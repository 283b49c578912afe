// Grouped-query flash attention for Hopper (sm_90a), plain C launch interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// _flash_kernel (entry flash_attention, pallas_call at :120).  Per (query,
// head) row, with G = H / KV query heads sharing one kv head:
//   s = (q . k) * D^-0.5 in fp32, masked to NEG_INF = -1e30 where
//       qpos < kpos (causal; positions counted from 0 for q and k alike);
//   online softmax over the keys with (m, l, acc) in fp32;
//   p = exp(s - m) is rounded to v's type before the PV product, while l
//       sums the unrounded p;
//   out = acc / max(l, 1e-30), cast to q's type.
// Layouts are the reference's public ones: q, out (B, Sq, H, D) and k, v
// (B, Sk, KV, D), all contiguous.  Head h belongs to kv head h / G.
//
// What bounds it on this card: at the prefill shape (B = 4, S = 2048,
// H = 16, KV = 8, D = 128, causal) the work is 4 B H D S (S + 1) / 2
// = 6.9e10 operations.  bf16 runs them on the tensor cores, 0.070 ms at
// 989 TFLOP/s, while the bytes (q, k, v read once, out written once: 100.7
// MB) take 0.030 ms at 3.35 TB/s, so bf16 is bound by tensor-core
// operations.  fp32 runs them as 3xTF32 on the tensor cores: three TF32
// products per product, 0.417 ms at 495 TFLOP/s (the bytes, 201 MB, take
// 0.060 ms); as exact fp32 FMAs they would take 1.026 ms at 67 TFLOP/s.
//
// What the design does about it: one block per (kv slab, query tile).  The
// G query heads of a kv head are folded into the block's rows, so every
// K/V tile staged in shared memory serves all G heads of all the tile's
// queries.  Tiles wholly above a warpgroup's diagonal are skipped (an
// exact no-op: their p is exp(-1e30 - m) = 0).
//   * bf16: 128 rows in two consumer warpgroups of 64 and one producer
//     warpgroup, which gives most of its registers to the consumers
//     (setmaxnreg).  The producer streams 64-key K and V tiles with
//     cp.async into a ring of kStages stages in shared memory, stored in
//     the swizzled layout wgmma reads, and signals each stage's `full`
//     mbarrier; the consumers release a stage through its `empty` mbarrier,
//     so the next tiles land while this one is computed.  q K^T and P V are
//     wgmma.mma_async m64nNk16 with bf16 inputs and fp32 accumulation (the
//     reference's dot_general(preferred_element_type=f32)): q (staged once
//     in shared memory) and K are the K-major A and B operands, P the A
//     operand from registers and V the MN-major B operand (transpose bit).
//     P V sums at most kFoldTiles key tiles on the tensor core; each thread
//     then folds them into its outputs in shared memory by fp32 FMAs.  The
//     tensor core's accumulation truncates: carried over rows of 32768
//     keys it leaned toward zero (`flash_long_rows.py`).
//     The loop is software-pipelined: P V of tile t and q K^T of tile t + 1
//     run on the tensor cores while the softmax of tile t + 1 runs.  p is
//     computed in fp32, added to the row's l, then rounded to bf16 as P's A
//     fragment.  p = e^(scale (s - m)) is taken as 2^(s scale log2(e) -
//     m scale log2(e)), one FFMA and one ex2.approx per score, with m the
//     running max of the raw scores.  Against expf(s scale - m), the
//     reference's form, this did not raise the share of outputs whose bf16
//     rounding differs from the plain version at the kernel's key tile, so
//     it was kept (chip_smoke.py phase 6 reads that share).  Branches are
//     taken on values the compiler can see to be warp-uniform (the warp
//     index comes through a shuffle), or ptxas serializes the wgmma
//     products.  The query tiles of a causal launch run heaviest first (the
//     grid's slow axis walks them backwards).
//   * fp32: 128 rows in eight warps of 16, all computing; every thread
//     also streams K and V with cp.async into two buffers of 32 keys (tile
//     t + 1 lands while tile t is computed), padded so the fragment reads
//     are free of bank conflicts.  q K^T and P V are mma.sync m16n8k8 with
//     tf32 inputs and fp32 accumulation, as 3xTF32: each fp32 operand x is
//     split into hi = cvt.rna.tf32(x) and lo = x - hi (the tensor core
//     truncates lo to tf32), and each product is taken as lo.hi + hi.lo +
//     hi.hi, small terms first, so a product keeps about 21 of fp32's 24
//     bits.  q is split once, into shared memory in the order each warp
//     reads its A fragments; K and V are split as their fragments are
//     read; p is split after it is added to l, which sums the unrounded p.
//     The tensor core's fp32 accumulation truncates, so P V is summed per
//     key tile in a fresh accumulator and added to o by a rounded FMA;
//     carried over a whole row of 32768 keys it drifted to 1.7e-4.
//     The online softmax is the bf16 kernel's (raw-score maxima, one FFMA
//     and one ex2 per score).  What bounds it now: the splits' ALU work
//     beside 3 mma.sync per product with eight warps per SM to hide their
//     latency (the kernel holds 184 registers a thread, one block per SM).
//     q in registers, split per tile, spilled at D = 128 and took 1.5x
//     as long or more.  wgmma's tf32 form takes only K-major B operands, and V as it
//     lies is MN-major, so this kernel stays on mma.sync.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// bf16: warpgroup (wgmma) kernel with a pipelined K/V ring
// ---------------------------------------------------------------------------
constexpr int kBf16Rows = 128;      // (query, head) rows: 2 warpgroups of 64
constexpr int kBf16Keys = 64;       // keys per K/V tile
constexpr int kStages = 3;          // K/V tiles in flight in shared memory
constexpr int kFoldTiles = 8;       // key tiles P V sums on the tensor core
constexpr int kConsumers = 256;     // the two warpgroups that compute
constexpr int kProducers = 128;     // the warpgroup that streams K and V
constexpr int kBf16Threads = kConsumers + kProducers;
// registers per thread: the producers give theirs up to the consumers
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(kProducers * kProducerRegs + kConsumers * kConsumerRegs <= 65536,
              "the register file holds one block");
constexpr float kLog2e = 1.4426950408889634f;
constexpr long long kSpinLimit = 1ll << 28;    // mbarrier polls before a trap

// Shared-memory geometry of one K or V tile for head dimension D.  A row of
// the tile is one key; its D values are cut into column blocks of kCols
// bf16 (kRowBytes = 2 kCols bytes: the swizzle width, 128, 64 or 32), and
// block c of every key lies at c * kBlockBytes.  Inside a block the 16-byte
// chunk j of key n sits at chunk j ^ ((n * kRowBytes >> 7) & (kRowBytes/16
// - 1)): the 128B/64B/32B swizzle that wgmma reads from a 1024-byte-aligned
// base.  K is then wgmma's K-major B operand (keys x D, D contiguous) and V
// its MN-major B operand (keys x D read through the transpose bit).
// D = 112 (zamba2's heads) takes seven 16-column blocks in the 32B swizzle,
// as D = 16 takes one: a 14336-byte tile and 175152 bytes a block.  Its 14
// chunks a key do not divide the 128 producer threads, so the producer
// steps 9 keys at a time and its last two threads only arrive, as D = 96's
// last eight do.
template <int D>
struct Smem {
  static constexpr int kCols = D % 64 == 0 ? 64 : (D % 32 == 0 ? 32 : 16);
  static constexpr int kRowBytes = 2 * kCols;
  static constexpr int kBlockBytes = kBf16Keys * kRowBytes;
  static constexpr int kTileBytes = kBf16Keys * D * 2;
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : (kRowBytes == 64 ? 2 : 3);
  // the block's q rows, stored as a K tile of kBf16Rows rows
  static constexpr int kQBlockBytes = kBf16Rows * kRowBytes;
  static constexpr int kQBytes = kBf16Rows * D * 2;
  // each consumer thread's D / 2 folded outputs, as float4 j of thread x
  // at (j * kConsumers + x) * 16, then the running max (of its two rows)
  // that they are scaled to, at kConsumers * D * 2 + x * 8
  static constexpr int kFoldBytes = kConsumers * (D / 2 + 2) * 4;
  // K and V of each stage, q, then the stages' full and empty barriers;
  // plus slack to align the base to 1024 bytes
  static constexpr int kBytes =
      2 * kStages * kTileBytes + kQBytes + 2 * kStages * 8 + kFoldBytes + 1024;
  static_assert(kTileBytes % 1024 == 0, "stages stay 1024-byte aligned");
};

// d += a . B for a 64 x 16 bf16 A in registers and a 16 x N B read by
// descriptor through the transpose bit (an MN-major B): o += P V
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void run(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};

template <>
struct Wgmma<96> {
  static __device__ __forceinline__ void run(float (&d)[48], const uint32_t (&a)[4],
                                             uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};

template <>
struct Wgmma<112> {
  static __device__ __forceinline__ void run(float (&d)[56], const uint32_t (&a)[4],
                                             uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55"
        "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};

// d = A . B with A (64 x 16 bf16) and B (16 x 64) both read by descriptor:
// S = q K^T of one 64-key tile
static_assert(kBf16Keys == 64, "wgmma_ss_n64 is the q K^T product");

// The first product of a tile writes d (its old values are not read: no
// instruction has to move them into place while products are in flight);
// the others accumulate into it.
template <bool kFirst>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b) {
  if constexpr (kFirst) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(kFirst ? 0 : 1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(kFirst ? 0 : 1));
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (all in 16-byte units) and the swizzle mode in bits 62-63
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until at most N committed groups of products are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.  A
// barrier that never completes traps (the launch then fails) instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (long long spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spin > kSpinLimit) __trap();
  }
}

// 16 bytes global -> shared, zero-filled when `bytes` is 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}

// the barrier's arrival once this thread's earlier cp.async have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               ::"r"(bar) : "memory");
}

// 2^x on the special-function unit; results below 2^-126 flush to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Register fragments (lane = 4 * gid + tig, warp w of a warpgroup owning its
// rows 16w .. 16w + 15), the same per warp as mma.m16n8k16's:
//   A (16 rows x 16, bf16 pairs): a0 (gid, 2tig..+1), a1 (gid+8, 2tig..+1),
//                                 a2 (gid, 2tig+8..+9), a3 (gid+8, 2tig+8..+9);
//   D (16 rows x N, fp32): d[4j] d[4j+1] (gid, 8j+2tig..+1),
//                          d[4j+2] d[4j+3] (gid+8, 8j+2tig..+1).
// So the S accumulator of 16 keys becomes the A fragment of P V in place.
template <int D>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ out, int sq, int sk, int kvh,
                  int g, float scale, int causal) {
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t qs = base + 2 * kStages * L::kTileBytes;   // q rows
  const uint32_t full = qs + L::kQBytes;                     // kStages barriers
  const uint32_t empty = full + kStages * 8;                 // kStages barriers
  const uint32_t folded = empty + kStages * 8;               // see fold below

  // the warp index through a shuffle: the compiler then knows it, and every
  // branch taken on it, to be uniform across the warp, so the wgmma
  // products in those branches are not serialized
  const int warp = __shfl_sync(kFull, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  const int qb = kBf16Rows / g;  // queries per block
  const int b = blockIdx.x / kvh, kvi = blockIdx.x % kvh;
  const int h = kvh * g;
  // heaviest causal tiles first: the last query tile is launched first
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * qb;
  const int q_last = min(q0 + qb, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int n_tiles = (k_end + kBf16Keys - 1) / kBf16Keys;
  const long long key_stride = static_cast<long long>(kvh) * D;
  const __nv_bfloat16* kbase = k + (static_cast<long long>(b) * sk * kvh + kvi) * D;
  const __nv_bfloat16* vbase = v + (static_cast<long long>(b) * sk * kvh + kvi) * D;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, kProducers);        // one per producer thread
      mbar_init(empty + 8 * s, kConsumers / 32);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    // producer: stream tile t into stage t % kStages once the consumers have
    // released that stage's previous tile
    // thread pt copies 16-byte chunk cc of rows r0, r0 + kRowStep, ... of
    // every tile (threads past kRowStep rows only arrive)
    constexpr int kChunks = D / 8, kRowStep = kProducers / kChunks;
    const int pt = threadIdx.x - kConsumers;
    const int cc = pt % kChunks, r0 = pt / kChunks;
    const int c = cc / (L::kCols / 8), j = cc % (L::kCols / 8);
    const long long step = kRowStep * key_stride;
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      if (t >= kStages) mbar_wait(empty + 8 * s, (t / kStages - 1) & 1);
      const uint32_t ks = base + s * 2 * L::kTileBytes, vs = ks + L::kTileBytes;
      const long long off0 = (t * kBf16Keys + r0) * key_stride + cc * 8;
#pragma unroll
      for (int i = 0; i < (kBf16Keys + kRowStep - 1) / kRowStep; ++i) {
        const int r = r0 + i * kRowStep;
        if (r0 < kRowStep && r < kBf16Keys) {
          const bool in = t * kBf16Keys + r < sk;  // past Sk: zero K and V rows
          const long long off = in ? off0 + i * step : 0;
          const uint32_t dst =
              c * L::kBlockBytes + r * L::kRowBytes +
              16 * (j ^ ((r * L::kRowBytes >> 7) & (L::kRowBytes / 16 - 1)));
          cp_async16(ks + dst, kbase + off, in ? 16 : 0);
          cp_async16(vs + dst, vbase + off, in ? 16 : 0);
        }
      }
      cp_async_arrive(full + 8 * s);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63; this thread
  // rows gid and gid + 8 of its warp's 16
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int gid = lane >> 2, tig = lane & 3;
  const int wg = warp / 4;
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qpos[i] = q0 + (warp * 16 + gid + 8 * i) / g;
  const int wg_row_end = min(wg * 64 + 64, qb * g);
  const bool wg_any = wg * 64 < qb * g && q0 + (wg * 64) / g < sq;
  const int wg_first = q0 + (wg * 64) / g;
  const int wg_last = min(q0 + (wg_row_end - 1) / g, sq - 1);
  // the tiles this warpgroup computes: a tile wholly above its last query
  // is an exact no-op, so it computes tiles 0 .. n_mine - 1 only
  const int n_mine = !wg_any ? 0
                     : causal ? min(n_tiles, wg_last / kBf16Keys + 1)
                              : n_tiles;

  // the warpgroup's 64 q rows into shared memory, swizzled as a K tile:
  // wgmma's K-major A operand
  for (int idx = threadIdx.x % 128; idx < 64 * D / 8; idx += 128) {
    const int rr = idx / (D / 8), cc = idx % (D / 8);
    const int r = wg * 64 + rr;
    const int c = cc / (L::kCols / 8), j = cc % (L::kCols / 8);
    const int qp = q0 + r / g;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r < qb * g && qp < sq)
      x = *reinterpret_cast<const uint4*>(
          q + ((static_cast<long long>(b) * sq + qp) * h + kvi * g + r % g) * D +
          cc * 8);
    const uint32_t dst =
        qs + c * L::kQBlockBytes + r * L::kRowBytes +
        16 * (j ^ ((r * L::kRowBytes >> 7) & (L::kRowBytes / 16 - 1)));
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                 ::"r"(dst), "r"(x.x), "r"(x.y), "r"(x.z), "r"(x.w) : "memory");
  }
  // written through the generic proxy, read by wgmma through the async
  // proxy, by the whole warpgroup (named barrier 1 + wg)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");

  // m is the running max of the raw scores s = q.k; p = e^(scale (s - m))
  // is taken as 2^(s scale2 - m scale2), one FFMA and one ex2 per score
  const float scale2 = scale * kLog2e;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // The output is pv plus this thread's folded values (shared memory),
  // rescaled from the max they were folded at: pv sums P V of up to
  // kFoldTiles key tiles on the tensor core, folded the tiles before them.
  // The tensor core's fp32 accumulation truncates, so a sum it carried
  // over a whole row would lean toward zero with the key count; the fold
  // adds pv in rounded fp32 FMAs.
  float pv[D / 2], s[kBf16Keys / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) pv[j] = 0.f;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    asm volatile("st.shared.v4.f32 [%0], {%1, %1, %1, %1};\n"
                 ::"r"(folded + (j * kConsumers + threadIdx.x) * 16), "f"(0.f)
                 : "memory");
  asm volatile("st.shared.v2.f32 [%0], {%1, %1};\n"
               ::"r"(folded + kConsumers * D * 2 + threadIdx.x * 8), "f"(kNegInf)
               : "memory");
  // P of two consecutive tiles: one feeds the running P V product while
  // the softmax of the next fills the other
  uint32_t pa[kBf16Keys / 16][4], pb[kBf16Keys / 16][4];

  const uint64_t qdesc = smem_desc(qs + wg * 64 * L::kRowBytes, 16,
                                  8 * L::kRowBytes, L::kLayout);

  // S = q K^T of tile t, over D / 16 steps of 16; one commit group
  auto issue_qk = [&](int t) {
    const int stage = t % kStages;
    mbar_wait(full + 8 * stage, (t / kStages) & 1);
    // cp.async wrote the tile through the generic proxy; wgmma reads it
    // through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const uint32_t ks = base + stage * 2 * L::kTileBytes;
    // each k-step's descriptors are the first one's plus a constant
    const uint64_t kdesc = smem_desc(ks, 16, 8 * L::kRowBytes, L::kLayout);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int blk = kk * 16 / L::kCols, col = (kk * 16 % L::kCols) * 2;
      const uint64_t da = qdesc + ((blk * L::kQBlockBytes + col) >> 4);
      const uint64_t db = kdesc + ((blk * L::kBlockBytes + col) >> 4);
      if (kk == 0)
        wgmma_ss_n64<true>(s, da, db);
      else
        wgmma_ss_n64<false>(s, da, db);
    }
    wgmma_commit();
  };

  // pv (+)= P V of tile t, over kBf16Keys / 16 steps of 16 keys; one
  // group.  The first tile after a fold starts pv afresh.
  auto issue_pv = [&](int t, const uint32_t (&pf)[kBf16Keys / 16][4]) {
    const uint32_t vs = base + (t % kStages) * 2 * L::kTileBytes + L::kTileBytes;
    const uint64_t vdesc =
        smem_desc(vs, L::kBlockBytes, 8 * L::kRowBytes, L::kLayout);
    const int fresh = t % kFoldTiles == 0;
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < kBf16Keys / 16; ++kt)
      Wgmma<D>::run(pv, pf[kt], vdesc + ((kt * 16 * L::kRowBytes) >> 4),
                    kt > 0 || !fresh);
    wgmma_commit();
  };

  // pv = folded 2^((m_f - m) scale2) + alpha pv, with m_f the max folded
  // was scaled to and m the running max; unless last, folded = pv and
  // m_f = m
  auto fold = [&](const float (&alpha)[2], bool last) {
    const uint32_t mf = folded + kConsumers * D * 2 + threadIdx.x * 8;
    float f0, f1;
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                 : "=f"(f0), "=f"(f1) : "r"(mf));
    const float b0 = ex2((f0 - m[0]) * scale2), b1 = ex2((f1 - m[1]) * scale2);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const uint32_t a = folded + (j * kConsumers + threadIdx.x) * 16;
      float x0, x1, x2, x3;
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(x0), "=f"(x1), "=f"(x2), "=f"(x3) : "r"(a));
      pv[4 * j] = fmaf(x0, b0, pv[4 * j] * alpha[0]);
      pv[4 * j + 1] = fmaf(x1, b0, pv[4 * j + 1] * alpha[0]);
      pv[4 * j + 2] = fmaf(x2, b1, pv[4 * j + 2] * alpha[1]);
      pv[4 * j + 3] = fmaf(x3, b1, pv[4 * j + 3] * alpha[1]);
      if (!last)
        asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n"
                     ::"r"(a), "f"(pv[4 * j]), "f"(pv[4 * j + 1]),
                     "f"(pv[4 * j + 2]), "f"(pv[4 * j + 3]) : "memory");
    }
    if (!last)
      asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n"
                   ::"r"(mf), "f"(m[0]), "f"(m[1]) : "memory");
  };

  // the online softmax of tile t from its scores s: p in fp32 for l, then
  // rounded to bf16 as the A fragments of P V; returns the rows' alpha
  auto softmax = [&](int t, uint32_t (&pf)[kBf16Keys / 16][4],
                     float (&alpha)[2]) {
    const int t0 = t * kBf16Keys;
    // only a tile that reaches past Sk or the warpgroup's first query has
    // masked keys
    const bool edge = t0 + kBf16Keys > sk || (causal && t0 + kBf16Keys - 1 > wg_first);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kBf16Keys / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int key = t0 + nt * 8 + tig * 2 + (e & 1);
        if (edge && (key >= sk || (causal && key > qpos[i]))) s[4 * nt + e] = kNegInf;
        mx[i] = fmaxf(mx[i], s[4 * nt + e]);
      }
    }
    float nms[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      alpha[i] = ex2((m[i] - mx[i]) * scale2);  // exactly 1 for an unchanged max
      m[i] = mx[i];
      nms[i] = -m[i] * scale2;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBf16Keys / 8; ++nt) {
      const float p0 = ex2(fmaf(s[4 * nt], scale2, nms[0]));
      const float p1 = ex2(fmaf(s[4 * nt + 1], scale2, nms[0]));
      const float p2 = ex2(fmaf(s[4 * nt + 2], scale2, nms[1]));
      const float p3 = ex2(fmaf(s[4 * nt + 3], scale2, nms[1]));
      ls[0] += p0 + p1;
      ls[1] += p2 + p3;
      pf[nt / 2][2 * (nt % 2)] = pack_bf16(p0, p1);
      pf[nt / 2][2 * (nt % 2) + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + ls[i];
  };

  auto release = [&](int t) {  // this warp is done with tile t's stage
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (t % kStages));
  };

  // Tile t, whose P is in pf: its P V product runs on the tensor cores
  // together with q K^T of tile t + 1 and then beside that tile's softmax,
  // which fills pn; once P V is done, pv is folded if tile t + 1 starts it
  // afresh, and the output takes tile t + 1's rescaling.
  auto step = [&](int t, const uint32_t (&pf)[kBf16Keys / 16][4],
                  uint32_t (&pn)[kBf16Keys / 16][4]) {
    if (t + 1 < n_mine) {
      issue_qk(t + 1);
      issue_pv(t, pf);
      wgmma_wait<1>();  // q K^T of tile t + 1 is done
      float alpha[2];
      softmax(t + 1, pn, alpha);
      wgmma_wait<0>();  // P V of tile t is done
      release(t);
      if ((t + 1) % kFoldTiles == 0) {
        fold(alpha, false);  // tile t + 1 starts pv afresh
      } else if (__any_sync(kFull, alpha[0] != 1.f || alpha[1] != 1.f)) {
        // rescaling by alpha = 1 (no row of the warp found a new max) is
        // the identity, so the warp skips it
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          pv[4 * j] *= alpha[0];
          pv[4 * j + 1] *= alpha[0];
          pv[4 * j + 2] *= alpha[1];
          pv[4 * j + 3] *= alpha[1];
        }
      }
    } else {
      issue_pv(t, pf);
      wgmma_wait<0>();
      release(t);
    }
  };

  if (n_mine > 0) {
    float alpha[2];  // nothing summed yet: nothing to rescale
    issue_qk(0);
    wgmma_wait<0>();
    softmax(0, pa, alpha);
  }
  for (int t = 0; t < n_mine; t += 2) {
    step(t, pa, pb);
    if (t + 1 < n_mine) step(t + 1, pb, pa);
  }
  const float one[2] = {1.f, 1.f};
  fold(one, true);  // pv = the whole output
  // the tiles above this warpgroup's diagonal: released unread
  for (int t = n_mine; t < n_tiles; ++t) {
    mbar_wait(full + 8 * (t % kStages), (t / kStages) & 1);
    release(t);
  }

  // each row's l is spread over the four lanes of its quad
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
    const int r = warp * 16 + gid + 8 * i;
    if (r >= qb * g || qpos[i] >= sq) continue;  // not a live row
    const float lsum = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* dst =
        out + ((static_cast<long long>(b) * sq + qpos[i]) * h + kvi * g + r % g) * D +
        tig * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) = __floats2bfloat162_rn(
          pv[4 * j + 2 * i] / lsum, pv[4 * j + 2 * i + 1] / lsum);
  }
}

// ---------------------------------------------------------------------------
// fp32: 3xTF32 tensor-core kernel (mma.sync) with a double-buffered K/V stream
// ---------------------------------------------------------------------------
constexpr int kF32Rows = 128;     // (query, head) rows: 8 warps of 16
constexpr int kF32Keys = 32;      // keys per K/V tile
constexpr int kF32Threads = 256;
constexpr int kF32Pad = 4;        // floats of padding after each staged key

// Shared memory of the fp32 kernel: K and V tiles of kF32Keys keys, two
// buffers each, a key every D + kF32Pad floats (a row stride of 4 mod 32
// words keeps the fragment reads below free of bank conflicts); then q's
// A fragments, split once into hi and lo parts, eight words per lane and
// k-step, in the order each warp reads them.
template <int D>
struct F32Smem {
  static constexpr int kRow = D + kF32Pad;
  static constexpr int kTile = kF32Keys * kRow;   // floats per K or V tile
  static constexpr int kQ = kF32Rows * D * 2;     // floats of split q
  static constexpr int kBytes = (2 * 2 * kTile + kQ) * 4;
};

// x rounded to tf32 (10 mantissa bits), to nearest, ties away from zero
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// x = hi + lo to about 21 bits: hi = tf32(x), rounded to nearest, and
// lo = x - hi as fp32 bits, whose low 13 bits the tensor core ignores, so
// lo enters the product truncated to tf32 (CUTLASS's FastF32, which
// PyTorch's memory-efficient attention runs for fp32, truncates its small
// part too).  Rounding lo with a second cvt.rna read the same error at
// the prefill shape and took 11% longer.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a . b for one m16n8k8 tile, tf32 inputs, fp32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in 3xTF32 for b = (x0, x1) split here: a_lo b_hi and a_hi b_lo,
// the small terms, first, then a_hi b_hi; a_lo b_lo (about 2^-22 of the
// product) is dropped
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float x0,
                                           float x1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(x0, bh0, bl0);
  split(x1, bh1, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// n consecutive floats of shared memory (n = 2 or 4, 8 or 16 bytes aligned)
template <int N>
__device__ __forceinline__ void lds(float (&x)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 y = *reinterpret_cast<const float4*>(p);
    x[0] = y.x, x[1] = y.y, x[2] = y.z, x[3] = y.w;
  } else {
    const float2 y = *reinterpret_cast<const float2*>(p);
    x[0] = y.x, x[1] = y.y;
  }
}

__device__ __forceinline__ uint4 as_u4(float4 x) {
  return make_uint4(__float_as_uint(x.x), __float_as_uint(x.y),
                    __float_as_uint(x.z), __float_as_uint(x.w));
}

// Fragments of mma.m16n8k8.tf32 (lane = 4 gid + tig):
//   A (16 x 8): a0 (gid, tig), a1 (gid + 8, tig), a2 (gid, tig + 4),
//               a3 (gid + 8, tig + 4);
//   B (8 x 8):  b0 (tig, gid), b1 (tig + 4, gid);
//   D (16 x 8): d0 d1 (gid, 2 tig .. + 1), d2 d3 (gid + 8, 2 tig .. + 1).
// The order of the k axis inside a product is free, so each product maps
// its k positions to the operand's columns in the order that lets a thread
// read them as vectors:
//   * q K^T, over chunks of KC = 8 KS values of d (KS = 4, or 2 for
//     D = 16): in k-step ks of a chunk, position tig is column 2 KS tig + ks
//     and position tig + 4 column 2 KS tig + KS + ks, so a thread reads its
//     2 KS columns of a key as float4s once per chunk and key.
//   * P V, over the 8 keys of an n-tile of S: position tig is key 2 tig and
//     position tig + 4 key 2 tig + 1, so P's A fragment is S's accumulator
//     fragment in place (a0 = d0, a1 = d2, a2 = d1, a3 = d3).  V's columns
//     go to output tiles in groups of NG = KS: n-tile NG jj + e, position
//     gid holds column 8 NG jj + NG gid + e, so a thread reads NG
//     consecutive columns of a key for NG output tiles at once, and writes
//     NG consecutive outputs at the end.
template <int D>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int sq,
                 int sk, int kvh, int g, float scale, int causal) {
  using L = F32Smem<D>;
  constexpr int KS = D % 32 == 0 ? 4 : 2;  // k-steps of 8 per chunk of d
  constexpr int KC = 8 * KS;               // d values per chunk
  constexpr int NG = KS;                   // output n-tiles per V read
  constexpr int kNT = kF32Keys / 8;        // n-tiles of S per K/V tile
  constexpr int kDT = D / 8;               // k-steps of q K^T
  static_assert(D % KC == 0, "the head dimension is whole chunks");
  extern __shared__ __align__(16) float smem_f32[];
  float* const kbuf = smem_f32;                  // 2 K tiles
  float* const vbuf = smem_f32 + 2 * L::kTile;   // 2 V tiles
  float4* const qsplit = reinterpret_cast<float4*>(smem_f32 + 4 * L::kTile);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int qb = kF32Rows / g;  // queries per block
  const int b = blockIdx.x / kvh, kvi = blockIdx.x % kvh;
  const int h = kvh * g;
  // heaviest causal tiles first: the last query tile is launched first
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * qb;
  const int q_last = min(q0 + qb, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int n_tiles = (k_end + kF32Keys - 1) / kF32Keys;
  const long long key_stride = static_cast<long long>(kvh) * D;
  const float* kbase = k + (static_cast<long long>(b) * sk * kvh + kvi) * D;
  const float* vbase = v + (static_cast<long long>(b) * sk * kvh + kvi) * D;

  // this thread's rows: gid and gid + 8 of its warp's 16
  int qpos[2];
  bool live[2];
  long long row_off[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gid + 8 * i;
    qpos[i] = q0 + r / g;
    live[i] = r < qb * g && qpos[i] < sq;
    row_off[i] = ((static_cast<long long>(b) * sq + qpos[i]) * h + kvi * g +
                  r % g) * D;
  }
  const int w_row_end = min(warp * 16 + 16, qb * g);
  const bool w_any = warp * 16 < qb * g && q0 + (warp * 16) / g < sq;
  const int w_first = q0 + (warp * 16) / g;
  const int w_last = min(q0 + (w_row_end - 1) / g, sq - 1);
  // a tile wholly above the warp's last query is an exact no-op, so the
  // warp computes tiles 0 .. n_mine - 1 only
  const int n_mine = !w_any ? 0
                     : causal ? min(n_tiles, w_last / kF32Keys + 1)
                              : n_tiles;

  // q's A fragments, split once: (hi a0..a3, lo a0..a3) of k-step kk of
  // this warp at qsplit[2 ((warp kDT + kk) 32 + lane)]; each lane writes and
  // later reads only its own
  const float4* qf = qsplit + 2 * (warp * kDT * 32 + lane);
  for (int c = 0; c < D / KC; ++c)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[e] = live[e & 1] ? q[row_off[e & 1] + c * KC + 2 * KS * tig +
                                (e >> 1) * KS + ks]
                           : 0.f;
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(x[e], hi[e], lo[e]);
      float4* dst = qsplit + 2 * ((warp * kDT + c * KS + ks) * 32 + lane);
      dst[0] = make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]),
                           __uint_as_float(hi[2]), __uint_as_float(hi[3]));
      dst[1] = make_float4(__uint_as_float(lo[0]), __uint_as_float(lo[1]),
                           __uint_as_float(lo[2]), __uint_as_float(lo[3]));
    }

  // tile t of K and V into buffer `buf`, keys past Sk zero-filled; one
  // cp.async group per tile
  auto load_tile = [&](int t, int buf) {
    constexpr int kChunks = D / 4;  // 16-byte chunks per key
    float* ks = kbuf + buf * L::kTile;
    float* vs = vbuf + buf * L::kTile;
    for (int idx = threadIdx.x; idx < kF32Keys * kChunks; idx += kF32Threads) {
      const int r = idx / kChunks, c = idx % kChunks;
      const int key = t * kF32Keys + r;
      const bool in = key < sk;
      const long long off = in ? key * key_stride + 4 * c : 0;
      cp_async16(smem_addr(ks + r * L::kRow + 4 * c), kbase + off, in ? 16 : 0);
      cp_async16(smem_addr(vs + r * L::kRow + 4 * c), vbase + off, in ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // m is the running max of the raw scores s = q.k; p = e^(scale (s - m))
  // is taken as 2^(s scale2 - m scale2), one FFMA and one ex2 per score
  const float scale2 = scale * kLog2e;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  // one tile of the online softmax from the K and V tiles at ks, vs
  auto compute = [&](int t, const float* ks, const float* vs) {
    // S = q K^T
    float s[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int c = 0; c < D / KC; ++c) {
      uint32_t ah[KS][4], al[KS][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint4 xh = as_u4(qf[2 * 32 * (c * KS + kk)]);
        const uint4 xl = as_u4(qf[2 * 32 * (c * KS + kk) + 1]);
        ah[kk][0] = xh.x, ah[kk][1] = xh.y, ah[kk][2] = xh.z, ah[kk][3] = xh.w;
        al[kk][0] = xl.x, al[kk][1] = xl.y, al[kk][2] = xl.z, al[kk][3] = xl.w;
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        float kx[2 * KS];
        const float* kr = ks + (nt * 8 + gid) * L::kRow + c * KC + 2 * KS * tig;
#pragma unroll
        for (int e = 0; e < 2 * KS; e += 4) {
          const float4 y = *reinterpret_cast<const float4*>(kr + e);
          kx[e] = y.x, kx[e + 1] = y.y, kx[e + 2] = y.z, kx[e + 3] = y.w;
        }
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          mma_3xtf32(s[nt], ah[kk], al[kk], kx[kk], kx[KS + kk]);
      }
    }

    // only a tile that reaches past Sk or the warp's first query has
    // masked keys
    const int t0 = t * kF32Keys;
    const bool edge = t0 + kF32Keys > sk || (causal && t0 + kF32Keys - 1 > w_first);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int key = t0 + nt * 8 + tig * 2 + (e & 1);
        if (edge && (key >= sk || (causal && key > qpos[i]))) s[nt][e] = kNegInf;
        mx[i] = fmaxf(mx[i], s[nt][e]);
      }
    }
    float alpha[2], nms[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      alpha[i] = ex2((m[i] - mx[i]) * scale2);  // exactly 1 for an unchanged max
      m[i] = mx[i];
      nms[i] = -m[i] * scale2;
    }

    // P, split for 3xTF32, as P V's A fragment (one k-step per n-tile of
    // S); l sums the unrounded p
    float ls[2] = {0.f, 0.f};
    uint32_t ph[kNT][4], pl[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const float p0 = ex2(fmaf(s[nt][0], scale2, nms[0]));
      const float p1 = ex2(fmaf(s[nt][1], scale2, nms[0]));
      const float p2 = ex2(fmaf(s[nt][2], scale2, nms[1]));
      const float p3 = ex2(fmaf(s[nt][3], scale2, nms[1]));
      ls[0] += p0 + p1;
      ls[1] += p2 + p3;
      split(p0, ph[nt][0], pl[nt][0]);
      split(p2, ph[nt][1], pl[nt][1]);
      split(p1, ph[nt][2], pl[nt][2]);
      split(p3, ph[nt][3], pl[nt][3]);
    }

    // o = alpha o + P V.  The tensor core's fp32 accumulation truncates,
    // so a sum it carries over the whole row drifts low with the key count
    // (rows of 32768 keys summed to one within only 1.7e-4).  Each output
    // tile's share of this key tile is summed instead in a fresh
    // accumulator, 3 kNT products deep, and added to o in one rounded FMA,
    // which also applies the rescale.
#pragma unroll
    for (int jj = 0; jj < D / (8 * NG); ++jj) {
      float pv[NG][4];
#pragma unroll
      for (int e = 0; e < NG; ++e) pv[e][0] = pv[e][1] = pv[e][2] = pv[e][3] = 0.f;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const float* v0 = vs + (nt * 8 + 2 * tig) * L::kRow + NG * gid + 8 * NG * jj;
        float x0[NG], x1[NG];
        lds<NG>(x0, v0);
        lds<NG>(x1, v0 + L::kRow);
#pragma unroll
        for (int e = 0; e < NG; ++e) mma_3xtf32(pv[e], ph[nt], pl[nt], x0[e], x1[e]);
      }
#pragma unroll
      for (int e = 0; e < NG; ++e) {
        float* oj = o[NG * jj + e];
        oj[0] = fmaf(oj[0], alpha[0], pv[e][0]);
        oj[1] = fmaf(oj[1], alpha[0], pv[e][1]);
        oj[2] = fmaf(oj[2], alpha[1], pv[e][2]);
        oj[3] = fmaf(oj[3], alpha[1], pv[e][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + ls[i];
  };

  // the K/V stream: tile t + 1 lands in the other buffer while tile t is
  // computed; a buffer is refilled only after every warp is done with it
  if (n_tiles > 0) load_tile(0, 0);
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_tile(t + 1, (t + 1) & 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    if (t < n_mine) compute(t, kbuf + (t & 1) * L::kTile, vbuf + (t & 1) * L::kTile);
    __syncthreads();
  }

  // each row's l is spread over the four lanes of its quad
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
    if (!live[i]) continue;
    const float lsum = fmaxf(l[i], 1e-30f);
    float* dst = out + row_off[i];
#pragma unroll
    for (int jj = 0; jj < D / (8 * NG); ++jj)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // position 2 tig + half of n-tiles NG jj .. NG jj + NG - 1
        float x[NG];
#pragma unroll
        for (int e = 0; e < NG; ++e) x[e] = o[NG * jj + e][2 * i + half] / lsum;
        float* d = dst + 8 * NG * jj + NG * (2 * tig + half);
        if constexpr (NG == 4)
          *reinterpret_cast<float4*>(d) = make_float4(x[0], x[1], x[2], x[3]);
        else
          *reinterpret_cast<float2*>(d) = make_float2(x[0], x[1]);
      }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int sq, int sk, int kvh, int g, int bf16, int causal, float scale,
           cudaStream_t stream) {
  const int rows = bf16 ? kBf16Rows : kF32Rows;
  if (g > rows) return static_cast<int>(cudaErrorInvalidValue);
  const int qb = rows / g;
  const int n_qt = (sq + qb - 1) / qb;
  if (bf16) {
    // above 48 KB, dynamic shared memory has to be asked for
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Smem<D>::kBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_bf16_kernel<D><<<dim3(batch * kvh, n_qt), kBf16Threads,
                           Smem<D>::kBytes, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
        sq, sk, kvh, g, scale, causal);
  } else {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        F32Smem<D>::kBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_f32_kernel<D><<<dim3(batch * kvh, n_qt), kF32Threads,
                          F32Smem<D>::kBytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), sq, sk, kvh,
        g, scale, causal);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Enqueues one launch on `stream`.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue (nonzero, nothing launched) for a head dimension
// without an instantiation or more query heads per kv head than a block has
// rows.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, int batch, int sq, int sk,
                                   int heads, int kv_heads, int head_dim,
                                   int bf16, int causal, float scale,
                                   void* stream) {
  if (kv_heads <= 0 || heads % kv_heads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int g = heads / kv_heads;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch<16>(q, k, v, out, batch, sq, sk, kv_heads, g, bf16, causal, scale, s);
    case 32: return launch<32>(q, k, v, out, batch, sq, sk, kv_heads, g, bf16, causal, scale, s);
    case 64: return launch<64>(q, k, v, out, batch, sq, sk, kv_heads, g, bf16, causal, scale, s);
    case 96: return launch<96>(q, k, v, out, batch, sq, sk, kv_heads, g, bf16, causal, scale, s);
    case 112: return launch<112>(q, k, v, out, batch, sq, sk, kv_heads, g, bf16, causal, scale, s);
    case 128: return launch<128>(q, k, v, out, batch, sq, sk, kv_heads, g, bf16, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
