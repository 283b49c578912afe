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
// H = 16, KV = 8, D = 128, causal, bf16) the work is 4 B H D S (S + 1) / 2
// = 6.9e10 operations on the tensor cores, 0.070 ms at 989 TFLOP/s, while
// the bytes (q, k, v read once, out written once: 100.7 MB) take 0.030 ms at
// 3.35 TB/s.  So bf16 is bound by tensor-core operations.  fp32 has no
// tensor-core path that keeps full fp32 products; it is bound by fp32 FMA
// work against 67 TFLOP/s.
//
// What the design does about it: one block per (kv slab, query tile).  The
// G query heads of a kv head are folded into the block's rows, so every
// K/V tile staged in shared memory serves all G heads of all the tile's
// queries.  The block keeps its q rows and their (m, l, acc) state in
// registers and streams K/V tiles through shared memory up to the diagonal;
// tiles wholly above a warp's diagonal are skipped (an exact no-op: their
// p is exp(-1e30 - m) = 0).
//   * bf16: 4 warps x 16 rows; q K^T and P V run as mma.sync m16n8k16 with
//     bf16 inputs and fp32 accumulation, the same kind of product as the
//     reference's dot_general(preferred_element_type=f32).  The S fragments
//     of q K^T become the A fragments of P V in registers, rounded to bf16
//     on the way; l is summed from the fp32 p before that rounding.
//   * fp32: 32 rows, four threads per row, each holding a quarter of the
//     head dimension; scalar FMA with a 4-lane shuffle for each dot product.
// Simple first: no TMA, no wgmma, no software pipelining of the tile loads;
// those are for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor-core kernel
// ---------------------------------------------------------------------------
constexpr int kBf16Rows = 16 * (kThreads / 32);  // (query, head) rows per block
constexpr int kBf16Keys = 64;                    // keys per shared-memory tile

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Fragment layout of mma.m16n8k16 (lane = 4 * gid + tig):
//   A (16 x 16, row): a0 (gid, 2tig..+1), a1 (gid+8, 2tig..+1),
//                     a2 (gid, 2tig+8..+9), a3 (gid+8, 2tig+8..+9);
//   B (16 x 8, col):  b0 (k 2tig..+1, n gid), b1 (k 2tig+8..+9, n gid);
//   C (16 x 8):       c0 c1 (gid, 2tig..+1), c2 c3 (gid+8, 2tig..+1).
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ out, int sq, int sk, int kvh,
                  int g, float scale, int causal) {
  constexpr int kStride = D + 8;  // bf16 elements; the pad spreads the banks
  constexpr int kVec = D / 8;     // 16-byte vectors per row
  __shared__ __align__(16) __nv_bfloat16 ks[kBf16Keys * kStride];
  __shared__ __align__(16) __nv_bfloat16 vs[kBf16Keys * kStride];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int qb = kBf16Rows / g;  // queries per block
  const int b = blockIdx.y / kvh, kvi = blockIdx.y % kvh;
  const int h = kvh * g;
  const int q0 = blockIdx.x * qb;
  const int q_last = min(q0 + qb, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;

  // this thread's two rows: gid and gid + 8 of the warp's 16
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
  const int warp_row_end = min(warp * 16 + 16, qb * g);  // live rows: below
  const bool warp_any = warp * 16 < qb * g && q0 + (warp * 16) / g < sq;
  const int warp_last = min(q0 + (warp_row_end - 1) / g, sq - 1);

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const __nv_bfloat16* p = q + row_off[i] + kk * 16 + tig * 2;
      qf[kk][i] = live[i] ? *reinterpret_cast<const uint32_t*>(p) : 0u;
      qf[kk][i + 2] = live[i] ? *reinterpret_cast<const uint32_t*>(p + 8) : 0u;
    }
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const long long key_stride = static_cast<long long>(kvh) * D;
  const __nv_bfloat16* kbase = k + (static_cast<long long>(b) * sk * kvh + kvi) * D;
  const __nv_bfloat16* vbase = v + (static_cast<long long>(b) * sk * kvh + kvi) * D;

  for (int t0 = 0; t0 < k_end; t0 += kBf16Keys) {
    __syncthreads();  // every warp is done with the previous tile
    for (int idx = threadIdx.x; idx < kBf16Keys * kVec; idx += kThreads) {
      const int r = idx / kVec, c = idx % kVec;
      const int key = t0 + r;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = make_uint4(0, 0, 0, 0);
      if (key < sk) {
        kx = *reinterpret_cast<const uint4*>(kbase + key * key_stride + c * 8);
        vx = *reinterpret_cast<const uint4*>(vbase + key * key_stride + c * 8);
      }
      *reinterpret_cast<uint4*>(ks + r * kStride + c * 8) = kx;
      *reinterpret_cast<uint4*>(vs + r * kStride + c * 8) = vx;
    }
    __syncthreads();
    if (!warp_any || (causal && t0 > warp_last)) continue;

    // S = q K^T for 8 n-tiles of 8 keys
    float s[kBf16Keys / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBf16Keys / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const __nv_bfloat16* kp = ks + (nt * 8 + gid) * kStride + tig * 2;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kp + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kp + kk * 16 + 8);
        mma_bf16(s[nt], qf[kk], b0, b1);
      }
    }

    // scale, mask, running max
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kBf16Keys / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int key = t0 + nt * 8 + tig * 2 + (e & 1);
        float x = s[nt][e] * scale;
        if (key >= sk || (causal && key > qpos[i])) x = kNegInf;
        s[nt][e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      alpha[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
    }

    // p in fp32 for l; rounded to bf16 as the A fragments of P V
    uint32_t pf[kBf16Keys / 16][4];
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBf16Keys / 8; ++nt) {
      const float p0 = expf(s[nt][0] - m[0]), p1 = expf(s[nt][1] - m[0]);
      const float p2 = expf(s[nt][2] - m[1]), p3 = expf(s[nt][3] - m[1]);
      ls[0] += p0 + p1;
      ls[1] += p2 + p3;
      pf[nt / 2][2 * (nt % 2)] = pack_bf16(p0, p1);
      pf[nt / 2][2 * (nt % 2) + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + ls[i];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // acc += P V: k = key, n = head-dim column
#pragma unroll
    for (int kt = 0; kt < kBf16Keys / 16; ++kt) {
      const __nv_bfloat16* vp = vs + (kt * 16 + tig * 2) * kStride + gid;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const __nv_bfloat16* c = vp + j * 8;
        const uint32_t b0 = pack_bf16(c[0], c[kStride]);
        const uint32_t b1 = pack_bf16(c[8 * kStride], c[9 * kStride]);
        mma_bf16(acc[j], pf[kt], b0, b1);
      }
    }
  }

  // each row's l is spread over the four lanes of its quad
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
    if (!live[i]) continue;
    const float lsum = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* o = out + row_off[i] + tig * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + j * 8) = __floats2bfloat162_rn(
          acc[j][2 * i] / lsum, acc[j][2 * i + 1] / lsum);
  }
}

// ---------------------------------------------------------------------------
// fp32: scalar FMA kernel
// ---------------------------------------------------------------------------
constexpr int kLanes = 4;                       // threads per (query, head) row
constexpr int kF32Rows = kThreads / kLanes;     // rows per block
constexpr int kF32Keys = 32;                    // keys per shared-memory tile

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int sq,
                 int sk, int kvh, int g, float scale, int causal) {
  constexpr int kChunks = D / (4 * kLanes);  // float4 chunks per thread
  __shared__ __align__(16) float ks[kF32Keys * D];
  __shared__ __align__(16) float vs[kF32Keys * D];

  const int r = threadIdx.x / kLanes, part = threadIdx.x % kLanes;
  const int warp = threadIdx.x / 32;
  const int qb = kF32Rows / g;
  const int b = blockIdx.y / kvh, kvi = blockIdx.y % kvh;
  const int h = kvh * g;
  const int q0 = blockIdx.x * qb;
  const int q_last = min(q0 + qb, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int qpos = q0 + r / g;
  const bool live = r < qb * g && qpos < sq;
  const long long row_off =
      ((static_cast<long long>(b) * sq + qpos) * h + kvi * g + r % g) * D;
  constexpr int kWarpRows = 32 / kLanes;
  const int warp_row_end = min(warp * kWarpRows + kWarpRows, qb * g);
  const bool warp_any = warp * kWarpRows < qb * g &&
                        q0 + (warp * kWarpRows) / g < sq;
  const int warp_last = min(q0 + (warp_row_end - 1) / g, sq - 1);

  // thread `part` holds columns 4 (part + kLanes c) .. +3 for each chunk c
  float qr[kChunks][4], acc[kChunks][4];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const float4 x = live ? *reinterpret_cast<const float4*>(
                                q + row_off + 4 * (part + kLanes * c))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[c][0] = x.x, qr[c][1] = x.y, qr[c][2] = x.z, qr[c][3] = x.w;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  const long long key_stride = static_cast<long long>(kvh) * D;
  const float* kbase = k + (static_cast<long long>(b) * sk * kvh + kvi) * D;
  const float* vbase = v + (static_cast<long long>(b) * sk * kvh + kvi) * D;

  for (int t0 = 0; t0 < k_end; t0 += kF32Keys) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kF32Keys * D / 4; idx += kThreads) {
      const int kr = idx / (D / 4), c = idx % (D / 4);
      const int key = t0 + kr;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (key < sk) {
        kx = *reinterpret_cast<const float4*>(kbase + key * key_stride + 4 * c);
        vx = *reinterpret_cast<const float4*>(vbase + key * key_stride + 4 * c);
      }
      *reinterpret_cast<float4*>(ks + kr * D + 4 * c) = kx;
      *reinterpret_cast<float4*>(vs + kr * D + 4 * c) = vx;
    }
    __syncthreads();
    if (!warp_any || (causal && t0 > warp_last)) continue;

    float s[kF32Keys];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kF32Keys; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 x =
            *reinterpret_cast<const float4*>(ks + j * D + 4 * (part + kLanes * c));
        dot = fmaf(qr[c][0], x.x, dot);
        dot = fmaf(qr[c][1], x.y, dot);
        dot = fmaf(qr[c][2], x.z, dot);
        dot = fmaf(qr[c][3], x.w, dot);
      }
      dot += __shfl_xor_sync(kFull, dot, 1);
      dot += __shfl_xor_sync(kFull, dot, 2);
      const int key = t0 + j;
      float x = dot * scale;
      if (key >= sk || (causal && key > qpos)) x = kNegInf;
      s[j] = x;
      mx = fmaxf(mx, x);
    }
    const float alpha = expf(m - mx);
    m = mx;
    float ls = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] *= alpha;
#pragma unroll
    for (int j = 0; j < kF32Keys; ++j) {
      const float p = expf(s[j] - m);  // v is fp32: the rounding is exact
      ls += p;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 x =
            *reinterpret_cast<const float4*>(vs + j * D + 4 * (part + kLanes * c));
        acc[c][0] = fmaf(p, x.x, acc[c][0]);
        acc[c][1] = fmaf(p, x.y, acc[c][1]);
        acc[c][2] = fmaf(p, x.z, acc[c][2]);
        acc[c][3] = fmaf(p, x.w, acc[c][3]);
      }
    }
    l = l * alpha + ls;
  }

  if (!live) return;
  const float lsum = fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    *reinterpret_cast<float4*>(out + row_off + 4 * (part + kLanes * c)) =
        make_float4(acc[c][0] / lsum, acc[c][1] / lsum, acc[c][2] / lsum,
                    acc[c][3] / lsum);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int sq, int sk, int kvh, int g, int bf16, int causal, float scale,
           cudaStream_t stream) {
  const int rows = bf16 ? kBf16Rows : kF32Rows;
  if (g > rows) return static_cast<int>(cudaErrorInvalidValue);
  const int qb = rows / g;
  const dim3 grid((sq + qb - 1) / qb, batch * kvh);
  if (bf16)
    flash_bf16_kernel<D><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
        sq, sk, kvh, g, scale, causal);
  else
    flash_f32_kernel<D><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), sq, sk, kvh,
        g, scale, causal);
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
    case 128: return launch<128>(q, k, v, out, batch, sq, sk, kv_heads, g, bf16, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
