// All-pairs N-body force kernels for Hopper (sm_90a), plain C launch interface.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/nbody_force.py:
//   * nbody_acc_jerk_pot -> _acc_jerk_kernel (entry acc_jerk_pot_packed):
//       per target acc = sum m r/d^3, jerk = sum m/d^3 (v + q r) with
//       q = -3 r.v/d^2, pot = -sum m/d;
//   * nbody_snap         -> _snap_kernel (entry snap_packed): per target
//       snap = sum [t da - 6 alpha J - 3 beta P], t = m/d^3, alpha = r.v/d^2,
//       beta = (v.v + r.da)/d^2 + alpha^2.
// Layouts are the reference's packed ones: targets (N_t, 8) rows
// [x y z act vx vy vz 0], sources (8, N_s) rows [x y z m vx vy vz 0], snap
// accelerations (N_t, 8) and (8, N_s), outputs (N_t, 8).  An optional
// leading batch axis B runs on gridDim.y with per-batch targets and sources.
//
// What bounds it on this card: fp32 FMA and rsqrtf work, not memory and not
// tensor cores.  Operations per pair, counted from the code below (an FMA
// is two, rsqrtf one, a select none):
//   acc/jerk/pot, fp32: 6 differences, r^2 5, softening 1, rsqrtf 1,
//     1/d^2 and 1/d^3 2, t 1, r.v 5, q 2, acc 6, jerk 12, pot 2  = 43;
//   snap, fp32: 9 differences, r^2 5, softening 1, rsqrtf 1, 1/d^2 and 1/d^3
//     2, t 1, alpha 6, beta 14, c1 = -6 alpha 1, c2 = 18 alpha^2 - 3 beta 4,
//     t (da + c1 v + c2 r) 15, accumulate 3  = 62;
//   mixed mode adds a bf16 round trip per term (conversions, no flops) and
//     replaces each accumulate-add with a 7-flop two-sum: 85 and 80.
// The bound is ops * N_t * N_s / 67 TFLOP/s (fp32, non-tensor): 0.172 ms
// (K1) and 0.248 ms (K2) at N_t = N_s = 16384.  The bytes moved (each
// operand read once, each output written once) are ~1.6 MB at that size,
// under 1 us at 3.35 TB/s.  rsqrtf issues on the SFU at an eighth of the
// FMA rate, so the practical ceiling sits a little under the flop bound.
//
// What the design does about it: the sources stream through shared memory
// one tile at a time, loaded with coalesced row reads of the (8, N_s)
// layout and read back as broadcasts, so the inner loop is pure register
// arithmetic with no global traffic.  A block whose targets are all
// inactive skips its source loop (__syncthreads_or), the analogue of the
// reference's pl.when.  Both kernels split the source axis across threads
// (one thread per target, 128 a block, gave the grid only N/32 warps at
// N = 16384, about four per SM, too few to hide the dependent rsqrtf/FMA
// chain of a pair): k*Slices = 16 lanes share a group of k*Per = 4 targets, each lane taking
// an interleave of every staged 512-source tile, so each shared-memory
// read of a source serves four pairs and the grid holds 16 / 4 = 4 times
// the old one's threads: at N = 16384, 128 blocks of 16 warps, one per SM.
// The lanes' partial sums meet in a shuffle butterfly in a fixed order,
// with no atomics: plain adds in fp32, and in mixed mode a two-sum of the
// sums and a sum of the compensations, which fold in at the end, outside
// the gate.  In fp32 mode each lane sums its share of a tile into a tile
// partial that is then added to its running sum (the reference sums within
// a j-block and accumulates across blocks the same way).
//   * K1 keeps 7 sums per target, 28 per thread, beside 28 tile partials
//     (fp32) or 28 compensations (mixed) and 24 target coordinates; the
//     activity column is read again at the end instead of held.  512
//     threads cap a thread at 128 registers.
//   * K2 keeps 3 sums per target and also the targets' accelerations.
//     Each pair's three terms are gathered per component into
//     t (da + c1 v + c2 r), 62 operations where the reference's
//     t da - 6 alpha J - 3 beta P takes 72.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Both kernels share one decomposition: a block holds k*Targets targets,
// each thread k*Per of them, and the k*Slices lanes of a target group split
// every staged source tile between them, lane s taking sources s,
// s + k*Slices, ...  The lanes' partial sums meet in a butterfly of
// shuffles in a fixed order, so two launches on the same inputs agree bit
// for bit.
constexpr int kAccThreads = 512;
constexpr int kAccSlices = 16;  // lanes per target group, dividing 32
constexpr int kAccPer = 4;      // targets per thread
constexpr int kAccTargets = kAccThreads / kAccSlices * kAccPer;
constexpr int kAccTile = kAccThreads;  // sources staged per tile
static_assert(32 % kAccSlices == 0, "a target group lies inside one warp");
static_assert(kAccPer <= kAccSlices, "each target has a lane to write it");

constexpr int kSnapThreads = 512;
constexpr int kSnapSlices = 16;  // lanes per target group, dividing 32
constexpr int kSnapPer = 4;      // targets per thread
constexpr int kSnapTargets = kSnapThreads / kSnapSlices * kSnapPer;
constexpr int kSnapTile = kSnapThreads;  // sources staged per tile
static_assert(32 % kSnapSlices == 0, "a target group lies inside one warp");
static_assert(kSnapPer <= kSnapSlices, "each target has a lane to write it");

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// s + v as an exact two-sum: the rounding error of the add goes into c.
__device__ __forceinline__ void two_sum_add(float& s, float& c, float v) {
  const float t = s + v;
  const float bb = t - s;
  c += (s - (t - bb)) + (v - bb);
  s = t;
}

// One pair's contribution added into the accumulators: per-pair bf16
// rounding and a two-sum in mixed mode, a plain add into the tile partial
// otherwise.
template <bool kMixed>
__device__ __forceinline__ void accumulate(float& part, float& sum,
                                           float& comp, float term) {
  if constexpr (kMixed) {
    two_sum_add(sum, comp, round_bf16(term));
  } else {
    part += term;
  }
}

// (s, c) += the partner lane's (s, c): a two-sum of the sums and a sum of
// the compensations.  Both partners compute the same bits (the adds are
// commutative and the two-sum's error is exact), so after the butterfly
// every lane of the group holds the same total.
template <bool kMixed>
__device__ __forceinline__ void combine(float& s, float& c, int offset) {
  const float so = __shfl_xor_sync(0xffffffffu, s, offset);
  if constexpr (kMixed) {
    const float co = __shfl_xor_sync(0xffffffffu, c, offset);
    float e = 0.f;
    two_sum_add(s, e, so);
    c = (c + co) + e;
  } else {
    s += so;
  }
}

template <bool kMixed>
__global__ void __launch_bounds__(kAccThreads)
acc_jerk_pot_kernel(const float* __restrict__ tgt,
                    const float* __restrict__ src, float* __restrict__ out,
                    int n_t, int n_s, float eps2) {
  const size_t b = blockIdx.y;
  tgt += b * n_t * 8;
  src += b * 8 * n_s;
  out += b * n_t * 8;
  const int slice = threadIdx.x % kAccSlices;
  const int first = blockIdx.x * kAccTargets + threadIdx.x / kAccSlices * kAccPer;

  float xi[kAccPer], yi[kAccPer], zi[kAccPer];
  float vxi[kAccPer], vyi[kAccPer], vzi[kAccPer];
  bool any = false;
#pragma unroll
  for (int p = 0; p < kAccPer; ++p) {
    xi[p] = yi[p] = zi[p] = vxi[p] = vyi[p] = vzi[p] = 0.f;
    const int i = first + p;
    if (i < n_t) {
      const float* t = tgt + static_cast<size_t>(i) * 8;
      xi[p] = t[0]; yi[p] = t[1]; zi[p] = t[2];
      vxi[p] = t[4]; vyi[p] = t[5]; vzi[p] = t[6];
      any |= t[3] != 0.f;
    }
  }

  __shared__ float sh[7][kAccTile];  // x y z m vx vy vz of one source tile
  float sum[kAccPer][7], comp[kAccPer][7];
#pragma unroll
  for (int p = 0; p < kAccPer; ++p)
#pragma unroll
    for (int k = 0; k < 7; ++k) sum[p][k] = comp[p][k] = 0.f;

  if (__syncthreads_or(any)) {  // uniform over the block: barriers stay legal
    for (int j0 = 0; j0 < n_s; j0 += kAccTile) {
      const int nj = min(kAccTile, n_s - j0);
      if (threadIdx.x < nj) {
#pragma unroll
        for (int r = 0; r < 7; ++r)
          sh[r][threadIdx.x] = src[static_cast<size_t>(r) * n_s + j0 + threadIdx.x];
      }
      __syncthreads();
      float part[kAccPer][7];
#pragma unroll
      for (int p = 0; p < kAccPer; ++p)
#pragma unroll
        for (int k = 0; k < 7; ++k) part[p][k] = 0.f;
#pragma unroll 2
      for (int j = slice; j < nj; j += kAccSlices) {
        const float sx = sh[0][j], sy = sh[1][j], sz = sh[2][j], mj = sh[3][j];
        const float svx = sh[4][j], svy = sh[5][j], svz = sh[6][j];
#pragma unroll
        for (int p = 0; p < kAccPer; ++p) {
          const float dx = sx - xi[p];
          const float dy = sy - yi[p];
          const float dz = sz - zi[p];
          const float dvx = svx - vxi[p];
          const float dvy = svy - vyi[p];
          const float dvz = svz - vzi[p];
          const float r2 = dx * dx + dy * dy + dz * dz;
          // a self-pair (r2 == 0) contributes exactly zero, the potential too
          const float inv_r = r2 > 0.f ? rsqrtf(r2 + eps2) : 0.f;
          const float inv_r2 = inv_r * inv_r;
          const float t = mj * (inv_r2 * inv_r);
          const float q = -3.f * (dx * dvx + dy * dvy + dz * dvz) * inv_r2;
          accumulate<kMixed>(part[p][0], sum[p][0], comp[p][0], t * dx);
          accumulate<kMixed>(part[p][1], sum[p][1], comp[p][1], t * dy);
          accumulate<kMixed>(part[p][2], sum[p][2], comp[p][2], t * dz);
          accumulate<kMixed>(part[p][3], sum[p][3], comp[p][3], t * (dvx + q * dx));
          accumulate<kMixed>(part[p][4], sum[p][4], comp[p][4], t * (dvy + q * dy));
          accumulate<kMixed>(part[p][5], sum[p][5], comp[p][5], t * (dvz + q * dz));
          accumulate<kMixed>(part[p][6], sum[p][6], comp[p][6], mj * inv_r);
        }
      }
      if constexpr (!kMixed) {
#pragma unroll
        for (int p = 0; p < kAccPer; ++p)
#pragma unroll
          for (int k = 0; k < 7; ++k) sum[p][k] += part[p][k];
      }
      __syncthreads();  // the tile is consumed before the next one lands
    }
  }

  // the slices' partials meet in a fixed butterfly; the compensation folds
  // in after it, outside the activity gate
#pragma unroll
  for (int offset = 1; offset < kAccSlices; offset *= 2)
#pragma unroll
    for (int p = 0; p < kAccPer; ++p)
#pragma unroll
      for (int k = 0; k < 7; ++k) combine<kMixed>(sum[p][k], comp[p][k], offset);
  if (slice < kAccPer && first + slice < n_t) {
    // lane `slice` of the group writes the group's target `slice`
    float s[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int p = 0; p < kAccPer; ++p) {
      if (p != slice) continue;
#pragma unroll
      for (int k = 0; k < 7; ++k) s[k] = sum[p][k] + comp[p][k];
    }
    const size_t i = first + slice;
    const float a = tgt[i * 8 + 3];
    float* o = out + i * 8;
#pragma unroll
    for (int k = 0; k < 6; ++k) o[k] = a * s[k];
    o[6] = -(a * s[6]);
    o[7] = 0.f;
  }
}

template <bool kMixed>
__global__ void __launch_bounds__(kSnapThreads)
snap_kernel(const float* __restrict__ tgt, const float* __restrict__ src,
            const float* __restrict__ tacc, const float* __restrict__ sacc,
            float* __restrict__ out, int n_t, int n_s, float eps2) {
  const size_t b = blockIdx.y;
  tgt += b * n_t * 8;
  tacc += b * n_t * 8;
  src += b * 8 * n_s;
  sacc += b * 8 * n_s;
  out += b * n_t * 8;
  const int slice = threadIdx.x % kSnapSlices;
  const int first = blockIdx.x * kSnapTargets + threadIdx.x / kSnapSlices * kSnapPer;

  float xi[kSnapPer], yi[kSnapPer], zi[kSnapPer], act[kSnapPer];
  float vxi[kSnapPer], vyi[kSnapPer], vzi[kSnapPer];
  float axi[kSnapPer], ayi[kSnapPer], azi[kSnapPer];
  bool any = false;
#pragma unroll
  for (int p = 0; p < kSnapPer; ++p) {
    xi[p] = yi[p] = zi[p] = act[p] = vxi[p] = vyi[p] = vzi[p] = 0.f;
    axi[p] = ayi[p] = azi[p] = 0.f;
    const int i = first + p;
    if (i < n_t) {
      const float* t = tgt + static_cast<size_t>(i) * 8;
      xi[p] = t[0]; yi[p] = t[1]; zi[p] = t[2]; act[p] = t[3];
      vxi[p] = t[4]; vyi[p] = t[5]; vzi[p] = t[6];
      const float* a = tacc + static_cast<size_t>(i) * 8;
      axi[p] = a[0]; ayi[p] = a[1]; azi[p] = a[2];
      any |= act[p] != 0.f;
    }
  }

  __shared__ float sh[10][kSnapTile];  // x y z m vx vy vz ax ay az
  float sum[kSnapPer][3], comp[kSnapPer][3];
#pragma unroll
  for (int p = 0; p < kSnapPer; ++p)
#pragma unroll
    for (int k = 0; k < 3; ++k) sum[p][k] = comp[p][k] = 0.f;

  if (__syncthreads_or(any)) {  // uniform over the block: barriers stay legal
    for (int j0 = 0; j0 < n_s; j0 += kSnapTile) {
      const int nj = min(kSnapTile, n_s - j0);
      if (threadIdx.x < nj) {
        const size_t j = j0 + threadIdx.x;
#pragma unroll
        for (int r = 0; r < 7; ++r) sh[r][threadIdx.x] = src[r * n_s + j];
#pragma unroll
        for (int r = 0; r < 3; ++r) sh[7 + r][threadIdx.x] = sacc[r * n_s + j];
      }
      __syncthreads();
      float part[kSnapPer][3];
#pragma unroll
      for (int p = 0; p < kSnapPer; ++p)
#pragma unroll
        for (int k = 0; k < 3; ++k) part[p][k] = 0.f;
#pragma unroll 2
      for (int j = slice; j < nj; j += kSnapSlices) {
        const float sx = sh[0][j], sy = sh[1][j], sz = sh[2][j], mj = sh[3][j];
        const float svx = sh[4][j], svy = sh[5][j], svz = sh[6][j];
        const float sax = sh[7][j], say = sh[8][j], saz = sh[9][j];
#pragma unroll
        for (int p = 0; p < kSnapPer; ++p) {
          const float dx = sx - xi[p];
          const float dy = sy - yi[p];
          const float dz = sz - zi[p];
          const float dvx = svx - vxi[p];
          const float dvy = svy - vyi[p];
          const float dvz = svz - vzi[p];
          const float dax = sax - axi[p];
          const float day = say - ayi[p];
          const float daz = saz - azi[p];
          const float r2 = dx * dx + dy * dy + dz * dz;
          const float inv_r = r2 > 0.f ? rsqrtf(r2 + eps2) : 0.f;
          const float inv_r2 = inv_r * inv_r;
          const float t = mj * (inv_r2 * inv_r);
          const float alpha = (dx * dvx + dy * dvy + dz * dvz) * inv_r2;
          const float beta = (dvx * dvx + dvy * dvy + dvz * dvz
                              + dx * dax + dy * day + dz * daz) * inv_r2
                             + alpha * alpha;
          // t da - 6 alpha J - 3 beta P with P = t r and J = t v - 3 alpha P
          // (A0, A1), gathered as t (da + c1 v + c2 r)
          const float c1 = -6.f * alpha;
          const float c2 = fmaf(18.f * alpha, alpha, -3.f * beta);
          accumulate<kMixed>(part[p][0], sum[p][0], comp[p][0],
                             t * fmaf(c2, dx, fmaf(c1, dvx, dax)));
          accumulate<kMixed>(part[p][1], sum[p][1], comp[p][1],
                             t * fmaf(c2, dy, fmaf(c1, dvy, day)));
          accumulate<kMixed>(part[p][2], sum[p][2], comp[p][2],
                             t * fmaf(c2, dz, fmaf(c1, dvz, daz)));
        }
      }
      if constexpr (!kMixed) {
#pragma unroll
        for (int p = 0; p < kSnapPer; ++p)
#pragma unroll
          for (int k = 0; k < 3; ++k) sum[p][k] += part[p][k];
      }
      __syncthreads();  // the tile is consumed before the next one lands
    }
  }

  // the slices' partials meet in a fixed butterfly; the compensation folds
  // in after it, outside the activity gate
#pragma unroll
  for (int offset = 1; offset < kSnapSlices; offset *= 2)
#pragma unroll
    for (int p = 0; p < kSnapPer; ++p)
#pragma unroll
      for (int k = 0; k < 3; ++k) combine<kMixed>(sum[p][k], comp[p][k], offset);
  if (slice < kSnapPer && first + slice < n_t) {
    // lane `slice` of the group writes the group's target `slice`
    float s[3] = {0.f, 0.f, 0.f}, a = 0.f;
#pragma unroll
    for (int p = 0; p < kSnapPer; ++p) {
      if (p != slice) continue;
      a = act[p];
#pragma unroll
      for (int k = 0; k < 3; ++k) s[k] = sum[p][k] + comp[p][k];
    }
    float* o = out + static_cast<size_t>(first + slice) * 8;
#pragma unroll
    for (int k = 0; k < 3; ++k) o[k] = a * s[k];
#pragma unroll
    for (int k = 3; k < 8; ++k) o[k] = 0.f;
  }
}

}  // namespace

// Each launcher enqueues one kernel on `stream`, writes the number of
// blocks of its grid to `*blocks` and returns cudaGetLastError(): nonzero
// when the launch was refused.
extern "C" int nbody_acc_jerk_pot(const void* tgt, const void* src, void* out,
                                  int batch, int n_t, int n_s, float eps,
                                  int mixed, void* stream, int* blocks) {
  const float eps2 = eps * eps;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const float*>(tgt);
  const auto* x = static_cast<const float*>(src);
  auto* o = static_cast<float*>(out);
  const dim3 grid((n_t + kAccTargets - 1) / kAccTargets, batch);
  *blocks = static_cast<int>(grid.x * grid.y);
  if (mixed)
    acc_jerk_pot_kernel<true><<<grid, kAccThreads, 0, s>>>(t, x, o, n_t, n_s, eps2);
  else
    acc_jerk_pot_kernel<false><<<grid, kAccThreads, 0, s>>>(t, x, o, n_t, n_s, eps2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nbody_snap(const void* tgt, const void* src, const void* tacc,
                          const void* sacc, void* out, int batch, int n_t,
                          int n_s, float eps, int mixed, void* stream,
                          int* blocks) {
  const float eps2 = eps * eps;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const float*>(tgt);
  const auto* x = static_cast<const float*>(src);
  const auto* ta = static_cast<const float*>(tacc);
  const auto* sa = static_cast<const float*>(sacc);
  auto* o = static_cast<float*>(out);
  const dim3 grid((n_t + kSnapTargets - 1) / kSnapTargets, batch);
  *blocks = static_cast<int>(grid.x * grid.y);
  if (mixed)
    snap_kernel<true><<<grid, kSnapThreads, 0, s>>>(t, x, ta, sa, o, n_t, n_s, eps2);
  else
    snap_kernel<false><<<grid, kSnapThreads, 0, s>>>(t, x, ta, sa, o, n_t, n_s, eps2);
  return static_cast<int>(cudaGetLastError());
}
