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
//     2, t 1, alpha 6, beta 14, -3alpha -3beta 6alpha 3, P 3, J 9, S 15,
//     accumulate 3  = 72;
//   mixed mode adds a bf16 round trip per term (conversions, no flops) and
//     replaces each accumulate-add with a 7-flop two-sum: 85 and 90.
// The bound is ops * N_t * N_s / 67 TFLOP/s (fp32, non-tensor): 0.172 ms
// (K1) and 0.289 ms (K2) at N_t = N_s = 16384.  The bytes moved (each
// operand read once, each output written once) are ~1.6 MB at that size,
// under 1 us at 3.35 TB/s.  rsqrtf issues on the SFU at an eighth of the
// FMA rate, so the practical ceiling sits a little under the flop bound.
//
// What the design does about it: one thread per target row keeps its seven
// (or ten) sums in registers; the sources stream through shared memory one
// tile of kTile at a time, loaded with coalesced row reads of the (8, N_s)
// layout and read back as broadcasts, so the inner loop is pure register
// arithmetic with no global traffic.  A block whose targets are all inactive
// skips its source loop (__syncthreads_or), the analogue of the reference's
// pl.when.  In fp32 mode each tile is summed into a tile partial that is
// then added to the running sum (the reference sums within a j-block and
// accumulates across blocks the same way).  Simple first: at N = 16384 the
// grid holds only N/32 warps, about four per SM, which later work can raise
// by splitting the source axis across threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // targets per block, one thread each
constexpr int kTile = kThreads;  // sources staged per shared-memory tile

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

template <bool kMixed>
__global__ void __launch_bounds__(kThreads)
acc_jerk_pot_kernel(const float* __restrict__ tgt,
                    const float* __restrict__ src, float* __restrict__ out,
                    int n_t, int n_s, float eps2) {
  const size_t b = blockIdx.y;
  tgt += b * n_t * 8;
  src += b * 8 * n_s;
  out += b * n_t * 8;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool row = i < n_t;

  float xi = 0.f, yi = 0.f, zi = 0.f, act = 0.f;
  float vxi = 0.f, vyi = 0.f, vzi = 0.f;
  if (row) {
    const float* t = tgt + static_cast<size_t>(i) * 8;
    xi = t[0]; yi = t[1]; zi = t[2]; act = t[3];
    vxi = t[4]; vyi = t[5]; vzi = t[6];
  }

  __shared__ float sh[7][kTile];  // x y z m vx vy vz of one source tile
  float sum[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float comp[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  if (__syncthreads_or(act != 0.f)) {
    for (int j0 = 0; j0 < n_s; j0 += kTile) {
      const int nj = min(kTile, n_s - j0);
      if (threadIdx.x < nj) {
#pragma unroll
        for (int r = 0; r < 7; ++r)
          sh[r][threadIdx.x] = src[static_cast<size_t>(r) * n_s + j0 + threadIdx.x];
      }
      __syncthreads();
      float part[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int j = 0; j < nj; ++j) {
        const float dx = sh[0][j] - xi;
        const float dy = sh[1][j] - yi;
        const float dz = sh[2][j] - zi;
        const float mj = sh[3][j];
        const float dvx = sh[4][j] - vxi;
        const float dvy = sh[5][j] - vyi;
        const float dvz = sh[6][j] - vzi;
        const float r2 = dx * dx + dy * dy + dz * dz;
        // a self-pair (r2 == 0) contributes exactly zero, the potential too
        const float inv_r = r2 > 0.f ? rsqrtf(r2 + eps2) : 0.f;
        const float inv_r2 = inv_r * inv_r;
        const float t = mj * (inv_r2 * inv_r);
        const float q = -3.f * (dx * dvx + dy * dvy + dz * dvz) * inv_r2;
        accumulate<kMixed>(part[0], sum[0], comp[0], t * dx);
        accumulate<kMixed>(part[1], sum[1], comp[1], t * dy);
        accumulate<kMixed>(part[2], sum[2], comp[2], t * dz);
        accumulate<kMixed>(part[3], sum[3], comp[3], t * (dvx + q * dx));
        accumulate<kMixed>(part[4], sum[4], comp[4], t * (dvy + q * dy));
        accumulate<kMixed>(part[5], sum[5], comp[5], t * (dvz + q * dz));
        accumulate<kMixed>(part[6], sum[6], comp[6], mj * inv_r);
      }
      if constexpr (!kMixed) {
#pragma unroll
        for (int k = 0; k < 7; ++k) sum[k] += part[k];
      }
      __syncthreads();  // the tile is consumed before the next one lands
    }
  }

  // the compensation folds in here, outside the activity gate
  if (row) {
    float* o = out + static_cast<size_t>(i) * 8;
#pragma unroll
    for (int k = 0; k < 6; ++k) o[k] = act * (sum[k] + comp[k]);
    o[6] = -(act * (sum[6] + comp[6]));
    o[7] = 0.f;
  }
}

template <bool kMixed>
__global__ void __launch_bounds__(kThreads)
snap_kernel(const float* __restrict__ tgt, const float* __restrict__ src,
            const float* __restrict__ tacc, const float* __restrict__ sacc,
            float* __restrict__ out, int n_t, int n_s, float eps2) {
  const size_t b = blockIdx.y;
  tgt += b * n_t * 8;
  tacc += b * n_t * 8;
  src += b * 8 * n_s;
  sacc += b * 8 * n_s;
  out += b * n_t * 8;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool row = i < n_t;

  float xi = 0.f, yi = 0.f, zi = 0.f, act = 0.f;
  float vxi = 0.f, vyi = 0.f, vzi = 0.f, axi = 0.f, ayi = 0.f, azi = 0.f;
  if (row) {
    const float* t = tgt + static_cast<size_t>(i) * 8;
    xi = t[0]; yi = t[1]; zi = t[2]; act = t[3];
    vxi = t[4]; vyi = t[5]; vzi = t[6];
    const float* a = tacc + static_cast<size_t>(i) * 8;
    axi = a[0]; ayi = a[1]; azi = a[2];
  }

  __shared__ float sh[10][kTile];  // x y z m vx vy vz ax ay az
  float sum[3] = {0.f, 0.f, 0.f};
  float comp[3] = {0.f, 0.f, 0.f};

  if (__syncthreads_or(act != 0.f)) {
    for (int j0 = 0; j0 < n_s; j0 += kTile) {
      const int nj = min(kTile, n_s - j0);
      if (threadIdx.x < nj) {
        const size_t j = j0 + threadIdx.x;
#pragma unroll
        for (int r = 0; r < 7; ++r) sh[r][threadIdx.x] = src[r * n_s + j];
#pragma unroll
        for (int r = 0; r < 3; ++r) sh[7 + r][threadIdx.x] = sacc[r * n_s + j];
      }
      __syncthreads();
      float part[3] = {0.f, 0.f, 0.f};
#pragma unroll 4
      for (int j = 0; j < nj; ++j) {
        const float dx = sh[0][j] - xi;
        const float dy = sh[1][j] - yi;
        const float dz = sh[2][j] - zi;
        const float mj = sh[3][j];
        const float dvx = sh[4][j] - vxi;
        const float dvy = sh[5][j] - vyi;
        const float dvz = sh[6][j] - vzi;
        const float dax = sh[7][j] - axi;
        const float day = sh[8][j] - ayi;
        const float daz = sh[9][j] - azi;
        const float r2 = dx * dx + dy * dy + dz * dz;
        const float inv_r = r2 > 0.f ? rsqrtf(r2 + eps2) : 0.f;
        const float inv_r2 = inv_r * inv_r;
        const float t = mj * (inv_r2 * inv_r);
        const float alpha = (dx * dvx + dy * dvy + dz * dvz) * inv_r2;
        const float beta = (dvx * dvx + dvy * dvy + dvz * dvz
                            + dx * dax + dy * day + dz * daz) * inv_r2
                           + alpha * alpha;
        const float a3 = -3.f * alpha, b3 = -3.f * beta, a6 = 6.f * alpha;
        const float px = t * dx, py = t * dy, pz = t * dz;       // A0
        const float jx = t * dvx + a3 * px;                      // A1
        const float jy = t * dvy + a3 * py;
        const float jz = t * dvz + a3 * pz;
        accumulate<kMixed>(part[0], sum[0], comp[0], t * dax - a6 * jx + b3 * px);
        accumulate<kMixed>(part[1], sum[1], comp[1], t * day - a6 * jy + b3 * py);
        accumulate<kMixed>(part[2], sum[2], comp[2], t * daz - a6 * jz + b3 * pz);
      }
      if constexpr (!kMixed) {
#pragma unroll
        for (int k = 0; k < 3; ++k) sum[k] += part[k];
      }
      __syncthreads();
    }
  }

  if (row) {
    float* o = out + static_cast<size_t>(i) * 8;
#pragma unroll
    for (int k = 0; k < 3; ++k) o[k] = act * (sum[k] + comp[k]);
#pragma unroll
    for (int k = 3; k < 8; ++k) o[k] = 0.f;
  }
}

dim3 grid_for(int batch, int n_t) {
  return dim3((n_t + kThreads - 1) / kThreads, batch);
}

}  // namespace

// Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError(): nonzero when the launch was refused.
extern "C" int nbody_acc_jerk_pot(const void* tgt, const void* src, void* out,
                                  int batch, int n_t, int n_s, float eps,
                                  int mixed, void* stream) {
  const float eps2 = eps * eps;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const float*>(tgt);
  const auto* x = static_cast<const float*>(src);
  auto* o = static_cast<float*>(out);
  if (mixed)
    acc_jerk_pot_kernel<true><<<grid_for(batch, n_t), kThreads, 0, s>>>(t, x, o, n_t, n_s, eps2);
  else
    acc_jerk_pot_kernel<false><<<grid_for(batch, n_t), kThreads, 0, s>>>(t, x, o, n_t, n_s, eps2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nbody_snap(const void* tgt, const void* src, const void* tacc,
                          const void* sacc, void* out, int batch, int n_t,
                          int n_s, float eps, int mixed, void* stream) {
  const float eps2 = eps * eps;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const float*>(tgt);
  const auto* x = static_cast<const float*>(src);
  const auto* ta = static_cast<const float*>(tacc);
  const auto* sa = static_cast<const float*>(sacc);
  auto* o = static_cast<float*>(out);
  if (mixed)
    snap_kernel<true><<<grid_for(batch, n_t), kThreads, 0, s>>>(t, x, ta, sa, o, n_t, n_s, eps2);
  else
    snap_kernel<false><<<grid_for(batch, n_t), kThreads, 0, s>>>(t, x, ta, sa, o, n_t, n_s, eps2);
  return static_cast<int>(cudaGetLastError());
}
