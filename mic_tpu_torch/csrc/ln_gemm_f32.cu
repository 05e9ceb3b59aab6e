// LayerNorm folded into a dense on a float32 model: out = layer_norm(x) @ W + b.
//
// Replaces mic_tpu/ops/ln_gemm.py::ln_gemm (_ln_gemm_kernel) at float32, the
// decode step's ln_self -> fused q/k/v projection under
// MIC_TPU_EXPERIMENTAL=ln_qkv on the default float32 model.  mic_tpu's
// kernel rounds the normalised row to the weight's dtype and the sum to x's,
// which at float32 round nothing: f32 statistics (the mean, then the mean of
// squared deviations), xn = (x - mean) * rsqrt(var + eps) * scale + shift
// in f32, an f32 product with f32 accumulation (no TF32), the bias added.
//
// Bound: operations, at the flagship step (N = 1024 rows, D = 1024,
// O = 3072) 6.4 GFLOP against 17 MB; bytes at small N (N = 32: W's 12.6 MB).
// Design: float32-accurate products on the tensor cores, the 3xTF32
// mma.sync tile of csrc/tf32x3_mma.cuh, whose fragments come from shared
// memory in any layout: TF32 wgmma reads both operands K-major only, and W
// (D, O) is MN-major as stored.  An FFMA tile (8 x 8 sums a thread) took
// 0.2304 ms at the flagship step, slower than the plain version (PERF.md
// §6).
//   - the row statistics first, by their own small kernel (a warp a row,
//     the row read twice, 2 x 4 bytes a row written), so that the GEMM's
//     column tiles do not each recompute them;
//   - a 128 x 96 output tile a block of eight warps, each warp 64 rows x 24
//     columns (four 16-row by three 8-column mma tiles), over 16-deep
//     slices double-buffered in shared memory: the next slice's raw x and
//     W are loaded into registers while the current one's products run,
//     x normalised on its way to shared memory; at the flagship 256 tiles,
//     two waves of the 132 SMs;
//   - each slice's products go into zeroed sums that FADDs add to the
//     running ones (the tensor core truncates what it accumulates,
//     csrc/tf32x3_wgmma.cuh);
//   - where the tiles leave SMs idle (N = 32: 32 tiles) the depth is cut
//     into splits of whole slices (ops/ln_gemm.py::ln_splits_f32), their
//     f32 partials summed in split order with the bias by a second kernel.
// Rows past N are normalised with mean 0 and rstd 0 and never written; W's
// columns past O are read as zeros and never written.  Every sum has one
// fixed order: reruns are bit-equal.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3_mma.cuh"

namespace {
namespace ln_f32 {

using namespace tf32x3_mma;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The statistics of rows blockIdx.x * 8 ..: a warp a row, the sum lane by
// lane (float4 runs) and across the warp, the mean, then the squared
// deviations the same way; rstd in round-to-nearest.
__global__ void __launch_bounds__(kThreads) stats_kernel(const float* __restrict__ x,
                                                         float* __restrict__ mean,
                                                         float* __restrict__ rstd, int n, int d,
                                                         float eps) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const float* xr = x + static_cast<size_t>(row) * d;
  float s = 0.f;
  for (int c = 4 * lane; c < d; c += 128) {
    const float4 v = *reinterpret_cast<const float4*>(xr + c);
    s += v.x;
    s += v.y;
    s += v.z;
    s += v.w;
  }
  const float mu = __fdiv_rn(warp_sum(s), static_cast<float>(d));
  float q = 0.f;
  for (int c = 4 * lane; c < d; c += 128) {
    const float4 v = *reinterpret_cast<const float4*>(xr + c);
    const float e[4] = {v.x - mu, v.y - mu, v.z - mu, v.w - mu};
#pragma unroll
    for (int j = 0; j < 4; ++j) q = fmaf(e[j], e[j], q);
  }
  const float var = __fdiv_rn(warp_sum(q), static_cast<float>(d));
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = __frsqrt_rn(var + eps);
  }
}

struct Args {
  const float* x;      // (n, d)
  const float* scale;  // (d,)
  const float* shift;  // (d,)
  const float* w;      // (d, o)
  const float* bias;   // (o,)
  const float* mean;   // (n,)
  const float* rstd;   // (n,)
  float* part;         // (splits, n, o) where split, else unread
  float* out;          // (n, o)
  int n, d, o;
};

__global__ void __launch_bounds__(kThreads, 1) gemm_kernel(const Args a) {
  __shared__ __align__(16) float xs[2][kRows][kAPitch];  // normalised x, K-major
  __shared__ __align__(16) float ws[2][kDepth][kBPitch];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.y * kRows;
  const int c0 = blockIdx.x * kCols;
  int s0, s1;
  split_range(a.d / kDepth, s0, s1);

  // x row xr's eight columns xc.. of a slice, normalised on the way
  const int xr = tid >> 1;
  const int xc = 8 * (tid & 1);
  const bool x_live = m0 + xr < a.n;
  const float mu = x_live ? a.mean[m0 + xr] : 0.f;
  const float rs = x_live ? a.rstd[m0 + xr] : 0.f;
  const float* xrow = a.x + static_cast<size_t>(x_live ? m0 + xr : 0) * a.d + xc;

  Acc acc;
  zero(acc);
  walk<float[8]>(
      acc, a.w, a.d, c0, a.o, ws, s0, s1,
      [&](int s, float (&xn)[8]) {
        const int k = s * kDepth;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 v = x_live ? *reinterpret_cast<const float4*>(xrow + k + 4 * h)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
          const float4 sc = *reinterpret_cast<const float4*>(a.scale + k + xc + 4 * h);
          const float4 sh = *reinterpret_cast<const float4*>(a.shift + k + xc + 4 * h);
          const float vv[4] = {v.x, v.y, v.z, v.w};
          const float ss[4] = {sc.x, sc.y, sc.z, sc.w};
          const float hh[4] = {sh.x, sh.y, sh.z, sh.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            xn[4 * h + j] = __fadd_rn(__fmul_rn(__fmul_rn(vv[j] - mu, rs), ss[j]), hh[j]);
          }
        }
      },
      [&](int buf, const float (&xn)[8]) {
        *reinterpret_cast<float4*>(&xs[buf][xr][xc]) = make_float4(xn[0], xn[1], xn[2], xn[3]);
        *reinterpret_cast<float4*>(&xs[buf][xr][xc + 4]) =
            make_float4(xn[4], xn[5], xn[6], xn[7]);
      },
      [&](int buf, int m, int k) { return xs[buf][m][k]; });

  const bool split_z = gridDim.z > 1;
  for_each_pair(acc, m0, c0, a.n, a.o, warp & 1, warp >> 1, lane,
                [&](int row, int col, float2 v) {
    const size_t at = static_cast<size_t>(row) * a.o + col;
    if (split_z) {
      *reinterpret_cast<float2*>(a.part + static_cast<size_t>(blockIdx.z) * a.n * a.o + at) = v;
    } else {
      const float2 b = *reinterpret_cast<const float2*>(a.bias + col);
      v.x += b.x;
      v.y += b.y;
      *reinterpret_cast<float2*>(a.out + at) = v;
    }
  });
}

}  // namespace ln_f32
}  // namespace

// x (N, D), scale and shift (D,), w (D, O), bias (O,), out (N, O), all f32;
// stats f32 scratch of 2 N values (the rows' mean, then rstd); part f32
// scratch of splits N O values where splits > 1 (else unread).  splits cuts
// the D / 16 slices of the depth into that many splits
// (ops/ln_gemm.py::ln_splits_f32).
extern "C" int mic_ln_gemm_f32(void* x, void* scale, void* shift, void* w, void* bias,
                               void* stats, void* part, void* out, int n, int d, int o, float eps,
                               int splits, void* stream) {
  using namespace ln_f32;
  if (n < 1 || d < kDepth || d % 32 || o < 64 || o % 64 || splits < 1 ||
      splits > d / kDepth || splits > 65535 || (n + kRows - 1) / kRows > 65535 ||
      (part == nullptr && splits > 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mean = static_cast<float*>(stats);
  float* rstd = mean + n;
  const int warps = kThreads / 32;
  stats_kernel<<<(n + warps - 1) / warps, kThreads, 0, s>>>(static_cast<const float*>(x), mean,
                                                           rstd, n, d, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{static_cast<const float*>(x), static_cast<const float*>(scale),
               static_cast<const float*>(shift), static_cast<const float*>(w),
               static_cast<const float*>(bias), mean, rstd, static_cast<float*>(part),
               static_cast<float*>(out), n, d, o};
  const dim3 grid((o + kCols - 1) / kCols, (n + kRows - 1) / kRows, splits);
  gemm_kernel<<<grid, kThreads, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  // the splits' partials added in split order, then the bias
  return static_cast<int>(split_sum(a.part, splits, static_cast<size_t>(n) * o,
                                    BiasEpilogue<>{a.bias, a.out, o}, s));
}
