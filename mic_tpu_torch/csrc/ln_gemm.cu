// LayerNorm folded into the prologue of a dense: out = layer_norm(x) @ W + b.
//
// Replaces mic_tpu/ops/ln_gemm.py::ln_gemm (_ln_gemm_kernel), the decode
// step's ln_self -> fused q/k/v projection under MIC_TPU_EXPERIMENTAL=ln_qkv.
// Rounding points, as the TPU kernel's: f32 statistics (mean, then the mean
// of squared deviations), xn = (x - mean) * rsqrt(var + eps) * scale + bias
// in f32 and rounded to bf16, an f32 product with W, the sum rounded to
// bf16, then the bf16 bias added (one more bf16 rounding).
//
// Bound: operations, at the flagship step (N = 1024 rows, D = 1024,
// O = 3072) 6.4 GFLOP against 14 MB.  Design: gemm_tile.cuh's 64 x 64 WMMA
// tile.  Each block first takes its 64 rows' statistics (a warp per row, two
// passes over the row), then normalises each 64 x 32 slice of x on its way
// into shared memory, so the normalised activations never reach device
// memory; W streams through the cp.async ring.  x is re-read from L2 by the
// blocks that share a row band.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tile.cuh"

namespace {

using gemm::bf16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct LoadNormalized {
  const bf16* x;
  const bf16* scale;
  const bf16* shift;
  const float* mean;  // (kBM,) in shared memory
  const float* rstd;
  int d, row0, m;

  __device__ __forceinline__ void operator()(bf16* dst, int kk) const {
    for (int i = threadIdx.x; i < gemm::kBM * (gemm::kBK / 8); i += gemm::kThreads) {
      const int r = i / (gemm::kBK / 8);
      const int c = (i % (gemm::kBK / 8)) * 8;
      const int row = min(row0 + r, m - 1);
      float v[8], g[8], s[8];
      gemm::unpack8(x + static_cast<size_t>(row) * d + kk + c, v);
      gemm::unpack8(scale + kk + c, g);
      gemm::unpack8(shift + kk + c, s);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float xn = __fmul_rn(__fsub_rn(v[j], mean[r]), rstd[r]);
        v[j] = __fadd_rn(__fmul_rn(xn, g[j]), s[j]);
      }
      gemm::pack8(v, dst + r * gemm::kLda + c);
    }
  }
};

struct AddBias {
  bf16* out;
  const bf16* bias;
  int o;

  __device__ __forceinline__ void operator()(const float* c, int row, int col) const {
    float v[8], bv[8];
    gemm::unpack8(bias + col, bv);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = gemm::bf16_round(c[j]) + bv[j];
    gemm::pack8(v, out + static_cast<size_t>(row) * o + col);
  }
};

__global__ void __launch_bounds__(gemm::kThreads)
ln_gemm_kernel(const bf16* __restrict__ x,      // (N, D)
               const bf16* __restrict__ scale,  // (D,)
               const bf16* __restrict__ shift,  // (D,)
               const bf16* __restrict__ w,      // (D, O)
               const bf16* __restrict__ bias,   // (O,)
               bf16* __restrict__ out,          // (N, O)
               int n, int d, int o, float eps) {
  __shared__ __align__(128) unsigned char smem[gemm::kSmemBytes];
  __shared__ float mean[gemm::kBM];
  __shared__ float rstd[gemm::kBM];
  const int row0 = blockIdx.y * gemm::kBM;
  const int col0 = blockIdx.x * gemm::kBN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < gemm::kBM; r += gemm::kThreads / 32) {
    const bf16* row = x + static_cast<size_t>(min(row0 + r, n - 1)) * d;
    float sum = 0.f;
    for (int c = 8 * lane; c < d; c += 8 * 32) {
      float v[8];
      gemm::unpack8(row + c, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += v[j];
    }
    const float mu = __fdiv_rn(warp_sum(sum), static_cast<float>(d));
    float sq = 0.f;
    for (int c = 8 * lane; c < d; c += 8 * 32) {
      float v[8];
      gemm::unpack8(row + c, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float dv = v[j] - mu;
        sq = fmaf(dv, dv, sq);
      }
    }
    const float var = __fdiv_rn(warp_sum(sq), static_cast<float>(d));
    if (lane == 0) {
      mean[r] = mu;
      rstd[r] = __fdiv_rn(1.f, __fsqrt_rn(var + eps));
    }
  }
  __syncthreads();
  const LoadNormalized load{x, scale, shift, mean, rstd, d, row0, n};
  const AddBias epi{out, bias, o};
  gemm::tile(load, w, o, d, row0, col0, n, smem, epi);
}

}  // namespace

extern "C" int mic_ln_gemm_bf16(void* x, void* scale, void* shift, void* w, void* bias, void* out,
                                int n, int d, int o, float eps, void* stream) {
  if (n < 1 || d < gemm::kBK || d % gemm::kBK || o < gemm::kBN || o % gemm::kBN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(o / gemm::kBN, (n + gemm::kBM - 1) / gemm::kBM);
  ln_gemm_kernel<<<grid, gemm::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(scale),
      static_cast<const bf16*>(shift), static_cast<const bf16*>(w),
      static_cast<const bf16*>(bias), static_cast<bf16*>(out), n, d, o, eps);
  return static_cast<int>(cudaGetLastError());
}
