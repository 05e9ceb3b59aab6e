// A bf16 x int8 GEMM with per-output-channel scales, dequantised on chip.
//
// Replaces mic_tpu/ops/int8_matmul.py::int8_matmul (_kernel): x (M, K)
// bf16, w_q (K, N) int8 row-major, scale (N,) f32 ->
//
//   w[k, n]  = bf16( bf16(w_q[k, n]) * bf16(scale[n]) )      (one rounding)
//   out[m, n] = bf16( sum_k x[m, k] * w[k, n] )                (f32 sums)
//
// the TPU kernel's arithmetic.  Any M, K and N: the TPU kernel's pad of N to
// a multiple of 128 and its XLA fallback at M % 8 or K % 128 were tiling
// needs of the TPU and have no counterpart here.
//
// Bound: at decode shapes the int8 weight stream (M <= 1024: 3 MB for
// K=1024, N=3072 against 6.4 GFLOP, operations at M=1024 and bytes at M=4).
// Design: gemm_tile.cuh's 64 x 64 WMMA tile; the weight slice is read as
// int8 (eight bytes a thread where N % 8 == 0), dequantised in registers
// with the block's 64 bf16 scales from shared memory, and stored to the
// ring as bf16, so the bf16 weight never reaches device memory.  Edges past
// K (in both operands) are zero-filled and columns past N are not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tile.cuh"

namespace {

using gemm::bf16;

// x rows row0.., depth columns kk..kk+31, zeros past K
struct LoadX {
  const bf16* x;
  int k, row0, m;
  bool vec;  // K % 8 == 0: every row 16-byte aligned

  __device__ __forceinline__ void operator()(bf16* dst, int kk) const {
    for (int i = threadIdx.x; i < gemm::kBM * (gemm::kBK / 8); i += gemm::kThreads) {
      const int r = i / (gemm::kBK / 8);
      const int c = (i % (gemm::kBK / 8)) * 8;
      const bf16* src = x + static_cast<size_t>(min(row0 + r, m - 1)) * k + kk + c;
      bf16* d = dst + r * gemm::kLda + c;
      if (vec && kk + c + 8 <= k) {
        gemm::cp_async16(d, src);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) d[j] = kk + c + j < k ? src[j] : __float2bfloat16_rn(0.f);
      }
    }
  }
};

// w_q rows kk..kk+31, columns col0..col0+63, dequantised; zeros past K or N
struct LoadWq {
  const int8_t* w;
  const float* scale;  // (kBN,) bf16-rounded scales of the block's columns, in shared memory
  int k, n, col0;
  bool vec;  // N % 8 == 0: eight-byte runs aligned

  __device__ __forceinline__ void operator()(bf16* dst, int kk) const {
    for (int i = threadIdx.x; i < gemm::kBK * (gemm::kBN / 8); i += gemm::kThreads) {
      const int r = i / (gemm::kBN / 8);
      const int c = (i % (gemm::kBN / 8)) * 8;
      const int kr = kk + r;
      const int col = col0 + c;
      uint2 raw = make_uint2(0u, 0u);
      int8_t* v = reinterpret_cast<int8_t*>(&raw);
      if (kr < k) {
        const int8_t* src = w + static_cast<size_t>(kr) * n + col;
        if (vec && col + 8 <= n) {
          raw = *reinterpret_cast<const uint2*>(src);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = col + j < n ? src[j] : 0;
        }
      }
      float f[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = gemm::bf16_round(static_cast<float>(v[j]) * scale[c + j]);
      gemm::pack8(f, dst + r * gemm::kLdb + c);
    }
  }
};

struct Store {
  bf16* out;
  int n;
  bool vec;  // N % 8 == 0: eight-column runs 16-byte aligned

  __device__ __forceinline__ void operator()(const float* c, int row, int col) const {
    bf16* o = out + static_cast<size_t>(row) * n + col;
    if (vec && col + 8 <= n) {
      gemm::pack8(c, o);
    } else {
      for (int j = 0; j < 8 && col + j < n; ++j) o[j] = __float2bfloat16_rn(c[j]);
    }
  }
};

__global__ void __launch_bounds__(gemm::kThreads)
int8_matmul_kernel(const bf16* __restrict__ x,       // (M, K)
                   const int8_t* __restrict__ w,     // (K, N)
                   const float* __restrict__ scale,  // (N,)
                   bf16* __restrict__ out,           // (M, N)
                   int m, int k, int n) {
  __shared__ __align__(128) unsigned char smem[gemm::kSmemBytes];
  __shared__ float ws[gemm::kBN];
  const int row0 = blockIdx.y * gemm::kBM;
  const int col0 = blockIdx.x * gemm::kBN;
  for (int c = threadIdx.x; c < gemm::kBN; c += gemm::kThreads) {
    ws[c] = col0 + c < n ? gemm::bf16_round(scale[col0 + c]) : 0.f;
  }
  __syncthreads();
  const LoadX load_x{x, k, row0, m, k % 8 == 0};
  const LoadWq load_w{w, ws, k, n, col0, n % 8 == 0};
  const Store epi{out, n, n % 8 == 0};
  const int depth = (k + gemm::kBK - 1) / gemm::kBK * gemm::kBK;
  gemm::tile_with(load_x, load_w, depth, row0, col0, m, smem, epi);
}

}  // namespace

extern "C" int mic_int8_matmul_bf16(void* x, void* w_q, void* scale, void* out, int m, int k,
                                    int n, void* stream) {
  const int row_tiles = (m + gemm::kBM - 1) / gemm::kBM;
  if (m < 1 || k < 1 || n < 1 || row_tiles > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n + gemm::kBN - 1) / gemm::kBN, row_tiles);
  int8_matmul_kernel<<<grid, gemm::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(w_q),
      static_cast<const float*>(scale), static_cast<bf16*>(out), m, k, n);
  return static_cast<int>(cudaGetLastError());
}
