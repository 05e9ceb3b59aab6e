// Shared-memory tiles for the full-sequence attention kernels
// (small_attention.cu, flash_attention.cu).
//
// A tile is a 64 x 64 float32 matrix in shared memory with a row stride of
// 65 floats, so that a warp reading 16 consecutive entries of a row, or of
// a column, touches 16 different banks.  A block has 256 threads, 16 x 16;
// thread (ty, tx) owns the 4 x 4 entries (ty + 16 r, tx + 16 c) of a 64 x 64
// product (`mma_tile`).  The 16 threads that share a ty, and so a set of
// rows, are one half of a warp: a row reduction over them is four
// shuffles (`half_warp_sum`, `half_warp_max`).
//
// q, k and v arrive in their natural (B, T, H, 64) layout: the rows of one
// (image, head) are 64 contiguous elements H * 64 apart (`load_rows`,
// `store_rows`), so no operand is transposed in device memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace attn_tile {

constexpr int kDim = 64;                   // head dim; rows of a tile
constexpr int kLd = kDim + 1;              // row stride of a tile, in floats
constexpr int kThreads = 256;              // 16 x 16 threads, 4 x 4 entries each
constexpr int kTileFloats = kDim * kLd;
constexpr size_t kTileBytes = sizeof(float) * kTileFloats;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back (the TPU kernels' p.astype(dtype))
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

__device__ __forceinline__ int tile_y() { return threadIdx.x >> 4; }
__device__ __forceinline__ int tile_x() { return threadIdx.x & 15; }

// tile rows [0, rows) from `rows` rows of 64 elements, `stride` elements
// apart; rows [rows, 64) zero
template <typename T>
__device__ void load_rows(float* tile, const T* src, int rows, size_t stride) {
  for (int idx = threadIdx.x; idx < kDim * kDim; idx += kThreads) {
    const int r = idx >> 6, c = idx & (kDim - 1);
    tile[r * kLd + c] = r < rows ? to_float(src[r * stride + c]) : 0.f;
  }
}

// tile rows [0, rows) to `rows` rows of 64 elements, `stride` elements apart
template <typename T>
__device__ void store_rows(T* dst, const float* tile, int rows, size_t stride) {
  for (int idx = threadIdx.x; idx < rows * kDim; idx += kThreads) {
    const int r = idx >> 6, c = idx & (kDim - 1);
    dst[r * stride + c] = from_float<T>(tile[r * kLd + c]);
  }
}

// acc[r][c] += sum_{k < depth} A(ty + 16 r, k) * B(k, tx + 16 c), with
// A(i, k) = a[i * ai + k * ak] and B(k, j) = b[k * bk + j * bj]: the strides
// pick a tile or its transpose.  float32 FMAs in k order.
__device__ __forceinline__ void mma_tile(float (&acc)[4][4], const float* a, int ai, int ak,
                                         const float* b, int bk, int bj, int depth) {
  const int ty = tile_y(), tx = tile_x();
#pragma unroll 4
  for (int k = 0; k < depth; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = a[(ty + 16 * r) * ai + k * ak];
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = b[k * bk + (tx + 16 * c) * bj];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  }
}

// a thread's 4 x 4 entries into their places in a tile
__device__ __forceinline__ void put_tile(float* tile, const float (&acc)[4][4]) {
  const int ty = tile_y(), tx = tile_x();
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) tile[(ty + 16 * r) * kLd + tx + 16 * c] = acc[r][c];
  }
}

// reductions over the 16 threads that share a ty (one half of a warp)
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Lets `kernel` take `bytes` of dynamic shared memory, once per device, so
// that a launch inside a CUDA-graph capture makes no attribute call.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes, bool (&done)[64]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && done[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && device < 64) done[device] = true;
  return err;
}

}  // namespace attn_tile
