// A 64 x 64 output tile of C = A @ B on the tensor cores, shared by the
// LN -> GEMM kernel (ln_gemm.cu), the fused MLP (fused_mlp.cu) and the int8
// dequant GEMM (int8_matmul.cu).
//
// A is (M, depth) row-major bf16, produced slice by slice by the caller's
// loader (copied as it is, or layer-normalised on the way); B is
// (depth, ldb) row-major bf16, the (in, out) layout of mic_tpu's dense
// kernels, copied as it is (``tile``) or produced by a loader of the
// caller's too (``tile_with``: int8 weights dequantised on the way).
// Slices of depth 32 stream through a three-stage ring in shared
// memory (cp.async for B, and for A where it is copied as it is); four
// warps each own a 32 x 32 quarter of the tile as 2 x 2 WMMA (mma.sync)
// bf16 fragments with f32 accumulation.  After the last slice the f32 tile
// lands in shared memory and the caller's epilogue writes it, eight
// consecutive columns a thread.  The sum over depth is one fixed order: no
// split and no atomics, so reruns are bit-equal.
//
// Shapes the caller of ``tile`` guarantees: depth % 32 == 0, ldb % 64 == 0,
// every row 16-byte aligned.  Rows of A past M re-read row M - 1 and are not
// written.  A loader of ``tile_with`` handles its own edges.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {
namespace gemm {

using bf16 = __nv_bfloat16;
using nvcuda::wmma::accumulator;
using nvcuda::wmma::fragment;
using nvcuda::wmma::matrix_a;
using nvcuda::wmma::matrix_b;
using nvcuda::wmma::mem_row_major;
using nvcuda::wmma::row_major;

constexpr int kBM = 64;        // rows of A (and C) per block
constexpr int kBN = 64;        // columns of B (and C) per block
constexpr int kBK = 32;        // depth of one slice
constexpr int kStages = 3;
constexpr int kThreads = 128;  // 4 warps
constexpr int kLda = kBK + 8;  // bf16 pitch of an A slice (bank padding)
constexpr int kLdb = kBN + 8;  // bf16 pitch of a B slice
constexpr int kLdc = kBN + 4;  // f32 pitch of the C tile
constexpr int kATile = kBM * kLda;
constexpr int kBTile = kBK * kLdb;
constexpr size_t kRingBytes = static_cast<size_t>(kStages) * (kATile + kBTile) * sizeof(bf16);
constexpr size_t kCBytes = static_cast<size_t>(kBM) * kLdc * sizeof(float);
constexpr size_t kSmemBytes = kRingBytes > kCBytes ? kRingBytes : kCBytes;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

// A copied as it is: rows row0.. of a (M, lda) matrix.
struct LoadRows {
  const bf16* a;
  int lda, row0, m;

  __device__ __forceinline__ void operator()(bf16* dst, int kk) const {
    for (int i = threadIdx.x; i < kBM * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8);
      const int c = (i % (kBK / 8)) * 8;
      const int row = min(row0 + r, m - 1);
      cp_async16(dst + r * kLda + c, a + static_cast<size_t>(row) * lda + kk + c);
    }
  }
};

// B copied as it is: rows kk.. and columns col0.. of a (depth, ldb) matrix.
struct LoadCols {
  const bf16* b;
  int ldb, col0;

  __device__ __forceinline__ void operator()(bf16* dst, int kk) const {
    for (int i = threadIdx.x; i < kBK * (kBN / 8); i += kThreads) {
      const int r = i / (kBN / 8);
      const int c = (i % (kBN / 8)) * 8;
      cp_async16(dst + r * kLdb + c, b + static_cast<size_t>(kk + r) * ldb + col0 + c);
    }
  }
};

// Computes the block's tile from the slices load_a(dst, kk) and
// load_b(dst, kk) write (A's 64 x 32 at pitch kLda, B's 32 x 64 at pitch
// kLdb), then epi(c_row, row, col) for each run of eight columns of each
// row < m, c_row pointing at the eight f32 sums.
template <class LoadA, class LoadB, class Epilogue>
__device__ __forceinline__ void tile_with(const LoadA& load_a, const LoadB& load_b, int depth,
                                          int row0, int col0, int m, unsigned char* smem,
                                          const Epilogue& epi) {
  bf16* as = reinterpret_cast<bf16*>(smem);
  bf16* bs = as + kStages * kATile;
  float* cs = reinterpret_cast<float*>(smem);  // after the ring is drained
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;
  const int nk = depth / kBK;

  auto load_slice = [&](int s) {
    const int kk = s * kBK;
    load_a(as + (s % kStages) * kATile, kk);
    load_b(bs + (s % kStages) * kBTile, kk);
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_slice(s);
    cp_async_commit();
  }

  fragment<accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.f);

  for (int s = 0; s < nk; ++s) {
    cp_async_wait_ring();
    __syncthreads();
    // refill the stage every thread finished with in the previous iteration
    if (s + kStages - 1 < nk) load_slice(s + kStages - 1);
    cp_async_commit();

    const bf16* a_tile = as + (s % kStages) * kATile;
    const bf16* b_tile = bs + (s % kStages) * kBTile;
#pragma unroll
    for (int k16 = 0; k16 < kBK; k16 += 16) {
      fragment<matrix_a, 16, 16, 16, bf16, row_major> fa[2];
      fragment<matrix_b, 16, 16, 16, bf16, row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        nvcuda::wmma::load_matrix_sync(fa[i], a_tile + (wm + 16 * i) * kLda + k16, kLda);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        nvcuda::wmma::load_matrix_sync(fb[j], b_tile + k16 * kLdb + wn + 16 * j, kLdb);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) nvcuda::wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      nvcuda::wmma::store_matrix_sync(cs + (wm + 16 * i) * kLdc + wn + 16 * j, acc[i][j], kLdc,
                                      mem_row_major);
  __syncthreads();
  for (int i = tid; i < kBM * (kBN / 8); i += kThreads) {
    const int r = i / (kBN / 8);
    const int c = (i % (kBN / 8)) * 8;
    if (row0 + r < m) epi(cs + r * kLdc + c, row0 + r, col0 + c);
  }
}

// The tile with B (depth, ldb) copied as it is.
template <class LoadA, class Epilogue>
__device__ __forceinline__ void tile(const LoadA& load_a, const bf16* __restrict__ b, int ldb,
                                     int depth, int row0, int col0, int m, unsigned char* smem,
                                     const Epilogue& epi) {
  tile_with(load_a, LoadCols{b, ldb, col0}, depth, row0, col0, m, smem, epi);
}

// eight bf16 values to and from floats
__device__ __forceinline__ void unpack8(const bf16* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(pair[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void pack8(const float* f, bf16* p) {
  uint4 raw;
  __nv_bfloat162* pair = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) pair[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

}  // namespace gemm
}  // namespace
