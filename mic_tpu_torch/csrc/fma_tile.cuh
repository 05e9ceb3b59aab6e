// A float32 tile product on the CUDA cores, used by the float32 instances
// of rows 7 and 8, the flash-CE forward and dl (csrc/flash_ce_f32.cu).
//
//   acc[i][j] = sum over k < D of A[row0 + r(i)][k] * B[col0 + c(j)][k]
//
// for one (16 TM) x (16 TN) output tile, A (M, D) and B (rows_b, D)
// row-major float32 (the hidden rows and the tied table as stored), 256
// threads a block.  Every product and sum is an IEEE f32 FMA (no TF32,
// which keeps about three decimal digits), each output summed in k order,
// so a rerun is bit-equal.  The bound here is the card's f32 FMA rate, 67
// TFLOP/s on an H100 SXM.  wgmma has no f32 x f32 form, but its TF32 form
// with each operand split into hi and lo reaches float32 accuracy at 165
// TFLOP/s of such products (csrc/tf32x3_wgmma.cuh, which row 4's float32
// bucket select and row 5's float32 selects moved to); rows 7 and 8 are
// the next to move.
//
// Thread (ty, tx) = (tid / 16, tid % 16) owns rows r(i) = 4 ty + 64 (i / 4)
// + i % 4 (i < TM) and columns c(j) = 4 tx + 64 (j / 4) + j % 4 (j < TN) of
// the tile, so that its reads of a slice from shared memory are 16-byte
// loads that a quarter warp takes without a bank conflict (A's as one
// broadcast).  Depth slices of kDepth values go through two shared-memory
// buffers, k-major: while the current slice's TM x TN FMAs a k run, each
// thread loads its 16-byte pieces of A and B of the next slice from device
// memory into registers, then stores them transposed into the other buffer
// (one barrier a slice).  Rows past M, columns past rows_b and depth past D
// read as zero, so D need only be a multiple of 4 (16-byte rows).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fma_tile {

template <int TM, int TN, int D>
struct Tile {
  static_assert((TM == 4 || TM == 8) && (TN == 4 || TN == 8), "4 or 8 outputs a side");
  static constexpr int kThreads = 256;
  static constexpr int kRows = 16 * TM;             // A rows (hidden rows) of the tile
  static constexpr int kCols = 16 * TN;             // B rows (vocab columns) of the tile
  static constexpr int kDepth = D;                  // depth of a slice
  static constexpr int kPitchA = kRows + 4;         // floats a k-row of A's slice
  static constexpr int kPitchB = kCols + 4;
  static constexpr int kSliceA = kDepth * kPitchA;  // floats of A's slice
  static constexpr int kBuffer = kSliceA + kDepth * kPitchB;
  static constexpr int kFloats = 2 * kBuffer;       // two buffers of A and B
  static constexpr int kPieces = kDepth / 4;        // 16-byte pieces a row of a slice
  static constexpr int kLoadsA = kRows * kPieces / kThreads;  // pieces a thread loads
  static constexpr int kLoadsB = kCols * kPieces / kThreads;
  static_assert(kLoadsA >= 1 && kLoadsB >= 1 && kRows * kPieces % kThreads == 0 &&
                kCols * kPieces % kThreads == 0, "whole pieces a thread");

  // the tile row of the thread's output index i, the tile column of j
  __device__ static __forceinline__ int row(int ty, int i) { return 4 * ty + 64 * (i >> 2) + (i & 3); }
  __device__ static __forceinline__ int col(int tx, int j) { return 4 * tx + 64 * (j >> 2) + (j & 3); }
};

// A piece of an operand's slice that one thread loads: its row in the
// tile, depth offset and source row (row 0's where the row is past the end).
struct Piece {
  const float* src;
  int row, k;
  bool ok;
};

template <int kPieces>
__device__ __forceinline__ Piece piece(const float* base, int first, int rows, int d, int p) {
  Piece x;
  x.row = p / kPieces;
  x.k = 4 * (p % kPieces);
  x.ok = first + x.row < rows;
  x.src = base + static_cast<size_t>(x.ok ? first + x.row : 0) * d;
  return x;
}

__device__ __forceinline__ float4 load(const Piece& x, int k0, int d) {
  const int k = k0 + x.k;
  return x.ok && k < d ? *reinterpret_cast<const float4*>(x.src + k)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
}

// v's four depth values into column x.row of rows x.k .. x.k + 3 of a
// k-major slice of the given pitch.
__device__ __forceinline__ void store(float* slice, int pitch, const Piece& x, float4 v) {
  float* s = slice + x.k * pitch + x.row;
  s[0] = v.x, s[pitch] = v.y, s[2 * pitch] = v.z, s[3 * pitch] = v.w;
}

// acc (zeroed here) <- the tile at (row0, col0); smem holds L::kFloats
// floats.  Every thread of the block calls it; it ends with a barrier, so
// the caller may reuse shared memory of its own right after.
template <typename L, int TM, int TN>
__device__ __forceinline__ void product(float (&acc)[TM][TN], const float* __restrict__ a, int m,
                                        int row0, const float* __restrict__ b, int rows_b,
                                        int col0, int d, float* smem) {
  static_assert(L::kRows == 16 * TM && L::kCols == 16 * TN, "the tile's outputs a thread");
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  Piece pa[L::kLoadsA], pb[L::kLoadsB];
#pragma unroll
  for (int p = 0; p < L::kLoadsA; ++p) {
    pa[p] = piece<L::kPieces>(a, row0, m, d, tid + p * L::kThreads);
  }
#pragma unroll
  for (int p = 0; p < L::kLoadsB; ++p) {
    pb[p] = piece<L::kPieces>(b, col0, rows_b, d, tid + p * L::kThreads);
  }
  float4 ra[L::kLoadsA], rb[L::kLoadsB];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int p = 0; p < L::kLoadsA; ++p) ra[p] = load(pa[p], k0, d);
#pragma unroll
    for (int p = 0; p < L::kLoadsB; ++p) rb[p] = load(pb[p], k0, d);
  };
  auto put = [&](float* buf) {
#pragma unroll
    for (int p = 0; p < L::kLoadsA; ++p) store(buf, L::kPitchA, pa[p], ra[p]);
#pragma unroll
    for (int p = 0; p < L::kLoadsB; ++p) store(buf + L::kSliceA, L::kPitchB, pb[p], rb[p]);
  };
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
  const int slices = (d + L::kDepth - 1) / L::kDepth;
  fetch(0);
  put(smem);
  __syncthreads();
  for (int s = 0; s < slices; ++s) {
    const float* cur = smem + (s & 1) * L::kBuffer;
    if (s + 1 < slices) fetch((s + 1) * L::kDepth);
#pragma unroll
    for (int k = 0; k < L::kDepth; ++k) {
      float x[TM], y[TN];
#pragma unroll
      for (int q = 0; q < TM / 4; ++q) {
        const float4 u = *reinterpret_cast<const float4*>(cur + k * L::kPitchA + 4 * ty + 64 * q);
        x[4 * q] = u.x, x[4 * q + 1] = u.y, x[4 * q + 2] = u.z, x[4 * q + 3] = u.w;
      }
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(cur + L::kSliceA + k * L::kPitchB +
                                                          4 * tx + 64 * q);
        y[4 * q] = v.x, y[4 * q + 1] = v.y, y[4 * q + 2] = v.z, y[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
      }
    }
    if (s + 1 < slices) put(smem + ((s + 1) & 1) * L::kBuffer);
    __syncthreads();
  }
}

}  // namespace fma_tile
