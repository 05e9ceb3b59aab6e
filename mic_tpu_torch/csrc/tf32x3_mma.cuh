// The 3xTF32 mma.sync tile shared by the float32 kernels whose W operand is
// read as stored, (K, N) row-major: row 15 f32 (csrc/ln_gemm_f32.cu), row 16
// f32 (csrc/fused_mlp_f32.cu) and the float32 flash-CE contractions of rows
// 9 and 10 (csrc/flash_ce_bwd_f32.cu).
//
// Float32-accurate products on the tensor cores, three TF32 products a term
// (each operand split into a TF32 hi and the f32 rest lo; a_lo b_hi + a_hi
// b_lo + a_hi b_hi, as csrc/tf32x3_wgmma.cuh), on mma.sync.m16n8k8, whose
// fragments come from shared memory in any layout: TF32 wgmma reads both
// operands K-major only.  A block of eight warps owns a 128 x 96 output
// tile, each warp 64 rows x 24 columns (four 16-row by three 8-column mma
// tiles), over 16-deep slices double-buffered in shared memory (`walk`:
// each kernel gives only how it loads and stages its A operand).  Each
// slice's products go into zeroed sums that FADDs add to the running ones:
// the tensor core truncates what it accumulates.  Where a product's tiles
// leave SMs idle its depth is cut into splits of whole slices
// (`split_range`), whose f32 partials `split_sum_kernel` adds in split
// order before the kernel's own epilogue.  An FFMA tile (8 x 8 sums a thread) took 0.2304 ms for row
// 15 f32 at the flagship step, slower than its plain version (PERF.md §6).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3_mma {

constexpr int kRows = 128;                  // output rows of a block
constexpr int kCols = 96;                   // output columns of a block
constexpr int kDepth = 16;                  // the depth of a slice
constexpr int kThreads = 256;
constexpr int kMTiles = 4;                  // 16-row tiles of a warp's 64 rows
constexpr int kNTiles = kCols / 4 / 8;      // 8-column tiles of a warp's 24 columns
constexpr int kAPitch = kDepth + 4;         // f32 of a staged K-major A row: fragment reads spread
constexpr int kBPitch = kCols + 8;          // f32 of a staged B row: fragment reads spread
constexpr int kBVecs = kDepth * kCols / 4;  // float4 of B a slice

using Acc = float[kMTiles][kNTiles][4];

// x = hi + lo: hi truncated to TF32 (10 mantissa bits), lo = x - hi as f32
// bits (the tensor core reads its top 10 mantissa bits).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d (16 x 8, f32) += a (16 x 8, tf32) . b (8 x 8, tf32): thread (g = lane
// / 4, t = lane % 4) holds a rows g (a[0], a[2]) and g + 8 (a[1], a[3]) at
// k t (a[0], a[1]) and t + 4 (a[2], a[3]); b at k t (b[0]) and t + 4
// (b[1]), column g; d rows g (d[0], d[1]) and g + 8 (d[2], d[3]), columns
// 2 t and 2 t + 1.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// This thread's two float4 of a slice's B: rows k + f / 24 (below `depth`)
// of columns c0 + 4 (f % 24) (below `cols`) of the row-major (depth, cols)
// w, for f = tid and tid + 256 of the slice's 16 x 96; zeros elsewhere.
__device__ __forceinline__ void load_b(const float* w, int k, int depth, int c0, int cols,
                                       int tid, float4 (&bv)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = tid + h * kThreads;
    const int row = k + f / (kCols / 4);
    const int col = c0 + 4 * (f % (kCols / 4));
    bv[h] = f < kBVecs && row < depth && col < cols
                ? *reinterpret_cast<const float4*>(w + static_cast<size_t>(row) * cols + col)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ void store_b(float (*bs)[kBPitch], const float4 (&bv)[2], int tid) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = tid + h * kThreads;
    if (f < kBVecs) *reinterpret_cast<float4*>(&bs[f / (kCols / 4)][4 * (f % (kCols / 4))]) = bv[h];
  }
}

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int i = 0; i < kMTiles; ++i)
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// The staged slice's products into warp (wm, wn)'s running sums acc (rows
// 64 wm.., columns 24 wn..): a_at(m, k) reads A's row m at depth k from
// shared memory, bs is B's slice.  Each of the three products runs over the
// twelve tiles before the next, so that no mma waits on the one before it.
template <class AAt>
__device__ __forceinline__ void slice_products(Acc& acc, AAt a_at, const float (*bs)[kBPitch],
                                               int wm, int wn, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
  Acc part;
  zero(part);
#pragma unroll
  for (int k0 = 0; k0 < kDepth; k0 += 8) {
    uint32_t bh[kNTiles][2], bl[kNTiles][2];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      const int col = 24 * wn + 8 * j + g;
      split(bs[k0 + t][col], bh[j][0], bl[j][0]);
      split(bs[k0 + t + 4][col], bh[j][1], bl[j][1]);
    }
    uint32_t ah[kMTiles][4], al[kMTiles][4];
#pragma unroll
    for (int i = 0; i < kMTiles; ++i) {
      const int row = 64 * wm + 16 * i + g;
      split(a_at(row, k0 + t), ah[i][0], al[i][0]);
      split(a_at(row + 8, k0 + t), ah[i][1], al[i][1]);
      split(a_at(row, k0 + t + 4), ah[i][2], al[i][2]);
      split(a_at(row + 8, k0 + t + 4), ah[i][3], al[i][3]);
    }
#pragma unroll
    for (int i = 0; i < kMTiles; ++i)
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) mma_tf32(part[i][j], al[i], bh[j][0], bh[j][1]);
#pragma unroll
    for (int i = 0; i < kMTiles; ++i)
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) mma_tf32(part[i][j], ah[i], bl[j][0], bl[j][1]);
#pragma unroll
    for (int i = 0; i < kMTiles; ++i)
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) mma_tf32(part[i][j], ah[i], bh[j][0], bh[j][1]);
  }
#pragma unroll
  for (int i = 0; i < kMTiles; ++i)
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
}

// store(row, col, float2) for each pair of warp (wm, wn)'s sums inside the
// output: block rows m0.. below m_end, columns c0.. below cols.
template <class Store>
__device__ __forceinline__ void for_each_pair(const Acc& acc, int m0, int c0, int m_end, int cols,
                                              int wm, int wn, int lane, Store store) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = m0 + 64 * wm + 16 * i + g + 8 * hf;
      if (row >= m_end) continue;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        const int col = c0 + 24 * wn + 8 * j + 2 * t;
        if (col >= cols) continue;
        store(row, col, make_float2(acc[i][j][2 * hf], acc[i][j][2 * hf + 1]));
      }
    }
  }
}

// Slices [s0, s1) of `slices`: split blockIdx.z of gridDim.z.
__device__ __forceinline__ void split_range(int slices, int& s0, int& s1) {
  s0 = static_cast<int>(static_cast<int64_t>(blockIdx.z) * slices / gridDim.z);
  s1 = static_cast<int>(static_cast<int64_t>(blockIdx.z + 1) * slices / gridDim.z);
}

// Slices [s0, s1) of a block's depth into acc, double-buffered: the next
// slice's A and B are read into registers while the staged one's products
// run.  load_a(s, regs) reads slice s's A into this thread's ARegs,
// store_a(buf, regs) stages them as A buffer buf, a_at(buf, m, k) reads the
// staged A's row m at depth k; B is the row-major (depth, cols) w from
// column c0, staged in bs.  Warp (warp % 2, warp / 2) sums rows 64 (warp %
// 2).., columns 24 (warp / 2)..
template <class ARegs, class LoadA, class StoreA, class AAt>
__device__ __forceinline__ void walk(Acc& acc, const float* w, int depth, int c0, int cols,
                                     float (*bs)[kDepth][kBPitch], int s0, int s1, LoadA load_a,
                                     StoreA store_a, AAt a_at) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  ARegs av;
  float4 bv[2];
  if (s0 < s1) {
    load_a(s0, av);
    load_b(w, s0 * kDepth, depth, c0, cols, tid, bv);
    store_a(0, av);
    store_b(bs[0], bv, tid);
  }
  __syncthreads();
  for (int s = s0; s < s1; ++s) {
    const int buf = (s - s0) & 1;
    if (s + 1 < s1) {
      load_a(s + 1, av);
      load_b(w, (s + 1) * kDepth, depth, c0, cols, tid, bv);
    }
    slice_products(acc, [&](int m, int k) { return a_at(buf, m, k); }, bs[buf], warp & 1,
                   warp >> 1, lane);
    if (s + 1 < s1) {
      store_a(buf ^ 1, av);
      store_b(bs[buf ^ 1], bv, tid);
    }
    __syncthreads();
  }
}

// f(x) = x: a dense with no activation.
struct Identity {
  __device__ __forceinline__ float operator()(float x) const { return x; }
};

// The split sum's epilogue of a dense: out = act(sum + bias), the bias of
// (cols,) broadcast over rows.
template <class Act = Identity>
struct BiasEpilogue {
  const float* bias;
  float* out;
  int cols;
  __device__ __forceinline__ void operator()(size_t run, float4 v) const {
    const float4 b = reinterpret_cast<const float4*>(bias)[(4 * run % cols) / 4];
    const Act act{};
    v.x = act(v.x + b.x);
    v.y = act(v.y + b.y);
    v.z = act(v.z + b.z);
    v.w = act(v.w + b.w);
    reinterpret_cast<float4*>(out)[run] = v;
  }
};

// epilogue(run, v) for each four values `run` of a plane of `plane` f32,
// v the splits' partial sums (part, (splits, plane)) added in split order;
// four values a thread.
template <class Epilogue>
__global__ void __launch_bounds__(kThreads) split_sum_kernel(const float* __restrict__ part,
                                                             int splits, size_t plane,
                                                             Epilogue epilogue) {
  for (size_t run = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; run < plane / 4;
       run += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float4 v = reinterpret_cast<const float4*>(part)[run];
    for (int z = 1; z < splits; ++z) {
      const float4 p = reinterpret_cast<const float4*>(part + z * plane)[run];
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    epilogue(run, v);
  }
}

template <class Epilogue>
cudaError_t split_sum(const float* part, int splits, size_t plane, Epilogue epilogue,
                      cudaStream_t s) {
  const size_t runs = plane / 4;
  const int blocks = static_cast<int>(runs < 1024 * 256 ? (runs + 255) / 256 : 1024);
  split_sum_kernel<<<blocks, kThreads, 0, s>>>(part, splits, plane, epilogue);
  return cudaGetLastError();
}

}  // namespace tf32x3_mma
