// Fused tied LM head: logits s = hidden @ weight^T + bias over the
// 250054-token vocab, never stored, reduced to candidates and the row lse.
//
// Kernels (ops/fused_head.py launches them):
//   - the bucket accumulator pass (fused_head_topk and fused_head_topk_q8,
//     select="bucket"), replacing mic_tpu/ops/fused_head.py's
//     _kernel_bucket_acc (bf16) and _kernel_q8_bucket(_acc) (int8 weight);
//   - the exact/window candidate select, replacing its _kernel (bf16) and
//     _kernel_q8 (int8 x int8);
//   - the merges of their split runs.
// The weight is the tied embedding as stored, (V, D), each vocab row
// contiguous; the int8 form has one f32 scale per vocab row.
//
// Bucket select.  The vocab is cut into chunks of `buckets` columns (the
// TPU's bv, on which the candidate ids depend: 512, or
// MIC_TPU_EXPERIMENTAL=bucket_bv; any multiple of 64); bucket column j of a
// row keeps, over the chunks in order,
//
//   l[j]    += exp(min(s, 60))                    (fixed-offset sum of exps)
//   rmax[j], rid[j] <- s, id   where s > rmax[j]  (strict: earliest chunk wins)
//
// with columns >= V masked to -1e30.  The three (N, buckets) planes go back
// to the caller, which finishes lse and the top-k of the bucket winners as
// the TPU's _bucket_finish_host does in XLA.  A block owns 64 hidden rows x
// 64 bucket columns and walks a run of consecutive chunks, so each thread
// keeps its cells' (l, rmax, rid) in registers.  When the row tiles x
// column groups (8 at 512) leave most SMs idle (small N), the caller splits
// the chunk walk into `splits` consecutive runs (grid z); each run writes
// its own planes and a merge kernel folds them in chunk order -- sums
// added, the strict > so that the earliest chunk still wins ties.
//
// Bound at the flagship decode shape (N = 1024 rows, D = 1024, V = 250054):
// the product, 0.52 TFLOP, at the tensor-core rate (0.53 ms in bf16, 0.265
// ms for the int8 x int8 select); at a few rows (N = 4, one image of beam
// 4) the stream of the weight (512 MB bf16, 256 MB int8: 0.077 ms).
//
// The int8 head (row 6 of PERF.md's table) runs on Hopper's wgmma fed by TMA
// through an mbarrier ring (q8::bucket_kernel, q8::select_kernel below,
// built on csrc/head_wgmma.cuh), so the tensor cores see a product in
// flight while the producer warp keeps the next slices coming and no block
// barrier falls inside the walk; see the note above namespace q8.  The
// bf16 instances (rows 4 and 5) are still the first port's design: four
// (bucket) or eight (select) warps of 16 x 16 WMMA (mma.sync) tiles on a
// resident hidden tile, a three-stage cp.async ring of weight slices and a
// block barrier a slice, the scores staged through a shared f32 tile; they
// reach 8-9% of their bound and are to move onto the wgmma mainloop
// (ROADMAP B27, B29).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

#include "head_wgmma.cuh"

namespace {

using nvcuda::wmma::accumulator;
using nvcuda::wmma::col_major;
using nvcuda::wmma::fragment;
using nvcuda::wmma::matrix_a;
using nvcuda::wmma::matrix_b;
using nvcuda::wmma::mem_row_major;
using nvcuda::wmma::row_major;

constexpr int kBM = 64;        // hidden rows per block
constexpr int kBC = 64;        // bucket columns per block
constexpr int kBK = 64;        // depth of one weight slice
constexpr int kStages = 3;
constexpr int kThreads = 128;  // 4 warps, each a 32 x 32 quarter of the tile
constexpr int kPerThread = kBM * kBC / kThreads;
constexpr int kPad = 8;        // bf16 row padding against bank conflicts
constexpr int kPadS = 4;       // f32 row padding of the score tile
constexpr float kNegInf = -1e30f;   // NEG_INF of mic_tpu/ops/topk_lse.py
constexpr float kExpClamp = 60.f;   // _EXP_CLAMP of mic_tpu/ops/fused_head.py

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

// resident hidden tile, a bf16 slice ring, the score tile
size_t smem_bytes(int d) {
  return static_cast<size_t>(kBM) * (d + kPad) * 2 +
         static_cast<size_t>(kStages) * kBC * (kBK + kPad) * 2 +
         static_cast<size_t>(kBM) * (kBC + kPadS) * 4;
}

__global__ void __launch_bounds__(kThreads)
fused_head_bucket_kernel(const __nv_bfloat16* __restrict__ hidden,  // (N, D)
                         const __nv_bfloat16* __restrict__ weight,  // (V, D)
                         const float* __restrict__ bias,            // (V,)
                         float* __restrict__ l_out,                 // (splits, N, buckets)
                         float* __restrict__ rmax_out,              // (splits, N, buckets)
                         int32_t* __restrict__ rid_out,             // (splits, N, buckets)
                         int n, int d, int vocab, int buckets) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int lda = d + kPad;
  constexpr int ldb = kBK + kPad;
  constexpr int lds = kBC + kPadS;
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* bs = as + kBM * lda;
  float* ss = reinterpret_cast<float*>(bs + kStages * kBC * ldb);

  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBC;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;

  // resident hidden tile; rows past n are zero
  const int vec_per_row = d / 8;
  for (int i = tid; i < kBM * vec_per_row; i += kThreads) {
    const int r = i / vec_per_row;
    const int c = (i % vec_per_row) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) v = *reinterpret_cast<const uint4*>(hidden + static_cast<size_t>(row0 + r) * d + c);
    *reinterpret_cast<uint4*>(as + r * lda + c) = v;
  }

  // this block's run of chunks [c_begin, c_end), split z of gridDim.z
  const int nk = d / kBK;
  const int nchunks = (vocab + buckets - 1) / buckets;
  const int c_begin = static_cast<int>(static_cast<int64_t>(blockIdx.z) * nchunks / gridDim.z);
  const int c_end = static_cast<int>(static_cast<int64_t>(blockIdx.z + 1) * nchunks / gridDim.z);
  // the run streams as one sequence of slices: slice s is depth block
  // s % nk of vocab chunk c_begin + s / nk
  const int nslices = (c_end - c_begin) * nk;
  auto load_slice = [&](int s) {
    const int chunk = c_begin + s / nk;
    const int kk = (s % nk) * kBK;
    // 16-byte pieces of a weight row: 8 values
    for (int i = tid; i < kBC * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8);
      const int c = (i % (kBK / 8)) * 8;
      // the ragged last chunk re-reads row V-1; its scores are masked below
      const size_t src = static_cast<size_t>(min(chunk * buckets + col0 + r, vocab - 1)) * d + kk + c;
      cp_async16(bs + (s % kStages) * kBC * ldb + r * ldb + c, weight + src);
    }
  };

  float l_acc[kPerThread];
  float m_acc[kPerThread];
  int32_t id_acc[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    l_acc[i] = 0.f;
    m_acc[i] = kNegInf;
    id_acc[i] = 0;
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nslices) load_slice(s);
    cp_async_commit();
  }

  fragment<accumulator, 16, 16, 16, float> acc[2][2];
  for (int s = 0; s < nslices; ++s) {
    const int ks = s % nk;
    if (ks == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.f);
    }
    cp_async_wait_one();
    __syncthreads();
    // refill the stage every thread finished with in the previous iteration
    if (s + kStages - 1 < nslices) load_slice(s + kStages - 1);
    cp_async_commit();

    const __nv_bfloat16* b_tile = bs + (s % kStages) * kBC * ldb;
    const int kk = ks * kBK;
#pragma unroll
    for (int k16 = 0; k16 < kBK; k16 += 16) {
      fragment<matrix_a, 16, 16, 16, __nv_bfloat16, row_major> fa[2];
      fragment<matrix_b, 16, 16, 16, __nv_bfloat16, col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        nvcuda::wmma::load_matrix_sync(fa[i], as + (wm + 16 * i) * lda + kk + k16, lda);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        nvcuda::wmma::load_matrix_sync(fb[j], b_tile + (wn + 16 * j) * ldb + k16, ldb);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) nvcuda::wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }

    if (ks == nk - 1) {
      // chunk complete: scores through shared memory into the bucket update.
      // The score tile is next written after at least one more barrier.
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          nvcuda::wmma::store_matrix_sync(ss + (wm + 16 * i) * lds + wn + 16 * j, acc[i][j], lds,
                                          mem_row_major);
      __syncthreads();
      const int base = (c_begin + s / nk) * buckets + col0;
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const int e = tid + i * kThreads;
        const int r = e / kBC;
        const int c = e % kBC;
        const int v = base + c;
        float sc = kNegInf;
        if (v < vocab) sc = ss[r * lds + c] + bias[v];
        l_acc[i] += expf(fminf(sc, kExpClamp));
        if (sc > m_acc[i]) {
          m_acc[i] = sc;
          id_acc[i] = v;
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);

#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int e = tid + i * kThreads;
    const int r = row0 + e / kBC;
    if (r < n) {
      const size_t o = (static_cast<size_t>(blockIdx.z) * n + r) * buckets + col0 + e % kBC;
      l_out[o] = l_acc[i];
      rmax_out[o] = m_acc[i];
      rid_out[o] = id_acc[i];
    }
  }
}

// Folds the per-split planes (splits, N*buckets) into (N*buckets) in split order,
// which is chunk order: sums added, strict > so the earliest split's winner
// stands on ties.
__global__ void fused_head_bucket_merge_kernel(const float* __restrict__ l_part,
                                               const float* __restrict__ rmax_part,
                                               const int32_t* __restrict__ rid_part,
                                               float* __restrict__ l_out,
                                               float* __restrict__ rmax_out,
                                               int32_t* __restrict__ rid_out, int total,
                                               int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float l = l_part[i];
  float m = rmax_part[i];
  int32_t id = rid_part[i];
  for (int z = 1; z < splits; ++z) {
    const size_t o = static_cast<size_t>(z) * total + i;
    l += l_part[o];
    if (rmax_part[o] > m) {
      m = rmax_part[o];
      id = rid_part[o];
    }
  }
  l_out[i] = l;
  rmax_out[i] = m;
  rid_out[i] = id;
}

// With splits == 1 the walk writes the (N, buckets) outputs directly and the
// *_part pointers are unused; with splits > 1 it writes (splits, N, buckets)
// partial planes there, which the merge kernel folds into the outputs.
bool bucket_args_ok(int n, int vocab, int buckets, int splits) {
  if (buckets < kBC || buckets % kBC != 0 || n < 1 || vocab < 1) return false;
  return splits >= 1 && splits <= (vocab + buckets - 1) / buckets;
}

// After the walk's launch: the merge of the split planes, if any.
int bucket_merge(void* l_out, void* rmax_out, void* rid_out, void* l_part, void* rmax_part,
                 void* rid_part, int n, int buckets, int splits, cudaStream_t s) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int total = n * buckets;
  fused_head_bucket_merge_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(l_part), static_cast<const float*>(rmax_part),
      static_cast<const int32_t*>(rid_part), static_cast<float*>(l_out),
      static_cast<float*>(rmax_out), static_cast<int32_t*>(rid_out), total, splits);
  return static_cast<int>(cudaGetLastError());
}

int launch_bucket(void* hidden, void* weight, void* bias, void* l_out, void* rmax_out,
                  void* rid_out, void* l_part, void* rmax_part, void* rid_part, int n, int d,
                  int vocab, int buckets, int splits, void* stream) {
  const size_t smem = smem_bytes(d);
  if (!bucket_args_ok(n, vocab, buckets, splits) || d % kBK != 0 || smem > 232448) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      fused_head_bucket_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool split = splits > 1;
  const dim3 grid((n + kBM - 1) / kBM, buckets / kBC, splits);
  fused_head_bucket_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(hidden), static_cast<const __nv_bfloat16*>(weight),
      static_cast<const float*>(bias), static_cast<float*>(split ? l_part : l_out),
      static_cast<float*>(split ? rmax_part : rmax_out),
      static_cast<int32_t*>(split ? rid_part : rid_out), n, d, vocab, buckets);
  return bucket_merge(l_out, rmax_out, rid_out, l_part, rmax_part, rid_part, n, buckets, splits,
                      s);
}

// ---------------------------------------------------------------------------
// Exact and window candidate select.
//
// Replaces fused_head_topk(select="exact"/"window") (the _kernel Pallas
// kernel of mic_tpu/ops/fused_head.py) and the exact/window path of
// fused_head_topk_q8 (_kernel_q8; its int8 kernel is q8::select_kernel
// below).  Per hidden row it computes the row's
// online (max, sum of exps) of the logits and its candidates: the exact
// top-k (on equal values the lowest id first, the leftmost max of
// _select_topk), or the top-k over the 128-wide windows' top-1s (inside a
// window the highest lane wins a tie, between windows the lowest window).
// bf16 operands multiply on bf16 tensor cores into f32 and s = acc + b.
//
// The TPU walks the vocab in order with its running state in scratch; here
// blocks run in no order.  A block owns 64 rows and a run of consecutive
// 128-wide vocab tiles and keeps, four threads a row, its run's online
// (max, sum) and candidates (for exact, each thread a running top-16 over
// every fourth column of the tiles; for window, one list a row).  A second
// kernel merges the runs per row, with no atomics: the order of candidates
// is total (value, then id), so the merge does not depend on which run
// finishes first.
//
// Bound: as the bucket kernel's -- a stream of the weight at a few rows, the
// GEMM at N = 1024 rows -- with one block an SM (the resident 64-row tile is
// 128 KB at D = 1024).  The caller makes the runs as many as fill the SMs;
// the blocks of one run start together and mostly meet in L2.  Operands are
// kept in shared memory in 16-wide k slabs, so every tensor-core fragment
// starts 32-byte aligned.

constexpr int kSN = 128;       // vocab columns per tile (= the 128-wide window)
constexpr int kSK = 32;        // depth of one weight slice
constexpr int kSThreads = 256; // 8 warps: 2 x 4, each 32 rows x 32 columns
constexpr int kSLds = kSN + 4; // row pitch of the score tile
constexpr int kTopK = 16;      // the largest k served

size_t select_smem_bytes(int d) {
  return static_cast<size_t>(kBM) * d * 2 + static_cast<size_t>(kStages) * kSN * kSK * 2 +
         static_cast<size_t>(kBM) * kSLds * 4;
}

// (v, id) ranks before (tv, ti): higher value, or the same value and lower id
__device__ __forceinline__ bool ranks_before(float v, int id, float tv, int ti) {
  return v > tv || (v == tv && id < ti);
}

// Insert (v, id) into a list kept in rank order; the last entry drops out.
__device__ __forceinline__ void topk_insert(float (&tv)[kTopK], int (&ti)[kTopK], float v,
                                            int id) {
  if (!ranks_before(v, id, tv[kTopK - 1], ti[kTopK - 1])) return;
  bool placed = false;
#pragma unroll
  for (int i = kTopK - 1; i >= 0; --i) {
    if (!placed) {
      if (i > 0 && ranks_before(v, id, tv[i - 1], ti[i - 1])) {
        tv[i] = tv[i - 1];
        ti[i] = ti[i - 1];
      } else {
        tv[i] = v;
        ti[i] = id;
        placed = true;
      }
    }
  }
}

template <bool kWindow>
__global__ void __launch_bounds__(kSThreads)
fused_head_select_kernel(const __nv_bfloat16* __restrict__ x,       // (N, D) hidden
                         const __nv_bfloat16* __restrict__ weight,  // (V, D)
                         const float* __restrict__ bias,            // (V,)
                         float* __restrict__ part_m,        // (runs, N)
                         float* __restrict__ part_l,        // (runs, N)
                         float* __restrict__ part_v,        // (runs, N, k)
                         int32_t* __restrict__ part_i,      // (runs, N, k)
                         int n, int d, int vocab, int k) {
  using T = __nv_bfloat16;
  constexpr int kPer = 8;  // values in a 16-byte piece
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* as = reinterpret_cast<T*>(smem_raw);          // [D/16][64 rows][16]
  T* bs = as + kBM * d;                            // [stage][2][128 cols][16]
  float* ss = reinterpret_cast<float*>(bs + kStages * kSN * kSK);

  const int row0 = blockIdx.x * kBM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = (warp >> 2) * 32;
  const int wn = (warp & 3) * 32;

  for (int i = tid; i < kBM * (d / kPer); i += kSThreads) {
    const int r = i / (d / kPer);
    const int c = (i % (d / kPer)) * kPer;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) v = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(row0 + r) * d + c);
    *reinterpret_cast<uint4*>(as + (c / 16) * (kBM * 16) + r * 16 + c % 16) = v;
  }

  const int nk = d / kSK;
  const int ntiles = (vocab + kSN - 1) / kSN;
  const int t_begin = static_cast<int>(static_cast<int64_t>(blockIdx.y) * ntiles / gridDim.y);
  const int t_end = static_cast<int>(static_cast<int64_t>(blockIdx.y + 1) * ntiles / gridDim.y);
  const int nslices = (t_end - t_begin) * nk;
  auto load_slice = [&](int s) {
    const int tile = t_begin + s / nk;
    const int kk = (s % nk) * kSK;
    T* dst = bs + (s % kStages) * kSN * kSK;
    for (int i = tid; i < kSN * (kSK / kPer); i += kSThreads) {
      const int r = i / (kSK / kPer);
      const int c = (i % (kSK / kPer)) * kPer;
      // the ragged last tile re-reads row V-1; its columns are skipped below
      const int v = min(tile * kSN + r, vocab - 1);
      cp_async16(dst + (c / 16) * (kSN * 16) + r * 16 + c % 16,
                 weight + static_cast<size_t>(v) * d + kk + c);
    }
  };

  // this thread's row of the tile and its quarter of the columns
  const int er = tid >> 2;
  const int eq = tid & 3;
  float m_run = -INFINITY;
  float l_run = 0.f;
  float tv[kTopK];
  int ti[kTopK];
#pragma unroll
  for (int i = 0; i < kTopK; ++i) {
    tv[i] = -INFINITY;
    ti[i] = INT32_MAX;
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nslices) load_slice(s);
    cp_async_commit();
  }

  fragment<accumulator, 16, 16, 16, float> acc[2][2];
  for (int s = 0; s < nslices; ++s) {
    const int ks = s % nk;
    if (ks == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.f);
    }
    cp_async_wait_one();
    __syncthreads();
    if (s + kStages - 1 < nslices) load_slice(s + kStages - 1);
    cp_async_commit();

    const T* b_tile = bs + (s % kStages) * kSN * kSK;
#pragma unroll
    for (int j16 = 0; j16 < kSK / 16; ++j16) {
      const int slab = ks * (kSK / 16) + j16;
      fragment<matrix_a, 16, 16, 16, T, row_major> fa[2];
      fragment<matrix_b, 16, 16, 16, T, col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        nvcuda::wmma::load_matrix_sync(
            fa[i], as + slab * (kBM * 16) + (wm + 16 * i) * 16, 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        nvcuda::wmma::load_matrix_sync(
            fb[j], b_tile + j16 * (kSN * 16) + (wn + 16 * j) * 16, 16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) nvcuda::wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }

    if (ks == nk - 1) {
      // tile complete: products through shared memory into the row state;
      // the score tile is next written after at least one more barrier
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          nvcuda::wmma::store_matrix_sync(ss + (wm + 16 * i) * kSLds + wn + 16 * j, acc[i][j],
                                          kSLds, mem_row_major);
      __syncthreads();
      const int base = (t_begin + s / nk) * kSN;
      float sv[kSN / 4];
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kSN / 4; ++j) {
        const int col = base + eq + 4 * j;
        float sc = -INFINITY;
        if (col < vocab) sc = ss[er * kSLds + eq + 4 * j] + bias[col];
        sv[j] = sc;
        cmax = fmaxf(cmax, sc);
      }
      // online sum of exps over this thread's columns
      if (cmax > -INFINITY) {
        const float m_new = fmaxf(m_run, cmax);
        float l = l_run * expf(m_run - m_new);
#pragma unroll
        for (int j = 0; j < kSN / 4; ++j) l += expf(sv[j] - m_new);
        m_run = m_new;
        l_run = l;
      }
      if constexpr (kWindow) {
        // the tile is one window: its top-1, the highest column on ties
        float wv = -INFINITY;
        int wi = -1;
#pragma unroll
        for (int j = 0; j < kSN / 4; ++j) {
          if (base + eq + 4 * j < vocab && sv[j] >= wv) {
            wv = sv[j];
            wi = base + eq + 4 * j;
          }
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, wv, o);
          const int oi = __shfl_xor_sync(0xffffffffu, wi, o);
          if (ov > wv || (ov == wv && oi > wi)) {
            wv = ov;
            wi = oi;
          }
        }
        if (eq == 0) topk_insert(tv, ti, wv, wi);
      } else {
#pragma unroll
        for (int j = 0; j < kSN / 4; ++j) {
          if (base + eq + 4 * j < vocab) topk_insert(tv, ti, sv[j], base + eq + 4 * j);
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);

  // the row's (max, sum) over its four threads
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m_run, o);
    const float ol = __shfl_xor_sync(0xffffffffu, l_run, o);
    const float mm = fmaxf(m_run, om);
    float l = 0.f;
    if (m_run > -INFINITY) l += l_run * expf(m_run - mm);
    if (om > -INFINITY) l += ol * expf(om - mm);
    m_run = mm;
    l_run = l;
  }
  if constexpr (!kWindow) {
    // the row's four lists through shared memory into thread 0's
    __syncthreads();
    float* lv = reinterpret_cast<float*>(ss);
    int* li = reinterpret_cast<int*>(lv + kBM * 4 * kTopK);
#pragma unroll
    for (int i = 0; i < kTopK; ++i) {
      lv[(er * 4 + eq) * kTopK + i] = tv[i];
      li[(er * 4 + eq) * kTopK + i] = ti[i];
    }
    __syncthreads();
    if (eq == 0) {
      for (int other = 1; other < 4; ++other)
#pragma unroll
        for (int i = 0; i < kTopK; ++i)
          topk_insert(tv, ti, lv[(er * 4 + other) * kTopK + i], li[(er * 4 + other) * kTopK + i]);
    }
  }
  const int grow = row0 + er;
  if (eq == 0 && grow < n) {
    const size_t o = static_cast<size_t>(blockIdx.y) * n + grow;
    part_m[o] = m_run;
    part_l[o] = l_run;
#pragma unroll
    for (int i = 0; i < kTopK; ++i) {
      if (i < k) {
        part_v[o * k + i] = tv[i];
        part_i[o * k + i] = ti[i];
      }
    }
  }
}

// One thread a row: folds the runs' (max, sum) into lse = log(sum) + max and
// their candidate lists into the row's top-k; lp = value - lse.
__global__ void fused_head_select_merge_kernel(const float* __restrict__ part_m,
                                               const float* __restrict__ part_l,
                                               const float* __restrict__ part_v,
                                               const int32_t* __restrict__ part_i,
                                               float* __restrict__ lp, int32_t* __restrict__ ids,
                                               float* __restrict__ lse, int n, int k, int runs) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float m = -INFINITY;
  for (int z = 0; z < runs; ++z) m = fmaxf(m, part_m[static_cast<size_t>(z) * n + row]);
  float l = 0.f;
  for (int z = 0; z < runs; ++z) {
    const float mz = part_m[static_cast<size_t>(z) * n + row];
    if (mz > -INFINITY) l += part_l[static_cast<size_t>(z) * n + row] * expf(mz - m);
  }
  const float lse_r = logf(l) + m;
  float tv[kTopK];
  int ti[kTopK];
#pragma unroll
  for (int i = 0; i < kTopK; ++i) {
    tv[i] = -INFINITY;
    ti[i] = INT32_MAX;
  }
  for (int z = 0; z < runs; ++z) {
    const size_t o = (static_cast<size_t>(z) * n + row) * k;
    for (int i = 0; i < k; ++i) topk_insert(tv, ti, part_v[o + i], part_i[o + i]);
  }
#pragma unroll
  for (int i = 0; i < kTopK; ++i) {
    if (i < k) {
      lp[static_cast<size_t>(row) * k + i] = tv[i] - lse_r;
      ids[static_cast<size_t>(row) * k + i] = ti[i];
    }
  }
  lse[row] = lse_r;
}

// After the select walk's launch: the merge of its runs into lp, ids, lse.
int select_merge(void* part_m, void* part_l, void* part_v, void* part_i, void* lp, void* ids,
                 void* lse, int n, int k, int runs, cudaStream_t s) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_head_select_merge_kernel<<<(n + 127) / 128, 128, 0, s>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_v), static_cast<const int32_t*>(part_i),
      static_cast<float*>(lp), static_cast<int32_t*>(ids), static_cast<float*>(lse), n, k, runs);
  return static_cast<int>(cudaGetLastError());
}

template <bool kWindow>
int launch_select(const void* x, const void* weight, const void* bias, void* part_m,
                  void* part_l, void* part_v, void* part_i, void* lp, void* ids, void* lse, int n,
                  int d, int vocab, int k, int runs, void* stream) {
  const size_t smem = select_smem_bytes(d);
  const int ntiles = (vocab + kSN - 1) / kSN;
  if (n < 1 || vocab < 1 || d % kSK != 0 || smem > 232448 || k < 1 || k > kTopK || runs < 1 ||
      runs > ntiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaFuncSetAttribute(fused_head_select_kernel<kWindow>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // row tiles vary fastest, so the blocks of one run are scheduled together
  const dim3 grid((n + kBM - 1) / kBM, runs);
  fused_head_select_kernel<kWindow><<<grid, kSThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(weight),
      static_cast<const float*>(bias), static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<float*>(part_v), static_cast<int32_t*>(part_i), n, d, vocab, k);
  return select_merge(part_m, part_l, part_v, part_i, lp, ids, lse, n, k, runs, s);
}

// ---------------------------------------------------------------------------
// The int8 head on wgmma fed by TMA (csrc/head_wgmma.cuh).
//
// Replaces fused_head_topk_q8's kernels (mic_tpu/ops/fused_head.py:
// _kernel_q8_bucket, _kernel_q8_bucket_acc and _kernel_q8).  Both kernels
// below are one producer warp (in a warpgroup of its own that hands its
// registers to the consumers by setmaxnreg), which keeps TMA loads of int8
// weight slices in flight through a ring of mbarrier-guarded slots, and two
// consumer warpgroups, which issue wgmma on the slots and release them; no
// __syncthreads falls inside the walk.  The weight is read as it is stored,
// (V, D) with each vocab row contiguous: K-major, the only major order
// wgmma takes for 8-bit operands.  Vocab rows past V arrive as TMA's zero
// fill and are masked in the epilogues.
//
// Bucket (bf16 hidden x int8 weight, f32 sums).  wgmma has no bf16 x int8
// form, so the vocab is the M side: each consumer thread reads its rows of
// the int8 slice from shared memory into registers and converts them to bf16
// there (exact: every int8 value is a bf16), and the register A operand of
// m64n64k16 multiplies the block's 64 hidden rows, resident in shared memory
// for the whole walk as the B operand (128-byte swizzle).  The thread's 16
// bytes of a row hold, by a fixed permutation of k inside each 64-deep
// block, exactly the 16 values its A fragments need for the slice's four k16
// steps; the hidden tile is stored with the same permutation, so the sums
// are unchanged and each slice costs two 16-byte shared loads a thread.  A
// block owns 64 bucket columns: warpgroup w walks chunks c_begin + w,
// c_begin + w + 2, ... of its run, each stage holding one 64 x 64 slice for
// each warpgroup.  The epilogue is the bucket update on the accumulator
// registers -- each thread always owns the same (bucket column, hidden row)
// cells -- with s = acc * ws + b unfused (__fmul_rn, __fadd_rn); at the end
// the two warpgroups' planes merge through shared memory, sums added, the
// higher value or on a tie the lower id (the earlier chunk) kept.
//
// Exact and window (int8 x int8 into exact int32).  m64n128k32 with both
// operands in shared memory: the block's 128 quantized hidden rows (64 a
// warpgroup) resident as A, each 128-wide vocab tile (one window) as B.  The
// epilogue works on the accumulator registers: s = acc * xs[row] * ws[col] +
// b[col] in f32 in the plain version's order (bit-equal logits; the tile's
// ws and b arrive by TMA beside its last slice), the online (max, sum of
// exps) per row, then the window's top-1 by quad shuffles, or for exact
// every column that ranks before the row's current k-th candidate and
// reaches the row's floor, appended to the row's list in shared memory; a
// list that fills is cut back to its top k by rank (the order is total:
// value, then lower id), which raises the row's threshold, and publishes
// that k-th value as the row's floor for the other runs (atomicMax in
// global memory: k columns reach it, so nothing below it is in the top k).
//
// Bound at N = 1024, D = 1024, V = 250054: the bucket product, 0.52 TFLOP
// at the bf16 rate (0.53 ms); the exact/window product at the int8 rate
// (0.265 ms).  At a few rows both stream the 256 MB int8 weight (0.077 ms).
// A block reads the weight slices of its run once for its 64 (bucket) or
// 128 (exact/window) hidden rows; blocks of one run start together and
// mostly meet in L2.

namespace q8 {

using namespace head_wgmma;

constexpr int kConsumerWarps = 8;                      // two warpgroups
constexpr int kThreads = (kConsumerWarps + 4) * 32;    // and the producer's warpgroup
constexpr int kConsumerThreads = kConsumerWarps * 32;
constexpr int kProducerRegs = 40;                      // registers a thread after setmaxnreg
constexpr int kConsumerRegs = 232;
constexpr int kMaxSmem = 232448;

// bucket: 64 hidden rows x 64 bucket columns a block, 64-deep int8 slices
constexpr int kBRows = 64;
constexpr int kBCols = 64;
constexpr int kBDepth = 64;
constexpr int kBStages = 8;
constexpr int kBSlice = kBCols * kBDepth;  // one warpgroup's slice: 4096 bytes

size_t bucket_smem_bytes(int d) {
  return 1024 + static_cast<size_t>(kBRows) * d * 2 + kBStages * 2 * kBSlice +
         2 * kBStages * sizeof(uint64_t);
}

// exact/window: 128 hidden rows a block, 128-column tiles, 128-deep slices
constexpr int kSRows = 128;
constexpr int kSCols = 128;
constexpr int kSDepth = 128;
constexpr int kSStages = 4;
constexpr int kSSlice = kSCols * kSDepth;  // 16384 bytes
constexpr int kSSide = kSCols * 8;         // a tile's ws and bias beside its last slice
constexpr int kCap = 24;                   // candidate entries a row

size_t select_smem_bytes(int d) {
  const int nkb = (d + kSDepth - 1) / kSDepth;
  return 1024 + static_cast<size_t>(nkb) * kSRows * kSDepth + kSStages * (kSSlice + kSSide) +
         static_cast<size_t>(kSRows) * kCap * 8 + (2 * kSStages + 1) * sizeof(uint64_t);
}

// f32 values as ints in the same order (for atomicMax on a shared floor).
__device__ __forceinline__ int order_key(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7FFFFFFF;
}
__device__ __forceinline__ float key_value(int key) {
  return __int_as_float(key >= 0 ? key : key ^ 0x7FFFFFFF);
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__global__ void __launch_bounds__(kThreads, 1)
bucket_kernel(const __grid_constant__ CUtensorMap wmap,   // int8 (V, D), 64 x 64-byte boxes
              const __nv_bfloat16* __restrict__ hidden,   // (N, D)
              const float* __restrict__ wscale,           // (V,)
              const float* __restrict__ bias,             // (V,)
              float* __restrict__ l_out,                  // (splits, N, buckets)
              float* __restrict__ rmax_out,               // (splits, N, buckets)
              int32_t* __restrict__ rid_out,              // (splits, N, buckets)
              int n, int d, int vocab, int buckets) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* hs = align_1024(smem_raw);        // [D/64][64 rows][128 B], swizzled
  unsigned char* ring = hs + kBRows * d * 2;        // [stage][warpgroup][64 rows][64 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kBStages * 2 * kBSlice);
  uint64_t* empty = full + kBStages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * kBRows;
  const int col0 = blockIdx.y * kBCols;
  const int nk = d / kBDepth;
  // this block's run of chunks [c_begin, c_end), split z of gridDim.z,
  // walked as pairs: warpgroup w takes chunk c_begin + 2 p + w of pair p
  const int nchunks = (vocab + buckets - 1) / buckets;
  const int c_begin = static_cast<int>(static_cast<int64_t>(blockIdx.z) * nchunks / gridDim.z);
  const int c_end = static_cast<int>(static_cast<int64_t>(blockIdx.z + 1) * nchunks / gridDim.z);
  const int npairs = (c_end - c_begin + 1) / 2;
  const int nslices = npairs * nk;  // a warpgroup's slices, whether or not its chunk exists

  if (tid == 0) {
    for (int i = 0; i < kBStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // producer: stage s holds depth block s % nk of the pair's two chunks
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0) {
      for (int s = 0; s < nslices; ++s) {
        const int slot = s % kBStages;
        if (s >= kBStages) mbar_wait(&empty[slot], ((s / kBStages) - 1) & 1);
        const int chunk = c_begin + 2 * (s / nk);
        const int kk = (s % nk) * kBDepth;
        const bool second = chunk + 1 < c_end;
        unsigned char* dst = ring + slot * 2 * kBSlice;
        mbar_expect_tx(&full[slot], second ? 2 * kBSlice : kBSlice);
        tma_load_2d(dst, &wmap, &full[slot], kk, chunk * buckets + col0);
        if (second) tma_load_2d(dst + kBSlice, &wmap, &full[slot], kk, (chunk + 1) * buckets + col0);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2;
  const int w = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  // the resident hidden tile as wgmma's B: logical 16-byte chunk c of row r
  // in depth block kb holds the bf16 pairs 8 t' + c (t' = 0..3) of that
  // block, the permutation that matches the A registers below; rows past n
  // are zero
  for (int i = tid; i < kBRows * nk * 8; i += kConsumerThreads) {
    const int c = i & 7;
    const int kb = (i >> 3) % nk;
    const int r = (i >> 3) / nk;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (row0 + r < n) {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(
          hidden + static_cast<size_t>(row0 + r) * d + kb * kBDepth);
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = src[8 * q + c];
    }
    *reinterpret_cast<uint4*>(hs + kb * (kBRows * 128) + r * 128 + ((c ^ (r & 7)) << 4)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
  fence_proxy_async();
  consumer_sync(kConsumerThreads);

  float acc[32];
  float l_st[32], m_st[32];
  int id_st[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    acc[x] = 0.f;
    l_st[x] = 0.f;
    m_st[x] = kNegInf;
    id_st[x] = 0;
  }
  // bytes [16 t, 16 t + 16) of vocab rows 16 w + g and 16 w + g + 8 of the slice
  const int arow = (16 * w + g) * kBDepth + 16 * t;
  int s = 0;
  for (int p = 0; p < npairs; ++p) {
    const int chunk = c_begin + 2 * p + wg;
    const bool mine = chunk < c_end;  // warpgroup-uniform
    // vocab rows 16 w + g + 8 h of the chunk's column group
    const int vbase = chunk * buckets + col0 + 16 * w + g;
    // the chunk's scales and biases, loaded while its products run
    float wsv[2], bv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool valid = mine && vbase + 8 * h < vocab;
      wsv[h] = valid ? __ldg(wscale + vbase + 8 * h) : 0.f;
      bv[h] = valid ? __ldg(bias + vbase + 8 * h) : 0.f;
    }
    for (int kb = 0; kb < nk; ++kb, ++s) {
      const int slot = s % kBStages;
      mbar_wait(&full[slot], (s / kBStages) & 1);
      if (mine) {
        const unsigned char* src = ring + slot * 2 * kBSlice + wg * kBSlice + arow;
        const uint4 lo = *reinterpret_cast<const uint4*>(src);
        const uint4 hi = *reinterpret_cast<const uint4*>(src + 8 * kBDepth);
        // word j of a row's 16 bytes: k step j's (a0, a2) or (a1, a3)
        uint32_t a[4][4];
        int8x4_to_bf16x4(lo.x, a[0][0], a[0][2]);
        int8x4_to_bf16x4(hi.x, a[0][1], a[0][3]);
        int8x4_to_bf16x4(lo.y, a[1][0], a[1][2]);
        int8x4_to_bf16x4(hi.y, a[1][1], a[1][3]);
        int8x4_to_bf16x4(lo.z, a[2][0], a[2][2]);
        int8x4_to_bf16x4(hi.z, a[2][1], a[2][3]);
        int8x4_to_bf16x4(lo.w, a[3][0], a[3][2]);
        int8x4_to_bf16x4(hi.w, a[3][1], a[3][3]);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[slot]);
#pragma unroll
        for (int x = 0; x < 32; ++x) fence_operand(acc[x]);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wgmma_m64n64k16_bf16_rs(acc, a[j], desc_sw128(hs + kb * (kBRows * 128) + 32 * j),
                                  (kb | j) != 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int x = 0; x < 32; ++x) fence_operand(acc[x]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) fence_operand(a[j][q]);
      } else {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[slot]);
      }
    }
    if (mine) {
      // the bucket update: d[4 i + 2 h + e] is vocab row 16 w + g + 8 h of the
      // chunk's column group (bucket column col0 + 16 w + g + 8 h), hidden
      // row 8 i + 2 t + e
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v = vbase + 8 * h;
        const bool valid = v < vocab;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * i + 2 * h + e;
            const float sc = valid ? __fadd_rn(__fmul_rn(acc[x], wsv[h]), bv[h]) : kNegInf;
            l_st[x] += expf(fminf(sc, kExpClamp));
            if (sc > m_st[x]) {
              m_st[x] = sc;
              id_st[x] = v;
            }
          }
        }
      }
    }
  }

  // the two warpgroups' cells, through the ring (every slot has been read)
  consumer_sync(kConsumerThreads);
  float* xl = reinterpret_cast<float*>(ring);
  float* xm = xl + 32 * 128;
  int* xi = reinterpret_cast<int*>(xm + 32 * 128);
  const int me = tid & 127;
  if (wg == 1) {
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      xl[x * 128 + me] = l_st[x];
      xm[x * 128 + me] = m_st[x];
      xi[x * 128 + me] = id_st[x];
    }
  }
  consumer_sync(kConsumerThreads);
  if (wg == 0) {
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      l_st[x] += xl[x * 128 + me];
      const float om = xm[x * 128 + me];
      const int oi = xi[x * 128 + me];
      if (om > m_st[x] || (om == m_st[x] && oi < id_st[x])) {
        m_st[x] = om;
        id_st[x] = oi;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = row0 + 8 * i + 2 * t + e;
        if (r < n) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int x = 4 * i + 2 * h + e;
            const size_t o = (static_cast<size_t>(blockIdx.z) * n + r) * buckets + col0 +
                             16 * w + g + 8 * h;
            l_out[o] = l_st[x];
            rmax_out[o] = m_st[x];
            rid_out[o] = id_st[x];
          }
        }
      }
    }
  }
}

// Cut a row's candidate list (its quad's shared entries [0, cnt)) back to its
// top k, in rank order; the row's threshold becomes its k-th entry.  Every
// entry's rank is the number of entries that rank before it: distinct,
// since ids are.
__device__ __forceinline__ void compact_row(float* bv, int* bi, int& cnt, int k, float& tv,
                                            int& ti, int t, unsigned quad) {
  constexpr int kPer = kCap / 4;
  float ev[kPer];
  int ei[kPer];
  int rk[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int e = t + 4 * q;
    ev[q] = e < cnt ? bv[e] : -INFINITY;
    ei[q] = e < cnt ? bi[e] : INT32_MAX;
    rk[q] = 0;
  }
  for (int x = 0; x < cnt; ++x) {
    const float xv = bv[x];
    const int xid = bi[x];
#pragma unroll
    for (int q = 0; q < kPer; ++q) rk[q] += ranks_before(xv, xid, ev[q], ei[q]) ? 1 : 0;
  }
  __syncwarp(quad);
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    if (t + 4 * q < cnt && rk[q] < k) {
      bv[rk[q]] = ev[q];
      bi[rk[q]] = ei[q];
    }
  }
  __syncwarp(quad);
  cnt = min(cnt, k);
  if (cnt == k) {
    tv = bv[k - 1];
    ti = bi[k - 1];
  } else {
    tv = -INFINITY;
    ti = INT32_MAX;
  }
}

template <bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
select_kernel(const __grid_constant__ CUtensorMap xmap,   // xq (N, D), 128 x 128-byte boxes
              const __grid_constant__ CUtensorMap wmap,   // weight (V, D), the same boxes
              const __grid_constant__ CUtensorMap wsmap,  // wscale (V,) f32, 128-value boxes
              const __grid_constant__ CUtensorMap bmap,   // bias (V,) f32, 128-value boxes
              const float* __restrict__ xscale,           // (N,)
              int* __restrict__ row_floor,                // (N,), order_key, exact only
              float* __restrict__ part_m,                // (runs, N)
              float* __restrict__ part_l,                // (runs, N)
              float* __restrict__ part_v,                // (runs, N, k)
              int32_t* __restrict__ part_i,              // (runs, N, k)
              int n, int d, int vocab, int k) {
  extern __shared__ unsigned char smem_raw[];
  const int nkb = (d + kSDepth - 1) / kSDepth;
  unsigned char* xs = align_1024(smem_raw);                 // [nkb][128 rows][128 B], swizzled
  unsigned char* ring = xs + nkb * kSRows * kSDepth;        // [stage][128 cols][128 B], swizzled
  unsigned char* side = ring + kSStages * kSSlice;          // [stage][ws 128, bias 128] f32
  float* cand_v = reinterpret_cast<float*>(side + kSStages * kSSide);  // [128 rows][kCap]
  int* cand_i = reinterpret_cast<int*>(cand_v + kSRows * kCap);
  uint64_t* full = reinterpret_cast<uint64_t*>(cand_i + kSRows * kCap);
  uint64_t* empty = full + kSStages;
  uint64_t* xfull = empty + kSStages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * kSRows;
  const int ntiles = (vocab + kSCols - 1) / kSCols;
  const int t_begin = static_cast<int>(static_cast<int64_t>(blockIdx.y) * ntiles / gridDim.y);
  const int t_end = static_cast<int>(static_cast<int64_t>(blockIdx.y + 1) * ntiles / gridDim.y);
  const int nslices = (t_end - t_begin) * nkb;

  if (tid == 0) {
    for (int i = 0; i < kSStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    mbar_init(xfull, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // producer: the block's rows once, then depth block s % nk of tile
    // t_begin + s / nk into stage s, and with a tile's last depth block the
    // tile's ws and bias; depth past D and rows past N or V arrive as zeros
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0) {
      mbar_expect_tx(xfull, nkb * kSRows * kSDepth);
      for (int kb = 0; kb < nkb; ++kb) {
        tma_load_2d(xs + kb * kSRows * kSDepth, &xmap, xfull, kb * kSDepth, row0);
      }
      for (int s = 0; s < nslices; ++s) {
        const int slot = s % kSStages;
        if (s >= kSStages) mbar_wait(&empty[slot], ((s / kSStages) - 1) & 1);
        const int col0 = (t_begin + s / nkb) * kSCols;
        const bool last = s % nkb == nkb - 1;
        mbar_expect_tx(&full[slot], last ? kSSlice + kSSide : kSSlice);
        tma_load_2d(ring + slot * kSSlice, &wmap, &full[slot], (s % nkb) * kSDepth, col0);
        if (last) {
          tma_load_1d(side + slot * kSSide, &wsmap, &full[slot], col0);
          tma_load_1d(side + slot * kSSide + kSSide / 2, &bmap, &full[slot], col0);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2;
  const int w = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  const unsigned quad = 0xFu << (lane & ~3);
  // this thread's rows: block rows 64 wg + 16 w + g + 8 h, h = 0, 1
  const int rb = 64 * wg + 16 * w + g;
  const bool wg_live = row0 + 64 * wg < n;  // warpgroup-uniform
  bool live[2];
  float xsr[2], m_run[2], l_run[2], thr_v[2];
  int thr_i[2], cnt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + rb + 8 * h;
    live[h] = r < n;
    xsr[h] = live[h] ? xscale[r] : 0.f;
    m_run[h] = -INFINITY;
    l_run[h] = 0.f;
    thr_v[h] = -INFINITY;
    thr_i[h] = INT32_MAX;
    cnt[h] = 0;
  }
  mbar_wait(xfull, 0);

  int acc[64];
#pragma unroll
  for (int x = 0; x < 64; ++x) acc[x] = 0;
  int floor_key[2] = {0, 0};
  for (int s = 0; s < nslices; ++s) {
    const int slot = s % kSStages;
    const int kb = s % nkb;
    mbar_wait(&full[slot], (s / kSStages) & 1);
    if (!kWindow && kb == 0) {
      // the rows' floors as other runs have raised them, read ahead of the
      // tile's epilogue
#pragma unroll
      for (int h = 0; h < 2; ++h) floor_key[h] = live[h] ? __ldcg(row_floor + row0 + rb + 8 * h) : 0;
    }
    if (wg_live) {
#pragma unroll
      for (int x = 0; x < 64; ++x) fence_operand(acc[x]);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wgmma_m64n128k32_s8(acc, desc_sw128(xs + kb * kSRows * kSDepth + wg * 64 * kSDepth + 32 * j),
                            desc_sw128(ring + slot * kSSlice + 32 * j), (kb | j) != 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int x = 0; x < 64; ++x) fence_operand(acc[x]);
    }
    if (kb != nkb - 1 || !wg_live) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
      continue;
    }

    // tile complete: d[4 i + 2 h + e] is row rb + 8 h, column col0 + 8 i + 2 t + e.
    // The logits replace the sums in place (f32 bits), since the next tile's
    // first product overwrites them; the slot (its ws and bias) is released
    // after them.
    const int col0 = (t_begin + s / nkb) * kSCols;
    const float* ws_tile = reinterpret_cast<const float*>(side + slot * kSSide);
    const float* b_tile = ws_tile + kSCols;
    int* sv = acc;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float2 wsp = *reinterpret_cast<const float2*>(ws_tile + 8 * i + 2 * t);
      const float2 bp = *reinterpret_cast<const float2*>(b_tile + 8 * i + 2 * t);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + 8 * i + 2 * t + e;
        const bool valid = col < vocab;
        const float wsv = e ? wsp.y : wsp.x;
        const float bcol = e ? bp.y : bp.x;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = 4 * i + 2 * h + e;
          sv[x] = __float_as_int(
              valid ? __fadd_rn(__fmul_rn(__fmul_rn(static_cast<float>(acc[x]), xsr[h]), wsv),
                                bcol)
                    : -INFINITY);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
    float cm[2], wv[2];
    int wi[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float cmax = -INFINITY;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        cmax = fmaxf(cmax, fmaxf(__int_as_float(sv[4 * i + 2 * h]),
                                 __int_as_float(sv[4 * i + 2 * h + 1])));
      }
      cm[h] = cmax;
      if (cmax > -INFINITY) {
        const float m_new = fmaxf(m_run[h], cmax);
        float l = l_run[h] * expf(m_run[h] - m_new);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          l += expf(__int_as_float(sv[4 * i + 2 * h]) - m_new);
          l += expf(__int_as_float(sv[4 * i + 2 * h + 1]) - m_new);
        }
        m_run[h] = m_new;
        l_run[h] = l;
      }
      if constexpr (kWindow) {
        // the tile is one window: its top-1, the highest column on ties --
        // the thread's highest column holding its maximum (columns rise with
        // j), then the quad's
        uint32_t at_max = 0u;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          if (__int_as_float(sv[4 * (j >> 1) + 2 * h + (j & 1)]) == cmax) at_max |= 1u << j;
        }
        wv[h] = cmax;
        wi[h] = -1;
        if (cmax > -INFINITY) {
          const int j = 31 - __clz(at_max);
          wi[h] = col0 + 8 * (j >> 1) + 2 * t + (j & 1);
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, wv[h], o);
          const int oi = __shfl_xor_sync(0xffffffffu, wi[h], o);
          if (ov > wv[h] || (ov == wv[h] && oi > wi[h])) {
            wv[h] = ov;
            wi[h] = oi;
          }
        }
      }
    }
    // the candidates, one row at a time (the loop is not unrolled: one copy
    // of its code), the row's state picked by h
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      const bool lv = h ? live[1] : live[0];
      float tv = h ? thr_v[1] : thr_v[0];
      int ti = h ? thr_i[1] : thr_i[0];
      int c = h ? cnt[1] : cnt[0];
      float* rbv = cand_v + (rb + 8 * h) * kCap;
      int* rbi = cand_i + (rb + 8 * h) * kCap;
      if constexpr (kWindow) {
        const float v = h ? wv[1] : wv[0];
        const int id = h ? wi[1] : wi[0];
        if (lv && id >= 0 && ranks_before(v, id, tv, ti)) {  // quad-uniform
          if (c == kCap) compact_row(rbv, rbi, c, k, tv, ti, t, quad);
          if (t == 0) {
            rbv[c] = v;
            rbi[c] = id;
          }
          ++c;
          __syncwarp(quad);
        }
      } else {
        // every column that ranks before the row's k-th candidate so far and
        // reaches the row's floor (the highest k-th candidate any run of the
        // row has published: k columns reach it, so no column below it is in
        // the row's top k); the loop runs while some quad of the warp has
        // more than its list holds (cut back to k each time)
        const float cmax = h ? cm[1] : cm[0];
        const float fl = key_value(h ? floor_key[1] : floor_key[0]);
        if (!__any_sync(0xffffffffu, lv && cmax >= tv && cmax >= fl)) continue;
        float rv[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int x = 4 * (j >> 1) + (j & 1);
          rv[j] = __int_as_float(h ? sv[x + 2] : sv[x]);
        }
        uint32_t done = 0u;
        for (;;) {
          // the thread's passing columns as a bit mask, without branches
          uint32_t mask = 0u;
          if (lv && cmax >= tv && cmax >= fl) {  // per thread: no shuffle inside
#pragma unroll
            for (int j = 0; j < 32; ++j) {
              const int col = col0 + 8 * (j >> 1) + 2 * t + (j & 1);
              const bool pass = (rv[j] > tv) | ((rv[j] == tv) & (col < ti));
              mask |= static_cast<uint32_t>(pass & (col < vocab) & (rv[j] >= fl)) << j;
            }
            mask &= ~done;
          }
          const int mine_n = __popc(mask);
          int incl = mine_n;
#pragma unroll
          for (int o = 1; o < 4; o <<= 1) {
            const int up = __shfl_up_sync(0xffffffffu, incl, o, 4);
            if (t >= o) incl += up;
          }
          const int total = __shfl_sync(0xffffffffu, incl, 3, 4);
          const int before = incl - mine_n;
          const int space = kCap - c;
          const int allow = min(mine_n, max(0, space - before));
          // the first `allow` of them, lowest column first; a value is picked
          // out of the registers by a chain of selects
          uint32_t left = mask;
          for (int q = 0; q < allow; ++q) {
            const int j = __ffs(left) - 1;
            left &= left - 1;
            float v = rv[0];
#pragma unroll
            for (int jj = 1; jj < 32; ++jj) v = jj == j ? rv[jj] : v;
            rbv[c + before + q] = v;
            rbi[c + before + q] = col0 + 8 * (j >> 1) + 2 * t + (j & 1);
            done |= 1u << j;
          }
          c += min(total, space);
          const bool more = total > space;  // quad-uniform
          __syncwarp();
          if (!__any_sync(0xffffffffu, more)) break;
          if (more) {
            compact_row(rbv, rbi, c, k, tv, ti, t, quad);
            if (t == 0 && c == k) atomicMax(row_floor + row0 + rb + 8 * h, order_key(tv));
          }
          __syncwarp();
        }
      }
      if (h) {
        thr_v[1] = tv;
        thr_i[1] = ti;
        cnt[1] = c;
      } else {
        thr_v[0] = tv;
        thr_i[0] = ti;
        cnt[0] = c;
      }
    }
  }

  // the row's (max, sum) over its quad, its candidates in rank order
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m_run[h], o);
      const float ol = __shfl_xor_sync(0xffffffffu, l_run[h], o);
      const float mm = fmaxf(m_run[h], om);
      float l = 0.f;
      if (m_run[h] > -INFINITY) l += l_run[h] * expf(m_run[h] - mm);
      if (om > -INFINITY) l += ol * expf(om - mm);
      m_run[h] = mm;
      l_run[h] = l;
    }
  }
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    if (!(h ? live[1] : live[0])) continue;  // quad-uniform
    float tv = h ? thr_v[1] : thr_v[0];
    int ti = h ? thr_i[1] : thr_i[0];
    int c = h ? cnt[1] : cnt[0];
    float* rbv = cand_v + (rb + 8 * h) * kCap;
    int* rbi = cand_i + (rb + 8 * h) * kCap;
    compact_row(rbv, rbi, c, k, tv, ti, t, quad);
    const size_t o = static_cast<size_t>(blockIdx.y) * n + row0 + rb + 8 * h;
    if (t == 0) {
      part_m[o] = h ? m_run[1] : m_run[0];
      part_l[o] = h ? l_run[1] : l_run[0];
    }
    for (int i = t; i < k; i += 4) {
      part_v[o * k + i] = i < c ? rbv[i] : -INFINITY;
      part_i[o * k + i] = i < c ? rbi[i] : INT32_MAX;
    }
  }
}

int launch_bucket(const void* hidden, const void* weight, const void* wscale, const void* bias,
                  void* l_out, void* rmax_out, void* rid_out, void* l_part, void* rmax_part,
                  void* rid_part, int n, int d, int vocab, int buckets, int splits,
                  void* stream) {
  const size_t smem = bucket_smem_bytes(d);
  if (!bucket_args_ok(n, vocab, buckets, splits) || d % kBDepth != 0 || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap wmap;
  cudaError_t err = encode_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, weight, d, vocab,
                              kBDepth, kBCols, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(bucket_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool split = splits > 1;
  const dim3 grid((n + kBRows - 1) / kBRows, buckets / kBCols, splits);
  bucket_kernel<<<grid, kThreads, smem, s>>>(
      wmap, static_cast<const __nv_bfloat16*>(hidden), static_cast<const float*>(wscale),
      static_cast<const float*>(bias), static_cast<float*>(split ? l_part : l_out),
      static_cast<float*>(split ? rmax_part : rmax_out),
      static_cast<int32_t*>(split ? rid_part : rid_out), n, d, vocab, buckets);
  return bucket_merge(l_out, rmax_out, rid_out, l_part, rmax_part, rid_part, n, buckets, splits,
                      s);
}

template <bool kWindow>
int launch_select(const void* xq, const void* xscale, const void* weight, const void* wscale,
                  const void* bias, void* row_floor, void* part_m, void* part_l, void* part_v,
                  void* part_i, void* lp, void* ids, void* lse, int n, int d, int vocab, int k,
                  int runs, void* stream) {
  const size_t smem = select_smem_bytes(d);
  const int ntiles = (vocab + kSCols - 1) / kSCols;
  if (n < 1 || vocab < 1 || d % 64 != 0 || smem > kMaxSmem || k < 1 || k > kTopK || runs < 1 ||
      runs > ntiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap xmap, wmap, wsmap, bmap;
  cudaError_t err = encode_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, xq, d, n, kSDepth, kSRows,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess) {
    err = encode_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, weight, d, vocab, kSDepth, kSCols,
                    CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err == cudaSuccess) err = encode_1d_f32(&wsmap, wscale, vocab, kSCols);
  if (err == cudaSuccess) err = encode_1d_f32(&bmap, bias, vocab, kSCols);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(select_kernel<kWindow>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // every row's floor starts below every value (order_key 0x80808080)
  err = cudaMemsetAsync(row_floor, 0x80, static_cast<size_t>(n) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // row tiles vary fastest, so the blocks of one run are scheduled together
  const dim3 grid((n + kSRows - 1) / kSRows, runs);
  select_kernel<kWindow><<<grid, kThreads, smem, s>>>(
      xmap, wmap, wsmap, bmap, static_cast<const float*>(xscale),
      static_cast<int*>(row_floor), static_cast<float*>(part_m),
      static_cast<float*>(part_l),
      static_cast<float*>(part_v), static_cast<int32_t*>(part_i), n, d, vocab, k);
  return select_merge(part_m, part_l, part_v, part_i, lp, ids, lse, n, k, runs, s);
}

}  // namespace q8

}  // namespace

// buckets: the chunk width, a multiple of kBC (512 unless bucket_bv is set).
extern "C" int mic_fused_head_bucket_bf16(void* hidden, void* weight, void* bias, void* l_out,
                                          void* rmax_out, void* rid_out, void* l_part,
                                          void* rmax_part, void* rid_part, int n, int d,
                                          int vocab, int buckets, int splits, void* stream) {
  return launch_bucket(hidden, weight, bias, l_out, rmax_out, rid_out, l_part, rmax_part,
                       rid_part, n, d, vocab, buckets, splits, stream);
}

extern "C" int mic_fused_head_bucket_q8(void* hidden, void* weight_q, void* wscale, void* bias,
                                        void* l_out, void* rmax_out, void* rid_out,
                                        void* l_part, void* rmax_part, void* rid_part, int n,
                                        int d, int vocab, int buckets, int splits,
                                        void* stream) {
  return q8::launch_bucket(hidden, weight_q, wscale, bias, l_out, rmax_out, rid_out, l_part,
                           rmax_part, rid_part, n, d, vocab, buckets, splits, stream);
}

// The exact/window select on bf16 operands (window != 0 selects "window").
extern "C" int mic_fused_head_select_bf16(void* hidden, void* weight, void* bias, void* part_m,
                                          void* part_l, void* part_v, void* part_i, void* lp,
                                          void* ids, void* lse, int n, int d, int vocab, int k,
                                          int runs, int window, void* stream) {
  auto launch = window ? launch_select<true> : launch_select<false>;
  return launch(hidden, weight, bias, part_m, part_l, part_v, part_i, lp, ids, lse, n, d, vocab,
                k, runs, stream);
}

// The same on int8 operands: xq (N, D) with row scales xs (N,), weight_q
// (V, D) with row scales wscale (V,); row_floor (N,) int32 scratch.
extern "C" int mic_fused_head_select_q8(void* xq, void* xs, void* weight_q, void* wscale,
                                        void* bias, void* row_floor, void* part_m, void* part_l,
                                        void* part_v, void* part_i, void* lp, void* ids,
                                        void* lse, int n, int d, int vocab, int k, int runs,
                                        int window, void* stream) {
  auto launch = window ? q8::launch_select<true> : q8::launch_select<false>;
  return launch(xq, xs, weight_q, wscale, bias, row_floor, part_m, part_l, part_v, part_i, lp,
                ids, lse, n, d, vocab, k, runs, stream);
}
