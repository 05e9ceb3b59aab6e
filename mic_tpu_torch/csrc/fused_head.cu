// Fused tied LM head with bucket candidate select: the accumulator pass.
//
// Replaces mic_tpu/ops/fused_head.py::fused_head_topk(select="bucket"), the
// _kernel_bucket_acc Pallas kernel of its n > 512 path.  Logits
// s = hidden @ weight^T + bias are never stored.  The vocab is cut into
// chunks of `buckets` columns (the TPU's bv, on which the candidate ids
// depend: 512, or MIC_TPU_EXPERIMENTAL=bucket_bv; any multiple of kBC);
// bucket column j of a row keeps, over the chunks in order,
//
//   l[j]    += exp(min(s, 60))                    (fixed-offset sum of exps)
//   rmax[j], rid[j] <- s, id   where s > rmax[j]  (strict: earliest chunk wins)
//
// with columns >= V masked to -1e30.  The three (N, buckets) planes go back
// to the caller, which finishes lse and the top-k of the bucket winners as
// the TPU's _bucket_finish_host does in XLA.
//
// Bound: at the flagship decode shape (N = 1024 rows, D = 1024, V = 250054)
// the GEMM's 0.52 TFLOP puts it above the card's bf16 ridge point; at a few
// rows (N = 4, one image of beam 4) it is a stream of the 512 MB weight.  As
// built, neither bound is reached: one block fits an SM (177 KB of shared
// memory at D = 1024), and each block's serial walk of 64-wide slices sets
// the time.  Design: a block owns 64
// rows x 64 bucket columns and walks a run of consecutive vocab chunks in
// order, so the bucket update is a plain per-thread register update.  Its 64
// hidden rows stay resident in shared memory for the whole walk; the weight
// is read as it is stored, (V, D) with each vocab row contiguous, in 64 x 64
// slices through a three-stage cp.async ring, and multiplied with bf16 WMMA
// (mma.sync) into f32.  Each row tile streams the weight once, so a step
// reads it ceil(N / 64) times; blocks of one bucket-column group run in the
// same wave and mostly meet in L2.
//
// When the row tiles x column groups (8 at 512) leave most SMs idle (small N), the
// caller splits the chunk walk into `splits` consecutive runs (grid z).  Each
// run writes its own three planes, and a merge kernel folds them in chunk
// order -- sums added, and the strict > so that the earliest chunk still wins
// ties -- giving the planes of one walk over all chunks.
//
// The int8-weight variant (kInt8) replaces fused_head_topk_q8's bucket
// kernels (_kernel_q8_bucket, _kernel_q8_bucket_acc): the (V, D) weight is
// int8 with one f32 scale per vocab row.  Each slice streams half the bytes
// into an int8 ring, is converted to bf16 in shared memory (every int8
// value is exact in bf16) and goes through the same bf16 tensor-core
// product; the epilogue is s * ws[col] + b[col] in f32, with no FMA
// contraction (__fmul_rn, __fadd_rn), as the TPU computes it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

constexpr int kPadQ = 16;      // int8 ring row padding (keeps 16-byte rows)

// bf16: resident hidden tile, a bf16 slice ring, the score tile.  int8: the
// ring holds int8 slices, plus one bf16 slice the product reads.
size_t smem_bytes(int d, bool int8) {
  const size_t ring = int8 ? static_cast<size_t>(kStages) * kBC * (kBK + kPadQ) +
                                 static_cast<size_t>(kBC) * (kBK + kPad) * 2
                           : static_cast<size_t>(kStages) * kBC * (kBK + kPad) * 2;
  return static_cast<size_t>(kBM) * (d + kPad) * 2 + ring +
         static_cast<size_t>(kBM) * (kBC + kPadS) * 4;
}

template <bool kInt8>
__global__ void __launch_bounds__(kThreads)
fused_head_bucket_kernel(const __nv_bfloat16* __restrict__ hidden,  // (N, D)
                         const void* __restrict__ weight_raw,       // (V, D) bf16 or int8
                         const float* __restrict__ wscale,          // (V,), int8 only
                         const float* __restrict__ bias,            // (V,)
                         float* __restrict__ l_out,                 // (splits, N, buckets)
                         float* __restrict__ rmax_out,              // (splits, N, buckets)
                         int32_t* __restrict__ rid_out,             // (splits, N, buckets)
                         int n, int d, int vocab, int buckets) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int lda = d + kPad;
  constexpr int ldb = kBK + kPad;
  constexpr int lds = kBC + kPadS;
  constexpr int ldq = kBK + kPadQ;
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  // bf16: the ring; int8: the one converted slice, then the int8 ring
  __nv_bfloat16* bs = as + kBM * lda;
  int8_t* qs = reinterpret_cast<int8_t*>(bs + (kInt8 ? 1 : kStages) * kBC * ldb);
  float* ss = kInt8 ? reinterpret_cast<float*>(qs + kStages * kBC * ldq)
                    : reinterpret_cast<float*>(qs);

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
    // 16-byte pieces of a weight row: 8 bf16 or 16 int8 values
    constexpr int kPer = kInt8 ? 16 : 8;
    for (int i = tid; i < kBC * (kBK / kPer); i += kThreads) {
      const int r = i / (kBK / kPer);
      const int c = (i % (kBK / kPer)) * kPer;
      // the ragged last chunk re-reads row V-1; its scores are masked below
      const size_t src = static_cast<size_t>(min(chunk * buckets + col0 + r, vocab - 1)) * d + kk + c;
      if constexpr (kInt8) {
        cp_async16(qs + (s % kStages) * kBC * ldq + r * ldq + c,
                   static_cast<const int8_t*>(weight_raw) + src);
      } else {
        cp_async16(bs + (s % kStages) * kBC * ldb + r * ldb + c,
                   static_cast<const __nv_bfloat16*>(weight_raw) + src);
      }
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

    if constexpr (kInt8) {
      // int8 slice -> bf16 slice; the next write of bs follows the next
      // iteration's barrier, after every warp's product below
      // (one 16-byte load of 16 values, two 16-byte stores of their bf16)
      const int8_t* src = qs + (s % kStages) * kBC * ldq;
      for (int i = tid; i < kBC * (kBK / 16); i += kThreads) {
        const int r = i / (kBK / 16);
        const int c = (i % (kBK / 16)) * 16;
        const uint4 raw = *reinterpret_cast<const uint4*>(src + r * ldq + c);
        const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
        __align__(16) __nv_bfloat162 pairs[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          pairs[j] = __floats2bfloat162_rn(static_cast<float>(v[2 * j]),
                                           static_cast<float>(v[2 * j + 1]));
        }
        uint4* dst = reinterpret_cast<uint4*>(bs + r * ldb + c);
        dst[0] = reinterpret_cast<const uint4*>(pairs)[0];
        dst[1] = reinterpret_cast<const uint4*>(pairs)[1];
      }
      __syncthreads();
    }
    const __nv_bfloat16* b_tile = bs + (kInt8 ? 0 : (s % kStages) * kBC * ldb);
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
        if (v < vocab) {
          sc = kInt8 ? __fadd_rn(__fmul_rn(ss[r * lds + c], wscale[v]), bias[v])
                     : ss[r * lds + c] + bias[v];
        }
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
template <bool kInt8>
int launch_bucket(void* hidden, void* weight, void* wscale, void* bias, void* l_out,
                  void* rmax_out, void* rid_out, void* l_part, void* rmax_part, void* rid_part,
                  int n, int d, int vocab, int buckets, int splits, void* stream) {
  const size_t smem = smem_bytes(d, kInt8);
  if (buckets < kBC || buckets % kBC != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nchunks = (vocab + buckets - 1) / buckets;
  if (n < 1 || vocab < 1 || d % kBK != 0 || smem > 232448 || splits < 1 || splits > nchunks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(fused_head_bucket_kernel<kInt8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool split = splits > 1;
  const dim3 grid((n + kBM - 1) / kBM, buckets / kBC, splits);
  fused_head_bucket_kernel<kInt8><<<grid, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(hidden), weight, static_cast<const float*>(wscale),
      static_cast<const float*>(bias), static_cast<float*>(split ? l_part : l_out),
      static_cast<float*>(split ? rmax_part : rmax_out),
      static_cast<int32_t*>(split ? rid_part : rid_out), n, d, vocab, buckets);
  if (split) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int total = n * buckets;
    fused_head_bucket_merge_kernel<<<(total + 255) / 256, 256, 0, s>>>(
        static_cast<const float*>(l_part), static_cast<const float*>(rmax_part),
        static_cast<const int32_t*>(rid_part), static_cast<float*>(l_out),
        static_cast<float*>(rmax_out), static_cast<int32_t*>(rid_out), total, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Exact and window candidate select.
//
// Replaces fused_head_topk(select="exact"/"window") (the _kernel Pallas
// kernel of mic_tpu/ops/fused_head.py) and the exact/window path of
// fused_head_topk_q8 (_kernel_q8).  Per hidden row it computes the row's
// online (max, sum of exps) of the logits and its candidates: the exact
// top-k (on equal values the lowest id first, the leftmost max of
// _select_topk), or the top-k over the 128-wide windows' top-1s (inside a
// window the highest lane wins a tie, between windows the lowest window).
// bf16 operands multiply on bf16 tensor cores into f32 and s = acc + b.  int8
// operands (the row-quantized activation, scale xs, and the int8 weight,
// scale ws) multiply on int8 tensor cores into exact int32, and
// s = acc * xs[row] * ws[col] + b[col] with no FMA contraction: these
// logits equal the plain version's bit for bit.
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
// 128 KB in bf16 at D = 1024, 64 KB in int8).  The caller makes the runs as
// many as fill the SMs; the blocks of one run start together and mostly meet
// in L2.  Operands are kept in shared memory in 16-wide k slabs, so every
// tensor-core fragment (bf16 or int8) starts 32-byte aligned.

constexpr int kSN = 128;       // vocab columns per tile (= the 128-wide window)
constexpr int kSK = 32;        // depth of one weight slice
constexpr int kSThreads = 256; // 8 warps: 2 x 4, each 32 rows x 32 columns
constexpr int kSLds = kSN + 4; // row pitch of the score tile
constexpr int kTopK = 16;      // the largest k served

size_t select_smem_bytes(int d, size_t elem) {
  return static_cast<size_t>(kBM) * d * elem + static_cast<size_t>(kStages) * kSN * kSK * elem +
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

template <typename T, bool kWindow>
__global__ void __launch_bounds__(kSThreads)
fused_head_select_kernel(const T* __restrict__ x,           // (N, D) bf16 hidden or int8 rows
                         const float* __restrict__ xscale,  // (N,), int8 only
                         const T* __restrict__ weight,      // (V, D)
                         const float* __restrict__ wscale,  // (V,), int8 only
                         const float* __restrict__ bias,    // (V,)
                         float* __restrict__ part_m,        // (runs, N)
                         float* __restrict__ part_l,        // (runs, N)
                         float* __restrict__ part_v,        // (runs, N, k)
                         int32_t* __restrict__ part_i,      // (runs, N, k)
                         int n, int d, int vocab, int k) {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  using Acc = typename std::conditional<kInt8, int, float>::type;
  using Frag = typename std::conditional<kInt8, signed char, __nv_bfloat16>::type;
  constexpr int kPer = 16 / sizeof(T);  // values in a 16-byte piece
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* as = reinterpret_cast<T*>(smem_raw);          // [D/16][64 rows][16]
  T* bs = as + kBM * d;                            // [stage][2][128 cols][16]
  Acc* ss = reinterpret_cast<Acc*>(bs + kStages * kSN * kSK);

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
  const float xs_r = (kInt8 && row0 + er < n) ? xscale[row0 + er] : 0.f;
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

  fragment<accumulator, 16, 16, 16, Acc> acc[2][2];
  for (int s = 0; s < nslices; ++s) {
    const int ks = s % nk;
    if (ks == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(acc[i][j], static_cast<Acc>(0));
    }
    cp_async_wait_one();
    __syncthreads();
    if (s + kStages - 1 < nslices) load_slice(s + kStages - 1);
    cp_async_commit();

    const T* b_tile = bs + (s % kStages) * kSN * kSK;
#pragma unroll
    for (int j16 = 0; j16 < kSK / 16; ++j16) {
      const int slab = ks * (kSK / 16) + j16;
      fragment<matrix_a, 16, 16, 16, Frag, row_major> fa[2];
      fragment<matrix_b, 16, 16, 16, Frag, col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        nvcuda::wmma::load_matrix_sync(
            fa[i], reinterpret_cast<const Frag*>(as + slab * (kBM * 16) + (wm + 16 * i) * 16), 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        nvcuda::wmma::load_matrix_sync(
            fb[j], reinterpret_cast<const Frag*>(b_tile + j16 * (kSN * 16) + (wn + 16 * j) * 16),
            16);
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
        if (col < vocab) {
          if constexpr (kInt8) {
            sc = __fadd_rn(__fmul_rn(__fmul_rn(static_cast<float>(ss[er * kSLds + eq + 4 * j]), xs_r),
                                     wscale[col]),
                           bias[col]);
          } else {
            sc = ss[er * kSLds + eq + 4 * j] + bias[col];
          }
        }
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

template <typename T, bool kWindow>
int launch_select(const void* x, const void* xscale, const void* weight, const void* wscale,
                  const void* bias, void* part_m, void* part_l, void* part_v, void* part_i,
                  void* lp, void* ids, void* lse, int n, int d, int vocab, int k, int runs,
                  void* stream) {
  const size_t smem = select_smem_bytes(d, sizeof(T));
  const int ntiles = (vocab + kSN - 1) / kSN;
  if (n < 1 || vocab < 1 || d % kSK != 0 || smem > 232448 || k < 1 || k > kTopK || runs < 1 ||
      runs > ntiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(fused_head_select_kernel<T, kWindow>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // row tiles vary fastest, so the blocks of one run are scheduled together
  const dim3 grid((n + kBM - 1) / kBM, runs);
  fused_head_select_kernel<T, kWindow><<<grid, kSThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(xscale), static_cast<const T*>(weight),
      static_cast<const float*>(wscale), static_cast<const float*>(bias),
      static_cast<float*>(part_m), static_cast<float*>(part_l), static_cast<float*>(part_v),
      static_cast<int32_t*>(part_i), n, d, vocab, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_head_select_merge_kernel<<<(n + 127) / 128, 128, 0, s>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_v), static_cast<const int32_t*>(part_i),
      static_cast<float*>(lp), static_cast<int32_t*>(ids), static_cast<float*>(lse), n, k, runs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// buckets: the chunk width, a multiple of kBC (512 unless bucket_bv is set).
extern "C" int mic_fused_head_bucket_bf16(void* hidden, void* weight, void* bias, void* l_out,
                                          void* rmax_out, void* rid_out, void* l_part,
                                          void* rmax_part, void* rid_part, int n, int d,
                                          int vocab, int buckets, int splits, void* stream) {
  return launch_bucket<false>(hidden, weight, nullptr, bias, l_out, rmax_out, rid_out, l_part,
                              rmax_part, rid_part, n, d, vocab, buckets, splits, stream);
}

extern "C" int mic_fused_head_bucket_q8(void* hidden, void* weight_q, void* wscale, void* bias,
                                        void* l_out, void* rmax_out, void* rid_out,
                                        void* l_part, void* rmax_part, void* rid_part, int n,
                                        int d, int vocab, int buckets, int splits,
                                        void* stream) {
  return launch_bucket<true>(hidden, weight_q, wscale, bias, l_out, rmax_out, rid_out, l_part,
                             rmax_part, rid_part, n, d, vocab, buckets, splits, stream);
}

// The exact/window select on bf16 operands (window != 0 selects "window").
extern "C" int mic_fused_head_select_bf16(void* hidden, void* weight, void* bias, void* part_m,
                                          void* part_l, void* part_v, void* part_i, void* lp,
                                          void* ids, void* lse, int n, int d, int vocab, int k,
                                          int runs, int window, void* stream) {
  auto launch = window ? launch_select<__nv_bfloat16, true> : launch_select<__nv_bfloat16, false>;
  return launch(hidden, nullptr, weight, nullptr, bias, part_m, part_l, part_v, part_i, lp, ids,
                lse, n, d, vocab, k, runs, stream);
}

// The same on int8 operands: xq (N, D) with row scales xs (N,), weight_q
// (V, D) with row scales wscale (V,).
extern "C" int mic_fused_head_select_q8(void* xq, void* xs, void* weight_q, void* wscale,
                                        void* bias, void* part_m, void* part_l, void* part_v,
                                        void* part_i, void* lp, void* ids, void* lse, int n,
                                        int d, int vocab, int k, int runs, int window,
                                        void* stream) {
  auto launch = window ? launch_select<int8_t, true> : launch_select<int8_t, false>;
  return launch(xq, xs, weight_q, wscale, bias, part_m, part_l, part_v, part_i, lp, ids, lse, n,
                d, vocab, k, runs, stream);
}
