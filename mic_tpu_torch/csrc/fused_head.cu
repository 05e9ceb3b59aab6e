// Fused tied LM head with bucket candidate select: the accumulator pass.
//
// Replaces mic_tpu/ops/fused_head.py::fused_head_topk(select="bucket"), the
// _kernel_bucket_acc Pallas kernel of its n > 512 path.  Logits
// s = hidden @ weight^T + bias are never stored.  The vocab is cut into
// chunks of kBuckets = 512 (the TPU's bv, on which the candidate ids
// depend); bucket column j of a row keeps, over the chunks in order,
//
//   l[j]    += exp(min(s, 60))                    (fixed-offset sum of exps)
//   rmax[j], rid[j] <- s, id   where s > rmax[j]  (strict: earliest chunk wins)
//
// with columns >= V masked to -1e30.  The three (N, 512) planes go back to
// the caller, which finishes lse and the top-k of the 512 bucket winners as
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
// When the row tiles x 8 column groups leave most SMs idle (small N), the
// caller splits the chunk walk into `splits` consecutive runs (grid z).  Each
// run writes its own three planes, and a merge kernel folds them in chunk
// order -- sums added, and the strict > so that the earliest chunk still wins
// ties -- giving the planes of one walk over all chunks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using nvcuda::wmma::accumulator;
using nvcuda::wmma::col_major;
using nvcuda::wmma::fragment;
using nvcuda::wmma::matrix_a;
using nvcuda::wmma::matrix_b;
using nvcuda::wmma::mem_row_major;
using nvcuda::wmma::row_major;

constexpr int kBuckets = 512;  // bv of mic_tpu/ops/fused_head.py::_bucket_tiles
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

size_t smem_bytes(int d) {
  return static_cast<size_t>(kBM) * (d + kPad) * 2 +
         static_cast<size_t>(kStages) * kBC * (kBK + kPad) * 2 +
         static_cast<size_t>(kBM) * (kBC + kPadS) * 4;
}

__global__ void __launch_bounds__(kThreads)
fused_head_bucket_kernel(const __nv_bfloat16* __restrict__ hidden,  // (N, D)
                         const __nv_bfloat16* __restrict__ weight,  // (V, D)
                         const float* __restrict__ bias,            // (V,)
                         float* __restrict__ l_out,                 // (splits, N, 512)
                         float* __restrict__ rmax_out,              // (splits, N, 512)
                         int32_t* __restrict__ rid_out,             // (splits, N, 512)
                         int n, int d, int vocab) {
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
  const int nchunks = (vocab + kBuckets - 1) / kBuckets;
  const int c_begin = static_cast<int>(static_cast<int64_t>(blockIdx.z) * nchunks / gridDim.z);
  const int c_end = static_cast<int>(static_cast<int64_t>(blockIdx.z + 1) * nchunks / gridDim.z);
  // the run streams as one sequence of slices: slice s is depth block
  // s % nk of vocab chunk c_begin + s / nk
  const int nslices = (c_end - c_begin) * nk;
  auto load_slice = [&](int s) {
    const int chunk = c_begin + s / nk;
    const int kk = (s % nk) * kBK;
    __nv_bfloat16* dst = bs + (s % kStages) * kBC * ldb;
    for (int i = tid; i < kBC * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8);
      const int c = (i % (kBK / 8)) * 8;
      // the ragged last chunk re-reads row V-1; its scores are masked below
      const int v = min(chunk * kBuckets + col0 + r, vocab - 1);
      cp_async16(dst + r * ldb + c, weight + static_cast<size_t>(v) * d + kk + c);
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
      const int base = (c_begin + s / nk) * kBuckets + col0;
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const int e = tid + i * kThreads;
        const int r = e / kBC;
        const int c = e % kBC;
        const int v = base + c;
        const float sc = v < vocab ? ss[r * lds + c] + bias[v] : kNegInf;
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
      const size_t o = (static_cast<size_t>(blockIdx.z) * n + r) * kBuckets + col0 + e % kBC;
      l_out[o] = l_acc[i];
      rmax_out[o] = m_acc[i];
      rid_out[o] = id_acc[i];
    }
  }
}

// Folds the per-split planes (splits, N*512) into (N*512) in split order,
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

}  // namespace

// With splits == 1 the walk writes the (N, 512) outputs directly and the
// *_part pointers are unused; with splits > 1 it writes (splits, N, 512)
// partial planes there, which the merge kernel folds into the outputs.
extern "C" int mic_fused_head_bucket_bf16(void* hidden, void* weight, void* bias, void* l_out,
                                          void* rmax_out, void* rid_out, void* l_part,
                                          void* rmax_part, void* rid_part, int n, int d,
                                          int vocab, int splits, void* stream) {
  const size_t smem = smem_bytes(d);
  const int nchunks = (vocab + kBuckets - 1) / kBuckets;
  if (n < 1 || vocab < 1 || d % kBK != 0 || smem > 232448 || splits < 1 || splits > nchunks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(fused_head_bucket_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool split = splits > 1;
  const dim3 grid((n + kBM - 1) / kBM, kBuckets / kBC, splits);
  fused_head_bucket_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(hidden), static_cast<const __nv_bfloat16*>(weight),
      static_cast<const float*>(bias), static_cast<float*>(split ? l_part : l_out),
      static_cast<float*>(split ? rmax_part : rmax_out),
      static_cast<int32_t*>(split ? rid_part : rid_out), n, d, vocab);
  if (split) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int total = n * kBuckets;
    fused_head_bucket_merge_kernel<<<(total + 255) / 256, 256, 0, s>>>(
        static_cast<const float*>(l_part), static_cast<const float*>(rmax_part),
        static_cast<const int32_t*>(rid_part), static_cast<float*>(l_out),
        static_cast<float*>(rmax_out), static_cast<int32_t*>(rid_out), total, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
