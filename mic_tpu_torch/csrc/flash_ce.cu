// Flash cross-entropy over the tied LM head (training): the forward
// statistics (optionally saving the logits), the dl backward, and the two
// backward contractions of the split and save routes.  No kernel stores f32
// logits of the main vocab span.
//
// Replaces mic_tpu/ops/flash_ce.py::flash_ce_forward (_ce_fwd_kernel via
// _lse_main, and _ce_fwd_save_kernel via _lse_main_save), ::flash_ce_backward_dl
// (_ce_dl_kernel), ::flash_ce_backward (_ce_gw_kernel, _ce_gh_kernel) and
// ::flash_ce_backward_save (_ce_gw_save_kernel, _ce_gh_save_kernel).  Per row
// of s = hidden @ weight^T + bias over the whole vocab:
//
//   forward:  lse = log sum exp(s), zsum = sum(s)  (online max + rescaled sum)
//   save:     the same, and s stored: bf16 (N, v_main), f32 (N, V - v_main)
//   dl:       dl = (exp(s - lse) - target) * rowscale as bf16 (N, V), with
//             target = low + (conf - low) * onehot(label), plus exact f32
//             per-band dbias partials folded in band order.
//   grad-W:   demb = dl^T @ hidden (V, D) f32 and dbias = column sums of dl
//   grad-h:   dh = dl @ weight (N, D) f32
//
// For grad-W and grad-h dl is rounded to bf16 before the contraction, as
// mic_tpu's kernels do, and s is either recomputed (split) or the saved bf16
// logits (save, over the first v_main columns; the f32 tail is contracted
// outside, as mic_tpu does).  Columns >= V never enter a sum and are never
// written.  The label logit and the dh / demb GEMMs over dl stay outside, as
// mic_tpu computes them outside its kernels.
//
// Bound: at the flagship training step (N = 4096 rows, D = 1024,
// V = 250054) each kernel is a 2.1 TFLOP GEMM (4.2 for a recomputing
// contraction), far above the card's bf16 ridge point, so the tensor cores
// should bound it; the dl kernel also writes 2 GB of bf16 dl, the save
// forward 2 GB of bf16 logits.  Design of the forward and dl kernels (the
// simple first version): a block owns
// 64 rows and walks a run of consecutive 64-wide vocab tiles; per tile it
// streams 64 x 64 slices of hidden and weight (the weight read as stored,
// (V, D), each vocab row contiguous) through a three-stage cp.async ring
// into bf16 WMMA (mma.sync) with f32 accumulation, then runs the epilogue
// on the tile in shared memory.  Hidden is not kept resident, so a block
// needs 73 KB of shared memory and three fit an SM; the hidden rows are
// re-read from L2 per tile.  The vocab walk is cut into runs so that the
// row tiles x runs fill the card; the forward merges the runs' (m, s, z)
// in run order and dbias sums the row bands in band order.  There is no
// float atomic anywhere: two identical calls give bit-equal results.
//
// dl rows start at row * V * 2 bytes, which for an odd V is only 2-byte
// aligned, so dl is written with scalar bf16 stores (a warp writes 64
// consecutive bytes); no padded row pitch is needed.  The saved main logits
// start at row * v_main * 2 bytes, and v_main is a multiple of 128, so they
// are written 16 bytes at a time; the tail's pitch is not aligned, and it
// is written value by value.  The contraction kernels are described where
// they are defined, below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
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
using bf16 = __nv_bfloat16;

constexpr int kBM = 64;        // hidden rows per block
constexpr int kBN = 64;        // vocab columns per tile
constexpr int kBK = 64;        // depth of one slice
constexpr int kStages = 3;
constexpr int kThreads = 128;  // 4 warps, each a 32 x 32 quarter of the tile
constexpr int kLda = kBK + 8;  // bf16 row pitch of a staged slice (bank padding)
constexpr int kLds = kBN + 4;  // f32 row pitch of the score tile
constexpr float kNeg = -FLT_MAX;  // finfo(float32).min, NEG of mic_tpu/ops/flash_ce.py
constexpr size_t kSmemBytes =
    2 * static_cast<size_t>(kStages) * kBM * kLda * sizeof(bf16) +
    static_cast<size_t>(kBM) * kLds * sizeof(float);

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

// This block's run [t_begin, t_end) of 64-wide vocab tiles, run z of gridDim.y.
__device__ __forceinline__ void tile_run(int vocab, int& t_begin, int& t_end) {
  const int ntiles = (vocab + kBN - 1) / kBN;
  t_begin = static_cast<int>(static_cast<int64_t>(blockIdx.y) * ntiles / gridDim.y);
  t_end = static_cast<int>(static_cast<int64_t>(blockIdx.y + 1) * ntiles / gridDim.y);
}

// Walks the block's tiles: for each, the (64 x 64) f32 tile of
// hidden[row0:row0+64] @ weight[tile*64 : tile*64+64]^T lands in `ss` (row
// major, pitch kLds) and epi(ss, first column) runs on it.  Rows past n and
// vocab rows past V re-read the last valid row; the epilogue masks them.
template <class Epilogue>
__device__ __forceinline__ void walk_tiles(const bf16* __restrict__ hidden,
                                           const bf16* __restrict__ weight, int n, int d,
                                           int vocab, int row0, int t_begin, int t_end,
                                           unsigned char* smem, Epilogue& epi) {
  bf16* as = reinterpret_cast<bf16*>(smem);
  bf16* bs = as + kStages * kBM * kLda;
  float* ss = reinterpret_cast<float*>(bs + kStages * kBN * kLda);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;
  const int nk = d / kBK;
  // the run streams as one sequence of slices: slice s is depth block
  // s % nk of vocab tile t_begin + s / nk
  const int nslices = (t_end - t_begin) * nk;
  auto load_slice = [&](int s) {
    const int tile = t_begin + s / nk;
    const int kk = (s % nk) * kBK;
    bf16* a_dst = as + (s % kStages) * kBM * kLda;
    bf16* b_dst = bs + (s % kStages) * kBN * kLda;
    for (int i = tid; i < kBM * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8);
      const int c = (i % (kBK / 8)) * 8;
      const int row = min(row0 + r, n - 1);
      cp_async16(a_dst + r * kLda + c, hidden + static_cast<size_t>(row) * d + kk + c);
      const int v = min(tile * kBN + r, vocab - 1);
      cp_async16(b_dst + r * kLda + c, weight + static_cast<size_t>(v) * d + kk + c);
    }
  };

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

    const bf16* a_tile = as + (s % kStages) * kBM * kLda;
    const bf16* b_tile = bs + (s % kStages) * kBN * kLda;
#pragma unroll
    for (int k16 = 0; k16 < kBK; k16 += 16) {
      fragment<matrix_a, 16, 16, 16, bf16, row_major> fa[2];
      fragment<matrix_b, 16, 16, 16, bf16, col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        nvcuda::wmma::load_matrix_sync(fa[i], a_tile + (wm + 16 * i) * kLda + k16, kLda);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        nvcuda::wmma::load_matrix_sync(fb[j], b_tile + (wn + 16 * j) * kLda + k16, kLda);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) nvcuda::wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }

    if (ks == nk - 1) {
      // tile complete.  The score tile is next written after at least one
      // more barrier, so the epilogue may read (and rewrite) it freely.
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          nvcuda::wmma::store_matrix_sync(ss + (wm + 16 * i) * kLds + wn + 16 * j, acc[i][j],
                                          kLds, mem_row_major);
      __syncthreads();
      epi(ss, (t_begin + s / nk) * kBN);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
}

// Forward epilogue: two threads per row, each folding 32 of the tile's
// columns into its running (max, rescaled sum of exps, sum of logits).
struct RowStats {
  const float* bias;
  int vocab;
  int r;     // row within the block
  int half;  // which 32 columns
  float m = kNeg, s = 0.f, z = 0.f;

  __device__ __forceinline__ void operator()(const float* ss, int col0) {
    const int c0 = col0 + half * 32;
    const int nv = min(32, vocab - c0);
    if (nv <= 0) return;
    const float* row = ss + r * kLds + half * 32;
    float v[32];
    float lmax = kNeg;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      v[j] = j < nv ? row[j] + bias[c0 + j] : kNeg;
      lmax = fmaxf(lmax, v[j]);
    }
    const float mnew = fmaxf(m, lmax);
    float e = 0.f, t = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (j < nv) {
        e += expf(v[j] - mnew);
        t += v[j];
      }
    }
    s = s * expf(m - mnew) + e;
    m = mnew;
    z += t;
  }
};

// Save epilogue: the same fold of the exact f32 tile, then the tile stored,
// rounded to bf16 where it lies in the first v_main columns and as it is in
// the tail.  v_main is a multiple of 128, so no 64-wide tile straddles it.
struct SaveTile {
  RowStats st;
  bf16* lg;     // (N, v_main)
  float* tail;  // (N, V - v_main)
  const float* bias;
  int n, vocab, v_main, row0;

  __device__ __forceinline__ void operator()(const float* ss, int col0) {
    st(ss, col0);
    if (col0 < v_main) {
      for (int i = threadIdx.x; i < kBM * (kBN / 8); i += kThreads) {
        const int r = i / (kBN / 8);
        const int c = (i % (kBN / 8)) * 8;
        if (row0 + r >= n) continue;
        const float* src = ss + r * kLds + c;
        const float* b = bias + col0 + c;
        uint4 raw;
        __nv_bfloat162* pair = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pair[j] = __floats2bfloat162_rn(src[2 * j] + b[2 * j], src[2 * j + 1] + b[2 * j + 1]);
        *reinterpret_cast<uint4*>(lg + static_cast<size_t>(row0 + r) * v_main + col0 + c) = raw;
      }
    } else {
      const int vt = vocab - v_main;
      for (int e = threadIdx.x; e < kBM * kBN; e += kThreads) {
        const int r = e / kBN;
        const int col = col0 + e % kBN;
        if (row0 + r < n && col < vocab)
          tail[static_cast<size_t>(row0 + r) * vt + (col - v_main)] = ss[r * kLds + e % kBN] + bias[col];
      }
    }
  }
};

template <bool kSave>
__global__ void __launch_bounds__(kThreads)
flash_ce_fwd_kernel(const bf16* __restrict__ hidden,  // (N, D)
                    const bf16* __restrict__ weight,  // (V, D)
                    const float* __restrict__ bias,   // (V,)
                    float* __restrict__ part_m,       // (runs, N)
                    float* __restrict__ part_s,       // (runs, N)
                    float* __restrict__ part_z,       // (runs, N)
                    bf16* __restrict__ lg,            // (N, v_main), kSave only
                    float* __restrict__ tail,         // (N, V - v_main), kSave only
                    int n, int d, int vocab, int v_main) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int row0 = blockIdx.x * kBM;
  int t_begin, t_end;
  tile_run(vocab, t_begin, t_end);
  RowStats st;
  st.bias = bias;
  st.vocab = vocab;
  st.r = threadIdx.x >> 1;
  st.half = threadIdx.x & 1;
  if constexpr (kSave) {
    SaveTile epi{st, lg, tail, bias, n, vocab, v_main, row0};
    walk_tiles(hidden, weight, n, d, vocab, row0, t_begin, t_end, smem_raw, epi);
    st = epi.st;
  } else {
    walk_tiles(hidden, weight, n, d, vocab, row0, t_begin, t_end, smem_raw, st);
  }

  // fold the two halves of each row (neighbouring lanes); both lanes get
  // the same sums, the even one writes
  const float m2 = __shfl_xor_sync(0xffffffffu, st.m, 1);
  const float s2 = __shfl_xor_sync(0xffffffffu, st.s, 1);
  const float z2 = __shfl_xor_sync(0xffffffffu, st.z, 1);
  const float m = fmaxf(st.m, m2);
  const float lo = st.half == 0 ? st.s * expf(st.m - m) : s2 * expf(m2 - m);
  const float hi = st.half == 0 ? s2 * expf(m2 - m) : st.s * expf(st.m - m);
  const float zl = st.half == 0 ? st.z : z2;
  const float zh = st.half == 0 ? z2 : st.z;
  const int row = row0 + st.r;
  if (st.half == 0 && row < n) {
    const size_t o = static_cast<size_t>(blockIdx.y) * n + row;
    part_m[o] = m;
    part_s[o] = lo + hi;
    part_z[o] = zl + zh;
  }
}

// Folds the runs' partials in run order: lse = m + log(sum_z s_z e^(m_z - m)).
__global__ void flash_ce_fwd_merge_kernel(const float* __restrict__ part_m,
                                          const float* __restrict__ part_s,
                                          const float* __restrict__ part_z,
                                          float* __restrict__ lse, float* __restrict__ zsum,
                                          int n, int runs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float m = kNeg;
  for (int z = 0; z < runs; ++z) m = fmaxf(m, part_m[static_cast<size_t>(z) * n + i]);
  float s = 0.f, t = 0.f;
  for (int z = 0; z < runs; ++z) {
    const size_t o = static_cast<size_t>(z) * n + i;
    s += part_s[o] * expf(part_m[o] - m);
    t += part_z[o];
  }
  lse[i] = m + logf(s);
  zsum[i] = t;
}

// dl epilogue: the 128 threads cover the 64 x 64 tile 32 times over,
// neighbouring threads on neighbouring columns.  Each f32 dl value goes to
// global memory as bf16 and back into the score tile, whose 64 column sums
// (rows in order) are this band's dbias partial.
struct DlTile {
  bf16* dl;
  float* band;  // this block's row band of the (bands, V) partials
  const float* bias;
  const float* lse_s;  // the block's rows, in shared memory
  const float* rs_s;
  const int* y_s;
  float low, conf_low;
  int n, vocab, row0;

  __device__ __forceinline__ void operator()(float* ss, int col0) {
    const int tid = threadIdx.x;
#pragma unroll 4
    for (int i = 0; i < kBM * kBN / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kBN;
      const int c = e % kBN;
      const int row = row0 + r;
      const int col = col0 + c;
      float g = 0.f;
      if (row < n && col < vocab) {
        const float p = expf(ss[r * kLds + c] + bias[col] - lse_s[r]);
        const float target = low + conf_low * (col == y_s[r] ? 1.f : 0.f);
        g = (p - target) * rs_s[r];
        dl[static_cast<size_t>(row) * vocab + col] = __float2bfloat16(g);
      }
      ss[r * kLds + c] = g;
    }
    __syncthreads();
    if (tid < kBN && col0 + tid < vocab) {
      float acc = 0.f;
      for (int r = 0; r < kBM; ++r) acc += ss[r * kLds + tid];
      band[col0 + tid] = acc;
    }
  }
};

__global__ void __launch_bounds__(kThreads)
flash_ce_dl_kernel(const bf16* __restrict__ hidden,    // (N, D)
                   const bf16* __restrict__ weight,    // (V, D)
                   const float* __restrict__ bias,     // (V,)
                   const int32_t* __restrict__ labels, // (N,)
                   const float* __restrict__ lse,      // (N,)
                   const float* __restrict__ rowscale, // (N,)
                   bf16* __restrict__ dl,              // (N, V)
                   float* __restrict__ band_part,      // (ceil(N / 64), V)
                   float low, float conf_low, int n, int d, int vocab) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ float lse_s[kBM];
  __shared__ float rs_s[kBM];
  __shared__ int y_s[kBM];
  const int row0 = blockIdx.x * kBM;
  if (threadIdx.x < kBM) {
    const int row = row0 + threadIdx.x;
    const bool live = row < n;
    lse_s[threadIdx.x] = live ? lse[row] : 0.f;
    rs_s[threadIdx.x] = live ? rowscale[row] : 0.f;
    y_s[threadIdx.x] = live ? labels[row] : -1;
  }
  __syncthreads();
  int t_begin, t_end;
  tile_run(vocab, t_begin, t_end);
  DlTile epi{dl, band_part + static_cast<size_t>(blockIdx.x) * vocab, bias, lse_s, rs_s, y_s,
             low, conf_low, n, vocab, row0};
  walk_tiles(hidden, weight, n, d, vocab, row0, t_begin, t_end, smem_raw, epi);
}

// dbias[v] = sum of the row bands' partials, in band order.
__global__ void flash_ce_band_sum_kernel(const float* __restrict__ band_part,
                                         float* __restrict__ dbias, int bands, int vocab) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= vocab) return;
  float acc = 0.f;
  for (int b = 0; b < bands; ++b) acc += band_part[static_cast<size_t>(b) * vocab + v];
  dbias[v] = acc;
}

int check_args(int n, int d, int vocab, int runs) {
  const int ntiles = (vocab + kBN - 1) / kBN;
  if (n < 1 || vocab < 1 || d < kBK || d % kBK != 0 || runs < 1 || runs > ntiles ||
      (n + kBM - 1) / kBM > 65535 || runs > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <bool kSave>
int launch_fwd(void* hidden, void* weight, void* bias, void* part_m, void* part_s, void* part_z,
               void* lse, void* zsum, void* lg, void* tail, int n, int d, int vocab, int v_main,
               int runs, void* stream) {
  if (int bad = check_args(n, d, vocab, runs)) return bad;
  if (kSave && (v_main < 0 || v_main > vocab || v_main % 128 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(flash_ce_fwd_kernel<kSave>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kBM - 1) / kBM, runs);
  flash_ce_fwd_kernel<kSave><<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const bf16*>(hidden), static_cast<const bf16*>(weight),
      static_cast<const float*>(bias), static_cast<float*>(part_m), static_cast<float*>(part_s),
      static_cast<float*>(part_z), static_cast<bf16*>(lg), static_cast<float*>(tail), n, d, vocab,
      v_main);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_ce_fwd_merge_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_s),
      static_cast<const float*>(part_z), static_cast<float*>(lse), static_cast<float*>(zsum), n,
      runs);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The backward contractions: grad-W and grad-h.
//
// mic_tpu keeps the whole (VC, D) demb block, or the (RB, D) dh block,
// resident in VMEM across its sweep, so each is written once.  A block here
// owns 32 output rows over the full D instead: 32 vocab rows of demb
// (grad-W), or 32 hidden rows of dh (grad-h), with the 32 x D f32 sums in
// the registers of its 8 warps (warp w holds the 16-wide column fragments
// w, w + 8, ...; at D = 1024 that is 128 floats a thread).  The block sweeps
// the other operand in tiles of 32 rows (hidden rows for grad-W, vocab rows
// for grad-h), each tile X (32 x D bf16) loaded once through a two-stage
// cp.async ring, and per tile:
//
//   1. the 32 x 32 logits tile: recomputed as own (32 x D, resident) @ X^T,
//      the depth split in two halves over the warps and the halves added in
//      a fixed order, plus the bias (split); or the saved bf16 logits of
//      the tile, staged beside X (save);
//   2. dl = (exp(s - lse) - target) * rowscale in f32, zero outside the
//      vocab and past row N, and its bf16 copy; grad-W sums each vocab row's
//      f32 dl into its dbias;
//   3. acc += dl (own x swept) @ X (32 x D), bf16 WMMA with f32 sums.
//
// Splitting D over blocks instead would recompute the logits once per
// slice; keeping full D costs one block an SM (205 KB of shared memory at
// D = 1024 for the split route: own, two X stages, the halves, the dl
// tile and the output staging; 141 KB for save).  Every sum has one order
// and there are no atomics: reruns are bit-equal.  The bound is the tensor
// cores: 2 x 2 N D V operations a split contraction, 2 N D v_main a save
// one; the design is set by the mma.sync fragment loads from shared memory
// (two for each product in step 1), far from it in this first version.

constexpr int kOB = 32;           // output rows per block
constexpr int kSB = 32;           // swept rows per tile
constexpr int kBThreads = 256;    // 8 warps
constexpr int kBWarps = kBThreads / 32;
constexpr int kColFrags = 8;      // 16-wide output column fragments per warp at most
constexpr int kMaxD = kBWarps * kColFrags * 16;  // 1024
constexpr int kLdT = kSB + 8;     // bf16 pitch of the dl and saved-logits tiles
constexpr int kLdP = kSB + 4;     // f32 pitch of the recomputed halves
constexpr int kLdO = 16 + 4;      // f32 pitch of a warp's output staging fragment
constexpr int kGradW = 0;
constexpr int kGradH = 1;

struct BwdArgs {
  const bf16* hidden;     // (N, D)
  const bf16* weight;     // (V, D)
  const float* bias;      // (V,), split only
  const bf16* logits;     // (N, v_main) saved logits, save only
  const int32_t* labels;  // (N,)
  const float* lse;       // (N,)
  const float* rowscale;  // (N,)
  float* out;             // grad-W: (vext, D) rows of demb; grad-h: (N, D)
  float* dbias;           // grad-W: (vext,)
  float low, conf_low;
  int n, d;
  int vext;               // vocab columns covered: V (split) or v_main (save)
};

size_t bwd_smem_bytes(int d, bool saved) {
  const size_t ldx = static_cast<size_t>(d) + 8;
  size_t bytes = 2 * kSB * ldx * sizeof(bf16)                  // X, two stages
                 + kOB * kLdT * sizeof(bf16)                   // the dl tile
                 + kBWarps * 16 * kLdO * sizeof(float);        // output staging
  if (saved) {
    bytes += 2 * kSB * kLdT * sizeof(bf16);                    // saved logits, two stages
  } else {
    bytes += kOB * ldx * sizeof(bf16) + 2 * kOB * kLdP * sizeof(float);  // own, halves
  }
  return bytes;
}

template <int kGrad, bool kSaved>
__global__ void __launch_bounds__(kBThreads, 1) flash_ce_bwd_kernel(const BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int d = a.d;
  const int ldx = d + 8;
  bf16* x_s = reinterpret_cast<bf16*>(smem_raw);        // [2][kSB][ldx]
  bf16* dl_s = x_s + 2 * kSB * ldx;                      // [kOB][kLdT]
  float* out_s = reinterpret_cast<float*>(dl_s + kOB * kLdT);  // [warps][16][kLdO]
  bf16* rest = reinterpret_cast<bf16*>(out_s + kBWarps * 16 * kLdO);
  bf16* lg_s = rest;                                     // save: [2][kSB][kLdT]
  bf16* own_s = rest;                                    // split: [kOB][ldx]
  float* half_s = reinterpret_cast<float*>(own_s + kOB * ldx);  // split: [2][kOB][kLdP]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int own0 = blockIdx.x * kOB;
  // grad-W owns vocab rows and sweeps hidden rows; grad-h the reverse
  const int own_end = kGrad == kGradW ? a.vext : a.n;
  const int sweep_end = kGrad == kGradW ? a.n : a.vext;
  const bf16* own_src = kGrad == kGradW ? a.weight : a.hidden;
  const bf16* x_src = kGrad == kGradW ? a.hidden : a.weight;
  const int ntiles = (sweep_end + kSB - 1) / kSB;
  const int vec = d / 8;  // 16-byte pieces of a row

  // rows past the operand's end re-read its last row; their dl is zero
  auto load_tile = [&](int t, int stage) {
    const int s0 = t * kSB;
    bf16* dst = x_s + stage * kSB * ldx;
    for (int i = tid; i < kSB * vec; i += kBThreads) {
      const int r = i / vec;
      const int c = (i % vec) * 8;
      const int row = min(s0 + r, sweep_end - 1);
      cp_async16(dst + r * ldx + c, x_src + static_cast<size_t>(row) * d + c);
    }
    if constexpr (kSaved) {
      // the (hidden rows x vocab columns) block of the saved logits
      if (tid < kSB * (kSB / 8)) {
        const int r = tid / (kSB / 8);
        const int c = (tid % (kSB / 8)) * 8;
        const int row = min((kGrad == kGradW ? s0 : own0) + r, a.n - 1);
        const int col = (kGrad == kGradW ? own0 : s0) + c;
        cp_async16(lg_s + stage * kSB * kLdT + r * kLdT + c,
                   a.logits + static_cast<size_t>(row) * a.vext + col);
      }
    }
  };

  if constexpr (!kSaved) {
    for (int i = tid; i < kOB * vec; i += kBThreads) {
      const int r = i / vec;
      const int c = (i % vec) * 8;
      const int row = min(own0 + r, own_end - 1);
      cp_async16(own_s + r * ldx + c, own_src + static_cast<size_t>(row) * d + c);
    }
  }
  load_tile(0, 0);
  cp_async_commit();

  const int nf = d / 16;
  fragment<accumulator, 16, 16, 16, float> acc[2][kColFrags];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kColFrags; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.f);

  // step 2's elements: thread -> own row eo, swept rows es .. es + 3
  const int eo = tid >> 3;
  const int es = (tid & 7) * 4;
  float dbias_acc = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    // the other stage was last read in the previous tile's step 3
    if (t + 1 < ntiles) load_tile(t + 1, (t + 1) & 1);
    cp_async_commit();
    const bf16* xt = x_s + (t & 1) * kSB * ldx;
    const int s0 = t * kSB;

    if constexpr (!kSaved) {
      // step 1: warp w computes fragment (w & 1, (w >> 1) & 1) over depth half w >> 2
      const int fi = warp & 1;
      const int fj = (warp >> 1) & 1;
      const int half = warp >> 2;
      fragment<accumulator, 16, 16, 16, float> c;
      nvcuda::wmma::fill_fragment(c, 0.f);
      const int k_end = (half + 1) * (d / 2);
      for (int k = half * (d / 2); k < k_end; k += 16) {
        fragment<matrix_a, 16, 16, 16, bf16, row_major> fa;
        fragment<matrix_b, 16, 16, 16, bf16, col_major> fb;
        nvcuda::wmma::load_matrix_sync(fa, own_s + 16 * fi * ldx + k, ldx);
        nvcuda::wmma::load_matrix_sync(fb, xt + 16 * fj * ldx + k, ldx);
        nvcuda::wmma::mma_sync(c, fa, fb, c);
      }
      nvcuda::wmma::store_matrix_sync(half_s + (half * kOB + 16 * fi) * kLdP + 16 * fj, c, kLdP,
                                      mem_row_major);
      __syncthreads();
    }

    // step 2
    {
      const bf16* lt = lg_s + (t & 1) * kSB * kLdT;
      float part = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int sw = es + q;
        const int row = kGrad == kGradW ? s0 + sw : own0 + eo;
        const int col = kGrad == kGradW ? own0 + eo : s0 + sw;
        float g = 0.f;
        if (row < a.n && col < a.vext) {
          float logit;
          if constexpr (kSaved) {
            logit = __bfloat162float(kGrad == kGradW ? lt[sw * kLdT + eo] : lt[eo * kLdT + sw]);
          } else {
            logit = half_s[eo * kLdP + sw] + half_s[(kOB + eo) * kLdP + sw] + a.bias[col];
          }
          const float p = expf(logit - a.lse[row]);
          const float target = a.low + a.conf_low * (col == a.labels[row] ? 1.f : 0.f);
          g = (p - target) * a.rowscale[row];
        }
        part += g;
        dl_s[eo * kLdT + sw] = __float2bfloat16(g);
      }
      if constexpr (kGrad == kGradW) {
        // the eight threads of one vocab row are neighbouring lanes
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        part += __shfl_xor_sync(0xffffffffu, part, 4);
        dbias_acc += part;
      }
    }
    __syncthreads();

    // step 3
#pragma unroll
    for (int k16 = 0; k16 < kSB; k16 += 16) {
      fragment<matrix_a, 16, 16, 16, bf16, row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        nvcuda::wmma::load_matrix_sync(fa[i], dl_s + 16 * i * kLdT + k16, kLdT);
#pragma unroll
      for (int j = 0; j < kColFrags; ++j) {
        const int f = warp + kBWarps * j;
        if (f < nf) {
          fragment<matrix_b, 16, 16, 16, bf16, row_major> fb;
          nvcuda::wmma::load_matrix_sync(fb, xt + k16 * ldx + 16 * f, ldx);
          nvcuda::wmma::mma_sync(acc[0][j], fa[0], fb, acc[0][j]);
          nvcuda::wmma::mma_sync(acc[1][j], fa[1], fb, acc[1][j]);
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);

  // each warp writes its fragments through its own 16 x 16 staging tile
  float* st = out_s + warp * 16 * kLdO;
  const int sr = lane >> 1;
  const int sc = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < kColFrags; ++j) {
      const int f = warp + kBWarps * j;
      if (f < nf) {
        nvcuda::wmma::store_matrix_sync(st, acc[i][j], kLdO, mem_row_major);
        __syncwarp();
        const int row = own0 + 16 * i + sr;
        if (row < own_end) {
          float4* dst = reinterpret_cast<float4*>(a.out + static_cast<size_t>(row) * d + 16 * f + sc);
          dst[0] = *reinterpret_cast<const float4*>(st + sr * kLdO + sc);
          dst[1] = *reinterpret_cast<const float4*>(st + sr * kLdO + sc + 4);
        }
        __syncwarp();
      }
    }
  }
  if constexpr (kGrad == kGradW) {
    if ((tid & 7) == 0 && own0 + eo < own_end) a.dbias[own0 + eo] = dbias_acc;
  }
}

template <int kGrad, bool kSaved>
int launch_bwd(const BwdArgs& a, void* stream) {
  const size_t smem = bwd_smem_bytes(a.d, kSaved);
  if (a.n < 1 || a.vext < 1 || a.d < 64 || a.d % 64 != 0 || a.d > kMaxD || smem > 232448 ||
      (kSaved && a.vext % kSB != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(flash_ce_bwd_kernel<kGrad, kSaved>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int own_end = kGrad == kGradW ? a.vext : a.n;
  flash_ce_bwd_kernel<kGrad, kSaved><<<(own_end + kOB - 1) / kOB, kBThreads, smem,
                                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

BwdArgs bwd_args(void* hidden, void* weight, void* bias, void* logits, void* labels, void* lse,
                 void* rowscale, void* out, void* dbias, float low, float conf_low, int n, int d,
                 int vext) {
  return BwdArgs{static_cast<const bf16*>(hidden), static_cast<const bf16*>(weight),
                 static_cast<const float*>(bias), static_cast<const bf16*>(logits),
                 static_cast<const int32_t*>(labels), static_cast<const float*>(lse),
                 static_cast<const float*>(rowscale), static_cast<float*>(out),
                 static_cast<float*>(dbias), low, conf_low, n, d, vext};
}

}  // namespace

// runs consecutive vocab-tile runs per row tile; part_* are (runs, N) scratch.
extern "C" int mic_flash_ce_fwd_bf16(void* hidden, void* weight, void* bias, void* part_m,
                                     void* part_s, void* part_z, void* lse, void* zsum, int n,
                                     int d, int vocab, int runs, void* stream) {
  return launch_fwd<false>(hidden, weight, bias, part_m, part_s, part_z, lse, zsum, nullptr,
                           nullptr, n, d, vocab, 0, runs, stream);
}

// The same, also storing the logits: columns < v_main (a multiple of 128)
// as bf16 into logits_main (N, v_main), the rest as f32 into tail.
extern "C" int mic_flash_ce_fwd_save_bf16(void* hidden, void* weight, void* bias, void* part_m,
                                          void* part_s, void* part_z, void* lse, void* zsum,
                                          void* logits_main, void* tail, int n, int d,
                                          int vocab, int v_main, int runs, void* stream) {
  return launch_fwd<true>(hidden, weight, bias, part_m, part_s, part_z, lse, zsum, logits_main,
                          tail, n, d, vocab, v_main, runs, stream);
}

// grad-W: demb rows [0, vext) and dbias [0, vext).  saved == 0: the logits
// recomputed over V = vext columns (bias read, logits unused); saved != 0:
// read from logits (N, vext) (bias unused), vext a multiple of 32.
extern "C" int mic_flash_ce_gw_bf16(void* hidden, void* weight, void* bias, void* logits,
                                    void* labels, void* lse, void* rowscale, void* demb,
                                    void* dbias, float low, float conf_low, int n, int d,
                                    int vext, int saved, void* stream) {
  const BwdArgs a = bwd_args(hidden, weight, bias, logits, labels, lse, rowscale, demb, dbias, low,
                             conf_low, n, d, vext);
  return saved ? launch_bwd<kGradW, true>(a, stream) : launch_bwd<kGradW, false>(a, stream);
}

// grad-h: dh (N, D) f32 over the vocab columns [0, vext), as grad-W.
extern "C" int mic_flash_ce_gh_bf16(void* hidden, void* weight, void* bias, void* logits,
                                    void* labels, void* lse, void* rowscale, void* dh, float low,
                                    float conf_low, int n, int d, int vext, int saved,
                                    void* stream) {
  const BwdArgs a = bwd_args(hidden, weight, bias, logits, labels, lse, rowscale, dh, nullptr, low,
                             conf_low, n, d, vext);
  return saved ? launch_bwd<kGradH, true>(a, stream) : launch_bwd<kGradH, false>(a, stream);
}

// band_part is (ceil(N / 64), V) f32 scratch; every live entry is written.
extern "C" int mic_flash_ce_dl_bf16(void* hidden, void* weight, void* bias, void* labels,
                                    void* lse, void* rowscale, void* dl, void* band_part,
                                    void* dbias, float low, float conf_low, int n, int d,
                                    int vocab, int runs, void* stream) {
  if (int bad = check_args(n, d, vocab, runs)) return bad;
  cudaError_t err = cudaFuncSetAttribute(flash_ce_dl_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bands = (n + kBM - 1) / kBM;
  const dim3 grid(bands, runs);
  flash_ce_dl_kernel<<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const bf16*>(hidden), static_cast<const bf16*>(weight),
      static_cast<const float*>(bias), static_cast<const int32_t*>(labels),
      static_cast<const float*>(lse), static_cast<const float*>(rowscale),
      static_cast<bf16*>(dl), static_cast<float*>(band_part), low, conf_low, n, d, vocab);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_ce_band_sum_kernel<<<(vocab + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(band_part), static_cast<float*>(dbias), bands, vocab);
  return static_cast<int>(cudaGetLastError());
}
