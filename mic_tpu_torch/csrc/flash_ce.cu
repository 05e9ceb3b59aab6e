// Flash cross-entropy over the tied LM head (training): forward statistics
// and the dl backward, each a GEMM whose logits never reach device memory
// as f32.
//
// Replaces mic_tpu/ops/flash_ce.py::flash_ce_forward (_ce_fwd_kernel via
// _lse_main) and ::flash_ce_backward_dl (_ce_dl_kernel).  Per row of
// s = hidden @ weight^T + bias over the whole vocab:
//
//   forward:  lse = log sum exp(s), zsum = sum(s)  (online max + rescaled sum)
//   dl:       dl = (exp(s - lse) - target) * rowscale as bf16 (N, V), with
//             target = low + (conf - low) * onehot(label), plus exact f32
//             per-band dbias partials folded in band order.
//
// Columns >= V never enter a sum and are never written.  The label logit and
// the dh / demb GEMMs over dl stay outside, as mic_tpu computes them outside
// its kernels.
//
// Bound: at the flagship training step (N = 4096 rows, D = 1024,
// V = 250054) each kernel is a 2.1 TFLOP GEMM, far above the card's bf16
// ridge point, so the tensor cores should bound it; the dl kernel also
// writes 2 GB of bf16 dl.  Design (the simple first version): a block owns
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
// consecutive bytes); no padded row pitch is needed.

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

__global__ void __launch_bounds__(kThreads)
flash_ce_fwd_kernel(const bf16* __restrict__ hidden,  // (N, D)
                    const bf16* __restrict__ weight,  // (V, D)
                    const float* __restrict__ bias,   // (V,)
                    float* __restrict__ part_m,       // (runs, N)
                    float* __restrict__ part_s,       // (runs, N)
                    float* __restrict__ part_z,       // (runs, N)
                    int n, int d, int vocab) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int row0 = blockIdx.x * kBM;
  int t_begin, t_end;
  tile_run(vocab, t_begin, t_end);
  RowStats st;
  st.bias = bias;
  st.vocab = vocab;
  st.r = threadIdx.x >> 1;
  st.half = threadIdx.x & 1;
  walk_tiles(hidden, weight, n, d, vocab, row0, t_begin, t_end, smem_raw, st);

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

}  // namespace

// runs consecutive vocab-tile runs per row tile; part_* are (runs, N) scratch.
extern "C" int mic_flash_ce_fwd_bf16(void* hidden, void* weight, void* bias, void* part_m,
                                     void* part_s, void* part_z, void* lse, void* zsum, int n,
                                     int d, int vocab, int runs, void* stream) {
  if (int bad = check_args(n, d, vocab, runs)) return bad;
  cudaError_t err = cudaFuncSetAttribute(flash_ce_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kBM - 1) / kBM, runs);
  flash_ce_fwd_kernel<<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const bf16*>(hidden), static_cast<const bf16*>(weight),
      static_cast<const float*>(bias), static_cast<float*>(part_m), static_cast<float*>(part_s),
      static_cast<float*>(part_z), n, d, vocab);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_ce_fwd_merge_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_s),
      static_cast<const float*>(part_z), static_cast<float*>(lse), static_cast<float*>(zsum), n,
      runs);
  return static_cast<int>(cudaGetLastError());
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
