// The float32 flash-CE forward and dl kernels: rows 7 and 8 for a float32
// model.
//
// Replace mic_tpu/ops/flash_ce.py::flash_ce_forward (_ce_fwd_kernel via
// _lse_main) and ::flash_ce_backward_dl (_ce_dl_kernel) where h is float32
// (CaptionerConfig.dtype "float32": mic_tpu casts the table to h.dtype and
// runs the same kernels).  The bf16 walk of csrc/flash_ce.cu is wgmma on
// bf16 operands and cannot take float32; these compute the logits
// s = hidden @ weight^T + bias in full float32 on the CUDA cores
// (csrc/fma_tile.cuh: 128 x 128 tiles, 8 x 8 outputs a thread, no TF32) and
// never store them.  Per row over the whole vocab:
//
//   forward: lse = log sum exp(s), zsum = sum(s)  (online max + rescaled sum)
//   dl:      dl = (exp(s - lse) - target) * rowscale as float32 (N, V), with
//            target = low + (conf - low) * onehot(label), and the tile's
//            column sums over the block's 128 rows as the row band's dbias
//            partial, folded in band order by a second kernel.
//
// The walk is the bf16 kernels': a block owns 128 hidden rows and walks a
// run of consecutive 128-wide vocab tiles (grid (row tiles, runs), row tiles
// fastest, so the blocks of a run read the same table rows together); the
// forward's runs write (max, sum of exps, sum of logits) partials that
// csrc/ce_reduce.cuh's merge folds in run order.  Columns >= V (the ragged
// last tile) never enter a sum and are never written, nor are rows past N.
// The sums: a tile's row statistics over the row's 16 threads by xor
// shuffles, folded into the row's running (max, sum of exps, sum of logits)
// in shared memory by one of them; the band's column sums over a thread's
// rows, then over the warp's two row groups by a shuffle, then over the
// eight warps through shared memory in warp order.  The rows' state and
// terms (dl's -lse, rowscale, label) live in shared memory so that a thread
// holds its 64 sums and the product's operands in 128 registers: two
// blocks an SM, which took the forward from 79 to 54-56 ms and dl from 83
// to 56-60 ms at the flagship step (an H100; tools/torch_f32_variants.py).
// No atomics: reruns are bit-equal.  The label logit and the dh / demb products over dl stay
// outside, as mic_tpu computes them outside its kernels.
//
// Bound at the flagship training step (N = 4096, D = 1024, V = 250054):
// 2 N D V = 2.1 TFLOP at the f32 FMA rate, 31.3 ms each; dl also writes
// 4.1 GB of float32.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "ce_reduce.cuh"
#include "fma_tile.cuh"

namespace {

using Tile = fma_tile::Tile<8, 8, 8>;  // 128 hidden rows x 128 vocab columns
constexpr float kFloor = -1e30f;  // a row's running max before its first column

struct Args {
  const float* hidden;    // (N, D)
  const float* weight;    // (V, D)
  const float* bias;      // (V,)
  const float* lse;       // dl: (N,)
  const float* rowscale;  // dl: (N,)
  const int32_t* labels;  // dl: (N,)
  float* part_m;          // forward: (runs, N) partials
  float* part_s;
  float* part_z;
  float* dl;              // dl: (N, V)
  float* band;            // dl: (row tiles, V) dbias partials
  float low, conf_low;
  int n, d, vocab;
};

// 16-lane reductions over the threads of a row (the lanes with one ty): a
// butterfly, so every lane ends with the same value.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <bool kDl>
__global__ void __launch_bounds__(Tile::kThreads, 2) ce_f32_kernel(const Args a) {
  __shared__ __align__(16) float smem[Tile::kFloats];
  // per block row: the forward's running (max, sum of exps, sum of logits),
  // or dl's (-lse, rowscale, label); kept here, not in registers, so that a
  // thread holds its 64 sums and the product's operands in 128 registers
  // (two blocks an SM)
  __shared__ float row_a[Tile::kRows], row_b[Tile::kRows], row_c[Tile::kRows];
  __shared__ float sums[8][Tile::kCols];  // dl: the warps' column sums of a tile
  const int row0 = blockIdx.x * Tile::kRows;
  const int ntiles = (a.vocab + Tile::kCols - 1) / Tile::kCols;
  const int t_begin = static_cast<int>(static_cast<int64_t>(blockIdx.y) * ntiles / gridDim.y);
  const int t_end = static_cast<int>(static_cast<int64_t>(blockIdx.y + 1) * ntiles / gridDim.y);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  if (tid < Tile::kRows) {
    const int row = row0 + tid;
    const bool live = row < a.n;
    row_a[tid] = kDl ? (live ? -a.lse[row] : 0.f) : kFloor;
    row_b[tid] = kDl && live ? a.rowscale[row] : 0.f;  // 0: a dead row's dl is 0
    row_c[tid] = kDl ? __int_as_float(live ? a.labels[row] : -1) : 0.f;
  }
  // the first product's barrier orders these stores before their reads
  const float label_target = a.low + a.conf_low;

  float acc[8][8];
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int col0 = tile * Tile::kCols;
    fma_tile::product<Tile>(acc, a.hidden, a.n, row0, a.weight, a.vocab, col0, a.d, smem);
    bool ok[8];
    float b[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + Tile::col(tx, j);
      ok[j] = col < a.vocab;
      b[j] = ok[j] ? a.bias[col] : 0.f;
    }
    if constexpr (!kDl) {
      // each row's tile max, sum of exps against it and sum of logits over
      // the row's 16 threads, then folded into the row's running state by
      // its tx == 0 thread (the only one that reads or writes it)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) tmax = ok[j] ? fmaxf(tmax, acc[i][j] + b[j]) : tmax;
        tmax = row_max(tmax);
        float es = 0.f, zs = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float x = acc[i][j] + b[j];
          es += ok[j] ? expf(x - tmax) : 0.f;
          zs += ok[j] ? x : 0.f;
        }
        es = row_sum(es);
        zs = row_sum(zs);
        if (tx == 0) {
          const int r = Tile::row(ty, i);
          const float m = row_a[r];
          const float mnew = fmaxf(m, tmax);
          row_b[r] = row_b[r] * expf(m - mnew) + es * expf(tmax - mnew);
          row_a[r] = mnew;
          row_c[r] += zs;
        }
      }
    } else {
      float colsum[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) colsum[j] = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = Tile::row(ty, i);
        const float nl = row_a[r], rs = row_b[r];
        const int y = __float_as_int(row_c[r]);
        float* dl_row = a.dl + static_cast<size_t>(row0 + r) * a.vocab;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = col0 + Tile::col(tx, j);
          const float p = expf(acc[i][j] + b[j] + nl);
          const float g = (p - (col == y ? label_target : a.low)) * rs;
          if (ok[j] && row0 + r < a.n) dl_row[col] = g;
          colsum[j] += ok[j] ? g : 0.f;  // a dead row's g is 0 (rowscale 0)
        }
      }
      // the warp's two row groups (lanes l and l ^ 16)
#pragma unroll
      for (int j = 0; j < 8; ++j) colsum[j] += __shfl_xor_sync(0xffffffffu, colsum[j], 16);
      if (lane < 16) {
#pragma unroll
        for (int j = 0; j < 8; ++j) sums[warp][Tile::col(tx, j)] = colsum[j];
      }
      __syncthreads();
      if (tid < Tile::kCols && col0 + tid < a.vocab) {
        float band = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) band += sums[w][tid];
        a.band[static_cast<size_t>(blockIdx.x) * a.vocab + col0 + tid] = band;
      }
      // the next tile's product starts with a barrier before its stores here
    }
  }

  if constexpr (!kDl) {
    __syncthreads();
    if (tid < Tile::kRows && row0 + tid < a.n) {
      const size_t o = static_cast<size_t>(blockIdx.y) * a.n + row0 + tid;
      a.part_m[o] = row_a[tid];
      a.part_s[o] = row_b[tid];
      a.part_z[o] = row_c[tid];
    }
  }
}

template <bool kDl>
int launch(const Args& a, int runs, cudaStream_t stream) {
  const int ntiles = (a.vocab + Tile::kCols - 1) / Tile::kCols;
  if (a.n < 1 || a.vocab < 1 || a.d < 4 || a.d % 4 || runs < 1 || runs > ntiles ||
      runs > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((a.n + Tile::kRows - 1) / Tile::kRows, runs);
  ce_f32_kernel<kDl><<<grid, Tile::kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hidden (N, D), weight (V, D), bias (V,) float32, D a multiple of 4; runs
// consecutive vocab-tile runs per row tile; part_* are (runs, N) scratch.
extern "C" int mic_flash_ce_fwd_f32(void* hidden, void* weight, void* bias, void* part_m,
                                    void* part_s, void* part_z, void* lse, void* zsum, int n,
                                    int d, int vocab, int runs, void* stream) {
  Args a{};
  a.hidden = static_cast<const float*>(hidden);
  a.weight = static_cast<const float*>(weight);
  a.bias = static_cast<const float*>(bias);
  a.part_m = static_cast<float*>(part_m);
  a.part_s = static_cast<float*>(part_s);
  a.part_z = static_cast<float*>(part_z);
  a.n = n;
  a.d = d;
  a.vocab = vocab;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int bad = launch<false>(a, runs, s)) return bad;
  flash_ce_fwd_merge_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      a.part_m, a.part_s, a.part_z, static_cast<float*>(lse), static_cast<float*>(zsum), n, runs);
  return static_cast<int>(cudaGetLastError());
}

// dl (N, V) float32 and dbias (V,) through band_part, (ceil(N / 128), V)
// float32 scratch of which every live entry is written.
extern "C" int mic_flash_ce_dl_f32(void* hidden, void* weight, void* bias, void* labels,
                                   void* lse, void* rowscale, void* dl, void* band_part,
                                   void* dbias, float low, float conf_low, int n, int d,
                                   int vocab, int runs, void* stream) {
  Args a{};
  a.hidden = static_cast<const float*>(hidden);
  a.weight = static_cast<const float*>(weight);
  a.bias = static_cast<const float*>(bias);
  a.lse = static_cast<const float*>(lse);
  a.rowscale = static_cast<const float*>(rowscale);
  a.labels = static_cast<const int32_t*>(labels);
  a.dl = static_cast<float*>(dl);
  a.band = static_cast<float*>(band_part);
  a.low = low;
  a.conf_low = conf_low;
  a.n = n;
  a.d = d;
  a.vocab = vocab;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int bad = launch<true>(a, runs, s)) return bad;
  const int bands = (n + Tile::kRows - 1) / Tile::kRows;
  flash_ce_band_sum_kernel<<<(vocab + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(band_part), static_cast<float*>(dbias), bands, vocab);
  return static_cast<int>(cudaGetLastError());
}
