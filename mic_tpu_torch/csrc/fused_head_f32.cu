// The float32 bucket select of the tied head: row 4 for a float32 model.
//
// Replaces mic_tpu/ops/fused_head.py::fused_head_topk's bucket kernels
// (_kernel_bucket_acc / _kernel_bucket) where the hidden rows and the table
// are float32 (CaptionerConfig.dtype "float32": mic_tpu casts the table to
// hidden.dtype and runs the same kernel).  The bf16 kernel of
// csrc/fused_head.cu is wgmma on bf16 operands and cannot take float32;
// this one computes the logits s = hidden @ weight^T + bias in full float32
// on the CUDA cores (csrc/fma_tile.cuh, no TF32) and never stores them.
//
// The vocab is cut into chunks of `buckets` columns (the bucket_bv width);
// bucket column j of a hidden row keeps, over the chunks in order,
//
//   rmax[j], rid[j] <- s, id   where s > rmax[j]   (strict: earliest chunk wins)
//
// over the columns id = c * buckets + j < V, and each row keeps an online
// logsumexp (running max, sum of exps against it) over every column the
// block sees.  The caller merges the runs' planes and the row partials in
// a fixed order and finishes the row lse and the top-k of the bucket
// winners (ops/fused_head.py::bucket_finish_f32); the plain version's dense
// logsumexp and bucket select give the same values to f32 rounding.
//
// A block owns 128 hidden rows (64 where there are no more than 64) x 64
// bucket columns (a column group's columns at or past `buckets` read the
// next chunk's rows and are left out) and walks a run of consecutive
// chunks; each thread keeps the (rmax, rid) of its 8 x 4 cells in
// registers for the whole walk (4 x 4 at 64 rows) and the rows' lse state
// lives in shared memory, so that two blocks fit an SM at 128 registers
// (the 128-row tile took the flagship launch from 20.0 to 17.7 ms against
// the 64 x 64 one, an H100; tools/torch_f32_variants.py).
// Where the blocks leave the card's SMs idle (a few rows) the walk is cut
// into `splits` consecutive runs (grid z), each writing its own planes.
//
// Bound at the flagship decode shape (N = 1024 rows, D = 1024, V = 250054):
// 2 N D V = 0.52 TFLOP at the f32 FMA rate, 7.8 ms; the 1 GB table read
// once would take 0.31 ms.  Each block re-reads its chunks' table rows from
// L2 (the row tiles of a column group walk the same chunks together).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fma_tile.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // NEG_INF of mic_tpu/ops/topk_lse.py

// TM = 8: 128 hidden rows a block (slices 16 deep); TM = 4: 64 rows, for a
// few rows (slices 32 deep).  Both: 64 bucket columns, 4 a thread.
template <int TM>
using BucketTile = fma_tile::Tile<TM, 4, TM == 8 ? 16 : 32>;

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

template <int TM>
__global__ void __launch_bounds__(256, 2)
bucket_f32_kernel(const float* __restrict__ hidden,  // (N, D)
                  const float* __restrict__ weight,  // (V, D)
                  const float* __restrict__ bias,    // (V,)
                  float* __restrict__ rmax_out,      // (splits, N, buckets)
                  int32_t* __restrict__ rid_out,
                  float* __restrict__ part_m,        // (splits, groups, N)
                  float* __restrict__ part_l, int n, int d, int vocab, int buckets) {
  using Tile = BucketTile<TM>;
  __shared__ __align__(16) float smem[Tile::kFloats];
  // each block row's running max and sum of exps over the block's columns;
  // only the row's tx == 0 thread reads or writes them after the first barrier
  __shared__ float row_m[Tile::kRows], row_l[Tile::kRows];
  const int row0 = blockIdx.x * Tile::kRows;
  const int j0 = blockIdx.y * Tile::kCols;
  const int nchunks = (vocab + buckets - 1) / buckets;
  const int c_begin = static_cast<int>(static_cast<int64_t>(blockIdx.z) * nchunks / gridDim.z);
  const int c_end = static_cast<int>(static_cast<int64_t>(blockIdx.z + 1) * nchunks / gridDim.z);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  if (tid < Tile::kRows) {
    row_m[tid] = kNegInf;
    row_l[tid] = 0.f;
  }

  float rmax[TM][4];
  int rid[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      rmax[i][j] = kNegInf;
      rid[i][j] = j0 + Tile::col(tx, j);  // the first chunk's id, as the dense select's
    }
  }
  float acc[TM][4];
  for (int c = c_begin; c < c_end; ++c) {
    const int col0 = c * buckets + j0;
    fma_tile::product<Tile>(acc, hidden, n, row0, weight, vocab, col0, d, smem);
    bool ok[4];
    float b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int bj = j0 + Tile::col(tx, j);
      const int id = c * buckets + bj;
      ok[j] = bj < buckets && id < vocab;
      b[j] = ok[j] ? bias[id] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float s = acc[i][j] + b[j];
        acc[i][j] = s;
        if (ok[j] && s > rmax[i][j]) {  // strict: the earliest chunk keeps a tie
          rmax[i][j] = s;
          rid[i][j] = c * buckets + j0 + Tile::col(tx, j);
        }
        tmax = ok[j] ? fmaxf(tmax, s) : tmax;
      }
      tmax = row_max(tmax);
      float es = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) es += ok[j] ? expf(acc[i][j] - tmax) : 0.f;
      es = row_sum(es);
      if (tx == 0 && tmax > -INFINITY) {
        const int r = Tile::row(ty, i);
        const float m = row_m[r];
        const float mnew = fmaxf(m, tmax);
        row_l[r] = row_l[r] * expf(m - mnew) + es * expf(tmax - mnew);
        row_m[r] = mnew;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + Tile::row(ty, i);
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int bj = j0 + Tile::col(tx, j);
      if (bj >= buckets) continue;
      const size_t o = (static_cast<size_t>(blockIdx.z) * n + row) * buckets + bj;
      rmax_out[o] = rmax[i][j];
      rid_out[o] = rid[i][j];
    }
  }
  __syncthreads();
  if (tid < Tile::kRows && row0 + tid < n) {
    const size_t o = (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) * n + row0 + tid;
    part_m[o] = row_m[tid];
    part_l[o] = row_l[tid];
  }
}

template <int TM>
int launch(const float* hidden, const float* weight, const float* bias, float* rmax_out,
           int32_t* rid_out, float* part_m, float* part_l, int n, int d, int vocab, int buckets,
           int splits, cudaStream_t stream) {
  using Tile = BucketTile<TM>;
  const dim3 grid((n + Tile::kRows - 1) / Tile::kRows, (buckets + Tile::kCols - 1) / Tile::kCols,
                  splits);
  bucket_f32_kernel<TM><<<grid, 256, 0, stream>>>(hidden, weight, bias, rmax_out, rid_out,
                                                  part_m, part_l, n, d, vocab, buckets);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hidden (N, D), weight (V, D) and bias (V,) float32, D a multiple of 4;
// rows (64 or 128) hidden rows a block; the planes are (splits, N, buckets),
// each run's own, the row partials (splits, ceil(buckets / 64), N).
extern "C" int mic_fused_head_bucket_f32(void* hidden, void* weight, void* bias, void* rmax_out,
                                         void* rid_out, void* part_m, void* part_l, int n, int d,
                                         int vocab, int buckets, int splits, int rows,
                                         void* stream) {
  const int nchunks = (vocab + buckets - 1) / buckets;
  if (n < 1 || d < 4 || d % 4 || vocab < 1 || buckets < 1 || splits < 1 || splits > nchunks ||
      splits > 65535 || (rows != 64 && rows != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto args = [&](auto launcher) {
    return launcher(static_cast<const float*>(hidden), static_cast<const float*>(weight),
                    static_cast<const float*>(bias), static_cast<float*>(rmax_out),
                    static_cast<int32_t*>(rid_out), static_cast<float*>(part_m),
                    static_cast<float*>(part_l), n, d, vocab, buckets, splits,
                    static_cast<cudaStream_t>(stream));
  };
  return rows == 128 ? args(launch<8>) : args(launch<4>);
}
