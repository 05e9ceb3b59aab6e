// Per-row top-k and logsumexp of a logits matrix in one read.
//
// Replaces mic_tpu/ops/topk_lse.py::topk_log_probs (its _kernel Pallas
// kernel, MIC_TPU_EXPERIMENTAL=pallas_topk): for each row of (N, V) logits,
// bf16 or f32, the k largest f32-cast values (ties to the lower id) and the
// row logsumexp, returned as log-probs value - lse with their int32 ids.
//
// Bound: bytes.  The logits are read once, N * V elements (512 MB of bf16 at
// N = 1024, V = 250054: 0.153 ms at 3.35 TB/s), with a compare, an exp and
// an add each.  The TPU kernel carried its running (max, sum) and top-k in
// VMEM scratch across a sequential grid over vocab blocks, with a k-step
// select-and-mask per block; on this card blocks run in no order, so the
// walk is cut into runs and merged.  Design (the run-and-merge pattern of
// csrc/fused_head.cu's select): a block owns kRows rows, one warp a row,
// and one run of consecutive vocab columns; the launcher cuts each row into
// as many runs as fill one wave of resident blocks (a second, partial wave
// would double the time).  Lane l reads columns l, l+32, ... of the run
// (each warp load is 32 neighbouring elements, kLoads of them in flight)
// and keeps an online (max, rescaled sum), rescaled once per kLoads
// columns.  The warp keeps one top-k list, entry j in lane j: a column
// enters only if it ranks before the k-th entry, which one ballot finds for
// the warp's 32 x kLoads columns at once, so the common column costs a
// compare, and an insert is a few shuffles.  (A list per lane, the first
// design, paid a 16-step insert whenever any lane of the warp improved its
// own list.)  A second launch, a warp a row, folds the runs' (max, sum) and
// offers their lists to the same warp list.  Every comparison is the total
// order (value descending, then lower id): no atomics, and the result
// depends on neither block scheduling nor the order of inserts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;   // rows (warps) a block
constexpr int kMaxK = 16;
constexpr int kLoads = 8;  // column loads a lane has in flight
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }

// (v, id) ranks before (tv, ti): higher value, or the same value and lower id
__device__ __forceinline__ bool ranks_before(float v, int id, float tv, int ti) {
  return v > tv || (v == tv && id < ti);
}

// The warp's top-k list: lane j < k holds the j-th best (lv, li) so far and
// every lane holds the k-th, (thr_v, thr_i).  Each lane offers (v, id) when
// valid; the candidates that rank before the k-th entry go in one at a time.
// The list is in rank order, so "the new entry ranks before entry j" is
// false up to its place p and true from p on: lane p takes the new entry,
// the lanes after it their left neighbour's, and the old k-th drops out.
__device__ __forceinline__ void warp_list_offer(float& lv, int& li, float& thr_v, int& thr_i,
                                                float v, int id, bool valid, int lane, int k) {
  bool pending = valid && ranks_before(v, id, thr_v, thr_i);
  unsigned ballot = __ballot_sync(kFull, pending);
  while (ballot) {
    const int src = __ffs(ballot) - 1;
    const float nv = __shfl_sync(kFull, v, src);
    const int ni = __shfl_sync(kFull, id, src);
    const bool after = lane < k && ranks_before(nv, ni, lv, li);
    const float left_v = __shfl_up_sync(kFull, lv, 1);
    const int left_i = __shfl_up_sync(kFull, li, 1);
    const bool left_after = __shfl_up_sync(kFull, static_cast<int>(after), 1) && lane > 0;
    if (after) {
      lv = left_after ? left_v : nv;
      li = left_after ? left_i : ni;
    }
    thr_v = __shfl_sync(kFull, lv, k - 1);
    thr_i = __shfl_sync(kFull, li, k - 1);
    pending = pending && lane != src && ranks_before(v, id, thr_v, thr_i);
    ballot = __ballot_sync(kFull, pending);
  }
}

// Fold (om, ol) into the online pair (m, l): l is a sum of exp(x - m).
__device__ __forceinline__ void lse_fold(float& m, float& l, float om, float ol) {
  const float mm = fmaxf(m, om);
  float s = 0.f;
  if (m > -INFINITY) s += l * expf(m - mm);
  if (om > -INFINITY) s += ol * expf(om - mm);
  m = mm;
  l = s;
}

// The warp's 32 (max, sum) pairs into every lane.
__device__ __forceinline__ void warp_lse_fold(float& m, float& l) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float om = __shfl_xor_sync(kFull, m, o);
    const float ol = __shfl_xor_sync(kFull, l, o);
    lse_fold(m, l, om, ol);
  }
}

template <typename T>
__global__ void __launch_bounds__(kRows * 32)
topk_lse_kernel(const T* __restrict__ logits,    // (N, V)
                float* __restrict__ part_m,      // (runs, N)
                float* __restrict__ part_l,      // (runs, N)
                float* __restrict__ part_v,      // (runs, N, k)
                int32_t* __restrict__ part_i,    // (runs, N, k)
                int n, int vocab, int k, int run_cols) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRows + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp: one warp a row
  const int c0 = blockIdx.y * run_cols;
  const int c1 = min(vocab, c0 + run_cols);
  const T* x = logits + static_cast<size_t>(row) * vocab;

  float m = -INFINITY, l = 0.f;
  float lv = -INFINITY, thr_v = -INFINITY;
  int li = INT32_MAX, thr_i = INT32_MAX;
  for (int c = c0; c < c1; c += 32 * kLoads) {  // warp-uniform: the ballots below
    float v[kLoads];
    float top = -INFINITY;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int cu = c + 32 * u + lane;
      v[u] = cu < c1 ? to_float(x[cu]) : -INFINITY;
      top = fmaxf(top, v[u]);
    }
    // one rescale for the lane's kLoads columns; exp(-inf) adds 0
    const float mn = fmaxf(m, top);
    if (mn > -INFINITY) {
      float sum = l * expf(m - mn);
#pragma unroll
      for (int u = 0; u < kLoads; ++u) sum += expf(v[u] - mn);
      l = sum;
      m = mn;
    }
    // one ballot for the warp's 32 x kLoads columns; most have no candidate
    bool any = false;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int cu = c + 32 * u + lane;
      any |= cu < c1 && ranks_before(v[u], cu, thr_v, thr_i);
    }
    if (__ballot_sync(kFull, any)) {
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int cu = c + 32 * u + lane;
        warp_list_offer(lv, li, thr_v, thr_i, v[u], cu, cu < c1, lane, k);
      }
    }
  }
  warp_lse_fold(m, l);
  const size_t o = static_cast<size_t>(blockIdx.y) * n + row;
  if (lane == 0) {
    part_m[o] = m;
    part_l[o] = l;
  }
  if (lane < k) {
    part_v[o * k + lane] = lv;
    part_i[o * k + lane] = li;
  }
}

// A warp a row: the runs' (max, sum) into lse = log(sum) + max, their lists
// offered to one warp list; lp = value - lse.
__global__ void __launch_bounds__(kRows * 32)
topk_lse_merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                      const float* __restrict__ part_v, const int32_t* __restrict__ part_i,
                      float* __restrict__ lp, int32_t* __restrict__ ids, int n, int k,
                      int runs) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRows + (threadIdx.x >> 5);
  if (row >= n) return;
  float m = -INFINITY, l = 0.f;
  for (int z = lane; z < runs; z += 32) {
    const size_t o = static_cast<size_t>(z) * n + row;
    lse_fold(m, l, part_m[o], part_l[o]);
  }
  warp_lse_fold(m, l);
  const float lse = logf(l) + m;
  float lv = -INFINITY, thr_v = -INFINITY;
  int li = INT32_MAX, thr_i = INT32_MAX;
  const int total = runs * k;
  for (int t0 = 0; t0 < total; t0 += 32) {  // warp-uniform
    const int t = t0 + lane;
    const bool valid = t < total;
    float v = 0.f;
    int id = 0;
    if (valid) {
      const size_t o = (static_cast<size_t>(t / k) * n + row) * k + t % k;
      v = part_v[o];
      id = part_i[o];
    }
    warp_list_offer(lv, li, thr_v, thr_i, v, id, valid, lane, k);
  }
  if (lane < k) {
    lp[static_cast<size_t>(row) * k + lane] = lv - lse;
    ids[static_cast<size_t>(row) * k + lane] = li;
  }
}

constexpr int kMaxDevices = 64;

// Resident blocks of topk_lse_kernel<T> in one wave on the current device,
// queried once a device: the launch runs once a decode step.
template <typename T>
cudaError_t wave_blocks(int* wave) {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= kMaxDevices) {
    return err != cudaSuccess ? err : cudaErrorInvalidDevice;
  }
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, topk_lse_kernel<T>,
                                                          kRows * 32, 0);
    }
    if (err != cudaSuccess) return err;
    cached[dev] = max(1, sms * per_sm);
  }
  *wave = cached[dev];
  return cudaSuccess;
}

// part_* hold max_runs partials a row; the launch uses as many as fill a wave
template <typename T>
int launch(const void* logits, void* part_m, void* part_l, void* part_v, void* part_i, void* lp,
           void* ids, int n, int vocab, int k, int max_runs, void* stream) {
  if (n < 1 || vocab < 1 || k < 1 || k > kMaxK || k > vocab || max_runs < 1 ||
      max_runs > vocab) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int wave = 0;
  cudaError_t err = wave_blocks<T>(&wave);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_blocks = (n + kRows - 1) / kRows;
  const int runs = max(1, min(max_runs, wave / row_blocks));
  const int run_cols = (vocab + runs - 1) / runs;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  topk_lse_kernel<T><<<dim3(row_blocks, runs), kRows * 32, 0, s>>>(
      static_cast<const T*>(logits), static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<float*>(part_v), static_cast<int32_t*>(part_i), n, vocab, k, run_cols);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_lse_merge_kernel<<<row_blocks, kRows * 32, 0, s>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_v), static_cast<const int32_t*>(part_i),
      static_cast<float*>(lp), static_cast<int32_t*>(ids), n, k, runs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mic_topk_lse_bf16(void* logits, void* part_m, void* part_l, void* part_v,
                                 void* part_i, void* lp, void* ids, int n, int vocab, int k,
                                 int max_runs, void* stream) {
  return launch<__nv_bfloat16>(logits, part_m, part_l, part_v, part_i, lp, ids, n, vocab, k,
                               max_runs, stream);
}

extern "C" int mic_topk_lse_f32(void* logits, void* part_m, void* part_l, void* part_v,
                                void* part_i, void* lp, void* ids, int n, int vocab, int k,
                                int max_runs, void* stream) {
  return launch<float>(logits, part_m, part_l, part_v, part_i, lp, ids, n, vocab, k, max_runs,
                       stream);
}
