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
// select-and-mask per block; on this card blocks run in no order, so each
// row is cut into runs of consecutive columns, one warp a (row, run), and
// the runs are folded at the end.  The launcher cuts each row into as many
// runs as fill one wave of resident warps (a second, partial wave would
// double the time).
//
// The walk streams at the byte bound:
//   - each lane reads 16 bytes a load (8 bf16 or 4 f32), a warp 512
//     neighbouring bytes, kVecs loads a batch; the next batch's loads are
//     issued before the current batch is looked at, so a warp keeps two
//     batches (4 KB) in flight;
//   - rows of V = 250054 are not 16-byte aligned (a bf16 row's pitch is
//     500,108 bytes), so each run peels the columns before its first
//     16-byte boundary and after its last whole piece (fewer than 8 each,
//     one a lane in one extra step); the body compares nothing per element;
//   - the logsumexp is online in base 2: each lane keeps its max m, ml =
//     m log2(e) rounded to f32, and l = sum 2^(v log2(e) - ml), one FFMA and
//     one ex2.approx.ftz.f32 an element, l rescaled where a piece's max
//     exceeds m (a few times a run).  Error: ex2.approx is within 2 ulp (2^-22
//     relative; CUDA's exp2f, the same instruction, documents 2 ulp), and
//     the FFMA rounds its argument once, 2^-24 of |v log2(e) - ml|, a
//     relative error in a term that is largest for the terms that count
//     least; the rounding of ml is a shift common to one lane's terms,
//     undone exactly at the end (delta = fma(m, log2(e), -ml)); log2(e)'s
//     own rounding scales every logit by 1 + 2^-25, which moves the lse by
//     at most 2^-25 (lse - mean) (about 5e-7 for a flat row of 250054).
//     So the lse is within a few 1e-7 of the exact one at these sizes,
//     below the 1e-5 the checks hold lp to;
//   - the warp keeps one top-k list, entry j in lane j (k <= 32; past 32,
//     up to 40, each lane holds two slots: entry j in lane j % 32, slot
//     j / 32, List2 below).  A batch costs one
//     compare a piece (its max >= the k-th value) and one vote; only where a
//     piece holds a candidate are its values offered, with their ids, to
//     the list (out of line: the walk's loop stays small), which takes them
//     in the exact total order (value descending, then lower id), a few
//     shuffles an insert.  The compare is >=, not >: a value equal to the
//     k-th with a lower id ranks before it (the peeled tail, walked first,
//     can hold the k-th).  While the list fills, more than k lanes vote:
//     then the k-th largest of the lanes' maxima (a bitonic sort across the
//     lanes) cuts the values offered, since at least k values reach it;
//     past k = 32, the ceil(k / 2)-th largest of the lanes' second-largest
//     piece maxima, each lane below it holding two values that reach it.
// One launch: 8 warps a block, at most 128 registers (two blocks an SM).
// Measured as patched copies (tools/torch_topk_variants.py): 2 or 8 loads a
// batch, three blocks an SM, runs of at least 1024 or 2048 columns, and the
// runs folded by a second launch were no faster (within 4%); without the
// cut, 2-14% slower.
// The last run of a row to finish folds the runs' (max, sum) pairs and
// lists in run order: each warp writes its partials, fences, and counts
// itself in on the row's arrival counter; the one that brings it to
// `runs` folds the row and resets the counter to 0 for the next launch (a
// CUDA graph's replays too).  The fold's order is the runs' order, and
// every comparison is the total order, so the result depends on neither
// block scheduling nor the order of inserts: reruns are bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;  // warps a block, one (row, run) each
constexpr int kMaxK = 40;   // ROADMAP B45: 16 beams with an n-gram ban ask for 37
constexpr int kVecs = 4;   // 16-byte loads a lane issues a batch
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }

// A 16-byte piece of a row: its element count, element e (e a constant
// after unrolling) as f32, and the piece of -inf that fills a piece past
// the body.
template <typename T>
struct Piece;

template <>
struct Piece<__nv_bfloat16> {
  static constexpr int kN = 8;
  static constexpr uint32_t kNegInf = 0xff80ff80u;
  static __device__ __forceinline__ float at(const uint4& r, int e) {
    const uint32_t w = e < 2 ? r.x : e < 4 ? r.y : e < 6 ? r.z : r.w;
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

template <>
struct Piece<float> {
  static constexpr int kN = 4;
  static constexpr uint32_t kNegInf = 0xff800000u;
  static __device__ __forceinline__ float at(const uint4& r, int e) {
    return __uint_as_float(e == 0 ? r.x : e == 1 ? r.y : e == 2 ? r.z : r.w);
  }
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// An online logsumexp in base 2: l = sum 2^(v log2(e) - ml) over the values
// added, ml = m log2(e) rounded, m their max (-inf and l = 0 for none).
struct Lse {
  float m = -INFINITY, ml = -INFINITY, l = 0.f;

  // Before values up to `top` are added: a new max rescales l (exactly 0
  // while l is 0).
  __device__ __forceinline__ void raise(float top) {
    if (top > m) {
      const float nl = __fmul_rn(top, kLog2e);  // never contracted into an FMA: ml itself
      l *= ex2(ml - nl);
      m = top;
      ml = nl;
    }
  }
  __device__ __forceinline__ float term(float v) const { return ex2(fmaf(v, kLog2e, -ml)); }

  // Another pair (om, ol) folded in: ol is relative to om's own ml.
  __device__ __forceinline__ void fold(float om, float ol) {
    raise(om);
    if (om > -INFINITY) l += ol * ex2(__fmul_rn(om, kLog2e) - ml);
  }

  // ln of the sum of exp(v): m + (log2 l - delta) ln 2, delta the rounding
  // of ml (exact by the FMA).
  __device__ __forceinline__ float value() const {
    return m + (log2f(l) - fmaf(m, kLog2e, -ml)) * kLn2;
  }
};

// The warp's 32 pairs folded into every lane (the same butterfly in every
// launch: deterministic).
__device__ __forceinline__ void warp_fold(Lse& s) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float om = __shfl_xor_sync(kFull, s.m, o);
    const float ol = __shfl_xor_sync(kFull, s.l, o);
    s.fold(om, ol);
  }
}

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
struct List {
  float lv = -INFINITY, thr_v = -INFINITY;
  int li = INT32_MAX, thr_i = INT32_MAX;

  __device__ __forceinline__ void offer(float v, int id, bool valid, int lane, int k) {
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
};

// The same list for 32 < k <= 64: entry j in lane j % 32, slot j / 32.  An
// insert shifts both slots right by a lane, lane 31's first slot into lane
// 0's second.
struct List2 {
  float lv[2] = {-INFINITY, -INFINITY}, thr_v = -INFINITY;
  int li[2] = {INT32_MAX, INT32_MAX}, thr_i = INT32_MAX;

  __device__ __forceinline__ void offer(float v, int id, bool valid, int lane, int k) {
    bool pending = valid && ranks_before(v, id, thr_v, thr_i);
    unsigned ballot = __ballot_sync(kFull, pending);
    while (ballot) {
      const int src = __ffs(ballot) - 1;
      const float nv = __shfl_sync(kFull, v, src);
      const int ni = __shfl_sync(kFull, id, src);
      bool after[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        after[q] = 32 * q + lane < k && ranks_before(nv, ni, lv[q], li[q]);
      }
      // each entry's left neighbour: the lane before's, lane 0's second
      // slot lane 31's first
      float left_v[2];
      int left_i[2];
      bool left_after[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        left_v[q] = __shfl_up_sync(kFull, lv[q], 1);
        left_i[q] = __shfl_up_sync(kFull, li[q], 1);
        left_after[q] = __shfl_up_sync(kFull, static_cast<int>(after[q]), 1);
      }
      const float wrap_v = __shfl_sync(kFull, lv[0], 31);
      const int wrap_i = __shfl_sync(kFull, li[0], 31);
      const bool wrap_after = __shfl_sync(kFull, static_cast<int>(after[0]), 31);
      if (lane == 0) {
        left_after[0] = false;
        left_v[1] = wrap_v;
        left_i[1] = wrap_i;
        left_after[1] = wrap_after;
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (after[q]) {
          lv[q] = left_after[q] ? left_v[q] : nv;
          li[q] = left_after[q] ? left_i[q] : ni;
        }
      }
      const int last = (k - 1) & 31;
      thr_v = __shfl_sync(kFull, k > 32 ? lv[1] : lv[0], last);
      thr_i = __shfl_sync(kFull, k > 32 ? li[1] : li[0], last);
      pending = pending && lane != src && ranks_before(v, id, thr_v, thr_i);
      ballot = __ballot_sync(kFull, pending);
    }
  }
};

// The k-th largest of the warp's 32 values x (k <= 32) in every lane, by a
// bitonic sort across the lanes, descending.  Where more than k lanes hold
// candidates, at least k values are at least this large, so no value below
// it can be among the k best: a cut that spares the list most inserts while
// it fills.
__device__ __forceinline__ float warp_kth(float x, int k, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float y = __shfl_xor_sync(kFull, x, stride);
      x = (((lane & size) == 0) == ((lane & stride) == 0)) ? fmaxf(x, y) : fminf(x, y);
    }
  }
  return __shfl_sync(kFull, x, k - 1);
}

// Batch `b`'s pieces of the run's body, lane l's u-th at b * 32 kVecs + 32 u
// + l; pieces at or past `pieces` are -inf and read nothing.
template <typename T>
__device__ __forceinline__ void load_batch(uint4 (&r)[kVecs], const uint4* body, int b,
                                           int pieces, int lane) {
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const int j = b * 32 * kVecs + 32 * u + lane;
    constexpr uint32_t z = Piece<T>::kNegInf;
    r[u] = j < pieces ? __ldcs(body + j) : make_uint4(z, z, z, z);
  }
}

// The rare path, out of line so that the walk's loop stays small: one
// piece a lane (its first column col0) offered to the list value by value,
// values under `cut` not at all.
template <typename T, typename L>
__device__ __noinline__ L offer_piece(L list, uint4 r, int col0, bool valid, float cut, int lane,
                                      int k) {
#pragma unroll 1
  for (int e = 0; e < Piece<T>::kN; ++e) {
    const float v = Piece<T>::at(r, e);
    list.offer(v, col0 + e, valid && v >= cut, lane, k);
  }
  return list;
}

// One batch into the lane's logsumexp and the warp's list, a piece at a
// time: its values' max (a new max rescales l), their terms; then one vote
// on the candidates (a piece whose max is at least the k-th value), and
// only a piece that holds one, in some lane, is offered.  Where more than k
// lanes vote (the list filling), the k-th largest of the lanes' maxima
// cuts the offers further.
template <typename T, typename L>
__device__ __forceinline__ void take_batch(const uint4 (&r)[kVecs], Lse& lse, L& list, int b,
                                           int pieces, int col0, int lane, int k) {
  constexpr int W = Piece<T>::kN;
  float top[kVecs];
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    float v[W];
#pragma unroll
    for (int e = 0; e < W; ++e) v[e] = Piece<T>::at(r[u], e);
    top[u] = v[0];
#pragma unroll
    for (int e = 1; e < W; ++e) top[u] = fmaxf(top[u], v[e]);
    lse.raise(top[u]);
    if (lse.m > -INFINITY) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int e = 0; e < W; e += 2) {
        s0 += lse.term(v[e]);
        s1 += lse.term(v[e + 1]);
      }
      lse.l += s0 + s1;
    }
  }
  bool any = false;
  float best = top[0];
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    any |= top[u] >= list.thr_v;
    best = fmaxf(best, top[u]);
  }
  const unsigned voters = __ballot_sync(kFull, any);
  if (voters == 0) return;
  float cut;
  if constexpr (std::is_same<L, List>::value) {
    cut = __popc(voters) > k ? warp_kth(best, k, lane) : -INFINITY;
  } else {
    // the lane's second-largest piece maximum: ceil(k / 2) lanes at or
    // above the cut hold k values that reach it
    float first = -INFINITY, second = -INFINITY;
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      second = fmaxf(second, fminf(first, top[u]));
      first = fmaxf(first, top[u]);
    }
    const int half = (k + 1) / 2;
    cut = __popc(voters) > half ? warp_kth(second, half, lane) : -INFINITY;
  }
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    cut = fmaxf(cut, list.thr_v);
    if (__any_sync(kFull, top[u] >= cut)) {
      const int j = b * 32 * kVecs + 32 * u + lane;
      list = offer_piece<T, L>(list, r[u], col0 + j * W, j < pieces, cut, lane, k);
    }
  }
}

// The row's runs folded in run order: their (max, sum) pairs lane z for run
// z (z + 32, ...) and then the butterfly; their lists offered 32 entries at
// a time to one list; lp = value - lse.  The partials are read from L2
// (other SMs wrote them).
template <typename L>
__device__ void fold_row(const float* part_m, const float* part_l, const float* part_v,
                         const int32_t* part_i, float* lp, int32_t* ids, int row, int n, int k,
                         int runs, int lane) {
  Lse lse;
  for (int z = lane; z < runs; z += 32) {
    const size_t o = static_cast<size_t>(z) * n + row;
    lse.fold(__ldcg(part_m + o), __ldcg(part_l + o));
  }
  warp_fold(lse);
  const float total = __shfl_sync(kFull, lse.value(), 0);
  L list;
  const int entries = runs * k;
  for (int t0 = 0; t0 < entries; t0 += 32) {  // warp-uniform
    const int t = t0 + lane;
    const bool valid = t < entries;
    float v = -INFINITY;
    int id = 0;
    if (valid) {
      const size_t o = (static_cast<size_t>(t / k) * n + row) * k + t % k;
      v = __ldcg(part_v + o);
      id = __ldcg(part_i + o);
    }
    const unsigned voters = __ballot_sync(kFull, valid && v >= list.thr_v);
    const float cut = __popc(voters) > k ? warp_kth(v, k, lane) : -INFINITY;
    list.offer(v, id, valid && v >= cut, lane, k);
  }
  if constexpr (std::is_same<L, List>::value) {
    if (lane < k) {
      lp[static_cast<size_t>(row) * k + lane] = list.lv - total;
      ids[static_cast<size_t>(row) * k + lane] = list.li;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (32 * q + lane < k) {
        lp[static_cast<size_t>(row) * k + 32 * q + lane] = list.lv[q] - total;
        ids[static_cast<size_t>(row) * k + 32 * q + lane] = list.li[q];
      }
    }
  }
}

// L: List (k <= 32) or List2 (32 < k <= 64)
template <typename T, typename L>
__global__ void __launch_bounds__(kWarps * 32, 2)
topk_lse_kernel(const T* __restrict__ logits,  // (N, V)
                float* __restrict__ part_m,    // (runs, N)
                float* __restrict__ part_l,    // (runs, N)
                float* __restrict__ part_v,    // (runs, N, k)
                int32_t* __restrict__ part_i,  // (runs, N, k)
                unsigned* __restrict__ arrivals,  // (N,), 0 between launches
                float* __restrict__ lp, int32_t* __restrict__ ids, int n, int vocab, int k,
                int runs, int run_cols) {
  constexpr int W = Piece<T>::kN;
  const int lane = threadIdx.x & 31;
  const int task = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (task >= n * runs) return;  // the whole warp
  const int row = task / runs, run = task - row * runs;
  const int c0 = run * run_cols, c1 = min(vocab, c0 + run_cols);
  const T* x = logits + static_cast<size_t>(row) * vocab;
  // the body: whole 16-byte pieces from the run's first 16-byte boundary
  const int misaligned = static_cast<int>(reinterpret_cast<uintptr_t>(x + c0) & 15);
  const int head = min(c1 - c0, ((16 - misaligned) & 15) / static_cast<int>(sizeof(T)));
  const int ca = c0 + head;
  const int pieces = (c1 - ca) / W;
  const int cb = ca + pieces * W;
  const uint4* body = reinterpret_cast<const uint4*>(x + ca);

  Lse lse;
  L list;
  {  // the head and the tail, fewer than W columns each: one a lane
    const int tail = c1 - cb;
    const bool valid = lane < head + tail;
    const int c = lane < head ? c0 + lane : cb + lane - head;
    const float v = valid ? to_float(x[c]) : -INFINITY;
    lse.raise(v);
    if (lse.m > -INFINITY) lse.l += lse.term(v);
    list.offer(v, c, valid, lane, k);
  }
  const int batches = (pieces + 32 * kVecs - 1) / (32 * kVecs);
  uint4 r0[kVecs], r1[kVecs];
  load_batch<T>(r0, body, 0, pieces, lane);
  for (int b = 0; b < batches; b += 2) {  // warp-uniform
    load_batch<T>(r1, body, b + 1, pieces, lane);
    take_batch<T, L>(r0, lse, list, b, pieces, ca, lane, k);
    if (b + 1 < batches) {
      load_batch<T>(r0, body, b + 2, pieces, lane);
      take_batch<T, L>(r1, lse, list, b + 1, pieces, ca, lane, k);
    }
  }
  warp_fold(lse);

  const size_t o = static_cast<size_t>(run) * n + row;
  if (lane == 0) {
    part_m[o] = lse.m;
    part_l[o] = lse.l;
  }
  if constexpr (std::is_same<L, List>::value) {
    if (lane < k) {
      part_v[o * k + lane] = list.lv;
      part_i[o * k + lane] = list.li;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (32 * q + lane < k) {
        part_v[o * k + 32 * q + lane] = list.lv[q];
        part_i[o * k + 32 * q + lane] = list.li[q];
      }
    }
  }
  __threadfence();  // this run's partials are visible before it counts itself in
  __syncwarp();
  unsigned prior = 0;
  if (lane == 0) prior = atomicAdd(arrivals + row, 1u);
  prior = __shfl_sync(kFull, prior, 0);
  if (prior != static_cast<unsigned>(runs - 1)) return;
  __threadfence();  // the last run in: every run's partials are visible
  fold_row<L>(part_m, part_l, part_v, part_i, lp, ids, row, n, k, runs, lane);
  if (lane == 0) arrivals[row] = 0;
}

constexpr int kMaxDevices = 64;

// Resident warps of topk_lse_kernel<T, L> in one wave on the current
// device, queried once a device: the launch runs once a decode step.
template <typename T, typename L>
cudaError_t wave_warps(int* wave) {
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
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, topk_lse_kernel<T, L>,
                                                          kWarps * 32, 0);
    }
    if (err != cudaSuccess) return err;
    cached[dev] = max(1, sms * per_sm) * kWarps;
  }
  *wave = cached[dev];
  return cudaSuccess;
}

// part_* hold max_runs partials a row; the launch uses as many as fill a
// wave.  arrivals: n counters, 0 on entry and again on return.
template <typename T, typename L>
int launch_list(const void* logits, void* part_m, void* part_l, void* part_v, void* part_i,
                void* arrivals, void* lp, void* ids, int n, int vocab, int k, int max_runs,
                void* stream) {
  int wave = 0;
  cudaError_t err = wave_warps<T, L>(&wave);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int want = max(1, min(max_runs, wave / n));
  const int run_cols = (vocab + want - 1) / want;
  const int runs = (vocab + run_cols - 1) / run_cols;  // none empty
  const int blocks = static_cast<int>((static_cast<int64_t>(n) * runs + kWarps - 1) / kWarps);
  topk_lse_kernel<T, L><<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(logits), static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<float*>(part_v), static_cast<int32_t*>(part_i),
      static_cast<unsigned*>(arrivals), static_cast<float*>(lp), static_cast<int32_t*>(ids), n,
      vocab, k, runs, run_cols);
  return static_cast<int>(cudaGetLastError());
}

// k <= 32 on the one-slot list, 33-40 on the two-slot one.
template <typename T>
int launch(const void* logits, void* part_m, void* part_l, void* part_v, void* part_i,
           void* arrivals, void* lp, void* ids, int n, int vocab, int k, int max_runs,
           void* stream) {
  if (n < 1 || vocab < 1 || k < 1 || k > kMaxK || k > vocab || max_runs < 1 ||
      max_runs > vocab) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto run = k <= 32 ? launch_list<T, List> : launch_list<T, List2>;
  return run(logits, part_m, part_l, part_v, part_i, arrivals, lp, ids, n, vocab, k, max_runs,
             stream);
}

}  // namespace

extern "C" int mic_topk_lse_bf16(void* logits, void* part_m, void* part_l, void* part_v,
                                 void* part_i, void* arrivals, void* lp, void* ids, int n,
                                 int vocab, int k, int max_runs, void* stream) {
  return launch<__nv_bfloat16>(logits, part_m, part_l, part_v, part_i, arrivals, lp, ids, n,
                               vocab, k, max_runs, stream);
}

extern "C" int mic_topk_lse_f32(void* logits, void* part_m, void* part_l, void* part_v,
                                void* part_i, void* arrivals, void* lp, void* ids, int n,
                                int vocab, int k, int max_runs, void* stream) {
  return launch<float>(logits, part_m, part_l, part_v, part_i, arrivals, lp, ids, n, vocab, k,
                       max_runs, stream);
}
