// Fused tied LM head: logits s = hidden @ weight^T + bias over the
// 250054-token vocab, never stored, reduced to candidates and the row lse.
//
// Kernels (ops/fused_head.py launches them), rows 4-6 of PERF.md's table:
//   - the bucket accumulator pass (fused_head_topk and fused_head_topk_q8,
//     select="bucket"), replacing mic_tpu/ops/fused_head.py's
//     _kernel_bucket_acc / _kernel_bucket (bf16 weight) and
//     _kernel_q8_bucket(_acc) (int8 weight): bucket_kernel<kInt8> below;
//   - the exact/window candidate select, replacing its _kernel (bf16:
//     select_kernel below; float32 hidden rows and table: f32::select_kernel
//     on the 3xTF32 tile of csrc/tf32x3_wgmma.cuh) and _kernel_q8 (int8 x
//     int8: q8::select_kernel);
//   - the merges of their split runs.
// The weight is the tied embedding as stored, (V, D), each vocab row
// contiguous (K-major, the order wgmma reads from shared memory); the int8
// form has one f32 scale per vocab row.
//
// Every kernel here runs on Hopper's wgmma fed by TMA (csrc/head_wgmma.cuh):
// one producer warp (in a warpgroup of its own that hands its registers to
// the consumers by setmaxnreg) keeps TMA loads of weight slices in flight
// through a ring of mbarrier-guarded slots; two consumer warpgroups issue
// wgmma on the slots and release them; no __syncthreads falls inside the
// walk, and the epilogue works on the accumulator registers, never through
// a shared score tile.  Vocab rows past V arrive as TMA's zero fill and are
// masked in the epilogues; so is depth past D (the bf16 select takes
// D % 64 == 32: the last 64-deep slice's zero half adds nothing).
//
// Bucket select.  The vocab is cut into chunks of `buckets` columns (the
// TPU's bv, on which the candidate ids depend: 512, or any width that
// MIC_TPU_EXPERIMENTAL=bucket_bv names); bucket column j of a row keeps,
// over the chunks in order,
//
//   l[j]    += exp(min(s, 60))                    (fixed-offset sum of exps)
//   rmax[j], rid[j] <- s, id   where s > rmax[j]  (strict: earliest chunk wins)
//
// with columns >= V masked to -1e30.  The three (N, buckets) planes go back
// to the caller, which finishes lse and the top-k of the bucket winners as
// the TPU's _bucket_finish_host does in XLA.  A block owns 64 hidden rows x
// 64 bucket columns (ceil(buckets / 64) column groups; a group's columns at
// or past `buckets` read the next chunk's rows and are masked out) and walks
// a run of consecutive chunks; the vocab is wgmma's M side (64 vocab rows of
// a chunk's column group), the block's 64 hidden rows, resident in shared
// memory for the whole walk, its N side (m64n64k16), so each thread always
// owns the same (bucket column, hidden row) cells and keeps their (l, rmax,
// rid) in registers: 32 accumulators and 96 words of state, which is why
// the tile stays 64 wide.  Warpgroup w walks chunks c_begin + w, c_begin +
// w + 2, ... of the run, each ring stage holding one 64 x 64 slice for each
// warpgroup; at the end the two warpgroups' planes merge through shared
// memory, sums added, the higher value or on a tie the lower id (the
// earlier chunk) kept.  When the (row tile x column group) blocks leave most
// SMs idle (small N), the caller splits the chunk walk into `splits`
// consecutive runs (grid z); each run writes its own planes and a merge
// kernel folds them in chunk order -- sums added, the strict > so that the
// earliest chunk still wins ties.
//   bf16 weight (row 4): both operands from shared memory (the slice as TMA
// writes it, the hidden tile by TMA too), s = acc + b in f32 (the plain
// version's rounding); a warpgroup waits for each slice's products and
// then frees its slot (a second group kept in flight measured no faster
// beyond the spread between runs: PERF.md).  At N = 1024 the 16
// row tiles stream the 512 MB weight from L2 16 times (8 GB); a cluster of
// two row tiles sharing each slice by TMA multicast halves that but was no
// faster there (measured on the card; PERF.md), so blocks load their own
// slices.
//   int8 weight (row 6): wgmma has no bf16 x int8 form, so each consumer
// thread reads its rows of the int8 slice from shared memory into
// registers and converts them to bf16 there (exact: every int8 value is a
// bf16) as the register A operand; the thread's 16 bytes of a row hold, by
// a fixed permutation of k inside each 64-deep block, exactly the 16 values
// its A fragments need for the slice's four k16 steps, and the hidden tile
// is stored with the same permutation, so the sums are unchanged and each
// slice costs two 16-byte shared loads a thread; s = acc * ws + b unfused
// (__fmul_rn, __fadd_rn).
//
// Exact and window select.  Per hidden row: the row's online (max, sum of
// exps) of the logits and its candidates: the exact top-k (on equal values
// the lowest id first, the leftmost max of _select_topk), or the top-k over
// the 128-wide windows' top-1s (inside a window the highest lane wins a tie,
// between windows the lowest window).  The TPU walks the vocab in order with
// its running state in scratch; here blocks run in no order.  A block owns
// a row tile and a run of consecutive 128-wide vocab tiles (one window
// each); the epilogue (select_tile) works on the accumulator registers:
// the online (max, sum) a row, the window's top-1 by quad shuffles, or for
// exact every column that ranks before the row's current k-th candidate and
// reaches the row's floor, appended to the row's list in shared memory; a
// list that fills is cut back to its top k by rank (the order is total:
// value, then lower id), which raises the row's threshold, and publishes
// that k-th value as the row's floor for the other runs (atomicMax in
// global memory: k columns reach it, so nothing below it is in the top k).
// A second kernel merges the runs per row; the order of candidates is
// total, so the merge does not depend on which run finishes first.
//   bf16 (row 5): 64 resident hidden rows (128 bytes a row a 64-deep block:
// 128 rows would not fit at D = 1024) as wgmma's A, each vocab tile as B
// (m64n128k16, both from shared memory, s = acc + b); the two warpgroups
// take alternate tiles of the run, each with its own slots of the ring and
// its own candidate lists, and write their state as two runs of the merge;
// a warpgroup waits for each slice's products and then frees its slot (a
// group kept in flight measured slower: PERF.md).
//   int8 (row 6, q8::select_kernel): m64n128k32 int8 x int8 into exact
// int32, the block's 128 quantized hidden rows (64 a warpgroup) resident
// as A; s = acc * xs[row] * ws[col] + b[col] in f32 in the plain version's
// order (bit-equal logits; the tile's ws and b arrive by TMA beside its
// last slice).
//   Wide instances (17 <= k <= 40; beam search asks for 2K + 5 candidates
// a row under an n-gram ban, 37 at 16 beams): the same kernels with lists
// of kCapWide = 44 entries a row (kCap = 24 up to k = 16), which the 64
// resident hidden rows leave room for only beside fewer ring slots: three
// in the bf16 select at D = 1024 (a slot then serves the two warpgroups in
// turn, slice s in slot s % stages, where the narrow instance gives each
// warpgroup the slots of its parity), three stages in the int8 select,
// four slots in the float32 one (two of each parity, as its narrow six).
// The merge of their runs is a k-way merge of the runs' lists
// (fused_head_select_merge_wide_kernel), which are in rank order already:
// no list of k entries is kept in registers.
//
// Bound at the flagship decode shape (N = 1024 rows, D = 1024, V = 250054):
// the product, 0.52 TFLOP, at the tensor-core rate (0.53 ms in bf16, 0.265
// ms for the int8 x int8 select); at a few rows (N = 4, one image of beam
// 4) the stream of the weight (512 MB bf16, 256 MB int8: 0.153 / 0.077 ms).
// The float32 select: 3 x 0.52 TFLOP of TF32 products, 3.18 ms at 495
// TFLOP/s (165 TFLOP/s of float32-accurate products); at N = 4 the 1 GB
// float32 table, 0.306 ms.  Its blocks re-read the hidden boxes and their
// tiles' table rows from L2, as the f32 bucket tile's do (csrc/fused_head_f32.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "head_wgmma.cuh"
#include "tf32x3_wgmma.cuh"

namespace {

using namespace head_wgmma;

constexpr float kNegInf = -1e30f;   // NEG_INF of mic_tpu/ops/topk_lse.py
constexpr float kExpClamp = 60.f;   // _EXP_CLAMP of mic_tpu/ops/fused_head.py
constexpr int kTopK = 16;           // the largest k of the narrow instances
constexpr int kTopKWide = 40;       // the largest k of the wide ones (ROADMAP B45)
constexpr int kConsumerWarps = 8;                      // two warpgroups
constexpr int kThreads = (kConsumerWarps + 4) * 32;    // and the producer's warpgroup
constexpr int kConsumerThreads = kConsumerWarps * 32;
constexpr int kProducerRegs = 40;                      // registers a thread after setmaxnreg
constexpr int kConsumerRegs = 232;
constexpr int kMaxSmem = 232448;
constexpr int kMaxStages = 8;
constexpr int kCap = 24;           // candidate entries a row (exact/window), k <= 16
constexpr int kCapWide = 44;       // the same for 17 <= k <= 40: three ring slots still fit
constexpr int kMergeHeads = 9;     // the wide merge's runs a lane, at most (288 runs)

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

// f32 values as ints in the same order (for atomicMax on a shared floor).
__device__ __forceinline__ int order_key(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7FFFFFFF;
}
__device__ __forceinline__ float key_value(int key) {
  return __int_as_float(key >= 0 ? key : key ^ 0x7FFFFFFF);
}

// ---------------------------------------------------------------------------
// Merges of the split runs.

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
  if (buckets < 1 || n < 1 || vocab < 1) return false;
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

// One warp a row: folds the runs' (max, sum) into lse = log(sum) + max and
// their candidate lists into the row's top-k; lp = value - lse.  Lane j
// takes runs j, j + 32, ...: their (max, sum) folded by butterflies (every
// lane ends with the same values), their candidates into a list of its own
// in rank order; then k rounds each take the best head of the 32 lists.
// The order of candidates is total, so the result does not depend on which
// lane held which.
__global__ void fused_head_select_merge_kernel(const float* __restrict__ part_m,
                                               const float* __restrict__ part_l,
                                               const float* __restrict__ part_v,
                                               const int32_t* __restrict__ part_i,
                                               float* __restrict__ lp, int32_t* __restrict__ ids,
                                               float* __restrict__ lse, int n, int k, int runs) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // warp-uniform
  float m = -INFINITY;
  for (int z = lane; z < runs; z += 32) m = fmaxf(m, part_m[static_cast<size_t>(z) * n + row]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float l = 0.f;
  for (int z = lane; z < runs; z += 32) {
    const float mz = part_m[static_cast<size_t>(z) * n + row];
    if (mz > -INFINITY) l += part_l[static_cast<size_t>(z) * n + row] * expf(mz - m);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  const float lse_r = logf(l) + m;
  float tv[kTopK];
  int ti[kTopK];
#pragma unroll
  for (int i = 0; i < kTopK; ++i) {
    tv[i] = -INFINITY;
    ti[i] = INT32_MAX;
  }
  for (int z = lane; z < runs; z += 32) {
    const size_t o = (static_cast<size_t>(z) * n + row) * k;
    for (int i = 0; i < k; ++i) topk_insert(tv, ti, part_v[o + i], part_i[o + i]);
  }
  for (int r = 0; r < k; ++r) {
    float bv = tv[0];
    int bi = ti[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ranks_before(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (tv[0] == bv && ti[0] == bi) {  // the lane holding it (or every empty list)
#pragma unroll
      for (int i = 0; i < kTopK - 1; ++i) {
        tv[i] = tv[i + 1];
        ti[i] = ti[i + 1];
      }
      tv[kTopK - 1] = -INFINITY;
      ti[kTopK - 1] = INT32_MAX;
    }
    if (lane == 0) {
      lp[static_cast<size_t>(row) * k + r] = bv - lse_r;
      ids[static_cast<size_t>(row) * k + r] = bi;
    }
  }
  if (lane == 0) lse[row] = lse_r;
}

// The merge of 17 <= k <= 40 candidates a run, one warp a row: a run's
// list is in rank order, so the row's top k is a k-way merge of the runs'
// lists.  Lane j holds the head (next entry) of each of runs j, j + 32, ...
// (up to kMergeHeads of them); each of k rounds takes the best head of the
// warp (the total order: value, then lower id), and the lane holding it
// moves that run's head on.  No list is kept in registers.  (max, sum) as
// the narrow merge.
__global__ void fused_head_select_merge_wide_kernel(const float* __restrict__ part_m,
                                                    const float* __restrict__ part_l,
                                                    const float* __restrict__ part_v,
                                                    const int32_t* __restrict__ part_i,
                                                    float* __restrict__ lp,
                                                    int32_t* __restrict__ ids,
                                                    float* __restrict__ lse, int n, int k,
                                                    int runs) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // warp-uniform
  float m = -INFINITY;
  for (int z = lane; z < runs; z += 32) m = fmaxf(m, part_m[static_cast<size_t>(z) * n + row]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float l = 0.f;
  for (int z = lane; z < runs; z += 32) {
    const float mz = part_m[static_cast<size_t>(z) * n + row];
    if (mz > -INFINITY) l += part_l[static_cast<size_t>(z) * n + row] * expf(mz - m);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  const float lse_r = logf(l) + m;
  float hv[kMergeHeads];
  int hi[kMergeHeads], at[kMergeHeads];
  auto head = [&](int u) {  // run lane + 32 u's entry at[u], or past its list
    const int z = lane + 32 * u;
    const bool in = z < runs && at[u] < k;
    const size_t o = (static_cast<size_t>(z) * n + row) * k + at[u];
    hv[u] = in ? part_v[o] : -INFINITY;
    hi[u] = in ? part_i[o] : INT32_MAX;
  };
#pragma unroll
  for (int u = 0; u < kMergeHeads; ++u) {
    at[u] = 0;
    head(u);
  }
  for (int r = 0; r < k; ++r) {
    float bv = hv[0];
    int bi = hi[0], bu = 0;
#pragma unroll
    for (int u = 1; u < kMergeHeads; ++u) {
      if (ranks_before(hv[u], hi[u], bv, bi)) {
        bv = hv[u];
        bi = hi[u];
        bu = u;
      }
    }
    float wv = bv;
    int wi = bi;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, wv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, wi, o);
      if (ranks_before(ov, oi, wv, wi)) {
        wv = ov;
        wi = oi;
      }
    }
    if (bv == wv && bi == wi) {  // the lane holding it (or every lane, once all are spent)
#pragma unroll
      for (int u = 0; u < kMergeHeads; ++u) {
        if (u == bu) {
          ++at[u];
          head(u);
        }
      }
    }
    if (lane == 0) {
      lp[static_cast<size_t>(row) * k + r] = wv - lse_r;
      ids[static_cast<size_t>(row) * k + r] = wi;
    }
  }
  if (lane == 0) lse[row] = lse_r;
}

// After the select walk's launch: the merge of its runs into lp, ids, lse
// (the wide merge past k = 16).
int select_merge(void* part_m, void* part_l, void* part_v, void* part_i, void* lp, void* ids,
                 void* lse, int n, int k, int runs, cudaStream_t s) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto merge = k > kTopK ? fused_head_select_merge_wide_kernel : fused_head_select_merge_kernel;
  merge<<<(n + 3) / 4, 128, 0, s>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_v), static_cast<const int32_t*>(part_i),
      static_cast<float*>(lp), static_cast<int32_t*>(ids), static_cast<float*>(lse), n, k, runs);
  return static_cast<int>(cudaGetLastError());
}

// The select instances by k: kCap entries a row for k <= 16, kCapWide up
// to 40; the wide merge takes at most 32 kMergeHeads runs.
bool select_k_ok(int k, int runs) {
  return k >= 1 && k <= kTopKWide && (k <= kTopK || runs <= 32 * kMergeHeads);
}

// ---------------------------------------------------------------------------
// Bucket select: 64 hidden rows x 64 bucket columns a block, 64-deep slices.

constexpr int kBRows = 64;
constexpr int kBCols = 64;
constexpr int kBDepth = 64;
constexpr int kBucketMerge = 3 * 32 * 128 * 4;  // the warpgroups' merge, through the ring

template <bool kInt8>
__host__ __device__ constexpr int bucket_slice() {  // a warpgroup's slice: 64 vocab rows x 64 deep
  return kInt8 ? kBCols * kBDepth : kBCols * kBDepth * 2;
}

// Alignment slack, the 64 resident hidden rows (bf16), `stages` ring stages
// of one slice for each warpgroup, their barriers and the hidden tile's.
template <bool kInt8>
size_t bucket_smem_bytes(int d, int stages) {
  return 1024 + static_cast<size_t>(kBRows) * d * 2 +
         static_cast<size_t>(stages) * 2 * bucket_slice<kInt8>() +
         (2 * stages + 1) * sizeof(uint64_t);
}

// int8: eight stages; bf16: as many as fit, up to eight.
template <bool kInt8>
int bucket_stages(int d) {
  if (kInt8) return kMaxStages;
  int stages = kMaxStages;
  while (stages > 0 && bucket_smem_bytes<false>(d, stages) > kMaxSmem) --stages;
  return stages;
}

template <bool kInt8>
__global__ void __launch_bounds__(kThreads, 1)
bucket_kernel(const __grid_constant__ CUtensorMap wmap,   // weight (V, D), 64-deep boxes
              const __grid_constant__ CUtensorMap hmap,   // bf16: hidden (N, D), 64 x 64 boxes
              const __nv_bfloat16* __restrict__ hidden,   // int8: (N, D), permuted on load
              const float* __restrict__ wscale,           // int8: (V,)
              const float* __restrict__ bias,             // (V,)
              float* __restrict__ l_out,                  // (splits, N, buckets)
              float* __restrict__ rmax_out,               // (splits, N, buckets)
              int32_t* __restrict__ rid_out,              // (splits, N, buckets)
              int n, int d, int vocab, int buckets, int stages) {
  constexpr int kSlice = bucket_slice<kInt8>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* hs = align_1024(smem_raw);        // [D/64][64 rows][128 B], swizzled
  unsigned char* ring = hs + kBRows * d * 2;        // [stage][warpgroup][64 rows][kRowBytes]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * 2 * kSlice);
  uint64_t* empty = full + stages;
  uint64_t* hfull = empty + stages;

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
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    mbar_init(hfull, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // producer: stage s holds depth block s % nk of the pair's two chunks
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0) {
      if constexpr (!kInt8) {
        // rows past n arrive as zeros
        mbar_expect_tx(hfull, nk * kBRows * 128);
        for (int kb = 0; kb < nk; ++kb) {
          tma_load_2d(hs + kb * (kBRows * 128), &hmap, hfull, kb * kBDepth, row0);
        }
      }
      int slot = 0, phase = 0;
      for (int s = 0; s < nslices; ++s) {
        if (s >= stages) mbar_wait(&empty[slot], phase ^ 1);
        const int chunk = c_begin + 2 * (s / nk);
        const int kk = (s % nk) * kBDepth;
        const bool second = chunk + 1 < c_end;
        unsigned char* dst = ring + slot * 2 * kSlice;
        mbar_expect_tx(&full[slot], second ? 2 * kSlice : kSlice);
        tma_load_2d(dst, &wmap, &full[slot], kk, chunk * buckets + col0);
        if (second) tma_load_2d(dst + kSlice, &wmap, &full[slot], kk, (chunk + 1) * buckets + col0);
        if (++slot == stages) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = consumer_warpgroup();
  const int w = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  if constexpr (kInt8) {
    // the resident hidden tile as wgmma's B: logical 16-byte chunk c of row
    // r in depth block kb holds the bf16 pairs 8 t' + c (t' = 0..3) of that
    // block, the permutation that matches the A registers below; rows past
    // n are zero
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
  } else {
    mbar_wait(hfull, 0);
  }

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
  // bucket columns col0 + 16 w + g + 8 h of the block (vocab rows of a
  // chunk's column group); a column at or past `buckets` is the next
  // chunk's and is left out
  const int bcol = col0 + 16 * w + g;
  // int8: bytes [16 t, 16 t + 16) of the thread's two vocab rows of a slice
  const int arow = (16 * w + g) * kBDepth + 16 * t;
  int slot = 0, phase = 0;
  auto advance = [&]() {
    if (++slot == stages) {
      slot = 0;
      phase ^= 1;
    }
  };
  for (int p = 0; p < npairs; ++p) {
    const int chunk = c_begin + 2 * p + wg;
    if (chunk >= c_end) {  // warpgroup-uniform: the last pair of an odd run
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(&full[slot], phase);
        release(empty, slot);
        advance();
      }
      continue;
    }
    const int vbase = chunk * buckets + bcol;
    // the chunk's scales and biases, loaded while its products run
    bool valid[2];
    float wsv[2], bv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      valid[h] = bcol + 8 * h < buckets && vbase + 8 * h < vocab;
      wsv[h] = kInt8 && valid[h] ? __ldg(wscale + vbase + 8 * h) : 0.f;
      bv[h] = valid[h] ? __ldg(bias + vbase + 8 * h) : 0.f;
    }
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(&full[slot], phase);
      unsigned char* slice = ring + slot * 2 * kSlice + wg * kSlice;
      if constexpr (kInt8) {
        const uint4 lo = *reinterpret_cast<const uint4*>(slice + arow);
        const uint4 hi = *reinterpret_cast<const uint4*>(slice + arow + 8 * kBDepth);
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
        release(empty, slot);
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
#pragma unroll
        for (int x = 0; x < 32; ++x) fence_operand(acc[x]);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wgmma_m64n64k16_bf16_ss(acc, desc_sw128(slice + 32 * j),
                                  desc_sw128(hs + kb * (kBRows * 128) + 32 * j), (kb | j) != 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int x = 0; x < 32; ++x) fence_operand(acc[x]);
        release(empty, slot);
      }
      advance();
    }
    // the bucket update: d[4 i + 2 h + e] is vocab row vbase + 8 h (bucket
    // column bcol + 8 h), hidden row 8 i + 2 t + e
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = vbase + 8 * h;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * i + 2 * h + e;
          const float prod = kInt8 ? __fmul_rn(acc[x], wsv[h]) : acc[x];
          const float sc = valid[h] ? __fadd_rn(prod, bv[h]) : kNegInf;
          l_st[x] += expf(fminf(sc, kExpClamp));
          if (sc > m_st[x]) {
            m_st[x] = sc;
            id_st[x] = v;
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
            if (bcol + 8 * h < buckets) {
              const size_t o = (static_cast<size_t>(blockIdx.z) * n + r) * buckets + bcol + 8 * h;
              l_out[o] = l_st[x];
              rmax_out[o] = m_st[x];
              rid_out[o] = id_st[x];
            }
          }
        }
      }
    }
  }
}

template <bool kInt8>
int launch_bucket(const void* hidden, const void* weight, const void* wscale, const void* bias,
                  void* l_out, void* rmax_out, void* rid_out, void* l_part, void* rmax_part,
                  void* rid_part, int n, int d, int vocab, int buckets, int splits,
                  void* stream) {
  const int stages = bucket_stages<kInt8>(d);
  const size_t smem = bucket_smem_bytes<kInt8>(d, stages);
  if (!bucket_args_ok(n, vocab, buckets, splits) || d % kBDepth != 0 || stages < 2 ||
      smem > kMaxSmem || stages * 2 * bucket_slice<kInt8>() < kBucketMerge) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap wmap, hmap;
  cudaError_t err =
      kInt8 ? encode_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, weight, d, vocab, kBDepth,
                        kBCols, CU_TENSOR_MAP_SWIZZLE_NONE)
            : encode_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, weight, d, vocab, kBDepth,
                        kBCols, CU_TENSOR_MAP_SWIZZLE_128B);
  hmap = wmap;  // int8: unread
  if (err == cudaSuccess && !kInt8) {
    err = encode_2d(&hmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, hidden, d, n, kBDepth, kBRows,
                    CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(bucket_kernel<kInt8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool split = splits > 1;
  const dim3 grid((n + kBRows - 1) / kBRows, (buckets + kBCols - 1) / kBCols, splits);
  bucket_kernel<kInt8><<<grid, kThreads, smem, s>>>(
      wmap, hmap, static_cast<const __nv_bfloat16*>(hidden), static_cast<const float*>(wscale),
      static_cast<const float*>(bias), static_cast<float*>(split ? l_part : l_out),
      static_cast<float*>(split ? rmax_part : rmax_out),
      static_cast<int32_t*>(split ? rid_part : rid_out), n, d, vocab, buckets, stages);
  return bucket_merge(l_out, rmax_out, rid_out, l_part, rmax_part, rid_part, n, buckets, splits,
                      s);
}

// ---------------------------------------------------------------------------
// The exact/window epilogue, shared by both selects.  A consumer thread of a
// warpgroup holds rows 16 w + g + 8 h (h = 0, 1) of the warpgroup's 64 and,
// of a 128-wide tile, columns 8 i + 2 t + e (i < 16, e < 2): its logits
// sv[4 i + 2 h + e], as m64n128's accumulator lays them out.

// The select state of a thread's two rows.
struct RowPair {
  bool live[2];      // the row is below N
  float m[2], l[2];  // the online max and sum of exps (the thread's columns)
  float tv[2];       // the row's k-th candidate so far: the admission threshold
  int ti[2];
  int cnt[2];        // entries in the row's candidate list
  int floor_key[2];  // the row's floor as the runs have raised it (exact)
  int srt[2];        // the list's first entries in rank order (the wide lists)
};

__device__ __forceinline__ void rows_init(RowPair& st, int row, int n) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    st.live[h] = row + 8 * h < n;
    st.m[h] = -INFINITY;
    st.l[h] = 0.f;
    st.tv[h] = -INFINITY;
    st.ti[h] = INT32_MAX;
    st.cnt[h] = 0;
    st.floor_key[h] = 0;
    st.srt[h] = 0;
  }
}

// The rows' floors as other runs have raised them (exact), read ahead of a
// tile's epilogue; floor points at row h = 0's (row h = 1's is 8 further).
__device__ __forceinline__ void read_floors(RowPair& st, const int* floor) {
#pragma unroll
  for (int h = 0; h < 2; ++h) st.floor_key[h] = st.live[h] ? __ldcg(floor + 8 * h) : 0;
}

__device__ __forceinline__ float value(float x) { return x; }
__device__ __forceinline__ float value(int x) { return __int_as_float(x); }

// Cut a row's candidate list (its quad's shared entries [0, cnt)) back to its
// top k, in rank order; the row's threshold becomes its k-th entry.  Every
// entry's rank is the number of entries that rank before it: distinct,
// since ids are.  With kSorted (the bf16 and int8 selects' wide lists)
// the list keeps its first `srt` entries in rank order from the last cut,
// so only the entries after them are compared with all: an earlier
// entry's rank is its index plus the later entries before it, a later
// entry's the earlier entries before it (a binary search) plus the later
// ones; `srt` becomes the entries kept.  (The float32 select keeps the
// full cut: with this one it measured 13.14 ms against 11.66-11.98 at k =
// 37, before its epilogue went out of line.)
template <int kCapT, bool kSorted>
__device__ __forceinline__ void compact_row(float* bv, int* bi, int& cnt, int k, float& tv,
                                            int& ti, int t, unsigned quad, int& srt) {
  constexpr int kPer = kCapT / 4;
  const int from = kSorted ? srt : 0;
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
  for (int x = from; x < cnt; ++x) {
    const float xv = bv[x];
    const int xid = bi[x];
#pragma unroll
    for (int q = 0; q < kPer; ++q) rk[q] += ranks_before(xv, xid, ev[q], ei[q]) ? 1 : 0;
  }
  if constexpr (kSorted) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int e = t + 4 * q;
      if (e < from) {
        rk[q] += e;
      } else if (e < cnt) {
        int lo = 0, hi = from;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (ranks_before(bv[mid], bi[mid], ev[q], ei[q])) {
            lo = mid + 1;
          } else {
            hi = mid;
          }
        }
        rk[q] += lo;
      }
    }
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
  srt = cnt;
  if (cnt == k) {
    tv = bv[k - 1];
    ti = bi[k - 1];
  } else {
    tv = -INFINITY;
    ti = INT32_MAX;
  }
}

// A complete tile's logits sv (columns >= V at -inf) into the rows' state:
// the online (max, sum), then the candidates.  cand_v / cand_i: row h = 0's
// list (row h = 1's is 8 * kCapT further); floor: row h = 0's floor in
// global memory.  Called by whole warps.
template <bool kWindow, int kCapT, bool kSorted, typename T>
__device__ __forceinline__ void select_tile(const T (&sv)[64], int col0, int vocab, int k,
                                            RowPair& st, float* cand_v, int* cand_i, int* floor,
                                            int t, unsigned quad) {
  float cm[2], wv[2];
  int wi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float cmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      cmax = fmaxf(cmax, fmaxf(value(sv[4 * i + 2 * h]), value(sv[4 * i + 2 * h + 1])));
    }
    cm[h] = cmax;
    if (cmax > -INFINITY) {
      const float m_new = fmaxf(st.m[h], cmax);
      float l = st.l[h] * expf(st.m[h] - m_new);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        l += expf(value(sv[4 * i + 2 * h]) - m_new);
        l += expf(value(sv[4 * i + 2 * h + 1]) - m_new);
      }
      st.m[h] = m_new;
      st.l[h] = l;
    }
    if constexpr (kWindow) {
      // the tile is one window: its top-1, the highest column on ties --
      // the thread's highest column holding its maximum (columns rise with
      // j), then the quad's
      uint32_t at_max = 0u;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if (value(sv[4 * (j >> 1) + 2 * h + (j & 1)]) == cmax) at_max |= 1u << j;
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
    const bool lv = h ? st.live[1] : st.live[0];
    float tv = h ? st.tv[1] : st.tv[0];
    int ti = h ? st.ti[1] : st.ti[0];
    int c = h ? st.cnt[1] : st.cnt[0];
    int srt = h ? st.srt[1] : st.srt[0];
    float* rbv = cand_v + 8 * h * kCapT;
    int* rbi = cand_i + 8 * h * kCapT;
    if constexpr (kWindow) {
      const float v = h ? wv[1] : wv[0];
      const int id = h ? wi[1] : wi[0];
      if (lv && id >= 0 && ranks_before(v, id, tv, ti)) {  // quad-uniform
        if (c == kCapT) compact_row<kCapT, kSorted>(rbv, rbi, c, k, tv, ti, t, quad, srt);
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
      const float fl = key_value(h ? st.floor_key[1] : st.floor_key[0]);
      if (!__any_sync(0xffffffffu, lv && cmax >= tv && cmax >= fl)) continue;
      float rv[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int x = 4 * (j >> 1) + (j & 1);
        rv[j] = value(h ? sv[x + 2] : sv[x]);
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
        const int space = kCapT - c;
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
          compact_row<kCapT, kSorted>(rbv, rbi, c, k, tv, ti, t, quad, srt);
          if (t == 0 && c == k) atomicMax(floor + 8 * h, order_key(tv));
        }
        __syncwarp();
      }
    }
    if (h) {
      st.tv[1] = tv;
      st.ti[1] = ti;
      st.cnt[1] = c;
      st.srt[1] = srt;
    } else {
      st.tv[0] = tv;
      st.ti[0] = ti;
      st.cnt[0] = c;
      st.srt[0] = srt;
    }
  }
}

// The rows' (max, sum) over their quads and their candidates in rank order,
// written as run entry o0 (row h = 0; row h = 1 is 8 further) of the parts.
template <int kCapT, bool kSorted>
__device__ __forceinline__ void select_finish(RowPair& st, float* cand_v, int* cand_i, int k,
                                              int t, unsigned quad, float* part_m, float* part_l,
                                              float* part_v, int32_t* part_i, size_t o0) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, st.m[h], o);
      const float ol = __shfl_xor_sync(0xffffffffu, st.l[h], o);
      const float mm = fmaxf(st.m[h], om);
      float l = 0.f;
      if (st.m[h] > -INFINITY) l += st.l[h] * expf(st.m[h] - mm);
      if (om > -INFINITY) l += ol * expf(om - mm);
      st.m[h] = mm;
      st.l[h] = l;
    }
  }
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    if (!(h ? st.live[1] : st.live[0])) continue;  // quad-uniform
    float tv = h ? st.tv[1] : st.tv[0];
    int ti = h ? st.ti[1] : st.ti[0];
    int c = h ? st.cnt[1] : st.cnt[0];
    int srt = h ? st.srt[1] : st.srt[0];
    float* rbv = cand_v + 8 * h * kCapT;
    int* rbi = cand_i + 8 * h * kCapT;
    compact_row<kCapT, kSorted>(rbv, rbi, c, k, tv, ti, t, quad, srt);
    const size_t o = o0 + 8 * h;
    if (t == 0) {
      part_m[o] = h ? st.m[1] : st.m[0];
      part_l[o] = h ? st.l[1] : st.l[0];
    }
    for (int i = t; i < k; i += 4) {
      part_v[o * k + i] = i < c ? rbv[i] : -INFINITY;
      part_i[o * k + i] = i < c ? rbi[i] : INT32_MAX;
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 exact/window select: 64 hidden rows a block, 128-column tiles,
// 64-deep slices; each warpgroup owns the ring's slots of its parity.

constexpr int kSRows = 64;
constexpr int kSCols = 128;
constexpr int kSDepth = 64;
constexpr int kSSlice = kSCols * kSDepth * 2;  // 16384 bytes
constexpr int kSSide = kSCols * 4;             // a tile's bias beside its last slice

// Alignment slack, the 64 resident hidden rows in 64-deep blocks, `stages`
// slots with a tile's biases beside each, the candidate lists (`cap`
// entries a row) of both warpgroups' 64 rows, the barriers (a full barrier
// a slot for each warpgroup, an empty barrier a slot, the rows' barrier).
size_t select_smem_bytes(int d, int stages, int cap) {
  const int nkb = (d + kSDepth - 1) / kSDepth;
  return 1024 + static_cast<size_t>(nkb) * kSRows * 128 + static_cast<size_t>(stages) *
         (kSSlice + kSSide) + 2 * kSRows * cap * 8 + (3 * stages + 1) * sizeof(uint64_t);
}

// As many slots as fit, up to eight: the producer runs that many slices
// ahead of the products.  Slice s goes to slot s % stages.  With the
// narrow lists (kCap) the count is even, so each warpgroup keeps the slots
// of its own parity.  The wide lists (kCapWide) take any count, so that
// three fit at D = 1024 where two would leave each warpgroup one; an odd
// count makes a slot serve the two warpgroups in turn.  A warpgroup then
// skips the other's uses of a slot, so each slot has a full barrier for
// each warpgroup: a barrier's parity names one of two phases, and a wait
// that skipped one would pass on the other warpgroup's.
int select_stages(int d, int cap) {
  const int step = cap == kCap ? 2 : 1;
  int stages = kMaxStages;
  while (stages > 0 && select_smem_bytes(d, stages, cap) > kMaxSmem) stages -= step;
  return stages;
}

template <bool kWindow, int kCapT>
__global__ void __launch_bounds__(kThreads, 1)
select_kernel(const __grid_constant__ CUtensorMap xmap,   // hidden (N, D), 64 x 64 boxes
              const __grid_constant__ CUtensorMap wmap,   // weight (V, D), 64-deep boxes
              const __grid_constant__ CUtensorMap bmap,   // bias (V,) f32, 128-value boxes
              int* __restrict__ row_floor,                // (N,), order_key, exact only
              float* __restrict__ part_m,                 // (2 runs, N)
              float* __restrict__ part_l,                 // (2 runs, N)
              float* __restrict__ part_v,                 // (2 runs, N, k)
              int32_t* __restrict__ part_i,               // (2 runs, N, k)
              int n, int d, int vocab, int k, int stages) {
  extern __shared__ unsigned char smem_raw[];
  const int nkb = (d + kSDepth - 1) / kSDepth;
  unsigned char* xs = align_1024(smem_raw);                 // [nkb][64 rows][128 B], swizzled
  unsigned char* ring = xs + nkb * kSRows * 128;            // [slot][128 cols][128 B], swizzled
  unsigned char* side = ring + stages * kSSlice;            // [slot][bias 128] f32
  float* cand_v = reinterpret_cast<float*>(side + stages * kSSide);  // [2 x 64 rows][kCapT]
  int* cand_i = reinterpret_cast<int*>(cand_v + 2 * kSRows * kCapT);
  uint64_t* full = reinterpret_cast<uint64_t*>(cand_i + 2 * kSRows * kCapT);  // [slot][warpgroup]
  uint64_t* empty = full + 2 * stages;
  uint64_t* xfull = empty + stages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * kSRows;
  const int ntiles = (vocab + kSCols - 1) / kSCols;
  const int t_begin = static_cast<int>(static_cast<int64_t>(blockIdx.y) * ntiles / gridDim.y);
  const int t_end = static_cast<int>(static_cast<int64_t>(blockIdx.y + 1) * ntiles / gridDim.y);
  // warpgroup w takes tile t_begin + 2 p + w of pair p; slice s of the ring
  // is depth block (s / 2) % nkb of pair (s / 2) / nkb for warpgroup s % 2
  const int npairs = (t_end - t_begin + 1) / 2;
  const int nslices = 2 * npairs * nkb;

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[2 * i], 1);
      mbar_init(&full[2 * i + 1], 1);
      mbar_init(&empty[i], 4);
    }
    mbar_init(xfull, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // producer: the block's rows once, then the slices in ring order, with a
    // tile's last depth block the tile's biases; a warpgroup's missing tile
    // (an odd run) completes its slot's phase without bytes
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0) {
      mbar_expect_tx(xfull, nkb * kSRows * 128);
      for (int kb = 0; kb < nkb; ++kb) {
        tma_load_2d(xs + kb * kSRows * 128, &xmap, xfull, kb * kSDepth, row0);
      }
      int slot = 0, phase = 0;
      for (int s = 0; s < nslices; ++s) {
        if (s >= stages) mbar_wait(&empty[slot], phase ^ 1);
        const int j = s >> 1;
        const int kb = j % nkb;
        const int tile = t_begin + 2 * (j / nkb) + (s & 1);
        uint64_t* f = &full[2 * slot + (s & 1)];
        if (tile < t_end) {
          const bool last = kb == nkb - 1;
          mbar_expect_tx(f, last ? kSSlice + kSSide : kSSlice);
          tma_load_2d(ring + slot * kSSlice, &wmap, f, kb * kSDepth, tile * kSCols);
          if (last) tma_load_1d(side + slot * kSSide, &bmap, f, tile * kSCols);
        } else {
          mbar_arrive(f);
        }
        if (++slot == stages) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = consumer_warpgroup();
  const int w = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  const unsigned quad = 0xFu << (lane & ~3);
  // this thread's rows: block rows 16 w + g + 8 h; its candidate lists are
  // the warpgroup's own
  const int rr = 16 * w + g;
  float* my_cand_v = cand_v + (64 * wg + rr) * kCapT;
  int* my_cand_i = cand_i + (64 * wg + rr) * kCapT;
  int* my_floor = row_floor + row0 + rr;
  RowPair st;
  rows_init(st, row0 + rr, n);
  mbar_wait(xfull, 0);

  float acc[64];
#pragma unroll
  for (int x = 0; x < 64; ++x) acc[x] = 0.f;
  // this warpgroup's slice u is in slot (2 u + wg) % stages: its (u /
  // period)-th use of the slot, on the warpgroup's own full barrier (an odd
  // count shares each slot; an even one leaves each its parity's slots);
  // kept by increments, not by a division and a remainder a slice
  const int period = stages & 1 ? stages : stages / 2;
  int slot = wg, phase = 0, left = period;
  auto advance = [&]() {
    slot += 2;
    if (slot >= stages) slot -= stages;
    if (--left == 0) {
      left = period;
      phase ^= 1;
    }
  };
  auto full_of = [&](int at) { return &full[2 * at + wg]; };
  for (int p = 0; p < npairs; ++p) {
    const int tile = t_begin + 2 * p + wg;
    if (tile >= t_end) {  // warpgroup-uniform
      for (int kb = 0; kb < nkb; ++kb) {
        mbar_wait(full_of(slot), phase);
        release(empty, slot);
        advance();
      }
      continue;
    }
    for (int kb = 0; kb < nkb; ++kb) {
      mbar_wait(full_of(slot), phase);
      if (!kWindow && kb == 0) read_floors(st, my_floor);
#pragma unroll
      for (int x = 0; x < 64; ++x) fence_operand(acc[x]);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wgmma_m64n128k16_bf16_ss(acc, desc_sw128(xs + kb * kSRows * 128 + 32 * j),
                                 desc_sw128(ring + slot * kSSlice + 32 * j), (kb | j) != 0);
      }
      wgmma_commit();
      if (kb != nkb - 1) {
        wgmma_wait<0>();
#pragma unroll
        for (int x = 0; x < 64; ++x) fence_operand(acc[x]);
        release(empty, slot);
        advance();
        continue;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int x = 0; x < 64; ++x) fence_operand(acc[x]);

      // tile complete: d[4 i + 2 h + e] is row rr + 8 h, column col0 + 8 i +
      // 2 t + e; the logits replace the sums in place, since the next
      // tile's first product overwrites them; the slot (its biases) is
      // released after them
      const int col0 = tile * kSCols;
      const float* b_tile = reinterpret_cast<const float*>(side + slot * kSSide);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float2 bp = *reinterpret_cast<const float2*>(b_tile + 8 * i + 2 * t);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool valid = col0 + 8 * i + 2 * t + e < vocab;
          const float bcol = e ? bp.y : bp.x;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int x = 4 * i + 2 * h + e;
            acc[x] = valid ? __fadd_rn(acc[x], bcol) : -INFINITY;
          }
        }
      }
      release(empty, slot);
      advance();
      select_tile<kWindow, kCapT, kCapT == kCapWide>(acc, col0, vocab, k, st, my_cand_v,
                                                     my_cand_i, my_floor, t, quad);
    }
  }
  // each warpgroup's state is a run of its own: entry 2 y + wg
  select_finish<kCapT, kCapT == kCapWide>(st, my_cand_v, my_cand_i, k, t, quad, part_m, part_l,
                                          part_v, part_i,
                                          (2 * static_cast<size_t>(blockIdx.y) + wg) * n +
                                              row0 + rr);
}

template <bool kWindow, int kCapT>
int launch_select_cap(const void* x, const void* weight, const void* bias, void* row_floor,
                      void* part_m, void* part_l, void* part_v, void* part_i, void* lp,
                      void* ids, void* lse, int n, int d, int vocab, int k, int runs,
                      void* stream) {
  const int stages = select_stages(d, kCapT);
  const size_t smem = select_smem_bytes(d, stages, kCapT);
  const int ntiles = (vocab + kSCols - 1) / kSCols;
  if (n < 1 || vocab < 1 || d % 32 != 0 || stages < 2 || smem > kMaxSmem ||
      !select_k_ok(k, 2 * runs) || runs < 1 || runs > ntiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap xmap, wmap, bmap;
  cudaError_t err = encode_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, d, n, kSDepth,
                              kSRows, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess) {
    err = encode_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, weight, d, vocab, kSDepth,
                    kSCols, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err == cudaSuccess) err = encode_1d_f32(&bmap, bias, vocab, kSCols);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = select_kernel<kWindow, kCapT>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // every row's floor starts below every value (order_key 0x80808080)
  err = cudaMemsetAsync(row_floor, 0x80, static_cast<size_t>(n) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // row tiles vary fastest, so the blocks of one run are scheduled together
  const dim3 grid((n + kSRows - 1) / kSRows, runs);
  kernel<<<grid, kThreads, smem, s>>>(
      xmap, wmap, bmap, static_cast<int*>(row_floor), static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_v), static_cast<int32_t*>(part_i), n,
      d, vocab, k, stages);
  return select_merge(part_m, part_l, part_v, part_i, lp, ids, lse, n, k, 2 * runs, s);
}

// k <= 16 on the narrow lists, 17-40 on the wide ones.
template <bool kWindow>
int launch_select(const void* x, const void* weight, const void* bias, void* row_floor,
                  void* part_m, void* part_l, void* part_v, void* part_i, void* lp, void* ids,
                  void* lse, int n, int d, int vocab, int k, int runs, void* stream) {
  auto launch = k <= kTopK ? launch_select_cap<kWindow, kCap>
                           : launch_select_cap<kWindow, kCapWide>;
  return launch(x, weight, bias, row_floor, part_m, part_l, part_v, part_i, lp, ids, lse, n, d,
                vocab, k, runs, stream);
}

// ---------------------------------------------------------------------------
// The int8 exact/window select: 128 hidden rows a block (64 a warpgroup,
// both on the same tile), 128-column tiles, 128-deep int8 slices.

namespace q8 {

constexpr int kSRows = 128;
constexpr int kSCols = 128;
constexpr int kSDepth = 128;
constexpr int kSStages = 4;      // with the narrow lists
constexpr int kSStagesWide = 3;  // with the wide lists (kCapWide), which take the fourth
constexpr int kSSlice = kSCols * kSDepth;  // 16384 bytes
constexpr int kSSide = kSCols * 8;         // a tile's ws and bias beside its last slice

size_t select_smem_bytes(int d, int stages, int cap) {
  const int nkb = (d + kSDepth - 1) / kSDepth;
  return 1024 + static_cast<size_t>(nkb) * kSRows * kSDepth + stages * (kSSlice + kSSide) +
         static_cast<size_t>(kSRows) * cap * 8 + (2 * stages + 1) * sizeof(uint64_t);
}

template <bool kWindow, int kCapT, int kStages>
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
  unsigned char* side = ring + kStages * kSSlice;          // [stage][ws 128, bias 128] f32
  float* cand_v = reinterpret_cast<float*>(side + kStages * kSSide);  // [128 rows][kCapT]
  int* cand_i = reinterpret_cast<int*>(cand_v + kSRows * kCapT);
  uint64_t* full = reinterpret_cast<uint64_t*>(cand_i + kSRows * kCapT);
  uint64_t* empty = full + kStages;
  uint64_t* xfull = empty + kStages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * kSRows;
  const int ntiles = (vocab + kSCols - 1) / kSCols;
  const int t_begin = static_cast<int>(static_cast<int64_t>(blockIdx.y) * ntiles / gridDim.y);
  const int t_end = static_cast<int>(static_cast<int64_t>(blockIdx.y + 1) * ntiles / gridDim.y);
  const int nslices = (t_end - t_begin) * nkb;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
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
        const int slot = s % kStages;
        if (s >= kStages) mbar_wait(&empty[slot], ((s / kStages) - 1) & 1);
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
  const int wg = consumer_warpgroup();
  const int w = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  const unsigned quad = 0xFu << (lane & ~3);
  // this thread's rows: block rows 64 wg + 16 w + g + 8 h, h = 0, 1
  const int rb = 64 * wg + 16 * w + g;
  const bool wg_live = row0 + 64 * wg < n;  // warpgroup-uniform
  RowPair st;
  rows_init(st, row0 + rb, n);
  float xsr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) xsr[h] = st.live[h] ? xscale[row0 + rb + 8 * h] : 0.f;
  mbar_wait(xfull, 0);

  int acc[64];
#pragma unroll
  for (int x = 0; x < 64; ++x) acc[x] = 0;
  for (int s = 0; s < nslices; ++s) {
    const int slot = s % kStages;
    const int kb = s % nkb;
    mbar_wait(&full[slot], (s / kStages) & 1);
    if (!kWindow && kb == 0) read_floors(st, row_floor + row0 + rb);
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
      release(empty, slot);
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
    release(empty, slot);
    select_tile<kWindow, kCapT, kCapT == kCapWide>(acc, col0, vocab, k, st, cand_v + rb * kCapT,
                                                   cand_i + rb * kCapT, row_floor + row0 + rb,
                                                   t, quad);
  }
  select_finish<kCapT, kCapT == kCapWide>(st, cand_v + rb * kCapT, cand_i + rb * kCapT, k, t,
                                          quad, part_m, part_l, part_v, part_i,
                                          static_cast<size_t>(blockIdx.y) * n + row0 + rb);
}

template <bool kWindow, int kCapT, int kStages>
int launch_select_cap(const void* xq, const void* xscale, const void* weight, const void* wscale,
                      const void* bias, void* row_floor, void* part_m, void* part_l,
                      void* part_v, void* part_i, void* lp, void* ids, void* lse, int n, int d,
                      int vocab, int k, int runs, void* stream) {
  const size_t smem = select_smem_bytes(d, kStages, kCapT);
  const int ntiles = (vocab + kSCols - 1) / kSCols;
  if (n < 1 || vocab < 1 || d % 64 != 0 || smem > kMaxSmem || !select_k_ok(k, runs) ||
      runs < 1 || runs > ntiles) {
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
  auto kernel = select_kernel<kWindow, kCapT, kStages>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // every row's floor starts below every value (order_key 0x80808080)
  err = cudaMemsetAsync(row_floor, 0x80, static_cast<size_t>(n) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // row tiles vary fastest, so the blocks of one run are scheduled together
  const dim3 grid((n + kSRows - 1) / kSRows, runs);
  kernel<<<grid, kThreads, smem, s>>>(
      xmap, wmap, wsmap, bmap, static_cast<const float*>(xscale),
      static_cast<int*>(row_floor), static_cast<float*>(part_m),
      static_cast<float*>(part_l),
      static_cast<float*>(part_v), static_cast<int32_t*>(part_i), n, d, vocab, k);
  return select_merge(part_m, part_l, part_v, part_i, lp, ids, lse, n, k, runs, s);
}

template <bool kWindow>
int launch_select(const void* xq, const void* xscale, const void* weight, const void* wscale,
                  const void* bias, void* row_floor, void* part_m, void* part_l, void* part_v,
                  void* part_i, void* lp, void* ids, void* lse, int n, int d, int vocab, int k,
                  int runs, void* stream) {
  auto launch = k <= kTopK ? launch_select_cap<kWindow, kCap, kSStages>
                           : launch_select_cap<kWindow, kCapWide, kSStagesWide>;
  return launch(xq, xscale, weight, wscale, bias, row_floor, part_m, part_l, part_v, part_i, lp,
                ids, lse, n, d, vocab, k, runs, stream);
}

}  // namespace q8

// ---------------------------------------------------------------------------
// The float32 exact/window select (row 5 for a float32 model): 64 hidden
// rows a block, 128-column tiles, 32-deep f32 slices on the 3xTF32 tile of
// csrc/tf32x3_wgmma.cuh.  The two warpgroups take alternate tiles of the
// run, each with the ring's slots of its parity, its own candidate lists,
// and its state written as a run of its own, as the bf16 select's.  A slot
// holds a tile's 128 table rows (two 64-row boxes: wgmma's M side, split in
// registers), the block's hidden hi and lo boxes (its N side, split before
// the walk) and, beside a tile's last slice, the tile's biases.  The
// accumulators hold a tile as (table row, hidden row); at the tile's end the
// warpgroup writes them into its slot (32 KB: the slot's boxes, read by
// then) as (hidden row, column) and reads them back as select_tile's
// m64n128 layout, so the epilogue is the bf16 select's.

namespace f32 {

constexpr int kSRows = 64;
constexpr int kSCols = 128;
constexpr int kBox = tf32x3::kBox;
constexpr int kSSlot = 4 * kBox;     // two table boxes, hidden hi, hidden lo: 32 KB
constexpr int kSSide = kSCols * 4;   // a tile's bias beside its last slice

size_t select_smem_bytes(int stages, int cap) {
  return 1024 + static_cast<size_t>(stages) * (kSSlot + kSSide) + 2 * kSRows * cap * 8 +
         2 * stages * sizeof(uint64_t);
}

// As many slots as fit, up to eight, an even number (each warpgroup the
// same): six with the narrow lists, four with the wide ones.  (Five slots
// that serve the warpgroups in turn, as the bf16 select's wide instance
// has them, made the window select 4% slower: PERF.md, PR 30.)
int select_stages(int cap) {
  int stages = kMaxStages;
  while (stages > 0 && select_smem_bytes(stages, cap) > kMaxSmem) stages -= 2;
  return stages;
}

// The float index in a slot of the transposed tile's (hidden row r, column
// c): rows of 128 floats, c's bits 3-4 XORed by r's bits so that the
// column-wise writes and the pairwise reads hit distinct banks.
__device__ __forceinline__ int tposed(int r, int c) {
  const int swz = ((r >> 1) & 1) | ((((r >> 2) ^ r) & 1) << 1);
  return r * kSCols + (c ^ (swz << 3));
}

// A barrier among the four warps of consumer warpgroup wg (ids 2 and 3).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// The epilogue out of line for the wide lists: inlined, its candidate
// loop's registers made ptxas keep 52 of the tile's accumulators in local
// memory across every slice's products (a store and a load of each a
// slice): 11.83-12.43 ms at k = 17-40 against 5.86-7.04 out of line.
template <bool kWindow, int kCapT>
__device__ __noinline__ void select_tile_wide(const float (&sv)[64], int col0, int vocab, int k,
                                              RowPair& st, float* cand_v, int* cand_i,
                                              int* floor, int t, unsigned quad) {
  select_tile<kWindow, kCapT, false>(sv, col0, vocab, k, st, cand_v, cand_i, floor, t, quad);
}

template <bool kWindow, int kCapT>
__global__ void __launch_bounds__(kThreads, 1)
select_kernel(const __grid_constant__ CUtensorMap wmap,   // weight (V, D), 128-row boxes
              const __grid_constant__ CUtensorMap himap,  // hidden hi (N, D), 64-row boxes
              const __grid_constant__ CUtensorMap lomap,  // hidden lo (N, D)
              const __grid_constant__ CUtensorMap bmap,   // bias (V,) f32, 128-value boxes
              int* __restrict__ row_floor,                // (N,), order_key, exact only
              float* __restrict__ part_m,                 // (2 runs, N)
              float* __restrict__ part_l,                 // (2 runs, N)
              float* __restrict__ part_v,                 // (2 runs, N, k)
              int32_t* __restrict__ part_i,               // (2 runs, N, k)
              int n, int d, int vocab, int k, int stages) {
  extern __shared__ unsigned char smem_raw[];
  const int nk = (d + tf32x3::kDepth - 1) / tf32x3::kDepth;
  unsigned char* ring = align_1024(smem_raw);               // [slot][table 2 boxes, hi, lo]
  unsigned char* side = ring + stages * kSSlot;             // [slot][bias 128] f32
  float* cand_v = reinterpret_cast<float*>(side + stages * kSSide);  // [2 x 64 rows][kCapT]
  int* cand_i = reinterpret_cast<int*>(cand_v + 2 * kSRows * kCapT);
  uint64_t* full = reinterpret_cast<uint64_t*>(cand_i + 2 * kSRows * kCapT);
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * kSRows;
  const int ntiles = (vocab + kSCols - 1) / kSCols;
  const int t_begin = static_cast<int>(static_cast<int64_t>(blockIdx.y) * ntiles / gridDim.y);
  const int t_end = static_cast<int>(static_cast<int64_t>(blockIdx.y + 1) * ntiles / gridDim.y);
  // warpgroup w takes tile t_begin + 2 p + w of pair p; slice s of the ring
  // is depth slice (s / 2) % nk of pair (s / 2) / nk for warpgroup s % 2
  const int npairs = (t_end - t_begin + 1) / 2;
  const int nslices = 2 * npairs * nk;

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // producer: the slices in ring order, with a tile's last slice the
    // tile's biases; a warpgroup's missing tile (an odd run) completes its
    // slot's phase without bytes
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0) {
      int slot = 0, phase = 0;
      for (int s = 0; s < nslices; ++s) {
        if (s >= stages) mbar_wait(&empty[slot], phase ^ 1);
        const int j = s >> 1;
        const int kb = j % nk;
        const int tile = t_begin + 2 * (j / nk) + (s & 1);
        uint64_t* f = &full[slot];
        if (tile < t_end) {
          const bool last = kb == nk - 1;
          const int kk = kb * tf32x3::kDepth;
          unsigned char* dst = ring + slot * kSSlot;
          mbar_expect_tx(f, last ? kSSlot + kSSide : kSSlot);
          tma_load_2d(dst, &wmap, f, kk, tile * kSCols);
          tma_load_2d(dst + 2 * kBox, &himap, f, kk, row0);
          tma_load_2d(dst + 3 * kBox, &lomap, f, kk, row0);
          if (last) tma_load_1d(side + slot * kSSide, &bmap, f, tile * kSCols);
        } else {
          mbar_arrive(f);
        }
        if (++slot == stages) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = consumer_warpgroup();
  const int w = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  const unsigned quad = 0xFu << (lane & ~3);
  // this thread's rows in the select layout: block rows 16 w + g + 8 h; its
  // candidate lists are the warpgroup's own
  const int rr = 16 * w + g;
  float* my_cand_v = cand_v + (64 * wg + rr) * kCapT;
  int* my_cand_i = cand_i + (64 * wg + rr) * kCapT;
  int* my_floor = row_floor + row0 + rr;
  RowPair st;
  rows_init(st, row0 + rr, n);

  float acc[2][32], part[32];
  int slot = wg, phase = 0;
  auto advance = [&]() {
    slot += 2;
    if (slot >= stages) {
      slot -= stages;
      phase ^= 1;
    }
  };
  for (int p = 0; p < npairs; ++p) {
    const int tile = t_begin + 2 * p + wg;
    if (tile >= t_end) {  // warpgroup-uniform
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(&full[slot], phase);
        release(empty, slot);
        advance();
      }
      continue;
    }
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(&full[slot], phase);
      if (!kWindow && kb == 0) read_floors(st, my_floor);
      unsigned char* box = ring + slot * kSSlot;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        tf32x3::slice_products(part, box + x * kBox, box + 2 * kBox, box + 3 * kBox, w, lane);
#pragma unroll
        for (int y = 0; y < 32; ++y) acc[x][y] = kb ? __fadd_rn(acc[x][y], part[y]) : part[y];
      }
      if (kb != nk - 1) {
        release(empty, slot);
        advance();
        continue;
      }
      // tile complete: acc[x][4 i + 2 h + e] is column 64 x + 16 w + g + 8 h
      // of the tile, hidden row 8 i + 2 t + e; through the slot into the
      // select layout sv[4 i + 2 h + e]: row rr + 8 h, column 8 i + 2 t + e
      float* tp = reinterpret_cast<float*>(box);
      warpgroup_sync(wg);  // every warp's products of the slot are done
#pragma unroll
      for (int x = 0; x < 2; ++x) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              tp[tposed(8 * i + 2 * t + e, 64 * x + 16 * w + g + 8 * h)] = acc[x][4 * i + 2 * h + e];
            }
          }
        }
      }
      warpgroup_sync(wg);
      const int col0 = tile * kSCols;
      const float* b_tile = reinterpret_cast<const float*>(side + slot * kSSide);
      float sv[64];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float2 bp = *reinterpret_cast<const float2*>(b_tile + 8 * i + 2 * t);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 s2 = *reinterpret_cast<const float2*>(tp + tposed(rr + 8 * h, 8 * i + 2 * t));
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool valid = col0 + 8 * i + 2 * t + e < vocab;
            sv[4 * i + 2 * h + e] =
                valid ? __fadd_rn(e ? s2.y : s2.x, e ? bp.y : bp.x) : -INFINITY;
          }
        }
      }
      // the slot's next bytes come by TMA after these generic accesses
      fence_proxy_async();
      release(empty, slot);
      advance();
      if constexpr (kCapT == kCapWide) {
        select_tile_wide<kWindow, kCapT>(sv, col0, vocab, k, st, my_cand_v, my_cand_i, my_floor,
                                         t, quad);
      } else {
        select_tile<kWindow, kCapT, false>(sv, col0, vocab, k, st, my_cand_v, my_cand_i,
                                           my_floor, t, quad);
      }
    }
  }
  // each warpgroup's state is a run of its own: entry 2 y + wg
  select_finish<kCapT, false>(st, my_cand_v, my_cand_i, k, t, quad, part_m, part_l, part_v,
                              part_i, (2 * static_cast<size_t>(blockIdx.y) + wg) * n + row0 + rr);
}

template <bool kWindow, int kCapT>
int launch_select_cap(const void* x, const void* weight, const void* bias, void* xsplit,
                      void* row_floor, void* part_m, void* part_l, void* part_v, void* part_i,
                      void* lp, void* ids, void* lse, int n, int d, int vocab, int k, int runs,
                      void* stream) {
  const int stages = select_stages(kCapT);
  const size_t smem = select_smem_bytes(stages, kCapT);
  const int ntiles = (vocab + kSCols - 1) / kSCols;
  if (n < 1 || vocab < 1 || d < 4 || d % 4 != 0 || stages < 2 || smem > kMaxSmem ||
      !select_k_ok(k, 2 * runs) || runs < 1 || runs > ntiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = tf32x3::split_rows(x, xsplit, n, d, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* lo = static_cast<const float*>(xsplit) + static_cast<size_t>(n) * d;
  CUtensorMap wmap, himap, lomap, bmap;
  err = tf32x3::encode_rows(&wmap, weight, vocab, d, kSCols);
  if (err == cudaSuccess) err = tf32x3::encode_rows(&himap, xsplit, n, d, kSRows);
  if (err == cudaSuccess) err = tf32x3::encode_rows(&lomap, lo, n, d, kSRows);
  if (err == cudaSuccess) err = encode_1d_f32(&bmap, bias, vocab, kSCols);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = select_kernel<kWindow, kCapT>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // every row's floor starts below every value (order_key 0x80808080)
  err = cudaMemsetAsync(row_floor, 0x80, static_cast<size_t>(n) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // row tiles vary fastest, so the blocks of one run are scheduled together
  const dim3 grid((n + kSRows - 1) / kSRows, runs);
  kernel<<<grid, kThreads, smem, s>>>(
      wmap, himap, lomap, bmap, static_cast<int*>(row_floor), static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_v), static_cast<int32_t*>(part_i), n,
      d, vocab, k, stages);
  return select_merge(part_m, part_l, part_v, part_i, lp, ids, lse, n, k, 2 * runs, s);
}

template <bool kWindow>
int launch_select(const void* x, const void* weight, const void* bias, void* xsplit,
                  void* row_floor, void* part_m, void* part_l, void* part_v, void* part_i,
                  void* lp, void* ids, void* lse, int n, int d, int vocab, int k, int runs,
                  void* stream) {
  auto launch = k <= kTopK ? launch_select_cap<kWindow, kCap>
                           : launch_select_cap<kWindow, kCapWide>;
  return launch(x, weight, bias, xsplit, row_floor, part_m, part_l, part_v, part_i, lp, ids, lse,
                n, d, vocab, k, runs, stream);
}

}  // namespace f32

}  // namespace

// buckets: the chunk width (512 unless bucket_bv is set), any width >= 1.
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

// The exact/window select on bf16 operands (window != 0 selects "window");
// row_floor (N,) int32 scratch; the parts hold 2 * runs entries a row.
extern "C" int mic_fused_head_select_bf16(void* hidden, void* weight, void* bias,
                                          void* row_floor, void* part_m, void* part_l,
                                          void* part_v, void* part_i, void* lp, void* ids,
                                          void* lse, int n, int d, int vocab, int k, int runs,
                                          int window, void* stream) {
  auto launch = window ? launch_select<true> : launch_select<false>;
  return launch(hidden, weight, bias, row_floor, part_m, part_l, part_v, part_i, lp, ids, lse, n,
                d, vocab, k, runs, stream);
}

// The exact/window select on float32 hidden rows and table (row 5 for a
// float32 model): xsplit (2, N, D) f32 scratch for the hidden rows' TF32 hi
// and lo; the rest as mic_fused_head_select_bf16's, D a multiple of 4.
extern "C" int mic_fused_head_select_f32(void* hidden, void* weight, void* bias, void* xsplit,
                                         void* row_floor, void* part_m, void* part_l,
                                         void* part_v, void* part_i, void* lp, void* ids,
                                         void* lse, int n, int d, int vocab, int k, int runs,
                                         int window, void* stream) {
  auto launch = window ? f32::launch_select<true> : f32::launch_select<false>;
  return launch(hidden, weight, bias, xsplit, row_floor, part_m, part_l, part_v, part_i, lp, ids,
                lse, n, d, vocab, k, runs, stream);
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
