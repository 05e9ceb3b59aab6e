// A 128 x 256 output tile of C = A @ B on wgmma fed by TMA, for the fused
// MLP (fused_mlp.cu): A (M, K) row-major bf16, the activations, read K-major;
// B (K, N) row-major bf16, the (in, out) weights as stored, read MN-major
// (desc_sw128_mn with wgmma's transpose bit), so no transposed copy exists.
//
// A block of kThreads: two consumer warpgroups, each owning 64 rows x 256
// columns (m64n256k16, 128 f32 sums a thread), and a producer warpgroup
// whose first warp issues the TMA loads (head_wgmma.cuh's pipeline).  A
// slice of the depth is 64 deep: two 64 x 64 boxes of A (one per consumer)
// and four 64 x 64 boxes of B, 48 KB, in a ring of kStages slots.  Each
// consumer keeps one product group in flight: it issues slice s's four
// products, waits until slice s - 1's group has retired and only then frees
// that slot (an arrival of CTA scope: one of cluster scope, a release to
// the whole cluster, made the loop some 1.5x slower).  Block (x, y, z) owns
// columns 256 x.., rows 128 y.. and, of the K / 64 slices, [z S / Z,
// (z + 1) S / Z): the caller cuts the depth into Z splits where the output
// tiles alone leave SMs idle, and sums them in split order (split_sum_kernel
// below, which LN -> GEMM's 128 x 192 tile, ln_gemm.cu, shares).  Within a
// block the sum over its slices is one fixed order, and no sum is atomic,
// so reruns are bit-equal.  Rows and columns past the tensors arrive as
// zeros (TMA's out-of-bounds fill); only rows < M and columns < N are
// written.
//
// Shapes the caller guarantees: K % 64 == 0, N % 8 == 0 (TMA's 16-byte
// strides), M >= 1, and at least one slice a split.

#pragma once

#include "head_wgmma.cuh"

namespace {
namespace gemm_wgmma {

using namespace head_wgmma;

constexpr int kBox = 64;                    // rows and bf16 depth of every TMA box
constexpr int kBoxBytes = kBox * kBox * 2;  // 8192
constexpr int kRows = 128;                  // M rows of a block
constexpr int kCols = 256;                  // N columns of a block
constexpr int kStages = 4;
constexpr int kSlot = 6 * kBoxBytes;        // A: two boxes | B: four boxes; 49152
constexpr int kConsumerWarps = 8;           // two warpgroups
constexpr int kThreads = kConsumerWarps * 32 + 128;  // and the producer's warpgroup
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr size_t kSmemBytes = 1024 + kStages * kSlot + 2 * kStages * sizeof(uint64_t);
static_assert(kSmemBytes <= 232448, "the GEMM tile must fit");
constexpr int kStagePitch = kCols + 8;  // f32 of a row of the tile staged in the ring
static_assert(kRows * kStagePitch * 4 <= kStages * kSlot, "the staged tile must fit the ring");

// The 64 x 64 bf16 boxes, 128-byte swizzle, of a row-major (rows, cols) tensor.
inline cudaError_t box_map(CUtensorMap* map, const void* base, int cols, int rows) {
  return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, cols, rows, kBox, kBox,
                   CU_TENSOR_MAP_SWIZZLE_128B);
}

// The block's tile of A (amap: box_map of (M, K)) times B (bmap: box_map of
// (K, N)) over its share of the `depth` / 64 slices, then epi(acc, m_row,
// c0, t) in each consumer thread: acc[4 i + 2 h + e] is the sum of row
// m_row + 8 h, column c0 + 8 i + 2 t + e (i < 32).  Returns false in the
// producer's warpgroup, whose registers are few by then: its threads
// should leave the kernel at once.
template <class Epilogue>
__device__ __forceinline__ bool tile(const CUtensorMap* amap, const CUtensorMap* bmap, int depth,
                                     unsigned char* smem_raw, const Epilogue& epi) {
  unsigned char* ring = align_1024(smem_raw);  // [slot][A: two boxes | B: four]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kSlot);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int c0 = blockIdx.x * kCols;
  const int m0 = blockIdx.y * kRows;
  const int nslices = depth / kBox;
  const int s_begin = static_cast<int>(static_cast<int64_t>(blockIdx.z) * nslices / gridDim.z);
  const int s_end = static_cast<int>(static_cast<int64_t>(blockIdx.z + 1) * nslices / gridDim.z);

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // producer: slice s brings A's rows m0 + 64 x at depth 64 s.. and B's
    // depth rows 64 s.. at columns c0 + 64 b..
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0) {
      int slot = 0, phase = 0;
      for (int s = s_begin; s < s_end; ++s) {
        if (s - s_begin >= kStages) mbar_wait(&empty[slot], phase ^ 1);
        unsigned char* dst = ring + slot * kSlot;
        mbar_expect_tx(&full[slot], kSlot);
        for (int x = 0; x < 2; ++x) {
          tma_load_2d(dst + x * kBoxBytes, amap, &full[slot], kBox * s, m0 + kBox * x);
        }
        for (int b = 0; b < 4; ++b) {
          tma_load_2d(dst + (2 + b) * kBoxBytes, bmap, &full[slot], c0 + kBox * b, kBox * s);
        }
        if (++slot == kStages) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    return false;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = consumer_warpgroup();
  const int w = warp & 3;
  float acc[128];
#pragma unroll
  for (int x = 0; x < 128; ++x) acc[x] = 0.f;
  int slot = 0, phase = 0, prev = 0;
  for (int s = s_begin; s < s_end; ++s) {
    mbar_wait(&full[slot], phase);
    const unsigned char* base = ring + slot * kSlot;
#pragma unroll
    for (int x = 0; x < 128; ++x) fence_operand(acc[x]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wgmma_m64n256k16_bf16_ss_mn(acc, desc_sw128(base + wg * kBoxBytes + 32 * j),
                                  desc_sw128_mn(base + 2 * kBoxBytes + 2048 * j, kBoxBytes), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // slice s - 1's group has retired: its slot is free
#pragma unroll
    for (int x = 0; x < 128; ++x) fence_operand(acc[x]);
    release_if(empty, prev, s > s_begin);
    prev = slot;
    if (++slot == kStages) {
      slot = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int x = 0; x < 128; ++x) fence_operand(acc[x]);
  epi(acc, m0 + 64 * wg + 16 * w + (lane >> 2), c0, lane & 3);
  return true;
}

// tile()'s epilogue of an unsplit tile: the sums into the ring, f32 rows at
// kStagePitch, once both consumer warpgroups' products have retired (the
// caller then reads them back with staged_runs).
struct Stage {
  unsigned char* ring;

  __device__ __forceinline__ void operator()(const float (&acc)[128], int m_row, int c0,
                                             int t) const {
    consumer_sync(kConsumerWarps * 32);
    float* staged = reinterpret_cast<float*>(ring) + (m_row - blockIdx.y * kRows) * kStagePitch;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        *reinterpret_cast<float2*>(staged + 8 * h * kStagePitch + 8 * i + 2 * t) =
            make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
      }
  }
};

// After Stage, in the consumer threads: finish(row, col, v) for each run of
// eight columns col.. of each row < m, col < ncols, v its eight f32 sums.
template <class Finish>
__device__ __forceinline__ void staged_runs(unsigned char* ring, int m, int ncols,
                                            const Finish& finish) {
  const float* staged = reinterpret_cast<const float*>(ring);
  consumer_sync(kConsumerWarps * 32);
  const int m0 = blockIdx.y * kRows;
  const int c0 = blockIdx.x * kCols;
  for (int item = threadIdx.x; item < kRows * (kCols / 8); item += kConsumerWarps * 32) {
    const int r = item / (kCols / 8);
    const int cl = 8 * (item % (kCols / 8));
    if (m0 + r >= m || c0 + cl >= ncols) continue;
    const float4 lo = *reinterpret_cast<const float4*>(staged + r * kStagePitch + cl);
    const float4 hi = *reinterpret_cast<const float4*>(staged + r * kStagePitch + cl + 4);
    const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    finish(m0 + r, c0 + cl, v);
  }
}

// The splits' partials (splits, n, cols) summed in split order, then
// finish(row, col, v) for each run of eight columns, one run a thread.
template <class Finish>
__global__ void split_sum_kernel(const float* __restrict__ part, const Finish finish, int splits,
                                 int n, int cols) {
  const size_t plane = static_cast<size_t>(n) * cols;
  for (size_t run = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; run < plane / 8;
       run += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float v[8];
    for (int z = 0; z < splits; ++z) {
      const float4* p = reinterpret_cast<const float4*>(part + z * plane + 8 * run);
      const float4 lo = p[0];
      const float4 hi = p[1];
      const float x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = z == 0 ? x[j] : v[j] + x[j];
    }
    const int row = static_cast<int>(8 * run / cols);
    finish(row, static_cast<int>(8 * run - static_cast<size_t>(row) * cols), v);
  }
}

// split_sum_kernel's launch over the (n, cols) plane on stream s.
template <class Finish>
cudaError_t split_sum(const float* part, const Finish& finish, int splits, int n, int cols,
                      cudaStream_t s) {
  const size_t runs = static_cast<size_t>(n) * cols / 8;
  const int blocks = static_cast<int>(runs < 1024 * 256 ? (runs + 255) / 256 : 1024);
  split_sum_kernel<Finish><<<blocks, 256, 0, s>>>(part, finish, splits, n, cols);
  return cudaGetLastError();
}

}  // namespace gemm_wgmma
}  // namespace
