// A bf16 x int8 GEMM with per-output-channel scales, dequantised on chip.
//
// Replaces mic_tpu/ops/int8_matmul.py::int8_matmul (_kernel): x (M, K)
// bf16, w_q (K, N) int8 row-major, scale (N,) f32 ->
//
//   w[k, n]  = bf16( bf16(w_q[k, n]) * bf16(scale[n]) )      (one rounding)
//   out[m, n] = bf16( sum_k x[m, k] * w[k, n] )                (f32 sums)
//
// the TPU kernel's arithmetic.  Any M, K and N: the TPU kernel's pad of N to
// a multiple of 128 and its XLA fallback at M % 8 or K % 128 were tiling
// needs of the TPU and have no counterpart here (the wrapper pads x's rows
// to a multiple of 8 columns where K is not one: TMA's 16-byte strides).
//
// Bound: the int8 weight stream at decode M (M = 4, K = 1024: 256 MB at
// N = 250054, 0.077 ms), the tensor cores at M = 1024 (0.53 ms there).
//
// Design: the transposed product, out^T = W^T x^T, on wgmma with the
// dequantised weight as the register A operand (m64nRk16, R the instance's
// x rows a tile: 8, 64 or 256) and x as B, K-major as stored, by TMA.  A
// tile is 128 weight columns (two consumer warpgroups of 64) by R rows of
// x, walked in slices (128 deep in the 8- and 64-row instances, 64 in the
// 256-row one) through a ring of slots [x boxes | the slice's weight rows,
// 128 bytes each, 128-byte swizzled].  The weight rows come by TMA where
// N % 16 == 0; elsewhere TMA cannot take them (its row strides and box
// starts are 16-byte multiples), and two producer warps copy the aligned
// 16-byte words covering each row's span (cp.async, no byte-wise load)
// into a raw ring and shift each row by its start's offset into its slot
// row.  Each consumer thread reads its weights with ldmatrix.trans (b16
// pairs of bytes: k and k + 1 of columns n and n + 1) and widens them
// exactly to bf16 pairs scaled by the column's bf16 scale, each product
// rounded once as the reference rounds it (widen_scaled; widen and
// mul.rn.bf16x2).  The A rows of a warp are its 16 columns in the order 0,
// 2, .., 14, 1, 3, .., 15, so a thread's two output rows are adjacent
// columns.  A consumer warpgroup widens each slice after its last group
// retired; the two warpgroups' widening and products overlap each other.
// The grid is persistent (the SMs' blocks walk the work items), and where the tiles alone leave SMs idle
// (decode M) the depth is cut into splits (ops/int8_matmul.py::
// int8_matmul_plan): a split writes its f32 sums, and the last split of a
// tile to arrive (a counter a tile, left at 0) adds all of them in split
// order, so reruns are bit-equal.  Columns past N and rows past M are
// computed on zeros or stale weights and never written; depth past K is
// zero in x and in the weights.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "head_wgmma.cuh"

namespace {
namespace dq {

using namespace head_wgmma;
using bf16 = __nv_bfloat16;

constexpr int kCols = 128;                 // weight columns of a tile
constexpr int kConsumerWarps = 8;          // two warpgroups of 64 columns
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kLoaders = 64;               // producer threads bringing weight rows
constexpr int kRaw = 144;                  // the aligned words covering a row's 128 bytes
// the 256-row instance's register split: within the block's allocation at
// launch, 168 a thread (setmaxnreg.inc waits for registers the block lacks)
constexpr int kProducerRegs = 88;
constexpr int kConsumerRegs = 208;
static_assert(kProducerRegs * 128 + kConsumerRegs * kConsumers <= 168 * kThreads,
              "the register split must fit the launch's allocation");

// kRows, the x rows of a tile, and kTma, the weights' path (TMA, or
// cp.async and a realign): the depth of a slice, ring slots,
// and raw weight slices in flight (a consumer's fixed cost a slice, its
// barrier wait, group and release, is what limits the narrow instances:
// they take deeper slices)
template <int kRows, bool kTma> struct Shape;
template <> struct Shape<8, true> { static constexpr int kDepth = 128, kStages = 8, kLoads = 0; };
template <> struct Shape<64, true> { static constexpr int kDepth = 128, kStages = 6, kLoads = 0; };
template <> struct Shape<256, true> { static constexpr int kDepth = 64, kStages = 5, kLoads = 0; };
template <> struct Shape<8, false> { static constexpr int kDepth = 128, kStages = 6, kLoads = 4; };
template <> struct Shape<64, false> { static constexpr int kDepth = 128, kStages = 4, kLoads = 4; };
template <> struct Shape<256, false> { static constexpr int kDepth = 64, kStages = 4, kLoads = 6; };

// A slot: [x boxes, kDepth / 64 of kRows x 128 bytes | weight rows, kDepth x
// 128 bytes], a multiple of 1024 bytes (the swizzle atom)
template <int kRows, bool kTma>
__host__ __device__ constexpr int x_bytes() {
  return Shape<kRows, kTma>::kDepth * kRows * 2;
}
template <int kRows, bool kTma>
__host__ __device__ constexpr int slot_bytes() {
  return x_bytes<kRows, kTma>() + Shape<kRows, kTma>::kDepth * kCols;
}
template <int kRows, bool kTma>
__host__ __device__ constexpr int raw_bytes() {
  return Shape<kRows, kTma>::kLoads * Shape<kRows, kTma>::kDepth * kRaw;
}

// the ring, the raw rows, two barriers a slot and a flag
template <int kRows, bool kTma>
constexpr size_t smem_bytes() {
  return 1024 + Shape<kRows, kTma>::kStages * slot_bytes<kRows, kTma>() +
         raw_bytes<kRows, kTma>() + 2 * Shape<kRows, kTma>::kStages * sizeof(uint64_t) + 16;
}

// ---------------------------------------------------------------------------
// Device helpers.

// d (64 x 8, f32) (+)= a (64 x 16 bf16, registers) . b (8 x 16 bf16, shared,
// K-major); d[2 h + e] is row 16 w + g + 8 h, column 2 t + e.
__device__ __forceinline__ void wgmma_m64n8k16_bf16_rs(float (&d)[4], const uint32_t (&a)[4],
                                                       uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// The tile's product of one k16 step: a (64 weight columns x 16 depth) by
// the x box's rows at desc_b (kRows x 16, K-major).
template <int kRows>
__device__ __forceinline__ void product(float (&acc)[kRows / 2], const uint32_t (&a)[4],
                                        uint64_t desc_b, int accumulate) {
  if constexpr (kRows == 8) {
    wgmma_m64n8k16_bf16_rs(acc, a, desc_b, accumulate);
  } else if constexpr (kRows == 64) {
    wgmma_m64n64k16_bf16_rs(acc, a, desc_b, accumulate);
  } else {
    wgmma_m64n256k16_bf16_rs(acc, a, desc_b, accumulate);
  }
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&d)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr)
               : "memory");
}

// Two bf16 pairs multiplied, each product rounded once to bf16.
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// A word of ldmatrix.trans over int8 rows: bytes (k, n), (k, n + 1),
// (k + 1, n), (k + 1, n + 1).  -> the bf16 pairs (k, k + 1) of column n
// (p0) and of column n + 1 (p1), exactly: each byte, offset to 0..255, is
// the low mantissa byte of 2^23 in f32, 2^23 + 128 is subtracted, and the
// integer's upper half is its bf16.
__device__ __forceinline__ void widen(uint32_t v, uint32_t& p0, uint32_t& p1) {
  const uint32_t u = v ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) -
                           8388736.f);
  }
  p0 = __byte_perm(f[0], f[2], 0x7632);
  p1 = __byte_perm(f[1], f[3], 0x7632);
}

__device__ __forceinline__ uint32_t bf16_pair(float v) {
  const __nv_bfloat162 p = __float2bfloat162_rn(v);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// A thread's two weight columns' scales, s = bf16(scale), in the forms the
// widening takes: (s, s) pairs; and, for the shorter form, (s 2^112, s
// 2^112) and (-128 s, -128 s) pairs, exact where |s| < 2^15 (`fast`).
struct Scales {
  uint32_t s[2], big[2], off[2];
  bool fast;

  __device__ __forceinline__ explicit Scales(const float (&scale)[2]) {
    fast = true;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float b = __bfloat162float(__float2bfloat16_rn(scale[e]));
      s[e] = bf16_pair(b);
      big[e] = bf16_pair(b * 0x1p112f);
      off[e] = bf16_pair(-128.f * b);
      fast = fast && fabsf(b) < 32768.f;
    }
  }
};

// widen's words, widened and scaled with fewer instructions where the
// scales allow: each byte, offset to u = 0..255, is the low mantissa byte
// of 1024 in f16 (a byte permute makes a pair), 1024 is subtracted (the
// integer u, exactly), and the f16 bits shifted right by 3 are the bf16 of
// u 2^-112 (an integer below 256 leaves the low 3 mantissa bits 0); one
// fma.rn.bf16x2 with (s 2^112, -128 s) rounds the exact u s - 128 s = q s
// once, as the reference does.
__device__ __forceinline__ void widen_scaled(uint32_t v, const Scales& sc, uint32_t& p0,
                                             uint32_t& p1) {
  const uint32_t u = v ^ 0x80808080u;
  uint32_t h[2] = {__byte_perm(u, 0x64646464u, 0x4240), __byte_perm(u, 0x64646464u, 0x4341)};
  uint32_t p[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(h[e]) : "r"(h[e]), "r"(0x64006400u));
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
        : "=r"(p[e])
        : "r"(h[e] >> 3), "r"(sc.big[e]), "r"(sc.off[e]));
  }
  p0 = p[0];
  p1 = p[1];
}

// out[row, col] and out[row, col + 1] from their f32 sums; a 4-byte store
// where the pair is whole and aligned (any N), else 2-byte stores.
__device__ __forceinline__ void store_pair(bf16* out, int n, int row, int col, float lo,
                                           float hi) {
  const size_t o = static_cast<size_t>(row) * n + col;
  if (col + 1 < n && (o & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(lo, hi);
  } else if (col < n) {
    out[o] = __float2bfloat16_rn(lo);
    if (col + 1 < n) out[o + 1] = __float2bfloat16_rn(hi);
  }
}

// A work item: tile (row tile fastest, so the row tiles of a weight column
// tile run together and share its weights in L2) and depth split.
struct Item {
  int tile, z, m0, n0, s0, s1;

  __device__ __forceinline__ Item(int item, int splits, int row_tiles, int slices, int rows) {
    tile = item / splits;
    z = item - tile * splits;
    m0 = (tile % row_tiles) * rows;
    n0 = (tile / row_tiles) * kCols;
    s0 = static_cast<int>(static_cast<int64_t>(z) * slices / splits);
    s1 = static_cast<int>(static_cast<int64_t>(z + 1) * slices / splits);
  }
};

// The walk's slices in order: item (tile, split) and slice s of it, and
// `it`, the slice's place in the ring's sequence.
struct Walk {
  int item, s, it;
  Item at;

  __device__ __forceinline__ Walk(int splits, int row_tiles, int slices, int rows)
      : item(blockIdx.x), it(0), at(blockIdx.x, splits, row_tiles, slices, rows) {
    s = at.s0;
  }
  __device__ __forceinline__ void next(int splits, int row_tiles, int slices, int rows) {
    ++it;
    if (++s < at.s1) return;
    item += gridDim.x;
    at = Item(item, splits, row_tiles, slices, rows);
    s = at.s0;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

// ---------------------------------------------------------------------------
// The producer warpgroup, weights by TMA (N % 16 == 0 and w_q 16-byte
// aligned: TMA's 16-byte row strides and box starts).  Warp 0's lanes bring
// each slice's boxes once its slot is free: per 64-deep half, its x box and
// its 64 weight rows of 128 bytes (128-byte swizzled); their bytes complete
// the slot's `full` barrier.
template <int kRows>
__device__ __forceinline__ void produce_tma(const CUtensorMap* xmap, const CUtensorMap* wmap,
                                            int m, int k, int n, int splits, unsigned char* ring,
                                            uint64_t* full, uint64_t* empty) {
  constexpr int kDepth = Shape<kRows, true>::kDepth;
  constexpr int kStages = Shape<kRows, true>::kStages;
  constexpr int kSlot = slot_bytes<kRows, true>();
  constexpr int kXBytes = x_bytes<kRows, true>();
  const int lane = threadIdx.x & 31;
  if (threadIdx.x - kConsumers >= 32) return;
  const int row_tiles = (m + kRows - 1) / kRows;
  const int slices = (k + kDepth - 1) / kDepth;
  const int items = row_tiles * ((n + kCols - 1) / kCols) * splits;
  for (Walk x(splits, row_tiles, slices, kRows); x.item < items;
       x.next(splits, row_tiles, slices, kRows)) {
    const int stage = x.it % kStages;
    if (x.it >= kStages) mbar_wait(&empty[stage], (x.it / kStages - 1) & 1);
    unsigned char* slot = ring + stage * kSlot;
    if (lane == 0) mbar_expect_tx(&full[stage], kXBytes + kDepth * kCols);
    __syncwarp();
    if (lane < kDepth / 64) {
      const int k0 = x.s * kDepth + 64 * lane;
      tma_load_2d(slot + lane * kRows * 128, xmap, &full[stage], k0, x.at.m0);
    } else if (lane < kDepth / 32) {
      const int half = lane - kDepth / 64;
      tma_load_2d(slot + kXBytes + half * 64 * kCols, wmap, &full[stage], x.at.n0,
                  x.s * kDepth + 64 * half);
    }
  }
}

// The producer warpgroup, weights by cp.async (any N and alignment of
// w_q).  Thread 0 brings each slice's x boxes by TMA once its slot is free.
// Warps 1 and 2, the loaders, bring the weights: the aligned 16-byte words
// covering each weight row's columns n0.. (cp.async; none past the
// tensor's last word or for rows >= K) go into a ring of kLoads raw slices,
// kLoads slices ahead of the one realigned, each warp copying the rows it
// realigns; loader r reads its rows r + 64 j from the word holding their
// first byte and funnel-shifts them by the rest of their start's offset
// into the slot's 128-byte swizzled rows (zeros for rows >= K), and
// arrives.  The x boxes' bytes and the 64 loaders' arrivals
// complete the slot's `full` barrier.
template <int kRows>
__device__ __forceinline__ void produce_loads(const CUtensorMap* xmap, const int8_t* w, int m,
                                              int k, int n, int splits, unsigned char* ring,
                                              unsigned char* raw, uint64_t* full,
                                              uint64_t* empty) {
  constexpr int kDepth = Shape<kRows, false>::kDepth;
  constexpr int kStages = Shape<kRows, false>::kStages;
  constexpr int kLoads = Shape<kRows, false>::kLoads;
  constexpr int kSlot = slot_bytes<kRows, false>();
  const int p = threadIdx.x - kConsumers;
  const int row_tiles = (m + kRows - 1) / kRows;
  const int slices = (k + kDepth - 1) / kDepth;
  const int items = row_tiles * ((n + kCols - 1) / kCols) * splits;
  if (p == 0) {
    for (Walk x(splits, row_tiles, slices, kRows); x.item < items;
         x.next(splits, row_tiles, slices, kRows)) {
      const int stage = x.it % kStages;
      if (x.it >= kStages) mbar_wait(&empty[stage], (x.it / kStages - 1) & 1);
      unsigned char* slot = ring + stage * kSlot;
      mbar_expect_tx(&full[stage], x_bytes<kRows, false>());
#pragma unroll
      for (int b = 0; b < kDepth / 64; ++b) {
        tma_load_2d(slot + b * kRows * 128, xmap, &full[stage], x.s * kDepth + 64 * b, x.at.m0);
      }
    }
    return;
  }
  if (p < 32 || p >= 32 + kLoaders) return;
  const int r = p - 32;
  // one past the tensor's last aligned word: a word holding a byte of the
  // tensor lies in its allocation's pages
  const uintptr_t end = (reinterpret_cast<uintptr_t>(w) + static_cast<size_t>(k) * n + 15) &
                        ~static_cast<uintptr_t>(15);
  auto row_start = [&](const Walk& x, int row) {
    return reinterpret_cast<uintptr_t>(w) + static_cast<size_t>(x.s * kDepth + row) * n + x.at.n0;
  };
  // a warp copies the rows it realigns, 32 of each 64: words 0-7 of row
  // 4 q + lane / 8 by lane % 8 (a warp's copy covers four rows' spans),
  // word 8 of row `lane`
  const int wl = r >> 5;
  const int lane = r & 31;
  const size_t off0 = static_cast<size_t>(32 * wl + (lane >> 3)) * n;
  const size_t off8 = static_cast<size_t>(r) * n;
  const size_t step = static_cast<size_t>(4) * n;
  auto copy = [&](unsigned char* dst, uintptr_t start, int word) {
    const uintptr_t first = start & ~static_cast<uintptr_t>(15);
    const uintptr_t src = first + 16 * word;
    cp_async16(dst, reinterpret_cast<const void*>(src < end ? src : first), src < end ? 16u : 0u);
  };
  auto load = [&](const Walk& x) {
#pragma unroll
    for (int g = 0; g < kDepth / 64; ++g) {
      const int k0 = x.s * kDepth + 64 * g;
      const uintptr_t base = reinterpret_cast<uintptr_t>(w) + static_cast<size_t>(k0) * n + x.at.n0;
      unsigned char* slab = raw + ((x.it % kLoads) * kDepth + 64 * g) * kRaw;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int row = 32 * wl + 4 * q + (lane >> 3);
        if (x.item < items && k0 + row < k) {
          copy(slab + row * kRaw + 16 * (lane & 7), base + off0 + q * step, lane & 7);
        }
      }
      if (x.item < items && k0 + r < k) copy(slab + r * kRaw + 128, base + off8, 8);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  Walk ahead(splits, row_tiles, slices, kRows);
  for (int i = 0; i < kLoads; ++i) {
    load(ahead);
    if (ahead.item < items) ahead.next(splits, row_tiles, slices, kRows);
  }
  for (Walk x(splits, row_tiles, slices, kRows); x.item < items;
       x.next(splits, row_tiles, slices, kRows)) {
    // the warp's copies of slice x are in
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kLoads - 1) : "memory");
    __syncwarp();
    const int stage = x.it % kStages;
    if (x.it >= kStages) mbar_wait(&empty[stage], (x.it / kStages - 1) & 1);
#pragma unroll
    for (int j = 0; j < kDepth / kLoaders; ++j) {
      const int row = r + kLoaders * j;
      // byte o of the raw words is the row's first: read from word o / 4
      // on, then shift by o % 4 bytes
      const int o = static_cast<int>(row_start(x, row) & 15);
      const uint32_t sh = 8u * (o & 3);
      const uint32_t* words = reinterpret_cast<const uint32_t*>(
          raw + ((x.it % kLoads) * kDepth + row) * kRaw) + (o >> 2);
      uint32_t v[33];
#pragma unroll
      for (int i = 0; i < 33; ++i) v[i] = words[i];
      const bool live = x.s * kDepth + row < k;
      unsigned char* dst = ring + stage * kSlot + x_bytes<kRows, false>() + row * 128;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        uint4 chunk = make_uint4(0u, 0u, 0u, 0u);
        if (live) {
          chunk = make_uint4(__funnelshift_r(v[4 * c], v[4 * c + 1], sh),
                             __funnelshift_r(v[4 * c + 1], v[4 * c + 2], sh),
                             __funnelshift_r(v[4 * c + 2], v[4 * c + 3], sh),
                             __funnelshift_r(v[4 * c + 3], v[4 * c + 4], sh));
        }
        *reinterpret_cast<uint4*>(dst + ((c ^ (row & 7)) << 4)) = chunk;
      }
    }
    mbar_arrive(&full[stage]);
    // the warp's raw rows are read: bring the ones kLoads slices on into them
    __syncwarp();
    load(ahead);
    if (ahead.item < items) ahead.next(splits, row_tiles, slices, kRows);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The A operands of a slice's k16 steps for this consumer thread, from the
// slot's weight rows at `base` (+ the thread's ldmatrix offset), widened
// and scaled: by widen_scaled where the warp's scales allow, else widen
// and a mul.rn.bf16x2.
template <int kSteps>
__device__ __forceinline__ void weights(uint32_t (&a)[kSteps][4], uint32_t base,
                                        const Scales& sc) {
#pragma unroll
  for (int q = 0; q < kSteps / 2; ++q) {
    uint32_t raw[4];
    ldsm_x4_trans(raw, base + q * 32 * 128);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t p0, p1;
        if (sc.fast) {
          widen_scaled(raw[2 * kk + h], sc, p0, p1);
        } else {
          widen(raw[2 * kk + h], p0, p1);
          p0 = mul_bf16x2(p0, sc.s[0]);
          p1 = mul_bf16x2(p1, sc.s[1]);
        }
        a[2 * q + kk][2 * h] = p0;
        a[2 * q + kk][2 * h + 1] = p1;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The kernel.

template <int kRows, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap xmap,  // x (M, Kx) bf16, boxes 64 x kRows
          const __grid_constant__ CUtensorMap wmap,  // w_q, boxes 128 x 64 (kTma)
          const int8_t* __restrict__ w,              // (K, N)
          const float* __restrict__ scale,           // (N,)
          bf16* __restrict__ out,                    // (M, N)
          float* __restrict__ part,      // split sums, (splits, tiles, kRows / 8, 256) float4
          unsigned* __restrict__ arrivals,  // (tiles,), 0 between launches
          int m, int k, int n, int splits) {
  constexpr int kDepth = Shape<kRows, kTma>::kDepth;
  constexpr int kStages = Shape<kRows, kTma>::kStages;
  constexpr int kSlot = slot_bytes<kRows, kTma>();
  constexpr int kSteps = kDepth / 16;
  constexpr int kAcc = kRows / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_1024(smem_raw);
  unsigned char* raw = ring + kStages * kSlot;
  uint64_t* full = reinterpret_cast<uint64_t*>(raw + raw_bytes<kRows, kTma>());
  uint64_t* empty = full + kStages;
  int* last = reinterpret_cast<int*>(empty + kStages);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], kTma ? 1 : 1 + kLoaders);
      mbar_init(&empty[i], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    if constexpr (kRows == 256) setmaxnreg_dec<kProducerRegs>();
    if constexpr (kTma) {
      produce_tma<kRows>(&xmap, &wmap, m, k, n, splits, ring, full, empty);
    } else {
      produce_loads<kRows>(&xmap, w, m, k, n, splits, ring, raw, full, empty);
    }
    return;
  }
  if constexpr (kRows == 256) setmaxnreg_inc<kConsumerRegs>();

  const int wg = consumer_warpgroup();
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row_tiles = (m + kRows - 1) / kRows;
  const int tiles = row_tiles * ((n + kCols - 1) / kCols);
  const int slices = (k + kDepth - 1) / kDepth;
  // ldmatrix: lane 8 q + j names row 16 (q >> 1) + 8 (q & 1) + j of each 32
  // of the slice's weight rows, 16-byte chunk 4 wg + w of it (the warp's 16
  // weight columns), swizzled by the row
  const int chunk = 4 * wg + (warp & 3);
  const int lrow = 16 * ((lane >> 3) >> 1) + 8 * ((lane >> 3) & 1) + (lane & 7);
  const uint32_t loff = x_bytes<kRows, kTma>() + lrow * 128 + ((chunk ^ (lane & 7)) << 4);
  // slice `it` is in its slot -> the slot's address
  auto arrived = [&](int it) {
    mbar_wait(&full[it % kStages], (it / kStages) & 1);
    return smem_u32(ring + (it % kStages) * kSlot);
  };
  // this thread's A rows g and g + 8 of an item: weight columns col and
  // col + 1 (their scales loaded an item ahead)
  auto column = [&](int item) {
    return (item / splits / row_tiles) * kCols + 16 * chunk + 2 * g;
  };
  auto scales = [&](int item, float (&sc)[2]) {
    const int col = column(item);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[e] = item < tiles * splits && col + e < n ? __ldg(scale + col + e) : 0.f;
    }
  };

  float acc[kAcc];
  uint32_t a[kSteps][4];
  float sc[2];
  scales(blockIdx.x, sc);
  int it = 0;
  for (int item = blockIdx.x; item < tiles * splits; item += gridDim.x) {
    const Item at(item, splits, row_tiles, slices, kRows);
    const int col = column(item);
    Scales scale_forms(sc);
    // the shorter widening where every lane's scales allow it (the same
    // choice across the warp), in the narrow instances: in the 256-row one
    // its registers spill
    scale_forms.fast = kRows < 256 &&
                       __shfl_sync(0xffffffffu, __all_sync(0xffffffffu, scale_forms.fast), 0);
    scales(item + gridDim.x, sc);
    const int count = at.s1 - at.s0;
    // each slice widened once the last group retired (a widening defining
    // a wgmma's registers while a group is in flight makes ptxas serialize
    // every wgmma, C7513; widening into spare registers and copying them
    // measured no faster): the other warpgroup's products fill the gap
    for (int j = 0; j < count; ++j, ++it) {
      weights(a, arrived(it) + loff, scale_forms);
      const unsigned char* slot = ring + (it % kStages) * kSlot;
#pragma unroll
      for (int x = 0; x < kAcc; ++x) fence_operand(acc[x]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        product<kRows>(acc, a[kk], desc_sw128(slot + (kk >> 2) * kRows * 128 + 32 * (kk & 3)),
                       (j | kk) != 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int x = 0; x < kAcc; ++x) fence_operand(acc[x]);
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) fence_operand(a[kk][q]);
      release(empty, it % kStages);
    }

    if (splits > 1) {
      // this split's sums, then the last split in adds all in split order
      float4* mine = reinterpret_cast<float4*>(part) +
                     (static_cast<size_t>(at.z) * tiles + at.tile) * (kRows / 8) * kConsumers +
                     tid;
#pragma unroll
      for (int x = 0; x < kRows / 8; ++x) {
        mine[x * kConsumers] =
            make_float4(acc[4 * x], acc[4 * x + 1], acc[4 * x + 2], acc[4 * x + 3]);
      }
      __threadfence();
      consumer_sync(kConsumers);
      if (tid == 0) *last = atomicAdd(arrivals + at.tile, 1u) == static_cast<unsigned>(splits - 1);
      consumer_sync(kConsumers);
      if (!__shfl_sync(0xffffffffu, *last, 0)) continue;
      __threadfence();
      const float4* sums = reinterpret_cast<const float4*>(part) +
                           static_cast<size_t>(at.tile) * (kRows / 8) * kConsumers + tid;
      const size_t plane = static_cast<size_t>(tiles) * (kRows / 8) * kConsumers;
#pragma unroll
      for (int x = 0; x < kRows / 8; ++x) {
        // eight splits' loads in flight at a time, added in split order
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int z0 = 0; z0 < splits; z0 += 8) {
          float4 u[8];
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            if (z0 + q < splits) u[q] = __ldcg(sums + (z0 + q) * plane + x * kConsumers);
          }
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            if (z0 + q < splits) {
              v = z0 + q == 0 ? u[q]
                              : make_float4(v.x + u[q].x, v.y + u[q].y, v.z + u[q].z,
                                            v.w + u[q].w);
            }
          }
        }
        acc[4 * x] = v.x;
        acc[4 * x + 1] = v.y;
        acc[4 * x + 2] = v.z;
        acc[4 * x + 3] = v.w;
      }
      if (tid == 0) arrivals[at.tile] = 0;
    }
    // acc[4 i + 2 h + e]: A row 16 w + g + 8 h (column col + h), x row
    // m0 + 8 i + 2 t + e
#pragma unroll
    for (int i = 0; i < kRows / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = at.m0 + 8 * i + 2 * t + e;
        if (row < m) store_pair(out, n, row, col, acc[4 * i + e], acc[4 * i + 2 + e]);
      }
    }
  }
}

template <int kRows, bool kTma>
cudaError_t launch(const void* x, const void* w, const void* scale, void* out, void* part,
                   void* arrivals, int m, int kx, int k, int n, int splits, int blocks,
                   cudaStream_t s) {
  CUtensorMap xmap, wmap = {};
  cudaError_t err = encode_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, kx, m, 64, kRows,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess && kTma) {
    err = encode_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, n, k, kCols, 64,
                    CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(dq_kernel<kRows, kTma>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes<kRows, kTma>()));
  }
  if (err != cudaSuccess) return err;
  dq_kernel<kRows, kTma><<<blocks, kThreads, smem_bytes<kRows, kTma>(), s>>>(
      xmap, wmap, static_cast<const int8_t*>(w), static_cast<const float*>(scale),
      static_cast<bf16*>(out), static_cast<float*>(part), static_cast<unsigned*>(arrivals), m, k,
      n, splits);
  return cudaGetLastError();
}

// The instance: the weights by TMA where the rows allow it, else by cp.async.
template <int kRows>
cudaError_t launch(const void* x, const void* w, const void* scale, void* out, void* part,
                   void* arrivals, int m, int kx, int k, int n, int splits, int blocks,
                   cudaStream_t s) {
  const bool tma = n % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  return tma ? launch<kRows, true>(x, w, scale, out, part, arrivals, m, kx, k, n, splits, blocks,
                                   s)
             : launch<kRows, false>(x, w, scale, out, part, arrivals, m, kx, k, n, splits,
                                    blocks, s);
}

}  // namespace dq
}  // namespace

// x (M, Kx) bf16 with Kx % 8 == 0 and Kx >= K (columns past K zero), w_q
// (K, N) int8 at any byte alignment, scale (N,) f32, out (M, N) bf16.
// rows: the instance, x rows a tile (8, 64 or 256); splits: depth splits of
// the slices (at most one a slice), with part f32 scratch of splits x tiles
// x 128 x rows values and arrivals zeroed counters, one a tile (unread when
// splits == 1); blocks: the persistent grid
// (ops/int8_matmul.py::int8_matmul_plan).
extern "C" int mic_int8_matmul_bf16(void* x, void* w_q, void* scale, void* out, void* part,
                                    void* arrivals, int m, int kx, int k, int n, int rows,
                                    int splits, int blocks, void* stream) {
  const int64_t tiles = ((m + static_cast<int64_t>(rows) - 1) / rows) *
                        ((n + static_cast<int64_t>(dq::kCols) - 1) / dq::kCols);
  const int depth = rows == 8    ? dq::Shape<8, true>::kDepth
                    : rows == 64 ? dq::Shape<64, true>::kDepth
                                 : dq::Shape<256, true>::kDepth;
  const int slices = (k + depth - 1) / depth;
  if (m < 1 || k < 1 || n < 1 || kx < k || kx % 8 || splits < 1 || splits > slices ||
      blocks < 1 || tiles * splits > INT32_MAX ||
      (splits > 1 && (part == nullptr || arrivals == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 8:
      return dq::launch<8>(x, w_q, scale, out, part, arrivals, m, kx, k, n, splits, blocks, s);
    case 64:
      return dq::launch<64>(x, w_q, scale, out, part, arrivals, m, kx, k, n, splits, blocks, s);
    case 256:
      return dq::launch<256>(x, w_q, scale, out, part, arrivals, m, kx, k, n, splits, blocks,
                             s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory a block of instance (rows, tma) takes, in bytes
// (tools/torch_kernel_resources.py prints it; ptxas reports static only).
extern "C" int mic_int8_matmul_shared_bytes(int rows, int tma) {
  switch (rows * 2 + (tma != 0)) {
    case 16: return static_cast<int>(dq::smem_bytes<8, false>());
    case 17: return static_cast<int>(dq::smem_bytes<8, true>());
    case 128: return static_cast<int>(dq::smem_bytes<64, false>());
    case 129: return static_cast<int>(dq::smem_bytes<64, true>());
    case 512: return static_cast<int>(dq::smem_bytes<256, false>());
    case 513: return static_cast<int>(dq::smem_bytes<256, true>());
    default: return -1;
  }
}
