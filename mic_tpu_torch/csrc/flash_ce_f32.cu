// The float32 flash-CE forward, its saving form and the dl kernel: rows 7,
// 9's forward and 8 for a float32 model.
//
// Replace mic_tpu/ops/flash_ce.py::flash_ce_forward (_ce_fwd_kernel via
// _lse_main, and via _lse_main_save with save=True) and
// ::flash_ce_backward_dl (_ce_dl_kernel) where h is float32
// (CaptionerConfig.dtype "float32": mic_tpu casts the table to h.dtype and
// runs the same kernels).  The dl walk also forms the split route's dl
// (row 10 f32), a vocab chunk at a time (mic_flash_ce_split_f32 below).  The bf16 walk of csrc/flash_ce.cu is wgmma on
// bf16 operands and cannot take float32; these compute the logits
// s = hidden @ weight^T + bias to float32 accuracy on the tensor cores
// (csrc/tf32x3_wgmma.cuh: TF32 wgmma, each operand split into hi + lo,
// three products a term, each 32-deep slice's products added to the logits
// by FADDs) and never store them.  Per row over the whole vocab:
//
//   forward: lse = log sum exp(s), zsum = sum(s)  (online max + rescaled sum)
//   save:    the forward's statistics, bit-equal, and s itself: the main
//            span's columns (< v_main, a multiple of 128, so a tile is
//            wholly main or wholly tail) rounded to bf16 (N, v_main), as
//            mic_tpu's _lse_main_save saves them at float32 too, the rest
//            as the f32 tail (N, V - v_main)
//   dl:      dl = (exp(s - lse) - target) * rowscale as float32 (N, V), with
//            target = low + (conf - low) * onehot(label), and the tile's
//            column sums over the block's 128 rows as the row band's dbias
//            partial, folded in band order by a second kernel.
//
// The walk is the bf16 walk's: a block owns 128 hidden rows and walks a run
// of consecutive 128-wide vocab tiles, one block an SM, grid (row tiles,
// runs), row tiles fastest (ops/flash_ce.py::_runs), so the blocks of a
// run read the same table rows together and the table is read from device
// memory about once.  One producer warp keeps a ring of mbarrier-guarded
// slots filled by TMA; two consumer warpgroups (setmaxnreg) run the
// products.  The tile is the float32 head's, turned to this walk: the vocab
// is wgmma's M side (each consumer warpgroup 64 table rows, loaded from the
// slot by ldmatrix and split in registers), the block's 128 hidden rows its
// N side (split into hi and lo once before the walk, tf32x3::split_rows:
// 32 MB at the flagship step), m64n128k8 products.  A slot holds one
// 32-deep slice of the tile's 128 table rows and of the hidden rows' hi and
// lo (48 KB); the hidden rows do not fit resident (1 MB as hi + lo), so both
// operands stream from L2 for every tile: about 96 bytes an output, 98 GB
// at the flagship step.  The other layout, the hidden rows on M as in the
// bf16 walk, would need the table's lo in shared memory: 2 GB more traffic
// (a split of the table each call) or spare warps forming it in every slot.
//
// Epilogues, on the accumulator registers, where a thread holds table rows
// v0 = 64 wg + 16 w + g and v0 + 8 of the tile and hidden columns
// c = 8 i + 2 t + e (i < 16, e < 2):
//   forward: a hidden row's statistics run over M, across the threads.  Per
//     tile each thread forms (max, sum of exps against it, sum of logits) of
//     its 32 columns from its two table rows, a reduce-scatter over the
//     warp's eight row groups (lane bits 16, 8, 4; each step keeps half the
//     columns and merges the partner's copy of them) leaves lane (g, t) with
//     the warp's statistics of columns 16 g + 8 (q >> 1) + 2 t + (q & 1)
//     (q < 4), merged into its running (M, S, Z): 12 registers.  At the end
//     of the run the eight warps' states are merged in warp order through
//     the ring, and the run's partial is written for csrc/ce_reduce.cuh's
//     merge, which folds the runs in run order.
//   dl: each value from the row's terms (-lse log2 e, rowscale, label: a
//     float4 a row in shared memory), staged transposed into a 128 x 132 f32
//     tile (conflict-free: 8 t + g covers the banks) that the producer
//     warpgroup's three other warps ("storers") write out while the next
//     tile's products run (save stages the logits there the same way, the
//     storers writing a main tile as bf16 in 16-byte pieces, a tail tile
//     as dl's); the band's column sums are a table row's: over
//     the thread's 32 columns, then its quad by two shuffles.  A dl row
//     starts at row x V x 4 bytes, only 4-byte aligned for an odd V, which
//     TMA cannot store; the storers shift each row by its start's offset
//     within 16 bytes and write aligned 16-byte pieces, the partial pieces at
//     its ends value by value.
// No atomics: reruns are bit-equal.  Rows past N, vocab rows past V and
// depth past D arrive as TMA's zero fill; columns >= V never enter a sum
// and are never written, nor are rows past N.  The label logit and the dh
// / demb products over dl stay outside, as mic_tpu computes them outside
// its kernels.
//
// Bound at the flagship training step (N = 4096, D = 1024, V = 250054):
// 2 N D V = 2.1 TFLOP at 165 TFLOP/s of float32-accurate products (three
// TF32 products at 495), 12.71 ms each; dl also writes 4.1 GB of float32
// (1.22 ms at 3.35 TB/s, under the products).  On an H100 the forward
// takes about 17 ms and dl about 18 (PERF.md).  What holds them there is
// what each SM takes in, not the L2's reads: without the hidden rows' lo
// boxes (a third of each slot) each kernel took 1.5-2 ms less
// (tools/torch_f32_variants.py's ce_lo_once), while a cluster of two runs
// sharing the hidden boxes by TMA multicast, half their L2 reads, was no
// faster.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "ce_reduce.cuh"
#include "tf32x3_wgmma.cuh"

namespace {

using namespace head_wgmma;

constexpr int kRows = 128;                        // hidden rows a block: wgmma's N
constexpr int kCols = 128;                        // vocab columns a tile: M, 64 a warpgroup
constexpr int kBox = kRows * 128;                 // a 128-row, 32-deep f32 box: 16384 bytes
constexpr int kSlot = 3 * kBox;                   // table, hidden hi, hidden lo: 49152
constexpr int kFwdStages = 4;
constexpr int kDlStages = 3;                      // room for the staged tile (dl, save)
constexpr int kConsumerWarps = 8;                 // two warpgroups
constexpr int kConsumerThreads = kConsumerWarps * 32;
constexpr int kThreads = kConsumerThreads + 128;  // and the producer's warpgroup
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kTilePitch = kCols + 4;             // f32 pitch of the staged dl tile
constexpr int kTileBytes = kRows * kTilePitch * 4;  // 67584
constexpr int kTermBytes = kRows * 16;            // dl: a row's terms as a float4
constexpr int kStorerWarps = 3;                   // the producer warpgroup's other warps
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kFloor = -1e30f;  // a running max before its first column

enum Mode { kWalkFwd = 0, kWalkDl = 1, kWalkSave = 2 };

// dl and save stage a tile for the storer warps
__host__ __device__ constexpr bool staged(int mode) { return mode != kWalkFwd; }
__host__ __device__ constexpr int ring_stages(int mode) {
  return staged(mode) ? kDlStages : kFwdStages;
}

// Alignment slack, the ring, the staged tile and the rows' terms (dl, save),
// the barriers (the ring's, and the staged tile's two).
constexpr size_t smem_bytes(int mode) {
  return 1024 + static_cast<size_t>(ring_stages(mode)) * kSlot +
         (staged(mode) ? kTileBytes + kTermBytes : 0) +
         (2 * ring_stages(mode) + 2) * sizeof(uint64_t);
}
static_assert(smem_bytes(kWalkFwd) <= 232448 && smem_bytes(kWalkDl) <= 232448,
              "the walks must fit a block's shared memory");
static_assert(3 * kConsumerWarps * kRows * 4 <= kDlStages * kSlot,
              "the warps' statistics merge through the ring");

struct Args {
  const float* bias;      // (V,)
  const float* lse;       // dl: (N,)
  const float* rowscale;  // dl: (N,)
  const int32_t* labels;  // dl: (N,)
  float* part_m;          // forward: (runs, N) partials
  float* part_s;
  float* part_z;
  float* dl;              // dl: (N, ld)
  float* band;            // dl: (row tiles, V) dbias partials
  __nv_bfloat16* logits;  // save: (N, v_main)
  float* tail;            // save: (N, V - v_main)
  float low, conf_low;
  int n, d, vocab;
  int ld;                 // dl: the row pitch of dl, at least V
  int label_base;         // dl: a label y is the walk's column y - label_base
  int v_main;             // save: the main span's columns
};

// 2^x, one MUFU instruction; 2^-inf = 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// (m, s, z) += (mb, sb, zb): running max, sum of exps relative to it, sum
// of logits.  The same result whichever side is which; a side with
// m = kFloor (no column yet) adds nothing.
__device__ __forceinline__ void merge(float& m, float& s, float& z, float mb, float sb,
                                      float zb) {
  const float hi = fmaxf(m, mb);
  const float e = ex2((fminf(m, mb) - hi) * kLog2e);
  s = m >= mb ? fmaf(sb, e, s) : fmaf(s, e, sb);
  m = hi;
  z += zb;
}

// One step of the statistics' reduce-scatter over a warp's row groups: of
// the 2 kHalf columns the thread holds (position q), it keeps the lower or
// upper kHalf, as its lane bit kBit says, and merges in its partner's
// (lane ^ kBit) copy of them.
template <int kHalf, int kBit>
__device__ __forceinline__ void scatter_stats(float (&m)[2 * kHalf], float (&s)[2 * kHalf],
                                              float (&z)[2 * kHalf], int lane) {
  const bool upper = (lane & kBit) != 0;
#pragma unroll
  for (int q = 0; q < kHalf; ++q) {
    const float om = __shfl_xor_sync(0xffffffffu, upper ? m[q] : m[q + kHalf], kBit);
    const float os = __shfl_xor_sync(0xffffffffu, upper ? s[q] : s[q + kHalf], kBit);
    const float oz = __shfl_xor_sync(0xffffffffu, upper ? z[q] : z[q + kHalf], kBit);
    if (upper) {
      m[q] = m[q + kHalf];
      s[q] = s[q + kHalf];
      z[q] = z[q + kHalf];
    }
    merge(m[q], s[q], z[q], om, os, oz);
  }
}

// The thread's (max, sum of exps, sum) of hidden column q = 2 i + e of the
// tile from its two table rows' logits x = acc + b (valid as ok says; ok[1]
// implies ok[0]).
template <bool kFull>
__device__ __forceinline__ void pair_stats(const float (&acc)[64], const float (&b)[2],
                                           const bool (&ok)[2], int q, float& m, float& s,
                                           float& z) {
  const int i = q >> 1, e = q & 1;
  const float x0 = acc[4 * i + e] + b[0];
  const float x1 = acc[4 * i + 2 + e] + b[1];
  const float hi = fmaxf(x0, x1);
  const float two = 1.f + ex2((fminf(x0, x1) - hi) * kLog2e);
  m = kFull || ok[1] ? hi : ok[0] ? x0 : kFloor;
  s = kFull || ok[1] ? two : ok[0] ? 1.f : 0.f;
  z = kFull || ok[1] ? x0 + x1 : ok[0] ? x0 : 0.f;
}

// The tile's logits into the warp's running statistics of the block's
// hidden rows (the header's forward epilogue).  The first step of the
// reduce-scatter (lane bit 16) takes columns q and q + 16 as they are
// formed, so that no more than 16 columns' states are held at once.
template <bool kFull>
__device__ __forceinline__ void fold_tile(const float (&acc)[64], const float (&b)[2],
                                          const bool (&ok)[2], int lane, float (&rm)[4],
                                          float (&rs)[4], float (&rz)[4]) {
  const bool upper = (lane & 16) != 0;
  float m[16], s[16], z[16];
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    float ma, sa, za, mb, sb, zb;
    pair_stats<kFull>(acc, b, ok, q, ma, sa, za);
    pair_stats<kFull>(acc, b, ok, q + 16, mb, sb, zb);
    const float om = __shfl_xor_sync(0xffffffffu, upper ? ma : mb, 16);
    const float os = __shfl_xor_sync(0xffffffffu, upper ? sa : sb, 16);
    const float oz = __shfl_xor_sync(0xffffffffu, upper ? za : zb, 16);
    m[q] = upper ? mb : ma;
    s[q] = upper ? sb : sa;
    z[q] = upper ? zb : za;
    merge(m[q], s[q], z[q], om, os, oz);
  }
  scatter_stats<8, 8>(m, s, z, lane);
  float m8[8], s8[8], z8[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    m8[q] = m[q];
    s8[q] = s[q];
    z8[q] = z[q];
  }
  scatter_stats<4, 4>(m8, s8, z8, lane);
#pragma unroll
  for (int q = 0; q < 4; ++q) merge(rm[q], rs[q], rz[q], m8[q], s8[q], z8[q]);
}

// dl of the tile into the staged tile (hidden row c, table row vl + 8 h of
// the tile) and the thread's column sums of it over its 32 hidden rows:
// (exp(x - lse) - target) * rowscale, 0 at table rows past V (and, by their
// terms, at rows past N).
template <bool kFull>
__device__ __forceinline__ void dl_tile(const float (&acc)[64], const float (&b)[2],
                                        const bool (&ok)[2], const int (&v)[2],
                                        const float4* terms, float* tile, int vl, int t,
                                        float low, float label_target, float (&colsum)[2]) {
  colsum[0] = colsum[1] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * i + 2 * t + e;
      const float4 r = terms[c];  // -lse log2 e, rowscale, label
      const int y = __float_as_int(r.z);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p = ex2(fmaf(acc[4 * i + 2 * h + e] + b[h], kLog2e, r.x));
        float g = (p - (v[h] == y ? label_target : low)) * r.y;
        g = kFull || ok[h] ? g : 0.f;
        tile[c * kTilePitch + vl + 8 * h] = g;
        colsum[h] += g;
      }
    }
  }
}

// The tile's logits into the staged tile (save), as dl_tile places dl.
__device__ __forceinline__ void save_tile(const float (&acc)[64], const float (&b)[2],
                                          float* tile, int vl, int t) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * i + 2 * t + e;
#pragma unroll
      for (int h = 0; h < 2; ++h) tile[c * kTilePitch + vl + 8 * h] = acc[4 * i + 2 * h + e] + b[h];
    }
  }
}

// A storer warp writes its rows r = sw, sw + 3, ... of the staged tile, a
// main tile of the save walk, as bf16 into logits (row pitch v_main, a
// multiple of 128: every row's 256 bytes start 16-byte aligned): half a
// warp a row, eight values a lane.
__device__ __forceinline__ void write_main_tile(const float* tile, __nv_bfloat16* out,
                                                int v_main, int row0, int n, int col0, int sw,
                                                int lane) {
  const int rows = min(kRows, n - row0);
  const int p = 8 * (lane & 15);
  for (int r = 2 * sw + (lane >> 4); r < rows; r += 2 * kStorerWarps) {
    const float* src = tile + r * kTilePitch + p;
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(src[2 * j], src[2 * j + 1]);
      w[j] = *reinterpret_cast<const uint32_t*>(&pair);
    }
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(row0 + r) * v_main + col0 + p) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// A storer warp writes its rows r = sw, sw + 3, ... of the staged tile into
// out (row pitch ld >= vocab): columns < vocab - col0 of rows < n - row0.
// The row's first value e0 = (row0 + r) ld + col0 lies sh = e0 % 4 values
// past a 16-byte
// boundary; lane j stores the aligned piece of positions [4 j, 4 j + 4)
// (counted from e0 - sh) where it lies inside the row, lanes 0-3 the row's
// values in the partial pieces at its ends; the vocab's last tile, if
// partial, goes value by value.
__device__ __forceinline__ void write_tile(const float* tile, float* out, int vocab, int ld,
                                           int row0, int n, int col0, int sw, int lane) {
  const int rows = min(kRows, n - row0);
  const int cols = min(kCols, vocab - col0);
  for (int r = sw; r < rows; r += kStorerWarps) {
    const size_t e0 = static_cast<size_t>(row0 + r) * ld + col0;
    const int sh = static_cast<int>(e0 & 3);
    const float* src = tile + r * kTilePitch - sh;  // src[p]: output position p
    float* dst = out + (e0 - sh);
    if (cols < kCols) {
      for (int p = sh + lane; p < sh + cols; p += 32) dst[p] = src[p];
      continue;
    }
    const int p0 = 4 * lane;
    if (p0 >= sh) {
      *reinterpret_cast<float4*>(dst + p0) =
          make_float4(src[p0], src[p0 + 1], src[p0 + 2], src[p0 + 3]);
    }
    if (sh > 0 && lane < 4) {  // positions sh .. 3 and 128 .. 127 + sh
      const int p = lane < 4 - sh ? sh + lane : kCols + lane - (4 - sh);
      dst[p] = src[p];
    }
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
ce_tf32_kernel(const __grid_constant__ CUtensorMap wmap,   // table (V, D), 128-row boxes
               const __grid_constant__ CUtensorMap himap,  // hidden hi (N, D), 128-row boxes
               const __grid_constant__ CUtensorMap lomap,  // hidden lo (N, D)
               const Args a) {
  constexpr int kStages = ring_stages(kMode);
  constexpr bool kDl = kMode == kWalkDl;
  constexpr bool kStaged = staged(kMode);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_1024(smem_raw);  // [slot][table, hi, lo][128 rows][128 B]
  unsigned char* rest = ring + kStages * kSlot;
  float* tile_s = reinterpret_cast<float*>(rest);                   // dl, save: [128][kTilePitch]
  float4* terms = reinterpret_cast<float4*>(rest + kTileBytes);     // dl: [128]
  if (kStaged) rest += kTileBytes + kTermBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(rest);
  uint64_t* empty = full + kStages;
  uint64_t* tile_full = empty + kStages;  // the staged tile written (consumer warps)
  uint64_t* tile_empty = tile_full + 1;   // ... and read out (storer warps)

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * kRows;
  const int ntiles = (a.vocab + kCols - 1) / kCols;
  const int t_begin = static_cast<int>(static_cast<int64_t>(blockIdx.y) * ntiles / gridDim.y);
  const int t_end = static_cast<int>(static_cast<int64_t>(blockIdx.y + 1) * ntiles / gridDim.y);
  const int nk = (a.d + tf32x3::kDepth - 1) / tf32x3::kDepth;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    mbar_init(tile_full, kConsumerWarps);
    mbar_init(tile_empty, kStorerWarps);
    mbar_fence_init();
  }
  if (kDl && tid < kRows) {
    // a row past N: exp of -inf is 0 and its rowscale 0, so its dl is 0
    const int row = row0 + tid;
    const bool live = row < a.n;
    terms[tid] = make_float4(live ? -a.lse[row] * kLog2e : -INFINITY,
                             live ? a.rowscale[row] : 0.f,
                             __int_as_float(live ? a.labels[row] - a.label_base : -1), 0.f);
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // producer: slice s is depth slice s % nk of tile t_begin + s / nk: the
    // tile's 128 table rows, the block's hidden hi and lo
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0) {
      const int nslices = (t_end - t_begin) * nk;
      int slot = 0, phase = 0;
      for (int s = 0; s < nslices; ++s) {
        if (s >= kStages) mbar_wait(&empty[slot], phase ^ 1);
        const int tile = t_begin + s / nk;
        const int kk = (s % nk) * tf32x3::kDepth;
        unsigned char* dst = ring + slot * kSlot;
        mbar_expect_tx(&full[slot], kSlot);
        tma_load_2d(dst, &wmap, &full[slot], kk, tile * kCols);
        tma_load_2d(dst + kBox, &himap, &full[slot], kk, row0);
        tma_load_2d(dst + 2 * kBox, &lomap, &full[slot], kk, row0);
        if (++slot == kStages) {
          slot = 0;
          phase ^= 1;
        }
      }
    } else if (kStaged && warp > kConsumerWarps) {
      // storers: the u-th tile of the run, once the consumers have staged
      // it, out to device memory while they walk the next tile
      const int sw = warp - kConsumerWarps - 1;
      for (int u = 0; t_begin + u < t_end; ++u) {
        const int col0 = (t_begin + u) * kCols;
        mbar_wait(tile_full, u & 1);
        if (kDl) {
          write_tile(tile_s, a.dl, a.vocab, a.ld, row0, a.n, col0, sw, lane);
        } else if (col0 < a.v_main) {
          write_main_tile(tile_s, a.logits, a.v_main, row0, a.n, col0, sw, lane);
        } else {
          const int vt = a.vocab - a.v_main;
          write_tile(tile_s, a.tail, vt, vt, row0, a.n, col0 - a.v_main, sw, lane);
        }
        release(tile_empty, 0);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = consumer_warpgroup();
  const int w = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int vl = 64 * wg + 16 * w + g;  // the thread's table row of a tile (h = 0; + 8 for h = 1)
  const float label_target = a.low + a.conf_low;
  float rm[4] = {kFloor, kFloor, kFloor, kFloor}, rs[4] = {0.f, 0.f, 0.f, 0.f},
        rz[4] = {0.f, 0.f, 0.f, 0.f};  // forward: the lane's columns' running statistics

  float acc[64], part[64];
  int slot = 0, phase = 0;
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int col0 = tile * kCols;
    // the rows' biases, loaded while the tile's products run
    int v[2];
    bool ok[2];
    float b[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      v[h] = col0 + vl + 8 * h;
      ok[h] = v[h] < a.vocab;
      b[h] = ok[h] ? __ldg(a.bias + v[h]) : 0.f;
    }
#pragma unroll
    for (int x = 0; x < 64; ++x) acc[x] = 0.f;
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(&full[slot], phase);
      const unsigned char* base = ring + slot * kSlot;
      tf32x3::slice_products(part, base + wg * (kBox / 2), base + kBox, base + 2 * kBox, w, lane);
      release(empty, slot);
      if (++slot == kStages) {
        slot = 0;
        phase ^= 1;
      }
#pragma unroll
      for (int x = 0; x < 64; ++x) acc[x] = __fadd_rn(acc[x], part[x]);
    }
    const bool full_tile = col0 + kCols <= a.vocab;  // every tile but the last
    if constexpr (kDl) {
      const int u = tile - t_begin;
      if (u > 0) mbar_wait(tile_empty, (u - 1) & 1);  // the storers read the last one
      float colsum[2];
      if (full_tile) {
        dl_tile<true>(acc, b, ok, v, terms, tile_s, vl, t, a.low, label_target, colsum);
      } else {
        dl_tile<false>(acc, b, ok, v, terms, tile_s, vl, t, a.low, label_target, colsum);
      }
      release(tile_full, 0);
      // the table row's sum over the block's rows: the quad's four column sets
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        colsum[h] += __shfl_xor_sync(0xffffffffu, colsum[h], 1);
        colsum[h] += __shfl_xor_sync(0xffffffffu, colsum[h], 2);
        if (t == 0 && ok[h]) a.band[static_cast<size_t>(blockIdx.x) * a.vocab + v[h]] = colsum[h];
      }
    } else {
      if constexpr (kStaged) {  // save: the logits out, then the same statistics
        const int u = tile - t_begin;
        if (u > 0) mbar_wait(tile_empty, (u - 1) & 1);
        save_tile(acc, b, tile_s, vl, t);
        release(tile_full, 0);
      }
      if (full_tile) {
        fold_tile<true>(acc, b, ok, lane, rm, rs, rz);
      } else {
        fold_tile<false>(acc, b, ok, lane, rm, rs, rz);
      }
    }
  }

  if constexpr (!kDl) {
    // the eight warps' statistics of each hidden row, merged in warp order
    // through the ring (both warpgroups are done with it), then the run's
    // partial
    consumer_sync(kConsumerThreads);
    float* xm = reinterpret_cast<float*>(ring);
    float* xs = xm + kConsumerWarps * kRows;
    float* xz = xs + kConsumerWarps * kRows;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = warp * kRows + 16 * g + 8 * (q >> 1) + 2 * t + (q & 1);
      xm[c] = rm[q];
      xs[c] = rs[q];
      xz[c] = rz[q];
    }
    consumer_sync(kConsumerThreads);
    if (tid < kRows && row0 + tid < a.n) {
      float m = xm[tid], s = xs[tid], z = xz[tid];
      for (int x = 1; x < kConsumerWarps; ++x) {
        merge(m, s, z, xm[x * kRows + tid], xs[x * kRows + tid], xz[x * kRows + tid]);
      }
      const size_t o = static_cast<size_t>(blockIdx.y) * a.n + row0 + tid;
      a.part_m[o] = m;
      a.part_s[o] = s;
      a.part_z[o] = z;
    }
  }
}

// One walk over (ceil(N / 128) row tiles) x (runs) blocks, the hidden rows
// already split into hi and lo (hsplit: (2, N, D) f32).
template <int kMode>
cudaError_t walk(const void* weight, const void* hsplit, const Args& a, int runs,
                 cudaStream_t stream) {
  const int ntiles = (a.vocab + kCols - 1) / kCols;
  if (a.n < 1 || a.vocab < 1 || a.d < 4 || a.d % 4 || runs < 1 || runs > ntiles ||
      runs > 65535) {
    return cudaErrorInvalidValue;
  }
  const float* lo = static_cast<const float*>(hsplit) + static_cast<size_t>(a.n) * a.d;
  CUtensorMap wmap, himap, lomap;
  cudaError_t err = tf32x3::encode_rows(&wmap, weight, a.vocab, a.d, kCols);
  if (err == cudaSuccess) err = tf32x3::encode_rows(&himap, hsplit, a.n, a.d, kRows);
  if (err == cudaSuccess) err = tf32x3::encode_rows(&lomap, lo, a.n, a.d, kRows);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = smem_bytes(kMode);
  err = cudaFuncSetAttribute(ce_tf32_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + kRows - 1) / kRows, runs);
  ce_tf32_kernel<kMode><<<grid, kThreads, smem, stream>>>(wmap, himap, lomap, a);
  return cudaGetLastError();
}

// The hidden rows split into hi and lo (hsplit: (2, N, D) f32 scratch),
// then one walk.
template <int kMode>
int launch(const void* hidden, const void* weight, void* hsplit, const Args& a, int runs,
           cudaStream_t stream) {
  if (a.n < 1 || a.d < 4 || a.d % 4) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = tf32x3::split_rows(hidden, hsplit, a.n, a.d, stream);
  if (err == cudaSuccess) err = walk<kMode>(weight, hsplit, a, runs, stream);
  return static_cast<int>(err);
}

}  // namespace

// hidden (N, D), weight (V, D), bias (V,) float32, D a multiple of 4; hsplit
// (2, N, D) float32 scratch for the hidden rows' hi and lo; runs consecutive
// vocab-tile runs per row tile; part_* are (runs, N) scratch.
extern "C" int mic_flash_ce_fwd_f32(void* hidden, void* weight, void* bias, void* hsplit,
                                    void* part_m, void* part_s, void* part_z, void* lse,
                                    void* zsum, int n, int d, int vocab, int runs, void* stream) {
  Args a{};
  a.bias = static_cast<const float*>(bias);
  a.part_m = static_cast<float*>(part_m);
  a.part_s = static_cast<float*>(part_s);
  a.part_z = static_cast<float*>(part_z);
  a.n = n;
  a.d = d;
  a.vocab = vocab;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int bad = launch<kWalkFwd>(hidden, weight, hsplit, a, runs, s)) return bad;
  flash_ce_fwd_merge_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      a.part_m, a.part_s, a.part_z, static_cast<float*>(lse), static_cast<float*>(zsum), n, runs);
  return static_cast<int>(cudaGetLastError());
}

// The forward with save: the same statistics, logits_main (N, v_main) bf16
// and tail (N, V - v_main) float32; v_main a multiple of 128, at most V.
extern "C" int mic_flash_ce_fwd_save_f32(void* hidden, void* weight, void* bias, void* hsplit,
                                         void* part_m, void* part_s, void* part_z, void* lse,
                                         void* zsum, void* logits_main, void* tail, int n, int d,
                                         int vocab, int v_main, int runs, void* stream) {
  if (v_main < 0 || v_main > vocab || v_main % kCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  a.bias = static_cast<const float*>(bias);
  a.part_m = static_cast<float*>(part_m);
  a.part_s = static_cast<float*>(part_s);
  a.part_z = static_cast<float*>(part_z);
  a.logits = static_cast<__nv_bfloat16*>(logits_main);
  a.tail = static_cast<float*>(tail);
  a.n = n;
  a.d = d;
  a.vocab = vocab;
  a.v_main = v_main;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int bad = launch<kWalkSave>(hidden, weight, hsplit, a, runs, s)) return bad;
  flash_ce_fwd_merge_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      a.part_m, a.part_s, a.part_z, static_cast<float*>(lse), static_cast<float*>(zsum), n, runs);
  return static_cast<int>(cudaGetLastError());
}

// dl (N, V) float32 and dbias (V,) through band_part, (ceil(N / 128), V)
// float32 scratch of which every live entry is written; hsplit as above.
extern "C" int mic_flash_ce_dl_f32(void* hidden, void* weight, void* bias, void* hsplit,
                                   void* labels, void* lse, void* rowscale, void* dl,
                                   void* band_part, void* dbias, float low, float conf_low, int n,
                                   int d, int vocab, int runs, void* stream) {
  Args a{};
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
  a.ld = vocab;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int bad = launch<kWalkDl>(hidden, weight, hsplit, a, runs, s)) return bad;
  const int bands = (n + kRows - 1) / kRows;
  flash_ce_band_sum_kernel<<<(vocab + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(band_part), static_cast<float*>(dbias), bands, vocab);
  return static_cast<int>(cudaGetLastError());
}

// The split route's dl, a vocab chunk at a time (row 10 f32): the dl walk
// over the table rows and biases of the chunk (weight and bias point at
// its first), dl into (N, ld) f32 with ld >= vocab (the chunk's columns) a
// multiple of 4, a label y counted as the chunk's column y - label_base,
// then the chunk's dbias (vocab,) from band_part ((ceil(N / 128), vocab)
// f32 scratch).  hsplit (2, N, D) holds the hidden rows' hi and lo; where
// hidden is not null they are split into it first.
extern "C" int mic_flash_ce_dl_chunk_f32(void* hidden, void* weight, void* bias, void* hsplit,
                                         void* labels, void* lse, void* rowscale, void* dl,
                                         void* band_part, void* dbias, float low, float conf_low,
                                         int n, int d, int vocab, int ld, int label_base,
                                         int runs, void* stream) {
  if (ld < vocab || ld % 4 || n < 1 || d < 4 || d % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
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
  a.ld = ld;
  a.label_base = label_base;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = hidden ? tf32x3::split_rows(hidden, hsplit, n, d, s) : cudaSuccess;
  if (err == cudaSuccess) err = walk<kWalkDl>(weight, hsplit, a, runs, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bands = (n + kRows - 1) / kRows;
  flash_ce_band_sum_kernel<<<(vocab + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(band_part), static_cast<float*>(dbias), bands, vocab);
  return static_cast<int>(cudaGetLastError());
}
