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
// bound it; the dl kernel also writes 2 GB of bf16 dl, the save forward
// 2 GB of bf16 logits.
//
// The walk of the forward, save and dl kernels (ce_walk_kernel<mode>) runs
// on Hopper's wgmma fed by TMA (csrc/head_wgmma.cuh).  A block owns 128
// hidden rows and walks a run of consecutive 256-wide vocab tiles.  Per
// tile both operands stream in 64-deep slices -- hidden (N, D) 128 x 64
// and the table as stored, (V, D), 256 x 64, both in the 128-byte swizzle,
// with the tile's 256 biases beside its last slice -- through a ring of
// mbarrier-guarded slots (four for the forward, three where the bf16 tile
// is staged) that one producer warp keeps filled; two consumer warpgroups
// (64 rows each) issue m64n256k16 on each slot, both operands from shared
// memory, wait for the products and free the slot.  A 128-row hidden tile
// is 256 KB at D = 1024 and does not fit, so its slices are re-read from
// L2 for every vocab tile.  The epilogue works on the accumulator
// registers, where a thread holds rows 16 w + g + 8 h (h = 0, 1) of its
// warpgroup's 64 and columns 8 i + 2 t + e (i < 32, e < 2):
//   forward: per row a running (max, rescaled sum of exps, sum of logits)
//     over the thread's columns, folded over the quad by shuffles at the
//     end of the run;
//   save: the same walk and fold (so the statistics are the forward's bit
//     for bit), then the logits stored;
//   dl: dl per element, stored as bf16, and the tile's f32 column sums over
//     the block's 128 rows (the row band's dbias partial): over the
//     thread's two rows, over the warp's eight row groups by a
//     reduce-scatter of shuffles, over the eight warps through shared
//     memory in warp order.
// The grid is (row tiles, runs), row tiles fastest, one block an SM
// (ops/flash_ce.py::_runs: as many runs as the row tiles leave SMs), so
// the blocks of one run walk the same vocab slices together and the table
// is read from device memory about once.  The forward merges the runs'
// (m, s, z) in run order and dbias sums the row bands in band order.
// There is no float atomic anywhere: two identical calls give bit-equal
// results.  Rows past N and vocab rows past V arrive as TMA's zero fill;
// rows past N are never written and columns >= V never enter a sum.
//
// Stores.  dl (2 GB at the flagship step) and the save form's bf16 logits
// leave the SM while the next tile's products run: the consumers stage the
// tile's bf16 values in shared memory and go on; the producer warpgroup's
// three other warps ("storers") write it out and free it (two more
// mbarriers).  dl rows start at row * V * 2 bytes, for an odd V only 2-byte
// aligned, which TMA cannot store (global strides must be multiples of 16
// bytes); so each staged row is shifted by its start's offset within 16
// bytes (the even part by the consumers, the odd one by the storers) and
// goes out in aligned 16-byte pieces, the partial pieces at its ends value
// by value.  Stored from the consumers' registers instead, while the tensor
// cores idled, dl took 1.3-1.5 ms more than the walk without its stores
// (an H100 at the flagship step).  The save form's f32 tail goes value by
// value from the registers.
// The contraction kernels are described where they are defined, below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "ce_reduce.cuh"
#include "head_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// The walk: forward, save and dl on wgmma fed by TMA.

namespace walk {

using namespace head_wgmma;

constexpr int kRows = 128;                         // hidden rows a block
constexpr int kCols = 256;                         // vocab columns a tile
constexpr int kDepth = 64;                         // bf16 depth of a slice: a 128-byte row
constexpr int kFwdStages = 4;                      // ring slots: the forward
constexpr int kStoreStages = 3;                    // save and dl (room for the tile)
constexpr int kASlice = kRows * kDepth * 2;        // 16384 bytes
constexpr int kBSlice = kCols * kDepth * 2;        // 32768
constexpr int kSide = kCols * 4;                   // the tile's biases, beside its last slice
constexpr int kSlot = kASlice + kBSlice + kSide;   // 50176 = 49 x 1024
constexpr int kConsumerWarps = 8;                  // two warpgroups
constexpr int kConsumerThreads = kConsumerWarps * 32;
constexpr int kThreads = kConsumerThreads + 128;   // and the producer's warpgroup
constexpr int kProducerRegs = 40;                  // registers a thread after setmaxnreg
constexpr int kConsumerRegs = 232;
constexpr int kSumPitch = kCols + 32;              // f32 pitch of a warp's column sums
constexpr int kSumBytes = kConsumerWarps * kSumPitch * 4;           // 9216
constexpr int kTilePitch = kCols + 8;              // bf16 pitch of the staged tile
constexpr int kTileBytes = kRows * kTilePitch * 2;                  // 67584
constexpr int kStorerWarps = 3;                    // the producer warpgroup's other warps
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kFloor = -1e30f;  // a row's running max before its first column

enum Mode { kFwd = 0, kSave = 1, kDl = 2 };

__host__ __device__ constexpr int ring_stages(int mode) { return mode == kFwd ? kFwdStages : kStoreStages; }

// Alignment slack, the ring, the staged bf16 tile (save, dl), the column
// sums (dl), the barriers (the ring's, and the staged tile's two).
constexpr size_t smem_bytes(int mode) {
  return 1024 + static_cast<size_t>(ring_stages(mode)) * kSlot +
         (mode == kFwd ? 0 : kTileBytes) + (mode == kDl ? kSumBytes : 0) +
         (2 * ring_stages(mode) + 2) * sizeof(uint64_t);
}
static_assert(smem_bytes(kDl) <= 232448, "the dl walk must fit a block's shared memory");

struct Args {
  const float* lse;        // dl: (N,)
  const float* rowscale;   // dl: (N,)
  const int32_t* labels;   // dl: (N,)
  float* part_m;           // forward, save: (runs, N) partials
  float* part_s;
  float* part_z;
  bf16* out;               // save: logits (N, v_main); dl: dl (N, V)
  float* tail;             // save: (N, V - v_main)
  float* band;             // dl: (row tiles, V) dbias partials
  float low, conf_low;
  int n, d, vocab, v_main;
};

// 2^x, one MUFU instruction; 2^-inf = 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The tile's logits x (column 8 i + 2 t + e valid where kFull or < V) into
// the thread's two rows' running (max m, sum of exps s relative to m, sum
// of logits z).  m starts at kFloor, so exp2 of (v - m) * log2 e needs no
// guard: a thread with no valid column in the tile keeps its state.
template <bool kFull>
__device__ __forceinline__ void fold_tile(const float (&x)[128], int col0, int vocab, int t,
                                          float (&m)[2], float (&s)[2], float (&z)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float tmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = kFull || col0 + 8 * i + 2 * t + e < vocab;
        tmax = fmaxf(tmax, ok ? x[4 * i + 2 * h + e] : -INFINITY);
      }
    }
    const float mnew = fmaxf(m[h], tmax);
    const float c = -mnew * kLog2e;
    float es[2] = {0.f, 0.f}, zs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = kFull || col0 + 8 * i + 2 * t + e < vocab;
        const float v = x[4 * i + 2 * h + e];
        es[e] += ok ? ex2(fmaf(v, kLog2e, c)) : 0.f;
        zs[e] += ok ? v : 0.f;
      }
    }
    s[h] = fmaf(s[h], ex2((m[h] - mnew) * kLog2e), es[0] + es[1]);
    m[h] = mnew;
    z[h] += zs[0] + zs[1];
  }
}

// The thread's values of x, rounded to bf16, into the staged tile for the
// storers: block row rr + 8 h, column c (c = 8 i + 2 t + e) at position
// c + (sh & 6) of the row, sh = the row's first element modulo 8 in the
// output (row pitch ld), pairs as 4-byte shared stores; the storers take
// out the rest of the shift, sh & 1.  The u-th use of the tile (u = 0, 1,
// ...) waits for their (u - 1)-th read.
__device__ __forceinline__ void stage_bf16(const float (&x)[128], uint16_t* tile,
                                           uint64_t* tile_full, uint64_t* tile_empty, int u,
                                           size_t ld, int row0, int col0, int rr, int t) {
  if (u > 0) mbar_wait(tile_empty, (u - 1) & 1);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int se = static_cast<int>((static_cast<size_t>(row0 + rr + 8 * h) * ld + col0) & 6);
    uint32_t* row = reinterpret_cast<uint32_t*>(tile + (rr + 8 * h) * kTilePitch + se) + t;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(x[4 * i + 2 * h], x[4 * i + 2 * h + 1]);
      row[4 * i] = *reinterpret_cast<const uint32_t*>(&b);
    }
  }
  release(tile_full, 0);
}

// A storer warp writes its rows r = sw, sw + 3, ... of the staged tile
// (block rows from row0, columns from col0) into out (row pitch ld
// elements): columns < limit of rows < n.  Output position p (from the
// 16-byte aligned element row * ld + col0 - sh on) holds the row's value
// p - sh, staged at position p - (sh & 1).  In a whole tile lane j stores
// the 16-byte piece at 8 j when it lies inside the row (for an odd sh each
// 4-byte pair rebuilt from two staged ones), and lanes 0-7 the row's 8
// values in the partial pieces at either end; a partial tile (the vocab's
// last) goes value by value.
__device__ __forceinline__ void write_tile(const uint16_t* tile, bf16* out, size_t ld, int row0,
                                           int n, int col0, int limit, int sw, int lane) {
  uint16_t* out16 = reinterpret_cast<uint16_t*>(out);
  const int rows = min(kRows, n - row0);
  const int cols = min(kCols, limit - col0);
  for (int r = sw; r < rows; r += kStorerWarps) {
    const size_t e0 = static_cast<size_t>(row0 + r) * ld + col0;
    const int sh = static_cast<int>(e0 & 7);
    const int odd = sh & 1;
    const uint16_t* src = tile + r * kTilePitch - odd;  // src[p]: output position p
    uint16_t* dst = out16 + (e0 - sh);
    if (cols < kCols) {
      for (int p = sh + lane; p < sh + cols; p += 32) dst[p] = src[p];
      continue;
    }
    const int p0 = 8 * lane;
    if (p0 >= sh) {  // the piece [p0, p0 + 8) lies inside [sh, sh + 256)
      const uint32_t* w = reinterpret_cast<const uint32_t*>(src + odd + p0);
      uint4 v = *reinterpret_cast<const uint4*>(w);
      if (odd) {  // row-uniform
        v = make_uint4(__byte_perm(w[-1], v.x, 0x5432), __byte_perm(v.x, v.y, 0x5432),
                       __byte_perm(v.y, v.z, 0x5432), __byte_perm(v.z, v.w, 0x5432));
      }
      *reinterpret_cast<uint4*>(dst + p0) = v;
    }
    if (sh > 0 && lane < 8) {  // positions sh .. 7 and 256 .. 255 + sh
      const int p = lane < 8 - sh ? sh + lane : kCols + lane - (8 - sh);
      dst[p] = src[p];
    }
  }
}

// dl of the tile, in place of its logits x: (exp(x - lse) - target) *
// rowscale, 0 for rows past N and columns >= V.
template <bool kFull>
__device__ __forceinline__ void dl_values(float (&x)[128], int col0, int vocab, int t,
                                          const bool (&live)[2], const float (&nl)[2],
                                          const float (&rs)[2], const int (&y)[2], float low,
                                          float label_target) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col0 + 8 * i + 2 * t + e;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float& v = x[4 * i + 2 * h + e];
        const float p = ex2(fmaf(v, kLog2e, nl[h]));
        const float g = (p - (col == y[h] ? label_target : low)) * rs[h];
        v = live[h] && (kFull || col < vocab) ? g : 0.f;
      }
    }
  }
}

// One step of the column sums' reduce-scatter: of the kHalf * 2 sums j the
// thread holds (sum j in x[4 (j / 2) + j % 2]), it keeps the lower or upper
// kHalf, as its lane bit kHalf / 2 says, and adds its partner's copy of them.
template <int kHalf>
__device__ __forceinline__ void scatter_step(float (&x)[128], int lane) {
  const bool upper = (lane & (kHalf / 2)) != 0;
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    float& lo = x[4 * (j >> 1) + (j & 1)];
    const float hi = x[4 * ((j + kHalf) >> 1) + ((j + kHalf) & 1)];
    const float send = upper ? lo : hi;
    const float keep = upper ? hi : lo;
    lo = keep + __shfl_xor_sync(0xffffffffu, send, kHalf / 2);
  }
}

// The tile's column sums of dl over the block's 128 rows, in a fixed order:
// the thread's two rows, then the warp's eight row groups (lanes 4 g + t,
// g = 0..7) by a reduce-scatter over lane bits 4, 3, 2, after which lane
// (g, t) holds columns 32 g + 8 q + 2 t + e (q < 4, e < 2); written to the
// warp's row of sums (column c at c + 4 (c / 32)), then, past a consumer
// barrier, added over the eight warps in warp order into the band's row.
// The sums are one buffer: a barrier before the writes keeps them behind
// the previous tile's reads.
__device__ __forceinline__ void band_sums(float (&x)[128], float* sums, float* band, int col0,
                                          int vocab, int warp, int lane, int g, int t) {
  // j = 2 i + e indexes the 64 column sums; they live in x[4 i + e]
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    x[4 * i] += x[4 * i + 2];
    x[4 * i + 1] += x[4 * i + 3];
  }
  scatter_step<32>(x, lane);
  scatter_step<16>(x, lane);
  scatter_step<8>(x, lane);
  consumer_sync(kConsumerThreads);  // every warp has read the previous tile's sums
  float* row = sums + warp * kSumPitch;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = 32 * g + 8 * q + 2 * t;
    *reinterpret_cast<float2*>(row + c + 4 * g) = make_float2(x[4 * q], x[4 * q + 1]);
  }
  consumer_sync(kConsumerThreads);
  const int tid = threadIdx.x;
  if (col0 + tid < vocab) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kConsumerWarps; ++w) acc += sums[w * kSumPitch + tid + 4 * (tid >> 5)];
    band[col0 + tid] = acc;
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
ce_walk_kernel(const __grid_constant__ CUtensorMap hmap,  // hidden (N, D), 64 x 128 boxes
               const __grid_constant__ CUtensorMap wmap,  // table (V, D), 64 x 256 boxes
               const __grid_constant__ CUtensorMap bmap,  // bias (V,) f32, 256-value boxes
               const Args a) {
  constexpr int kStages = ring_stages(kMode);
  constexpr bool kStaged = kMode != kFwd;  // bf16 stores through the staged tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_1024(smem_raw);  // [slot][A 128 x 128 B | B 256 x 128 B | bias]
  unsigned char* rest = ring + kStages * kSlot;
  uint16_t* tile_s = reinterpret_cast<uint16_t*>(rest);  // save, dl: [128][kTilePitch] bf16
  if (kStaged) rest += kTileBytes;
  float* sums = reinterpret_cast<float*>(rest);          // dl: [warp][kSumPitch]
  if (kMode == kDl) rest += kSumBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(rest);
  uint64_t* empty = full + kStages;
  uint64_t* tile_full = empty + kStages;  // the staged tile written (consumer warps)
  uint64_t* tile_empty = tile_full + 1;   // ... and read out (storer warps)
  // the bf16 store of a tile: (N, ld) out, columns < limit; a run's staged
  // tiles are its tiles with col0 < limit, a prefix of the run
  const size_t ld = kMode == kDl ? a.vocab : a.v_main;
  const int limit = kMode == kDl ? a.vocab : a.v_main;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * kRows;
  const int ntiles = (a.vocab + kCols - 1) / kCols;
  const int t_begin = static_cast<int>(static_cast<int64_t>(blockIdx.y) * ntiles / gridDim.y);
  const int t_end = static_cast<int>(static_cast<int64_t>(blockIdx.y + 1) * ntiles / gridDim.y);
  const int nkb = a.d / kDepth;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    mbar_init(tile_full, kConsumerWarps);
    mbar_init(tile_empty, kStorerWarps);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // producer: slice s is depth block s % nkb of tile t_begin + s / nkb;
    // a tile's last slice brings its biases
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0) {
      const int nslices = (t_end - t_begin) * nkb;
      int slot = 0, phase = 0;
      for (int s = 0; s < nslices; ++s) {
        if (s >= kStages) mbar_wait(&empty[slot], phase ^ 1);
        const int tile = t_begin + s / nkb;
        const int kb = s % nkb;
        const bool last = kb == nkb - 1;
        unsigned char* dst = ring + slot * kSlot;
        mbar_expect_tx(&full[slot], kASlice + kBSlice + (last ? kSide : 0));
        tma_load_2d(dst, &hmap, &full[slot], kb * kDepth, row0);
        tma_load_2d(dst + kASlice, &wmap, &full[slot], kb * kDepth, tile * kCols);
        if (last) tma_load_1d(dst + kASlice + kBSlice, &bmap, &full[slot], tile * kCols);
        if (++slot == kStages) {
          slot = 0;
          phase ^= 1;
        }
      }
    } else if (kStaged && warp > kConsumerWarps) {
      // storers: the u-th staged tile of the run, once the consumers have
      // written it, out to device memory while they walk the next tile
      const int sw = warp - kConsumerWarps - 1;
      for (int u = 0; t_begin + u < t_end && (t_begin + u) * kCols < limit; ++u) {
        mbar_wait(tile_full, u & 1);
        write_tile(tile_s, a.out, ld, row0, a.n, (t_begin + u) * kCols, limit, sw, lane);
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
  const int row_base = row0 + 64 * wg + 16 * w;  // the warp's 16 rows; the thread's: + g + 8 h
  bool live[2];
  float nl[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
  int y[2] = {-1, -1};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_base + g + 8 * h;
    live[h] = row < a.n;
    if (kMode == kDl && live[h]) {
      nl[h] = -a.lse[row] * kLog2e;
      rs[h] = a.rowscale[row];
      y[h] = a.labels[row];
    }
  }
  const float label_target = a.low + a.conf_low;
  float m[2] = {kFloor, kFloor}, s[2] = {0.f, 0.f}, z[2] = {0.f, 0.f};
  const int rr = 64 * wg + 16 * w + g;  // the thread's block row (h = 0)

  float acc[128];
#pragma unroll
  for (int x = 0; x < 128; ++x) acc[x] = 0.f;
  int slot = 0, phase = 0;
  auto advance = [&]() {
    if (++slot == kStages) {
      slot = 0;
      phase ^= 1;
    }
  };
  for (int tile = t_begin; tile < t_end; ++tile) {
    for (int kb = 0; kb < nkb; ++kb) {
      mbar_wait(&full[slot], phase);
      const unsigned char* base = ring + slot * kSlot;
#pragma unroll
      for (int x = 0; x < 128; ++x) fence_operand(acc[x]);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wgmma_m64n256k16_bf16_ss(acc, desc_sw128(base + wg * (kASlice / 2) + 32 * j),
                                 desc_sw128(base + kASlice + 32 * j), (kb | j) != 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int x = 0; x < 128; ++x) fence_operand(acc[x]);
      if (kb != nkb - 1) {
        release(empty, slot);
        advance();
      }
    }
    // tile complete: the logits x = acc + bias in place, from the slot's
    // biases; then the slot is free
    const int col0 = tile * kCols;
    const float* bt = reinterpret_cast<const float*>(ring + slot * kSlot + kASlice + kBSlice);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float2 b = *reinterpret_cast<const float2*>(bt + 8 * i + 2 * t);
      acc[4 * i] += b.x;
      acc[4 * i + 1] += b.y;
      acc[4 * i + 2] += b.x;
      acc[4 * i + 3] += b.y;
    }
    release(empty, slot);
    advance();
    const bool full_tile = col0 + kCols <= a.vocab;  // every tile but the last
    if constexpr (kMode == kDl) {
      if (full_tile) {
        dl_values<true>(acc, col0, a.vocab, t, live, nl, rs, y, a.low, label_target);
      } else {
        dl_values<false>(acc, col0, a.vocab, t, live, nl, rs, y, a.low, label_target);
      }
      stage_bf16(acc, tile_s, tile_full, tile_empty, tile - t_begin, ld, row0, col0, rr, t);
      band_sums(acc, sums, a.band + static_cast<size_t>(blockIdx.x) * a.vocab, col0, a.vocab,
                warp, lane, g, t);
    } else {
      if (full_tile) {
        fold_tile<true>(acc, col0, a.vocab, t, m, s, z);
      } else {
        fold_tile<false>(acc, col0, a.vocab, t, m, s, z);
      }
      if constexpr (kMode == kSave) {
        if (col0 < a.v_main) {
          stage_bf16(acc, tile_s, tile_full, tile_empty, tile - t_begin, ld, row0, col0, rr,
                     t);
        }
        if (col0 + kCols > a.v_main) {
          // the f32 tail: column 8 i + 2 t + e of the tile is tail column
          // tc0 + 8 i + e, stored where 0 <= it < V - v_main
          const int vt = a.vocab - a.v_main;
          const int tc0 = col0 - a.v_main + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (!live[h]) continue;
            float* tail_row = a.tail + static_cast<size_t>(row_base + g + 8 * h) * vt;
#pragma unroll
            for (int i = 0; i < 32; ++i) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int tc = tc0 + 8 * i + e;
                if (static_cast<unsigned>(tc) < static_cast<unsigned>(vt)) {
                  tail_row[tc] = acc[4 * i + 2 * h + e];
                }
              }
            }
          }
        }
      }
    }
  }

  if constexpr (kMode != kDl) {
    // the quad's four column sets of each row, then the run's partial
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float om = __shfl_xor_sync(0xffffffffu, m[h], o);
        const float os = __shfl_xor_sync(0xffffffffu, s[h], o);
        const float oz = __shfl_xor_sync(0xffffffffu, z[h], o);
        const float mm = fmaxf(m[h], om);
        s[h] = fmaf(s[h], ex2((m[h] - mm) * kLog2e), os * ex2((om - mm) * kLog2e));
        m[h] = mm;
        z[h] += oz;
      }
      if (t == 0 && live[h]) {
        const size_t o = static_cast<size_t>(blockIdx.y) * a.n + row_base + g + 8 * h;
        a.part_m[o] = m[h];
        a.part_s[o] = s[h];
        a.part_z[o] = z[h];
      }
    }
  }
}

}  // namespace walk

// One walk over (ceil(N / 128) row tiles) x (runs) blocks.
template <int kMode>
int launch_walk(const void* hidden, const void* weight, const void* bias, const walk::Args& a,
                int runs, cudaStream_t s) {
  using namespace walk;
  const int ntiles = (a.vocab + kCols - 1) / kCols;
  if (a.n < 1 || a.vocab < 1 || a.d < kDepth || a.d % kDepth != 0 || runs < 1 ||
      runs > ntiles || runs > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap hmap, wmap, bmap;
  cudaError_t err = encode_2d(&hmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, hidden, a.d, a.n,
                              kDepth, kRows, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess) {
    err = encode_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, weight, a.d, a.vocab, kDepth,
                    kCols, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err == cudaSuccess) err = encode_1d_f32(&bmap, bias, a.vocab, kCols);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr size_t smem = smem_bytes(kMode);
  err = cudaFuncSetAttribute(ce_walk_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.n + kRows - 1) / kRows, runs);
  ce_walk_kernel<kMode><<<grid, kThreads, smem, s>>>(hmap, wmap, bmap, a);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode>
int launch_fwd(void* hidden, void* weight, void* bias, void* part_m, void* part_s, void* part_z,
               void* lse, void* zsum, void* lg, void* tail, int n, int d, int vocab, int v_main,
               int runs, void* stream) {
  if (kMode == walk::kSave && (v_main < 0 || v_main > vocab || v_main % 128 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  walk::Args a{};
  a.part_m = static_cast<float*>(part_m);
  a.part_s = static_cast<float*>(part_s);
  a.part_z = static_cast<float*>(part_z);
  a.out = static_cast<bf16*>(lg);
  a.tail = static_cast<float*>(tail);
  a.n = n;
  a.d = d;
  a.vocab = vocab;
  a.v_main = v_main;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int bad = launch_walk<kMode>(hidden, weight, bias, a, runs, s)) return bad;
  flash_ce_fwd_merge_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_s),
      static_cast<const float*>(part_z), static_cast<float*>(lse), static_cast<float*>(zsum), n,
      runs);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The backward contractions: grad-W and grad-h, on wgmma fed by TMA.
//
// Two GEMMs whose A operand, dl, is formed on the way in f32 and rounded to
// bf16 (mic_tpu keeps each output block resident in VMEM across its sweep;
// here a warpgroup keeps its output tile in registers across its sweep):
//   grad-h: dh (N, D) = dl (N, vext) . W (vext, D)       M = hidden rows, K = vocab
//   grad-W: demb (vext, D) = dl^T (vext, N) . h (N, D)   M = vocab, K = hidden rows
// Every operand arrives by TMA in boxes of 64 rows x 64 bf16 (8 KB, the
// 128-byte swizzle).  A consumer warpgroup owns 64 output rows x a 256-wide
// D chunk: an m64n256 f32 accumulator (128 registers a thread), fed by
// m64n256k16 products whose A (dl) is in registers and whose B -- the table
// (V, D) or hidden (N, D) as stored, rows k -- is MN-major: four boxes of
// 64 k x 64 D columns, 8 KB apart (desc_sw128_mn).  Two consumer warpgroups
// and a producer warpgroup (one TMA warp, which gives its registers away)
// make a block, as in the walk; every product group is waited for before
// its slot is freed.
//
// Save (save_kernel): the saved bf16 logits are the A boxes, rows x vocab
// as stored: K-major for grad-h, MN-major for grad-W (ldmatrix loads them
// transposed).  A block owns 128 M rows (64 a warpgroup) x one D chunk and
// sweeps K in 64-deep slices through a ring of four 48 KB slots (two A
// boxes, four B boxes, and for grad-W the lse, rowscale and labels of the
// slice's 64 hidden rows).  Per slice each thread loads its A fragments,
// forms dl = (exp(s - lse) - target) * rowscale in f32 from them (grad-W
// also adds them into its vocab rows' dbias), packs dl to bf16 and issues
// four m64n256k16.  (Read from global memory instead, grad-W's row terms
// left it at 9.5 ms against grad-h's 3.8, an H100 at the flagship step.)
// The logits are read once per D chunk, four times at D = 1024, mostly
// from L2: the chunks of an M tile are neighbouring blocks.
//
// Split (split_kernel): the logits are recomputed, as a flash-attention
// forward does.  A block owns 64 rows of the "own" operand (hidden rows for
// grad-h, table rows for grad-W), resident in shared memory over the whole D
// (64 x D bf16: D <= 1024, 128 KB), and two D chunks, one a warpgroup.  It
// sweeps the other operand in 64-row tiles, each in 256-deep groups (a
// 32 KB slot of four boxes) through a ring of three; the tile's terms
// (grad-h: its 64 biases; grad-W: its hidden rows' lse, rowscale, labels)
// arrive by TMA into a buffer of the tile's parity.  Per tile each
// warpgroup computes the 64 x 64 logits tile over the full D (s = h W^T for
// grad-h, s^T = W h^T for grad-W; both operands K-major, m64n64k16 from
// shared memory), adds the bias, forms dl in the accumulator registers,
// packs them as the A operand (the m64n64 accumulator's layout is the A
// fragment of four k16 steps, FlashAttention-3's P.V), and contracts them
// with its chunk's group of the tile, still in the ring: a tile's groups
// run in an order that ends with the block's two chunks, and a chunk's slot
// is freed after its contraction.  Each warpgroup recomputes the logits for
// itself: a logit is computed 2 ceil(D / 512) times (4 at D = 1024), so a
// split contraction does (4 + 1) x 2 N D V operations where the function
// needs 2 N D V.  The order of the depth groups differs between a row's D
// blocks; each is fixed.
//
// Grid (x = D block, y = M tile, z = K part), x fastest: the blocks of an
// M tile are neighbours and all blocks sweep K in step.  grad-h has few M
// tiles at small N, so its K sweep is cut into parts over z (ops/
// flash_ce.py::_contraction_grid), written as (parts, N, D) partials and
// summed in part order by a second kernel.  dbias: each vocab row's f32 dl
// summed over K in a fixed order (the thread's values, then its quad),
// written by D block 0.  There
// is no atomic: reruns are bit-equal.  Rows past N and vocab rows past V
// arrive as TMA's zero fill and their dl is 0; nothing past N, vext or D is
// written.  Bound: the tensor cores, 2 N D vext operations a contraction
// (the split route's recompute adds 4 x 2 N D V at D = 1024).

namespace contract {

using namespace head_wgmma;
using walk::ex2;
using walk::kLog2e;

constexpr int kBox = 64;                     // rows and bf16 depth of every TMA box
constexpr int kBoxBytes = kBox * kBox * 2;   // 8192
constexpr int kChunk = 256;                  // D columns a consumer warpgroup owns
constexpr int kGroupBytes = 4 * kBoxBytes;   // 64 rows x 256 columns: 32768
constexpr int kConsumerWarps = 8;            // two warpgroups
constexpr int kThreads = kConsumerWarps * 32 + 128;  // and the producer's warpgroup
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kSaveRows = 128;               // M rows of a save block
constexpr int kSaveStages = 4;
constexpr int kTerms = 3 * kBox * 4;         // a step's 64 rows' lse, rowscale, labels: 768 B
constexpr int kSaveAB = 2 * kBoxBytes + kGroupBytes;  // A: two boxes | B: four; 49152
constexpr int kSaveSlot = kSaveAB + 1024;    // | grad-W's terms, 1024-aligned slots
constexpr int kSplitStages = 3;
constexpr int kMaxGroups = 4;                // split: the resident operand's depth, 1024

enum Grad { kGradW = 0, kGradH = 1 };

constexpr size_t save_smem_bytes() {
  return 1024 + kSaveStages * kSaveSlot + 2 * kSaveStages * sizeof(uint64_t);
}
// own rows | ring | two tiles' terms | barriers (the ring's, own_full, and
// the terms' full and empty pairs)
constexpr size_t split_smem_bytes(int groups) {
  return 1024 + static_cast<size_t>(groups + kSplitStages) * kGroupBytes + 2 * kTerms +
         (2 * kSplitStages + 5) * sizeof(uint64_t);
}
static_assert(split_smem_bytes(kMaxGroups) <= 232448, "the split contraction must fit");

struct Args {
  const float* bias;      // (V,): split only
  const int32_t* labels;  // (N,)
  const float* lse;       // (N,)
  const float* rowscale;  // (N,)
  float* out;             // demb (vext, D); dh (N, D) or its (parts, N, D) partials
  float* dbias;           // grad-W: (vext,)
  float low, conf_low;
  int n, d, vext;
};

// A hidden row's terms of dl: -lse log2 e, rowscale, label; live: row < N.
struct Row {
  float nl, rs;
  int y;
  bool live;
};

__device__ __forceinline__ Row row_terms(const Args& a, int row) {
  Row r{0.f, 0.f, -1, row < a.n};
  if (r.live) {
    r.nl = -__ldg(a.lse + row) * kLog2e;
    r.rs = __ldg(a.rowscale + row);
    r.y = __ldg(a.labels + row);
  }
  return r;
}

// The terms of row r of a step's staged 64 (lse, rowscale, labels as
// stored), the hidden row `row`.
__device__ __forceinline__ Row staged_terms(const unsigned char* terms, int r, int row, int n) {
  const float* f = reinterpret_cast<const float*>(terms);
  return Row{-f[r] * kLog2e, f[kBox + r], reinterpret_cast<const int*>(f)[2 * kBox + r], row < n};
}

// dl of logit s: (exp(s - lse) - target) * rowscale, 0 where !live.
__device__ __forceinline__ float dl_of(float s, const Row& r, bool hit, bool live, float low,
                                       float label_target) {
  const float g = (ex2(fmaf(s, kLog2e, r.nl)) - (hit ? label_target : low)) * r.rs;
  return live ? g : 0.f;
}

// A warpgroup's m64n256 sums into out (row pitch d): rows m_row + 8 h below
// m_end, columns c0 + 8 i + 2 t (+ 1) below d.
__device__ __forceinline__ void store_acc(const float (&acc)[128], float* out, int d, int m_row,
                                          int m_end, int c0, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (m_row + 8 * h >= m_end) continue;
    float* dst = out + static_cast<size_t>(m_row + 8 * h) * d + c0 + 2 * t;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (c0 + 8 * i + 2 * t < d) {
        *reinterpret_cast<float2*>(dst + 8 * i) = make_float2(acc[4 * i + 2 * h],
                                                              acc[4 * i + 2 * h + 1]);
      }
    }
  }
}

// grad-W's dbias of the thread's two vocab rows (v_row + 8 h): its partial
// sums folded over its quad in a fixed order, written by lane t = 0.
__device__ __forceinline__ void store_dbias(float (&dsum)[2], float* dbias, int v_row, int vext,
                                            int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    dsum[h] += __shfl_xor_sync(0xffffffffu, dsum[h], 1);
    dsum[h] += __shfl_xor_sync(0xffffffffu, dsum[h], 2);
    if (t == 0 && v_row + 8 * h < vext) dbias[v_row + 8 * h] = dsum[h];
  }
}

template <int kGrad>
__global__ void __launch_bounds__(kThreads, 1)
save_kernel(const __grid_constant__ CUtensorMap lmap,  // saved logits (N, vext)
            const __grid_constant__ CUtensorMap bmap,  // B: table (V, D) or hidden (N, D)
            const __grid_constant__ CUtensorMap lse_map,  // grad-W: lse, rowscale, labels
            const __grid_constant__ CUtensorMap rs_map,   // (N,), 64-value boxes
            const __grid_constant__ CUtensorMap y_map,
            const Args a) {
  constexpr bool kW = kGrad == kGradW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_1024(smem_raw);  // [slot][A: two boxes | B: four | terms]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kSaveStages * kSaveSlot);
  uint64_t* empty = full + kSaveStages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int c0 = blockIdx.x * kChunk;
  const int m0 = blockIdx.y * kSaveRows;
  const int m_end = kW ? a.vext : a.n;
  const int nslices = ((kW ? a.n : a.vext) + kBox - 1) / kBox;
  const int s_begin = static_cast<int>(static_cast<int64_t>(blockIdx.z) * nslices / gridDim.z);
  const int s_end = static_cast<int>(static_cast<int64_t>(blockIdx.z + 1) * nslices / gridDim.z);

  if (tid == 0) {
    for (int i = 0; i < kSaveStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // producer: slice s brings the A boxes (grad-h: rows m0 + 64 x, vocab
    // 64 s..; grad-W: vocab m0 + 64 x, hidden rows 64 s..), the four B
    // boxes (rows 64 s.., the block's D chunk) and, for grad-W, the terms
    // of hidden rows 64 s..
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0) {
      int slot = 0, phase = 0;
      for (int s = s_begin; s < s_end; ++s) {
        if (s - s_begin >= kSaveStages) mbar_wait(&empty[slot], phase ^ 1);
        unsigned char* dst = ring + slot * kSaveSlot;
        mbar_expect_tx(&full[slot], kSaveAB + (kW ? kTerms : 0));
        for (int x = 0; x < 2; ++x) {
          tma_load_2d(dst + x * kBoxBytes, &lmap, &full[slot], kW ? m0 + kBox * x : kBox * s,
                      kW ? kBox * s : m0 + kBox * x);
        }
        for (int b = 0; b < 4; ++b) {
          tma_load_2d(dst + (2 + b) * kBoxBytes, &bmap, &full[slot], c0 + kBox * b, kBox * s);
        }
        if (kW) {
          tma_load_1d(dst + kSaveAB, &lse_map, &full[slot], kBox * s);
          tma_load_1d(dst + kSaveAB + kTerms / 3, &rs_map, &full[slot], kBox * s);
          tma_load_1d(dst + kSaveAB + 2 * kTerms / 3, &y_map, &full[slot], kBox * s);
        }
        if (++slot == kSaveStages) {
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
  const int m_row = m0 + 64 * wg + 16 * w + g;  // the thread's M rows: + 8 h
  const float label_target = a.low + a.conf_low;
  Row own[2] = {};  // grad-h: the thread's hidden rows
  if constexpr (!kW) {
#pragma unroll
    for (int h = 0; h < 2; ++h) own[h] = row_terms(a, m_row + 8 * h);
  }
  float acc[128];
#pragma unroll
  for (int x = 0; x < 128; ++x) acc[x] = 0.f;
  float dsum[2] = {0.f, 0.f};
  int slot = 0, phase = 0;
  for (int s = s_begin; s < s_end; ++s) {
    mbar_wait(&full[slot], phase);
    const unsigned char* base = ring + slot * kSaveSlot;
    uint32_t af[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t raw[4];
      ldsm_a<kW>(raw, base + wg * kBoxBytes, w, j, lane);
      // a[r] holds M row m_row + 8 (r & 1) at K 64 s + 16 j + 8 (r >> 1) + 2 t (+ 1)
      const int k0 = kBox * s + 16 * j + 2 * t;
      Row kr[2][2];  // grad-W: the hidden rows k0 + 8 q + e, from the slot's terms
      if constexpr (kW) {
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            kr[q][e] = staged_terms(base + kSaveAB, 16 * j + 8 * q + 2 * t + e, k0 + 8 * q + e,
                                    a.n);
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int h = r & 1;
        const int q = r >> 1;
        const float x[2] = {__uint_as_float(raw[r] << 16), __uint_as_float(raw[r] & 0xffff0000u)};
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if constexpr (kW) {
            const Row& kq = kr[q][e];
            v[e] = dl_of(x[e], kq, m_row + 8 * h == kq.y, kq.live, a.low, label_target);
            dsum[h] += v[e];
          } else {
            v[e] = dl_of(x[e], own[h], k0 + 8 * q + e == own[h].y, own[h].live, a.low,
                         label_target);
          }
        }
        af[j][r] = pack_bf16(v[0], v[1]);
      }
    }
#pragma unroll
    for (int x = 0; x < 128; ++x) fence_operand(acc[x]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wgmma_m64n256k16_bf16_rs_mn(acc, af[j],
                                  desc_sw128_mn(base + 2 * kBoxBytes + 2048 * j, kBoxBytes), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int x = 0; x < 128; ++x) fence_operand(acc[x]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) fence_operand(af[j][r]);
    release(empty, slot);
    if (++slot == kSaveStages) {
      slot = 0;
      phase ^= 1;
    }
  }
  store_acc(acc, a.out + static_cast<size_t>(blockIdx.z) * m_end * a.d, a.d, m_row, m_end, c0,
            t);
  if constexpr (kW) {
    if (blockIdx.x == 0) store_dbias(dsum, a.dbias, m_row, a.vext, t);
  }
}

template <int kGrad>
__global__ void __launch_bounds__(kThreads, 1)
split_kernel(const __grid_constant__ CUtensorMap omap,  // own: hidden (N, D) or table (V, D)
             const __grid_constant__ CUtensorMap xmap,  // swept: the other
             const __grid_constant__ CUtensorMap t0map,  // a swept tile's terms, 64-value
             const __grid_constant__ CUtensorMap t1map,  // boxes: grad-h the bias (V,);
             const __grid_constant__ CUtensorMap t2map,  // grad-W lse, rowscale, labels (N,)
             const Args a) {
  constexpr bool kW = kGrad == kGradW;
  extern __shared__ unsigned char smem_raw[];
  const int groups = (a.d + kChunk - 1) / kChunk;  // 256-deep groups of D
  unsigned char* own_s = align_1024(smem_raw);     // box b: own rows x depth 64 b..
  unsigned char* ring = own_s + groups * kGroupBytes;  // [slot][swept rows x one group]
  unsigned char* terms = ring + kSplitStages * kGroupBytes;  // [tile parity][kTerms]
  uint64_t* full = reinterpret_cast<uint64_t*>(terms + 2 * kTerms);
  uint64_t* empty = full + kSplitStages;
  uint64_t* own_full = empty + kSplitStages;
  uint64_t* terms_full = own_full + 1;   // [2]: a tile's terms arrived
  uint64_t* terms_empty = terms_full + 2;  // [2]: ... and read (the consumer warps)
  constexpr int kTermBytes = kW ? kTerms : kTerms / 3;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int own0 = blockIdx.y * kBox;
  const int n_own = kW ? a.vext : a.n;
  const int chunk0 = 2 * blockIdx.x;                // warpgroup 0's D chunk
  const int chunk1 = min(chunk0 + 1, groups - 1);   // warpgroup 1's (0's again past D)
  const int ntiles = ((kW ? a.n : a.vext) + kBox - 1) / kBox;
  const int t_begin = static_cast<int>(static_cast<int64_t>(blockIdx.z) * ntiles / gridDim.z);
  const int t_end = static_cast<int>(static_cast<int64_t>(blockIdx.z + 1) * ntiles / gridDim.z);

  if (tid == 0) {
    for (int i = 0; i < kSplitStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    mbar_init(own_full, 1);
    for (int i = 0; i < 2; ++i) {
      mbar_init(&terms_full[i], 1);
      mbar_init(&terms_empty[i], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // producer: the own rows over the whole D once, then per swept tile its
    // terms (into the buffer of the tile's parity, once the tile before the
    // last has read it) and its groups in the order (q + chunk1 + 1) mod
    // groups, ending with chunk0 and chunk1
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0) {
      mbar_expect_tx(own_full, groups * kGroupBytes);
      for (int b = 0; b < 4 * groups; ++b) {
        tma_load_2d(own_s + b * kBoxBytes, &omap, own_full, kBox * b, own0);
      }
      int slot = 0, phase = 0, u = 0;
      for (int tile = t_begin; tile < t_end; ++tile) {
        const int tb = tile - t_begin;
        unsigned char* tdst = terms + (tb & 1) * kTerms;
        if (tb >= 2) mbar_wait(&terms_empty[tb & 1], ((tb >> 1) - 1) & 1);
        mbar_expect_tx(&terms_full[tb & 1], kTermBytes);
        tma_load_1d(tdst, &t0map, &terms_full[tb & 1], kBox * tile);
        if (kW) {
          tma_load_1d(tdst + kTerms / 3, &t1map, &terms_full[tb & 1], kBox * tile);
          tma_load_1d(tdst + 2 * kTerms / 3, &t2map, &terms_full[tb & 1], kBox * tile);
        }
        for (int q = 0; q < groups; ++q, ++u) {
          const int grp = (q + chunk1 + 1) % groups;
          if (u >= kSplitStages) mbar_wait(&empty[slot], phase ^ 1);
          unsigned char* dst = ring + slot * kGroupBytes;
          mbar_expect_tx(&full[slot], kGroupBytes);
          for (int b = 0; b < 4; ++b) {
            tma_load_2d(dst + b * kBoxBytes, &xmap, &full[slot], kChunk * grp + kBox * b,
                        kBox * tile);
          }
          if (++slot == kSplitStages) {
            slot = 0;
            phase ^= 1;
          }
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
  const int mine = wg == 0 ? chunk0 : chunk1;
  const int o_row = own0 + 16 * w + g;  // the thread's own rows (M of s): + 8 h
  const float label_target = a.low + a.conf_low;
  Row own[2] = {};                      // grad-h: the thread's hidden rows
  float obias[2] = {0.f, 0.f};          // grad-W: its vocab rows' biases
  bool olive[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    olive[h] = o_row + 8 * h < n_own;
    if constexpr (kW) {
      if (olive[h]) obias[h] = __ldg(a.bias + o_row + 8 * h);
    } else {
      own[h] = row_terms(a, o_row + 8 * h);
    }
  }
  mbar_wait(own_full, 0);

  float acc[128];
#pragma unroll
  for (int x = 0; x < 128; ++x) acc[x] = 0.f;
  float s[32];  // the logits tile, overwritten by each tile's first product
#pragma unroll
  for (int x = 0; x < 32; ++x) s[x] = 0.f;
  float dsum[2] = {0.f, 0.f};
  int slot = 0, phase = 0;
  for (int tile = t_begin; tile < t_end; ++tile) {
    int held = 0;  // the slot of this warpgroup's chunk
    for (int q = 0; q < groups; ++q) {
      const int grp = (q + chunk1 + 1) % groups;
      mbar_wait(&full[slot], phase);
      const unsigned char* xs = ring + slot * kGroupBytes;
#pragma unroll
      for (int x = 0; x < 32; ++x) fence_operand(s[x]);
      wgmma_fence();
#pragma unroll
      for (int b = 0; b < 4; ++b) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_m64n64k16_bf16_ss(s, desc_sw128(own_s + (4 * grp + b) * kBoxBytes + 32 * kk),
                                  desc_sw128(xs + b * kBoxBytes + 32 * kk), (q | b | kk) != 0);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int x = 0; x < 32; ++x) fence_operand(s[x]);
      held = grp == mine ? slot : held;
      release_if(empty, slot, grp != mine);
      if (++slot == kSplitStages) {
        slot = 0;
        phase ^= 1;
      }
    }
    // s[4 i + 2 h + e]: own row o_row + 8 h, swept index x0 + 8 i + 2 t + e;
    // the logits plus bias, then dl in place, with the tile's staged terms
    const int x0 = kBox * tile;
    const int tb = tile - t_begin;
    const unsigned char* tt = terms + (tb & 1) * kTerms;
    mbar_wait(&terms_full[tb & 1], (tb >> 1) & 1);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int xc = x0 + 8 * i + 2 * t + e;
        if constexpr (kW) {
          const Row xr = staged_terms(tt, 8 * i + 2 * t + e, xc, a.n);  // hidden row xc
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float& v = s[4 * i + 2 * h + e];
            v = dl_of(v + obias[h], xr, o_row + 8 * h == xr.y, xr.live && olive[h], a.low,
                      label_target);
            dsum[h] += v;
          }
        } else {
          const bool ok = xc < a.vext;  // vocab column xc
          const float bc = reinterpret_cast<const float*>(tt)[8 * i + 2 * t + e];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float& v = s[4 * i + 2 * h + e];
            v = dl_of(v + bc, own[h], xc == own[h].y, ok && own[h].live, a.low, label_target);
          }
        }
      }
    }
    release(terms_empty, tb & 1);
    uint32_t af[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) af[j][r] = pack_bf16(s[8 * j + 2 * r], s[8 * j + 2 * r + 1]);
    }
    const unsigned char* bs = ring + held * kGroupBytes;
#pragma unroll
    for (int x = 0; x < 128; ++x) fence_operand(acc[x]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wgmma_m64n256k16_bf16_rs_mn(acc, af[j], desc_sw128_mn(bs + 2048 * j, kBoxBytes), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int x = 0; x < 128; ++x) fence_operand(acc[x]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) fence_operand(af[j][r]);
    release(empty, held);
  }
  if (wg == 0 || chunk1 != chunk0) {
    store_acc(acc, a.out + static_cast<size_t>(blockIdx.z) * n_own * a.d, a.d, o_row, n_own,
              kChunk * mine, t);
  }
  if constexpr (kW) {
    if (blockIdx.x == 0 && wg == 0) store_dbias(dsum, a.dbias, o_row, a.vext, t);
  }
}

// The operand forms of the contractions alone, for a test against a plain
// product: out (64 x 256 f32) = A (64 x 64) . B (64 x 256), B row-major (k,
// n) read MN-major through desc_sw128_mn; A row-major (m, k)
// (trans 0) or stored transposed, (k, m) (trans 1), into registers by
// ldsm_a.  One warpgroup.
__global__ void __launch_bounds__(128, 1)
probe_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
             float* out, int trans) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* buf = align_1024(smem_raw);  // A box | four B boxes
  uint64_t* bar = reinterpret_cast<uint64_t*>(buf + 5 * kBoxBytes);
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 5 * kBoxBytes);
    tma_load_2d(buf, &amap, bar, 0, 0);
    for (int b = 0; b < 4; ++b) tma_load_2d(buf + (1 + b) * kBoxBytes, &bmap, bar, kBox * b, 0);
  }
  mbar_wait(bar, 0);
  const int w = tid >> 5;
  const int lane = tid & 31;
  uint32_t af[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (trans) {
      ldsm_a<true>(af[j], buf, w, j, lane);
    } else {
      ldsm_a<false>(af[j], buf, w, j, lane);
    }
  }
  float acc[128];
#pragma unroll
  for (int x = 0; x < 128; ++x) acc[x] = 0.f;
#pragma unroll
  for (int x = 0; x < 128; ++x) fence_operand(acc[x]);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wgmma_m64n256k16_bf16_rs_mn(acc, af[j], desc_sw128_mn(buf + kBoxBytes + 2048 * j, kBoxBytes),
                                1);
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int x = 0; x < 128; ++x) fence_operand(acc[x]);
  store_acc(acc, out, 4 * kBox, 16 * w + (lane >> 2), kBox, 0, lane & 3);
}

// The 64 x 64 bf16 boxes, 128-byte swizzle, of a row-major (rows, cols) tensor.
cudaError_t box_map(CUtensorMap* map, const void* base, int cols, int rows) {
  return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, cols, rows, kBox, kBox,
                   CU_TENSOR_MAP_SWIZZLE_128B);
}

// lse, rowscale and the labels (their bits: TMA copies them unchanged), in
// 64-value boxes.
cudaError_t row_maps(const Args& a, CUtensorMap* lse_map, CUtensorMap* rs_map,
                     CUtensorMap* y_map) {
  cudaError_t err = encode_1d_f32(lse_map, a.lse, a.n, kBox);
  if (err == cudaSuccess) err = encode_1d_f32(rs_map, a.rowscale, a.n, kBox);
  if (err == cudaSuccess) err = encode_1d_f32(y_map, a.labels, a.n, kBox);
  return err;
}

bool bad_shape(const Args& a) {
  return a.n < 1 || a.vext < 1 || a.d < kBox || a.d % kBox != 0;
}

template <int kGrad>
int launch_save(const void* hidden, const void* weight, const void* logits, const Args& a,
                int parts, cudaStream_t s) {
  constexpr bool kW = kGrad == kGradW;
  const int m_tiles = ((kW ? a.vext : a.n) + kSaveRows - 1) / kSaveRows;
  const int nslices = ((kW ? a.n : a.vext) + kBox - 1) / kBox;
  if (bad_shape(a) || a.vext % 128 != 0 || parts < 1 || parts > nslices || m_tiles > 65535 ||
      parts > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap lmap, bmap, lse_map, rs_map, y_map;
  cudaError_t err = box_map(&lmap, logits, a.vext, a.n);
  if (err == cudaSuccess) {
    err = kW ? box_map(&bmap, hidden, a.d, a.n) : box_map(&bmap, weight, a.d, a.vext);
  }
  if (err == cudaSuccess) err = row_maps(a, &lse_map, &rs_map, &y_map);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr size_t smem = save_smem_bytes();
  err = cudaFuncSetAttribute(save_kernel<kGrad>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.d + kChunk - 1) / kChunk, m_tiles, parts);
  save_kernel<kGrad><<<grid, kThreads, smem, s>>>(lmap, bmap, lse_map, rs_map, y_map, a);
  return static_cast<int>(cudaGetLastError());
}

template <int kGrad>
int launch_split(const void* hidden, const void* weight, const Args& a, int parts,
                 cudaStream_t s) {
  constexpr bool kW = kGrad == kGradW;
  const int groups = (a.d + kChunk - 1) / kChunk;
  const int own_tiles = ((kW ? a.vext : a.n) + kBox - 1) / kBox;
  const int ntiles = ((kW ? a.n : a.vext) + kBox - 1) / kBox;
  if (bad_shape(a) || groups > kMaxGroups || parts < 1 || parts > ntiles ||
      own_tiles > 65535 || parts > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap hmap, wmap, t0map, t1map, t2map;
  cudaError_t err = box_map(&hmap, hidden, a.d, a.n);
  if (err == cudaSuccess) err = box_map(&wmap, weight, a.d, a.vext);
  if (err == cudaSuccess) {
    err = kW ? row_maps(a, &t0map, &t1map, &t2map) : encode_1d_f32(&t0map, a.bias, a.vext, kBox);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = split_smem_bytes(groups);
  err = cudaFuncSetAttribute(split_kernel<kGrad>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((groups + 1) / 2, own_tiles, parts);
  split_kernel<kGrad><<<grid, kThreads, smem, s>>>(kW ? wmap : hmap, kW ? hmap : wmap, t0map,
                                                   kW ? t1map : t0map, kW ? t2map : t0map, a);
  return static_cast<int>(cudaGetLastError());
}

Args args(void* bias, void* labels, void* lse, void* rowscale, void* out, void* dbias, float low,
          float conf_low, int n, int d, int vext) {
  return Args{static_cast<const float*>(bias), static_cast<const int32_t*>(labels),
              static_cast<const float*>(lse), static_cast<const float*>(rowscale),
              static_cast<float*>(out), static_cast<float*>(dbias), low, conf_low, n, d, vext};
}

}  // namespace contract

}  // namespace

// runs consecutive vocab-tile runs per row tile; part_* are (runs, N) scratch.
extern "C" int mic_flash_ce_fwd_bf16(void* hidden, void* weight, void* bias, void* part_m,
                                     void* part_s, void* part_z, void* lse, void* zsum, int n,
                                     int d, int vocab, int runs, void* stream) {
  return launch_fwd<walk::kFwd>(hidden, weight, bias, part_m, part_s, part_z, lse, zsum, nullptr,
                                nullptr, n, d, vocab, 0, runs, stream);
}

// The same, also storing the logits: columns < v_main (a multiple of 128)
// as bf16 into logits_main (N, v_main), the rest as f32 into tail.
extern "C" int mic_flash_ce_fwd_save_bf16(void* hidden, void* weight, void* bias, void* part_m,
                                          void* part_s, void* part_z, void* lse, void* zsum,
                                          void* logits_main, void* tail, int n, int d,
                                          int vocab, int v_main, int runs, void* stream) {
  return launch_fwd<walk::kSave>(hidden, weight, bias, part_m, part_s, part_z, lse, zsum,
                                 logits_main, tail, n, d, vocab, v_main, runs, stream);
}

// grad-W: demb rows [0, vext) and dbias [0, vext).  saved == 0: the logits
// recomputed over V = vext columns (bias read, logits unused; D <= 1024);
// saved != 0: read from logits (N, vext) (bias unused), vext a multiple of
// 128.
extern "C" int mic_flash_ce_gw_bf16(void* hidden, void* weight, void* bias, void* logits,
                                    void* labels, void* lse, void* rowscale, void* demb,
                                    void* dbias, float low, float conf_low, int n, int d,
                                    int vext, int saved, void* stream) {
  const contract::Args a = contract::args(bias, labels, lse, rowscale, demb, dbias, low,
                                          conf_low, n, d, vext);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return saved ? contract::launch_save<contract::kGradW>(hidden, weight, logits, a, 1, s)
               : contract::launch_split<contract::kGradW>(hidden, weight, a, 1, s);
}

// grad-h: dh (N, D) f32 over the vocab columns [0, vext), as grad-W, the
// vocab sweep cut into `parts` consecutive parts: with parts > 1 each part
// writes its (N, D) partial into part, (parts, N, D) f32 scratch, and the
// partials are summed into dh in part order.
extern "C" int mic_flash_ce_gh_bf16(void* hidden, void* weight, void* bias, void* logits,
                                    void* labels, void* lse, void* rowscale, void* dh, void* part,
                                    float low, float conf_low, int n, int d, int vext, int saved,
                                    int parts, void* stream) {
  const contract::Args a = contract::args(bias, labels, lse, rowscale, parts > 1 ? part : dh,
                                          nullptr, low, conf_low, n, d, vext);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = saved ? contract::launch_save<contract::kGradH>(hidden, weight, logits, a,
                                                                  parts, s)
                        : contract::launch_split<contract::kGradH>(hidden, weight, a, parts, s);
  if (bad || parts == 1) return bad;
  flash_ce_band_sum_kernel<<<(n * d + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(dh), parts, n * d);
  return static_cast<int>(cudaGetLastError());
}

// The contractions' operand forms alone (contract::probe_kernel): a (64, 64)
// bf16, b (64, 256) bf16, out (64, 256) f32.
extern "C" int mic_flash_ce_operand_probe(void* a, void* b, void* out, int trans, void* stream) {
  using namespace contract;
  CUtensorMap amap, bmap;
  cudaError_t err = box_map(&amap, a, kBox, kBox);
  if (err == cudaSuccess) err = box_map(&bmap, b, 4 * kBox, kBox);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int smem = 1024 + 5 * kBoxBytes + 8;
  probe_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(amap, bmap,
                                                                     static_cast<float*>(out),
                                                                     trans);
  return static_cast<int>(cudaGetLastError());
}

// band_part is (ceil(N / 128), V) f32 scratch; every live entry is written.
extern "C" int mic_flash_ce_dl_bf16(void* hidden, void* weight, void* bias, void* labels,
                                    void* lse, void* rowscale, void* dl, void* band_part,
                                    void* dbias, float low, float conf_low, int n, int d,
                                    int vocab, int runs, void* stream) {
  walk::Args a{};
  a.lse = static_cast<const float*>(lse);
  a.rowscale = static_cast<const float*>(rowscale);
  a.labels = static_cast<const int32_t*>(labels);
  a.out = static_cast<bf16*>(dl);
  a.band = static_cast<float*>(band_part);
  a.low = low;
  a.conf_low = conf_low;
  a.n = n;
  a.d = d;
  a.vocab = vocab;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int bad = launch_walk<walk::kDl>(hidden, weight, bias, a, runs, s)) return bad;
  const int bands = (n + walk::kRows - 1) / walk::kRows;
  flash_ce_band_sum_kernel<<<(vocab + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(band_part), static_cast<float*>(dbias), bands, vocab);
  return static_cast<int>(cudaGetLastError());
}
