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
#include <mma.h>
#include <stdint.h>

#include "head_wgmma.cuh"

namespace {

using nvcuda::wmma::accumulator;
using nvcuda::wmma::col_major;
using nvcuda::wmma::fragment;
using nvcuda::wmma::matrix_a;
using nvcuda::wmma::matrix_b;
using nvcuda::wmma::mem_row_major;
using nvcuda::wmma::row_major;
using bf16 = __nv_bfloat16;

constexpr float kNeg = -FLT_MAX;  // finfo(float32).min, NEG of mic_tpu/ops/flash_ce.py

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

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

// dbias[v] = sum of the row bands' partials, in band order.
__global__ void flash_ce_band_sum_kernel(const float* __restrict__ band_part,
                                         float* __restrict__ dbias, int bands, int vocab) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= vocab) return;
  float acc = 0.f;
  for (int b = 0; b < bands; ++b) acc += band_part[static_cast<size_t>(b) * vocab + v];
  dbias[v] = acc;
}

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
// The backward contractions: grad-W and grad-h.
//
// mic_tpu keeps the whole (VC, D) demb block, or the (RB, D) dh block,
// resident in VMEM across its sweep, so each is written once.  A block here
// owns 32 output rows over the full D instead: 32 vocab rows of demb
// (grad-W), or 32 hidden rows of dh (grad-h), with the 32 x D f32 sums in
// the registers of its 8 warps (warp w holds the 16-wide column fragments
// w, w + 8, ...; at D = 1024 that is 128 floats a thread).  The block sweeps
// the other operand in tiles of 32 rows (hidden rows for grad-W, vocab rows
// for grad-h), each tile X (32 x D bf16) loaded once through a two-stage
// cp.async ring, and per tile:
//
//   1. the 32 x 32 logits tile: recomputed as own (32 x D, resident) @ X^T,
//      the depth split in two halves over the warps and the halves added in
//      a fixed order, plus the bias (split); or the saved bf16 logits of
//      the tile, staged beside X (save);
//   2. dl = (exp(s - lse) - target) * rowscale in f32, zero outside the
//      vocab and past row N, and its bf16 copy; grad-W sums each vocab row's
//      f32 dl into its dbias;
//   3. acc += dl (own x swept) @ X (32 x D), bf16 WMMA with f32 sums.
//
// Splitting D over blocks instead would recompute the logits once per
// slice; keeping full D costs one block an SM (205 KB of shared memory at
// D = 1024 for the split route: own, two X stages, the halves, the dl
// tile and the output staging; 141 KB for save).  Every sum has one order
// and there are no atomics: reruns are bit-equal.  The bound is the tensor
// cores: 2 x 2 N D V operations a split contraction, 2 N D v_main a save
// one; the design is set by the mma.sync fragment loads from shared memory
// (two for each product in step 1), far from it in this first version.

constexpr int kOB = 32;           // output rows per block
constexpr int kSB = 32;           // swept rows per tile
constexpr int kBThreads = 256;    // 8 warps
constexpr int kBWarps = kBThreads / 32;
constexpr int kColFrags = 8;      // 16-wide output column fragments per warp at most
constexpr int kMaxD = kBWarps * kColFrags * 16;  // 1024
constexpr int kLdT = kSB + 8;     // bf16 pitch of the dl and saved-logits tiles
constexpr int kLdP = kSB + 4;     // f32 pitch of the recomputed halves
constexpr int kLdO = 16 + 4;      // f32 pitch of a warp's output staging fragment
constexpr int kGradW = 0;
constexpr int kGradH = 1;

struct BwdArgs {
  const bf16* hidden;     // (N, D)
  const bf16* weight;     // (V, D)
  const float* bias;      // (V,), split only
  const bf16* logits;     // (N, v_main) saved logits, save only
  const int32_t* labels;  // (N,)
  const float* lse;       // (N,)
  const float* rowscale;  // (N,)
  float* out;             // grad-W: (vext, D) rows of demb; grad-h: (N, D)
  float* dbias;           // grad-W: (vext,)
  float low, conf_low;
  int n, d;
  int vext;               // vocab columns covered: V (split) or v_main (save)
};

size_t bwd_smem_bytes(int d, bool saved) {
  const size_t ldx = static_cast<size_t>(d) + 8;
  size_t bytes = 2 * kSB * ldx * sizeof(bf16)                  // X, two stages
                 + kOB * kLdT * sizeof(bf16)                   // the dl tile
                 + kBWarps * 16 * kLdO * sizeof(float);        // output staging
  if (saved) {
    bytes += 2 * kSB * kLdT * sizeof(bf16);                    // saved logits, two stages
  } else {
    bytes += kOB * ldx * sizeof(bf16) + 2 * kOB * kLdP * sizeof(float);  // own, halves
  }
  return bytes;
}

template <int kGrad, bool kSaved>
__global__ void __launch_bounds__(kBThreads, 1) flash_ce_bwd_kernel(const BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int d = a.d;
  const int ldx = d + 8;
  bf16* x_s = reinterpret_cast<bf16*>(smem_raw);        // [2][kSB][ldx]
  bf16* dl_s = x_s + 2 * kSB * ldx;                      // [kOB][kLdT]
  float* out_s = reinterpret_cast<float*>(dl_s + kOB * kLdT);  // [warps][16][kLdO]
  bf16* rest = reinterpret_cast<bf16*>(out_s + kBWarps * 16 * kLdO);
  bf16* lg_s = rest;                                     // save: [2][kSB][kLdT]
  bf16* own_s = rest;                                    // split: [kOB][ldx]
  float* half_s = reinterpret_cast<float*>(own_s + kOB * ldx);  // split: [2][kOB][kLdP]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int own0 = blockIdx.x * kOB;
  // grad-W owns vocab rows and sweeps hidden rows; grad-h the reverse
  const int own_end = kGrad == kGradW ? a.vext : a.n;
  const int sweep_end = kGrad == kGradW ? a.n : a.vext;
  const bf16* own_src = kGrad == kGradW ? a.weight : a.hidden;
  const bf16* x_src = kGrad == kGradW ? a.hidden : a.weight;
  const int ntiles = (sweep_end + kSB - 1) / kSB;
  const int vec = d / 8;  // 16-byte pieces of a row

  // rows past the operand's end re-read its last row; their dl is zero
  auto load_tile = [&](int t, int stage) {
    const int s0 = t * kSB;
    bf16* dst = x_s + stage * kSB * ldx;
    for (int i = tid; i < kSB * vec; i += kBThreads) {
      const int r = i / vec;
      const int c = (i % vec) * 8;
      const int row = min(s0 + r, sweep_end - 1);
      cp_async16(dst + r * ldx + c, x_src + static_cast<size_t>(row) * d + c);
    }
    if constexpr (kSaved) {
      // the (hidden rows x vocab columns) block of the saved logits
      if (tid < kSB * (kSB / 8)) {
        const int r = tid / (kSB / 8);
        const int c = (tid % (kSB / 8)) * 8;
        const int row = min((kGrad == kGradW ? s0 : own0) + r, a.n - 1);
        const int col = (kGrad == kGradW ? own0 : s0) + c;
        cp_async16(lg_s + stage * kSB * kLdT + r * kLdT + c,
                   a.logits + static_cast<size_t>(row) * a.vext + col);
      }
    }
  };

  if constexpr (!kSaved) {
    for (int i = tid; i < kOB * vec; i += kBThreads) {
      const int r = i / vec;
      const int c = (i % vec) * 8;
      const int row = min(own0 + r, own_end - 1);
      cp_async16(own_s + r * ldx + c, own_src + static_cast<size_t>(row) * d + c);
    }
  }
  load_tile(0, 0);
  cp_async_commit();

  const int nf = d / 16;
  fragment<accumulator, 16, 16, 16, float> acc[2][kColFrags];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kColFrags; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.f);

  // step 2's elements: thread -> own row eo, swept rows es .. es + 3
  const int eo = tid >> 3;
  const int es = (tid & 7) * 4;
  float dbias_acc = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    // the other stage was last read in the previous tile's step 3
    if (t + 1 < ntiles) load_tile(t + 1, (t + 1) & 1);
    cp_async_commit();
    const bf16* xt = x_s + (t & 1) * kSB * ldx;
    const int s0 = t * kSB;

    if constexpr (!kSaved) {
      // step 1: warp w computes fragment (w & 1, (w >> 1) & 1) over depth half w >> 2
      const int fi = warp & 1;
      const int fj = (warp >> 1) & 1;
      const int half = warp >> 2;
      fragment<accumulator, 16, 16, 16, float> c;
      nvcuda::wmma::fill_fragment(c, 0.f);
      const int k_end = (half + 1) * (d / 2);
      for (int k = half * (d / 2); k < k_end; k += 16) {
        fragment<matrix_a, 16, 16, 16, bf16, row_major> fa;
        fragment<matrix_b, 16, 16, 16, bf16, col_major> fb;
        nvcuda::wmma::load_matrix_sync(fa, own_s + 16 * fi * ldx + k, ldx);
        nvcuda::wmma::load_matrix_sync(fb, xt + 16 * fj * ldx + k, ldx);
        nvcuda::wmma::mma_sync(c, fa, fb, c);
      }
      nvcuda::wmma::store_matrix_sync(half_s + (half * kOB + 16 * fi) * kLdP + 16 * fj, c, kLdP,
                                      mem_row_major);
      __syncthreads();
    }

    // step 2
    {
      const bf16* lt = lg_s + (t & 1) * kSB * kLdT;
      float part = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int sw = es + q;
        const int row = kGrad == kGradW ? s0 + sw : own0 + eo;
        const int col = kGrad == kGradW ? own0 + eo : s0 + sw;
        float g = 0.f;
        if (row < a.n && col < a.vext) {
          float logit;
          if constexpr (kSaved) {
            logit = __bfloat162float(kGrad == kGradW ? lt[sw * kLdT + eo] : lt[eo * kLdT + sw]);
          } else {
            logit = half_s[eo * kLdP + sw] + half_s[(kOB + eo) * kLdP + sw] + a.bias[col];
          }
          const float p = expf(logit - a.lse[row]);
          const float target = a.low + a.conf_low * (col == a.labels[row] ? 1.f : 0.f);
          g = (p - target) * a.rowscale[row];
        }
        part += g;
        dl_s[eo * kLdT + sw] = __float2bfloat16(g);
      }
      if constexpr (kGrad == kGradW) {
        // the eight threads of one vocab row are neighbouring lanes
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        part += __shfl_xor_sync(0xffffffffu, part, 4);
        dbias_acc += part;
      }
    }
    __syncthreads();

    // step 3
#pragma unroll
    for (int k16 = 0; k16 < kSB; k16 += 16) {
      fragment<matrix_a, 16, 16, 16, bf16, row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        nvcuda::wmma::load_matrix_sync(fa[i], dl_s + 16 * i * kLdT + k16, kLdT);
#pragma unroll
      for (int j = 0; j < kColFrags; ++j) {
        const int f = warp + kBWarps * j;
        if (f < nf) {
          fragment<matrix_b, 16, 16, 16, bf16, row_major> fb;
          nvcuda::wmma::load_matrix_sync(fb, xt + k16 * ldx + 16 * f, ldx);
          nvcuda::wmma::mma_sync(acc[0][j], fa[0], fb, acc[0][j]);
          nvcuda::wmma::mma_sync(acc[1][j], fa[1], fb, acc[1][j]);
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);

  // each warp writes its fragments through its own 16 x 16 staging tile
  float* st = out_s + warp * 16 * kLdO;
  const int sr = lane >> 1;
  const int sc = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < kColFrags; ++j) {
      const int f = warp + kBWarps * j;
      if (f < nf) {
        nvcuda::wmma::store_matrix_sync(st, acc[i][j], kLdO, mem_row_major);
        __syncwarp();
        const int row = own0 + 16 * i + sr;
        if (row < own_end) {
          float4* dst = reinterpret_cast<float4*>(a.out + static_cast<size_t>(row) * d + 16 * f + sc);
          dst[0] = *reinterpret_cast<const float4*>(st + sr * kLdO + sc);
          dst[1] = *reinterpret_cast<const float4*>(st + sr * kLdO + sc + 4);
        }
        __syncwarp();
      }
    }
  }
  if constexpr (kGrad == kGradW) {
    if ((tid & 7) == 0 && own0 + eo < own_end) a.dbias[own0 + eo] = dbias_acc;
  }
}

template <int kGrad, bool kSaved>
int launch_bwd(const BwdArgs& a, void* stream) {
  const size_t smem = bwd_smem_bytes(a.d, kSaved);
  if (a.n < 1 || a.vext < 1 || a.d < 64 || a.d % 64 != 0 || a.d > kMaxD || smem > 232448 ||
      (kSaved && a.vext % kSB != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(flash_ce_bwd_kernel<kGrad, kSaved>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int own_end = kGrad == kGradW ? a.vext : a.n;
  flash_ce_bwd_kernel<kGrad, kSaved><<<(own_end + kOB - 1) / kOB, kBThreads, smem,
                                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

BwdArgs bwd_args(void* hidden, void* weight, void* bias, void* logits, void* labels, void* lse,
                 void* rowscale, void* out, void* dbias, float low, float conf_low, int n, int d,
                 int vext) {
  return BwdArgs{static_cast<const bf16*>(hidden), static_cast<const bf16*>(weight),
                 static_cast<const float*>(bias), static_cast<const bf16*>(logits),
                 static_cast<const int32_t*>(labels), static_cast<const float*>(lse),
                 static_cast<const float*>(rowscale), static_cast<float*>(out),
                 static_cast<float*>(dbias), low, conf_low, n, d, vext};
}

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
// recomputed over V = vext columns (bias read, logits unused); saved != 0:
// read from logits (N, vext) (bias unused), vext a multiple of 32.
extern "C" int mic_flash_ce_gw_bf16(void* hidden, void* weight, void* bias, void* logits,
                                    void* labels, void* lse, void* rowscale, void* demb,
                                    void* dbias, float low, float conf_low, int n, int d,
                                    int vext, int saved, void* stream) {
  const BwdArgs a = bwd_args(hidden, weight, bias, logits, labels, lse, rowscale, demb, dbias, low,
                             conf_low, n, d, vext);
  return saved ? launch_bwd<kGradW, true>(a, stream) : launch_bwd<kGradW, false>(a, stream);
}

// grad-h: dh (N, D) f32 over the vocab columns [0, vext), as grad-W.
extern "C" int mic_flash_ce_gh_bf16(void* hidden, void* weight, void* bias, void* logits,
                                    void* labels, void* lse, void* rowscale, void* dh, float low,
                                    float conf_low, int n, int d, int vext, int saved,
                                    void* stream) {
  const BwdArgs a = bwd_args(hidden, weight, bias, logits, labels, lse, rowscale, dh, nullptr, low,
                             conf_low, n, d, vext);
  return saved ? launch_bwd<kGradH, true>(a, stream) : launch_bwd<kGradH, false>(a, stream);
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
