// LayerNorm folded into the prologue of a dense: out = layer_norm(x) @ W + b.
//
// Replaces mic_tpu/ops/ln_gemm.py::ln_gemm (_ln_gemm_kernel), the decode
// step's ln_self -> fused q/k/v projection under MIC_TPU_EXPERIMENTAL=ln_qkv.
// Rounding points, as the TPU kernel's: f32 statistics (mean, then the mean
// of squared deviations), xn = (x - mean) * rsqrt(var + eps) * scale + bias
// in f32 and rounded to bf16, an f32 product with W, the sum rounded to
// bf16, then the bf16 bias added (one more bf16 rounding).
//
// Bound: operations, at the flagship step (N = 1024 rows, D = 1024,
// O = 3072) 6.4 GFLOP against 14 MB; bytes at small N (N = 32: W's 6 MB).
// Design: a 128 x 192 output tile of m64n192k16 wgmma (two consumer
// warpgroups of 64 rows, 96 f32 sums a thread; 128 blocks at the
// flagship), raw x read K-major and W MN-major as stored (desc_sw128_mn,
// wgmma's transpose bit), both by TMA through a ring of five 40 KB slots
// that a producer warp fills (head_wgmma.cuh's pipeline), with the
// LayerNorm applied to the A operand on chip:
//   - while the first five slices load, every thread of the block takes
//     part in its rows' statistics (a warp a row, four rows a warp at once,
//     D <= 1024 held in registers between the two passes); pairs of column
//     tiles of a row band run as clusters of 2, each block taking half the
//     band's 128 rows and storing their mean and rstd into both blocks'
//     shared memory (at the flagship the statistics cost 0.011 ms a block
//     alone, 0.007 in pairs; clusters of 4 missed a wave, 0.049 ms);
//   - each consumer warpgroup normalises its own 64 x 64 box of raw x in
//     place once the slot has landed (a thread a 16-byte piece column of
//     four rows, their mean and rstd in registers, the slice's LN scale and
//     shift loaded during the previous slice's products), zeroing the
//     columns past D (TMA's zero fill would normalise to shift - mean *
//     rstd * scale, and W's rows past D, TMA's zeros, cancel a finite xn
//     only), fences it to the async proxy and meets its warpgroup at a
//     barrier; then the slice's four products, one group in flight, so
//     normalising slice s + 1 overlaps slice s's products.  At 96 sums a
//     thread the normalisation has the registers it needs: with 128 (a 128
//     x 256 tile) ptxas serialized every product (C7515), and the producer
//     warpgroup's three idle warps normalising for the consumers were
//     bound by their arithmetic (0.034 ms at the flagship; 0.030 here).
// Rows past N arrive as zeros, are given mean 0 and rstd 0, and are never
// written.  An unsplit tile is staged in shared memory and finished (the
// sum rounded to bf16, the bias added, rounded again) in 16-byte runs;
// where the tiles leave SMs idle (N = 32: 16 tiles) the depth is cut into
// splits of whole slices (ops/ln_gemm.py::ln_splits), each split computing
// its rows' full-D statistics, and the f32 partials are summed in split
// order by gemm_wgmma::split_sum_kernel.  Every sum has one fixed order:
// reruns are bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace head_wgmma;
using gemm_wgmma::kBox;
using gemm_wgmma::kBoxBytes;
using gemm_wgmma::kConsumerWarps;
using gemm_wgmma::kRows;
using gemm_wgmma::kThreads;

constexpr int kCols = 192;                        // output columns of a block
constexpr int kWBoxes = kCols / kBox;             // W boxes of a slice
constexpr int kSlot = (2 + kWBoxes) * kBoxBytes;  // A: two boxes | W: three; 40960
constexpr int kStages = 5;
constexpr int kSums = kCols / 2;                  // f32 sums a consumer thread
constexpr int kStagePitch = kCols + 8;            // f32 of a staged row
constexpr size_t kBarrierBytes = 2 * kStages * sizeof(uint64_t);
constexpr size_t kSmemBytes =
    1024 + kStages * kSlot + kBarrierBytes + 2 * kRows * sizeof(float);
static_assert(kSmemBytes <= 232448, "the LN -> GEMM tile must fit");
static_assert(kRows * kStagePitch * 4 <= kStages * kSlot, "the staged tile must fit the ring");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float2 unpack2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

__device__ __forceinline__ float sum8(const uint4& raw) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = unpack2(w[j]);
    s += f.x;
    s += f.y;
  }
  return s;
}

__device__ __forceinline__ float sq8(const uint4& raw, float mu, float acc) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = unpack2(w[j]);
    const float a = f.x - mu;
    const float b = f.y - mu;
    acc = fmaf(a, a, acc);
    acc = fmaf(b, b, acc);
  }
  return acc;
}

// v into block `rank` of this cluster at the address of p in its shared
// memory.
__device__ __forceinline__ void store_cluster(float* p, uint32_t rank, float v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v) : "memory");
}

struct Args {
  const bf16* x;      // (n, d)
  const bf16* scale;  // (d,)
  const bf16* shift;  // (d,)
  int n, d;
  float eps;
};

// The statistics of the block's rows m0..: a warp a row, the mean, then the
// mean of squared deviations, each summed lane by lane and across the warp
// in one order.  The blocks of a cluster (column tiles of one row band)
// take equal shares of the rows and store each row's mean and rstd into
// every block's shared memory; rows past n take 0 and 0.  Every thread of
// every block of the cluster calls it.
__device__ __forceinline__ void row_stats(const Args& a, float* mean, float* rstd) {
  constexpr int kBatch = 4;  // rows a warp takes at once
  constexpr int kHeld = 4;   // 16-byte pieces a lane holds of a row: D <= 1024
  constexpr int kSpan = 8 * 32 * kHeld;
  constexpr int kWarps = kThreads / 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * kRows;
  uint32_t rank, ranks;
  asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  asm("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(ranks));
  const int share = kRows / static_cast<int>(ranks);
  const int lo = static_cast<int>(rank) * share;
  for (int r0 = lo + warp * kBatch; r0 < lo + share; r0 += kWarps * kBatch) {
    float mu[kBatch] = {}, rs[kBatch] = {};
    if (m0 + r0 < a.n) {
      uint4 v[kBatch][kHeld];
      auto fetch = [&](int seg) {
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int row = m0 + r0 + b;
#pragma unroll
          for (int i = 0; i < kHeld; ++i) {
            const int c = seg + 8 * lane + 256 * i;
            v[b][i] = row < a.n && c < a.d ? __ldg(reinterpret_cast<const uint4*>(
                                                 a.x + static_cast<size_t>(row) * a.d + c))
                                           : make_uint4(0, 0, 0, 0);
          }
        }
      };
      float sum[kBatch] = {};
      for (int seg = 0; seg < a.d; seg += kSpan) {
        fetch(seg);
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
#pragma unroll
          for (int i = 0; i < kHeld; ++i) sum[b] += sum8(v[b][i]);  // zeros past d add 0
      }
      float sq[kBatch] = {};
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        mu[b] = __fdiv_rn(warp_sum(sum[b]), static_cast<float>(a.d));
      }
      for (int seg = 0; seg < a.d; seg += kSpan) {
        if (a.d > kSpan) fetch(seg);
#pragma unroll
        for (int i = 0; i < kHeld; ++i) {
          if (seg + 8 * lane + 256 * i >= a.d) continue;
#pragma unroll
          for (int b = 0; b < kBatch; ++b) sq[b] = sq8(v[b][i], mu[b], sq[b]);
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const float var = __fdiv_rn(warp_sum(sq[b]), static_cast<float>(a.d));
        rs[b] = __fdiv_rn(1.f, __fsqrt_rn(var + a.eps));
        if (m0 + r0 + b >= a.n) mu[b] = rs[b] = 0.f;
      }
    }
    if (lane < static_cast<int>(ranks)) {  // lane q stores into block q of the cluster
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        store_cluster(&mean[r0 + b], lane, mu[b]);
        store_cluster(&rstd[r0 + b], lane, rs[b]);
      }
    }
  }
  // every block's rows in every block's shared memory before any is read
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The LN scale and shift of piece c (eight columns k..) of slice s, as
// packed bf16 (zeros past d).
__device__ __forceinline__ void coefficients(const Args& a, int s, int c, uint4& g, uint4& b) {
  const int k = kBox * s + 8 * c;
  const bool live = k < a.d;
  g = live ? __ldg(reinterpret_cast<const uint4*>(a.scale + k)) : make_uint4(0, 0, 0, 0);
  b = live ? __ldg(reinterpret_cast<const uint4*>(a.shift + k)) : make_uint4(0, 0, 0, 0);
}

// A consumer warpgroup's 64 x 64 box of raw x at depth 64 s.., in place:
// thread t of the warpgroup takes piece c = t % 8 (eight columns; piece c
// of row r lies at c ^ (r % 8) in the 128-byte swizzle) of rows t / 8 +
// 16 j, with their mean and rstd in mu and rs; pieces past d are zeroed.
// Then the writes are fenced to the async proxy and the warpgroup meets at
// its barrier (ids 2 and 3; 1 is consumer_sync's).
__device__ __forceinline__ void normalise(unsigned char* box, int s, int t, int wg, int d,
                                          const float (&mu)[4], const float (&rs)[4],
                                          const uint4& graw, const uint4& braw) {
  const int c = t & 7;
  const bool live = kBox * s + 8 * c < d;
  uint4 raw[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = (t >> 3) + 16 * j;
    raw[j] = *reinterpret_cast<const uint4*>(box + r * 128 + ((c ^ (r & 7)) << 4));
  }
  const uint32_t gw[4] = {graw.x, graw.y, graw.z, graw.w};
  const uint32_t bw[4] = {braw.x, braw.y, braw.z, braw.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = (t >> 3) + 16 * j;
    uint4 out = make_uint4(0, 0, 0, 0);
    if (live) {
      const uint32_t xw[4] = {raw[j].x, raw[j].y, raw[j].z, raw[j].w};
      uint32_t o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 xv = unpack2(xw[e]);
        const float2 g = unpack2(gw[e]);
        const float2 b = unpack2(bw[e]);
        const float lo = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(xv.x, mu[j]), rs[j]), g.x), b.x);
        const float hi = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(xv.y, mu[j]), rs[j]), g.y), b.y);
        o[e] = pack_bf16(lo, hi);
      }
      out = make_uint4(o[0], o[1], o[2], o[3]);
    }
    *reinterpret_cast<uint4*>(box + r * 128 + ((c ^ (r & 7)) << 4)) = out;
  }
  fence_proxy_async();
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// The outputs of a run of eight columns from their f32 sums: each sum
// rounded to bf16, the bias added, rounded again; one 16-byte store.
struct AddBias {
  const bf16* bias;
  bf16* out;
  int cols;

  __device__ __forceinline__ void operator()(int row, int col, const float (&v)[8]) const {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(bias + col));
    const uint32_t bw[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t packed[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 b = unpack2(bw[j]);
      const float lo = __bfloat162float(__float2bfloat16_rn(v[2 * j])) + b.x;
      const float hi = __bfloat162float(__float2bfloat16_rn(v[2 * j + 1])) + b.y;
      packed[j] = pack_bf16(lo, hi);
    }
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * cols + col) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
};

__global__ void __launch_bounds__(kThreads, 1)
ln_gemm_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
               const Args a, const AddBias fin, float* part) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_1024(smem_raw);  // [slot][A: two boxes | W: three]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kSlot);
  uint64_t* empty = full + kStages;
  float* mean = reinterpret_cast<float*>(empty + kStages);  // (kRows,)
  float* rstd = mean + kRows;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int c0 = blockIdx.x * kCols;
  const int m0 = blockIdx.y * kRows;
  const int nslices = (a.d + kBox - 1) / kBox;
  const int s_begin = static_cast<int>(static_cast<int64_t>(blockIdx.z) * nslices / gridDim.z);
  const int s_end = static_cast<int>(static_cast<int64_t>(blockIdx.z + 1) * nslices / gridDim.z);
  const bool loader = warp == kConsumerWarps && lane == 0;

  // slice s into `slot`: x's rows m0 + 64 h at depth 64 s.., W's depth rows
  // 64 s.. at columns c0 + 64 b..
  auto load = [&](int slot, int s) {
    unsigned char* dst = ring + slot * kSlot;
    mbar_expect_tx(&full[slot], kSlot);
    for (int h = 0; h < 2; ++h) {
      tma_load_2d(dst + h * kBoxBytes, &xmap, &full[slot], kBox * s, m0 + kBox * h);
    }
    for (int b = 0; b < kWBoxes; ++b) {
      tma_load_2d(dst + (2 + b) * kBoxBytes, &wmap, &full[slot], c0 + kBox * b, kBox * s);
    }
  };

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int first = min(kStages, s_end - s_begin);
  if (loader) {
    for (int i = 0; i < first; ++i) load(i, s_begin + i);
  }
  row_stats(a, mean, rstd);
  __syncthreads();

  if (warp >= kConsumerWarps) {
    if (loader) {
      for (int i = first; i < s_end - s_begin; ++i) {
        const int slot = i % kStages;
        mbar_wait(&empty[slot], ((i / kStages) & 1) ^ 1);
        load(slot, s_begin + i);
      }
    }
    return;
  }

  const int wg = consumer_warpgroup();
  const int w = warp & 3;
  const int t = tid & 127;
  float mu[4], rs[4];  // of rows 64 wg + t / 8 + 16 j
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    mu[j] = mean[64 * wg + (t >> 3) + 16 * j];
    rs[j] = rstd[64 * wg + (t >> 3) + 16 * j];
  }
  uint4 graw, braw;
  coefficients(a, s_begin, t & 7, graw, braw);
  float acc[kSums];
#pragma unroll
  for (int x = 0; x < kSums; ++x) acc[x] = 0.f;
  int slot = 0, phase = 0, prev = 0;
  for (int s = s_begin; s < s_end; ++s) {
    mbar_wait(&full[slot], phase);
    unsigned char* base = ring + slot * kSlot;
    normalise(base + wg * kBoxBytes, s, t, wg, a.d, mu, rs, graw, braw);
    if (s + 1 < s_end) coefficients(a, s + 1, t & 7, graw, braw);  // in flight meanwhile
#pragma unroll
    for (int x = 0; x < kSums; ++x) fence_operand(acc[x]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wgmma_m64n192k16_bf16_ss_mn(acc, desc_sw128(base + wg * kBoxBytes + 32 * j),
                                  desc_sw128_mn(base + 2 * kBoxBytes + 2048 * j, kBoxBytes), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // slice s - 1's group has retired: its slot is free
#pragma unroll
    for (int x = 0; x < kSums; ++x) fence_operand(acc[x]);
    release_if(empty, prev, s > s_begin);
    prev = slot;
    if (++slot == kStages) {
      slot = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int x = 0; x < kSums; ++x) fence_operand(acc[x]);

  // acc[4 i + 2 h + e] is row m_row + 8 h, column c0 + 8 i + 2 q + e
  const int m_row = m0 + 64 * wg + 16 * w + (lane >> 2);
  const int q = lane & 3;
  if (gridDim.z > 1) {  // a split: its f32 partial sums into part (splits, n, cols)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m_row + 8 * h;
      if (row >= a.n) continue;
#pragma unroll
      for (int i = 0; i < kSums / 4; ++i) {
        const int col = c0 + 8 * i + 2 * q;  // cols % 8 == 0: col + 1 < cols too
        if (col >= fin.cols) continue;
        *reinterpret_cast<float2*>(part + (static_cast<size_t>(blockIdx.z) * a.n + row) *
                                              fin.cols + col) =
            make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
      }
    }
    return;
  }
  // unsplit: the sums staged in the ring once both warpgroups' products
  // have retired, then finished in runs of eight columns
  consumer_sync(kConsumerWarps * 32);
  float* staged = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < kSums / 4; ++i) {
      *reinterpret_cast<float2*>(staged + (m_row - m0 + 8 * h) * kStagePitch + 8 * i + 2 * q) =
          make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
    }
  consumer_sync(kConsumerWarps * 32);
  for (int item = tid; item < kRows * (kCols / 8); item += kConsumerWarps * 32) {
    const int r = item / (kCols / 8);
    const int cl = 8 * (item % (kCols / 8));
    if (m0 + r >= a.n || c0 + cl >= fin.cols) continue;
    const float4 lo = *reinterpret_cast<const float4*>(staged + r * kStagePitch + cl);
    const float4 hi = *reinterpret_cast<const float4*>(staged + r * kStagePitch + cl + 4);
    const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    fin(m0 + r, c0 + cl, v);
  }
}

}  // namespace

// x (N, D), scale and shift (D,), w (D, O), bias (O,), out (N, O), all
// bf16; part f32 scratch of splits N O values where splits > 1 (else
// unread).  splits cuts the ceil(D / 64) slices of the depth into that
// many splits (ops/ln_gemm.py::ln_splits).
extern "C" int mic_ln_gemm_bf16(void* x, void* scale, void* shift, void* w, void* bias,
                                void* part, void* out, int n, int d, int o, float eps,
                                int splits, void* stream) {
  const int slices = (d + kBox - 1) / kBox;
  if (n < 1 || d < 32 || d % 32 || o < kBox || o % kBox || splits < 1 || splits > slices ||
      splits > 65535 || (n + kRows - 1) / kRows > 65535 || (part == nullptr && splits > 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap xmap, wmap;
  cudaError_t err = gemm_wgmma::box_map(&xmap, x, d, n);
  if (err == cudaSuccess) err = gemm_wgmma::box_map(&wmap, w, o, d);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(ln_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{static_cast<const bf16*>(x), static_cast<const bf16*>(scale),
               static_cast<const bf16*>(shift), n, d, eps};
  const AddBias fin{static_cast<const bf16*>(bias), static_cast<bf16*>(out), o};
  const dim3 grid((o + kCols - 1) / kCols, (n + kRows - 1) / kRows, splits);
  // an unsplit grid's column tiles share their rows' statistics in pairs
  // (clusters of 4 missed a wave at the flagship's 128 blocks); a split
  // grid fills the SMs with blocks whose clusters would not all fit at once
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = splits == 1 && grid.x % 2 == 0 ? 2 : 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = kSmemBytes;
  config.stream = s;
  config.attrs = &attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, ln_gemm_kernel, xmap, wmap, a, fin,
                           static_cast<float*>(part));
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(gemm_wgmma::split_sum(static_cast<const float*>(part), fin, splits, n,
                                                o, s));
}
