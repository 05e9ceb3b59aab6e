// The float32 flash-CE backward contractions: rows 9's backward and 10 for
// a float32 model.
//
// Replace, where h is float32, mic_tpu/ops/flash_ce.py::flash_ce_backward_save
// (_ce_gw_save_kernel, _ce_gh_save_kernel) and ::flash_ce_backward
// (_ce_gw_kernel, _ce_gh_kernel).  Each pair contracts dl, formed in f32 in
// mic_tpu's order of rounding (and cast to h.dtype, a no-op at float32):
//
//   grad-W: demb (V, D) = dl^T @ h  and  dbias (V,) = the column sums of dl
//   grad-h: dh (N, D)   = dl @ W
//
// with dl = (exp(s - lse) - target) * rowscale, target = low + (conf - low)
// * onehot(label).  The save route forms dl from the forward's saved bf16
// logits of the main span (mic_tpu saves them as bf16 at float32 too); its
// ragged f32 tail stays two plain products outside, as mic_tpu computes it
// outside Pallas.  The split route forms dl from logits it recomputes:
// csrc/flash_ce_f32.cu's dl walk (the 3xTF32 wgmma tile that streams D
// through a TMA ring) writes a vocab chunk of dl (N x a few thousand
// columns, never the N x V) that these kernels then read twice, so the
// logits are recomputed once a chunk where mic_tpu's two kernels recompute
// them each.  (The bf16 split kernel keeps 64 own rows resident over D;
// hi + lo of 64 f32 rows at D = 1024 are 512 KB, which no block holds.)
//
// Bound: operations.  At the flagship step (N = 4096, D = 1024, V = 250054)
// each contraction is 2 N D V = 2.1 TFLOP, 12.7 ms at the 165 TFLOP/s of
// float32-accurate tensor-core products (three TF32 products at 495): the
// save route's pair 25.4 ms, the split route's pair with its recompute
// 38.1 ms.
// Design: row 15 f32's tile (csrc/tf32x3_mma.cuh): a 128 x 96 output tile a
// block of eight warps, 3xTF32 mma.sync.m16n8k8 over 16-deep slices
// double-buffered in shared memory, each slice summed into the running
// sums by FADDs.  mma.sync's fragments come from shared memory in any
// layout, so B, the table's rows (grad-h) or the hidden rows (grad-W), is
// read as stored, and A is dl, formed on its way to shared memory:
//   grad-h: A (N rows, the span's columns as depth) from a hidden row's
//     eight consecutive logits a thread, K-major like row 15's x;
//   grad-W: A (the span's columns as rows, N as depth) from eight
//     consecutive columns of one hidden row a thread, stored M-major
//     (pitch 136: the fragment reads 8 t + g cover the banks); the block's
//     first column tile also sums dl's columns for dbias, in a fixed order.
// grad-h's depth (the span) is cut into splits where its output tiles leave
// SMs idle (small N), their partials summed in split order by a second
// kernel, which also adds to dh (the split route's chunks after the first).
// Rows past N, columns past the span and depth past its end read as zeros
// and are never written.  No atomics: reruns are bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3_mma.cuh"

namespace {
namespace ce_contract_f32 {

using namespace tf32x3_mma;

constexpr int kWPitch = kRows + 8;          // grad-W: f32 of a staged A depth row (M-major)
constexpr int kABuf = kRows * kAPitch;      // f32 of an A buffer, either layout
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kDepth * kWPitch <= kABuf, "grad-W's A fits grad-h's buffer");
static_assert(kDepth * kRows <= 2 * kABuf, "dbias's column sums fit the A buffers");

struct Args {
  const void* src;          // saved bf16 logits (N, ld) or f32 dl (N, ld)
  const float* b;           // B rows, (depth, d): the table's (grad-h), the hidden's (grad-W)
  const float* lse;         // saved: (N,)
  const float* rowscale;    // saved: (N,)
  const int32_t* labels;    // saved: (N,)
  float* out;               // grad-h: dh (N, d); grad-W: demb (vext, d)
  float* part;              // grad-h: (splits, N, d) where split
  float* dbias;             // grad-W: (vext,), or null
  float low, conf_low;
  int n, d, vext, ld;       // vext: the span's columns
  int accumulate;           // grad-h: add to out
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Eight consecutive values of row `row` from column `col` (a multiple of 8,
// below the span's end) of the source: dl formed from the saved bf16
// logits with the row's terms (-lse log2 e, rowscale, label), as the dl
// walk forms it, or the dl chunk as stored; columns past the span 0.
template <bool kSaved>
__device__ __forceinline__ void load_run(const Args& a, int row, int col, float nl, float rs,
                                         int y, float (&v)[8]) {
  const size_t at = static_cast<size_t>(row) * a.ld + col;
  if constexpr (kSaved) {
    const uint4 raw = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(a.src) +
                                                      at);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    const float label_target = a.low + a.conf_low;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t bits = j & 1 ? w[j >> 1] & 0xFFFF0000u : w[j >> 1] << 16;
      const float p = ex2(fmaf(__uint_as_float(bits), kLog2e, nl));
      v[j] = col + j < a.vext ? (p - (col + j == y ? label_target : a.low)) * rs : 0.f;
    }
  } else {
    const float* src = static_cast<const float*>(a.src) + at;
    const float4 lo = *reinterpret_cast<const float4*>(src);
    const float4 hi = *reinterpret_cast<const float4*>(src + 4);
    const float raw[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = col + j < a.vext ? raw[j] : 0.f;
  }
}

template <bool kSaved, bool kGradW>
__global__ void __launch_bounds__(kThreads, 1) contract_kernel(const Args a) {
  __shared__ __align__(16) float as[2][kABuf];
  __shared__ __align__(16) float bs[2][kDepth][kBPitch];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.y * kRows;
  const int c0 = blockIdx.x * kCols;
  const int depth = kGradW ? a.n : a.vext;
  int s0, s1;
  split_range((depth + kDepth - 1) / kDepth, s0, s1);

  // A loads.  grad-h: hidden row m0 + tid / 2, columns 8 (tid % 2).. of a
  // slice; grad-W: hidden row tid / 16 of a slice, span columns m0 + 8 (tid
  // % 16)..
  const int ar = kGradW ? tid >> 4 : tid >> 1;
  const int ac = kGradW ? 8 * (tid & 15) : 8 * (tid & 1);
  float nl = 0.f, rs = 0.f;
  int y = -1;
  auto terms = [&](int row) {
    if constexpr (kSaved) {
      nl = -a.lse[row] * kLog2e;
      rs = a.rowscale[row];
      y = a.labels[row];
    }
  };
  if (!kGradW && m0 + ar < a.n) terms(m0 + ar);
  float colsum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // grad-W's dbias

  Acc acc;
  zero(acc);
  walk<float[8]>(
      acc, a.b, depth, c0, a.d, bs, s0, s1,
      [&](int s, float (&av)[8]) {
        const int k = s * kDepth;
        if constexpr (kGradW) {
          const int row = k + ar;
          const bool live = row < a.n && m0 + ac < a.vext;
          if (live) {
            terms(row);
            load_run<kSaved>(a, row, m0 + ac, nl, rs, y, av);
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j) av[j] = 0.f;
          }
        } else {
          const bool live = m0 + ar < a.n && k + ac < a.vext;
          if (live) {
            load_run<kSaved>(a, m0 + ar, k + ac, nl, rs, y, av);
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j) av[j] = 0.f;
          }
        }
      },
      [&](int buf, const float (&av)[8]) {
        float* dst = kGradW ? &as[buf][ar * kWPitch + ac] : &as[buf][ar * kAPitch + ac];
        *reinterpret_cast<float4*>(dst) = make_float4(av[0], av[1], av[2], av[3]);
        *reinterpret_cast<float4*>(dst + 4) = make_float4(av[4], av[5], av[6], av[7]);
        if constexpr (kGradW) {
#pragma unroll
          for (int j = 0; j < 8; ++j) colsum[j] += av[j];
        }
      },
      // A (row m, depth k) of the staged slice
      [&](int buf, int m, int k) {
        return kGradW ? as[buf][k * kWPitch + m] : as[buf][m * kAPitch + k];
      });

  const int m_end = kGradW ? a.vext : a.n;
  const bool split_z = gridDim.z > 1;
  for_each_pair(acc, m0, c0, m_end, a.d, warp & 1, warp >> 1, lane,
                [&](int row, int col, float2 v) {
    const size_t at = static_cast<size_t>(row) * a.d + col;
    if (split_z) {
      *reinterpret_cast<float2*>(a.part + static_cast<size_t>(blockIdx.z) * a.n * a.d + at) = v;
    } else {
      float2* o = reinterpret_cast<float2*>(a.out + at);
      if (!kGradW && a.accumulate) {
        const float2 was = *o;
        v.x = was.x + v.x;
        v.y = was.y + v.y;
      }
      *o = v;
    }
  });

  if constexpr (kGradW) {
    // dbias of the block's span columns: each thread's sums over its depth
    // rows, then the 16 rows' sums of each column in row order (the A
    // buffers are free: the last slice's products are done)
    if (blockIdx.x != 0 || a.dbias == nullptr) return;
    float* sums = &as[0][0];  // [16][kRows]
#pragma unroll
    for (int j = 0; j < 8; ++j) sums[ar * kRows + ac + j] = colsum[j];
    __syncthreads();
    if (tid < kRows && m0 + tid < a.vext) {
      float total = 0.f;
      for (int r = 0; r < 16; ++r) total += sums[r * kRows + tid];
      a.dbias[m0 + tid] = total;
    }
  }
}

// The grad-h split sum's epilogue: dh = the partials' sum, or dh += it
// (the split route's chunks after the first).
struct Accumulate {
  float* out;
  int accumulate;
  __device__ __forceinline__ void operator()(size_t run, float4 v) const {
    if (accumulate) {
      const float4 was = reinterpret_cast<const float4*>(out)[run];
      v.x = was.x + v.x;
      v.y = was.y + v.y;
      v.z = was.z + v.z;
      v.w = was.w + v.w;
    }
    reinterpret_cast<float4*>(out)[run] = v;
  }
};

template <bool kSaved, bool kGradW>
cudaError_t contract(const Args& a, int splits, cudaStream_t s) {
  const int m = kGradW ? a.vext : a.n;
  const dim3 grid((a.d + kCols - 1) / kCols, (m + kRows - 1) / kRows, splits);
  contract_kernel<kSaved, kGradW><<<grid, kThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (kGradW || err != cudaSuccess || splits == 1) return err;
  return split_sum(a.part, splits, static_cast<size_t>(a.n) * a.d,
                   Accumulate{a.out, a.accumulate}, s);
}

}  // namespace ce_contract_f32
}  // namespace

// One float32 backward contraction over a span of vext vocab columns.
// src: the saved bf16 logits (saved = 1; lse, rowscale and labels (N,)
// give dl) or a float32 dl chunk (saved = 0), (N, ld) with ld >= vext a
// multiple of 8.  grad_w = 1: demb (vext, D) into out from b = the hidden
// rows (N, D), and dbias (vext,) where not null; grad_w = 0: dh (N, D) into
// out (added to it where accumulate) from b = the table's rows of the span
// (vext, D), its depth cut into `splits` through part (splits, N, D) f32
// scratch where splits > 1.  Every pointer 16-byte aligned, D a multiple
// of 4; low and conf - low the smoothed target's.
extern "C" int mic_flash_ce_contract_f32(void* src, int saved, int ld, void* b, void* lse,
                                         void* rowscale, void* labels, void* out, void* part,
                                         void* dbias, float low, float conf_low, int n, int d,
                                         int vext, int grad_w, int accumulate, int splits,
                                         void* stream) {
  using namespace ce_contract_f32;
  const int depth = grad_w ? n : vext;
  if (n < 1 || d < 4 || d % 4 || vext < 1 || ld < vext || ld % 8 || splits < 1 ||
      splits > (depth + kDepth - 1) / kDepth || splits > 65535 || (grad_w && splits != 1) ||
      (splits > 1 && part == nullptr) || (n + kRows - 1) / kRows > 65535 ||
      (vext + kRows - 1) / kRows > 65535 || (saved && (!lse || !rowscale || !labels))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  a.src = src;
  a.b = static_cast<const float*>(b);
  a.lse = static_cast<const float*>(lse);
  a.rowscale = static_cast<const float*>(rowscale);
  a.labels = static_cast<const int32_t*>(labels);
  a.out = static_cast<float*>(out);
  a.part = static_cast<float*>(part);
  a.dbias = static_cast<float*>(dbias);
  a.low = low;
  a.conf_low = conf_low;
  a.n = n;
  a.d = d;
  a.vext = vext;
  a.ld = ld;
  a.accumulate = accumulate;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (saved) {
    err = grad_w ? contract<true, true>(a, 1, s) : contract<true, false>(a, splits, s);
  } else {
    err = grad_w ? contract<false, true>(a, 1, s) : contract<false, false>(a, splits, s);
  }
  return static_cast<int>(err);
}
