// Lazy-beam decode self-attention: one decoder layer at one decode step.
//
// Replaces mic_tpu/ops/lazy_attention.py::fused_lazy_attention_dma (the
// _kernel_dma_bf16 Pallas kernel).  The beam cache is never reordered: row
// b*K + j of the merged (B*K, T, H*Dh) cache holds what running slot j of
// image b wrote, and ancestry[b, k, t] names the row that holds beam k's
// token at position t.  For image b, head h and query beam k this computes
//
//   softmax over {(t, ancestry[b,k,t]) : t < index} + beam k's own step row
//   out[b, k, h] = sum w * V
//
// with scores and softmax in f32, then writes the step K/V into column
// `index` of rows b*K + j IN PLACE (the cache tensors are mutable; the JAX
// kernel needed aliased pass-through buffers and an in-kernel DMA for the
// same effect).  Columns > index are never read and never written, so a
// zero-initialised cache keeps them zero.
//
// Bound: bytes of the live cache prefix.  Each query beam reads exactly one
// row per position (the one its ancestry names), so a block reads at most
// K * index rows of K and of V, 128 bytes each, and nothing past `index`.
// Design: one block per (head, image) and one warp per query beam.  The
// TPU's block-diagonal query matrix, row fold and 8-wide aligned window
// write existed for Mosaic's tiling and have no counterpart here.
//   pass 1: lane t scores position t (a full 128-byte K row, 16-byte loads);
//   pass 2: lane l accumulates output dims 2l, 2l+1 over the live positions
//           (each V row is one coalesced 128-byte warp read).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attend_rows.cuh"

namespace {

constexpr int kHeadDim = 64;
// finfo(float32).min: the mask constant of mic_tpu/nn/attention.py.
constexpr float kMaskValue = -3.4028234663852886e38f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// 1/127 as torch and JAX multiply by it: the double rounded to float
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);

// round(x / scale) half to even, clamped to +-127 (ops/quant.py)
__device__ __forceinline__ signed char quantize(float x, float scale) {
  return static_cast<signed char>(fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -127.f), 127.f));
}

__global__ void lazy_attention_bf16_kernel(
    const __nv_bfloat16* __restrict__ q,       // (B, K, H*Dh), pre-scaled
    __nv_bfloat16* cache_k,                    // (B*K, T, H*Dh)
    __nv_bfloat16* cache_v,                    // (B*K, T, H*Dh)
    const __nv_bfloat16* __restrict__ k_step,  // (B, K, H*Dh)
    const __nv_bfloat16* __restrict__ v_step,  // (B, K, H*Dh)
    const int32_t* __restrict__ ancestry,      // (B, K, T)
    __nv_bfloat16* __restrict__ out,           // (B, K, H*Dh)
    int beams, int t_max, int heads, int index) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int k = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int hd = heads * kHeadDim;

  float* p = smem + k * t_max;  // scores, then unnormalised weights
  int* anc = reinterpret_cast<int*>(smem + beams * t_max) + k * t_max;

  const size_t beam_row = static_cast<size_t>(b) * beams + k;
  const int32_t* anc_g = ancestry + beam_row * t_max;
  for (int t = lane; t < index; t += 32) anc[t] = anc_g[t];

  const size_t head_off = beam_row * hd + static_cast<size_t>(h) * kHeadDim;
  float qr[kHeadDim];
#pragma unroll
  for (int d = 0; d < kHeadDim; d += 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(q + head_off + d);
    const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(pair[i]);
      qr[d + 2 * i] = f.x;
      qr[d + 2 * i + 1] = f.y;
    }
  }

  // pass 1: one lane per live position t < index
  float m = kMaskValue;
  for (int t = lane; t < index; t += 32) {
    const __nv_bfloat16* kr =
        cache_k + ((static_cast<size_t>(b) * beams + anc[t]) * t_max + t) * hd +
        static_cast<size_t>(h) * kHeadDim;
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < kHeadDim; d += 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(kr + d);
      const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(pair[i]);
        acc = fmaf(qr[d + 2 * i], f.x, acc);
        acc = fmaf(qr[d + 2 * i + 1], f.y, acc);
      }
    }
    p[t] = acc;
    m = fmaxf(m, acc);
  }
  // beam k's own step row stands at position `index`
  const float2 q2 = load_pair(q + head_off + 2 * lane);
  const float2 ks2 = load_pair(k_step + head_off + 2 * lane);
  const float s_step = warp_sum(q2.x * ks2.x + q2.y * ks2.y);
  m = fmaxf(warp_max(m), s_step);

  float l = 0.f;
  for (int t = lane; t < index; t += 32) {
    const float e = expf(p[t] - m);
    p[t] = e;
    l += e;
  }
  const float e_step = expf(s_step - m);
  l = warp_sum(l) + e_step;
  __syncwarp();

  // pass 2: lane owns output dims 2*lane and 2*lane + 1
  float ax = 0.f, ay = 0.f;
#pragma unroll 4
  for (int t = 0; t < index; ++t) {
    const float2 v2 = load_pair(
        cache_v + ((static_cast<size_t>(b) * beams + anc[t]) * t_max + t) * hd +
        static_cast<size_t>(h) * kHeadDim + 2 * lane);
    ax = fmaf(p[t], v2.x, ax);
    ay = fmaf(p[t], v2.y, ay);
  }
  const float2 vs2 = load_pair(v_step + head_off + 2 * lane);
  ax = fmaf(e_step, vs2.x, ax);
  ay = fmaf(e_step, vs2.y, ay);
  const float inv = 1.f / l;
  *reinterpret_cast<__nv_bfloat162*>(out + head_off + 2 * lane) =
      __floats2bfloat162_rn(ax * inv, ay * inv);

  // In-place column write of row b*K + k at position `index`.  Every block
  // reads only positions < index, so no block reads what any block writes.
  const size_t col = (beam_row * t_max + index) * hd + static_cast<size_t>(h) * kHeadDim + 2 * lane;
  *reinterpret_cast<__nv_bfloat162*>(cache_k + col) =
      *reinterpret_cast<const __nv_bfloat162*>(k_step + head_off + 2 * lane);
  *reinterpret_cast<__nv_bfloat162*>(cache_v + col) =
      *reinterpret_cast<const __nv_bfloat162*>(v_step + head_off + 2 * lane);
}

// The int8-cache variant: replaces _kernel_dma_q8 of the same file.  The
// cache holds int8 rows, each with one f32 scale over its whole merged
// H*Dh row ((B*K, T) scale planes).  As on the TPU, a cached row's score is
// (q . k8) * ks[row, t]; the step's own K row enters unquantized (scale 1);
// after the f32 softmax each cached weight is multiplied by vs[row, t], and
// every weight is rounded to bf16 before the V product (the TPU kernel's
// w.astype(bf16)).  Each warp also quantizes its beam's step rows as
// ops/quant.py::quantize_rows_dynamic does, bit for bit: one scale over the
// whole merged row (amax over all heads, floor 1e-8, times 1/127), IEEE
// division, round half to even, clamp to +-127.  The block writes its head's
// slice of the int8 rows into column `index` in place; the head-0 block
// writes the scales beside them.
//
// Bound: bytes of the live prefix, half those of the bf16 cache (64 B of K
// and 64 B of V per head row) plus 8 B of scales per position.  Design: the
// bf16 kernel's, with 16-byte loads of 16 int8 values in pass 1 and one
// 2-byte load per lane per row in pass 2.  Quantizing the step rows here
// saves the step some twenty small torch launches per layer; each block
// re-reads its beams' 2 KB step rows for the row amax.
__global__ void lazy_attention_q8_kernel(
    const __nv_bfloat16* __restrict__ q,       // (B, K, H*Dh), pre-scaled
    int8_t* cache_k,                           // (B*K, T, H*Dh)
    float* k_scale,                            // (B*K, T)
    int8_t* cache_v,                           // (B*K, T, H*Dh)
    float* v_scale,                            // (B*K, T)
    const __nv_bfloat16* __restrict__ k_step,  // (B, K, H*Dh)
    const __nv_bfloat16* __restrict__ v_step,  // (B, K, H*Dh)
    const int32_t* __restrict__ ancestry,      // (B, K, T)
    __nv_bfloat16* __restrict__ out,           // (B, K, H*Dh)
    int beams, int t_max, int heads, int index) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int k = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int hd = heads * kHeadDim;

  float* p = smem + k * t_max;  // scores, then bf16-rounded weights
  int* anc = reinterpret_cast<int*>(smem + beams * t_max) + k * t_max;

  const size_t beam_row = static_cast<size_t>(b) * beams + k;
  const int32_t* anc_g = ancestry + beam_row * t_max;
  for (int t = lane; t < index; t += 32) anc[t] = anc_g[t];

  const size_t head_off = beam_row * hd + static_cast<size_t>(h) * kHeadDim;
  float qr[kHeadDim];
#pragma unroll
  for (int d = 0; d < kHeadDim; d += 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(q + head_off + d);
    const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(pair[i]);
      qr[d + 2 * i] = f.x;
      qr[d + 2 * i + 1] = f.y;
    }
  }

  // pass 1: one lane per live position t < index
  float m = kMaskValue;
  for (int t = lane; t < index; t += 32) {
    const size_t src = (static_cast<size_t>(b) * beams + anc[t]) * t_max + t;
    const int8_t* kr = cache_k + src * hd + static_cast<size_t>(h) * kHeadDim;
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < kHeadDim; d += 16) {
      const uint4 raw = *reinterpret_cast<const uint4*>(kr + d);
      const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int i = 0; i < 16; ++i) acc = fmaf(qr[d + i], static_cast<float>(v[i]), acc);
    }
    acc = __fmul_rn(acc, k_scale[src]);
    p[t] = acc;
    m = fmaxf(m, acc);
  }
  // beam k's own step row, unquantized
  const float2 q2 = load_pair(q + head_off + 2 * lane);
  const float2 ks2 = load_pair(k_step + head_off + 2 * lane);
  const float s_step = warp_sum(q2.x * ks2.x + q2.y * ks2.y);
  m = fmaxf(warp_max(m), s_step);

  float l = 0.f;
  for (int t = lane; t < index; t += 32) {
    const float e = expf(p[t] - m);
    p[t] = e;
    l += e;
  }
  const float e_step = expf(s_step - m);
  l = warp_sum(l) + e_step;
  // weights: softmax, times the V row scale, rounded to bf16
  for (int t = lane; t < index; t += 32) {
    const size_t src = (static_cast<size_t>(b) * beams + anc[t]) * t_max + t;
    p[t] = __bfloat162float(__float2bfloat16_rn(__fmul_rn(__fdiv_rn(p[t], l), v_scale[src])));
  }
  const float w_step = __bfloat162float(__float2bfloat16_rn(__fdiv_rn(e_step, l)));
  __syncwarp();

  // pass 2: lane owns output dims 2*lane and 2*lane + 1
  float ax = 0.f, ay = 0.f;
#pragma unroll 4
  for (int t = 0; t < index; ++t) {
    const char2 v2 = *reinterpret_cast<const char2*>(
        cache_v + ((static_cast<size_t>(b) * beams + anc[t]) * t_max + t) * hd +
        static_cast<size_t>(h) * kHeadDim + 2 * lane);
    ax = fmaf(p[t], static_cast<float>(v2.x), ax);
    ay = fmaf(p[t], static_cast<float>(v2.y), ay);
  }
  const float2 vs2 = load_pair(v_step + head_off + 2 * lane);
  ax = fmaf(w_step, vs2.x, ax);
  ay = fmaf(w_step, vs2.y, ay);
  *reinterpret_cast<__nv_bfloat162*>(out + head_off + 2 * lane) = __floats2bfloat162_rn(ax, ay);

  // The step rows' scales: the amax over the whole merged rows
  float kmax = 0.f, vmax = 0.f;
  for (int i = 8 * lane; i < hd; i += 8 * 32) {
    const uint4 kraw = *reinterpret_cast<const uint4*>(k_step + beam_row * hd + i);
    const uint4 vraw = *reinterpret_cast<const uint4*>(v_step + beam_row * hd + i);
    const __nv_bfloat162* kp = reinterpret_cast<const __nv_bfloat162*>(&kraw);
    const __nv_bfloat162* vp = reinterpret_cast<const __nv_bfloat162*>(&vraw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 kf = __bfloat1622float2(kp[j]);
      const float2 vf = __bfloat1622float2(vp[j]);
      kmax = fmaxf(kmax, fmaxf(fabsf(kf.x), fabsf(kf.y)));
      vmax = fmaxf(vmax, fmaxf(fabsf(vf.x), fabsf(vf.y)));
    }
  }
  const float ksc = __fmul_rn(fmaxf(warp_max(kmax), 1e-8f), kInv127);
  const float vsc = __fmul_rn(fmaxf(warp_max(vmax), 1e-8f), kInv127);

  // In-place write of this head's slice of the quantized step rows, and of
  // their scales, at `index`.  Every block reads only positions < index.
  const size_t col = beam_row * t_max + index;
  const size_t off = col * hd + static_cast<size_t>(h) * kHeadDim + 2 * lane;
  *reinterpret_cast<char2*>(cache_k + off) = make_char2(quantize(ks2.x, ksc), quantize(ks2.y, ksc));
  *reinterpret_cast<char2*>(cache_v + off) = make_char2(quantize(vs2.x, vsc), quantize(vs2.y, vsc));
  if (h == 0 && lane == 0) {
    k_scale[col] = ksc;
    v_scale[col] = vsc;
  }
}

}  // namespace

extern "C" int mic_lazy_attention_bf16(void* q, void* cache_k, void* cache_v, void* k_step,
                                       void* v_step, void* ancestry, void* out, int batch,
                                       int beams, int t_max, int heads, int head_dim, int index,
                                       void* stream) {
  if (head_dim != kHeadDim || beams < 1 || beams > 32 || index < 0 || index >= t_max) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(heads, batch);
  const dim3 block(32 * beams);
  const size_t smem = 2 * static_cast<size_t>(beams) * t_max * sizeof(float);
  lazy_attention_bf16_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(cache_k),
      static_cast<__nv_bfloat16*>(cache_v), static_cast<const __nv_bfloat16*>(k_step),
      static_cast<const __nv_bfloat16*>(v_step), static_cast<const int32_t*>(ancestry),
      static_cast<__nv_bfloat16*>(out), beams, t_max, heads, index);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mic_lazy_attention_q8(void* q, void* cache_k, void* k_scale, void* cache_v,
                                     void* v_scale, void* k_step, void* v_step, void* ancestry,
                                     void* out, int batch, int beams, int t_max, int heads,
                                     int head_dim, int index, void* stream) {
  if (head_dim != kHeadDim || beams < 1 || beams > 32 || index < 0 || index >= t_max) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(heads, batch);
  const dim3 block(32 * beams);
  const size_t smem = 2 * static_cast<size_t>(beams) * t_max * sizeof(float);
  lazy_attention_q8_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<int8_t*>(cache_k),
      static_cast<float*>(k_scale), static_cast<int8_t*>(cache_v), static_cast<float*>(v_scale),
      static_cast<const __nv_bfloat16*>(k_step), static_cast<const __nv_bfloat16*>(v_step),
      static_cast<const int32_t*>(ancestry), static_cast<__nv_bfloat16*>(out), beams, t_max,
      heads, index);
  return static_cast<int>(cudaGetLastError());
}

// The blocked kernel of mode "1": replaces
// mic_tpu/ops/lazy_attention.py::fused_lazy_attention (_kernel_bf16 and
// _kernel_q8).  It reads the PRE-update cache and never writes it: the
// caller stores the step column after it.  Liveness comes from the per-step
// (B, J*T, K) int8 ancestry mask shared by every layer (strict t < index),
// and each beam's own step row is scored unquantized (scale 1).  The int8
// variant reads per-(row, position, head) f32 scales, (B*K, T, H).  The
// kernel walks positions < `positions` only: the wrapper passes the write
// index, past which the strict mask admits nothing.  Math and design:
// attend_rows.cuh.
extern "C" int mic_lazy_attention_blocked_bf16(void* q, void* cache_k, void* cache_v, void* k_step,
                                               void* v_step, void* amask, void* out, int batch,
                                               int beams, int t_max, int positions, int heads,
                                               int head_dim, void* stream) {
  attend::Args a{static_cast<const __nv_bfloat16*>(q), cache_k, cache_v, nullptr, nullptr,
                 static_cast<const __nv_bfloat16*>(k_step),
                 static_cast<const __nv_bfloat16*>(v_step), static_cast<const int8_t*>(amask),
                 static_cast<__nv_bfloat16*>(out), beams, beams, t_max, positions, heads};
  return attend::launch<__nv_bfloat16, true, true>(a, batch, head_dim,
                                                   static_cast<cudaStream_t>(stream));
}

extern "C" int mic_lazy_attention_blocked_q8(void* q, void* cache_k, void* k_scale, void* cache_v,
                                             void* v_scale, void* k_step, void* v_step,
                                             void* amask, void* out, int batch, int beams,
                                             int t_max, int positions, int heads, int head_dim,
                                             void* stream) {
  attend::Args a{static_cast<const __nv_bfloat16*>(q), cache_k, cache_v,
                 static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                 static_cast<const __nv_bfloat16*>(k_step),
                 static_cast<const __nv_bfloat16*>(v_step), static_cast<const int8_t*>(amask),
                 static_cast<__nv_bfloat16*>(out), beams, beams, t_max, positions, heads};
  return attend::launch<int8_t, true, true>(a, batch, head_dim,
                                            static_cast<cudaStream_t>(stream));
}
