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
