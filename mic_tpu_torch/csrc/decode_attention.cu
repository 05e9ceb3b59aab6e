// Decode-step self-attention on the physical cache, with the in-place write.
//
// Replaces mic_tpu/ops/decode_attention.py::decode_attention (its _kernel
// Pallas kernel, MIC_TPU_EXPERIMENTAL=fused_decode).  The cache is the
// stacked (L, N, T, H, Dh) self K/V of nn/cache.py::DecoderCache.  For one
// layer `layer` at write position `index` this
//
//   1. writes the step's K/V row into cache[layer, n, index] (bit copies);
//   2. scores positions 0..index: s = q . k in f32 (q pre-scaled);
//   3. softmax over them in f32, out = sum w * v in f32, cast to q's type,
//
// the math of the TPU function's exact off-TPU branch.  Positions > index
// are never read and never written.
//
// Bound: bytes.  The work is the live prefix of one layer, read once:
// 2 * N * (index + 1) * H * Dh elements (67.1 MB in bf16 at N = 256, T = 64,
// H * Dh = 1024, index 63: 0.020 ms at 3.35 TB/s), against about 4 flops a
// cached element.  The TPU kernel's aliased buffers, chunked DMA ring and
// 128-lane head-sum matmul existed for Mosaic's tiling and VMEM; here the
// cache is a mutable tensor, so the column is a plain store.  Design: one
// warp per (row n, head h), kWarps heads to a block.  Lane l holds dims 2l
// and 2l+1 of q, of the step K/V and of the f32 accumulator, so each cached
// K or V row of a head is one coalesced 128-byte (bf16) warp load.  The warp
// walks the positions four at a time (four loads in flight, four
// shuffle-reduced dot products), keeping an online (max, sum) and rescaling
// the accumulator; the step's own K/V stay in registers for position index.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;  // two dims a lane
constexpr int kWarps = 4;     // heads a block
constexpr int kUnroll = 4;    // positions a warp has in flight

template <typename T>
struct Pair;

template <>
struct Pair<__nv_bfloat16> {
  using Raw = __nv_bfloat162;
  static __device__ __forceinline__ float2 to_float(Raw r) { return __bfloat1622float2(r); }
  static __device__ __forceinline__ Raw from_float(float2 f) { return __floats2bfloat162_rn(f.x, f.y); }
};

template <>
struct Pair<float> {
  using Raw = float2;
  static __device__ __forceinline__ float2 to_float(Raw r) { return r; }
  static __device__ __forceinline__ Raw from_float(float2 f) { return f; }
};

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const T* __restrict__ q,       // (N, H, Dh), pre-scaled
                        const T* __restrict__ k_step,  // (N, H, Dh)
                        const T* __restrict__ v_step,  // (N, H, Dh)
                        T* cache_k,                    // (L, N, T, H, Dh)
                        T* cache_v,                    // (L, N, T, H, Dh)
                        T* __restrict__ out,           // (N, H, Dh)
                        int rows, int t_max, int heads, int layer, int index) {
  using P = Pair<T>;
  using Raw = typename P::Raw;
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.y * kWarps + (threadIdx.x >> 5);
  const int n = blockIdx.x;
  if (h >= heads) return;
  const size_t hd = static_cast<size_t>(heads) * kHeadDim;
  const size_t own = n * hd + h * kHeadDim + 2 * lane;
  // element offset of position t of this (layer, row, head, lane)
  const size_t base = (static_cast<size_t>(layer) * rows + n) * t_max * hd + h * kHeadDim + 2 * lane;

  const float2 qf = P::to_float(*reinterpret_cast<const Raw*>(q + own));
  const Raw k_raw = *reinterpret_cast<const Raw*>(k_step + own);
  const Raw v_raw = *reinterpret_cast<const Raw*>(v_step + own);
  *reinterpret_cast<Raw*>(cache_k + base + index * hd) = k_raw;
  *reinterpret_cast<Raw*>(cache_v + base + index * hd) = v_raw;
  const float2 k_own = P::to_float(k_raw);
  const float2 v_own = P::to_float(v_raw);

  float m = -INFINITY, l = 0.f, acc0 = 0.f, acc1 = 0.f;
  for (int t0 = 0; t0 <= index; t0 += kUnroll) {
    float s[kUnroll];
    float2 vv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      float2 kk = make_float2(0.f, 0.f);
      vv[u] = make_float2(0.f, 0.f);
      if (t < index) {
        kk = P::to_float(*reinterpret_cast<const Raw*>(cache_k + base + t * hd));
        vv[u] = P::to_float(*reinterpret_cast<const Raw*>(cache_v + base + t * hd));
      } else if (t == index) {
        kk = k_own;
        vv[u] = v_own;
      }
      s[u] = qf.x * kk.x + qf.y * kk.y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u <= index) {
        const float mn = fmaxf(m, s[u]);
        const float scale = expf(m - mn);  // 0 on the first position
        const float p = expf(s[u] - mn);
        l = l * scale + p;
        acc0 = acc0 * scale + p * vv[u].x;
        acc1 = acc1 * scale + p * vv[u].y;
        m = mn;
      }
    }
  }
  *reinterpret_cast<Raw*>(out + own) = P::from_float(make_float2(acc0 / l, acc1 / l));
}

template <typename T>
int launch(void* q, void* k_step, void* v_step, void* cache_k, void* cache_v, void* out,
           int layers, int rows, int t_max, int heads, int head_dim, int layer, int index,
           void* stream) {
  if (head_dim != kHeadDim || layers < 1 || rows < 1 || heads < 1 || layer < 0 ||
      layer >= layers || index < 0 || index >= t_max) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(rows, (heads + kWarps - 1) / kWarps);
  decode_attention_kernel<T><<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_step), static_cast<const T*>(v_step),
      static_cast<T*>(cache_k), static_cast<T*>(cache_v), static_cast<T*>(out), rows, t_max,
      heads, layer, index);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mic_decode_attention_bf16(void* q, void* k_step, void* v_step, void* cache_k,
                                         void* cache_v, void* out, int layers, int rows,
                                         int t_max, int heads, int head_dim, int layer,
                                         int index, void* stream) {
  return launch<__nv_bfloat16>(q, k_step, v_step, cache_k, cache_v, out, layers, rows, t_max,
                               heads, head_dim, layer, index, stream);
}

extern "C" int mic_decode_attention_f32(void* q, void* k_step, void* v_step, void* cache_k,
                                        void* cache_v, void* out, int layers, int rows,
                                        int t_max, int heads, int head_dim, int layer, int index,
                                        void* stream) {
  return launch<float>(q, k_step, v_step, cache_k, cache_v, out, layers, rows, t_max, heads,
                       head_dim, layer, index, stream);
}
