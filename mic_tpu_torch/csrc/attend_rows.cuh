// The cross-attention's row walk (cross_attention.cu): the counterpart of
// mic_tpu/ops/lazy_attention.py::_attend_tiles as the cross-attention TPU
// kernels call it, with every row live and no step rows.
//
// For image b, head h and query beam k, over the rows of one image's
// (sources, t_max, H*Dh) cache (rows (j, t) with t < positions):
//
//   s[k, (j,t)] = (q[b,k,h] . K[j,t,h]) * k_scale[j,t,h]     (f32; scale 1 in bf16)
//   w = softmax(s) in f32, times v_scale[j,t,h] (int8), rounded to bf16
//   out[b,k,h] = bf16( sum w * V )                             (f32 sums)
//
// which is _attend_tiles' arithmetic: f32 scores, scales on the scores and
// the weights, weights rounded to bf16 before the V product, one bf16
// rounding of the output.  The TPU kernel's block-diagonal query matrix and
// row fold existed for the MXU and have no counterpart here.  (The blocked
// lazy self-attention, with its mask and step rows, has its own split walk
// in lazy_attention.cu.)
//
// Bound: bytes of the cache rows read.  Design: one block of four warps per
// (head, image).  Pass 1 gives each thread whole rows (a 128-byte bf16 or
// 64-byte int8 head row, read once and scored against every beam).  Then
// warp k runs beam k's softmax over the scores in shared memory and walks
// the rows for the V product, one coalesced head row a step, lane l owning
// dims 2l, 2l+1.  Nothing is written but the output; nothing is atomic.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {
namespace attend {

constexpr int kHeadDim = 64;
constexpr int kMaxBeams = 8;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// finfo(float32).min: the mask constant of mic_tpu/ops/lazy_attention.py.
constexpr float kMaskValue = -3.4028234663852886e38f;
constexpr size_t kMaxSmem = 227 * 1024;

struct Args {
  const __nv_bfloat16* q;  // (B, K, H*Dh), pre-scaled by Dh**-0.5
  const void* cache_k;     // (B*sources, t_max, H*Dh) bf16 or int8
  const void* cache_v;
  const float* k_scale;    // (B*sources, t_max, H) f32, int8 caches only
  const float* v_scale;
  __nv_bfloat16* out;      // (B, K, H*Dh)
  int beams, sources, t_max, positions, heads;
};

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

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// eight consecutive values of a head row as floats
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(pair[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float* f) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = static_cast<float>(v[i]);
}

// dims 2*lane, 2*lane + 1 of a head row
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load_pair(const int8_t* p) {
  const char2 v = *reinterpret_cast<const char2*>(p);
  return make_float2(static_cast<float>(v.x), static_cast<float>(v.y));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) attend_rows_kernel(const Args a) {
  constexpr bool kQ8 = std::is_same<T, int8_t>::value;
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int beams = a.beams;
  const int hd = a.heads * kHeadDim;
  const int rows = a.sources * a.positions;
  const T* cache_k = static_cast<const T*>(a.cache_k);
  const T* cache_v = static_cast<const T*>(a.cache_v);

  float* qf = smem;                       // (K, Dh)
  float* p = smem + beams * kHeadDim;     // (K, rows): scores, then weights
  for (int i = tid; i < beams * kHeadDim; i += kThreads) {
    const int k = i / kHeadDim;
    qf[i] = __bfloat162float(
        a.q[(static_cast<size_t>(b) * beams + k) * hd + h * kHeadDim + i % kHeadDim]);
  }
  __syncthreads();

  // pass 1: a thread per row, scored against every beam
  for (int r = tid; r < rows; r += kThreads) {
    const int j = r / a.positions;
    const int t = r - j * a.positions;
    const size_t g = (static_cast<size_t>(b) * a.sources + j) * a.t_max + t;
    float acc[kMaxBeams];
#pragma unroll
    for (int k = 0; k < kMaxBeams; ++k) acc[k] = 0.f;
    const T* row = cache_k + g * hd + h * kHeadDim;
#pragma unroll
    for (int d = 0; d < kHeadDim; d += 8) {
      float f[8];
      load8(row + d, f);
#pragma unroll
      for (int k = 0; k < kMaxBeams; ++k) {
        if (k < beams) {
          const float* qk = qf + k * kHeadDim + d;
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[k] = fmaf(qk[i], f[i], acc[k]);
        }
      }
    }
    if (kQ8) {
      const float sc = a.k_scale[g * a.heads + h];
#pragma unroll
      for (int k = 0; k < kMaxBeams; ++k) acc[k] = __fmul_rn(acc[k], sc);
    }
#pragma unroll
    for (int k = 0; k < kMaxBeams; ++k) {
      if (k < beams) p[k * rows + r] = acc[k];
    }
  }
  __syncthreads();

  // softmax and the V product: warp w takes beams w, w + 4, ...
  for (int k = warp; k < beams; k += kWarps) {
    float* pk = p + k * rows;
    const size_t qrow = (static_cast<size_t>(b) * beams + k) * hd + h * kHeadDim + 2 * lane;
    float m = kMaskValue;
    for (int r = lane; r < rows; r += 32) m = fmaxf(m, pk[r]);
    m = warp_max(m);
    float l = 0.f;
    for (int r = lane; r < rows; r += 32) {
      const float e = expf(pk[r] - m);
      pk[r] = e;
      l += e;
    }
    l = warp_sum(l);
    for (int r = lane; r < rows; r += 32) {
      float w = __fdiv_rn(pk[r], l);
      if (kQ8 && w != 0.f) {
        const int j = r / a.positions;
        const size_t g = (static_cast<size_t>(b) * a.sources + j) * a.t_max + (r - j * a.positions);
        w = __fmul_rn(w, a.v_scale[g * a.heads + h]);
      }
      pk[r] = bf16_round(w);
    }
    __syncwarp();

    float ax = 0.f, ay = 0.f;
    int r = 0;
    for (int j = 0; j < a.sources; ++j) {
      const T* src = cache_v + (static_cast<size_t>(b) * a.sources + j) * a.t_max * hd +
                     h * kHeadDim + 2 * lane;
      for (int t = 0; t < a.positions; ++t, ++r) {
        const float w = pk[r];  // the same for every lane: a uniform branch
        if (w != 0.f) {
          const float2 v = load_pair(src + static_cast<size_t>(t) * hd);
          ax = fmaf(w, v.x, ax);
          ay = fmaf(w, v.y, ay);
        }
      }
    }
    *reinterpret_cast<__nv_bfloat162*>(a.out + qrow) = __floats2bfloat162_rn(ax, ay);
  }
}

// Launch on `stream` for `batch` images; returns a cudaError_t.
template <typename T>
int launch(const Args& a, int batch, int head_dim, cudaStream_t stream) {
  if (head_dim != kHeadDim || a.beams < 1 || a.beams > kMaxBeams || a.sources < 1 ||
      a.positions < 0 || a.positions > a.t_max || a.heads < 1 || batch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      (static_cast<size_t>(a.beams) * kHeadDim +
       static_cast<size_t>(a.beams) * a.sources * a.positions) * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = attend_rows_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(a.heads, batch), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attend
}  // namespace
