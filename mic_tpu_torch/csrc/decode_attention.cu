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
// cached element, and each (row, head) pair has a single query row, so the
// tensor cores do not apply.  What the time needs is bytes in flight.  The
// TPU kernel's aliased buffers, chunked DMA ring and 128-lane head-sum
// matmul existed for Mosaic's tiling and VMEM; here the cache is a mutable
// tensor and the column is a plain store.
//
// Design: one warp walks one split of the positions of one (row n, head h)
// pair.  A cached 64-dim K or V row is read as 16-byte loads by 8 lanes
// (bf16; 16 lanes in f32), so a warp load instruction covers kGroups = 4
// positions (2 in f32), and each lane group keeps its own online (max,
// sum, acc) over the positions b + g, b + g + kGroups, ...  of its split
// [b, e).  Positions go kUnroll to a group a round, and the next round's K
// and V rows are loaded before the current round is reduced, so two rounds
// (up to 32 rows of 128 bytes a warp) are in flight.  The step's own K/V
// are read from the step tensors, never from the column being written.
// The walk of a pair is cut into `splits` (1, 2 or 4) consecutive ranges
// [s * P / splits, (s + 1) * P / splits) of the P = index + 1 positions,
// one warp each, in one block; the host sizes splits from N x H, the SM
// count and P (ops/decode_attention.py::decode_splits) so that both a few
// rows (N = 4, beam 4 of one image) and N = 256 fill the card.  The lane
// groups of a warp merge by an xor butterfly (the same merge on both sides,
// so every lane ends with the same result), then the splits of a pair merge
// in shared memory in split order, and the pair's first warp writes the
// output.  The f32 instance runs the same template.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kWarps = 4;      // warps a block
constexpr int kUnroll = 4;     // positions a lane group has in one round
constexpr int kMaxSplits = 4;  // the splits of a pair share one block

template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;  // elements in a 16-byte load
  static __device__ __forceinline__ void to_float(uint4 raw, float (&f)[kN]) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  static __device__ __forceinline__ uint4 from_float(const float (&f)[kN]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&p);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void to_float(uint4 raw, float (&f)[kN]) {
    f[0] = __uint_as_float(raw.x);
    f[1] = __uint_as_float(raw.y);
    f[2] = __uint_as_float(raw.z);
    f[3] = __uint_as_float(raw.w);
  }
  static __device__ __forceinline__ uint4 from_float(const float (&f)[kN]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

// Fold the online state (om, ol, oacc) into (m, l, acc); an empty state has
// m = -inf and contributes nothing.
template <int N>
__device__ __forceinline__ void merge_state(float& m, float& l, float (&acc)[N], float om,
                                            float ol, const float (&oacc)[N]) {
  const float mm = fmaxf(m, om);
  if (mm == -INFINITY) return;
  const float a = m == -INFINITY ? 0.f : expf(m - mm);
  const float b = om == -INFINITY ? 0.f : expf(om - mm);
  l = l * a + ol * b;
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = acc[i] * a + oacc[i] * b;
  m = mm;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const T* __restrict__ q,       // (N, H, Dh), pre-scaled
                        const T* __restrict__ k_step,  // (N, H, Dh)
                        const T* __restrict__ v_step,  // (N, H, Dh)
                        T* cache_k,                    // (L, N, T, H, Dh)
                        T* cache_v,                    // (L, N, T, H, Dh)
                        T* __restrict__ out,           // (N, H, Dh)
                        int rows, int t_max, int heads, int layer, int index, int splits) {
  using V = Vec<T>;
  constexpr int kVec = V::kN;
  constexpr int kLanesPerRow = kHeadDim / kVec;  // 8 (bf16) or 16 (f32)
  constexpr int kGroups = 32 / kLanesPerRow;     // positions a warp load covers
  constexpr int kStride = kGroups * kUnroll;     // positions a warp covers a round
  __shared__ float merge_m[kWarps], merge_l[kWarps];
  __shared__ float merge_acc[kWarps][kHeadDim];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gw = blockIdx.x * kWarps + warp;
  const int pair = gw / splits;
  const int split = gw % splits;
  const bool active = pair < rows * heads;
  const int group = lane / kLanesPerRow;
  const int chunk = lane % kLanesPerRow;
  const int n = active ? pair / heads : 0;
  const int h = active ? pair % heads : 0;
  const size_t hd = static_cast<size_t>(heads) * kHeadDim;
  const size_t own = (static_cast<size_t>(n) * heads + h) * kHeadDim + chunk * kVec;
  // element offset of position 0 of this (layer, row, head, chunk)
  const size_t base =
      (static_cast<size_t>(layer) * rows + n) * t_max * hd + h * kHeadDim + chunk * kVec;

  float m = -INFINITY, l = 0.f, acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.f;

  if (active) {
    float qf[kVec];
    V::to_float(*reinterpret_cast<const uint4*>(q + own), qf);
    const uint4 k_own = *reinterpret_cast<const uint4*>(k_step + own);
    const uint4 v_own = *reinterpret_cast<const uint4*>(v_step + own);
    if (split == 0 && group == 0) {
      *reinterpret_cast<uint4*>(cache_k + base + index * hd) = k_own;
      *reinterpret_cast<uint4*>(cache_v + base + index * hd) = v_own;
    }
    // this split's positions [b, e); the group's are b + group + kGroups * j
    const int positions = index + 1;
    const int b = static_cast<int>(static_cast<int64_t>(split) * positions / splits);
    const int e = static_cast<int>(static_cast<int64_t>(split + 1) * positions / splits);
    auto load = [&](int t0, uint4 (&kr)[kUnroll], uint4 (&vr)[kUnroll]) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + group + kGroups * u;
        kr[u] = make_uint4(0u, 0u, 0u, 0u);
        vr[u] = kr[u];
        if (t < index && t < e) {
          kr[u] = *reinterpret_cast<const uint4*>(cache_k + base + t * hd);
          vr[u] = *reinterpret_cast<const uint4*>(cache_v + base + t * hd);
        } else if (t == index && t < e) {
          kr[u] = k_own;
          vr[u] = v_own;
        }
      }
    };
    uint4 kc[kUnroll], vc[kUnroll];
    load(b, kc, vc);
    for (int t0 = b; t0 < e; t0 += kStride) {
      // the next round's rows are in flight while this one is reduced
      uint4 kn[kUnroll], vn[kUnroll];
      load(t0 + kStride, kn, vn);
      float s[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float kf[kVec];
        V::to_float(kc[u], kf);
        s[u] = 0.f;
#pragma unroll
        for (int i = 0; i < kVec; ++i) s[u] = fmaf(qf[i], kf[i], s[u]);
      }
#pragma unroll
      for (int o = kLanesPerRow / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
      }
      float mx = m;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (t0 + group + kGroups * u >= e) s[u] = -INFINITY;
        mx = fmaxf(mx, s[u]);
      }
      if (mx > -INFINITY) {
        const float scale = expf(m - mx);  // 0 while the group has seen nothing
        l *= scale;
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[i] *= scale;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float p = expf(s[u] - mx);  // 0 for a position past the split
          float vf[kVec];
          V::to_float(vc[u], vf);
          l += p;
#pragma unroll
          for (int i = 0; i < kVec; ++i) acc[i] = fmaf(p, vf[i], acc[i]);
        }
        m = mx;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        kc[u] = kn[u];
        vc[u] = vn[u];
      }
    }
  }

  // the warp's lane groups, by an xor butterfly over the group bits
#pragma unroll
  for (int o = kLanesPerRow; o < 32; o <<= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m, o);
    const float ol = __shfl_xor_sync(0xffffffffu, l, o);
    float oacc[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) oacc[i] = __shfl_xor_sync(0xffffffffu, acc[i], o);
    merge_state(m, l, acc, om, ol, oacc);
  }

  if (splits > 1) {
    // the pair's splits, in split order, by its first warp
    if (group == 0) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) merge_acc[warp][chunk * kVec + i] = acc[i];
      if (chunk == 0) {
        merge_m[warp] = m;
        merge_l[warp] = l;
      }
    }
    __syncthreads();
    if (split == 0) {
      for (int z = 1; z < splits; ++z) {
        float oacc[kVec];
#pragma unroll
        for (int i = 0; i < kVec; ++i) oacc[i] = merge_acc[warp + z][chunk * kVec + i];
        merge_state(m, l, acc, merge_m[warp + z], merge_l[warp + z], oacc);
      }
    }
  }
  if (active && split == 0 && group == 0) {
    float o[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) o[i] = acc[i] / l;
    *reinterpret_cast<uint4*>(out + own) = V::from_float(o);
  }
}

template <typename T>
int launch(void* q, void* k_step, void* v_step, void* cache_k, void* cache_v, void* out,
           int layers, int rows, int t_max, int heads, int head_dim, int layer, int index,
           int splits, void* stream) {
  if (head_dim != kHeadDim || layers < 1 || rows < 1 || heads < 1 || layer < 0 ||
      layer >= layers || index < 0 || index >= t_max || splits < 1 || splits > kMaxSplits ||
      kWarps % splits != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t warps = static_cast<int64_t>(rows) * heads * splits;
  const int blocks = static_cast<int>((warps + kWarps - 1) / kWarps);
  decode_attention_kernel<T><<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_step), static_cast<const T*>(v_step),
      static_cast<T*>(cache_k), static_cast<T*>(cache_v), static_cast<T*>(out), rows, t_max,
      heads, layer, index, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// splits: warps a (row, head) pair's walk is cut into, 1, 2 or 4
// (ops/decode_attention.py::decode_splits).
extern "C" int mic_decode_attention_bf16(void* q, void* k_step, void* v_step, void* cache_k,
                                         void* cache_v, void* out, int layers, int rows,
                                         int t_max, int heads, int head_dim, int layer,
                                         int index, int splits, void* stream) {
  return launch<__nv_bfloat16>(q, k_step, v_step, cache_k, cache_v, out, layers, rows, t_max,
                               heads, head_dim, layer, index, splits, stream);
}

extern "C" int mic_decode_attention_f32(void* q, void* k_step, void* v_step, void* cache_k,
                                        void* cache_v, void* out, int layers, int rows,
                                        int t_max, int heads, int head_dim, int layer, int index,
                                        int splits, void* stream) {
  return launch<float>(q, k_step, v_step, cache_k, cache_v, out, layers, rows, t_max, heads,
                       head_dim, layer, index, splits, stream);
}
