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

#include <type_traits>

#include "attention_mma.cuh"

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

// The element type's loads and stores for the kernel below: bf16 (the
// serving dtype) or float (a float32 model's caches, q and step rows).
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Eight values at p (16-byte aligned) as f32: one 16-byte load of bf16, two of f32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(pair[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// Two elements copied as they are (the column write keeps the cache's dtype).
template <typename T>
__device__ __forceinline__ void copy_pair(T* dst, const T* src) {
  using Word = typename std::conditional<sizeof(T) == 2, uint32_t, uint2>::type;
  *reinterpret_cast<Word*>(dst) = *reinterpret_cast<const Word*>(src);
}

// T = __nv_bfloat16 (row 1 as the serving path runs it) or float (a float32
// model: the same walk, twice the bytes; every sum is f32 either way).
template <typename T>
__global__ void lazy_attention_kernel(
    const T* __restrict__ q,       // (B, K, H*Dh), pre-scaled
    T* cache_k,                    // (B*K, T, H*Dh)
    T* cache_v,                    // (B*K, T, H*Dh)
    const T* __restrict__ k_step,  // (B, K, H*Dh)
    const T* __restrict__ v_step,  // (B, K, H*Dh)
    const int32_t* __restrict__ ancestry,  // (B, K, T)
    T* __restrict__ out,           // (B, K, H*Dh)
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
    float f[8];
    load8(q + head_off + d, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) qr[d + i] = f[i];
  }

  // pass 1: one lane per live position t < index
  float m = kMaskValue;
  for (int t = lane; t < index; t += 32) {
    const T* kr = cache_k + ((static_cast<size_t>(b) * beams + anc[t]) * t_max + t) * hd +
                  static_cast<size_t>(h) * kHeadDim;
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < kHeadDim; d += 8) {
      float f[8];
      load8(kr + d, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc = fmaf(qr[d + i], f[i], acc);
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
  store_pair(out + head_off + 2 * lane, ax * inv, ay * inv);

  // In-place column write of row b*K + k at position `index`.  Every block
  // reads only positions < index, so no block reads what any block writes.
  const size_t col = (beam_row * t_max + index) * hd + static_cast<size_t>(h) * kHeadDim + 2 * lane;
  copy_pair(cache_k + col, k_step + head_off + 2 * lane);
  copy_pair(cache_v + col, v_step + head_off + 2 * lane);
}

// The int8-cache variant: replaces _kernel_dma_q8 of the same file.  The
// cache holds int8 rows, each with one f32 scale over its whole merged
// H*Dh row ((B*K, T) scale planes).  As on the TPU, a cached row's score is
// (q . k8) * ks[row, t]; the step's own K row enters unquantized (scale 1);
// after the f32 softmax each cached weight is multiplied by vs[row, t], and
// every weight is rounded to bf16 before the V product (the TPU kernel's
// w.astype(bf16)).  A float32 model's instance (split_kernel<float>) takes
// float32 q, step rows and output and leaves the weights in f32 (q's dtype,
// as the plain version at float32 does; the TPU kernel's bf16 casts are not
// copied, ROADMAP §C): the same walk, bound by the same int8 bytes.  The
// kernel also quantizes the beam's step rows as
// ops/quant.py::quantize_rows_dynamic does, bit for bit: one scale over the
// whole merged row (amax over all heads, floor 1e-8, times 1/127), IEEE
// division, round half to even, clamp to +-127, and writes them and their
// scales into column `index` in place.
//
// Bound: bytes of the live prefix, half those of the bf16 cache (64 B of K
// and 64 B of V per head row) plus 8 B of scales per position.  The first
// kernel here (one block per (head, image), a warp a beam) took the bf16
// kernel's 0.12 ms at the flagship for half its bytes: it was bound by
// latency and issue, not bytes (a serial V walk of one 2-byte load a lane
// a position, 64 floats of q a lane, an I2F a value, and every block
// re-reading its beams' 2 KB step rows for the amax).  Design, a split
// two-pass walk, one block per beam row (image b, beam k) over every head,
// so that each position's source row is read as one contiguous 1 KB merged
// row and the step rows once a block:
//   - 4 * G * P threads (at most 256, a multiple of 32; 128 at the
//     flagship, G = 16 and P = 2, whose 1024 blocks are all resident at
//     once at 64 registers a thread): thread (p, c) takes the 16-value
//     piece c of the G heads of a pass (G divides H; a quarter of a head's
//     q in registers) at positions t = p (mod P), P position groups
//     (ops/lazy_attention.py::q8_layout chooses G and P and sizes the
//     shared memory as q8::Layout lays it out);
//   - pass 1: each thread loads four positions' 16-byte K pieces before it
//     folds them, widens the int8 values exactly without I2F (the byte as the
//     low mantissa of 2^23, minus 2^23 + 128), and a head's four lanes add
//     their dot products by two xor shuffles; the scores (times the K row
//     scale) go to shared memory;
//   - a warp a head: the f32 softmax over the stored scores and the step
//     score, each weight divided by the final sum, times the V row scale,
//     rounded to bf16 (the weights need the final max and sum first, so no
//     online softmax);
//   - pass 2: the same walk over the V pieces, sixteen f32 sums a thread,
//     then the position groups' sums added in group order in shared memory
//     with the step row's term, one bf16 rounding;
//   - the step rows' amax, their quantized values and scales: once a block.
// Tensor cores do not help: each beam reads its own row at each position,
// so a beam-by-row product would be mostly waste.  Every sum has one fixed
// order, so reruns are bit-equal.
namespace q8 {

constexpr int kBatch = 4;  // positions a thread loads before it folds them

// Byte offsets of the block's shared memory, as ops/lazy_attention.py::
// q8_layout sizes them: the sources' (row, position), the K and V row
// scales and the scores (then weights) of positions < index; the position
// groups' partial sums; the step scores and weights; the warps' amaxes.
struct Layout {
  int ksc, vsc, p, part, st, red, bytes;
  __device__ __host__ Layout(int index, int group, int groups) {
    const int per = (4 * index + 15) & ~15;
    ksc = per;
    vsc = 2 * per;
    p = 3 * per;
    part = p + ((4 * group * index + 15) & ~15);
    st = part + 256 * group * groups;
    red = st + ((8 * group + 15) & ~15);
    bytes = red + 256;
  }
};

// Sixteen int8 values (raw, low byte first) as f32, exactly: each byte,
// offset to 0..255, becomes the low mantissa byte of 2^23 in f32, and
// 2^23 + 128 is subtracted (no I2F).
__device__ __forceinline__ void widen16(const uint4& raw, float (&f)[16]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t u = w[j] ^ 0x80808080u;
    f[4 * j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
    f[4 * j + 1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
    f[4 * j + 2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
    f[4 * j + 3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
  }
}

// Sixteen bf16 values at p (32 bytes, 16-byte aligned) as f32.
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&f)[16]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p + 8 * h);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
      f[8 * h + 2 * j] = v.x;
      f[8 * h + 2 * j + 1] = v.y;
    }
  }
}

// Sixteen f32 values at p (64 bytes, 16-byte aligned).
__device__ __forceinline__ void load16(const float* p, float (&f)[16]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 v = reinterpret_cast<const float4*>(p)[j];
    f[4 * j] = v.x, f[4 * j + 1] = v.y, f[4 * j + 2] = v.z, f[4 * j + 3] = v.w;
  }
}

__device__ __forceinline__ float amax8(const float (&v)[8]) {
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(v[j]));
  return m;
}

// Eight values quantized with `scale`, as eight int8 bytes.
__device__ __forceinline__ uint2 quantize8(const float (&v)[8], float scale) {
  uint32_t out[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    out[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(quantize(v[j], scale)))
                   << (8 * (j & 3));
  }
  return make_uint2(out[0], out[1]);
}

// A softmax weight as the V product takes it: rounded to bf16 where q is
// bf16 (the TPU kernel's w.astype(bf16)), kept in f32 where q is float32
// (q's dtype, as the plain version at float32).
template <typename Q>
__device__ __forceinline__ float weight_as(float w) {
  return std::is_same<Q, float>::value ? w : __bfloat162float(__float2bfloat16_rn(w));
}

// Eight outputs into p (16-byte aligned) in Q: one bf16 rounding, or as they are.
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint32_t packed[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    packed[j] = *reinterpret_cast<const uint32_t*>(&pair);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Q = __nv_bfloat16 (the serving dtype, the TPU kernel's math) or float (a
// float32 model: q, the step rows and the output in f32, the weights not
// rounded; the same walk, the step rows' reads twice the bytes).
template <typename Q>
__global__ void __launch_bounds__(256) split_kernel(
    const Q* __restrict__ q,               // (B, K, H*Dh), pre-scaled
    int8_t* cache_k,                       // (B*K, T, H*Dh)
    float* k_scale,                        // (B*K, T)
    int8_t* cache_v,                       // (B*K, T, H*Dh)
    float* v_scale,                        // (B*K, T)
    const Q* __restrict__ k_step,          // (B, K, H*Dh)
    const Q* __restrict__ v_step,          // (B, K, H*Dh)
    const int32_t* __restrict__ ancestry,  // (B, K, T)
    Q* __restrict__ out,                   // (B, K, H*Dh)
    int beams, int t_max, int heads, int index, int group, int groups) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(index, group, groups);
  int* srcs = reinterpret_cast<int*>(smem);  // (row, position) of each live position's source
  float* ksc = reinterpret_cast<float*>(smem + lay.ksc);
  float* vsc = reinterpret_cast<float*>(smem + lay.vsc);
  float* p = reinterpret_cast<float*>(smem + lay.p);        // (group, index)
  float* part = reinterpret_cast<float*>(smem + lay.part);  // (groups, 4 group, 16)
  float* st = reinterpret_cast<float*>(smem + lay.st);      // step scores | step weights
  float* red = reinterpret_cast<float*>(smem + lay.red);    // warp amaxes of K | of V

  const int row = blockIdx.x;  // b * beams + k
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int hd = heads * kHeadDim;
  const int pieces = 4 * group;
  const int piece = tid % pieces;
  const int pg = tid / pieces;
  const int hl = piece >> 2;

  const int beam0 = row - row % beams;
  for (int t = tid; t < index; t += nthreads) {
    const int at = (beam0 + ancestry[static_cast<size_t>(row) * t_max + t]) * t_max + t;
    srcs[t] = at;
    ksc[t] = k_scale[at];
    vsc[t] = v_scale[at];
  }

  // the step rows' scales: the amax over the whole merged rows, once
  const Q* ks8 = k_step + static_cast<size_t>(row) * hd;
  const Q* vs8 = v_step + static_cast<size_t>(row) * hd;
  float kmax = 0.f, vmax = 0.f;
  for (int i = tid; i < hd / 8; i += nthreads) {
    float kv[8], vv[8];
    load8(ks8 + 8 * i, kv);
    load8(vs8 + 8 * i, vv);
    kmax = fmaxf(kmax, amax8(kv));
    vmax = fmaxf(vmax, amax8(vv));
  }
  kmax = warp_max(kmax);
  vmax = warp_max(vmax);
  if (lane == 0) {
    red[warp] = kmax;
    red[32 + warp] = vmax;
  }
  __syncthreads();
  kmax = 0.f;
  vmax = 0.f;
  for (int w = 0; w < nthreads / 32; ++w) {
    kmax = fmaxf(kmax, red[w]);
    vmax = fmaxf(vmax, red[32 + w]);
  }
  const float kq = __fmul_rn(fmaxf(kmax, 1e-8f), kInv127);
  const float vq = __fmul_rn(fmaxf(vmax, 1e-8f), kInv127);
  // The quantized step rows and their scales into column `index`, in
  // place: every block reads only positions < index.
  const size_t col = static_cast<size_t>(row) * t_max + index;
  for (int i = tid; i < hd / 8; i += nthreads) {
    float kv[8], vv[8];
    load8(ks8 + 8 * i, kv);
    load8(vs8 + 8 * i, vv);
    *reinterpret_cast<uint2*>(cache_k + col * hd + 8 * i) = quantize8(kv, kq);
    *reinterpret_cast<uint2*>(cache_v + col * hd + 8 * i) = quantize8(vv, vq);
  }
  if (tid == 0) {
    k_scale[col] = kq;
    v_scale[col] = vq;
  }

  const int rounds = (index + kBatch * groups - 1) / (kBatch * groups);
  for (int h0 = 0; h0 < heads; h0 += group) {
    // this thread's piece: 16 dims of head h0 + hl of the merged row
    const int hoff = (h0 + hl) * kHeadDim + 16 * (piece & 3);
    const size_t own = static_cast<size_t>(row) * hd + hoff;
    float qr[16], f[16];
    load16(q + own, qr);
    load16(k_step + own, f);
    float s_step = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) s_step = fmaf(qr[i], f[i], s_step);
    s_step += __shfl_xor_sync(0xffffffffu, s_step, 1);
    s_step += __shfl_xor_sync(0xffffffffu, s_step, 2);
    if (pg == 0 && (piece & 3) == 0) st[hl] = s_step;

    // pass 1: the scores of this piece's head at positions t = pg (mod groups)
    for (int r = 0; r < rounds; ++r) {
      uint4 raw[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int t = (r * kBatch + u) * groups + pg;
        raw[u] = t < index ? *reinterpret_cast<const uint4*>(
                                 cache_k + static_cast<size_t>(srcs[t]) * hd + hoff)
                           : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int t = (r * kBatch + u) * groups + pg;
        widen16(raw[u], f);
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i) acc = fmaf(qr[i], f[i], acc);
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        if (t < index && (piece & 3) == 0) p[hl * index + t] = __fmul_rn(acc, ksc[t]);
      }
    }
    __syncthreads();

    // a warp a head: softmax, weights times the V row scales (rounded to
    // bf16 where q is bf16)
    for (int h = warp; h < group; h += nthreads / 32) {
      float* ph = p + h * index;
      float m = kMaskValue;
      for (int t = lane; t < index; t += 32) m = fmaxf(m, ph[t]);
      const float sh = st[h];
      m = fmaxf(warp_max(m), sh);
      float l = 0.f;
      for (int t = lane; t < index; t += 32) {
        const float e = expf(ph[t] - m);
        ph[t] = e;
        l += e;
      }
      const float e_step = expf(sh - m);
      l = warp_sum(l) + e_step;
      for (int t = lane; t < index; t += 32) {
        ph[t] = weight_as<Q>(__fmul_rn(__fdiv_rn(ph[t], l), vsc[t]));
      }
      if (lane == 0) st[group + h] = weight_as<Q>(__fdiv_rn(e_step, l));
    }
    __syncthreads();

    // pass 2: sixteen output dims of this piece over the same positions
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    for (int r = 0; r < rounds; ++r) {
      uint4 raw[kBatch];
      float w[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int t = (r * kBatch + u) * groups + pg;
        const bool live = t < index;
        raw[u] = live ? *reinterpret_cast<const uint4*>(
                            cache_v + static_cast<size_t>(srcs[t]) * hd + hoff)
                      : make_uint4(0, 0, 0, 0);
        w[u] = live ? p[hl * index + t] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        widen16(raw[u], f);
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[i] = fmaf(w[u], f[i], acc[i]);
      }
    }
    float4* mine =
        reinterpret_cast<float4*>(part + (static_cast<size_t>(pg) * pieces + piece) * 16);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mine[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
    }
    __syncthreads();

    // eight output dims a thread: the position groups' sums in group order,
    // then the step row's term, one rounding to Q
    for (int item = tid; item < 8 * group; item += nthreads) {
      const int pc = item >> 1;
      const int half = item & 1;
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = part[pc * 16 + 8 * half + j];
      for (int g = 1; g < groups; ++g) {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] += part[(g * pieces + pc) * 16 + 8 * half + j];
      }
      const size_t o = static_cast<size_t>(row) * hd + (h0 + (pc >> 2)) * kHeadDim +
                       16 * (pc & 3) + 8 * half;
      const float ws = st[group + (pc >> 2)];
      float vs[8];
      load8(v_step + o, vs);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = fmaf(ws, vs[j], v[j]);
      store8(out + o, v);
    }
    __syncthreads();  // the next group of heads reuses p, part and st
  }
}

}  // namespace q8

template <typename T>
int launch_lazy_attention(void* q, void* cache_k, void* cache_v, void* k_step, void* v_step,
                          void* ancestry, void* out, int batch, int beams, int t_max, int heads,
                          int head_dim, int index, void* stream) {
  if (head_dim != kHeadDim || beams < 1 || beams > 32 || index < 0 || index >= t_max) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(heads, batch);
  const dim3 block(32 * beams);
  const size_t smem = 2 * static_cast<size_t>(beams) * t_max * sizeof(float);
  lazy_attention_kernel<T><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<T*>(cache_k), static_cast<T*>(cache_v),
      static_cast<const T*>(k_step), static_cast<const T*>(v_step),
      static_cast<const int32_t*>(ancestry), static_cast<T*>(out), beams, t_max, heads, index);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mic_lazy_attention_bf16(void* q, void* cache_k, void* cache_v, void* k_step,
                                       void* v_step, void* ancestry, void* out, int batch,
                                       int beams, int t_max, int heads, int head_dim, int index,
                                       void* stream) {
  return launch_lazy_attention<__nv_bfloat16>(q, cache_k, cache_v, k_step, v_step, ancestry,
                                              out, batch, beams, t_max, heads, head_dim, index,
                                              stream);
}

// The same over float32 caches, q, step rows and output.
extern "C" int mic_lazy_attention_f32(void* q, void* cache_k, void* cache_v, void* k_step,
                                      void* v_step, void* ancestry, void* out, int batch,
                                      int beams, int t_max, int heads, int head_dim, int index,
                                      void* stream) {
  return launch_lazy_attention<float>(q, cache_k, cache_v, k_step, v_step, ancestry, out, batch,
                                      beams, t_max, heads, head_dim, index, stream);
}

namespace {

// group: heads a pass takes (a divisor of heads), groups: position
// groups; 4 * group * groups threads a block, as ops/lazy_attention.py::
// q8_layout chooses them (the shared memory holds no row of q or the step,
// so one layout serves both element types of Q).
template <typename Q>
int launch_q8(void* q, void* cache_k, void* k_scale, void* cache_v, void* v_scale, void* k_step,
              void* v_step, void* ancestry, void* out, int batch, int beams, int t_max,
              int heads, int head_dim, int index, int group, int groups, void* stream) {
  const int threads = 4 * group * groups;
  if (head_dim != kHeadDim || beams < 1 || index < 0 || index >= t_max || group < 1 ||
      heads % group || groups < 1 || threads > 256 || threads % 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const q8::Layout lay(index, group, groups);
  if (lay.bytes > 232448) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = q8::split_kernel<Q>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch * beams, threads, lay.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Q*>(q), static_cast<int8_t*>(cache_k), static_cast<float*>(k_scale),
      static_cast<int8_t*>(cache_v), static_cast<float*>(v_scale), static_cast<const Q*>(k_step),
      static_cast<const Q*>(v_step), static_cast<const int32_t*>(ancestry), static_cast<Q*>(out),
      beams, t_max, heads, index, group, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mic_lazy_attention_q8(void* q, void* cache_k, void* k_scale, void* cache_v,
                                     void* v_scale, void* k_step, void* v_step, void* ancestry,
                                     void* out, int batch, int beams, int t_max, int heads,
                                     int head_dim, int index, int group, int groups,
                                     void* stream) {
  return launch_q8<__nv_bfloat16>(q, cache_k, k_scale, cache_v, v_scale, k_step, v_step,
                                  ancestry, out, batch, beams, t_max, heads, head_dim, index,
                                  group, groups, stream);
}

// The same over float32 q, step rows and output (a float32 model's int8
// cache): the weights stay f32, nothing is rounded to bf16.
extern "C" int mic_lazy_attention_q8_f32(void* q, void* cache_k, void* k_scale, void* cache_v,
                                         void* v_scale, void* k_step, void* v_step,
                                         void* ancestry, void* out, int batch, int beams,
                                         int t_max, int heads, int head_dim, int index,
                                         int group, int groups, void* stream) {
  return launch_q8<float>(q, cache_k, k_scale, cache_v, v_scale, k_step, v_step, ancestry, out,
                          batch, beams, t_max, heads, head_dim, index, group, groups, stream);
}

// The blocked kernel of mode "1": replaces
// mic_tpu/ops/lazy_attention.py::fused_lazy_attention (_kernel_bf16 and
// _kernel_q8, whose arithmetic is _attend_tiles').  It reads the PRE-update
// cache and never writes it: the caller stores the step column after it.
// Liveness comes from the per-step (B, J*T, K) int8 mask shared by every
// layer (any bits: several source rows may be live for one beam at one
// position), and each beam's own step row is scored unquantized (scale 1)
// and live for that beam only.  The int8 variant reads per-(row, position,
// head) f32 scales, (B*K, T, H).  The kernel walks positions < `positions`
// only: the wrapper passes the write index, past which the strict mask
// admits nothing.  For image b, head h and query beam k:
//
//   s[k, (j,t)] = (q[b,k,h] . K[j,t,h]) * k_scale[j,t,h]   (f32; scale 1 in bf16)
//   dead (row, beam) pairs score finfo(float32).min
//   s_step = q . k_step[b,k,h]
//   w = softmax(s) in f32, cached weights times v_scale[j,t,h], rounded to bf16
//   out[b,k,h] = bf16( sum w * V + w_step * v_step )           (f32 sums)
//
// Bound: bytes of the K and V head rows the mask admits (128 bytes each in
// bf16, 64 in int8), each read once.  Design, one block of eight warps per
// (head, image), up to four blocks an SM (64 registers: at small indices
// the blocks' latencies overlap), as a split row walk:
//   0. the block reads each row's mask as one word and gathers the rows some
//      beam admits, with their beams' bits, into a list (a ballot and the
//      warps' counts: the list is in row order, whatever the timing);
//   1. it copies the listed K and V head rows into shared memory, bf16 by
//      cp.async, every 16-byte piece of a chunk of `stage` rows in flight at
//      once, V's first chunk behind K's; int8 through registers, widened to
//      bf16 on the way (exact: int8 values are bf16 values), with their
//      scales;
//   2. the scores of every beam against eight staged rows are one
//      mma.sync.m16n8k16 product chain, q (the beams, padded to 16 rows) as
//      A and the rows by ldmatrix as B, the warps taking alternate groups
//      of eight rows; rows no beam admits are never read;
//   3. warp k runs beam k's softmax over the stored scores;
//   4. the weights (bf16, exact) of sixteen rows times their V rows
//      (ldmatrix.trans) is another chain, the warps taking alternate groups
//      of sixteen rows, each warp's f32 sums added in warp order in shared
//      memory.
// The tensor cores take the dot products off the issue slots: with f32
// FMAs, eight lanes a row, the walk was bound by the instructions it
// issued, not by its bytes (the int8 walk, with its widening and scales,
// still is, at a quarter of its bound).  Every sum has
// one fixed order, so reruns are bit-equal.  Where the list does not fit
// beside the scores of every (row, beam) and a chunk (eight beams past
// about 800 positions), the walk takes every row in order with no list,
// reading rows no beam admits at weight 0, and where even two chunks of a
// row do not fit, K's and V's chunks take turns in one buffer; rows past a
// chunk's end are read as its last row, at weight 0 (blocked_layout in
// ops/lazy_attention.py chooses the list and the buffers and sizes the
// chunk).
// A float32 model's instances: on the per-head int8 cache, f32 q, step rows
// and output around the same walk (q rounded to bf16 as it becomes A); on a
// float32 cache, _attend_tiles on f32 tiles: q and the step rows rounded to
// bf16, f32 K and V rows not rounded, every weight rounded to bf16, one
// bf16 rounding of the output, returned in f32.  Its staged rows are 272
// bytes (64 f32 and 16 that spread the float4 reads), the beams' rounded q
// rows sit in shared memory, and both products are f32 FMAs: a thread a
// staged row for the scores (every beam's dot product with it), warp w the
// rows w, w + 8, ... for the V product (lane l every beam's dims 2 l, 2 l +
// 1), each warp's sums added in warp order as in the bf16 walk.
// Nine to sixteen beams take one instance per form, K read at run time
// (kWide): q's 16 rows of the A operand hold beams g and g + 8 (rows past K
// zero), so both products are the same chains as at eight beams; warp w
// runs the softmax of beams w and w + 8; a row's K mask bytes are read as
// words where K % 4 == 0 (its bytes start at row * K), as halves where K is
// even, else byte by byte, and its sixteen beam bits go in the list beside
// the row's position (12 bits) and source beam (4 bits).  Two blocks an SM
// at most (128 registers): at sixteen beams the scores of every (beam, row)
// take 64 KB at index 63.  Past sixteen beams the tile needs a second M
// tile (ROADMAP B41b).
namespace {
namespace blocked {

using attn_mma::ldmatrix_x4;
using attn_mma::ldmatrix_x4_trans;
using attn_mma::mma_bf16;
using attn_mma::pack_bf16;
using attn_mma::smem_addr;
using attn_mma::store_widened;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// bytes of a staged row: 64 bf16 (int8 rows widened to bf16) and 16 bytes
// that spread ldmatrix, or 64 f32 and 16 bytes that spread the float4 reads
constexpr int kPitch = 144;
constexpr int kPitchF32 = 272;
constexpr size_t kMaxSmem = 232448;
constexpr int kWide = 16;  // the instance of 9-16 beams: the A tile's rows

struct Args {
  const void* q;        // (B, K, H*Dh), pre-scaled by Dh**-0.5, bf16 or f32
  const void* cache_k;  // (B*K, t_max, H*Dh) bf16, int8 or f32
  const void* cache_v;
  const float* k_scale;  // (B*K, t_max, H) f32, int8 caches only
  const float* v_scale;
  const void* k_step;   // (B, K, H*Dh), q's dtype
  const void* v_step;
  const int8_t* amask;  // (B, K*t_max, K)
  void* out;            // (B, K, H*Dh), q's dtype
  int t_max, positions, heads, compact, stage, shared;
  int beams;            // K, which the kWide instance reads at run time
};

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// The block's shared bytes, in order: the scores, then weights, of every
// (beam, row), which the warps' partial sums reuse after the walk; where
// compact, the list of rows and the warps' counts; on a float32 cache the
// beams' q rows (rounded to bf16, held in f32); a chunk of `stage` K rows
// and one of V rows (each with its f32 scales in int8), or where `shared`
// one chunk that the V rows take after the scores.
__host__ __device__ constexpr size_t weight_bytes(int beams, int positions) {
  const size_t rows = static_cast<size_t>(beams) * positions;
  const size_t scores = static_cast<size_t>(beams) * rows;
  const size_t partial = static_cast<size_t>(kWarps) * beams * kHeadDim;
  return align16(4 * (scores > partial ? scores : partial));
}
__host__ __device__ constexpr size_t list_bytes(int beams, int positions, int compact) {
  return compact ? align16(4 * (static_cast<size_t>(beams) * positions + kWarps)) : 0;
}
__host__ __device__ constexpr size_t q_bytes(int beams, bool f32) {
  return f32 ? align16(4 * static_cast<size_t>(beams) * kHeadDim) : 0;
}
__host__ __device__ constexpr size_t stage_bytes(int stage, bool q8, bool f32) {
  return static_cast<size_t>(stage) * (f32 ? kPitchF32 : kPitch) +
         (q8 ? align16(4 * static_cast<size_t>(stage)) : 0);
}
__host__ __device__ constexpr size_t smem_bytes(int beams, int positions, int compact, int stage,
                                                int shared, bool q8, bool f32) {
  return weight_bytes(beams, positions) + list_bytes(beams, positions, compact) +
         q_bytes(beams, f32) + (shared ? 1 : 2) * stage_bytes(stage, q8, f32);
}

// Which of the K beams admit a row: its K mask bytes, read as one word.
template <int K>
__device__ __forceinline__ unsigned live_bits(const int8_t* m) {
  uint32_t lo = 0, hi = 0;
  if constexpr (K == 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(m);
    lo = w.x;
    hi = w.y;
  } else if constexpr (K == 4) {
    lo = *reinterpret_cast<const uint32_t*>(m);
  } else if constexpr (K == 2) {
    lo = *reinterpret_cast<const uint16_t*>(m);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      (k < 4 ? lo : hi) |= static_cast<uint32_t>(static_cast<uint8_t>(m[k])) << (8 * (k & 3));
    }
  }
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    bits |= (((k < 4 ? lo : hi) >> (8 * (k & 3))) & 0xffu ? 1u : 0u) << k;
  }
  return bits;
}

// The same for 9-16 beams, K at run time: a row's bytes start at row * K,
// 4-byte aligned where K % 4 == 0 and 2-byte aligned where K is even.
__device__ __forceinline__ unsigned live_bits_wide(const int8_t* m, int K) {
  unsigned bits = 0;
  if ((K & 3) == 0) {
#pragma unroll
    for (int w = 0; w < kWide / 4; ++w) {
      if (4 * w < K) {
        const uint32_t x = *reinterpret_cast<const uint32_t*>(m + 4 * w);
#pragma unroll
        for (int e = 0; e < 4; ++e) bits |= ((x >> (8 * e)) & 0xffu ? 1u : 0u) << (4 * w + e);
      }
    }
  } else if ((K & 1) == 0) {
#pragma unroll
    for (int w = 0; w < kWide / 2; ++w) {
      if (2 * w < K) {
        const uint32_t x = *reinterpret_cast<const uint16_t*>(m + 2 * w);
        bits |= ((x & 0xffu ? 1u : 0u) | (x & 0xff00u ? 2u : 0u)) << (2 * w);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kWide; ++k) {
      if (k < K) bits |= (m[k] ? 1u : 0u) << k;
    }
  }
  return bits;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Two values of q or a step row as the products take them: bf16 values (a
// float32 model's rounded to bf16, as _attend_tiles casts them).
__device__ __forceinline__ float2 load_bf16_pair(const __nv_bfloat16* p) { return load_pair(p); }
__device__ __forceinline__ float2 load_bf16_pair(const float* p) {
  const float2 v = load_pair(p);
  return make_float2(bf16_round(v.x), bf16_round(v.y));
}

// One output pair: rounded to bf16 once, stored in q's dtype.
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store_out(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(bf16_round(x), bf16_round(y));
}

// T: the cache's element (bf16, int8, or f32 on a float32 model); Q: q's,
// the step rows' and the output's (bf16, or f32 on a float32 model).  On a
// float32 cache the products have one bf16 operand (q, or the weights) and
// one f32 (K, or V) and run as f32 FMAs: at K=4 each 4-byte element loaded
// feeds 8 flops, below the card's ~20 flops a byte, so the walk stays bound
// by its bytes.
template <typename T, typename Q, int KT>
__global__ void __launch_bounds__(kThreads, KT == kWide ? 2 : 4) blocked_kernel(const Args a) {
  constexpr bool kQ8 = std::is_same<T, int8_t>::value;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr bool kW = KT == kWide;  // 9-16 beams: beams g and g + 8 in the A tile
  constexpr int kPieces = kHeadDim * sizeof(T) / 16;  // 16-byte pieces of a head row (8, 4, 16)
  constexpr int kRowPitch = kF32 ? kPitchF32 : kPitch;
  const int K = kW ? a.beams : KT;
  const Q* q_in = static_cast<const Q*>(a.q);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // the beam (A and C row) of this lane's fragments
  const int c = lane & 3;
  const int hd = a.heads * kHeadDim;
  const int positions = a.positions;
  const int rows = K * positions;  // (source j, position t) as j * positions + t
  const int stage = a.stage;
  float* w = reinterpret_cast<float*>(smem_raw);  // [K][rows]: scores, then weights
  float* part = w;                                // [kWarps][K][Dh], after the walk
  unsigned char* next = smem_raw + weight_bytes(K, positions);
  // [rows]: j t_max + t | bits << 24, or where kW t | j << 12 | bits << 16
  int* list = reinterpret_cast<int*>(next);
  int* counts = list + rows;                 // [kWarps]
  next += list_bytes(K, positions, a.compact);
  float* q_s = reinterpret_cast<float*>(next);  // [K][Dh], f32 caches only
  next += q_bytes(K, kF32);
  unsigned char* k_tile = next;  // [stage][kRowPitch], then the scales [stage]
  unsigned char* v_tile = a.shared ? k_tile : next + stage_bytes(stage, kQ8, kF32);
  float* k_sc = reinterpret_cast<float*>(k_tile + stage * kRowPitch);
  float* v_sc = reinterpret_cast<float*>(v_tile + stage * kRowPitch);
  const size_t row0 = static_cast<size_t>(b) * K * a.t_max;  // the image's first cache row

  // q as the A operand of the scores (beam g's dims 16 s + 2 c (+ 1, + 8,
  // + 9); rows 8-15 beam g + 8's where kW, else zero, and beams past K
  // zero), or on a float32 cache the beams' q rows in shared memory; and
  // warp k's pairs of beam k's (and k + 8's) q and step rows for the
  // softmax and the output, loaded first: their latency hides behind the
  // mask's
  uint32_t qa[4][2] = {}, qb[4][2] = {};
  auto load_q = [&](int beam, uint32_t (&frag)[4][2]) {
    const Q* qg = q_in + (static_cast<size_t>(b) * K + beam) * hd + h * kHeadDim + 2 * c;
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      if constexpr (std::is_same<Q, float>::value) {
        const float2 lo = load_pair(qg + 16 * st);
        const float2 hi = load_pair(qg + 16 * st + 8);
        frag[st][0] = pack_bf16(lo.x, lo.y);
        frag[st][1] = pack_bf16(hi.x, hi.y);
      } else {
        frag[st][0] = *reinterpret_cast<const uint32_t*>(qg + 16 * st);
        frag[st][1] = *reinterpret_cast<const uint32_t*>(qg + 16 * st + 8);
      }
    }
  };
  if constexpr (kF32) {
    if (tid < K * kHeadDim / 4) {
      const int k = tid / (kHeadDim / 4);
      const int d = 4 * (tid % (kHeadDim / 4));
      const float4 v = *reinterpret_cast<const float4*>(
          q_in + (static_cast<size_t>(b) * K + k) * hd + h * kHeadDim + d);
      *reinterpret_cast<float4*>(q_s + k * kHeadDim + d) =
          make_float4(bf16_round(v.x), bf16_round(v.y), bf16_round(v.z), bf16_round(v.w));
    }
  } else {
    if (g < K) load_q(g, qa);
    if constexpr (kW) {
      if (g + 8 < K) load_q(g + 8, qb);
    }
  }
  const size_t qrow =
      (static_cast<size_t>(b) * K + warp) * hd + static_cast<size_t>(h) * kHeadDim + 2 * lane;
  const size_t qrow8 = qrow + 8 * static_cast<size_t>(hd);  // beam warp + 8's (kW)
  float2 q2 = {}, ks = {}, vs = {}, q2b = {}, ksb = {}, vsb = {};
  if (warp < K) {
    q2 = load_bf16_pair(q_in + qrow);
    ks = load_bf16_pair(static_cast<const Q*>(a.k_step) + qrow);
    vs = load_bf16_pair(static_cast<const Q*>(a.v_step) + qrow);
  }
  if constexpr (kW) {
    if (warp + 8 < K) {
      q2b = load_bf16_pair(q_in + qrow8);
      ksb = load_bf16_pair(static_cast<const Q*>(a.k_step) + qrow8);
      vsb = load_bf16_pair(static_cast<const Q*>(a.v_step) + qrow8);
    }
  }
  auto mask_bits = [&](size_t row) {
    if constexpr (kW) {
      return live_bits_wide(a.amask + row * K, K);
    } else {
      return live_bits<KT>(a.amask + row * K);
    }
  };

  // 0. the rows some beam admits, in row order, with their beams' bits
  int n = rows;
  if (a.compact) {
    n = 0;
    for (int base = 0; base < rows; base += kThreads) {
      const int r = base + tid;
      int at = 0;  // the row's offset in the image's cache rows
      int entry = 0;
      unsigned bits = 0u;
      if (r < rows) {
        const int j = r / positions;
        const int t = r - j * positions;
        at = j * a.t_max + t;
        bits = mask_bits(row0 + at);
        entry = kW ? t | (j << 12) | static_cast<int>(bits << 16) : at | (bits << 24);
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, bits != 0u);
      if (lane == 0) counts[warp] = __popc(ballot);
      __syncthreads();
      int before = n;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        before += v < warp ? counts[v] : 0;
        n += counts[v];
      }
      if (bits) list[before + __popc(ballot & ((1u << lane) - 1u))] = entry;
      __syncthreads();
    }
  }
  // entry i's cache row, and its beams' bits
  auto entry_row = [&](int i) {
    if (a.compact) {
      if constexpr (kW) {
        return row0 + static_cast<size_t>((list[i] >> 12) & 15) * a.t_max + (list[i] & 0xfff);
      } else {
        return row0 + (list[i] & 0xffffff);
      }
    }
    const int j = i / positions;
    return row0 + static_cast<size_t>(j) * a.t_max + (i - j * positions);
  };
  auto entry_bits = [&](int i) {
    return a.compact ? static_cast<unsigned>(list[i]) >> (kW ? 16 : 24)
                     : mask_bits(entry_row(i));
  };

  // 1. bf16 and f32: entries [c0, c1) of the cache (K or V) into `tile` by
  // cp.async
  auto stage_rows = [&](const void* cache, unsigned char* tile, int c0, int c1) {
    const unsigned char* src = static_cast<const unsigned char*>(cache);
    for (int p = tid; p < (c1 - c0) * kPieces; p += kThreads) {
      const int e = p / kPieces;
      const int piece = p - e * kPieces;
      attn_mma::cp_async16(smem_addr(tile + e * kRowPitch + 16 * piece),
                           src + ((entry_row(c0 + e) * hd + h * kHeadDim) * sizeof(T) +
                                  16 * piece),
                           16);
    }
    attn_mma::cp_async_commit();
  };
  // int8: entries [c0, c1) of K (where k) and V (where v) loaded into
  // registers a 16-byte piece at a time (entry tid's scales with the first:
  // a chunk has at most kThreads rows) and stored widened to bf16 rows, the
  // scales beside
  auto widen_rows = [&](bool k, bool v, int c0, int c1) {
    const int8_t* cache_k = static_cast<const int8_t*>(a.cache_k);
    const int8_t* cache_v = static_cast<const int8_t*>(a.cache_v);
    float sk = 0.f, sv = 0.f;
    if (tid < c1 - c0) {
      const size_t at = entry_row(c0 + tid) * a.heads + h;
      if (k) sk = a.k_scale[at];
      if (v) sv = a.v_scale[at];
    }
    for (int p = tid; p < (c1 - c0) * kPieces; p += kThreads) {
      const size_t src = entry_row(c0 + p / kPieces) * hd + h * kHeadDim + 16 * (p % kPieces);
      const int dst = (p / kPieces) * kRowPitch + 32 * (p % kPieces);
      uint4 rk, rv;
      if (k) rk = *reinterpret_cast<const uint4*>(cache_k + src);
      if (v) rv = *reinterpret_cast<const uint4*>(cache_v + src);
      if (k) store_widened(k_tile + dst, rk);
      if (v) store_widened(v_tile + dst, rv);
    }
    if (tid < c1 - c0) {
      if (k) k_sc[tid] = sk;
      if (v) v_sc[tid] = sv;
    }
  };
  const int chunks = (n + stage - 1) / stage;
  if (n > 0) {
    if constexpr (kQ8) {
      widen_rows(true, !a.shared, 0, min(n, stage));
    } else {
      stage_rows(a.cache_k, k_tile, 0, min(n, stage));
      if (!a.shared) stage_rows(a.cache_v, v_tile, 0, min(n, stage));
    }
  }

  // 2. scores: warp w takes groups of eight staged rows w, w + 8, ...
  for (int ch = 0; ch < chunks; ++ch) {
    const int c0 = ch * stage;
    const int nc = min(n, c0 + stage) - c0;
    if (ch > 0) {
      __syncthreads();  // every warp is done with the last chunk
      if constexpr (kQ8) {
        widen_rows(true, false, c0, c0 + nc);
      } else {
        stage_rows(a.cache_k, k_tile, c0, c0 + nc);
        attn_mma::cp_async_wait<0>();
      }
    } else if (!kQ8 && a.shared) {
      attn_mma::cp_async_wait<0>();
    } else if (!kQ8) {
      attn_mma::cp_async_wait<1>();  // K's first chunk; V's may be in flight
    }
    __syncthreads();
    if constexpr (kF32) {
      // a thread a staged row: every beam's f32 dot product with it, q's
      // reads the same for the warp (a broadcast)
      for (int il = tid; il < nc; il += kThreads) {
        const float* kr = reinterpret_cast<const float*>(k_tile + il * kRowPitch);
        float acc[KT];
#pragma unroll
        for (int k = 0; k < KT; ++k) acc[k] = 0.f;
#pragma unroll 4
        for (int d = 0; d < kHeadDim; d += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
          for (int k = 0; k < KT; ++k) {
            if (k < K) {
              const float4 qv = *reinterpret_cast<const float4*>(q_s + k * kHeadDim + d);
              acc[k] = fmaf(qv.x, kv.x, acc[k]);
              acc[k] = fmaf(qv.y, kv.y, acc[k]);
              acc[k] = fmaf(qv.z, kv.z, acc[k]);
              acc[k] = fmaf(qv.w, kv.w, acc[k]);
            }
          }
        }
        const int i = c0 + il;
        const unsigned bits = entry_bits(i);
#pragma unroll
        for (int k = 0; k < KT; ++k) {
          if (k < K) w[k * rows + i] = (bits >> k) & 1u ? acc[k] : kMaskValue;
        }
      }
      continue;
    }
    for (int r0 = 8 * warp; r0 < nc; r0 += 8 * kWarps) {
      // rows past the chunk read as its last row; their scores are dropped
      const int row = min(r0 + (lane & 7), nc - 1);
      const uint32_t at = smem_addr(k_tile + row * kRowPitch + 16 * (lane >> 3));
      uint32_t lo[4], hi[4];  // the B operands of dims 0-31 and 32-63
      ldmatrix_x4(lo, at);
      ldmatrix_x4(hi, at + 64);
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        const uint32_t af[4] = {qa[st][0], kW ? qb[st][0] : 0u, qa[st][1], kW ? qb[st][1] : 0u};
        const uint32_t b0 = st < 2 ? lo[2 * st] : hi[2 * st - 4];
        const uint32_t b1 = st < 2 ? lo[2 * st + 1] : hi[2 * st - 3];
        mma_bf16(d, af, b0, b1);
      }
      if (g < K) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int il = r0 + 2 * c + e;
          if (il < nc) {
            const int i = c0 + il;
            const unsigned bits = entry_bits(i);
            const float sc = kQ8 ? __fmul_rn(d[e], k_sc[il]) : d[e];
            w[g * rows + i] = (bits >> g) & 1u ? sc : kMaskValue;
            if constexpr (kW) {
              if (g + 8 < K) {
                const float s8 = kQ8 ? __fmul_rn(d[2 + e], k_sc[il]) : d[2 + e];
                w[(g + 8) * rows + i] = (bits >> (g + 8)) & 1u ? s8 : kMaskValue;
              }
            }
          }
        }
      }
    }
  }
  __syncthreads();

  // 3. warp k: beam k's softmax (and beam k + 8's where kW); its step row's
  // weight stays in registers.  bf16 and f32 caches' weights are rounded to
  // bf16 here; int8 ones after their V scale, in 4.
  auto softmax = [&](int beam, float2 qq, float2 kk) {
    float* wk = w + beam * rows;
    float m = kMaskValue;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, wk[i]);
    const float s_step = warp_sum(qq.x * kk.x + qq.y * kk.y);
    m = fmaxf(warp_max(m), s_step);
    float l = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float e = expf(wk[i] - m);
      wk[i] = e;
      l += e;
    }
    const float e_step = expf(s_step - m);
    l = warp_sum(l) + e_step;
    for (int i = lane; i < n; i += 32) {
      const float x = __fdiv_rn(wk[i], l);
      wk[i] = kQ8 ? x : bf16_round(x);
    }
    return bf16_round(__fdiv_rn(e_step, l));
  };
  float w_step = 0.f, w_step8 = 0.f;
  if (warp < K) w_step = softmax(warp, q2, ks);
  if constexpr (kW) {
    if (warp + 8 < K) w_step8 = softmax(warp + 8, q2b, ksb);
  }

  // 4. the V walk: warp w takes groups of sixteen staged rows w, w + 8, ...
  // (on a float32 cache the rows w, w + 8, ..., lane l every beam's dims
  // 2 l and 2 l + 1, the weights' reads a broadcast)
  float acc[8][4];  // beam g's output dims 8 nb + 2 c (+ 1) in [nb][0..1], g + 8's in [2..3]
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[nb][x] = 0.f;
  float accf[KT][2];  // f32 caches: beam k's dims 2 lane (+ 1)
#pragma unroll
  for (int k = 0; k < KT; ++k) accf[k][0] = accf[k][1] = 0.f;
  for (int ch = 0; ch < chunks; ++ch) {
    const int c0 = ch * stage;
    const int nc = min(n, c0 + stage) - c0;
    if (ch > 0 || a.shared) {
      __syncthreads();  // every warp is done with the last chunk
      if constexpr (kQ8) {
        widen_rows(false, true, c0, c0 + nc);
      } else {
        stage_rows(a.cache_v, v_tile, c0, c0 + nc);
      }
    }
    if constexpr (!kQ8) attn_mma::cp_async_wait<0>();
    __syncthreads();  // and, the first time, every weight is written
    if constexpr (kF32) {
      for (int il = warp; il < nc; il += kWarps) {
        const float2 v2 = *reinterpret_cast<const float2*>(v_tile + il * kRowPitch + 8 * lane);
#pragma unroll
        for (int k = 0; k < KT; ++k) {
          if (k < K) {
            const float wk = w[k * rows + c0 + il];
            accf[k][0] = fmaf(wk, v2.x, accf[k][0]);
            accf[k][1] = fmaf(wk, v2.y, accf[k][1]);
          }
        }
      }
      continue;
    }
    for (int e0 = 16 * warp; e0 < nc; e0 += 16 * kWarps) {
      // beam g's (and g + 8's) weights of rows e0 + 2 c (+ 1, + 8, + 9); 0
      // past the chunk
      auto weights = [&](int beam, float (&x)[4]) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int il = e0 + 2 * c + (e & 1) + 8 * (e >> 1);
          if (il < nc) {
            x[e] = w[beam * rows + c0 + il];
            if (kQ8) x[e] = bf16_round(x[e] != 0.f ? __fmul_rn(x[e], v_sc[il]) : x[e]);
          }
        }
      };
      float x[4] = {0.f, 0.f, 0.f, 0.f}, y[4] = {0.f, 0.f, 0.f, 0.f};
      if (g < K) weights(g, x);
      if constexpr (kW) {
        if (g + 8 < K) weights(g + 8, y);
      }
      const uint32_t af[4] = {pack_bf16(x[0], x[1]), kW ? pack_bf16(y[0], y[1]) : 0u,
                              pack_bf16(x[2], x[3]), kW ? pack_bf16(y[2], y[3]) : 0u};
      // rows past the chunk read as its last row, at weight 0
      const int row = min(e0 + 8 * ((lane >> 3) & 1) + (lane & 7), nc - 1);
      const uint32_t at = smem_addr(v_tile + row * kRowPitch + 16 * (lane >> 4));
#pragma unroll
      for (int qd = 0; qd < 4; ++qd) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, at + 32 * qd);
        mma_bf16(acc[2 * qd], af, bv[0], bv[1]);
        mma_bf16(acc[2 * qd + 1], af, bv[2], bv[3]);
      }
    }
  }
  __syncthreads();  // every weight read: the partial sums take their place
  if constexpr (kF32) {
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      if (k < K) {
        *reinterpret_cast<float2*>(part + (warp * K + k) * kHeadDim + 2 * lane) =
            make_float2(accf[k][0], accf[k][1]);
      }
    }
  } else {
    if (g < K) {
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        *reinterpret_cast<float2*>(part + (warp * K + g) * kHeadDim + 8 * nb + 2 * c) =
            make_float2(acc[nb][0], acc[nb][1]);
      }
    }
    if constexpr (kW) {
      if (g + 8 < K) {
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          *reinterpret_cast<float2*>(part + (warp * K + g + 8) * kHeadDim + 8 * nb + 2 * c) =
              make_float2(acc[nb][2], acc[nb][3]);
        }
      }
    }
  }
  __syncthreads();
  auto finish = [&](int beam, float ws, float2 v, size_t at) {
    float ax = 0.f, ay = 0.f;
#pragma unroll
    for (int u = 0; u < kWarps; ++u) {
      const float2 p = *reinterpret_cast<const float2*>(part + (u * K + beam) * kHeadDim +
                                                        2 * lane);
      ax += p.x;
      ay += p.y;
    }
    ax = fmaf(ws, v.x, ax);
    ay = fmaf(ws, v.y, ay);
    store_out(static_cast<Q*>(a.out) + at, ax, ay);
  };
  if (warp < K) finish(warp, w_step, vs, qrow);
  if constexpr (kW) {
    if (warp + 8 < K) finish(warp + 8, w_step8, vsb, qrow8);
  }
}

template <typename T, typename Q, int KT>
int launch_beams(const Args& a, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes(KT == kWide ? a.beams : KT, a.positions, a.compact, a.stage,
                                 a.shared, std::is_same<T, int8_t>::value,
                                 std::is_same<T, float>::value);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = blocked_kernel<T, Q, KT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(a.heads, batch), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// 1-8 beams an instance each; 9-16 the kWide instance, whose list keeps a
// row's position in 12 bits (positions < 4096: the scores of 9 beams fit
// 717 at most).
template <typename T, typename Q>
int launch(const Args& a, int batch, int beams, int head_dim, cudaStream_t stream) {
  if (head_dim != kHeadDim || beams < 1 || beams > kWide || beams != a.beams ||
      a.positions < 0 || a.positions > a.t_max || a.heads < 1 || batch < 1 || batch > 65535 ||
      a.stage < 1 || a.stage > kThreads ||
      static_cast<int64_t>(beams) * a.t_max >= (1 << 24) ||
      (beams > 8 && a.compact && a.positions >= 4096)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (beams) {
    case 1: return launch_beams<T, Q, 1>(a, batch, stream);
    case 2: return launch_beams<T, Q, 2>(a, batch, stream);
    case 3: return launch_beams<T, Q, 3>(a, batch, stream);
    case 4: return launch_beams<T, Q, 4>(a, batch, stream);
    case 5: return launch_beams<T, Q, 5>(a, batch, stream);
    case 6: return launch_beams<T, Q, 6>(a, batch, stream);
    case 7: return launch_beams<T, Q, 7>(a, batch, stream);
    case 8: return launch_beams<T, Q, 8>(a, batch, stream);
    default: return launch_beams<T, Q, kWide>(a, batch, stream);
  }
}

}  // namespace blocked
}  // namespace

// compact: 1 to walk the list of admitted rows, 0 every row; stage: the
// rows a chunk copies into shared memory; shared: 1 where K's and V's
// chunks take turns in one buffer (ops/lazy_attention.py::blocked_layout
// gives all three).
extern "C" int mic_lazy_attention_blocked_bf16(void* q, void* cache_k, void* cache_v, void* k_step,
                                               void* v_step, void* amask, void* out, int batch,
                                               int beams, int t_max, int positions, int heads,
                                               int head_dim, int compact, int stage, int shared,
                                               void* stream) {
  const blocked::Args a{q, cache_k, cache_v, nullptr, nullptr, k_step, v_step,
                        static_cast<const int8_t*>(amask), out,
                        t_max, positions, heads, compact, stage, shared, beams};
  return blocked::launch<__nv_bfloat16, __nv_bfloat16>(a, batch, beams, head_dim,
                                                       static_cast<cudaStream_t>(stream));
}

// The float32 cache with float32 q, step rows and output (a float32 model).
extern "C" int mic_lazy_attention_blocked_f32(void* q, void* cache_k, void* cache_v, void* k_step,
                                              void* v_step, void* amask, void* out, int batch,
                                              int beams, int t_max, int positions, int heads,
                                              int head_dim, int compact, int stage, int shared,
                                              void* stream) {
  const blocked::Args a{q, cache_k, cache_v, nullptr, nullptr, k_step, v_step,
                        static_cast<const int8_t*>(amask), out,
                        t_max, positions, heads, compact, stage, shared, beams};
  return blocked::launch<float, float>(a, batch, beams, head_dim,
                                       static_cast<cudaStream_t>(stream));
}

namespace {

template <typename Q>
int launch_blocked_q8(void* q, void* cache_k, void* k_scale, void* cache_v, void* v_scale,
                      void* k_step, void* v_step, void* amask, void* out, int batch, int beams,
                      int t_max, int positions, int heads, int head_dim, int compact, int stage,
                      int shared, void* stream) {
  const blocked::Args a{q, cache_k, cache_v, static_cast<const float*>(k_scale),
                        static_cast<const float*>(v_scale), k_step, v_step,
                        static_cast<const int8_t*>(amask), out,
                        t_max, positions, heads, compact, stage, shared, beams};
  return blocked::launch<int8_t, Q>(a, batch, beams, head_dim, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int mic_lazy_attention_blocked_q8(void* q, void* cache_k, void* k_scale, void* cache_v,
                                             void* v_scale, void* k_step, void* v_step,
                                             void* amask, void* out, int batch, int beams,
                                             int t_max, int positions, int heads, int head_dim,
                                             int compact, int stage, int shared, void* stream) {
  return launch_blocked_q8<__nv_bfloat16>(q, cache_k, k_scale, cache_v, v_scale, k_step, v_step,
                                          amask, out, batch, beams, t_max, positions, heads,
                                          head_dim, compact, stage, shared, stream);
}

// The per-head int8 cache under float32 q, step rows and output.
extern "C" int mic_lazy_attention_blocked_q8_f32(void* q, void* cache_k, void* k_scale,
                                                 void* cache_v, void* v_scale, void* k_step,
                                                 void* v_step, void* amask, void* out, int batch,
                                                 int beams, int t_max, int positions, int heads,
                                                 int head_dim, int compact, int stage, int shared,
                                                 void* stream) {
  return launch_blocked_q8<float>(q, cache_k, k_scale, cache_v, v_scale, k_step, v_step, amask,
                                  out, batch, beams, t_max, positions, heads, head_dim, compact,
                                  stage, shared, stream);
}
