// Online-softmax ("flash") attention, forward.
//
// Replaces mic_tpu/ops/flash_attention.py::flash_attention (its _kernel
// Pallas kernel; Captioner(attn_impl="pallas")): softmax(q k^T + bias) v for
// q (B, Tq, H, 64), k and v (B, Tk, H, 64), q pre-scaled, in bf16 or f32,
// with an optional float32 (B, Tq, Tk) additive bias of 0 or -1e30 shared by
// an image's heads.  Its arithmetic is the TPU kernel's:
//
//   scores in f32; a running max m (from -1e30), normalizer l and f32
//   accumulator per query row across the key tiles; p = exp(s - m_new),
//   zeroed where s <= -5e29 (a masked key); the f32 p times the f32 v;
//   alpha = exp(m - m_new) rescales l and the accumulator; keys past Tk
//   score -1e30.  out = acc / l, and 0 where l == 0 (a fully masked row).
//
// Any Tq and Tk: the last query and key tiles are ragged and masked here.
// The backward is not a kernel (mic_tpu's _flash_bwd is plain einsums).
//
// Bound: bytes.  q, k, v and the bias read once and the output written
// once (34.6 MB in bf16 at the decoder's B=64, T=64, H=16: 0.0103 ms at
// 3.35 TB/s), against about 1 GFLOP.  The TPU grid walked (B*H, q blocks,
// kv blocks) in order with the running statistics in VMEM scratch; here
// one block owns one (image, head, 64-row query tile) and walks the key
// tiles of 64 itself, with m and l in the registers of the 16 threads that
// share a row set and the 64 x 64 accumulator spread 4 x 4 over 256
// threads (attention_tile.cuh).  q, k and v are read in their natural
// (B, T, H, 64) layout, row stride H * 64, not folded to (B*H, T, 64).  The
// p tile goes through shared memory to the P V product; 4 tiles (65 KB),
// three blocks an SM.  Products are f32 FMAs, as the TPU kernel keeps p in
// f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_tile.cuh"

namespace {

using namespace attn_tile;

constexpr float kNegInf = -1e30f;  // mic_tpu's NEG_INF

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const float* __restrict__ bias,
                           T* __restrict__ out, int tq, int tk, int heads) {
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kTileFloats;
  float* sv = sk + kTileFloats;
  float* sp = sv + kTileFloats;
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int q0 = blockIdx.y * kDim;
  const int rows = min(kDim, tq - q0);
  const size_t stride = static_cast<size_t>(heads) * kDim;
  const size_t q_base = (static_cast<size_t>(b) * tq + q0) * stride + static_cast<size_t>(h) * kDim;
  const size_t kv_base = static_cast<size_t>(b) * tk * stride + static_cast<size_t>(h) * kDim;
  const int ty = tile_y(), tx = tile_x();

  load_rows(sq, q + q_base, rows, stride);
  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  zero(acc);

  for (int k0 = 0; k0 < tk; k0 += kDim) {
    const int keys = min(kDim, tk - k0);
    __syncthreads();  // the last tile's K, V and P are read no more
    load_rows(sk, k + kv_base + static_cast<size_t>(k0) * stride, keys, stride);
    load_rows(sv, v + kv_base + static_cast<size_t>(k0) * stride, keys, stride);
    __syncthreads();
    float s[4][4];
    zero(s);
    mma_tile(s, sq, kLd, 1, sk, 1, kLd, kDim);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
      const float* brow = (bias != nullptr && i < rows)
                              ? bias + (static_cast<size_t>(b) * tq + q0 + i) * tk + k0
                              : nullptr;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        if (j >= keys) {
          s[r][c] = kNegInf;
        } else if (brow != nullptr) {
          s[r][c] += brow[j];
        }
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], half_warp_max(mx));
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = s[r][c] <= kNegInf / 2 ? 0.f : expf(s[r][c] - m_new);
        s[r][c] = p;
        part += p;
      }
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + half_warp_sum(part);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] *= alpha;
    }
    put_tile(sp, s);
    __syncthreads();
    mma_tile(acc, sp, kLd, 1, sv, kLd, 1, keys);  // acc += P V over the tile's keys
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float safe = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] /= safe;
  }
  __syncthreads();  // sk is read no more
  put_tile(sk, acc);
  __syncthreads();
  store_rows(out + q_base, sk, rows, stride);
}

template <typename T>
int launch(void* q, void* k, void* v, void* bias, void* out, int batch, int tq, int tk,
           int heads, int head_dim, void* stream) {
  if (batch < 1 || heads < 1 || tq < 1 || tk < 1 || head_dim != kDim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr size_t smem = 4 * kTileBytes;
  static bool done[64] = {};
  cudaError_t err = allow_shared(flash_attention_fwd_kernel<T>, smem, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch * heads, (tq + kDim - 1) / kDim);
  flash_attention_fwd_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<T*>(out), tq, tk, heads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mic_flash_attention_fwd_bf16(void* q, void* k, void* v, void* bias, void* out,
                                            int batch, int tq, int tk, int heads, int head_dim,
                                            void* stream) {
  return launch<__nv_bfloat16>(q, k, v, bias, out, batch, tq, tk, heads, head_dim, stream);
}

extern "C" int mic_flash_attention_fwd_f32(void* q, void* k, void* v, void* bias, void* out,
                                           int batch, int tq, int tk, int heads, int head_dim,
                                           void* stream) {
  return launch<float>(q, k, v, bias, out, batch, tq, tk, heads, head_dim, stream);
}
