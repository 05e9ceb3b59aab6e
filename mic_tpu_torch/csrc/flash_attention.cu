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
// tiles of 64 itself.  q, k and v are read in their natural (B, T, H, 64)
// layout, row stride H * 64, not folded to (B*H, T, 64).
//
// The bf16 instance (attention_mma.cuh): 128 threads, four warps of 16
// query rows.  q and the first key tile arrive by cp.async; while tile j
// is multiplied, tile j + 1 is copied into the other half of a two-stage
// ring (45 KB of shared memory a block), its rows past Tk zero-filled
// (0 x NaN would be NaN: the TPU kernel masks them for that reason).  A
// tile is taken as two online-softmax steps of 32 keys (the registers of
// a whole 64-key step spill at four blocks an SM).  q k^T is mma.sync on
// the tensor cores (bf16 products, exact in f32), the bias already in the
// accumulators; m, l and the 16 x 64 accumulator stay in a warp's
// registers.  The TPU kernel keeps p in f32, so p is not rounded to
// bf16 once: P V is two mma.sync on the same V fragments, of hi = bf16(p)
// and lo = bf16(p - hi), each product exact in f32, p carried to about
// 2^-17 of itself.  The f32 instance keeps every operand and the p tile in
// shared memory as f32 tiles (attention_tile.cuh: 4 tiles, 65 KB, three
// blocks an SM), the accumulator spread 4 x 4 over 256 threads, with f32
// FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_mma.cuh"
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

// The bf16 instance: one block of four warps per (image, head, 64 query rows).
__global__ void __launch_bounds__(attn_mma::kThreads, 4)
flash_attention_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                                int tq, int tk, int heads) {
  namespace mm = attn_mma;
  __shared__ __align__(128) unsigned char smem[5 * mm::kTileBytes];
  const uint32_t sq = mm::smem_addr(smem);
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int q0 = blockIdx.y * kDim;
  const int rows = min(kDim, tq - q0);
  const size_t stride = static_cast<size_t>(heads) * kDim;
  const size_t q_base = (static_cast<size_t>(b) * tq + q0) * stride + static_cast<size_t>(h) * kDim;
  const size_t kv_base = static_cast<size_t>(b) * tk * stride + static_cast<size_t>(h) * kDim;
  const __nv_bfloat16 *kb = k + kv_base, *vb = v + kv_base;
  // stage i of the ring: K at sq + (1 + i) tiles, V at sq + (3 + i) tiles
  mm::load_tile(sq, q + q_base, rows, stride);
  mm::load_tile(sq + mm::kTileBytes, kb, min(kDim, tk), stride);
  mm::load_tile(sq + 3 * mm::kTileBytes, vb, min(kDim, tk), stride);
  mm::cp_async_commit();

  // the bias of the block's 64 rows, the thread's rows g and g + 8 of them
  const float* brows = bias == nullptr ? nullptr : bias + (static_cast<size_t>(b) * tq + q0) * tk;
  const int r0 = mm::warp_id() * 16 + (mm::lane_id() >> 2), r1 = r0 + 8;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[8][4] = {};
  const int tiles = (tk + kDim - 1) / kDim;
  for (int j = 0; j < tiles; ++j) {
    const int k0 = j * kDim, keys = min(kDim, tk - k0);
    if (j + 1 < tiles) {
      const int next = (j + 1) & 1, k1 = k0 + kDim;
      mm::load_tile(sq + (1 + next) * mm::kTileBytes, kb + static_cast<size_t>(k1) * stride,
                    min(kDim, tk - k1), stride);
      mm::load_tile(sq + (3 + next) * mm::kTileBytes, vb + static_cast<size_t>(k1) * stride,
                    min(kDim, tk - k1), stride);
      mm::cp_async_commit();
    }
    // The tile in two halves of 32 keys, each one step of the online
    // softmax: a warp holds 16 x 32 scores (16 registers) and P's hi and lo
    // fragments (16), not 32 and 32, so that 128 registers a thread hold
    // four blocks an SM without spilling.  The first half's bias goes into
    // its accumulators while the tile's copies fly.
    const float* bias0 = brows != nullptr && r0 < rows ? brows + r0 * tk + k0 : nullptr;
    const float* bias1 = brows != nullptr && r1 < rows ? brows + r1 * tk + k0 : nullptr;
    float s[4][4];
    mm::init_scores(s, bias0, bias1, keys);
    if (j + 1 < tiles) {
      mm::cp_async_wait<1>();  // tile j (and q) are in
    } else {
      mm::cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int live = keys - 32 * half;
      if (live <= 0) break;  // the ragged last tile's empty half: p = 0, l and o unchanged
      if (half == 1) {
        mm::init_scores(s, bias0 == nullptr ? nullptr : bias0 + 32,
                        bias1 == nullptr ? nullptr : bias1 + 32, live);
      }
      const uint32_t rows_at = (32 * half) * mm::kPitchBytes;
      mm::qk(s, sq, sq + (1 + (j & 1)) * mm::kTileBytes + rows_at);
      mm::mask_keys(s, live, kNegInf);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float m_new = fmaxf(m[hh], mm::row_max(s, hh));
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = s[n][2 * hh + e];
            const float p = x <= kNegInf / 2 ? 0.f : expf(x - m_new);
            s[n][2 * hh + e] = p;
            sum += p;
          }
        }
        const float alpha = expf(m[hh] - m_new);
        l[hh] = l[hh] * alpha + mm::quad_sum(sum);
        m[hh] = m_new;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          o[n][2 * hh] *= alpha;
          o[n][2 * hh + 1] *= alpha;
        }
      }
      uint32_t pa[2][2][4];
      mm::p_fragments(s, pa);  // P as bf16 hi + lo
      mm::pv(o, pa, sq + (3 + (j & 1)) * mm::kTileBytes + rows_at);  // acc += P V
    }
    __syncthreads();  // this stage is read no more before tile j + 2's copies overwrite it
  }
  mm::store_rows(out + q_base, stride, rows, o, l[0] == 0.f ? 1.f : l[0],
                 l[1] == 0.f ? 1.f : l[1], smem);
}

bool bad_shape(int batch, int tq, int tk, int heads, int head_dim) {
  return batch < 1 || heads < 1 || tq < 1 || tk < 1 || head_dim != kDim;
}

int launch_f32(void* q, void* k, void* v, void* bias, void* out, int batch, int tq, int tk,
               int heads, int head_dim, void* stream) {
  if (bad_shape(batch, tq, tk, heads, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = 4 * kTileBytes;
  static bool done[64] = {};
  cudaError_t err = allow_shared(flash_attention_fwd_kernel<float>, smem, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch * heads, (tq + kDim - 1) / kDim);
  flash_attention_fwd_kernel<float><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(bias), static_cast<float*>(out), tq, tk, heads);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(void* q, void* k, void* v, void* bias, void* out, int batch, int tq, int tk,
                int heads, int head_dim, void* stream) {
  if (bad_shape(batch, tq, tk, heads, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  const dim3 grid(batch * heads, (tq + kDim - 1) / kDim);
  flash_attention_fwd_bf16_kernel<<<grid, attn_mma::kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<bf16*>(out), tq, tk, heads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mic_flash_attention_fwd_bf16(void* q, void* k, void* v, void* bias, void* out,
                                            int batch, int tq, int tk, int heads, int head_dim,
                                            void* stream) {
  return launch_bf16(q, k, v, bias, out, batch, tq, tk, heads, head_dim, stream);
}

extern "C" int mic_flash_attention_fwd_f32(void* q, void* k, void* v, void* bias, void* out,
                                           int batch, int tq, int tk, int heads, int head_dim,
                                           void* stream) {
  return launch_f32(q, k, v, bias, out, batch, tq, tk, heads, head_dim, stream);
}
