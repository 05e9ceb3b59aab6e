// Full-softmax attention for short sequences, forward and backward.
//
// Replaces mic_tpu/ops/small_attention.py::small_t_attention (its
// _fwd_kernel and _bwd_kernel Pallas kernels, MIC_TPU_EXPERIMENTAL=
// small_attn): softmax(q k^T + bias) v for q, k, v (B, T, H, 64) with
// T <= 64, q pre-scaled, and an optional float32 (B, T, T) additive bias
// shared by an image's heads (0 or finfo(float32).min, built by the wrapper
// with mic_tpu's key-0 redirect for fully masked rows).
//
//   forward:  s = q k^T + bias (f32), p = softmax(s) (f32), out = round(p) v,
//             round(p) being p rounded to the input type, the product
//             summed in f32 and cast to the input type;
//   backward: recomputes s and p, then dv = round(p)^T do, dp = do v^T,
//             ds = p * (dp - rowsum(dp * p)) with the f32 p, dq = ds k,
//             dk = ds^T q, all in f32, cast to the input type.
//
// Keys at or past T are masked here (the TPU wrapper padded T to a
// multiple of 8 and masked the padding; nothing is padded on the card).
//
// Bound: bytes.  The forward reads q, k, v and the bias and writes the
// output once (34.6 MB in bf16 at the decoder's B=64, T=64, H=16: 0.0103 ms
// at 3.35 TB/s), the backward reads q, k, v, do and the bias and writes
// dq, dk, dv (59.8 MB: 0.0178 ms), against about 1 GFLOP a launch.  The TPU
// kernel packed two images a 128-lane MXU tile for Mosaic; here one block
// owns one (image, head), 1,024 blocks at the flagship decoder.  It reads
// the (T, 64) slices of the natural layout with row stride H * 64, so no
// operand is transposed in device memory (the reason the TPU kernel exists).
//
// The bf16 forward (attention_mma.cuh): 128 threads copy q, k and v into
// bf16 tiles with cp.async (27 KB of shared memory a block), each warp
// forms its 16 rows' scores with mma.sync on the tensor cores (every
// product of two bf16 values is exact in f32, so the numbers are the TPU
// kernel's up to the order of the f32 sums), the bias already in the
// accumulators, takes the softmax in registers, rounds p to bf16 in the A
// fragment of P V (mma.sync again, V by ldmatrix.trans) and writes its rows
// through its own rows of the q tile.  Rows past T are zero and are not
// written.
//
// The bf16 backward (attention_mma.cuh too): q, k, v and do arrive the same
// way (46 KB of shared memory with a fifth tile: four blocks an SM).  Each
// warp first takes its 16 query rows: the scores, the f32 softmax, dP = do
// v^T on mma.sync, dS = p (dP - rowsum(dP p)) in f32 registers, and dq = dS
// k with dS as the A operand.  dS must stay f32 (the reference multiplies
// the f32 dS; one bf16 rounding of it is a different result), so it goes in
// as bf16 hi + lo, hi = bf16(dS) and lo = bf16(dS - hi), two products on the
// same k fragments, each exact in f32: what is left of dS is about 2^-17 of
// it.  dv = round(P)^T do and dk = dS^T q need the transposes: after a
// barrier (no warp reads k or v any more) each warp puts its rows of
// round(P) into v's tile and dS's hi and lo into k's and the fifth, and,
// after another, takes its 16 key rows, their A fragments read back with
// ldmatrix.trans.  round(P), do, v, k and q are bf16 already, so every
// product is exact and the outputs differ from the plain version's only
// by the order of f32 sums (and dS's 2^-17).  Rows past T have do = 0, so
// their dS is 0; keys past T have p = 0.
//
// The f32 forward and backward keep every operand, the scores and P in
// shared memory as f32 tiles (attention_tile.cuh) and form each product
// with f32 FMAs, 4 x 4 entries a thread; the row softmaxes are warp
// reductions.  One block owns its (image, head), so the backwards need no
// atomics and reruns are bit-equal.  The f32 forward takes 4 tiles (65 KB:
// three blocks an SM), the f32 backward 6 (98 KB: two).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_mma.cuh"
#include "attention_tile.cuh"

namespace {

using namespace attn_tile;

// s = Q K^T (+ bias) into tile `sp`; keys at or past t are -inf.
__device__ void scores(float* sp, const float* sq, const float* sk, const float* bias, int t) {
  float acc[4][4];
  zero(acc);
  mma_tile(acc, sq, kLd, 1, sk, 1, kLd, kDim);
  const int ty = tile_y(), tx = tile_x();
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx + 16 * c;
      float s = acc[r][c];
      if (j >= t) {
        s = -INFINITY;
      } else if (bias != nullptr && i < t) {
        s += bias[i * t + j];
      }
      acc[r][c] = s;
    }
  }
  put_tile(sp, acc);
}

// each row of tile `sp` to its softmax in place, one warp a row: the max,
// exp(s - max), their sum, then e / sum (f32; -inf entries give 0)
__device__ void softmax_rows(float* sp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < kDim; i += kThreads / 32) {
    float* row = sp + i * kLd;
    const float a = row[lane], b = row[lane + 32];
    float m = fmaxf(a, b);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float ea = expf(a - m), eb = expf(b - m);
    float sum = ea + eb;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    row[lane] = ea / sum;
    row[lane + 32] = eb / sum;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
small_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const float* __restrict__ bias,
                           T* __restrict__ out, int t, int heads) {
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kTileFloats;
  float* sv = sk + kTileFloats;
  float* sp = sv + kTileFloats;
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t stride = static_cast<size_t>(heads) * kDim;
  const size_t base = static_cast<size_t>(b) * t * stride + static_cast<size_t>(h) * kDim;
  const float* brow = bias == nullptr ? nullptr : bias + static_cast<size_t>(b) * t * t;

  load_rows(sq, q + base, t, stride);
  load_rows(sk, k + base, t, stride);
  load_rows(sv, v + base, t, stride);
  __syncthreads();
  scores(sp, sq, sk, brow, t);
  __syncthreads();
  softmax_rows(sp);
  __syncthreads();
  for (int idx = threadIdx.x; idx < kDim * kDim; idx += kThreads) {
    float* x = sp + (idx >> 6) * kLd + (idx & (kDim - 1));
    *x = round_to<T>(*x);
  }
  __syncthreads();
  float acc[4][4];
  zero(acc);
  mma_tile(acc, sp, kLd, 1, sv, kLd, 1, t);  // round(P) V over the t keys
  put_tile(sq, acc);                         // sq was last read before a barrier
  __syncthreads();
  store_rows(out + base, sq, t, stride);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
small_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const float* __restrict__ bias,
                           const T* __restrict__ dout, T* __restrict__ dq, T* __restrict__ dk,
                           T* __restrict__ dv, int t, int heads) {
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kTileFloats;
  float* sv = sk + kTileFloats;
  float* sdo = sv + kTileFloats;
  float* sp = sdo + kTileFloats;
  float* sx = sp + kTileFloats;
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t stride = static_cast<size_t>(heads) * kDim;
  const size_t base = static_cast<size_t>(b) * t * stride + static_cast<size_t>(h) * kDim;
  const float* brow = bias == nullptr ? nullptr : bias + static_cast<size_t>(b) * t * t;
  const int ty = tile_y(), tx = tile_x();

  load_rows(sq, q + base, t, stride);
  load_rows(sk, k + base, t, stride);
  load_rows(sv, v + base, t, stride);
  load_rows(sdo, dout + base, t, stride);
  __syncthreads();
  scores(sp, sq, sk, brow, t);
  __syncthreads();
  softmax_rows(sp);  // the f32 P
  __syncthreads();
  for (int idx = threadIdx.x; idx < kDim * kDim; idx += kThreads) {
    const int off = (idx >> 6) * kLd + (idx & (kDim - 1));
    sx[off] = round_to<T>(sp[off]);
  }
  __syncthreads();

  // dV = round(P)^T dO over the t query rows (dO rows past t are zero)
  float gv[4][4];
  zero(gv);
  mma_tile(gv, sx, 1, kLd, sdo, kLd, 1, t);
  // dP = dO V^T, then dS = P (dP - rowsum(dP P)); rows past t have dO = 0,
  // keys past t P = 0, so dS is zero outside the t x t block
  float ds[4][4];
  zero(ds);
  mma_tile(ds, sdo, kLd, 1, sv, 1, kLd, kDim);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float* prow = sp + (ty + 16 * r) * kLd;
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) part += ds[r][c] * prow[tx + 16 * c];
    const float rowsum = half_warp_sum(part);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float p = prow[tx + 16 * c];
      ds[r][c] = p * (ds[r][c] - rowsum);
    }
  }
  __syncthreads();  // every read of round(P) in sx is done
  put_tile(sx, ds);
  __syncthreads();

  // dQ = dS K over the t keys; dK = dS^T Q over the t query rows
  float gq[4][4], gk[4][4];
  zero(gq);
  zero(gk);
  mma_tile(gq, sx, kLd, 1, sk, kLd, 1, t);
  mma_tile(gk, sx, 1, kLd, sq, kLd, 1, t);
  __syncthreads();  // sp, sv and sdo are read no more
  put_tile(sp, gq);
  put_tile(sdo, gk);
  put_tile(sv, gv);
  __syncthreads();
  store_rows(dq + base, sp, t, stride);
  store_rows(dk + base, sdo, t, stride);
  store_rows(dv + base, sv, t, stride);
}

// The warp's 16 rows of scores (attention_mma.cuh's layout) to their
// softmax in place: p = e / sum(e), e = exp(s - max), per row in f32.
__device__ __forceinline__ void softmax_in_registers(float (&s)[8][4]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float m = attn_mma::row_max(s, hh);
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][2 * hh + e] = expf(s[n][2 * hh + e] - m);
        sum += s[n][2 * hh + e];
      }
    }
    sum = attn_mma::quad_sum(sum);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) s[n][2 * hh + e] = s[n][2 * hh + e] / sum;
    }
  }
}

// The bf16 forward: one block of four warps per (image, head).
__global__ void __launch_bounds__(attn_mma::kThreads, 4)
small_attention_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                                int t, int heads) {
  namespace mm = attn_mma;
  __shared__ __align__(128) unsigned char smem[3 * mm::kTileBytes];
  const uint32_t sq = mm::smem_addr(smem), sk = sq + mm::kTileBytes, sv = sk + mm::kTileBytes;
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t stride = static_cast<size_t>(heads) * kDim;
  const size_t base = static_cast<size_t>(b) * t * stride + static_cast<size_t>(h) * kDim;
  mm::load_tile(sq, q + base, t, stride);
  mm::load_tile(sk, k + base, t, stride);
  mm::load_tile(sv, v + base, t, stride);
  mm::cp_async_commit();

  // the bias of the thread's rows g and g + 8 into the accumulators while
  // the copies fly (none for rows past t)
  const int warp = mm::warp_id(), r0 = warp * 16 + (mm::lane_id() >> 2), r1 = r0 + 8;
  const float* brow = bias == nullptr ? nullptr : bias + static_cast<size_t>(b) * t * t;
  float s[8][4];
  mm::init_scores(s, brow != nullptr && r0 < t ? brow + r0 * t : nullptr,
                  brow != nullptr && r1 < t ? brow + r1 * t : nullptr, t);
  mm::cp_async_wait<0>();
  __syncthreads();
  if (warp * 16 >= t) return;  // no valid row; nothing else waits on this warp

  mm::qk(s, sq, sk);
  mm::mask_keys(s, t, -INFINITY);
  softmax_in_registers(s);
  uint32_t pa[1][4][4];
  mm::p_fragments(s, pa);  // round(P)
  float o[8][4] = {};
  mm::pv(o, pa, sv);  // round(P) V: keys past t have p = 0 and zero rows of v
  mm::store_rows(out + base, stride, t, o, 1.f, 1.f, smem);
}

// The bf16 backward: one block of four warps per (image, head); tiles q,
// k, v, do and a fifth (x), 46,080 bytes.
__global__ void __launch_bounds__(attn_mma::kThreads, 4)
small_attention_bwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                const float* __restrict__ bias,
                                const __nv_bfloat16* __restrict__ dout,
                                __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                                __nv_bfloat16* __restrict__ dv, int t, int heads) {
  namespace mm = attn_mma;
  constexpr int kTile = mm::kTileBytes;
  __shared__ __align__(128) unsigned char smem[5 * kTile];
  const uint32_t sq = mm::smem_addr(smem), sk = sq + kTile, sv = sk + kTile, sdo = sv + kTile,
                 sx = sdo + kTile;
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t stride = static_cast<size_t>(heads) * kDim;
  const size_t base = static_cast<size_t>(b) * t * stride + static_cast<size_t>(h) * kDim;
  mm::load_tile(sq, q + base, t, stride);
  mm::load_tile(sk, k + base, t, stride);
  mm::load_tile(sv, v + base, t, stride);
  mm::load_tile(sdo, dout + base, t, stride);
  mm::cp_async_commit();

  const int warp = mm::warp_id(), lane = mm::lane_id();
  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8;
  const bool live = warp * 16 < t;  // the warp owns a valid query row and key row
  const float* brow = bias == nullptr ? nullptr : bias + static_cast<size_t>(b) * t * t;
  float s[8][4];
  mm::init_scores(s, brow != nullptr && r0 < t ? brow + r0 * t : nullptr,
                  brow != nullptr && r1 < t ? brow + r1 * t : nullptr, t);
  mm::cp_async_wait<0>();
  __syncthreads();

  // The warp's 16 query rows: p, round(P), dS (hi + lo) and dq = dS k.
  uint32_t pa[1][4][4] = {}, dsa[2][4][4] = {};
  float gq[8][4] = {};
  if (live) {
    mm::qk(s, sq, sk);
    mm::mask_keys(s, t, -INFINITY);
    softmax_in_registers(s);  // the f32 P
    mm::p_fragments(s, pa);   // round(P)
    float dp[8][4] = {};
    mm::qk(dp, sdo, sv);      // dP = do v^T
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float part = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) part += dp[n][2 * hh + e] * s[n][2 * hh + e];
      }
      const float rowsum = mm::quad_sum(part);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          dp[n][2 * hh + e] = s[n][2 * hh + e] * (dp[n][2 * hh + e] - rowsum);
        }
      }
    }
    mm::p_fragments(dp, dsa);  // dS as bf16 hi + lo
    mm::pv(gq, dsa, sk);       // dq = dS k over the keys (keys past t: dS = 0)
  }
  __syncthreads();  // no warp reads k or v any more
  // dq out through the warp's own rows of x; then its rows of round(P) into
  // v's tile, dS hi into k's and dS lo into x
  mm::store_rows(dq + base, stride, t, gq, 1.f, 1.f, smem + 4 * kTile);
  __syncwarp();
  mm::put_fragments(smem + 2 * kTile, pa[0]);
  mm::put_fragments(smem + kTile, dsa[0]);
  mm::put_fragments(smem + 4 * kTile, dsa[1]);
  __syncthreads();

  // The warp's 16 key rows: dv = round(P)^T do and dk = dS^T q over the
  // query rows (rows past t: do = 0 and dS = 0).
  float gv[8][4] = {}, gk[8][4] = {};
  if (live) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ap[4], hi[4], lo[4];
      mm::load_transposed(ap, sv, warp * 16, 16 * kk);
      mm::load_transposed(hi, sk, warp * 16, 16 * kk);
      mm::load_transposed(lo, sx, warp * 16, 16 * kk);
      const uint32_t row = (16 * kk + (lane & 15)) * mm::kPitchBytes + (lane >> 4) * 16;
#pragma unroll
      for (int pair = 0; pair < 4; ++pair) {
        uint32_t bd[4], bq[4];
        mm::ldmatrix_x4_trans(bd, sdo + row + pair * 32);  // dims 16 pair .. 16 pair + 15
        mm::ldmatrix_x4_trans(bq, sq + row + pair * 32);
        mm::mma_bf16(gv[2 * pair], ap, bd[0], bd[1]);
        mm::mma_bf16(gv[2 * pair + 1], ap, bd[2], bd[3]);
        mm::mma_bf16(gk[2 * pair], hi, bq[0], bq[1]);
        mm::mma_bf16(gk[2 * pair + 1], hi, bq[2], bq[3]);
        mm::mma_bf16(gk[2 * pair], lo, bq[0], bq[1]);
        mm::mma_bf16(gk[2 * pair + 1], lo, bq[2], bq[3]);
      }
    }
  }
  __syncthreads();  // every read of the tiles is done
  mm::store_rows(dv + base, stride, t, gv, 1.f, 1.f, smem + 2 * kTile);
  mm::store_rows(dk + base, stride, t, gk, 1.f, 1.f, smem + kTile);
}

bool bad_shape(int batch, int t, int heads, int head_dim) {
  return batch < 1 || heads < 1 || t < 1 || t > kDim || head_dim != kDim;
}

int launch_fwd_f32(void* q, void* k, void* v, void* bias, void* out, int batch, int t,
                   int heads, int head_dim, void* stream) {
  if (bad_shape(batch, t, heads, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = 4 * kTileBytes;
  static bool done[64] = {};
  cudaError_t err = allow_shared(small_attention_fwd_kernel<float>, smem, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  small_attention_fwd_kernel<float><<<batch * heads, kThreads, smem,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(bias), static_cast<float*>(out), t, heads);
  return static_cast<int>(cudaGetLastError());
}

int launch_fwd_bf16(void* q, void* k, void* v, void* bias, void* out, int batch, int t,
                    int heads, int head_dim, void* stream) {
  if (bad_shape(batch, t, heads, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  small_attention_fwd_bf16_kernel<<<batch * heads, attn_mma::kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<bf16*>(out), t, heads);
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd_f32(void* q, void* k, void* v, void* bias, void* dout, void* dq, void* dk,
                   void* dv, int batch, int t, int heads, int head_dim, void* stream) {
  if (bad_shape(batch, t, heads, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = 6 * kTileBytes;
  static bool done[64] = {};
  cudaError_t err = allow_shared(small_attention_bwd_kernel<float>, smem, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  small_attention_bwd_kernel<float><<<batch * heads, kThreads, smem,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(bias), static_cast<const float*>(dout), static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), t, heads);
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd_bf16(void* q, void* k, void* v, void* bias, void* dout, void* dq, void* dk,
                    void* dv, int batch, int t, int heads, int head_dim, void* stream) {
  if (bad_shape(batch, t, heads, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  small_attention_bwd_bf16_kernel<<<batch * heads, attn_mma::kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<const bf16*>(dout), static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), t, heads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mic_small_attention_fwd_bf16(void* q, void* k, void* v, void* bias, void* out,
                                            int batch, int t, int heads, int head_dim,
                                            void* stream) {
  return launch_fwd_bf16(q, k, v, bias, out, batch, t, heads, head_dim, stream);
}

extern "C" int mic_small_attention_fwd_f32(void* q, void* k, void* v, void* bias, void* out,
                                           int batch, int t, int heads, int head_dim,
                                           void* stream) {
  return launch_fwd_f32(q, k, v, bias, out, batch, t, heads, head_dim, stream);
}

extern "C" int mic_small_attention_bwd_bf16(void* q, void* k, void* v, void* bias, void* dout,
                                            void* dq, void* dk, void* dv, int batch, int t,
                                            int heads, int head_dim, void* stream) {
  return launch_bwd_bf16(q, k, v, bias, dout, dq, dk, dv, batch, t, heads, head_dim, stream);
}

extern "C" int mic_small_attention_bwd_f32(void* q, void* k, void* v, void* bias, void* dout,
                                           void* dq, void* dk, void* dv, int batch, int t,
                                           int heads, int head_dim, void* stream) {
  return launch_bwd_f32(q, k, v, bias, dout, dq, dk, dv, batch, t, heads, head_dim, stream);
}
