// The cross-attention kernel (cross_attention.cu): the counterpart of
// mic_tpu/ops/lazy_attention.py::_attend_tiles as the cross-attention TPU
// kernels call it, with the rows below `positions` live and no step rows.
//
// For image b, head h and query beam k, over the rows t < positions of the
// image's (t_max, H*Dh) cache:
//
//   s[k, t] = (q[b,k,h] . K[t,h]) * k_scale[t,h]     (f32; scale 1 in bf16)
//   w = softmax(s) in f32, times v_scale[t,h] (int8), rounded to bf16
//   out[b,k,h] = bf16( sum_t w * V[t,h] )             (f32 sums)
//
// which is _attend_tiles' arithmetic: f32 scores, scales on the scores and
// the weights, weights rounded to bf16 before the V product, one bf16
// rounding of the output.  The TPU kernel's block-diagonal query matrix and
// row fold existed for the MXU and have no counterpart here.  Rows at or
// past `positions` (the merged cache's pad) are never read.
//
// Bound: bytes, each image's live K and V head rows read once (about four
// operations a byte, far below the tensor cores' balance).  But at the main
// path's shapes (S=50, 4 beams) a block's few products are not what takes
// the time: the instructions around them are, so the design keeps those
// few.  One block of four warps per (head, image):
//   1. every 16-byte piece of its q rows (the beams, padded to a multiple of
//      16 with zeros) and of its K and V head tiles (and int8 scales) is
//      requested by cp.async before any arithmetic, K's commit group first,
//      V's second; each thread's pieces are one piece of every few rows, so
//      its addresses step by a constant; rows past `positions` are
//      zero-filled from no address.  int8 rows land in the second half of
//      their 144-byte row and are widened there to bf16, exactly, without
//      I2F (attn_mma::store_widened);
//   2. the scores: mma.sync.m16n8k16, a tile of 16 beams (ldmatrix on q) as
//      A and eight K rows as B, the warps taking 8-row items, f32 scores
//      (times their K scales) into shared memory;
//   3. a warp a beam: the max, exp(s - max), the sum, then in place the
//      weights __fdiv_rn(e, sum) (times their V scales), 0 past `positions`;
//   4. the V product: the weights, rounded to bf16 as they are packed into
//      A, and the V rows (ldmatrix.trans) as B, the warps taking (16 beams,
//      16 dims) items and walking the rows in order, so the sums have one
//      order and reruns are bit-equal; one bf16 rounding of the output.
// Any beam count: the beams go through in tiles of 16.  Where the tiles do
// not fit beside the scores, K's and then V's rows go through in chunks of
// `stage` rows, each V item's sums kept in shared memory between chunks (the
// chain of products goes on from the same f32 values).
// A float32 model's instances: the int8 cache under f32 q and output (q
// rounded to bf16 as it is staged); and float32 K and V (rows 13 and 14
// f32), _attend_tiles on f32 tiles: q rounded to bf16, K and V not rounded,
// every weight rounded to bf16, one bf16 rounding of the output, returned
// in f32.  There the staged rows are 272 bytes (64 f32 and 16 that spread
// the float4 reads) and both products are f32 FMAs on the CUDA cores: at 4
// beams each 4-byte element loaded feeds 8 flops, below the card's ~20
// flops a byte, so the kernel stays bound by its bytes.  Scores: a thread a
// (beam, row), q's reads the same for the warp (a broadcast); the V
// product: a warp a beam, lane l its dims 2 l and 2 l + 1, the rows in
// order.
// The block shape is from measurement (PERF.md §6,
// tools/torch_cross_variants.py): two or four heads a block, or two or
// eight warps, were slower.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_mma.cuh"

namespace {
namespace attend {

using attn_mma::cp_async16;
using attn_mma::cp_async_commit;
using attn_mma::cp_async_wait;
using attn_mma::ldmatrix_x4;
using attn_mma::ldmatrix_x4_trans;
using attn_mma::mma_bf16;
using attn_mma::pack_bf16;
using attn_mma::smem_addr;
using attn_mma::store_widened;

constexpr int kHeadDim = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPitch = 144;  // bytes of a staged row: 64 bf16 and 16 that spread ldmatrix
constexpr int kPitchF32 = 272;  // 64 f32 and 16 that spread the float4 reads
// finfo(float32).min: the mask constant of mic_tpu/ops/lazy_attention.py.
constexpr float kMaskValue = -3.4028234663852886e38f;
constexpr size_t kMaxSmem = 232448;
// floats past a score row's end: eight rows' pairs of a 16-beam tile's A
// fragment then fall in different banks
constexpr int kScorePad = 8;

constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// A block's shared memory, each region 16-aligned: the q tile
// [beams16][pitch], the K and V tiles [stage][pitch] (pitch kPitch, or
// kPitchF32 on a float32 cache), int8: the K and V
// scales [rows16] each, then the f32 scores, then weights,
// [beams][rows16 + kScorePad] and, in chunks, the V items' f32 sums
// [beams16][64].
struct Layout {
  int beams16, rows16, chunks;
  int k_tile, v_tile, scales, scores, partial, total;
};

inline Layout layout(int beams, int positions, int stage, bool q8, int pitch) {
  Layout l{};
  l.beams16 = round16(beams);
  l.rows16 = round16(positions);
  l.chunks = (l.rows16 + stage - 1) / stage;
  const size_t k_tile = static_cast<size_t>(l.beams16) * pitch;
  const size_t v_tile = k_tile + static_cast<size_t>(stage) * pitch;
  const size_t scales = v_tile + static_cast<size_t>(stage) * pitch;
  const size_t scores = scales + (q8 ? 2 * 4 * static_cast<size_t>(l.rows16) : 0);
  const size_t partial = scores + 4 * static_cast<size_t>(beams) * (l.rows16 + kScorePad);
  const size_t total =
      partial + (l.chunks > 1 ? 4 * static_cast<size_t>(l.beams16) * kHeadDim : 0);
  if (total > kMaxSmem) {
    l.total = -1;  // does not fit
    return l;
  }
  l.k_tile = static_cast<int>(k_tile);
  l.v_tile = static_cast<int>(v_tile);
  l.scales = static_cast<int>(scales);
  l.scores = static_cast<int>(scores);
  l.partial = static_cast<int>(partial);
  l.total = static_cast<int>(total);
  return l;
}

struct Args {
  const void* q;         // (B, K, H*Dh), pre-scaled by Dh**-0.5, bf16 or f32
  const void* cache_k;   // (B, t_max, H*Dh) bf16, int8 or f32
  const void* cache_v;
  const float* k_scale;  // (B, t_max, H) f32, int8 caches only
  const float* v_scale;
  void* out;             // (B, K, H*Dh), q's dtype
  int batch, beams, t_max, positions, heads;
  int stage;  // rows a chunk of K or V stages, a multiple of 16
  Layout L;   // of stage, from the host
};

// 4 bytes from global to shared memory, or 4 zero bytes (src_bytes 0)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

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

// One output pair: rounded to bf16 once, stored in q's dtype.
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store_out(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(bf16_round(x), bf16_round(y));
}

// T: the cache's element (bf16, int8, or f32); Q: q's and the output's
// (bf16, or f32 on a float32 model).  64 registers: 8 blocks an SM
template <typename T, typename Q>
__global__ void __launch_bounds__(kThreads, 8) tiles_kernel(const Args a) {
  constexpr bool kQ8 = std::is_same<T, int8_t>::value;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kPieces = kHeadDim * sizeof(T) / 16;  // 16-byte pieces of a head row (8, 4, 16)
  constexpr int kRowPitch = kF32 ? kPitchF32 : kPitch;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout& L = a.L;
  const int stage = a.stage;
  const int beams = a.beams;
  const int positions = a.positions;
  const int beams16 = L.beams16;
  const int rows16 = L.rows16;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g8 = lane >> 2;  // the beam (A and C row) of this lane's fragments, and it + 8
  const int c = lane & 3;
  const int hd = a.heads * kHeadDim;
  const size_t row0 = static_cast<size_t>(b) * a.t_max;  // the image's first cache row
  unsigned char* q_tile = smem;
  unsigned char* k_tile = smem + L.k_tile;
  unsigned char* v_tile = smem + L.v_tile;
  float* k_sc = reinterpret_cast<float*>(smem + L.scales);
  float* v_sc = k_sc + rows16;
  float* scores = reinterpret_cast<float*>(smem + L.scores);
  float* partial = reinterpret_cast<float*>(smem + L.partial);
  const int ss = rows16 + kScorePad;  // the scores' row stride

  // 1. a thread's 16-byte pieces of a tile: one piece of every
  // kThreads / kPieces-th row ([row][piece] over the block's threads); rows
  // [c0, c0 + nc) of K or V into `tile` (rows past `positions` zero, from no
  // address), int8 rows into the second half of their staged row
  const int piece = tid % kPieces;
  auto stage_rows = [&](unsigned char* tile, const void* cache, int c0, int nc) {
    const unsigned char* src = static_cast<const unsigned char*>(cache) +
                               ((row0 + c0) * hd + h * kHeadDim) * sizeof(T) + 16 * piece;
    const size_t row_bytes = static_cast<size_t>(hd) * sizeof(T);
    const uint32_t dst = smem_addr(tile + (kQ8 ? 64 : 0) + 16 * piece);
    for (int r = tid / kPieces; r < nc; r += kThreads / kPieces) {
      const bool live = c0 + r < positions;
      cp_async16(dst + r * kRowPitch, live ? src + r * row_bytes : src, live ? 16 : 0);
    }
    cp_async_commit();
  };
  // int8: a thread a staged row, its four raw pieces read before any is
  // widened over them
  auto widen = [&](unsigned char* tile, int nc) {
    for (int i = tid; i < nc; i += kThreads) {
      unsigned char* row = tile + i * kPitch;
      uint4 raw[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) raw[p] = reinterpret_cast<const uint4*>(row + 64)[p];
#pragma unroll
      for (int p = 0; p < 4; ++p) store_widened(row + 32 * p, raw[p]);
    }
  };

  // q rows [beam][piece] (beams past `beams` zero) and int8 scales with K's
  // group, then V's group where the tiles are whole.  f32 q goes through
  // registers, rounded to bf16: as bf16 rows for the tensor cores, or on a
  // float32 cache as f32 rows of bf16 values
  if constexpr (std::is_same<Q, __nv_bfloat16>::value) {
    const __nv_bfloat16* qsrc = static_cast<const __nv_bfloat16*>(a.q) +
                                static_cast<size_t>(b) * beams * hd + h * kHeadDim +
                                8 * (tid & 7);
    const uint32_t qdst = smem_addr(q_tile + 16 * (tid & 7));
    for (int k = tid >> 3; k < beams16; k += kThreads / 8) {
      const bool live = k < beams;
      cp_async16(qdst + k * kPitch, live ? qsrc + static_cast<size_t>(k) * hd : qsrc,
                 live ? 16 : 0);
    }
  } else {
    const float* qsrc = static_cast<const float*>(a.q) + static_cast<size_t>(b) * beams * hd +
                        h * kHeadDim + 8 * (tid & 7);
    for (int k = tid >> 3; k < beams16; k += kThreads / 8) {
      float v[8] = {};
      if (k < beams) {
        const float4 lo = *reinterpret_cast<const float4*>(qsrc + static_cast<size_t>(k) * hd);
        const float4 hi =
            *reinterpret_cast<const float4*>(qsrc + static_cast<size_t>(k) * hd + 4);
        v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
        v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
      }
      unsigned char* dst = q_tile + k * kRowPitch + (kF32 ? 32 : 16) * (tid & 7);
      if constexpr (kF32) {
        reinterpret_cast<float4*>(dst)[0] =
            make_float4(bf16_round(v[0]), bf16_round(v[1]), bf16_round(v[2]), bf16_round(v[3]));
        reinterpret_cast<float4*>(dst)[1] =
            make_float4(bf16_round(v[4]), bf16_round(v[5]), bf16_round(v[6]), bf16_round(v[7]));
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                                    pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
      }
    }
  }
  if constexpr (kQ8) {
    for (int t = tid; t < rows16; t += kThreads) {
      const bool live = t < positions;
      const size_t at = (row0 + (live ? t : 0)) * a.heads + h;
      cp_async4(smem_addr(k_sc + t), a.k_scale + at, live ? 4 : 0);
      cp_async4(smem_addr(v_sc + t), a.v_scale + at, live ? 4 : 0);
    }
  }
  stage_rows(k_tile, a.cache_k, 0, min(stage, rows16));
  if (L.chunks == 1) stage_rows(v_tile, a.cache_v, 0, rows16);

  // 2. the scores of every beam against each 8-row group holding a live row
  for (int ch = 0; ch < L.chunks; ++ch) {
    const int c0 = ch * stage;
    const int nc = min(stage, rows16 - c0);
    if (ch > 0) {
      __syncthreads();  // every warp is done with the last chunk
      stage_rows(k_tile, a.cache_k, c0, nc);
    }
    if (L.chunks == 1) {
      cp_async_wait<1>();  // q and K; V may be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kQ8) {
      widen(k_tile, nc);
      __syncthreads();
    }
    if constexpr (kF32) {
      // a thread a (beam, row) of the chunk's live rows, beam-major
      const int live = min(nc, positions - c0);
      for (int item = tid; item < beams * live; item += kThreads) {
        const int k = item / live;
        const int r = item - k * live;
        const float* kr = reinterpret_cast<const float*>(k_tile + r * kRowPitch);
        const float* qr = reinterpret_cast<const float*>(q_tile + k * kRowPitch);
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < kHeadDim; d += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(kr + d);
          const float4 qv = *reinterpret_cast<const float4*>(qr + d);
          acc = fmaf(qv.x, kv.x, acc);
          acc = fmaf(qv.y, kv.y, acc);
          acc = fmaf(qv.z, kv.z, acc);
          acc = fmaf(qv.w, kv.w, acc);
        }
        scores[k * ss + c0 + r] = acc;
      }
      continue;
    }
    const int groups8 = (min(nc, positions - c0) + 7) / 8;
    for (int it = warp; it < groups8; it += kWarps) {
      const int r0 = 8 * it;
      const uint32_t kb = smem_addr(k_tile + (r0 + (lane & 7)) * kRowPitch + 16 * (lane >> 3));
      uint32_t lo[4], hi[4];  // the B operands of dims 0-31 and 32-63
      ldmatrix_x4(lo, kb);
      ldmatrix_x4(hi, kb + 64);
      for (int m0 = 0; m0 < beams16; m0 += 16) {
        const uint32_t qa = smem_addr(q_tile + (m0 + (lane & 15)) * kPitch + 16 * (lane >> 4));
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int st = 0; st < 4; ++st) {
          uint32_t af[4];
          ldmatrix_x4(af, qa + 32 * st);
          const uint32_t b0 = st < 2 ? lo[2 * st] : hi[2 * st - 4];
          const uint32_t b1 = st < 2 ? lo[2 * st + 1] : hi[2 * st - 3];
          mma_bf16(d, af, b0, b1);
        }
        // d[2 hf + e]: beam m0 + g8 + 8 hf, row c0 + r0 + 2 c + e
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int k = m0 + g8 + 8 * hf;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int t = c0 + r0 + 2 * c + e;
            if (k < beams && t < positions) {
              const float s = d[2 * hf + e];
              scores[k * ss + t] = kQ8 ? __fmul_rn(s, k_sc[t]) : s;
            }
          }
        }
      }
    }
  }
  __syncthreads();

  // 3-4. a warp a beam: exp(s - max), the sum, then in place the weights
  // e / sum (times their V scales), 0 past `positions`
  for (int row = warp; row < beams; row += kWarps) {
    float* s = scores + row * ss;
    float m = kMaskValue;
    for (int t = lane; t < positions; t += 32) m = fmaxf(m, s[t]);
    m = warp_max(m);
    float l = 0.f;
    for (int t = lane; t < positions; t += 32) {
      const float e = expf(s[t] - m);
      s[t] = e;
      l += e;
    }
    l = warp_sum(l);
    for (int t = lane; t < rows16; t += 32) {
      float w = 0.f;
      if (t < positions) {
        w = __fdiv_rn(s[t], l);
        if (kQ8) w = __fmul_rn(w, v_sc[t]);
      }
      s[t] = w;
    }
  }

  // 5. each chunk of V rows: the weights (rounded to bf16 as A is formed)
  // times the rows
  const int mtiles = beams16 / 16;
  for (int ch = 0; ch < L.chunks; ++ch) {
    const int c0 = ch * stage;
    const int nc = min(stage, rows16 - c0);
    if (L.chunks > 1) {
      __syncthreads();  // every weight, and every warp done with the last chunk
      stage_rows(v_tile, a.cache_v, c0, nc);
    }
    cp_async_wait<0>();
    __syncthreads();  // V's rows, and (whole tiles) every weight
    if constexpr (kQ8) {
      widen(v_tile, nc);
      __syncthreads();
    }
    if constexpr (kF32) {
      // a warp a beam, lane l its dims 2 l and 2 l + 1, the rows in order
      const int live = min(nc, positions - c0);
      for (int k = warp; k < beams; k += kWarps) {
        float2 acc = make_float2(0.f, 0.f);
        float2* part = reinterpret_cast<float2*>(partial + k * kHeadDim + 2 * lane);
        if (ch > 0) acc = *part;
        const float* wk = scores + k * ss + c0;
        for (int r = 0; r < live; ++r) {
          const float w = bf16_round(wk[r]);
          const float2 v2 = *reinterpret_cast<const float2*>(v_tile + r * kRowPitch + 8 * lane);
          acc.x = fmaf(w, v2.x, acc.x);
          acc.y = fmaf(w, v2.y, acc.y);
        }
        if (ch + 1 < L.chunks) {
          *part = acc;
        } else {
          store_out(static_cast<Q*>(a.out) + (static_cast<size_t>(b) * beams + k) * hd +
                        h * kHeadDim + 2 * lane,
                    acc.x, acc.y);
        }
      }
      continue;
    }
    const int groups16 = (min(nc, positions - c0) + 15) / 16;
    for (int it = warp; it < mtiles * 4; it += kWarps) {
      const int qd = it & 3;  // dims 16 qd .. 16 qd + 15
      const int m0 = 16 * (it >> 2);
      float acc[2][4];  // beam m0 + g8 (+ 8 in [2..3])'s dims 16 qd + 8 nb + 2 c (+ 1)
      float* part = partial + (m0 + g8) * kHeadDim + 16 * qd + 2 * c;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float2 v = make_float2(0.f, 0.f);
          if (ch > 0) v = *reinterpret_cast<const float2*>(part + 8 * hf * kHeadDim + 8 * nb);
          acc[nb][2 * hf] = v.x;
          acc[nb][2 * hf + 1] = v.y;
        }
      }
      // beam m0 + g8 (+ 8)'s weights of rows c0 + 16 kg + 2 c (+ 1, + 8, + 9);
      // a pad beam reads the last beam's, and its output row is dropped (each
      // output row of the product reads only its own A row)
      const float* w = scores + min(m0 + g8, beams - 1) * ss + c0 + 2 * c;
      const int w8 = (min(m0 + g8 + 8, beams - 1) - min(m0 + g8, beams - 1)) * ss;
      const uint32_t va = smem_addr(v_tile + (8 * ((lane >> 3) & 1) + (lane & 7)) * kRowPitch +
                                    32 * qd + 16 * (lane >> 4));
      for (int kg = 0; kg < groups16; ++kg) {
        const float* wk = w + 16 * kg;
        const float2 x0 = *reinterpret_cast<const float2*>(wk);
        const float2 x1 = *reinterpret_cast<const float2*>(wk + w8);
        const float2 x2 = *reinterpret_cast<const float2*>(wk + 8);
        const float2 x3 = *reinterpret_cast<const float2*>(wk + w8 + 8);
        const uint32_t af[4] = {pack_bf16(x0.x, x0.y), pack_bf16(x1.x, x1.y),
                                pack_bf16(x2.x, x2.y), pack_bf16(x3.x, x3.y)};
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, va + 16 * kPitch * kg);
        mma_bf16(acc[0], af, bv[0], bv[1]);
        mma_bf16(acc[1], af, bv[2], bv[3]);
      }
      if (ch + 1 < L.chunks) {
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            *reinterpret_cast<float2*>(part + 8 * hf * kHeadDim + 8 * nb) =
                make_float2(acc[nb][2 * hf], acc[nb][2 * hf + 1]);
        continue;
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int k = m0 + g8 + 8 * hf;
        if (k < beams) {
          Q* dst = static_cast<Q*>(a.out) + (static_cast<size_t>(b) * beams + k) * hd +
                   h * kHeadDim + 16 * qd + 2 * c;
#pragma unroll
          for (int nb = 0; nb < 2; ++nb) store_out(dst + 8 * nb, acc[nb][2 * hf], acc[nb][2 * hf + 1]);
        }
      }
    }
  }
}

// Launch on `stream`; returns a cudaError_t.  Whole tiles where they fit (K's
// and V's rows in flight together), else the largest chunk that does.
template <typename T, typename Q>
int launch(Args a, int head_dim, cudaStream_t stream) {
  constexpr bool kQ8 = std::is_same<T, int8_t>::value;
  constexpr int kRowPitch = std::is_same<T, float>::value ? kPitchF32 : kPitch;
  if (head_dim != kHeadDim || a.beams < 1 || a.positions < 1 || a.positions > a.t_max ||
      a.heads < 1 || a.batch < 1 || a.batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.stage = round16(a.positions);
  a.L = layout(a.beams, a.positions, a.stage, kQ8, kRowPitch);
  while (a.L.total < 0 && a.stage > 16) {
    a.stage -= 16;
    a.L = layout(a.beams, a.positions, a.stage, kQ8, kRowPitch);
  }
  if (a.L.total < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = tiles_kernel<T, Q>;
  if (a.L.total > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.L.total);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(a.heads, a.batch), kThreads, a.L.total, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attend
}  // namespace
