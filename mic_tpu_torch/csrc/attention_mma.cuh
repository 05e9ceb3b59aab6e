// bf16 tensor-core pieces of the full-sequence attention kernels: the bf16
// forwards of small_attention.cu and flash_attention.cu and the small-T
// backward's.  (Their f32 instances stay on attention_tile.cuh.)
//
// A block of 128 threads, four warps, owns 64 query rows of one (image,
// head); warp w owns rows [16 w, 16 w + 16).  q, k and v tiles of 64 rows
// x 64 bf16 arrive in shared memory by 16-byte cp.async copies from their
// natural (B, T, H, 64) layout (row stride H * 64 elements), at a pitch of
// 72 bf16 (144 bytes: the eight rows one ldmatrix phase reads start in
// eight different 4-bank groups, so the reads are free of bank conflicts).
// Rows at or past a tile's valid count are zero-filled, never read: their
// copy has a source size of 0 and an address clamped to the last valid row
// (the last image's rows would run past the end of the tensor).
//
// q k^T and P V are mma.sync.m16n8k16 bf16 products with f32 accumulators.
// A warp's scores, 16 rows x 8 NB keys (NB = 8 for small-T, 4 for flash's
// half-tile steps), stay in registers in the accumulator's layout, 4 NB
// f32 a thread: with g = lane / 4 and c = lane % 4, s[n][e] holds entry
// (g, 8 n + 2 c + e) and s[n][2 + e] entry (g + 8, 8 n + 2 c + e), e in
// {0, 1}; a row's max and sum are shuffles within a quad.  The A operand
// of q k^T comes from ldmatrix on q (read again for each key tile, half
// the dims at a time), the B operand from ldmatrix on k; P's A operand is
// built in registers from the scores (two adjacent 8-key accumulator
// blocks form one 16-key A fragment) and V's B operand comes from
// ldmatrix.trans.  The epilogue
// stages the warp's 16 output rows through its own rows of the q tile
// (only this warp read them) and writes 16-byte row pieces.  The backward
// also needs products over a tile's rows (round(P)^T dO, dS^T Q): it puts
// P's and dS's A fragments into tiles (`put_fragments`) and reads their
// transposes back with ldmatrix.trans (`load_transposed`).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace attn_mma {

constexpr int kDim = 64;                  // head dim; rows and keys of a tile
constexpr int kThreads = 128;             // four warps of 16 query rows
constexpr int kPitch = kDim + 8;          // row pitch of a tile, in bf16
constexpr int kPitchBytes = 2 * kPitch;   // 144
constexpr int kTileBytes = kDim * kPitchBytes;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes (src_bytes 0)
// (the "memory" clobbers keep the compiler from moving other memory
// accesses across the copies and the waits)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// Starts the copy of a tile: rows [0, rows) from `rows` rows of 64 bf16,
// `stride` elements apart; rows [rows, 64) zero.  rows >= 1.  Eight
// neighbouring threads copy one 128-byte row.
__device__ __forceinline__ void load_tile(uint32_t tile, const bf16* src, int rows,
                                          size_t stride) {
#pragma unroll
  for (int j = 0; j < kDim * 8 / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads, r = i >> 3, piece = i & 7;
    const int from = r < rows ? r : rows - 1;
    cp_async16(tile + r * kPitchBytes + piece * 16, src + from * stride + piece * 8,
               r < rows ? 16 : 0);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), d 16 x 8 f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Two floats rounded to bf16 (to nearest even) as one packed pair.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return as_u32(__floats2bfloat162_rn(lo, hi));
}

// Sixteen int8 values (a 16-byte piece of a head row) as sixteen bf16,
// exactly, into 32 bytes of shared memory: each byte b, offset to b ^ 0x80,
// becomes the low mantissa byte of 2^23 in f32, less 2^23 + 128 that is b,
// and the upper half of an f32 integer of at most 8 significant bits is its
// bf16.
__device__ __forceinline__ void store_widened(unsigned char* dst, const uint4& raw) {
  const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u, raw.z ^ 0x80808080u,
                         raw.w ^ 0x80808080u};
  uint32_t out[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t f[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[k] = __float_as_uint(__uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7540 + k)) -
                             8388736.f);
    }
    out[2 * i] = __byte_perm(f[0], f[1], 0x7632);
    out[2 * i + 1] = __byte_perm(f[2], f[3], 0x7632);
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(out[0], out[1], out[2], out[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(out[4], out[5], out[6], out[7]);
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
__device__ __forceinline__ int warp_id() { return threadIdx.x >> 5; }

// The warp's q rows, dims 32 half .. 32 half + 31, as the A operands of
// q k^T: two fragments of 16 dims.
__device__ __forceinline__ void load_q(uint32_t (&qa)[2][4], uint32_t q_tile, int half) {
  const int lane = lane_id();
  const uint32_t row = q_tile + (warp_id() * 16 + (lane & 15)) * kPitchBytes + (lane >> 4) * 16;
  ldmatrix_x4(qa[0], row + half * 64);
  ldmatrix_x4(qa[1], row + half * 64 + 32);
}

// Entries (col, col + 1) of a bias row, 0 at or past `keys` (8-byte loads
// where the row is 8-byte aligned); both 0 for a null row.
__device__ __forceinline__ float2 bias_pair(const float* row, int col, int keys) {
  if (row == nullptr) return make_float2(0.f, 0.f);
  if (col + 1 < keys && (reinterpret_cast<uintptr_t>(row) & 7) == 0) {
    return *reinterpret_cast<const float2*>(row + col);
  }
  return make_float2(col < keys ? row[col] : 0.f, col + 1 < keys ? row[col + 1] : 0.f);
}

// The functions below take NB blocks of 8 keys, s[NB][4] in the layout
// above, `keys` counted from the first of them.

// The scores' accumulators set to the bias of the thread's two rows (null
// for none), so that the products add onto it: s = q k^T + bias in f32.
template <int NB>
__device__ __forceinline__ void init_scores(float (&s)[NB][4], const float* row0,
                                            const float* row1, int keys) {
  const int col = 2 * (lane_id() & 3);
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    const float2 a = bias_pair(row0, 8 * n + col, keys);
    const float2 b = bias_pair(row1, 8 * n + col, keys);
    s[n][0] = a.x;
    s[n][1] = a.y;
    s[n][2] = b.x;
    s[n][3] = b.y;
  }
}

// s += q k^T over the 8 NB key rows from `k_rows` (a tile's row address)
// and the 64 dims, the warp's q rows read from the q tile half the dims at
// a time (8 registers live).
template <int NB>
__device__ __forceinline__ void qk(float (&s)[NB][4], uint32_t q_tile, uint32_t k_rows) {
  const int lane = lane_id();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t qa[2][4];
    load_q(qa, q_tile, half);
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      uint32_t b[4];  // keys 8 n .. 8 n + 7, dims 32 half .. 32 half + 31
      ldmatrix_x4(b, k_rows + (8 * n + (lane & 7)) * kPitchBytes + (lane >> 3) * 16 + half * 64);
      mma_bf16(s[n], qa[0], b[0], b[1]);
      mma_bf16(s[n], qa[1], b[2], b[3]);
    }
  }
}

// Keys at or past `keys` get the score `fill`.
template <int NB>
__device__ __forceinline__ void mask_keys(float (&s)[NB][4], int keys, float fill) {
  if (keys >= 8 * NB) return;
  const int col = 2 * (lane_id() & 3);
#pragma unroll
  for (int n = 0; n < NB; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (8 * n + col + e >= keys) {
        s[n][e] = fill;
        s[n][2 + e] = fill;
      }
    }
  }
}

// The max and the sum over the quad that holds a row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Row h's (h = 0: the thread's row g, h = 1: row g + 8) max over the keys
template <int NB>
__device__ __forceinline__ float row_max(const float (&s)[NB][4], int h) {
  float m = fmaxf(s[0][2 * h], s[0][2 * h + 1]);
#pragma unroll
  for (int n = 1; n < NB; ++n) m = fmaxf(m, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
  return quad_max(m);
}

// P's A fragments for P V from its f32 entries `p` (the scores' layout),
// one fragment per 16 keys (KK = NB / 2).  Parts == 1: p rounded once to
// bf16.  Parts == 2: p carried as bf16 hi + lo, hi = bf16(p) and lo =
// bf16(p - hi), so that two products on the same V fragments, each exact
// in f32, keep p to about 2^-17 of itself.  Packing here, before P V, lets
// p's f32 registers go.
template <int Parts, int NB, int KK>
__device__ __forceinline__ void p_fragments(const float (&p)[NB][4], uint32_t (&pa)[Parts][KK][4]) {
  static_assert(2 * KK == NB, "one fragment per 16 keys");
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // register i: keys 16 kk + 8 (i / 2) + 2 c, +1 of row g + 8 (i % 2)
      const float x = p[2 * kk + (i >> 1)][2 * (i & 1)];
      const float y = p[2 * kk + (i >> 1)][2 * (i & 1) + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
      pa[0][kk][i] = as_u32(hi);
      if (Parts == 2) {
        pa[Parts - 1][kk][i] =
            as_u32(__floats2bfloat162_rn(x - __low2float(hi), y - __high2float(hi)));
      }
    }
  }
}

// o += P V over the 16 KK value rows from `v_rows` (a tile's row address),
// each part of P (p_fragments) times the same V fragments.
template <int Parts, int KK>
__device__ __forceinline__ void pv(float (&o)[8][4], const uint32_t (&pa)[Parts][KK][4],
                                   uint32_t v_rows) {
  const int lane = lane_id();
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const uint32_t row = v_rows + (16 * kk + (lane & 15)) * kPitchBytes + (lane >> 4) * 16;
#pragma unroll
    for (int pair = 0; pair < 4; ++pair) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, row + pair * 32);  // dims 16 pair .. 16 pair + 15
#pragma unroll
      for (int part = 0; part < Parts; ++part) {
        mma_bf16(o[2 * pair], pa[part][kk], b[0], b[1]);
        mma_bf16(o[2 * pair + 1], pa[part][kk], b[2], b[3]);
      }
    }
  }
}

// A warp's A fragments of a 16 x 64 matrix (p_fragments' layout, one part)
// into its own 16 rows of a tile (`tile`, its generic pointer), as bf16.
// The eight rows a store touches start in eight different 4-bank groups,
// so each 4-byte store is free of bank conflicts.
__device__ __forceinline__ void put_fragments(unsigned char* tile, const uint32_t (&a)[4][4]) {
  const int lane = lane_id();
  unsigned char* row = tile + (warp_id() * 16 + (lane >> 2)) * kPitchBytes + 4 * (lane & 3);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<uint32_t*>(row + (i & 1) * 8 * kPitchBytes + (16 * kk + 8 * (i >> 1)) * 2) =
          a[kk][i];
    }
  }
}

// The A fragment of rows m0 .. m0 + 15 of a tile's transpose over depth
// k0 .. k0 + 15: the tile's columns m0 .. m0 + 15 of its rows k0 .. k0 +
// 15, by ldmatrix.trans (the four 8 x 8 blocks in the A fragment's order:
// (m, k), (m + 8, k), (m, k + 8), (m + 8, k + 8)).
__device__ __forceinline__ void load_transposed(uint32_t (&a)[4], uint32_t tile, int m0, int k0) {
  const int lane = lane_id();
  const int row = k0 + (lane & 7) + ((lane >> 4) << 3), col = m0 + (lane & 8);
  ldmatrix_x4_trans(a, tile + row * kPitchBytes + col * 2);
}

// The warp's 16 output rows, o divided by d0 (row g) and d1 (row g + 8) and
// rounded to bf16 once, into the warp's own rows of the q tile (`stage`,
// its generic pointer), then rows [0, rows) of the block's 64 out to `dst`,
// `stride` elements apart, 16 bytes a store.
__device__ __forceinline__ void store_rows(bf16* dst, size_t stride, int rows,
                                           const float (&o)[8][4], float d0, float d1,
                                           unsigned char* stage) {
  const int lane = lane_id(), warp = warp_id();
  bf16* tile = reinterpret_cast<bf16*>(stage + warp * 16 * kPitchBytes);
  bf16* r0 = tile + (lane >> 2) * kPitch + 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(r0 + 8 * n) =
        __floats2bfloat162_rn(o[n][0] / d0, o[n][1] / d0);
    *reinterpret_cast<__nv_bfloat162*>(r0 + 8 * kPitch + 8 * n) =
        __floats2bfloat162_rn(o[n][2] / d1, o[n][3] / d1);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int piece = lane + 32 * i, r = piece >> 3, col = 8 * (piece & 7);
    const int row = warp * 16 + r;
    if (row < rows) {
      *reinterpret_cast<uint4*>(dst + row * stride + col) =
          *reinterpret_cast<const uint4*>(tile + r * kPitch + col);
    }
  }
}

}  // namespace attn_mma
