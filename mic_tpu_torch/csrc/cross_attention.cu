// Beam-grouped cross-attention of one decoder layer at one decode step.
//
// Replaces mic_tpu/ops/cross_attention.py:
//   - fused_cross_attention, the bf16 _kernel_bf16 and the int8 _kernel_q8
//     (a quantized cross cache, int8 rows with an f32 scale per (image,
//     position, head));
//   - fused_cross_attention_dma (_kernel_cross_dma): the merged
//     (B, S_pad, H*Dh) bf16 cache, the encoder axis padded with zero rows
//     to a multiple of 16, rows at or past real_s dead.
// An image's K beams share its encoder K/V, read-only:
//
//   out[b, k, h] = bf16( softmax(q[b,k,h] . K[b,:,h] * ks) * vs rounded to bf16 @ V[b,:,h] )
//
// the arithmetic of _attend_tiles with no step rows (ks = vs = 1 in bf16).
// The TPU kernel masks the padded rows to finfo(float32).min, so each
// weighs exp(...) == 0 exactly; here they are never read (positions =
// real_s, the row stride t_max = S_pad), which gives the same result.
//
// Bound: bytes, each image's live K and V rows read once (52 MB a layer at
// B=256, S=50, H*Dh=1024 in bf16; half that, plus the scales, in int8;
// twice it in a float32 model's f32, whose instances take f32 q and output).
// Design: attend_rows.cuh, one block per (head, image) that
// requests its q, K and V tiles at once and runs both products on the
// tensor cores.  The TPU kernel's double-buffered DMA groups existed to
// keep its sequential grid fed; thousands of blocks in flight, each with
// its whole tiles requested, need no such scheme (a persistent grid whose
// blocks prefetch their next item measured slower, PERF.md §6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attend_rows.cuh"

extern "C" int mic_cross_attention_bf16(void* q, void* enc_k, void* enc_v, void* out, int batch,
                                        int beams, int enc_len, int heads, int head_dim,
                                        void* stream) {
  attend::Args a{q, enc_k, enc_v, nullptr, nullptr, out, batch, beams, enc_len, enc_len, heads,
                 16, {}};
  return attend::launch<__nv_bfloat16, __nv_bfloat16>(a, head_dim,
                                                      static_cast<cudaStream_t>(stream));
}

// A float32 model's: float32 q, encoder K/V and output.
extern "C" int mic_cross_attention_f32(void* q, void* enc_k, void* enc_v, void* out, int batch,
                                       int beams, int enc_len, int heads, int head_dim,
                                       void* stream) {
  attend::Args a{q, enc_k, enc_v, nullptr, nullptr, out, batch, beams, enc_len, enc_len, heads,
                 16, {}};
  return attend::launch<float, float>(a, head_dim, static_cast<cudaStream_t>(stream));
}

extern "C" int mic_cross_attention_q8(void* q, void* enc_k, void* k_scale, void* enc_v,
                                      void* v_scale, void* out, int batch, int beams, int enc_len,
                                      int heads, int head_dim, void* stream) {
  attend::Args a{q, enc_k, enc_v, static_cast<const float*>(k_scale),
                 static_cast<const float*>(v_scale), out, batch, beams, enc_len, enc_len, heads,
                 16, {}};
  return attend::launch<int8_t, __nv_bfloat16>(a, head_dim, static_cast<cudaStream_t>(stream));
}

// The int8 cross cache under float32 q and output.
extern "C" int mic_cross_attention_q8_f32(void* q, void* enc_k, void* k_scale, void* enc_v,
                                          void* v_scale, void* out, int batch, int beams,
                                          int enc_len, int heads, int head_dim, void* stream) {
  attend::Args a{q, enc_k, enc_v, static_cast<const float*>(k_scale),
                 static_cast<const float*>(v_scale), out, batch, beams, enc_len, enc_len, heads,
                 16, {}};
  return attend::launch<int8_t, float>(a, head_dim, static_cast<cudaStream_t>(stream));
}

extern "C" int mic_cross_attention_dma_bf16(void* q, void* enc_k, void* enc_v, void* out,
                                            int batch, int beams, int s_pad, int real_s, int heads,
                                            int head_dim, void* stream) {
  if (real_s < 1) return static_cast<int>(cudaErrorInvalidValue);
  attend::Args a{q, enc_k, enc_v, nullptr, nullptr, out, batch, beams, s_pad, real_s, heads, 16,
                 {}};
  return attend::launch<__nv_bfloat16, __nv_bfloat16>(a, head_dim,
                                                      static_cast<cudaStream_t>(stream));
}

// The merged padded cache of a float32 model.
extern "C" int mic_cross_attention_dma_f32(void* q, void* enc_k, void* enc_v, void* out,
                                           int batch, int beams, int s_pad, int real_s, int heads,
                                           int head_dim, void* stream) {
  if (real_s < 1) return static_cast<int>(cudaErrorInvalidValue);
  attend::Args a{q, enc_k, enc_v, nullptr, nullptr, out, batch, beams, s_pad, real_s, heads, 16,
                 {}};
  return attend::launch<float, float>(a, head_dim, static_cast<cudaStream_t>(stream));
}
