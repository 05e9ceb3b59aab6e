// Beam-grouped cross-attention of one decoder layer at one decode step.
//
// Replaces mic_tpu/ops/cross_attention.py::fused_cross_attention (the bf16
// _kernel_bf16; the int8 _kernel_q8 takes a quantized cross cache that
// nothing in mic_tpu builds).  An image's K beams share its encoder K/V,
// (B, S, H, Dh) bf16, read-only, every position live:
//
//   out[b, k, h] = bf16( softmax(q[b,k,h] . K[b,:,h]) rounded to bf16 @ V[b,:,h] )
//
// the arithmetic of _attend_tiles with no mask and no step rows.  S is any
// length (50 at the flagship, CLIP ViT-B/32's 49 patches and its class
// token): nothing is padded.
//
// Bound: bytes, each image's K and V read once (52 MB a layer at B=256,
// S=50, H*Dh=1024).  Design: attend_rows.cuh with one source of S rows, one
// block of four warps per (head, image).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attend_rows.cuh"

extern "C" int mic_cross_attention_bf16(void* q, void* enc_k, void* enc_v, void* out, int batch,
                                        int beams, int enc_len, int heads, int head_dim,
                                        void* stream) {
  attend::Args a{static_cast<const __nv_bfloat16*>(q), enc_k, enc_v, nullptr, nullptr, nullptr,
                 nullptr, nullptr, static_cast<__nv_bfloat16*>(out), beams, 1, enc_len, enc_len,
                 heads};
  return attend::launch<__nv_bfloat16, false, false>(a, batch, head_dim,
                                                     static_cast<cudaStream_t>(stream));
}
