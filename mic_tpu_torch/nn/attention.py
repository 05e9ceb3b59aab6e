"""Multi-head attention as functions over param dicts (mic_tpu/nn/attention.py).

The query is scaled by head_dim**-0.5 before the score product; projections
carry biases; scores and softmax run in float32.
"""

from __future__ import annotations

import torch

from mic_tpu_torch.core.params import Params
from mic_tpu_torch.nn.layers import dense, init_dense, layer_norm, merge_heads, split_heads
from mic_tpu_torch.ops import ln_gemm as ln_gemm_ops
from mic_tpu_torch.ops.attention import dot_product_attention, xla_attention
from mic_tpu_torch.ops.cross_attention import fused_cross_attention, fused_cross_attention_dma
from mic_tpu_torch.ops.lazy_attention import fused_lazy_attention, lazy_attention, lazy_attention_q8
from mic_tpu_torch.ops.quant import quantize_rows_dynamic


def init_mha(generator: torch.Generator, d_model: int, std: float = 0.02,
             device=None) -> Params:
    return {
        name: init_dense(generator, d_model, d_model, std, device=device)
        for name in ("q", "k", "v", "o")
    }


def project_kv(params: Params, kv_states: torch.Tensor, num_heads: int,
               dtype: torch.dtype | None = None):
    """K/V projections alone (the cross-attention cache)."""
    k = split_heads(dense(params["k"], kv_states, dtype), num_heads)
    v = split_heads(dense(params["v"], kv_states, dtype), num_heads)
    return k, v


def mha(params: Params, x: torch.Tensor, kv_states: torch.Tensor, mask,
        num_heads: int, impl: str = "xla", dropout_rate: float = 0.0, dropout_rng=None,
        return_weights: bool = False):
    """Full-sequence attention: self-attention when kv_states is x; optional
    dropout on the attention weights; ``impl`` as in
    ops/attention.py::dot_product_attention.  With ``return_weights``,
    returns (out, post-softmax weights (B, H, Tq, Tk))."""
    head_dim = x.shape[-1] // num_heads
    q = split_heads(dense(params["q"], x) * (head_dim**-0.5), num_heads)
    k, v = project_kv(params, kv_states, num_heads, x.dtype)
    out = dot_product_attention(q, k, v, mask, impl, dropout_rate, dropout_rng, return_weights)
    if return_weights:
        out, weights = out
        return dense(params["o"], merge_heads(out)), weights
    return dense(params["o"], merge_heads(out))


def mha_cross_grouped(params: Params, x: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, num_heads: int, kernel: bool = False,
                      enc_len: int | None = None, mask: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """Cached cross-attention with K/V held once per image: x (B*K, 1, D),
    k/v (B, S, H, Dh); an image's K beams ride the query axis.  ``mask``
    (B, 1, 1, S), True = attend, is the source's key-padding mask, shared
    by its beams.  In mic_tpu's order, with no mask: the merged (B, S_pad,
    H*Dh) cache (MIC_TPU_EXPERIMENTAL=merged_cross, zero rows past
    ``enc_len``) goes to ops/cross_attention.py::fused_cross_attention_dma
    whatever ``kernel`` says; else ``kernel``
    (MIC_TPU_EXPERIMENTAL=fused_cross_attn) takes
    ops/cross_attention.py::fused_cross_attention.  A mask keeps both
    kernels off: the scores are masked to finfo(float32).min."""
    bk, one, d = x.shape
    head_dim = d // num_heads
    b = k.shape[0]
    q = dense(params["q"], x) * (head_dim**-0.5)
    if k.ndim == 3 and mask is None:
        out = fused_cross_attention_dma(q.reshape(b, (bk // b) * one, d), k, v,
                                        enc_len if enc_len is not None else k.shape[1],
                                        (bk // b) * one, num_heads)
        return dense(params["o"], out.reshape(bk, one, d))
    if kernel and mask is None:
        out = fused_cross_attention(q.reshape(b, (bk // b) * one, d), k, v, (bk // b) * one,
                                    num_heads)
        return dense(params["o"], out.reshape(bk, one, d))
    if k.ndim == 3:  # a merged cache under a mask
        k = k.reshape(b, -1, num_heads, head_dim)
        v = v.reshape(b, -1, num_heads, head_dim)
    q = q.reshape(b, (bk // b) * one, num_heads, head_dim)
    scores = torch.einsum("bkhd,bshd->bhks", q.float(), k.float())
    if mask is not None:
        scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    weights = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bhks,bshd->bkhd", weights, v.to(x.dtype))
    return dense(params["o"], out.reshape(bk, one, d))


def mha_decode_step(params: Params, x: torch.Tensor, cache_k: torch.Tensor,
                    cache_v: torch.Tensor, index: int, num_heads: int) -> torch.Tensor:
    """Single-token cached self-attention on one layer of the physical cache
    (mic_tpu/nn/attention.py::mha_decode_step): x (N, 1, D); cache_k/v
    (N, T, H, Dh) gain column ``index`` in place (mic_tpu returns updated
    copies), then the step attends over positions <= index with f32 scores
    -> (N, 1, D)."""
    head_dim = x.shape[-1] // num_heads
    q = split_heads(dense(params["q"], x) * (head_dim**-0.5), num_heads)
    k_step, v_step = project_kv(params, x, num_heads)
    cache_k[:, index] = k_step[:, 0]
    cache_v[:, index] = v_step[:, 0]
    valid = torch.arange(cache_k.shape[1], device=x.device) <= index
    out = xla_attention(q, cache_k, cache_v, valid[None, None, None, :])
    return dense(params["o"], merge_heads(out))


def mha_decode_step_lazy(params: Params, x: torch.Tensor, cache_k, cache_v,
                         ancestry: torch.Tensor, index: int, num_heads: int, beams: int,
                         amask: torch.Tensor | None = None, ln=None) -> torch.Tensor:
    """Cached beam self-attention on the lazy cache (never reordered).

    x (B*K, 1, D); params hold the fused "qkv" projection
    (models/mbart_decoder.py::fuse_qkv_params), int8 or not; caches
    (B*K, T, D), or int8 {"q", "s"} dicts (ops/lazy_attention.py), gain
    column ``index`` in place.  Returns the (B*K, 1, D) output.

    Without ``amask`` (mode "2") one kernel attends and writes the column.
    With the step's (B, K*T, K) ancestry mask (mode "1") the blocked kernel
    reads the pre-update cache, then the step K/V are stored as a plain
    tensor store, quantized per head on the int8 cache (mode "1" takes the
    canonical layout only).  ``ln`` = (ln params, eps) means x is the
    PRE-norm input: where ops/ln_gemm.py's guard passes, the LayerNorm
    runs inside the qkv GEMM (MIC_TPU_EXPERIMENTAL=ln_qkv), else before it."""
    bk, one, d = x.shape
    b = bk // beams
    head_dim = d // num_heads
    if ln is None:
        qkv = dense(params["qkv"], x)
    elif ("kernel" in params["qkv"] and params["qkv"]["kernel"].ndim == 2
          and ln_gemm_ops.supports(x.reshape(bk, d), params["qkv"]["kernel"])):
        qkv = ln_gemm_ops.ln_gemm(x.reshape(bk, d), ln[0]["scale"], ln[0]["bias"],
                                  params["qkv"]["kernel"], params["qkv"]["bias"], ln[1])
    else:
        qkv = dense(params["qkv"], layer_norm(ln[0], x, ln[1]))
    q, k_step, v_step = torch.split(qkv.reshape(bk, one, 3 * d), d, dim=-1)
    q = q * (head_dim**-0.5)
    q, k_step, v_step = (t.reshape(b, beams, d).contiguous() for t in (q, k_step, v_step))
    if amask is None:
        attend = lazy_attention_q8 if isinstance(cache_k, dict) else lazy_attention
        out = attend(q, cache_k, cache_v, k_step, v_step, ancestry, index, num_heads)
        return dense(params["o"], out.reshape(bk, one, d))
    out = fused_lazy_attention(q, cache_k, cache_v, k_step, v_step, amask, beams, num_heads,
                               positions=index)
    for cache, step in ((cache_k, k_step), (cache_v, v_step)):
        if isinstance(cache, dict):  # the canonical int8 layout: a scale per head
            values, scales = quantize_rows_dynamic(step.reshape(bk, num_heads, head_dim))
            cache["q"][:, index] = values.reshape(bk, d)
            cache["s"][:, index] = scales[..., 0]
        else:
            cache[:, index] = step.reshape(bk, d)
    return dense(params["o"], out.reshape(bk, one, d))
