"""Multi-head attention as functions over param dicts (mic_tpu/nn/attention.py).

The query is scaled by head_dim**-0.5 before the score product; projections
carry biases; scores and softmax run in float32.  ``lazy_attention_chain``
is mic_tpu's XLA lazy-attention chain (lazy-attention mode "0"), plain
tensor code on any device: mic_tpu runs it as XLA ops, not as a kernel.
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


_MASK_VALUE = torch.finfo(torch.float32).min


def _write_column(cache, step: torch.Tensor, index: int, num_heads: int) -> None:
    """Store the step rows (N, D) as column ``index`` of a (N, T, D) cache,
    or quantized into an int8 one: a scale per row where its scales are
    (N, T), per head where they are (N, T, H)."""
    if not isinstance(cache, dict):
        cache[:, index] = step
        return
    n, d = step.shape
    per_head = cache["s"].ndim == 3
    values, scales = quantize_rows_dynamic(
        step.reshape(n, num_heads, d // num_heads) if per_head else step)
    cache["q"][:, index] = values.reshape(n, d)
    cache["s"][:, index] = scales[..., 0]


def lazy_attention_chain(q, cache_k, cache_v, k_step, v_step, ancestry: torch.Tensor,
                         index: int, num_heads: int, buckets: tuple = ()) -> torch.Tensor:
    """mic_tpu's XLA lazy-attention chain, ``mha_decode_step_lazy`` without
    ``amask``: the step's K/V are written into column ``index`` first
    (quantized on an int8 cache), then every query beam scores every source
    row's cached positions, masked to the rows its ancestry names and to
    t <= index, with one softmax over (source row, position).

    q, k_step, v_step (B, K, H*Dh), q already scaled; caches (B*K, T, H*Dh),
    or int8 {"q", "s"} with per-row (B*K, T) or per-head (B*K, T, H) scales
    (scales multiply the scores and the weights, never the cache); ancestry
    (B, K, T) -> (B, K, H*Dh) in q.dtype.  ``buckets`` are the static read
    prefixes of MIC_TPU_EXPERIMENTAL=attn_buckets: the shortest one covering
    index + 1 is read (masked positions add exact zeros, so every prefix
    gives the same values)."""
    b, beams, d = q.shape
    head_dim = d // num_heads
    dtype = q.dtype
    _write_column(cache_k, k_step.reshape(b * beams, d), index, num_heads)
    _write_column(cache_v, v_step.reshape(b * beams, d), index, num_heads)
    quant = isinstance(cache_k, dict)
    t = (cache_k["q"] if quant else cache_k).shape[1]
    q4 = q.reshape(b, beams, num_heads, head_dim)

    def scales(cache, tb):
        s = cache["s"][:, :tb]
        if s.ndim == 2:  # per row: (B, 1, 1, J, tb), over every head and query beam
            return s.reshape(b, beams, tb)[:, None, None]
        return s.reshape(b, beams, tb, num_heads).permute(0, 3, 1, 2)[:, :, None]

    def attend(tb: int) -> torch.Tensor:
        kg, vg = ((c["q"] if quant else c)[:, :tb].reshape(b, beams, tb, num_heads, head_dim)
                  for c in (cache_k, cache_v))
        scores = torch.einsum("bkhd,bjthd->bhkjt", q4.float(), kg.to(dtype).float())
        if quant:
            scores = scores * scales(cache_k, tb)
        live = torch.arange(tb, device=q.device) <= index
        sel = ancestry[:, :, :tb, None] == torch.arange(beams, device=q.device,
                                                         dtype=ancestry.dtype)
        mask = (sel & live[None, None, :, None]).permute(0, 1, 3, 2)   # (B, K, J, tb)
        scores = torch.where(mask[:, None], scores, _MASK_VALUE)
        w = torch.softmax(scores.reshape(b, num_heads, beams, beams * tb), dim=-1)
        w = w.reshape(b, num_heads, beams, beams, tb)
        if quant:
            w = w * scales(cache_v, tb)
        return torch.einsum("bhkjt,bjthd->bkhd", w.to(dtype), vg.to(dtype))

    if buckets:
        tiers = sorted(min(tb, t) for tb in buckets)
        if tiers[-1] != t:
            tiers.append(t)
        out = attend(tiers[sum(tb < index + 1 for tb in tiers[:-1])])
    else:
        out = attend(t)
    return out.reshape(b, beams, d)


def mha_decode_step_lazy(params: Params, x: torch.Tensor, cache_k, cache_v,
                         ancestry: torch.Tensor, index: int, num_heads: int, beams: int,
                         amask: torch.Tensor | None = None, ln=None, chain: bool = False,
                         buckets: tuple = ()) -> torch.Tensor:
    """Cached beam self-attention on the lazy cache (never reordered).

    x (B*K, 1, D); params hold the fused "qkv" projection
    (models/mbart_decoder.py::fuse_qkv_params), int8 or not; caches
    (B*K, T, D), or int8 {"q", "s"} dicts (ops/lazy_attention.py), gain
    column ``index`` in place.  Returns the (B*K, 1, D) output.

    ``chain`` (mode "0", and mode "1" on a shape its kernel does not take)
    runs ``lazy_attention_chain`` over the ``buckets`` read prefixes.
    Otherwise, without ``amask`` (mode "2") one kernel attends and writes the
    column; with the step's (B, K*T, K) ancestry mask (mode "1") the blocked kernel
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
    if chain:
        out = lazy_attention_chain(q, cache_k, cache_v, k_step, v_step, ancestry, index,
                                   num_heads, buckets)
        return dense(params["o"], out.reshape(bk, one, d))
    if amask is None:
        attend = lazy_attention_q8 if isinstance(cache_k, dict) else lazy_attention
        out = attend(q, cache_k, cache_v, k_step, v_step, ancestry, index, num_heads)
        return dense(params["o"], out.reshape(bk, one, d))
    out = fused_lazy_attention(q, cache_k, cache_v, k_step, v_step, amask, beams, num_heads,
                               positions=index)
    # the canonical int8 layout: a scale per head
    _write_column(cache_k, k_step.reshape(bk, d), index, num_heads)
    _write_column(cache_v, v_step.reshape(bk, d), index, num_heads)
    return dense(params["o"], out.reshape(bk, one, d))
