"""Multi-head attention as functions over param dicts (mic_tpu/nn/attention.py).

The query is scaled by head_dim**-0.5 before the score product; projections
carry biases; scores and softmax run in float32.
"""

from __future__ import annotations

import torch

from mic_tpu_torch.core.params import Params
from mic_tpu_torch.nn.layers import dense, init_dense, merge_heads, split_heads
from mic_tpu_torch.ops.attention import xla_attention
from mic_tpu_torch.ops.lazy_attention import lazy_attention


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
        num_heads: int) -> torch.Tensor:
    """Full-sequence attention: self-attention when kv_states is x."""
    head_dim = x.shape[-1] // num_heads
    q = split_heads(dense(params["q"], x) * (head_dim**-0.5), num_heads)
    k, v = project_kv(params, kv_states, num_heads, x.dtype)
    return dense(params["o"], merge_heads(xla_attention(q, k, v, mask)))


def mha_cross_grouped(params: Params, x: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Cached cross-attention with K/V held once per image: x (B*K, 1, D),
    k/v (B, S, H, Dh); an image's K beams ride the query axis."""
    bk, one, d = x.shape
    head_dim = d // num_heads
    b = k.shape[0]
    q = dense(params["q"], x) * (head_dim**-0.5)
    q = q.reshape(b, (bk // b) * one, num_heads, head_dim)
    scores = torch.einsum("bkhd,bshd->bhks", q.float(), k.float())
    weights = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bhks,bshd->bkhd", weights, v.to(x.dtype))
    return dense(params["o"], out.reshape(bk, one, d))


def mha_decode_step_lazy(params: Params, x: torch.Tensor, cache_k: torch.Tensor,
                         cache_v: torch.Tensor, ancestry: torch.Tensor, index: int,
                         num_heads: int, beams: int) -> torch.Tensor:
    """Cached beam self-attention on the lazy cache (never reordered).

    x (B*K, 1, D); params hold the fused "qkv" projection
    (models/mbart_decoder.py::fuse_qkv_params); merged caches (B*K, T, D)
    gain column ``index`` in place.  Returns the (B*K, 1, D) output."""
    bk, one, d = x.shape
    b = bk // beams
    head_dim = d // num_heads
    qkv = dense(params["qkv"], x)                            # (BK, 1, 3D)
    q, k_step, v_step = torch.split(qkv, d, dim=-1)
    q = q * (head_dim**-0.5)
    out = lazy_attention(
        q.reshape(b, beams, d).contiguous(), cache_k, cache_v,
        k_step.reshape(b, beams, d).contiguous(),
        v_step.reshape(b, beams, d).contiguous(),
        ancestry, index, num_heads,
    )
    return dense(params["o"], out.reshape(bk, one, d))
