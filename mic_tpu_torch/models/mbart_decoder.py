"""mBART-style pre-norm decoder, cached single-token decoding on the lazy
beam cache (mic_tpu/models/mbart_decoder.py).

Token embeddings are the shared table scaled by sqrt(d_model) in the
compute dtype; learned positions are offset by 2; every layer is
self-attention -> cross-attention -> MLP with pre-norm and a final LN.
"""

from __future__ import annotations

import dataclasses

import torch

from mic_tpu.core.config import DecoderConfig
from mic_tpu_torch.core.params import Params
from mic_tpu_torch.nn.attention import (
    init_mha,
    mha_cross_grouped,
    mha_decode_step_lazy,
    project_kv,
)
from mic_tpu_torch.nn.cache import LazyDecoderCache
from mic_tpu_torch.nn.layers import (
    ACTIVATIONS,
    dense,
    embed,
    init_dense,
    init_layer_norm,
    layer_norm,
)
from mic_tpu_torch.nn.stacked import init_stacked, layer_slice


def check_pre_norm(cfg: DecoderConfig) -> None:
    if cfg.post_norm:
        raise NotImplementedError("only the pre-norm (mBART) decoder is ported")


def fuse_qkv_params(decoder_params: Params) -> Params:
    """Decode-only view: each layer's self-attention q/k/v denses become one
    (L, D, 3D) "qkv" dense, so a step runs one projection GEMM per layer."""
    layers = decoder_params["layers"]
    sa = layers["self_attn"]
    qkv = {"kernel": torch.cat([sa[n]["kernel"] for n in ("q", "k", "v")], dim=-1)}
    if "bias" in sa["q"]:
        qkv["bias"] = torch.cat([sa[n]["bias"] for n in ("q", "k", "v")], dim=-1)
    new_sa = {key: value for key, value in sa.items() if key not in ("q", "k", "v")}
    new_sa["qkv"] = qkv
    return {**decoder_params, "layers": {**layers, "self_attn": new_sa}}


def init_decoder(generator: torch.Generator, cfg: DecoderConfig, device=None) -> Params:
    """Decoder params without the token embedding (the shared table)."""
    check_pre_norm(cfg)
    std, dm = cfg.init_std, cfg.d_model

    def layer():
        return {
            "ln_self": init_layer_norm(dm, device),
            "self_attn": init_mha(generator, dm, std, device),
            "ln_cross": init_layer_norm(dm, device),
            "cross_attn": init_mha(generator, dm, std, device),
            "ln_mlp": init_layer_norm(dm, device),
            "fc1": init_dense(generator, dm, cfg.ffn_dim, std, device=device),
            "fc2": init_dense(generator, cfg.ffn_dim, dm, std, device=device),
        }

    pos = torch.randn((cfg.max_position_embeddings + cfg.pos_offset, dm),
                      generator=generator, device=device) * std
    params = {
        "pos_embed": {"embedding": pos},
        "ln_embed": init_layer_norm(dm, device),
        "layers": init_stacked(cfg.num_layers, layer),
    }
    if cfg.use_final_ln:
        params["final_ln"] = init_layer_norm(dm, device)
    return params


def embed_tokens(shared: Params, ids: torch.Tensor, cfg: DecoderConfig,
                 dtype: torch.dtype) -> torch.Tensor:
    scale = cfg.d_model**0.5 if cfg.scale_embedding else 1.0
    return embed(shared, ids, dtype) * torch.tensor(scale, dtype=dtype, device=ids.device)


def init_cross_cache(params: Params, enc_states: torch.Tensor, cfg: DecoderConfig,
                     dtype: torch.dtype):
    """Project the encoder states into every layer's cross K/V once:
    -> (cross_k, cross_v), each (L, B, S, H, Dh)."""
    enc_states = enc_states.to(dtype)
    ks, vs = [], []
    for layer in range(cfg.num_layers):
        p = layer_slice(params["layers"]["cross_attn"], layer)
        k, v = project_kv(p, enc_states, cfg.num_heads)
        ks.append(k)
        vs.append(v)
    return torch.stack(ks), torch.stack(vs)


def decoder_step(params: Params, shared: Params, token_ids: torch.Tensor,
                 cache: LazyDecoderCache, cfg: DecoderConfig, dtype: torch.dtype,
                 beams: int):
    """One cached decode step on the lazy cache, the port of
    ``_decoder_step_lazy`` (the lazy branch of mic_tpu's decoder_step):
    token_ids (B*K, 1) -> (hidden (B*K, 1, D), cache with index + 1).  Each
    layer's self K/V gain column ``cache.index`` in place; nothing is
    reordered.  ``params`` carry the fused "qkv" self-attention projection."""
    check_pre_norm(cfg)
    eps = cfg.layer_norm_eps
    act = ACTIVATIONS[cfg.activation]
    index = cache.index
    pos = torch.full_like(token_ids, index + cfg.pos_offset)
    x = embed_tokens(shared, token_ids, cfg, dtype) + embed(params["pos_embed"], pos, dtype)
    x = layer_norm(params["ln_embed"], x, eps)
    for layer in range(cfg.num_layers):
        p = layer_slice(params["layers"], layer)
        r = x
        x = layer_norm(p["ln_self"], x, eps)
        x = r + mha_decode_step_lazy(
            p["self_attn"], x, cache.self_k[layer], cache.self_v[layer],
            cache.ancestry, index, cfg.num_heads, beams,
        )
        r = x
        x = layer_norm(p["ln_cross"], x, eps)
        x = r + mha_cross_grouped(
            p["cross_attn"], x, cache.cross_k[layer], cache.cross_v[layer], cfg.num_heads,
        )
        r = x
        x = layer_norm(p["ln_mlp"], x, eps)
        x = r + dense(p["fc2"], act(dense(p["fc1"], x)))
    if cfg.use_final_ln:
        x = layer_norm(params["final_ln"], x, eps)
    return x, dataclasses.replace(cache, index=index + token_ids.shape[1])
