"""The mBART-style decoder (mic_tpu/models/mbart_decoder.py): the
teacher-forced full-sequence pass for training (``apply_decoder``) and
cached single-token decoding (``decoder_step``) on the lazy beam cache
(with mic_tpu's opt-in kernels of the beam step: the blocked lazy
attention, the cross-attention over the canonical or the merged cross
cache, LN -> QKV and the fused MLP) or on the physical cache, whose
self-attention runs the decode-attention kernel under
MIC_TPU_EXPERIMENTAL=fused_decode.

Token embeddings are the shared table, scaled by sqrt(d_model) in the
compute dtype where ``scale_embedding``; learned positions are offset by
2; every layer is self-attention -> cross-attention -> MLP.  mBART's
blocks are pre-norm with a final LN; BART's (``post_norm=True``,
``use_final_ln=False``) normalize after each residual and have none.  A
source mask (the translator's ``enc_mask``) masks the cross-attention's
keys and keeps its kernels off, as in mic_tpu.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from mic_tpu_torch.core.config import DecoderConfig
from mic_tpu_torch.core.knobs import experimental
from mic_tpu_torch.core.params import Params
from mic_tpu_torch.nn.attention import (
    init_mha,
    mha,
    mha_cross_grouped,
    mha_decode_step,
    mha_decode_step_lazy,
    project_kv,
)
from mic_tpu_torch.nn.cache import DecoderCache, LazyDecoderCache
from mic_tpu_torch.nn.layers import (
    ACTIVATIONS,
    dense,
    dropout,
    embed,
    init_dense,
    init_layer_norm,
    layer_norm,
    merge_heads,
    split_heads,
)
from mic_tpu_torch.nn.stacked import init_stacked, layer_slice, scan_apply
from mic_tpu_torch.ops import cross_attention, lazy_attention
from mic_tpu_torch.ops.decode_attention import decode_attention
from mic_tpu_torch.ops.fused_mlp import fused_mlp


class DecoderTowerOutput(NamedTuple):
    """``apply_decoder`` with introspection (mic_tpu's DecoderTowerOutput):
    layer axes stacked, hidden_states (L+1, B, T, D) with the embeddings
    output first and the last entry after the final LN (as HF mBART),
    attentions and cross_attentions (L, B, heads, T, ·)."""

    last_hidden_state: torch.Tensor
    hidden_states: Optional[torch.Tensor] = None
    attentions: Optional[torch.Tensor] = None
    cross_attentions: Optional[torch.Tensor] = None


def attn_buckets(max_len: int) -> tuple:
    """Static cache-read prefix lengths of the lazy-attention chain
    (mic_tpu's ``_attn_buckets``): MIC_TPU_EXPERIMENTAL=attn_buckets=auto
    (or 1) reads half or all of the window, a list like "16.32.64" those
    prefixes; unset, "" or "0" reads the whole window."""
    spec = experimental("attn_buckets", "0")
    if spec in ("", "0"):
        return ()
    if spec in ("auto", "1"):
        return (max_len // 2, max_len) if max_len >= 16 else ()
    return tuple(int(s) for s in spec.replace(".", ",").split(","))


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


def _causal_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """(B, T) padding mask -> (B, 1, T, T) boolean causal+padding mask."""
    t = attention_mask.shape[-1]
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=attention_mask.device))
    return causal[None, None] & attention_mask.bool()[:, None, None, :]


def apply_decoder(params: Params, shared: Params, input_ids: torch.Tensor,
                  attention_mask: torch.Tensor, enc_states: torch.Tensor, enc_mask,
                  cfg: DecoderConfig, dtype: torch.dtype = torch.float32, rng=None,
                  attn_impl: str = "xla", remat=False, position_ids=None,
                  output_hidden_states: bool = False, output_attentions: bool = False):
    """Teacher-forced full-sequence decode: input_ids and attention_mask
    (B, T), enc_states (B, S, D) already projected, enc_mask (B, S) or None
    -> hidden states (B, T, D) after the final LN, or a DecoderTowerOutput
    when introspection outputs are requested.

    Dropout at mic_tpu's sites, drawn from ``rng`` (a torch.Generator, or
    None for none) in this order: the embeddings, then per layer the
    self-attention weights, the self-attention output, the cross-attention
    weights, the cross-attention output, the activation and the MLP output.
    ``attn_impl`` (ops/attention.py::dot_product_attention) reaches the
    self-attention only: mic_tpu gives the cross-attention none.  ``remat``
    as in nn/stacked.py::scan_apply."""
    b, t = input_ids.shape
    eps = cfg.layer_norm_eps
    act = ACTIVATIONS[cfg.activation]
    if position_ids is None:
        position_ids = torch.arange(t, device=input_ids.device).expand(b, t)
    x = embed_tokens(shared, input_ids, cfg, dtype)
    x = x + embed(params["pos_embed"], position_ids + cfg.pos_offset, dtype)
    x = layer_norm(params["ln_embed"], x, eps)
    x = dropout(x, cfg.dropout, rng)

    self_mask = _causal_mask(attention_mask)
    cross_mask = _cross_mask(enc_mask)
    enc_states = enc_states.to(dtype)
    post = cfg.post_norm
    embeddings = x

    def layer(h, p, lrng):
        ys = {}
        r = h
        if not post:
            h = layer_norm(p["ln_self"], h, eps)
        h = mha(p["self_attn"], h, h, self_mask, cfg.num_heads, impl=attn_impl,
                dropout_rate=cfg.attention_dropout, dropout_rng=lrng,
                return_weights=output_attentions)
        if output_attentions:
            h, ys["attn"] = h
        h = r + dropout(h, cfg.dropout, lrng)
        if post:
            h = layer_norm(p["ln_self"], h, eps)
        r = h
        if not post:
            h = layer_norm(p["ln_cross"], h, eps)
        h = mha(p["cross_attn"], h, enc_states, cross_mask, cfg.num_heads,
                dropout_rate=cfg.attention_dropout, dropout_rng=lrng,
                return_weights=output_attentions)
        if output_attentions:
            h, ys["cross_attn"] = h
        h = r + dropout(h, cfg.dropout, lrng)
        if post:
            h = layer_norm(p["ln_cross"], h, eps)
        r = h
        if not post:
            h = layer_norm(p["ln_mlp"], h, eps)
        h = act(dense(p["fc1"], h))
        h = dropout(h, cfg.activation_dropout, lrng)
        h = dense(p["fc2"], h)
        h = r + dropout(h, cfg.dropout, lrng)
        if post:
            h = layer_norm(p["ln_mlp"], h, eps)
        if output_hidden_states:
            ys["hidden"] = h
        return h, ys

    x, ys = scan_apply(layer, x, params["layers"], rng, remat)
    if cfg.use_final_ln:
        x = layer_norm(params["final_ln"], x, eps)
    if not (output_hidden_states or output_attentions):
        return x
    return DecoderTowerOutput(
        last_hidden_state=x,
        # the last entry is x: after the final LN, as HF mBART reports it
        hidden_states=(torch.cat([embeddings[None], ys["hidden"][:-1], x[None]])
                       if output_hidden_states else None),
        attentions=ys["attn"] if output_attentions else None,
        cross_attentions=ys["cross_attn"] if output_attentions else None,
    )


def _cross_mask(enc_mask):
    """(B, S) source mask, 1 = real token -> (B, 1, 1, S) bool, or None."""
    return None if enc_mask is None else enc_mask.bool()[:, None, None, :]


def init_cross_cache(params: Params, enc_states: torch.Tensor, cfg: DecoderConfig,
                     dtype: torch.dtype, merged: bool = False):
    """Project the encoder states into every layer's cross K/V once:
    -> (cross_k, cross_v), each (L, B, S, H, Dh), or with ``merged`` (the
    merged_cross layout of ops/cross_attention.py::fused_cross_attention_dma)
    (L, B, S_pad, H*Dh) with S padded by zero rows to a multiple of 16."""
    enc_states = enc_states.to(dtype)
    ks, vs = [], []
    for layer in range(cfg.num_layers):
        p = layer_slice(params["layers"]["cross_attn"], layer)
        k, v = project_kv(p, enc_states, cfg.num_heads)
        ks.append(k)
        vs.append(v)
    k, v = torch.stack(ks), torch.stack(vs)
    if merged:
        num_layers, b, s = k.shape[:3]
        pad = (0, 0, 0, (-s) % 16)
        k = torch.nn.functional.pad(k.reshape(num_layers, b, s, -1), pad)
        v = torch.nn.functional.pad(v.reshape(num_layers, b, s, -1), pad)
    return k, v


def _decoder_step_layers(params: Params, shared: Params, token_ids: torch.Tensor, cache,
                         cfg: DecoderConfig, dtype: torch.dtype, self_attention,
                         cross_kernel: bool = False, mlp=None, enc_len: int | None = None,
                         enc_mask=None):
    """The decode step's layer stack around ``self_attention(p, x, layer)``,
    which takes the layer's params and its input (a pre-norm step applies
    ln_self itself), returns the (N, 1, D) self-attention output and writes
    the step's K/V into column ``cache.index`` of the layer's self cache in
    place.  ``cross_kernel`` runs the cross-attention kernel; a merged cross
    cache runs its own, over its first ``enc_len`` rows; ``enc_mask`` (B, S)
    masks the sources' padding and keeps both kernels off; ``mlp(p, x)``,
    where given, replaces fc1 -> act -> fc2.  Post-norm (BART) normalizes
    after each residual instead of before each block."""
    eps = cfg.layer_norm_eps
    act = ACTIVATIONS[cfg.activation]
    post = cfg.post_norm
    cross_mask = _cross_mask(enc_mask)
    pos = torch.full_like(token_ids, cache.index + cfg.pos_offset)
    x = embed_tokens(shared, token_ids, cfg, dtype) + embed(params["pos_embed"], pos, dtype)
    x = layer_norm(params["ln_embed"], x, eps)
    for layer in range(cfg.num_layers):
        p = layer_slice(params["layers"], layer)
        x = x + self_attention(p, x, layer)
        if post:
            x = layer_norm(p["ln_self"], x, eps)
        r = x
        if not post:
            x = layer_norm(p["ln_cross"], x, eps)
        x = r + mha_cross_grouped(
            p["cross_attn"], x, cache.cross_k[layer], cache.cross_v[layer], cfg.num_heads,
            kernel=cross_kernel, enc_len=enc_len, mask=cross_mask,
        )
        if post:
            x = layer_norm(p["ln_cross"], x, eps)
        r = x
        if not post:
            x = layer_norm(p["ln_mlp"], x, eps)
        x = r + (mlp(p, x) if mlp else dense(p["fc2"], act(dense(p["fc1"], x))))
        if post:
            x = layer_norm(p["ln_mlp"], x, eps)
    if cfg.use_final_ln:
        x = layer_norm(params["final_ln"], x, eps)
    return x, dataclasses.replace(cache, index=cache.index + token_ids.shape[1])


def _decoder_step_lazy(params: Params, shared: Params, token_ids: torch.Tensor,
                       cache: LazyDecoderCache, cfg: DecoderConfig, dtype: torch.dtype,
                       beams: int, enc_len: int | None = None, enc_mask=None):
    """mic_tpu's ``_decoder_step_lazy``: each layer's self K/V gain column
    ``cache.index`` in place and nothing is reordered.

    mic_tpu's gates, each read where mic_tpu reads it on its accelerator and
    here wherever the switch is set; inside each wrapper the tensors' device
    then picks the kernel or its plain version:
      - MIC_TPU_FUSED_LAZY_ATTN (ops/lazy_attention.py::resolve_mode): "2"
        (the default) attends and writes the column in one kernel; "1" runs
        the blocked kernel on the per-step ancestry mask, built once and
        shared by every layer; "0", and "1" on a shape ``supports``
        rejects, run mic_tpu's XLA chain (nn/attention.py::
        lazy_attention_chain, plain tensor code) over the read prefixes of
        MIC_TPU_EXPERIMENTAL=attn_buckets.  The mode and the shape decide
        this before any launch; a kernel that fails still raises.
        (Under attn_buckets mic_tpu takes the chain in modes "1" and "2"
        too; the port keeps their kernels, which compute the same values.)
      - a merged cross cache (MIC_TPU_EXPERIMENTAL=merged_cross, resolved
        by the captioner): the merged cross-attention kernel over its first
        ``enc_len`` rows, whatever the next switch says;
      - MIC_TPU_EXPERIMENTAL=fused_cross_attn with H*Dh a multiple of 128
        and no source mask: the cross-attention kernel.
      - fused_mlp, on a float fc1 ("kernel") with a bias, N = images x beams
        a multiple of 8, d_model of 128 and ffn_dim of 512: the fused MLP
        kernel.
      - ln_qkv, pre-norm only: ln_self moves into the self-attention's qkv
        GEMM (where ops/ln_gemm.py's guard passes).
    An int8 weight tree ("kernel_q") turns the last two off, as in mic_tpu."""
    index = cache.index
    max_len = cache.ancestry.shape[-1]
    mode = lazy_attention.resolve_mode(max_len)
    lazy_attention.check_mode(mode)
    chain = mode == "0" or (mode == "1" and not lazy_attention.supports(
        cache.self_k[0], beams, cfg.num_heads, cfg.head_dim))
    buckets = attn_buckets(max_len) if chain else ()
    amask = (lazy_attention.build_ancestry_mask(cache.ancestry, index)
             if mode == "1" and not chain else None)
    ln_fused = experimental("ln_qkv", "0") == "1" and not cfg.post_norm
    cross_kernel = (experimental("fused_cross_attn", "0") == "1" and enc_mask is None
                    and cross_attention.supports(cfg.num_heads, cfg.head_dim))
    fc1 = params["layers"]["fc1"]
    mlp = None
    if (experimental("fused_mlp", "0") == "1" and "kernel" in fc1 and "bias" in fc1
            and token_ids.shape[0] % 8 == 0 and cfg.d_model % 128 == 0
            and cfg.ffn_dim % 512 == 0):
        def mlp(p, x):
            n, one, d = x.shape
            return fused_mlp(x.reshape(n, d), p["fc1"]["kernel"], p["fc1"]["bias"],
                             p["fc2"]["kernel"], p["fc2"]["bias"],
                             cfg.activation).reshape(n, one, d)

    def attend(p, x, layer):
        if not (ln_fused or cfg.post_norm):
            x = layer_norm(p["ln_self"], x, cfg.layer_norm_eps)
        return mha_decode_step_lazy(
            p["self_attn"], x, cache.self_k[layer], cache.self_v[layer], cache.ancestry, index,
            cfg.num_heads, beams, amask=amask,
            ln=(p["ln_self"], cfg.layer_norm_eps) if ln_fused else None,
            chain=chain, buckets=buckets,
        )

    return _decoder_step_layers(params, shared, token_ids, cache, cfg, dtype, attend,
                                cross_kernel=cross_kernel, mlp=mlp, enc_len=enc_len,
                                enc_mask=enc_mask)


def _decoder_step_physical(params: Params, shared: Params, token_ids: torch.Tensor,
                           cache: DecoderCache, cfg: DecoderConfig, dtype: torch.dtype,
                           enc_mask=None):
    """The physical branch of mic_tpu's ``decoder_step``: mha_decode_step
    on each layer's (N, T, H, Dh) view of the stacked self cache."""
    def attend(p, x, layer):
        if not cfg.post_norm:
            x = layer_norm(p["ln_self"], x, cfg.layer_norm_eps)
        return mha_decode_step(p["self_attn"], x, cache.self_k[layer], cache.self_v[layer],
                               cache.index, cfg.num_heads)

    return _decoder_step_layers(params, shared, token_ids, cache, cfg, dtype, attend,
                                enc_mask=enc_mask)


def _decoder_step_fused(params: Params, shared: Params, token_ids: torch.Tensor,
                        cache: DecoderCache, cfg: DecoderConfig, dtype: torch.dtype,
                        enc_mask=None):
    """mic_tpu's ``_decoder_step_fused`` (MIC_TPU_EXPERIMENTAL=fused_decode):
    the self-attention of each layer is ops/decode_attention.py, which
    writes the step column of the stacked cache and attends over 0..index
    in one launch."""
    head_dim = cfg.head_dim

    def attend(p, x, layer):
        sa = p["self_attn"]
        if not cfg.post_norm:
            x = layer_norm(p["ln_self"], x, cfg.layer_norm_eps)
        q = split_heads(dense(sa["q"], x) * (head_dim**-0.5), cfg.num_heads)
        k_step, v_step = project_kv(sa, x, cfg.num_heads)
        out = decode_attention(q, k_step, v_step, cache.self_k, cache.self_v, layer,
                               cache.index)
        return dense(sa["o"], merge_heads(out.to(x.dtype)))

    return _decoder_step_layers(params, shared, token_ids, cache, cfg, dtype, attend,
                                enc_mask=enc_mask)


def decoder_step(params: Params, shared: Params, token_ids: torch.Tensor, cache,
                 cfg: DecoderConfig, dtype: torch.dtype, beams: int = 1,
                 enc_len: int | None = None, enc_mask=None):
    """One cached decode step: token_ids (N, 1) -> (hidden (N, 1, D), cache
    with index + 1), N = images x beams.  Dispatches on the cache as mic_tpu
    does: the lazy cache, then MIC_TPU_EXPERIMENTAL=fused_decode, then the
    physical step.  The cross K/V are per image (or source) and shared by
    its beams; ``enc_len`` is the live length of a merged padded cross cache
    (the lazy cache alone carries one); ``enc_mask`` (B, S), 1 = real token,
    is the sources' padding mask (the translator's)."""
    if isinstance(cache, LazyDecoderCache):
        return _decoder_step_lazy(params, shared, token_ids, cache, cfg, dtype, beams,
                                  enc_len, enc_mask)
    if experimental("fused_decode", "0") == "1":
        return _decoder_step_fused(params, shared, token_ids, cache, cfg, dtype, enc_mask)
    return _decoder_step_physical(params, shared, token_ids, cache, cfg, dtype, enc_mask)
