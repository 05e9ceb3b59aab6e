"""The mBART text encoder (mic_tpu/models/mbart_text.py): pre-norm, learned
positions offset by 2, a final LN.  With the decoder (models/
mbart_decoder.py) it makes the mBART-50 translator (models/
mbart_seq2seq.py).

The source's padding mask reaches the self-attention through
ops/attention.py::dot_product_attention, so ``attn_impl="pallas"`` runs
flash attention (row 11) with the key-padding bias.
"""

from __future__ import annotations

import torch

from mic_tpu_torch.core.config import DecoderConfig
from mic_tpu_torch.core.params import Params
from mic_tpu_torch.models.mbart_decoder import embed_tokens
from mic_tpu_torch.nn.attention import init_mha, mha
from mic_tpu_torch.nn.layers import (
    ACTIVATIONS,
    dense,
    dropout,
    embed,
    init_dense,
    init_layer_norm,
    layer_norm,
)
from mic_tpu_torch.nn.stacked import init_stacked, scan_apply


def init_text_encoder(generator: torch.Generator, cfg: DecoderConfig, device=None) -> Params:
    """Encoder params without the token embedding (the shared table)."""
    std, dm = cfg.init_std, cfg.d_model

    def layer():
        return {
            "ln_self": init_layer_norm(dm, device),
            "self_attn": init_mha(generator, dm, std, device),
            "ln_mlp": init_layer_norm(dm, device),
            "fc1": init_dense(generator, dm, cfg.ffn_dim, std, device=device),
            "fc2": init_dense(generator, cfg.ffn_dim, dm, std, device=device),
        }

    pos = torch.randn((cfg.max_position_embeddings + cfg.pos_offset, dm),
                      generator=generator, device=device) * std
    return {
        "pos_embed": {"embedding": pos},
        "ln_embed": init_layer_norm(dm, device),
        "final_ln": init_layer_norm(dm, device),
        "layers": init_stacked(cfg.num_layers, layer),
    }


def apply_text_encoder(params: Params, shared: Params, input_ids: torch.Tensor,
                       attention_mask: torch.Tensor, cfg: DecoderConfig,
                       dtype: torch.dtype = torch.float32, rng=None, attn_impl: str = "xla",
                       remat=False) -> torch.Tensor:
    """input_ids and attention_mask (B, S), 1 = real token -> encoder states
    (B, S, D) after the final LN.  Dropout from ``rng`` (a torch.Generator,
    or None for none) at the embeddings, then per layer at the attention
    output, the activation and the MLP output; ``remat`` as in
    nn/stacked.py::scan_apply."""
    b, s = input_ids.shape
    eps = cfg.layer_norm_eps
    act = ACTIVATIONS[cfg.activation]
    positions = torch.arange(s, device=input_ids.device).expand(b, s)
    x = embed_tokens(shared, input_ids, cfg, dtype)
    x = x + embed(params["pos_embed"], positions + cfg.pos_offset, dtype)
    x = layer_norm(params["ln_embed"], x, eps)
    x = dropout(x, cfg.dropout, rng)
    mask = attention_mask.bool()[:, None, None, :]

    def layer(h, p, lrng):
        r = h
        h = layer_norm(p["ln_self"], h, eps)
        h = mha(p["self_attn"], h, h, mask, cfg.num_heads, impl=attn_impl)
        h = r + dropout(h, cfg.dropout, lrng)
        r = h
        h = layer_norm(p["ln_mlp"], h, eps)
        h = act(dense(p["fc1"], h))
        h = dropout(h, cfg.activation_dropout, lrng)
        h = dense(p["fc2"], h)
        return r + dropout(h, cfg.dropout, lrng), {}

    x, _ = scan_apply(layer, x, params["layers"], rng, remat)
    return layer_norm(params["final_ln"], x, eps)
