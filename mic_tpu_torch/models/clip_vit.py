"""The pre-LN vision transformer (mic_tpu/models/clip_vit.py) in its two
tower styles: CLIP's (a pre-LayerNorm on the embeddings; the output is the
un-normalized last hidden state, CLS + patches) and ViT's
(``use_pre_ln=False``, ``final_ln_output=True``, ``patch_bias=True``: a
biased patch projection, no pre-LayerNorm, the whole output through
post_ln).  The captioner projects the output into the decoder width.

The stride-P patch convolution is a reshape and one matmul.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mic_tpu_torch.core.config import VisionConfig
from mic_tpu_torch.core.params import Params
from mic_tpu_torch.nn.attention import init_mha, mha
from mic_tpu_torch.nn.layers import ACTIVATIONS, dense, init_dense, init_layer_norm, layer_norm
from mic_tpu_torch.nn.stacked import init_stacked, scan_apply


class VisionOutput(NamedTuple):
    """``apply_vision`` with introspection (mic_tpu's VisionOutput): layer
    axes stacked, hidden_states (L+1, B, T, H) with the embeddings output
    first, attentions (L, B, heads, T, T)."""

    last_hidden_state: torch.Tensor
    hidden_states: Optional[torch.Tensor] = None
    attentions: Optional[torch.Tensor] = None


def patchify(pixels: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, N, patch*patch*C), flattened (row, col, channel)."""
    b, h, w, c = pixels.shape
    x = pixels.reshape(b, h // patch, patch, w // patch, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // patch) * (w // patch), patch * patch * c)


def init_vision(generator: torch.Generator, cfg: VisionConfig, device=None) -> Params:
    hid = cfg.hidden_size
    patch_dim = cfg.patch_size * cfg.patch_size * 3

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device) * 0.02

    def layer():
        return {
            "ln1": init_layer_norm(hid, device),
            "attn": init_mha(generator, hid, device=device),
            "ln2": init_layer_norm(hid, device),
            "fc1": init_dense(generator, hid, cfg.intermediate_size, device=device),
            "fc2": init_dense(generator, cfg.intermediate_size, hid, device=device),
        }

    patch = {"kernel": normal(patch_dim, hid)}
    if cfg.patch_bias:
        patch["bias"] = torch.zeros((hid,), device=device)
    params = {
        "patch_embed": patch,
        "class_embed": normal(hid),
        "pos_embed": {"embedding": normal(cfg.seq_len, hid)},
        "post_ln": init_layer_norm(hid, device),
        "layers": init_stacked(cfg.num_layers, layer),
    }
    if cfg.use_pre_ln:
        params["pre_ln"] = init_layer_norm(hid, device)
    return params


def apply_vision(params: Params, pixels: torch.Tensor, cfg: VisionConfig,
                 dtype: torch.dtype = torch.float32, rng=None, attn_impl: str = "xla",
                 remat=False, output_hidden_states: bool = False,
                 output_attentions: bool = False):
    """pixels (B, image_size, image_size, 3) -> last hidden state (B, 1+N, H),
    or a VisionOutput when introspection outputs are requested.

    ``rng`` (a torch.Generator) drives attention-weight dropout, the tower's
    only dropout (CLIP has no hidden dropout); ``attn_impl`` as in
    ops/attention.py::dot_product_attention; ``remat`` as in
    nn/stacked.py::scan_apply."""
    if cfg.attention_dropout == 0.0:
        rng = None
    act = ACTIVATIONS[cfg.hidden_act]
    eps = cfg.layer_norm_eps
    x = patchify(pixels.to(dtype), cfg.patch_size) @ params["patch_embed"]["kernel"].to(dtype)
    if "bias" in params["patch_embed"]:
        x = x + params["patch_embed"]["bias"].to(dtype)
    cls = params["class_embed"].to(dtype).expand(x.shape[0], 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"]["embedding"].to(dtype)[None]
    if cfg.use_pre_ln:
        x = layer_norm(params["pre_ln"], x, eps)
    embeddings = x

    def layer(h, p, lrng):
        ys = {}
        r = h
        h = layer_norm(p["ln1"], h, eps)
        h = mha(p["attn"], h, h, None, cfg.num_heads, impl=attn_impl,
                dropout_rate=cfg.attention_dropout, dropout_rng=lrng,
                return_weights=output_attentions)
        if output_attentions:
            h, ys["attn"] = h
        h = r + h
        r = h
        h = layer_norm(p["ln2"], h, eps)
        h = r + dense(p["fc2"], act(dense(p["fc1"], h)))
        if output_hidden_states:
            ys["hidden"] = h
        return h, ys

    x, ys = scan_apply(layer, x, params["layers"], rng, remat)
    if cfg.final_ln_output:  # the ViT style normalizes the whole output
        x = layer_norm(params["post_ln"], x, eps)
    if not (output_hidden_states or output_attentions):
        return x
    return VisionOutput(
        last_hidden_state=x,
        hidden_states=torch.cat([embeddings[None], ys["hidden"]]) if output_hidden_states else None,
        attentions=ys["attn"] if output_attentions else None,
    )
