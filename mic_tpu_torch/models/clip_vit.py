"""CLIP-style pre-LN vision transformer (mic_tpu/models/clip_vit.py).

The stride-P patch convolution is a reshape and one matmul; the output is
the un-normalized last hidden state (CLS + patches), which the captioner
projects into the decoder width.  Only the CLIP tower style is ported.
"""

from __future__ import annotations

import torch

from mic_tpu.core.config import VisionConfig
from mic_tpu_torch.core.params import Params
from mic_tpu_torch.nn.attention import init_mha, mha
from mic_tpu_torch.nn.layers import ACTIVATIONS, dense, init_dense, init_layer_norm, layer_norm
from mic_tpu_torch.nn.stacked import init_stacked, scan_apply


def check_clip_style(cfg: VisionConfig) -> None:
    if not cfg.use_pre_ln or cfg.final_ln_output or cfg.patch_bias:
        raise NotImplementedError("only the CLIP tower style is ported")


def patchify(pixels: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, N, patch*patch*C), flattened (row, col, channel)."""
    b, h, w, c = pixels.shape
    x = pixels.reshape(b, h // patch, patch, w // patch, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // patch) * (w // patch), patch * patch * c)


def init_vision(generator: torch.Generator, cfg: VisionConfig, device=None) -> Params:
    check_clip_style(cfg)
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

    return {
        "patch_embed": {"kernel": normal(patch_dim, hid)},
        "class_embed": normal(hid),
        "pos_embed": {"embedding": normal(cfg.seq_len, hid)},
        "post_ln": init_layer_norm(hid, device),
        "pre_ln": init_layer_norm(hid, device),
        "layers": init_stacked(cfg.num_layers, layer),
    }


def apply_vision(params: Params, pixels: torch.Tensor, cfg: VisionConfig,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """pixels (B, image_size, image_size, 3) -> last hidden state (B, 1+N, H)."""
    check_clip_style(cfg)
    act = ACTIVATIONS[cfg.hidden_act]
    eps = cfg.layer_norm_eps
    x = patchify(pixels.to(dtype), cfg.patch_size) @ params["patch_embed"]["kernel"].to(dtype)
    cls = params["class_embed"].to(dtype).expand(x.shape[0], 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"]["embedding"].to(dtype)[None]
    x = layer_norm(params["pre_ln"], x, eps)

    def layer(h, p):
        r = h
        h = layer_norm(p["ln1"], h, eps)
        h = r + mha(p["attn"], h, h, None, cfg.num_heads)
        r = h
        h = layer_norm(p["ln2"], h, eps)
        return r + dense(p["fc2"], act(dense(p["fc1"], h)))

    return scan_apply(layer, x, params["layers"])
