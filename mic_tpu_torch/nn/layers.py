"""Functional layers over explicit param dicts (mic_tpu/nn/layers.py).

Parameters keep the JAX layouts: dense kernels are (d_in, d_out), embedding
tables (vocab, dim).  LayerNorm statistics and softmax run in float32 at
any compute dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mic_tpu_torch.core.params import Params


def init_dense(generator: torch.Generator, d_in: int, d_out: int,
               std: float = 0.02, use_bias: bool = True, device=None) -> Params:
    p = {"kernel": torch.randn((d_in, d_out), generator=generator, device=device) * std}
    if use_bias:
        p["bias"] = torch.zeros((d_out,), device=device)
    return p


def init_layer_norm(dim: int, device=None) -> Params:
    return {"scale": torch.ones((dim,), device=device),
            "bias": torch.zeros((dim,), device=device)}


def init_embed(generator: torch.Generator, vocab: int, dim: int,
               std: float = 0.02, device=None) -> Params:
    return {"embedding": torch.randn((vocab, dim), generator=generator, device=device) * std}


def dense(params: Params, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """x @ kernel + bias with inputs and output in ``dtype`` (x's by default)."""
    dtype = dtype or x.dtype
    y = x.to(dtype) @ params["kernel"].to(dtype)
    if "bias" in params:
        y = y + params["bias"].to(dtype)
    return y


def layer_norm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def embed(params: Params, ids: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """Gather rows, then cast (only the looked-up rows are converted)."""
    rows = params["embedding"][ids.long()]
    return rows if dtype is None else rows.to(dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    # CLIP's activation: x * sigmoid(1.702 x)
    return x * torch.sigmoid(1.702 * x)


ACTIVATIONS = {
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "quick_gelu": quick_gelu,
    "relu": F.relu,
    "silu": F.silu,
}


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, t, h, hd = x.shape
    return x.reshape(b, t, h * hd)
