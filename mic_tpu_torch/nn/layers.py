"""Functional layers over explicit param dicts (mic_tpu/nn/layers.py).

Parameters keep the JAX layouts: dense kernels are (d_in, d_out), embedding
tables (vocab, dim).  LayerNorm statistics and softmax run in float32 at
any compute dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mic_tpu_torch.core.params import Params
from mic_tpu_torch.ops.quant import dequant_dense, int8_dense


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
    """x @ kernel + bias with inputs and output in ``dtype`` (x's by default).

    An int8 dense (ops/quant.py): a 2-D ``kernel_q`` runs the int8 x int8
    product on the row-quantized activation; a stacked (L, in, out) one is
    dequantized to ``dtype`` and contracted as ``jnp.dot`` contracts it."""
    dtype = dtype or x.dtype
    if "kernel_q" in params:
        if params["kernel_q"].ndim == 2:
            return int8_dense(params, x, dtype)
        kernel = dequant_dense(params, dtype)
        y = torch.tensordot(x.to(dtype), kernel, dims=([x.ndim - 1], [kernel.ndim - 2]))
    else:
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
    """Gather rows, then cast (only the looked-up rows are converted).  An
    int8 table gathers int8 rows and scales and multiplies them in ``dtype``
    (float32 by default)."""
    if "embedding_q" in params:
        dtype = dtype or torch.float32
        rows = params["embedding_q"][ids.long()].to(dtype)
        return rows * params["embedding_scale"][ids.long()].to(dtype)[..., None]
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


def keep_mask(rng, shape, keep: float, device) -> torch.Tensor:
    """Bernoulli(keep) boolean mask: uniform < keep, as jax.random.bernoulli
    draws it.  ``rng`` is a torch.Generator on ``device``, or any object
    with its own ``keep_mask`` (a per-layer mask stream of nn/stacked.py
    under remat, the data-parallel trainer's GlobalBatchMasks)."""
    if isinstance(rng, torch.Generator):
        return torch.rand(shape, generator=rng, device=device) < keep
    return rng.keep_mask(shape, keep, device)


def dropout(x: torch.Tensor, rate: float, rng) -> torch.Tensor:
    """Inverted dropout; identity when rng is None (deterministic) or
    rate == 0 (mic_tpu/nn/layers.py::dropout).  The masks come from torch's
    Philox stream, not jax.random's: keep rate and scale are the same, the
    bits are not, so a step with dropout on is never bit-equal to JAX's."""
    if rng is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = keep_mask(rng, x.shape, keep, x.device)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, t, h, hd = x.shape
    return x.reshape(b, t, h * hd)
