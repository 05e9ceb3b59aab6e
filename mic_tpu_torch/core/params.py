"""Param-tree utilities: nested dicts of tensors, as the JAX package keeps
its pytrees (mic_tpu/core/params.py)."""

from __future__ import annotations

from typing import Callable

import torch

Params = dict

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def torch_dtype(name: str) -> torch.dtype:
    """CaptionerConfig.dtype -> torch dtype (the config's own compute_dtype
    property imports JAX, so the port never calls it)."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, value) for key, value in tree.items()}
    return fn(tree)


def make_serving_params(params: Params, dtype: torch.dtype = torch.bfloat16) -> Params:
    """Cast every floating leaf to the serving compute dtype, once; integer
    leaves pass through (mic_tpu/core/params.py::make_serving_params)."""
    return tree_map(
        lambda x: x.to(dtype) if x.is_floating_point() else x, params
    )
