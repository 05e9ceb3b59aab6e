"""Param-tree utilities: nested dicts of tensors, as the JAX package keeps
its pytrees (mic_tpu/core/params.py); and the device the port's entry
points run on."""

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


def resolve_device(device=None) -> torch.device:
    """The device of the trainer, the CLIs and from_pretrained: the card
    unless the caller names another (``device="cpu"``, as the CPU tests
    do).  No card and no device named raises: nothing falls back to the CPU
    by itself."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "(--device cpu) to run on the CPU")
        device = "cuda"
    return torch.device(device)


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` to every leaf of a nested dict (and the same leaves of
    the trees in ``rest``, which share its structure)."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, value, *(r[key] for r in rest))
                for key, value in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree, path=()) -> list:
    """[(key path, leaf)] in sorted-key order, the order of jax.tree.leaves."""
    if isinstance(tree, dict):
        return [item for key in sorted(tree) for item in tree_leaves(tree[key], path + (key,))]
    return [(path, tree)]


def make_serving_params(params: Params, dtype: torch.dtype = torch.bfloat16) -> Params:
    """Cast every floating leaf to the serving compute dtype, once; integer
    leaves pass through (mic_tpu/core/params.py::make_serving_params)."""
    return tree_map(
        lambda x: x.to(dtype) if x.is_floating_point() else x, params
    )
