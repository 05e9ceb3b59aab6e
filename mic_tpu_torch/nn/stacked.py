"""Stacked layers (mic_tpu/nn/stacked.py): every leaf of a stack carries a
leading layer axis L.  ``lax.scan`` over the stack becomes a Python loop
over layer slices; PyTorch runs eagerly, so there is nothing to compile
once."""

from __future__ import annotations

from typing import Callable

import torch

from mic_tpu_torch.core.params import Params, tree_map


def init_stacked(num_layers: int, init_fn: Callable[[], Params]) -> Params:
    """Stack ``num_layers`` independent inits along a new leading axis."""
    def zip_trees(trees):
        if isinstance(trees[0], dict):
            return {key: zip_trees([t[key] for t in trees]) for key in trees[0]}
        return torch.stack(trees)

    return zip_trees([init_fn() for _ in range(num_layers)])


def num_layers_of(stacked: Params) -> int:
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


def layer_slice(stacked: Params, layer: int) -> Params:
    return tree_map(lambda a: a[layer], stacked)


def scan_apply(body: Callable, h: torch.Tensor, stacked: Params) -> torch.Tensor:
    """Run ``body(h, layer_params) -> h`` over the layers in order."""
    for layer in range(num_layers_of(stacked)):
        h = body(h, layer_slice(stacked, layer))
    return h
