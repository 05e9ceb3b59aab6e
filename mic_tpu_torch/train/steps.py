"""Param-tree statistics (mic_tpu/train/steps.py)."""

from __future__ import annotations

import math

import torch

from mic_tpu_torch.core.params import tree_leaves


def count_params(params) -> int:
    return sum(math.prod(leaf.shape) for _, leaf in tree_leaves(params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float())) for _, leaf in tree_leaves(tree)))
