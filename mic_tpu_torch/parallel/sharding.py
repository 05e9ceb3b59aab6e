"""Rule-based parameter sharding (mic_tpu/parallel/sharding.py): param
path regex -> a spec of axis names, and the FSDP layout the trainer keeps.

The rule table, ``spec_for`` and ``param_specs`` are mic_tpu's: an ordered
table maps a param's key path (``"decoder/layers/fc1/kernel"``) to
trailing-dim axes, left-padded with None to the leaf's rank; a divisibility
guard drops the "model" axis from a dim the model axis cannot split evenly
(vocab 250054 splits by 2, not by 4); with ``fsdp_axis_size`` > 1 every
leaf's largest still-replicated dim that the data axis divides also shards
over "data", ties to the trailing dim.  A spec is a tuple of axis names
(None for a replicated dim), or ``()`` when the leaf is fully replicated
(mic_tpu's ``P()``).

FSDP (``TrainConfig.fsdp``; ZeRO-3 by hand over the params dict): each rank
keeps its part of every leaf split on the "data" dim of its spec
(``shard_tree``), and its moments and bf16 shadow the same way; a leaf with
no such dim stays whole on every rank.  ``gather_tree`` puts the parts
back together.
"""

from __future__ import annotations

import re
from typing import Any, Optional, Sequence, Tuple

import torch

from mic_tpu_torch.core.params import tree_map
from mic_tpu_torch.parallel.distributed import all_gather_dim
from mic_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

# (path regex, trailing-dims spec). First match wins; default = replicate.
DEFAULT_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"shared/embedding$", (MODEL_AXIS, None)),
    (r"lm_head/kernel$", (None, MODEL_AXIS)),
    (r"final_logits_bias$", (MODEL_AXIS,)),
    (r"(self_attn|cross_attn|attn)/(q|k|v)/kernel$", (None, MODEL_AXIS)),
    (r"(self_attn|cross_attn|attn)/(q|k|v)/bias$", (MODEL_AXIS,)),
    (r"(self_attn|cross_attn|attn)/o/kernel$", (MODEL_AXIS, None)),
    (r"fc1/kernel$", (None, MODEL_AXIS)),
    (r"fc1/bias$", (MODEL_AXIS,)),
    (r"fc2/kernel$", (MODEL_AXIS, None)),
    (r"patch_embed/kernel$", (None, MODEL_AXIS)),
)


def _add_fsdp_axis(spec: list, shape: Sequence[int], fsdp_axis_size: int) -> list:
    """Split the largest still-replicated dim that ``fsdp_axis_size``
    divides over "data"; ties break toward the trailing dim."""
    if fsdp_axis_size <= 1:
        return spec
    best = -1
    for i, (ax, n) in enumerate(zip(spec, shape)):
        if ax is None and n % fsdp_axis_size == 0 and n >= fsdp_axis_size:
            if best < 0 or n >= shape[best]:
                best = i
    if best < 0:
        return spec
    spec = list(spec)
    spec[best] = DATA_AXIS
    return spec


def spec_for(path: str, shape: Sequence[int], model_axis_size: int, rules=DEFAULT_RULES,
             fsdp_axis_size: int = 1) -> tuple:
    ndim = len(shape)
    spec = [None] * ndim
    for pattern, trailing in rules:
        if re.search(pattern, path):
            spec = [None] * (ndim - len(trailing)) + list(trailing)
            # divisibility guard: replicate any dim the mesh can't split
            spec = [ax if (ax is None or shape[i] % model_axis_size == 0) else None
                    for i, ax in enumerate(spec)]
            break
    spec = _add_fsdp_axis(spec, shape, fsdp_axis_size)
    if all(ax is None for ax in spec):
        return ()
    return tuple(spec)


def param_specs(params: Any, model_axis_size: int, rules=DEFAULT_RULES,
                fsdp_axis_size: int = 1, path: str = "") -> Any:
    """A tree of specs matching ``params`` (leaves need only a ``shape``)."""
    if isinstance(params, dict):
        return {key: param_specs(value, model_axis_size, rules, fsdp_axis_size,
                                 f"{path}/{key}" if path else str(key))
                for key, value in params.items()}
    return spec_for(path, tuple(params.shape), model_axis_size, rules,
                    fsdp_axis_size=fsdp_axis_size)


def shard_dim(spec: tuple) -> Optional[int]:
    """The dim a spec splits over "data", or None."""
    return spec.index(DATA_AXIS) if DATA_AXIS in spec else None


def shard_tree(tree: Any, specs: Any, rank: int, world: int) -> Any:
    """This rank's part of every leaf of ``tree`` (a contiguous copy), split
    on its spec's "data" dim; leaves with none pass through."""
    def part(leaf, spec):
        dim = shard_dim(spec)
        if dim is None:
            return leaf
        return leaf.detach().chunk(world, dim)[rank].clone()

    return tree_map(part, tree, specs)


def gather_tree(tree: Any, specs: Any, group=None) -> Any:
    """Every leaf whole again and detached: the ranks' parts concatenated on
    their spec's "data" dim, in rank order (every rank of ``group`` must
    call it); a leaf with no such dim is itself, detached."""
    def whole(leaf, spec):
        dim = shard_dim(spec)
        leaf = leaf.detach()
        return leaf if dim is None else all_gather_dim(leaf, dim, group)

    return tree_map(whole, tree, specs)


def tree_bytes(tree: Any) -> int:
    """Bytes of every tensor leaf of ``tree``."""
    total = 0

    def add(leaf):
        nonlocal total
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        return leaf

    tree_map(add, tree)
    return total
