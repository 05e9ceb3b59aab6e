"""Stacked layers (mic_tpu/nn/stacked.py): every leaf of a stack carries a
leading layer axis L.  ``lax.scan`` over the stack becomes a Python loop
over layer slices; PyTorch runs eagerly, so there is nothing to compile
once.  Rematerialization is ``torch.utils.checkpoint`` per layer."""

from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from mic_tpu_torch.core.params import Params, tree_map
from mic_tpu_torch.nn.layers import keep_mask


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


class MaskStream:
    """Dropout keep-masks for one run of a layer body, in the order the body
    asks for them: drawn from ``rng`` (a torch.Generator or an object with
    its own ``keep_mask``; each appended to ``record`` when given), or
    handed back from ``replay``."""

    def __init__(self, rng=None, record=None, replay=None):
        self._rng = rng
        self._record = record
        self._replay = replay

    def keep_mask(self, shape, keep: float, device) -> torch.Tensor:
        if self._replay is not None:
            return next(self._replay)
        mask = keep_mask(self._rng, shape, keep, device)
        if self._record is not None:
            self._record.append(mask)
        return mask


class _LayerRng:
    """The dropout randomness of one checkpointed layer.  Its forward draws
    from the caller's generator; the backward's recompute must see the same
    masks.  ``torch.utils.checkpoint`` restores only the default generators,
    never a user's, so "masks" keeps the masks the forward drew and replays
    them (mic_tpu's save_only_these_names("dropout_mask")), and "full" keeps
    only the generator's state and draws them again from a copy.  ``rng``
    is a torch.Generator, or an object with ``keep_mask``, ``get_state``
    and ``with_state(state)`` (a copy drawing from that state)."""

    def __init__(self, rng, keep_masks: bool):
        self._rng = rng
        self._masks = [] if keep_masks else None
        self._state = None if keep_masks else rng.get_state()
        self._runs = 0

    def stream(self) -> MaskStream:
        self._runs += 1
        if self._runs == 1:
            return MaskStream(self._rng, record=self._masks)
        if self._masks is not None:
            return MaskStream(replay=iter(self._masks))
        if not isinstance(self._rng, torch.Generator):
            return MaskStream(self._rng.with_state(self._state))
        copy = torch.Generator(device=self._rng.device)
        copy.set_state(self._state)
        return MaskStream(copy)


def remat_policy(remat) -> str | None:
    """None, "full", "masks" or "dots"; raises for an unknown policy."""
    if remat in (False, None, "none"):
        return None
    if remat in (True, "full"):
        return "full"
    if remat in ("masks", "dots"):
        return remat
    raise ValueError(f"unknown remat policy: {remat!r}")


def _dot_ops() -> frozenset:
    """The matrix products as autograd's dispatcher sees them (F.linear and
    einsum arrive as these): what mic_tpu's dots_saveable keeps."""
    aten = torch.ops.aten
    return frozenset({aten.mm.default, aten.addmm.default, aten.bmm.default,
                      aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    """Selective checkpointing's policy for "dots": keep every matrix
    product's output, recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if op in _dot_ops()
            else CheckpointPolicy.PREFER_RECOMPUTE)


def scan_apply(body: Callable, h: torch.Tensor, stacked: Params, rng=None,
               remat=False):
    """Run ``body(h, layer_params, rng) -> (h, ys)`` over the layers in order
    -> (h, stacked ys): ``ys`` is a dict of per-layer tensors (empty where
    the body keeps nothing), each stacked along a new leading layer axis,
    as mic_tpu's ``lax.scan`` stacks its ys.

    ``rng`` is the dropout generator (or None); the layers draw from it in
    order.  ``remat``: False/"none" keeps every activation; "full"
    checkpoints each layer and recomputes its dropout masks from the saved
    generator state; "masks" checkpoints each layer but keeps its boolean
    dropout masks; "dots" checkpoints each layer selectively, keeping the
    outputs of its matrix products (``_save_dots``) and recomputing the rest,
    the dropout masks drawn again as "full" draws them (mic_tpu's
    dots_saveable: its masks come again from the same key).  The kernels'
    autograd Functions are recomputed under "dots", as dots_saveable
    recomputes mic_tpu's Pallas calls.  All four draw the same masks from
    the same generator, so their gradients are equal; a checkpointed layer
    returns its ys too."""
    policy = remat_policy(remat)
    context = ({"context_fn": functools.partial(create_selective_checkpoint_contexts,
                                                _save_dots)}
               if policy == "dots" else {})
    per_layer = []
    for layer in range(num_layers_of(stacked)):
        p = layer_slice(stacked, layer)
        if policy is None:
            h, ys = body(h, p, rng)
        else:
            layer_rng = None if rng is None else _LayerRng(rng, keep_masks=policy == "masks")

            def run(x, p=p, layer_rng=layer_rng):
                return body(x, p, None if layer_rng is None else layer_rng.stream())

            h, ys = checkpoint(run, h, use_reentrant=False, **context)
        per_layer.append(ys)
    return h, {key: torch.stack([ys[key] for ys in per_layer]) for key in per_layer[0]}
