"""Bring a mic_tpu param tree into the port.

The JAX tree, given as nested dicts of numpy arrays (``jax.device_get`` of
the params), becomes nested dicts of tensors with the same key paths,
shapes, layouts and dtypes: dense kernels stay (d_in, d_out), stacked
layers keep their leading L axis, the tied embedding stays (V, D).  No leaf
is transposed or reshaped, and no key is assumed: any of mic_tpu's trees
crosses whole (the captioner's, with an untied ``lm_head`` or a ViT tower's
``patch_embed.bias``, and the translator's ``shared`` / ``encoder`` /
``decoder`` / ``final_logits_bias``).
"""

from __future__ import annotations

import numpy as np
import torch

from mic_tpu_torch.core.params import Params, tree_map


def _leaf(array, device) -> torch.Tensor:
    a = np.asarray(array)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16 has no torch twin in numpy
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def from_jax(tree: Params, device=None) -> Params:
    return tree_map(lambda a: _leaf(a, device), tree)


def _adam_state(node):
    """The first node of a (nested) optax state tuple holding mu and nu: the
    chain's ScaleByAdamState."""
    if hasattr(node, "mu") and hasattr(node, "nu"):
        return node
    if isinstance(node, (tuple, list)):
        for child in node:
            found = _adam_state(child)
            if found is not None:
                return found
    return None


def opt_state_from_jax(state, device=None):
    """mic_tpu's optimizer state (``jax.device_get`` of it) -> the port's,
    moments in their stored dtypes (bf16 stays bf16): its FusedAdamWState
    (count, mu, nu) as FusedAdamWState, or its optax chain's state (a tuple:
    clip_by_global_norm's empty state where clipping is on, then
    optax.adamw's ScaleByAdamState, the masked weight decay's state and
    ScaleByScheduleState, whose count equals the Adam count) as the port's
    AdamWChainState, from the ScaleByAdamState."""
    from mic_tpu_torch.train.adamw_chain import AdamWChainState
    from mic_tpu_torch.train.fused_adamw import FusedAdamWState

    adam = _adam_state(state)
    if adam is None:
        raise ValueError(f"no Adam moments in the optimizer state {type(state).__name__}")
    cls = FusedAdamWState if adam is state else AdamWChainState
    return cls(int(np.asarray(adam.count)), from_jax(adam.mu, device), from_jax(adam.nu, device))
