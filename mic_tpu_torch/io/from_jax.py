"""Bring a mic_tpu param tree into the port.

The JAX tree, given as nested dicts of numpy arrays (``jax.device_get`` of
the params), becomes nested dicts of tensors with the same key paths,
shapes, layouts and dtypes: dense kernels stay (d_in, d_out), stacked
layers keep their leading L axis, the tied embedding stays (V, D).  No leaf
is transposed or reshaped.
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


def opt_state_from_jax(state, device=None):
    """mic_tpu's FusedAdamWState (count, mu, nu; ``jax.device_get`` of it)
    -> the port's, moments in their stored dtypes (bf16 stays bf16)."""
    from mic_tpu_torch.train.fused_adamw import FusedAdamWState

    return FusedAdamWState(int(np.asarray(state.count)), from_jax(state.mu, device),
                           from_jax(state.nu, device))
