"""mic_tpu's optax chain, ``TrainConfig.fused_adamw=False``
(mic_tpu/train/state.py::make_optimizer(fused=False)).

optax.adamw is three transforms, run here as optax runs them, leaf by leaf
in the same order of float operations:

    scale_by_adam:         mu' = (1-b1) g + b1 mu,  nu' = (1-b2) g^2 + b2 nu,
                           u = (mu' / (1-b1^c)) / (sqrt(nu' / (1-b2^c)) + eps)
    add_decayed_weights:   u += wd p            (where the decay mask is True)
    scale_by_learning_rate: u *= -lr(count)     (the count before the increment)

with ``clip_by_global_norm`` first when ``max_grad_norm`` is set (g scaled
by max_norm / |g| where |g| >= max_norm).  mu is stored in ``mu_dtype``
(b1 rounded to that dtype before its product, as JAX types a Python float
beside a bf16 array); nu stays in the params' dtype, as optax.adamw keeps
it.

Two passes, as optax: ``update(grads, state, params) -> (updates, state)``
builds a whole updates tree, then ``apply_updates(params, updates)`` adds
it (p + u in the params' dtype).  The moments and params are written in
place, as train/fused_adamw.py writes them; the updates tree is new each
step.  Plain elementwise torch: mic_tpu has no kernel here either.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from mic_tpu_torch.core.params import tree_leaves, tree_map


class AdamWChainState(NamedTuple):
    """optax's ScaleByAdamState inside the chain: the step count (the
    schedule's count is always equal to it), mu and nu.  The fields are
    FusedAdamWState's, so train/state.py checkpoints either alike."""

    count: int
    mu: Any
    nu: Any


class AdamWChain(NamedTuple):
    """``init(params) -> state``; ``update(grads, state, params) -> (updates,
    state)``; apply with ``apply_updates``."""

    init: Callable[[Any], AdamWChainState]
    update: Callable[..., tuple]


def _leaves(tree) -> list:
    return [leaf for _, leaf in tree_leaves(tree)]


def global_norm(leaves: list) -> torch.Tensor:
    """optax.global_norm of a tree's leaves: sqrt of the sum over them of
    sum(g * g), added in leaf order."""
    total = 0
    for g in leaves:
        total = total + torch.sum(g * g)
    return torch.sqrt(total)


def make_adamw_chain(learning_rate: Union[float, Callable], *, b1: float = 0.9,
                     b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                     decay_mask_fn: Optional[Callable] = None,
                     max_grad_norm: Optional[float] = None,
                     mu_dtype: Optional[torch.dtype] = None) -> AdamWChain:
    """``mu_dtype`` stores mu narrower than the params (None keeps each
    param's dtype); nu always keeps it."""
    lr_fn = learning_rate if callable(learning_rate) else (lambda _: learning_rate)

    def init(params) -> AdamWChainState:
        mu = tree_map(lambda p: torch.zeros_like(p, dtype=mu_dtype or p.dtype), params)
        nu = tree_map(lambda p: torch.zeros_like(p), params)
        return AdamWChainState(0, mu, nu)

    @torch.no_grad()
    def update(grads, state: AdamWChainState, params, grad_norm=None):
        """``grad_norm``: the gradients' global norm where they are parts of
        a larger tree (the FSDP step), else computed here."""
        flat_g = [g.float() for g in _leaves(grads)]
        if max_grad_norm is not None:  # optax's select, with no read back to the host
            g_norm = global_norm(flat_g) if grad_norm is None else grad_norm
            keep = g_norm < max_grad_norm
            flat_g = [torch.where(keep, g, (g / g_norm) * max_grad_norm) for g in flat_g]
        count = state.count + 1
        cf = torch.tensor(count, dtype=torch.float32)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** cf
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** cf
        step_size = torch.tensor(-lr_fn(state.count), dtype=torch.float32)
        flat_p = _leaves(params)
        mask = decay_mask_fn(params) if decay_mask_fn is not None else None
        flat_mask = _leaves(mask) if mask is not None else [True] * len(flat_p)
        updates = []
        for p, g, mu, nu, decayed in zip(flat_p, flat_g, _leaves(state.mu), _leaves(state.nu),
                                         flat_mask):
            # b1 as a weakly typed scalar beside mu takes mu's dtype (a bf16
            # mu's b1 is bf16(b1)); XLA keeps the product in f32 (excess
            # precision) before the add to the f32 (1-b1) g
            mu2 = (1 - b1) * g + torch.tensor(b1, dtype=mu.dtype).float() * mu.float()
            nu2 = (1 - b2) * (g * g) + b2 * nu
            u = (mu2 / bc1.to(mu2.dtype)) / (torch.sqrt(nu2 / bc2.to(nu2.dtype)) + eps)
            if weight_decay and decayed:
                u = u + weight_decay * p
            updates.append(step_size.to(u.dtype) * u)
            mu.copy_(mu2)
            nu.copy_(nu2)
        by_leaf = {id(p): u for p, u in zip(flat_p, updates)}
        return (tree_map(lambda p: by_leaf[id(p)], params),
                AdamWChainState(count, state.mu, state.nu))

    return AdamWChain(init=init, update=update)


@torch.no_grad()
def apply_updates(params, updates):
    """optax.apply_updates in place: p <- (p + u) in p's dtype."""
    for p, u in zip(_leaves(params), _leaves(updates)):
        p.copy_((p + u).to(p.dtype))
    return params
