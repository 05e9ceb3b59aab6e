"""Single-pass AdamW over param dicts (mic_tpu/train/fused_adamw.py).

Per leaf, with c the step count after the increment:

    mu'  = b1*mu + (1-b1)*g
    nu'  = b2*nu + (1-b2)*g^2
    p'   = p - lr * ( (mu'/(1-b1^c)) / (sqrt(nu'/(1-b2^c)) + eps) + wd*p )

optax.adamw's formula, with global-norm clipping folded into the gradient
scale and the learning rate read at the count before the increment.  The
moments may be stored in a narrower dtype (bf16 by default in the trainer):
they are read up to float32, the math is float32, and they are rounded on
write.  Plain elementwise torch, no kernel (mic_tpu has none here either).

Unlike the JAX step, which returns new trees, params and moments are
updated in place: no second copy of the 2.2 GB float32 master tree or of
the moments is allocated.  The returned state shares the moment tensors.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from mic_tpu_torch.core.params import tree_leaves, tree_map


class FusedAdamWState(NamedTuple):
    count: int   # steps applied so far
    mu: Any      # first-moment tree (params-like)
    nu: Any      # second-moment tree (params-like)


class FusedAdamW(NamedTuple):
    """``init(params) -> state``; ``step(params, grads, state) -> (params, state)``."""

    init: Callable[[Any], FusedAdamWState]
    step: Callable[..., tuple]


def _leaves(tree) -> list:
    return [leaf for _, leaf in tree_leaves(tree)]


def make_fused_adamw(learning_rate: Union[float, Callable], *, b1: float = 0.9,
                     b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                     decay_mask_fn: Optional[Callable] = None,
                     max_grad_norm: Optional[float] = None,
                     mu_dtype: Optional[torch.dtype] = None,
                     nu_dtype: Optional[torch.dtype] = None) -> FusedAdamW:
    """``mu_dtype``/``nu_dtype`` store the moments narrower than the params
    (None keeps each param's dtype)."""
    lr_fn = learning_rate if callable(learning_rate) else (lambda _: learning_rate)

    def init(params) -> FusedAdamWState:
        mu = tree_map(lambda p: torch.zeros_like(p, dtype=mu_dtype or p.dtype), params)
        nu = tree_map(lambda p: torch.zeros_like(p, dtype=nu_dtype or p.dtype), params)
        return FusedAdamWState(0, mu, nu)

    @torch.no_grad()
    def step(params, grads, state: FusedAdamWState, shadow_spec=None,
             shadow_dtype: torch.dtype = torch.bfloat16, grad_norm=None):
        count = state.count + 1
        cf = torch.tensor(count, dtype=torch.float32)
        inv_bc1 = 1.0 / (1.0 - b1 ** cf)
        inv_bc2 = 1.0 / (1.0 - b2 ** cf)
        lr = torch.tensor(lr_fn(state.count), dtype=torch.float32)
        flat_g = _leaves(grads)
        gscale = None
        if max_grad_norm is not None:
            gnorm = (torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in flat_g))
                     if grad_norm is None else grad_norm)
            gscale = torch.clamp(max_grad_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
        mask = decay_mask_fn(params) if decay_mask_fn is not None else None
        flat_p = _leaves(params)
        flat_mask = _leaves(mask) if mask is not None else [True] * len(flat_p)
        for p, g, mu, nu, decayed in zip(flat_p, flat_g, _leaves(state.mu),
                                         _leaves(state.nu), flat_mask):
            if gscale is not None:
                g = g * gscale.to(g.dtype)
            gf = g.float()
            mu2 = b1 * mu.float() + (1.0 - b1) * gf
            nu2 = b2 * nu.float() + (1.0 - b2) * gf * gf
            upd = (mu2 * inv_bc1) / (torch.sqrt(nu2 * inv_bc2) + eps)
            if weight_decay and decayed:
                upd = upd + weight_decay * p.float()
            p.copy_(p.float() - lr * upd)
            mu.copy_(mu2)
            nu.copy_(nu2)
        new_state = FusedAdamWState(count, state.mu, state.nu)
        if shadow_spec is None:
            return params, new_state
        # the compute-dtype shadow (train/shadow.py), cast from the new params
        shadow = tree_map(lambda p, sh: p.to(shadow_dtype) if sh else p, params, shadow_spec)
        return params, new_state, shadow

    return FusedAdamW(init=init, step=step)


def apply_gradients(optimizer, params, grads, opt_state, shadow_spec=None,
                    shadow_dtype: torch.dtype = torch.bfloat16, grad_norm=None):
    """One optimizer application, fused or the optax chain
    (train/adamw_chain.py): (params', state'), or (params', state',
    shadow') when ``shadow_spec`` (train/shadow.py::shadow_spec) is given.
    The chain applies its updates tree in a second pass and casts the shadow
    in a third, as mic_tpu's optax path does (the same values).
    ``grad_norm`` is the global norm that clipping reads, where ``grads``
    are this rank's parts of the gradients (FSDP)."""
    if isinstance(optimizer, FusedAdamW):
        return optimizer.step(params, grads, opt_state, shadow_spec, shadow_dtype,
                              grad_norm=grad_norm)
    from mic_tpu_torch.train.adamw_chain import apply_updates
    from mic_tpu_torch.train.shadow import cast_shadow

    updates, opt_state = optimizer.update(grads, opt_state, params, grad_norm=grad_norm)
    params = apply_updates(params, updates)
    if shadow_spec is None:
        return params, opt_state
    return params, opt_state, cast_shadow(params, shadow_spec, shadow_dtype)
