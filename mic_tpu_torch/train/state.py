"""Train state and optimizer factory (mic_tpu/train/state.py)."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from mic_tpu_torch.core.knobs import override
from mic_tpu_torch.core.params import torch_dtype
from mic_tpu_torch.train.fused_adamw import FusedAdamW, make_fused_adamw


@dataclasses.dataclass
class TrainState:
    """Everything a step changes.  ``generator`` takes the place of the JAX
    state's dropout key; ``shadow`` is the compute-dtype copy of the params
    (train/shadow.py), or None."""

    params: Any
    opt_state: Any
    step: int
    generator: torch.Generator
    shadow: Any = None

    @classmethod
    def create(cls, params: Any, optimizer: FusedAdamW, generator: torch.Generator,
               shadow_dtype: torch.dtype | None = None) -> "TrainState":
        shadow = None
        if shadow_dtype is not None:
            from mic_tpu_torch.train.shadow import cast_shadow, shadow_spec

            shadow = cast_shadow(params, shadow_spec(params, shadow_dtype), shadow_dtype)
        return cls(params=params, opt_state=optimizer.init(params), step=0,
                   generator=generator, shadow=shadow)


def _moment_dtype(name) -> torch.dtype | None:
    """None (the param's own dtype) for float32 names, else the dtype;
    accepts a name or a torch dtype."""
    if isinstance(name, torch.dtype):
        return None if name == torch.float32 else name
    if name in (None, "", "float32", "f32"):
        return None
    return torch_dtype(name)


def decay_mask(params) -> Any:
    """True where weight decay applies: not on biases, LayerNorm scales or
    final_logits_bias (any of those names on the leaf's key path)."""
    def walk(node, names):
        if isinstance(node, dict):
            return {key: walk(value, names | {key}) for key, value in node.items()}
        return not ({"bias", "scale", "final_logits_bias"} & names)

    return walk(params, frozenset())


def make_optimizer(learning_rate_fn, *, weight_decay: float = 0.0, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-8, max_grad_norm: float | None = None,
                   mu_dtype=None, nu_dtype=None, fused: bool = True) -> FusedAdamW:
    """AdamW with no decay on LayerNorm and bias params.  The environment
    variable MIC_TPU_MOMENT_DTYPE sets both moment dtypes when set.
    ``fused=False`` (mic_tpu's optax chain) is not ported and raises."""
    if not fused:
        raise NotImplementedError("fused=False (the optax chain) is not ported (ROADMAP A6)")
    md = override("MIC_TPU_MOMENT_DTYPE")
    if md is not None:
        mu_dtype = nu_dtype = md
    return make_fused_adamw(
        learning_rate_fn, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
        decay_mask_fn=decay_mask if weight_decay > 0 else None,
        max_grad_norm=max_grad_norm, mu_dtype=_moment_dtype(mu_dtype),
        nu_dtype=_moment_dtype(nu_dtype),
    )
