"""Train state, its checkpointed part, and the optimizer factory
(mic_tpu/train/state.py)."""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import numpy as np
import torch

from mic_tpu_torch.core.knobs import override
from mic_tpu_torch.core.params import torch_dtype, tree_leaves, tree_map
from mic_tpu_torch.train.adamw_chain import AdamWChain, AdamWChainState, make_adamw_chain
from mic_tpu_torch.train.fused_adamw import FusedAdamW, FusedAdamWState, make_fused_adamw


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
    def create(cls, params: Any, optimizer: FusedAdamW | AdamWChain, generator: torch.Generator,
               shadow_dtype: torch.dtype | None = None) -> "TrainState":
        shadow = None
        if shadow_dtype is not None:
            from mic_tpu_torch.train.shadow import cast_shadow, shadow_spec

            shadow = cast_shadow(params, shadow_spec(params, shadow_dtype), shadow_dtype)
        return cls(params=params, opt_state=optimizer.init(params), step=0,
                   generator=generator, shadow=shadow)


def checkpoint_tree(state: TrainState) -> dict:
    """The part of the state a checkpoint keeps: params, opt_state (count,
    mu, nu, of either optimizer), step and the dropout generator's state
    (mic_tpu's dropout_rng).  The shadow is left out: it is a cast of the params, rebuilt on restore."""
    opt = state.opt_state
    return {"params": state.params, "opt_state": {"count": opt.count, "mu": opt.mu, "nu": opt.nu},
            "step": state.step, "generator": state.generator.get_state()}


def _fit(stored, template, what: str):
    """``stored`` checked against ``template``'s keys and shapes, each leaf
    cast to the template's dtype -> (tree, {(stored dtype, dtype): [leaf
    paths cast]})."""
    casts = {}

    def walk(x, t, path):
        where = f"checkpoint {what} {'/'.join(path)}".rstrip()
        if isinstance(t, dict):
            if not isinstance(x, dict) or set(x) != set(t):
                have = sorted(x) if isinstance(x, dict) else type(x).__name__
                raise ValueError(f"{where}: keys {have}, the model's are {sorted(t)}")
            return {key: walk(x[key], t[key], path + (key,)) for key in t}
        if not isinstance(x, torch.Tensor) or x.shape != t.shape:
            have = tuple(x.shape) if isinstance(x, torch.Tensor) else type(x).__name__
            raise ValueError(f"{where}: shape {have}, the model's is {tuple(t.shape)}")
        if x.dtype != t.dtype:
            casts.setdefault((x.dtype, t.dtype), []).append("/".join(path))
            return x.to(t.dtype)
        return x

    return walk(stored, template, ()), casts


def restore_state(tree: dict, template: Any, generator: torch.Generator, *,
                  mu_dtype: torch.dtype | None = None, nu_dtype: torch.dtype | None = None,
                  shadow_dtype: torch.dtype | None = None, fused: bool = True) -> TrainState:
    """A TrainState from a checkpoint_tree: ``template`` gives the params'
    key paths, shapes and dtypes (e.g. init_params on the "meta" device),
    ``mu_dtype``/``nu_dtype`` the moments' (None: the param's own, as
    make_optimizer resolves them), ``fused`` the optimizer the state is for
    (FusedAdamW's state, or the optax chain's; both keep count, mu and nu).
    A leaf stored in another dtype is cast, as mic_tpu's restore casts to
    its template, and a warning names it.  The generator takes the stored
    state (a state that does not fit it, e.g. one saved from another
    device's generator, raises); the shadow is cast fresh from the params."""
    saved, current = tree["generator"].cpu(), generator.get_state()
    if saved.dtype != current.dtype or saved.shape != current.shape:
        raise ValueError(f"the checkpoint's dropout generator state ({saved.numel()} bytes) does "
                         f"not fit this trainer's {generator.device} generator "
                         f"({current.numel()} bytes): it was saved from another device's "
                         "generator")

    def moment(dtype):
        return tree_map(lambda p: torch.empty(p.shape, dtype=dtype or p.dtype, device="meta"),
                        template)

    parts = {"params": (tree["params"], template, "the float32 master params"),
             "mu": (tree["opt_state"]["mu"], moment(mu_dtype), "train.adam_mu_dtype"),
             "nu": (tree["opt_state"]["nu"], moment(nu_dtype), "train.adam_nu_dtype")}
    fitted = {}
    for name, (stored, tmpl, setting) in parts.items():
        fitted[name], casts = _fit(stored, tmpl, name)
        for (have, want), leaves in casts.items():
            warnings.warn(f"checkpoint {name} stored as {have}, cast to {want} ({setting}): "
                          f"{', '.join(leaves)}", stacklevel=2)
    generator.set_state(saved)
    params = fitted["params"]
    for _, leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    state_cls = FusedAdamWState if fused else AdamWChainState
    opt_state = state_cls(int(tree["opt_state"]["count"]), fitted["mu"], fitted["nu"])
    shadow = None
    if shadow_dtype is not None:
        from mic_tpu_torch.train.shadow import cast_shadow, shadow_spec

        shadow = cast_shadow(params, shadow_spec(params, shadow_dtype), shadow_dtype)
    return TrainState(params, opt_state, int(tree["step"]), generator, shadow)


def _moment_dtype(name) -> torch.dtype | None:
    """None (the param's own dtype) for float32, else the dtype; accepts a
    name, a torch dtype or a numpy dtype (or scalar type) alike."""
    if isinstance(name, torch.dtype):
        return None if name == torch.float32 else name
    if name is not None and not isinstance(name, str):
        name = np.dtype(name).name
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


def moment_dtypes(mu_dtype=None, nu_dtype=None) -> tuple:
    """(mu, nu) storage dtypes as the optimizer keeps them (None: the
    param's own).  The environment variable MIC_TPU_MOMENT_DTYPE sets both
    when set."""
    md = override("MIC_TPU_MOMENT_DTYPE")
    if md is not None:
        mu_dtype = nu_dtype = md
    return _moment_dtype(mu_dtype), _moment_dtype(nu_dtype)


def make_optimizer(learning_rate_fn, *, weight_decay: float = 0.0, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-8, max_grad_norm: float | None = None,
                   mu_dtype=None, nu_dtype=None, fused: bool = True) -> FusedAdamW | AdamWChain:
    """AdamW with no decay on LayerNorm and bias params, its moments stored
    as moment_dtypes says: the single-pass FusedAdamW, or with
    ``fused=False`` mic_tpu's optax chain (train/adamw_chain.py), which
    keeps nu in float32 and so raises on another ``nu_dtype``."""
    mu_dtype, nu_dtype = moment_dtypes(mu_dtype, nu_dtype)
    if not fused:
        if nu_dtype is not None:
            raise ValueError(
                f"TrainConfig.adam_nu_dtype={nu_dtype} needs TrainConfig.fused_adamw=True: the "
                "optax chain (fused_adamw=False) keeps nu in float32; set adam_nu_dtype="
                "'float32' (or unset MIC_TPU_MOMENT_DTYPE) to use it")
        return make_adamw_chain(
            learning_rate_fn, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
            decay_mask_fn=decay_mask if weight_decay > 0 else None,
            max_grad_norm=max_grad_norm, mu_dtype=mu_dtype,
        )
    return make_fused_adamw(
        learning_rate_fn, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
        decay_mask_fn=decay_mask if weight_decay > 0 else None,
        max_grad_norm=max_grad_norm, mu_dtype=mu_dtype, nu_dtype=nu_dtype,
    )
