"""Compute-dtype shadow params (mic_tpu/train/shadow.py).

A persistent bf16 copy of every param the model consumes in bf16, which
the optimizer step casts fresh from the updated float32 masters; the loss
computes from it, so no step re-casts the master tree.  Leaves consumed in
float32 pass through as the master itself: LayerNorm {scale, bias},
``final_logits_bias`` and, inside the loss, the shared embedding, whose
input-side lookup gathers float32 rows (so colliding rows' gradients add
in float32).  The CE kernels read the loss's table in the compute dtype
through ``ce_table``: the shared embedding's shadow where the head is tied,
else a (V, D) copy of the untied ``lm_head`` kernel's shadow (mic_tpu's
shadow covers that kernel too, as any float32 leaf the model consumes).

Gradients reach the float32 masters: ``_Use`` hands the model the shadow
and casts its gradient to the master's dtype, the same cast the backward
of a per-use ``.to(bf16)`` applies (mic_tpu's ``_use`` custom VJP).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from mic_tpu_torch.core.params import tree_map


def shadow_spec(params: Any, compute_dtype: torch.dtype = torch.bfloat16) -> Any:
    """Bool mirror tree: True = shadow this leaf at ``compute_dtype``."""
    def walk(node, name=""):
        if isinstance(node, dict):
            if "scale" in node and "kernel" not in node:
                return {key: False for key in node}  # layer norm, consumed in f32
            return {key: walk(value, key) for key, value in node.items()}
        if name == "final_logits_bias":
            return False  # the CE loss reads it in f32
        return node.is_floating_point() and node.dtype != compute_dtype

    return walk(params)


def cast_shadow(params: Any, spec: Any, compute_dtype: torch.dtype = torch.bfloat16) -> Any:
    """astype(master) where spec is True, the master itself where False."""
    return tree_map(lambda p, sh: p.detach().to(compute_dtype) if sh else p, params, spec)


class _Use(torch.autograd.Function):
    """Value of the shadow leaf, gradient to the master leaf."""

    @staticmethod
    def forward(ctx, master, shadow):
        ctx.dtype = master.dtype
        return shadow.view_as(shadow)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


def shadowed_params(params: Any, shadow: Optional[Any]) -> Any:
    """The tree the model computes from: shadow leaves where cast, float32
    masters where passed through, and the shared embedding always the
    master.  Gradients land on ``params``."""
    if shadow is None:
        return params

    def use(master, sh):
        return master if sh is master else _Use.apply(master, sh)

    out = tree_map(use, params, shadow)
    if "shared" in params and "embedding" in params["shared"]:
        out["shared"] = {**out["shared"], "embedding": params["shared"]["embedding"]}
    return out


def ce_embedding(shadow: Optional[Any]):
    """The bf16 (V, D) table for fused_lm_loss's ``emb_cast``, or None."""
    if shadow is None:
        return None
    emb = shadow.get("shared", {}).get("embedding")
    if emb is not None and emb.is_floating_point():
        return emb
    return None


def ce_table(params: Any, shadow: Optional[Any], compute_dtype: torch.dtype):
    """(table, table_cast) for fused_lm_loss: the (V, D) table whose
    gradient the loss produces, and the compute-dtype copy the CE kernels
    read (or None: the table cast per use).

    A tied head's table is the shared embedding and its shadow.  An untied
    head's is ``lm_head``'s (D, V) kernel transposed, a view, so its
    gradient lands on the kernel itself (the shared embedding then gets only
    its lookup's gradient); the kernels read a contiguous (V, D) copy made
    here once a step in the compute dtype, from the shadow where there is
    one.  (With ``fused_ce`` on, mic_tpu takes an untied model's loss from
    the shared embedding, which is not the head it serves: ROADMAP §C.)"""
    if "lm_head" not in params:
        return params["shared"]["embedding"], ce_embedding(shadow)
    kernel = params["lm_head"]["kernel"]
    source = (shadow["lm_head"]["kernel"] if shadow is not None else kernel).detach()
    return kernel.t(), source.to(compute_dtype).t().contiguous()
