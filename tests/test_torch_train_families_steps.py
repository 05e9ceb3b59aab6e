"""Three Trainer steps of the second captioner family, tied and untied,
with every dropout on, against mic_tpu's step on the CPU (the helpers are
test_torch_train_families.py's).

Dropout against mic_tpu: torch's Philox stream cannot draw jax.random's
masks, so every mask is a fixed pattern of its shape and keep rate
(``_pattern``), drawn alike on both sides (jax.random.bernoulli replaced
by monkeypatch, the port handed ``_PatternMasks`` for its generator): the
same sites, scales and remat replays, with masks that are not the
packages' own.

Tolerances: float32 params after three steps within 1e-5
(test_fused_adamw_three_steps_match_jax's); bf16 with the shadow as
test_shadow_step_matches_jax: losses within 2e-3 relative, params within
2 * steps * lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mic_tpu.train.fused_adamw import apply_gradients as jax_apply_gradients
from mic_tpu.train.schedule import linear_warmup_linear_decay as jax_schedule
from mic_tpu.train.shadow import shadow_spec as jax_shadow_spec
from mic_tpu.train.state import TrainState as JaxTrainState
from mic_tpu.train.state import make_optimizer as jax_make_optimizer
from mic_tpu_torch.core.params import tree_leaves
from mic_tpu_torch.io.from_jax import from_jax
from mic_tpu_torch.train.shadow import shadow_spec
from test_torch_train_families import (
    LR, _batch, _config, _jax_leaves, _jax_value_and_grad, _numpy_params, _torch_leaves,
    _train_config, _trainer,
)


def _pattern(shape, keep) -> np.ndarray:
    """A keep mask fixed by its shape and keep rate alone."""
    shape = tuple(int(d) for d in shape)
    return np.random.default_rng([*shape, int(round(keep * 1e6))]).random(shape) < keep


class _PatternMasks:
    """The port's dropout randomness (nn/layers.py::keep_mask's protocol):
    ``_pattern`` masks, the same however often a layer draws them again."""

    def keep_mask(self, shape, keep, device):
        return torch.from_numpy(_pattern(shape, keep)).to(device)

    def get_state(self):
        return None

    def with_state(self, state):
        return self


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat", ["masks", "dots"])
@pytest.mark.parametrize("kind", ["vit_b16_bart_large", "family_untied"])
def test_three_trainer_steps_with_dropout_match_jax(kind, remat, dtype, monkeypatch):
    """Three Trainer.train_step calls with every dropout at 0.1 (the same
    pattern masks on both sides), weight decay and clipping on, under remat
    "masks" and "dots", against mic_tpu's step (its loss, remat policy,
    FusedAdamW and, in bf16, its shadow) from the same weights.  Float32:
    losses within 1e-5, params within 1e-5 absolute (1% of an lr-1e-3
    update), moments within 1/128 relative plus 1e-3 of the leaf's largest
    entry (floored at 1e-4 of the tree's largest: a key bias's gradient is
    rounding noise, 1e-13 here, and so are its moments).  Bf16 with the shadow: losses within 2e-3 relative, params
    within 2 * steps * lr (bf16 activations round at other places; Adam
    can turn a near-zero gradient's sign into a whole update), and the
    port's shadow exactly astype(params)."""
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(_pattern(shape, p)))
    config = _config(kind, dtype=dtype, dropout=0.1)
    tc = dict(remat=remat, flash_ce="dl", weight_decay=0.01, max_grad_norm=1.0,
              adam_mu_dtype="bfloat16")
    trainer = _trainer(config, **tc)
    jtc = _train_config(**tc)
    nparams = _numpy_params(config, seed=10)
    shadow_dtype = None if dtype == "float32" else config.compute_dtype
    jopt = jax_make_optimizer(jax_schedule(LR, 10, 1), weight_decay=0.01, max_grad_norm=1.0,
                              mu_dtype="bfloat16", nu_dtype=jtc.adam_nu_dtype)
    jparams = jax.tree.map(jnp.asarray, nparams)
    jstate = JaxTrainState.create(jparams, jopt, 0, shadow_dtype=shadow_dtype)
    spec = None if shadow_dtype is None else jax_shadow_spec(jparams, shadow_dtype)
    jstep = jax.jit(lambda p, g, s: jax_apply_gradients(jopt, p, g, s, shadow_spec=spec,
                                                        shadow_dtype=shadow_dtype))
    jloss = _jax_value_and_grad(config, jtc, remat=remat)
    state = trainer.init_state(from_jax(nparams))
    state.generator = _PatternMasks()
    key = jax.random.PRNGKey(0)
    for i in range(3):
        batch = _batch(config, seed=20 + i)
        jl, jg = jloss(jstate.params, jstate.shadow, jax.tree.map(jnp.asarray, batch), key)
        out = jstep(jstate.params, jg, jstate.opt_state)
        jstate = JaxTrainState(out[0], out[1], jstate.step + 1, jstate.dropout_rng,
                               out[2] if len(out) == 3 else None)
        state, metrics = trainer.train_step(state, trainer.put_batch(batch))
        if dtype == "float32":
            np.testing.assert_allclose(metrics["loss"].item(), float(jl), rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_allclose(metrics["loss"].item(), float(jl), rtol=2e-3)
    paths = [path for path, _ in tree_leaves(state.params)]
    if dtype == "float32":
        for path, got, ref in zip(paths, _torch_leaves(state.params), _jax_leaves(jstate.params)):
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5, err_msg=str(path))
        for tree, jtree in ((state.opt_state.mu, jstate.opt_state.mu),
                            (state.opt_state.nu, jstate.opt_state.nu)):
            refs = _jax_leaves(jtree)
            floor = 1e-4 * max(np.abs(r).max() for r in refs)
            for path, got, ref in zip(paths, _torch_leaves(tree), refs):
                np.testing.assert_allclose(got, ref, rtol=1 / 128,
                                           atol=1e-3 * max(np.abs(ref).max(), floor),
                                           err_msg=str(path))
        return
    for path, got, ref in zip(paths, _torch_leaves(state.params), _jax_leaves(jstate.params)):
        np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2 * 3 * LR, err_msg=str(path))
    tspec = shadow_spec(state.params, torch.bfloat16)
    if "lm_head" in tspec:  # the untied head is shadowed, as mic_tpu's is
        assert tspec["lm_head"]["kernel"] and jax_shadow_spec(jstate.params,
                                                                shadow_dtype)["lm_head"]["kernel"]
    for (_, p), (_, s), (_, sh) in zip(tree_leaves(state.params), tree_leaves(state.shadow),
                                       tree_leaves(tspec)):
        assert torch.equal(s, p.detach().bfloat16()) if sh else s is p
