"""The port's flash cross-entropy (mic_tpu_torch/ops/flash_ce.py) and fused
LM loss (ops/fused_ce.py) against mic_tpu's on the CPU.

JAX runs its Pallas kernels in interpret mode, as tests/test_flash_ce.py
does; the port runs the plain versions (CPU tensors).  Hidden states are
bf16 and the table is read in bf16 on both sides, so the logits are the
same f32 sums of exact products in another order.  V = 997 is ragged for
every vocab tile.  Tolerances: lse and label logits within 1e-5, sums of
logits within 1e-4 relative of the row's sum of |logits|; f32 gradients
within 1e-4 of their largest entry (dl is rounded to bf16 on both sides, and
a rounding tie can fall either way); bf16 dh within 1/128 of its largest
entry (one bf16 ulp); losses within 1e-5.  The CUDA kernels are held to the
plain versions in tests/test_torch_cuda_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mic_tpu.ops.flash_ce import flash_ce_backward_dl as jax_backward_dl
from mic_tpu.ops.flash_ce import flash_ce_forward as jax_forward
from mic_tpu.ops.fused_ce import fused_lm_loss as jax_fused_lm_loss
from mic_tpu_torch.ops.flash_ce import flash_ce_backward_dl, flash_ce_forward
from mic_tpu_torch.ops.fused_ce import fused_lm_loss


def _inputs(n=32, d=128, v=997, seed=0):
    rng = np.random.default_rng(seed)
    h = (rng.normal(size=(n, d)) * 0.5).astype(np.float32)
    emb = (rng.normal(size=(v, d)) * 0.05).astype(np.float32)
    bias = (rng.normal(size=(v,)) * 0.1).astype(np.float32)
    labels = rng.integers(0, v, size=(n,)).astype(np.int32)
    labels[:3] = v - 1 - np.arange(3)  # labels in the ragged last tile
    return h, emb, bias, labels


def _bf16(x):
    return torch.from_numpy(x).bfloat16()


def _jbf16(x):
    return jnp.asarray(x, jnp.bfloat16)


def _close_scaled(got, ref, frac, name=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=frac * np.abs(ref).max(), err_msg=name)


def test_forward_plain_matches_jax_kernel():
    h, emb, bias, labels = _inputs()
    ref = jax_forward(_jbf16(h), jnp.asarray(emb), jnp.asarray(bias), jnp.asarray(labels), True)
    launches = flash_ce_forward.launches
    got = flash_ce_forward(_bf16(h), torch.from_numpy(emb), torch.from_numpy(bias),
                           torch.from_numpy(labels))
    assert flash_ce_forward.launches == launches  # CPU tensors: the plain version
    lse, lbl, zsum = (np.asarray(a) for a in ref)
    np.testing.assert_allclose(got[0].numpy(), lse, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), lbl, rtol=1e-5, atol=1e-5)
    logits = (np.asarray(_jbf16(h), np.float64) @ np.asarray(_jbf16(emb), np.float64).T + bias)
    np.testing.assert_array_less(np.abs(got[2].numpy() - zsum), 1e-4 * np.abs(logits).sum(1))


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_backward_dl_plain_matches_jax_kernel(smoothing):
    h, emb, bias, labels = _inputs(seed=1)
    rng = np.random.default_rng(2)
    rowscale = rng.random(h.shape[0]).astype(np.float32) / h.shape[0]
    rowscale[::5] = 0.0
    lse = np.asarray(jax_forward(_jbf16(h), jnp.asarray(emb), jnp.asarray(bias),
                                 jnp.asarray(labels), True)[0])
    ref = jax_backward_dl(_jbf16(h), jnp.asarray(emb), jnp.asarray(bias), jnp.asarray(labels),
                          jnp.asarray(lse), jnp.asarray(rowscale), smoothing, "bfloat16", True)
    launches = flash_ce_backward_dl.launches
    dh, demb, dbias = flash_ce_backward_dl(
        _bf16(h), torch.from_numpy(emb), torch.from_numpy(bias), torch.from_numpy(labels),
        torch.from_numpy(np.array(lse)), torch.from_numpy(rowscale), smoothing)
    assert flash_ce_backward_dl.launches == launches
    assert dh.dtype == torch.bfloat16 and demb.dtype == dbias.dtype == torch.float32
    _close_scaled(dh.float().numpy(), np.asarray(ref[0], np.float32), 1 / 128, "dh")
    _close_scaled(demb.numpy(), np.asarray(ref[1]), 1e-4, "demb")
    _close_scaled(dbias.numpy(), np.asarray(ref[2]), 1e-4, "dbias")


@pytest.mark.parametrize("mode", ["0", "dl"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_fused_lm_loss_matches_jax(monkeypatch, mode, smoothing):
    """Value and (dh, demb, dbias) of fused_lm_loss, MIC_TPU_FLASH_CE set to
    the same route on both sides (bf16 hidden, f32 table and bias)."""
    monkeypatch.setenv("MIC_TPU_FLASH_CE", mode)
    b, t, d, v = 2, 16, 128, 997
    h, emb, bias, labels = _inputs(n=b * t, d=d, v=v, seed=3)
    h, labels = h.reshape(b, t, d), labels.reshape(b, t)
    mask = (np.random.default_rng(4).random((b, t)) > 0.2).astype(np.int32)

    def jloss(hh, ee, bb):
        return jax_fused_lm_loss(hh, ee, bb, jnp.asarray(labels), jnp.asarray(mask),
                                 smoothing, 64)

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        _jbf16(h), jnp.asarray(emb), jnp.asarray(bias))
    th = _bf16(h).requires_grad_(True)
    te = torch.from_numpy(emb).requires_grad_(True)
    tb = torch.from_numpy(bias).requires_grad_(True)
    loss = fused_lm_loss(th, te, tb, torch.from_numpy(labels), torch.from_numpy(mask),
                         smoothing, 64)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5, atol=1e-5)
    _close_scaled(th.grad.float().numpy(), np.asarray(jg[0], np.float32), 1 / 128, "dh")
    _close_scaled(te.grad.numpy(), np.asarray(jg[1]), 1e-4, "demb")
    _close_scaled(tb.grad.numpy(), np.asarray(jg[2]), 1e-4, "dbias")


def test_dl_route_with_shadow_table_and_row_cap(monkeypatch):
    """The dl route reads emb_cast (the bf16 shadow) and still sends the f32
    demb to the f32 table; above dl_max_rows its backward takes the chunked
    path, which gives the same gradients."""
    b, t, d, v = 2, 8, 64, 300
    h, emb, bias, labels = _inputs(n=b * t, d=d, v=v, seed=5)
    h, labels = h.reshape(b, t, d), labels.reshape(b, t)
    mask = np.ones((b, t), np.int32)
    grads = []
    for max_rows in (8192, 4):
        th = _bf16(h).requires_grad_(True)
        te = torch.from_numpy(emb).requires_grad_(True)
        tb = torch.from_numpy(bias).requires_grad_(True)
        loss = fused_lm_loss(th, te, tb, torch.from_numpy(labels), torch.from_numpy(mask), 0.1,
                             64, emb_cast=te.detach().bfloat16(), mode="dl",
                             dl_max_rows=max_rows)
        loss.backward()
        assert te.grad.dtype == torch.float32
        grads.append((loss.item(), th.grad.float(), te.grad, tb.grad))
    (l0, *g0), (l1, *g1) = grads
    assert l0 == l1
    for a, c, name in zip(g0, g1, ("dh", "demb", "dbias")):
        _close_scaled(a.numpy(), c.numpy(), 1 / 128 if name == "dh" else 1e-4, name)


@pytest.mark.parametrize("mode", ["fwd", "1", "split", "save"])
def test_unported_modes_raise(mode):
    h = torch.zeros((1, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        fused_lm_loss(h, torch.zeros((10, 64)), torch.zeros(10), torch.zeros((1, 2)),
                      torch.ones((1, 2)), mode=mode)
