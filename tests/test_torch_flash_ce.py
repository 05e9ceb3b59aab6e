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
entry (one bf16 ulp); losses within 1e-5.  The save forward's bf16 logits
are the bf16 rounding of the port's own f32 logits exactly, and within one
bf16 ulp of mic_tpu's (the f32 sums, in another order, can round a tie the
other way); its f32 tail within 1e-5.  The save backward is fed mic_tpu's
own saved logits, so the two sides differ only in summation order.  A
float32 model's routes (float32 hidden states and table on both sides)
hold their statistics and gradients within 1e-5 (1e-5 of the largest
entry), the save route's gradients within 1e-4 (dl is formed from saved
bf16 logits, which the two sides round from f32 sums in other orders).
The CUDA kernels are held to the plain versions in
tests/test_torch_cuda_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mic_tpu.ops import fused_ce as jax_fused_ce
from mic_tpu.ops.flash_ce import flash_ce_backward as jax_backward
from mic_tpu.ops.flash_ce import flash_ce_backward_dl as jax_backward_dl
from mic_tpu.ops.flash_ce import flash_ce_backward_save as jax_backward_save
from mic_tpu.ops.flash_ce import flash_ce_forward as jax_forward
from mic_tpu.ops.fused_ce import fused_lm_loss as jax_fused_lm_loss
from mic_tpu_torch.ops import flash_ce as fce
from mic_tpu_torch.ops import fused_ce
from mic_tpu_torch.ops.flash_ce import (
    _BOX,
    _BWD_MAX_D,
    _CHUNK,
    _ROW_TILE,
    _SAVE_ROWS,
    _VOCAB_TILE,
    _check_backward_args,
    _check_kernel_args,
    _contraction_grid,
    _runs,
    flash_ce_backward,
    flash_ce_backward_dl,
    flash_ce_backward_save,
    flash_ce_forward,
    main_columns,
)
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


def test_forward_plain_f32_matches_jax_kernel():
    """A float32 model's forward (row 7 in f32): mic_tpu's kernel in
    interpret mode on f32 hidden states and table against the plain
    version, lse and label logits within 1e-5, sums of logits within 1e-5
    of the row's sum of |logits| (f32 sums in another order)."""
    h, emb, bias, labels = _inputs(seed=4)
    ref = jax_forward(jnp.asarray(h), jnp.asarray(emb), jnp.asarray(bias), jnp.asarray(labels),
                      True)
    got = flash_ce_forward(torch.from_numpy(h), torch.from_numpy(emb), torch.from_numpy(bias),
                           torch.from_numpy(labels))
    lse, lbl, zsum = (np.asarray(a) for a in ref)
    np.testing.assert_allclose(got[0].numpy(), lse, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), lbl, rtol=1e-5, atol=1e-5)
    logits = h.astype(np.float64) @ emb.astype(np.float64).T + bias
    np.testing.assert_array_less(np.abs(got[2].numpy() - zsum), 1e-5 * np.abs(logits).sum(1))


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_backward_dl_plain_f32_matches_jax_kernel(smoothing):
    """A float32 model's dl route (row 8 in f32, then the dh and demb
    products over the f32 dl): mic_tpu's dl kernel in interpret mode at
    float32 against the plain version, every gradient within 1e-5 of its
    largest entry (f32 throughout; sums in another order)."""
    h, emb, bias, labels = _inputs(seed=5)
    rng = np.random.default_rng(6)
    rowscale = rng.random(h.shape[0]).astype(np.float32) / h.shape[0]
    rowscale[::5] = 0.0
    lse = np.asarray(jax_forward(jnp.asarray(h), jnp.asarray(emb), jnp.asarray(bias),
                                 jnp.asarray(labels), True)[0])
    ref = jax_backward_dl(jnp.asarray(h), jnp.asarray(emb), jnp.asarray(bias),
                          jnp.asarray(labels), jnp.asarray(lse), jnp.asarray(rowscale),
                          smoothing, "float32", True)
    dh, demb, dbias = flash_ce_backward_dl(
        torch.from_numpy(h), torch.from_numpy(emb), torch.from_numpy(bias),
        torch.from_numpy(labels), torch.from_numpy(np.array(lse)), torch.from_numpy(rowscale),
        smoothing)
    assert dh.dtype == demb.dtype == dbias.dtype == torch.float32
    _close_scaled(dh.numpy(), np.asarray(ref[0]), 1e-5, "dh")
    _close_scaled(demb.numpy(), np.asarray(ref[1]), 1e-5, "demb")
    _close_scaled(dbias.numpy(), np.asarray(ref[2]), 1e-5, "dbias")


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


def _loss_matches_jax(monkeypatch, mode, smoothing, h, emb, bias, labels, mask, f32=False,
                      **env):
    """Value and (dh, demb, dbias) of fused_lm_loss, MIC_TPU_FLASH_CE (and
    ``env``) set alike on both sides (bf16 hidden, or float32 where ``f32``;
    f32 table and bias)."""
    monkeypatch.setenv("MIC_TPU_FLASH_CE", mode)
    for key, value in env.items():
        monkeypatch.setenv(key, value)

    def jloss(hh, ee, bb):
        return jax_fused_lm_loss(hh, ee, bb, jnp.asarray(labels), jnp.asarray(mask),
                                 smoothing, 64)

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(h) if f32 else _jbf16(h), jnp.asarray(emb), jnp.asarray(bias))
    th = (torch.from_numpy(h) if f32 else _bf16(h)).requires_grad_(True)
    te = torch.from_numpy(emb).requires_grad_(True)
    tb = torch.from_numpy(bias).requires_grad_(True)
    loss = fused_lm_loss(th, te, tb, torch.from_numpy(labels), torch.from_numpy(mask),
                         smoothing, 64)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5, atol=1e-5)
    assert th.grad.dtype == th.dtype
    grad = 1e-4 if mode == "save" or not f32 else 1e-5
    _close_scaled(th.grad.float().numpy(), np.asarray(jg[0], np.float32),
                  grad if f32 else 1 / 128, "dh")
    _close_scaled(te.grad.numpy(), np.asarray(jg[1]), grad if f32 else 1e-4, "demb")
    _close_scaled(tb.grad.numpy(), np.asarray(jg[2]), grad if f32 else 1e-4, "dbias")


def _loss_inputs(b=2, t=16, d=128, v=997, seed=3):
    h, emb, bias, labels = _inputs(n=b * t, d=d, v=v, seed=seed)
    mask = (np.random.default_rng(seed + 1).random((b, t)) > 0.2).astype(np.int32)
    return h.reshape(b, t, d), emb, bias, labels.reshape(b, t), mask


@pytest.mark.parametrize("mode", ["0", "dl", "fwd", "1", "split", "save",
                                  "1:float32", "split:float32", "save:float32"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_fused_lm_loss_matches_jax(monkeypatch, mode, smoothing):
    """Every flash-CE route, V = 997 (save: a 512-column bf16 span and a
    485-column f32 tail); ":float32" a float32 model's (float32 hidden
    states) on the routes whose float32 kernels are rows 9 and 10 f32."""
    mode, _, dtype = mode.partition(":")
    _loss_matches_jax(monkeypatch, mode, smoothing, *_loss_inputs(), f32=dtype == "float32")


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


@pytest.mark.parametrize("v", [997, 300, 4099])
def test_save_forward_matches_jax(v):
    """The save forward keeps mic_tpu's v_main, its statistics bit-equal to
    the non-saving call's, its main logits the bf16 rounding of its f32
    logits and within one bf16 ulp of mic_tpu's, its tail within 1e-5."""
    h, emb, bias, labels = _inputs(v=v, seed=6)
    ref = jax_forward(_jbf16(h), jnp.asarray(emb), jnp.asarray(bias), jnp.asarray(labels), True,
                      None, True)
    args = (_bf16(h), torch.from_numpy(emb), torch.from_numpy(bias), torch.from_numpy(labels))
    launches = flash_ce_forward.launches, flash_ce_forward.save_launches
    got = flash_ce_forward(*args, None, True)
    plain = flash_ce_forward(*args)
    assert (flash_ce_forward.launches, flash_ce_forward.save_launches) == launches
    assert main_columns(v) == ref[3].shape[1] == got[3].shape[1] > 0
    assert got[3].dtype == torch.bfloat16 and got[4].dtype == torch.float32
    for a, c in zip(got[:3], plain):
        assert torch.equal(a, c)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-5, atol=1e-5)
    v_main = main_columns(v)
    logits = _bf16(h).float() @ torch.from_numpy(emb).bfloat16().float().T + torch.from_numpy(bias)
    assert torch.equal(got[3], logits[:, :v_main].bfloat16())
    jlg = torch.from_numpy(np.asarray(ref[3], np.float32))
    ulp = torch.ldexp(torch.ones_like(jlg), torch.frexp(jlg)[1] - 8)
    assert bool(((got[3].float() - jlg).abs() <= ulp).all())
    np.testing.assert_allclose(got[4].numpy(), np.asarray(ref[4]), rtol=1e-5, atol=1e-5)
    z_l1 = logits.abs().sum(1).numpy()
    np.testing.assert_array_less(np.abs(got[2].numpy() - np.asarray(ref[2])), 1e-4 * z_l1)


def _backward_inputs(v, seed, f32_hidden=False):
    """mic_tpu's save forward on seeded inputs, and a rowscale with zeros:
    (jax h, emb, bias, labels, lse, lg, tail, rowscale) as jax arrays."""
    h, emb, bias, labels = _inputs(v=v, seed=seed)
    rowscale = np.random.default_rng(seed + 1).random(h.shape[0]).astype(np.float32) / h.shape[0]
    rowscale[::5] = 0.0
    jh = jnp.asarray(h) if f32_hidden else _jbf16(h)
    lse, _, _, lg, tail = jax_forward(jh, jnp.asarray(emb), jnp.asarray(bias),
                                      jnp.asarray(labels), True, None, True)
    return jh, jnp.asarray(emb), jnp.asarray(bias), jnp.asarray(labels), lse, lg, tail, \
        jnp.asarray(rowscale)


def _torch(x):
    x = np.asarray(x.astype(jnp.float32)) if x.dtype == jnp.bfloat16 else np.asarray(x)
    return torch.from_numpy(np.array(x))


def _check_grads(got, ref):
    dh, demb, dbias = got
    assert dh.dtype == torch.bfloat16 and demb.dtype == dbias.dtype == torch.float32
    _close_scaled(dh.float().numpy(), np.asarray(ref[0], np.float32), 1 / 128, "dh")
    _close_scaled(demb.numpy(), np.asarray(ref[1]), 1e-4, "demb")
    _close_scaled(dbias.numpy(), np.asarray(ref[2]), 1e-4, "dbias")


@pytest.mark.parametrize("v", [997, 4099])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_backward_save_plain_matches_jax_kernel(v, smoothing):
    """flash_ce_backward_save from mic_tpu's saved logits (bf16 main span of
    512 or 4096 columns, f32 tail) against mic_tpu's kernels."""
    jh, jemb, jbias, jy, lse, lg, tail, rs = _backward_inputs(v, 7)
    ref = jax_backward_save(jh, jemb, jbias, jy, lse, rs, smoothing, "bfloat16", True, None, lg,
                            tail)
    launches = flash_ce_backward_save.launches
    got = flash_ce_backward_save(
        _torch(jh).bfloat16(), _torch(jemb), _torch(jbias), _torch(jy), _torch(lse), _torch(rs),
        smoothing, None, _torch(lg).bfloat16(), _torch(tail))
    assert flash_ce_backward_save.launches == launches
    _check_grads(got, ref)


@pytest.mark.parametrize("v", [997, 4099])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_backward_split_plain_matches_jax_kernel(v, smoothing):
    """flash_ce_backward (the split route) against mic_tpu's grad-W and
    grad-h kernels, which recompute the logits over a ragged vocab."""
    jh, jemb, jbias, jy, lse, _, _, rs = _backward_inputs(v, 9)
    ref = jax_backward(jh, jemb, jbias, jy, lse, rs, smoothing, "bfloat16", True)
    launches = flash_ce_backward.launches
    got = flash_ce_backward(_torch(jh).bfloat16(), _torch(jemb), _torch(jbias), _torch(jy),
                            _torch(lse), _torch(rs), smoothing)
    assert flash_ce_backward.launches == launches
    _check_grads(got, ref)


@pytest.mark.parametrize("v", [997, 4099])
def test_save_forward_f32_matches_jax(v):
    """A float32 model's save forward (row 9's in f32): mic_tpu's kernel in
    interpret mode on float32 hidden states and table against the port, its
    statistics bit-equal to the port's non-saving call, lse and label
    logits within 1e-5 of mic_tpu's; the main span bf16 (mic_tpu saves
    bf16 at float32 too), the bf16 rounding of the port's f32 logits and
    within one bf16 ulp of mic_tpu's; the f32 tail within 1e-5."""
    h, emb, bias, labels = _inputs(v=v, seed=16)
    ref = jax_forward(jnp.asarray(h), jnp.asarray(emb), jnp.asarray(bias), jnp.asarray(labels),
                      True, None, True)
    args = tuple(torch.from_numpy(a) for a in (h, emb, bias, labels))
    got = flash_ce_forward(*args, None, True)
    plain = flash_ce_forward(*args)
    assert all(torch.equal(a, c) for a, c in zip(got[:3], plain))
    assert got[3].dtype == torch.bfloat16 and got[4].dtype == torch.float32
    assert got[3].shape == ref[3].shape and np.asarray(ref[3]).dtype == jnp.bfloat16
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-5, atol=1e-5)
    v_main = main_columns(v)
    logits = args[0] @ args[1].T + args[2]
    assert torch.equal(got[3], logits[:, :v_main].bfloat16())
    jlg = torch.from_numpy(np.asarray(ref[3], np.float32))
    ulp = torch.ldexp(torch.ones_like(jlg), torch.frexp(jlg)[1] - 8)
    assert bool(((got[3].float() - jlg).abs() <= ulp).all())
    np.testing.assert_allclose(got[4].numpy(), np.asarray(ref[4]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("v", [997, 4099])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_backward_save_plain_f32_matches_jax_kernel(v, smoothing):
    """A float32 model's save backward (row 9's in f32) from mic_tpu's own
    saved logits against mic_tpu's kernels in interpret mode at
    out_dtype_name "float32": dh float32, every gradient within 1e-5 of its
    largest entry (dl formed in f32 from the same bf16 logits; f32 sums in
    another order)."""
    jh, jemb, jbias, jy, lse, lg, tail, rs = _backward_inputs(v, 17, f32_hidden=True)
    ref = jax_backward_save(jh, jemb, jbias, jy, lse, rs, smoothing, "float32", True, None, lg,
                            tail)
    launches = flash_ce_backward_save.launches
    got = flash_ce_backward_save(
        _torch(jh), _torch(jemb), _torch(jbias), _torch(jy), _torch(lse), _torch(rs),
        smoothing, None, _torch(lg).bfloat16(), _torch(tail))
    assert flash_ce_backward_save.launches == launches
    assert all(g.dtype == torch.float32 for g in got) and np.asarray(ref[0]).dtype == np.float32
    for a, c, name in zip(got, ref, ("dh", "demb", "dbias")):
        _close_scaled(a.numpy(), np.asarray(c), 1e-5, name)


@pytest.mark.parametrize("v", [997, 4099])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_backward_split_plain_f32_matches_jax_kernel(v, smoothing):
    """A float32 model's split route (row 10 in f32) against mic_tpu's
    grad-W and grad-h kernels in interpret mode at out_dtype_name "float32",
    which recompute the f32 logits over a ragged vocab: dh float32, every
    gradient within 1e-5 of its largest entry."""
    jh, jemb, jbias, jy, lse, _, _, rs = _backward_inputs(v, 19, f32_hidden=True)
    ref = jax_backward(jh, jemb, jbias, jy, lse, rs, smoothing, "float32", True)
    launches = flash_ce_backward.launches
    got = flash_ce_backward(_torch(jh), _torch(jemb), _torch(jbias), _torch(jy), _torch(lse),
                            _torch(rs), smoothing)
    assert flash_ce_backward.launches == launches
    assert all(g.dtype == torch.float32 for g in got) and np.asarray(ref[0]).dtype == np.float32
    for a, c, name in zip(got, ref, ("dh", "demb", "dbias")):
        _close_scaled(a.numpy(), np.asarray(c), 1e-5, name)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_save_all_tail_vocab(monkeypatch, smoothing):
    """V below the smallest vocab chunk (128): v_main is 0, the forward saves
    only the f32 tail and the backward is exact f32 over it, as mic_tpu's
    test_save_all_tail_vocab has it; loss and gradients against mic_tpu's."""
    jh, jemb, jbias, jy, lse, lg, tail, rs = _backward_inputs(97, 11)
    assert main_columns(97) == lg.shape[1] == 0 and tail.shape == (32, 97)
    got = flash_ce_forward(_torch(jh).bfloat16(), _torch(jemb), _torch(jbias), _torch(jy),
                           None, True)
    assert got[3].shape == (32, 0) and got[4].shape == (32, 97)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(tail), rtol=1e-5, atol=1e-5)
    ref = jax_backward_save(jh, jemb, jbias, jy, lse, rs, smoothing, "bfloat16", True, None, lg,
                            tail)
    grads = flash_ce_backward_save(
        _torch(jh).bfloat16(), _torch(jemb), _torch(jbias), _torch(jy), _torch(lse), _torch(rs),
        smoothing, None, got[3], _torch(tail))
    _check_grads(grads, ref)
    _loss_matches_jax(monkeypatch, "save", smoothing, *_loss_inputs(v=97, seed=12))


def test_save_degrades_to_chunked_above_row_cap(monkeypatch):
    """Above dl_max_rows the save route saves nothing: the forward keeps lse
    and no logits (mic_tpu's test_save_degrades_to_dl_above_row_cap), and the
    backward takes the chunked path; loss and gradients as mic_tpu's under
    the same cap, and as the chunked route's."""
    h, emb, bias, labels, mask = _loss_inputs()
    n = labels.size
    args = (_bf16(h).reshape(n, -1), torch.from_numpy(emb), torch.from_numpy(bias),
            torch.from_numpy(labels).reshape(n), torch.from_numpy(mask).reshape(n).float(), 0.1, 64,
            None)
    _, lse, saved = fused_ce._forward(*args, "save", 16)
    assert lse is not None and saved is None
    _, _, saved = fused_ce._forward(*args, "save", 32)
    assert saved is not None and saved[0].shape == (n, 512)
    *_, jlse, jsaved = jax_fused_ce._fwd_impl(
        _jbf16(h), jnp.asarray(emb), jnp.asarray(bias), jnp.asarray(labels), jnp.asarray(mask),
        0.1, 64, None, "save", dl_max_rows=16)
    assert jsaved is None and jlse is not None
    _loss_matches_jax(monkeypatch, "save", 0.1, h, emb, bias, labels, mask,
                      MIC_TPU_DL_MAX_ROWS="16")
    _loss_matches_jax(monkeypatch, "0", 0.1, h, emb, bias, labels, mask)


H100_SMS = 132


@pytest.mark.parametrize("v", [997, 4099, 250054])
@pytest.mark.parametrize("n", [1, 64, 129, 4096])
def test_walk_runs_cover_every_tile_once(n, v):
    """The walk of csrc/flash_ce.cu as the wrappers size it (128-row tiles,
    256-wide vocab tiles, _runs on an H100's 132 SMs): the grid's row tiles
    cover the N rows, and the dl kernel's bands are those row tiles; run y
    walks tiles [y T / runs, (y + 1) T / runs) of the T vocab tiles, so the
    runs (at most one a tile) take every tile once, in order; the blocks fit
    one wave wherever the row tiles leave SMs over."""
    assert (_ROW_TILE, _VOCAB_TILE) == (128, 256)
    ntiles = -(-v // _VOCAB_TILE)
    row_tiles = -(-n // _ROW_TILE)
    assert (row_tiles - 1) * _ROW_TILE < n <= row_tiles * _ROW_TILE
    runs = _runs(n, v, H100_SMS)
    assert 1 <= runs <= ntiles
    assert row_tiles * runs <= max(H100_SMS, row_tiles)
    bounds = [(y * ntiles // runs, (y + 1) * ntiles // runs) for y in range(runs)]
    assert all(b < e for b, e in bounds)
    walked = [tile for b, e in bounds for tile in range(b, e)]
    assert walked == list(range(ntiles))
    assert bounds[-1][1] * _VOCAB_TILE >= v > (bounds[-1][1] - 1) * _VOCAB_TILE


def test_walk_runs_at_the_flagship_shapes():
    """32 row tiles of the flagship step (N = 4096) leave room for four runs
    (128 of 132 SMs); one row tile takes a run an SM; past 132 row tiles one
    run."""
    assert _runs(4096, 250054, H100_SMS) == 4
    assert _runs(1, 250054, H100_SMS) == 132
    assert _runs(129, 250054, H100_SMS) == 66
    assert _runs(64, 997, H100_SMS) == 4
    assert _runs(132 * 128 + 1, 250054, H100_SMS) == 1


@pytest.mark.parametrize("v", [257, 997, 4099, 250054])
@pytest.mark.parametrize("n", [1, 70, 129, 4096, 132 * 128 + 1])
def test_f32_walk_runs_fill_the_card(n, v):
    """The float32 walk of csrc/flash_ce_f32.cu as the wrappers size it
    (128-row blocks, 128-wide vocab tiles, one block an SM, _runs on an
    H100's 132 SMs): at least one run, never more runs than vocab tiles;
    the (row tiles, runs) blocks fit one wave wherever the row tiles leave
    SMs over, and fill it: another run would not fit, unless every tile
    has its own run; run y's tiles [y T / runs, (y + 1) T / runs) take
    every tile once, in order."""
    ntiles = -(-v // 128)
    row_tiles = -(-n // _ROW_TILE)
    runs = _runs(n, v, H100_SMS, 128)
    assert 1 <= runs <= ntiles
    assert row_tiles * runs <= max(H100_SMS, row_tiles)
    assert runs == ntiles or row_tiles * (runs + 1) > H100_SMS
    bounds = [(y * ntiles // runs, (y + 1) * ntiles // runs) for y in range(runs)]
    assert all(b < e for b, e in bounds)
    assert [tile for b, e in bounds for tile in range(b, e)] == list(range(ntiles))


def test_f32_walk_runs_at_the_flagship_shapes():
    """The flagship step's 32 row tiles take four runs (128 of 132 SMs);
    one row tile a run an SM; 129 rows 66 runs; V = 997 has 8 tiles."""
    assert _runs(4096, 250054, H100_SMS, 128) == 4
    assert _runs(1, 250054, H100_SMS, 128) == 132
    assert _runs(129, 250054, H100_SMS, 128) == 66
    assert _runs(129, 997, H100_SMS, 128) == 8
    assert _runs(132 * 128 + 1, 250054, H100_SMS, 128) == 1


_LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)


def _tf32_trunc(x):
    """float32 x with its low 13 mantissa bits dropped (TF32 by truncation:
    the walk's hi, and what the tensor core reads of any f32 operand)."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _toward_zero(y):
    """float64 y as the float32 next to it on the side of zero."""
    f = y.float()
    return torch.where(f.double().abs() > y.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def _walk_logits(h, w, b, products=3):
    """s = h @ w^T + b as csrc/flash_ce_f32.cu's walk computes it: each
    operand split into hi (truncated to TF32) and lo = x - hi; per 32-deep
    slice the tensor core's products table-lo . hidden-hi, table-hi .
    hidden-lo, table-hi . hidden-hi, each k8 step exact and added to the
    slice's sum with float32 truncation (a model of the tensor core's
    accumulation); each slice's sum added to the logits by a float32 add,
    in depth order; then the bias.  ``products=1`` keeps hi . hi alone."""
    hh, wh = _tf32_trunc(h), _tf32_trunc(w)
    hl, wl = _tf32_trunc(h - hh), _tf32_trunc(w - wh)
    terms = ((wl, hh), (wh, hl), (wh, hh))[3 - products:]
    acc = torch.zeros((h.shape[0], w.shape[0]), dtype=torch.float32)
    for k0 in range(0, h.shape[1], 32):
        part = torch.zeros_like(acc, dtype=torch.float64)
        for k in range(k0, min(k0 + 32, h.shape[1]), 8):
            for a, c in terms:
                prod = c[:, k:k + 8].double() @ a[:, k:k + 8].double().T
                part = _toward_zero(part + prod).double()
        acc = acc + part.float()
    return acc + b


def _merge(a, b):
    """The walk's merge of two (max, sum of exps against it, sum) states."""
    (m1, s1, z1), (m2, s2, z2) = a, b
    hi = torch.maximum(m1, m2)
    e = torch.exp2((torch.minimum(m1, m2) - hi) * _LOG2E)
    return hi, torch.where(m1 >= m2, s1 + s2 * e, s2 + s1 * e), z1 + z2


def _walk_statistics(x, runs):
    """(lse, sum of logits) of the float32 logits x (N, V) in the walk's
    order: per 128-wide vocab tile a thread's pair of table rows (v0, v0 +
    8), the reduce-scatter over the warp's row groups (g with g ^ 4, then
    g ^ 2, then g ^ 1), each warp's running state over its run's tiles, the
    eight warps in order, then the runs in order (csrc/ce_reduce.cuh)."""
    n, v = x.shape
    ntiles = -(-v // 128)
    floor = torch.tensor(-1e30)
    parts = []
    for y in range(runs):
        state = None
        for tile in range(y * ntiles // runs, (y + 1) * ntiles // runs):
            xt = torch.zeros((n, 128))
            ok = torch.arange(tile * 128, tile * 128 + 128) < v
            xt[:, ok] = x[:, tile * 128:(tile + 1) * 128]
            # vocab row 64 wg + 16 w + 8 h + g -> (N, wg, w, h, g)
            xt, ok = xt.view(n, 2, 4, 2, 8), ok.view(2, 4, 2, 8)
            x0, x1, ok0, ok1 = xt[:, :, :, 0], xt[:, :, :, 1], ok[:, :, 0], ok[:, :, 1]
            hi = torch.maximum(x0, x1)
            two = 1 + torch.exp2((torch.minimum(x0, x1) - hi) * _LOG2E)
            cell = (torch.where(ok1, hi, torch.where(ok0, x0, floor)),
                    torch.where(ok1, two, ok0.float()),
                    torch.where(ok1, x0 + x1, torch.where(ok0, x0, 0.0)))
            for half in (4, 2, 1):  # lane bits 16, 8, 4: g merged with g ^ half
                cell = _merge(tuple(c[..., :half] for c in cell),
                              tuple(c[..., half:2 * half] for c in cell))
            cell = tuple(c[..., 0].reshape(n, 8) for c in cell)  # (N, warp 4 wg + w)
            state = cell if state is None else _merge(state, cell)
        warp = tuple(c[:, 0] for c in state)
        for i in range(1, 8):
            warp = _merge(warp, tuple(c[:, i] for c in state))
        parts.append(warp)
    m = torch.stack([p[0] for p in parts]).max(0).values
    s, z = torch.zeros(n), torch.zeros(n)
    for pm, ps, pz in parts:
        s = s + ps * torch.exp(pm - m)
        z = z + pz
    return m + torch.log(s), z


def _walk_dl(x, lse, rowscale, labels, low, conf_low):
    """dl and dbias from the float32 logits x (N, V) as the walk forms them:
    p = 2^(x log2 e - lse log2 e) (one fma), (p - target) * rowscale; the
    band's sum of a column over its 128 rows: a thread's 32 rows (8 i + 2 t
    + e, i then e), then its quad (t with t ^ 1, then t ^ 2); the bands in
    order."""
    n, v = x.shape
    nl = (-lse * _LOG2E)[:, None]
    p = torch.exp2((x.double() * _LOG2E.double() + nl.double()).float())
    target = torch.full_like(x, low)
    target.scatter_(1, labels[:, None].long(), low + conf_low)
    dl = (p - target) * rowscale[:, None]
    dbias = torch.zeros(v)
    for r0 in range(0, n, 128):
        band = torch.zeros((128, v))
        band[:min(128, n - r0)] = dl[r0:r0 + 128]
        rows = band.view(16, 4, 2, v)  # (i, t, e)
        quad = torch.zeros((4, v))
        for i in range(16):
            for e in range(2):
                quad = quad + rows[i, :, e]
        dbias = dbias + ((quad[0] + quad[1]) + (quad[2] + quad[3]))
    return dl, dbias


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_3xtf32_walk_keeps_the_card_tolerances(smoothing):
    """An emulation of the float32 CE walks' arithmetic (rows 7 and 8 f32,
    csrc/flash_ce_f32.cu) at D = 1024 with the card test's value scales (h
    ~ N(0, 1), W ~ 0.05 N(0, 1), bias ~ 0.1 N(0, 1); V = 1000 over eight
    128-wide tiles, the last ragged, in two runs; N = 200 over two row
    bands), held against float64: lse within 1e-5 relative, the sum of
    logits within 1e-5 of the row's sum of |logits|, dl within 1e-4 of
    |dl| + 2 target rowscale, dbias within 1e-5 of its largest entry
    (tests/test_torch_cuda_kernels.py::test_flash_ce_f32_kernels_match_plain's
    limits).  The walk's own error stays a tenth of those limits; one TF32
    product alone (hi . hi) misses the lse limit."""
    rng = np.random.default_rng(24)
    n, d, v = 200, 1024, 1000
    h = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(v, d)) * 0.05).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=(v,)) * 0.1).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, v, size=(n,)).astype(np.int32))
    rowscale = torch.from_numpy((rng.random(n) / n).astype(np.float32))
    rowscale[::7] = 0.0
    exact = h.double() @ w.double().T + b.double()
    lse64 = torch.logsumexp(exact, -1)
    l1 = exact.abs().sum(-1)

    x = _walk_logits(h, w, b)
    lse, zsum = _walk_statistics(x, runs=2)
    lse_err = ((lse.double() - lse64).abs() / lse64.abs()).max().item()
    z_err = ((zsum.double() - exact.sum(-1)).abs() / l1).max().item()
    assert lse_err < 1e-6 and z_err < 1e-6, (lse_err, z_err)

    low, conf_low = fce._targets(smoothing, v)
    dl, dbias = _walk_dl(x, lse64.float(), rowscale, labels, low, conf_low)
    target = torch.full_like(exact, low)
    target.scatter_(1, labels[:, None].long(), low + conf_low)
    dl64 = (torch.exp(exact - lse64[:, None]) - target) * rowscale.double()[:, None]
    assert not dl[rowscale == 0].any()
    limit = 1e-4 * (dl64.abs() + 2 * target * rowscale.double()[:, None])
    assert bool(((dl.double() - dl64).abs() <= 0.1 * limit).all())
    db_err = (dbias.double() - dl64.sum(0)).abs().max().item() / dl64.sum(0).abs().max().item()
    assert db_err < 1e-6, db_err

    one = _walk_statistics(_walk_logits(h, w, b, products=1), runs=2)[0]
    assert ((one.double() - lse64).abs() / lse64.abs()).max().item() > 1e-5


@pytest.mark.parametrize("case", ["float32", "float32_save_split", "float16", "d96", "d32",
                                  "table_width", "f32_d98"])
def test_kernel_arguments_raise_as_before(case):
    """What the CUDA kernels do not take raises before any launch; float32
    hidden states pass for every route's kernels (rows 7-10, any D a
    multiple of 4: the save and split routes' too, float32's D gate left
    at 4 and the split route's at no bound); another dtype raises
    TypeError; D off the tiles (64 in bf16, ROADMAP B36b; 4 in f32) or a
    table of another width ValueError."""
    n, d, v = 8, 128, 997
    h = torch.zeros((n, d), dtype=torch.bfloat16)
    w = torch.zeros((v, d), dtype=torch.bfloat16)
    bias = torch.zeros((v,), dtype=torch.float32)
    if case == "float32":
        _check_kernel_args("flash_ce_forward", h.float(), w.float(), bias)
        _check_kernel_args("flash_ce_dl", h.float()[:, :100], w.float()[:, :100], bias)
        return
    if case == "float32_save_split":
        for name in ("flash_ce_forward", "flash_ce_backward", "flash_ce_backward_save"):
            _check_kernel_args(name, h.float(), w.float(), bias)
            _check_kernel_args(name, h.float()[:, :100], w.float()[:, :100], bias)
            for split in (True, False):
                wide = torch.zeros((n, 1088)), torch.zeros((v, 1088))
                _check_backward_args(name, *wide, bias, split=split)
            with pytest.raises(ValueError, match="multiple of 4"):
                _check_kernel_args(name, h.float()[:, :98], w.float()[:, :98], bias)
            with pytest.raises(TypeError):
                _check_kernel_args(name, h.half(), w.half(), bias)
        return
    want = ValueError
    if case == "float16":
        h, w, want = h.half(), w.half(), TypeError
    elif case in ("d96", "d32"):
        d = int(case[1:])
        h, w = h[:, :d], w[:, :d]
    elif case == "f32_d98":
        h, w = h.float()[:, :98], w.float()[:, :98]
    else:
        w = w[:, :64]
    with pytest.raises(want, match="B36b" if case in ("d96", "d32") else None):
        _check_kernel_args("flash_ce_forward", h, w, bias)


def _contraction_blocks(part, saved, n, vext, d, sms):
    """What each block of a contraction kernel owns, as csrc/flash_ce.cu's
    save_kernel and split_kernel compute it from (blockIdx, gridDim): per
    consumer warpgroup that writes, its output rows, D chunk and sweep
    steps (warpgroups whose rows lie wholly past the end left out)."""
    dblocks, tiles, parts = _contraction_grid(part, saved, n, vext, d, sms)
    chunks = -(-d // _CHUNK)
    m, k = (n, vext) if part == "grad_h" else (vext, n)
    steps = -(-k // _BOX)
    for z in range(parts):
        sweep = range(z * steps // parts, (z + 1) * steps // parts)
        for y in range(tiles):
            for x in range(dblocks):
                if saved:  # the second warpgroup's rows may lie past the end
                    for wg in (0, 1):
                        r0 = y * _SAVE_ROWS + 64 * wg
                        rows = range(r0, min(r0 + 64, m))
                        if len(rows):
                            yield rows, x, sweep
                else:
                    c1 = min(2 * x + 1, chunks - 1)
                    rows = range(y * _BOX, min(y * _BOX + _BOX, m))
                    yield rows, 2 * x, sweep
                    if c1 != 2 * x:
                        yield rows, c1, sweep


@pytest.mark.parametrize("d", [64, 192, 1024])
@pytest.mark.parametrize("n", [1, 64, 129, 4096])
@pytest.mark.parametrize("saved", [False, True], ids=["split", "save"])
@pytest.mark.parametrize("part", ["grad_h", "grad_w"])
def test_contraction_grid_covers_every_output_tile_once(part, saved, n, d):
    """The backward contractions' grid as _contraction_grid sizes it on an
    H100's 132 SMs, at the flagship vocab (vext = V for split, v_main for
    save): every (output row, D chunk, sweep step) is taken exactly once
    over the blocks' writing warpgroups, so each output entry is one sum
    (over parts, summed in part order); grad-h fills the SMs its row tiles
    leave (one wave wherever they leave SMs over) and grad-W has one part."""
    v = 250054
    vext = main_columns(v) if saved else v
    m, k = (n, vext) if part == "grad_h" else (vext, n)
    chunks, steps = -(-d // _CHUNK), -(-k // _BOX)
    seen = np.zeros((m, chunks, steps), np.int32)
    for rows, chunk, sweep in _contraction_blocks(part, saved, n, vext, d, H100_SMS):
        assert len(rows) and len(sweep)
        seen[rows.start:rows.stop, chunk, sweep.start:sweep.stop] += 1
    assert bool((seen == 1).all())
    dblocks, tiles, parts = _contraction_grid(part, saved, n, vext, d, H100_SMS)
    if part == "grad_w":
        assert parts == 1
    else:
        assert 1 <= parts <= steps and dblocks * tiles * parts <= max(H100_SMS, dblocks * tiles)


def test_contraction_grid_at_the_flagship_step():
    """At N = 4096, D = 1024: grad-h is 128 blocks either way (split: 64
    row tiles x 2 D blocks; save: 32 x 4), one part; grad-W is a block per
    64 vocab rows and D block (split) or 128 and D chunk (save)."""
    v = 250054
    v_main = main_columns(v)
    assert _contraction_grid("grad_h", False, 4096, v, 1024, H100_SMS) == (2, 64, 1)
    assert _contraction_grid("grad_h", True, 4096, v_main, 1024, H100_SMS) == (4, 32, 1)
    assert _contraction_grid("grad_w", False, 4096, v, 1024, H100_SMS) == (2, 3908, 1)
    assert _contraction_grid("grad_w", True, 4096, v_main, 1024, H100_SMS) == (4, 1952, 1)
    assert _contraction_grid("grad_h", False, 64, v, 1024, H100_SMS) == (2, 1, 66)


@pytest.mark.parametrize("case", ["float32", "d96", "split_d1088", "save_d1088"])
def test_backward_arguments_raise(case):
    """The backward kernels take bfloat16 with D a multiple of 64 and
    float32 with D a multiple of 4 (ValueError otherwise); the bf16 split
    contractions hold 64 rows over the whole D and stop at _BWD_MAX_D
    (ValueError past it naming ROADMAP B36b), the bf16 save contractions
    take any such D, and the float32 ones (which stream D) any D on both
    routes, 1088 and 100 too."""
    n, v = 8, 997
    d = 1088 if case.endswith("1088") else 96 if case == "d96" else 128
    h = torch.zeros((n, d), dtype=torch.bfloat16)
    w = torch.zeros((v, d), dtype=torch.bfloat16)
    bias = torch.zeros((v,), dtype=torch.float32)
    assert _BWD_MAX_D == 1024
    if case == "save_d1088":
        _check_backward_args("flash_ce_backward_save", h, w, bias, split=False)
        return
    if case == "float32":
        for dd in (128, 100, 1088):
            hf, wf = torch.zeros((n, dd)), torch.zeros((v, dd))
            for split in (True, False):
                _check_backward_args("flash_ce_backward", hf, wf, bias, split=split)
        for split in (True, False):
            with pytest.raises(ValueError, match="multiple of 4"):
                _check_backward_args("flash_ce_backward", h.float()[:, :98], w.float()[:, :98],
                                     bias, split=split)
        return
    for split in ((True,) if case == "split_d1088" else (True, False)):
        with pytest.raises(ValueError, match="B36b"):
            _check_backward_args("flash_ce_backward", h, w, bias, split=split)
