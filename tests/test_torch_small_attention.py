"""The port's small-T attention (ops/small_attention.py) and the attention
gate (ops/attention.py::dot_product_attention) against mic_tpu.

On the CPU the port's wrappers run their plain versions; mic_tpu's
small_t_attention runs its Pallas kernels in interpret mode (as
tests/test_small_attention.py runs them), forward and backward, on the
same numpy inputs.  Every row is compared, fully masked ones too: both
sides send such a row to key 0.  Tolerances: float32 within 1e-5 (values)
or 1e-5 of a gradient's largest entry (f32 sums in another order);
bfloat16 outputs within 1e-2 absolute (inputs of size 0.3-1: a softmax
weight rounded to bf16 the other way, plus the output's own bf16 rounding,
moves an output by about 4e-3) and gradients within 2e-2 of their largest
entry (each side rounds dq, dk, dv once to bf16 from f32 sums in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mic_tpu.ops.attention as jax_attention
import mic_tpu.ops.flash_attention as jax_flash
import mic_tpu.ops.small_attention as jax_small
from mic_tpu_torch.ops import attention, small_attention

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(b, t, h, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(b, t, h, 64)) * s).astype(np.float32) for s in (0.3, 0.3, 1.0)]


def _mask(case, b, t, seed):
    """bool (B, 1, T, T) or None: causal with right padding (the decoder),
    padding only (an encoder), none (vision), causal with left padding
    (fully masked rows: a query before its row's first real token sees
    no key)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, t + 1, b)
    lengths[0] = t
    pos = np.arange(t)
    causal = np.tril(np.ones((t, t), bool))
    if case == "none":
        return None
    if case == "causal_pad":
        return causal[None, None] & (pos[None] < lengths[:, None])[:, None, None, :]
    if case == "pad_only":
        pad = (pos[None] < lengths[:, None])[:, None, None, :]
        return np.broadcast_to(pad, (b, 1, t, t)).copy()
    assert case == "left_pad"
    lengths[1] = t // 2
    return causal[None, None] & (pos[None] >= t - lengths[:, None])[:, None, None, :]


CASES = {  # name -> (B, T, H, mask)
    "decoder_causal_pad": (4, 64, 2, "causal_pad"),
    "encoder_pad_only": (4, 64, 2, "pad_only"),
    "vision_t50": (2, 50, 3, "none"),
    "fully_masked_rows": (4, 64, 2, "left_pad"),
    "odd_batch": (3, 64, 2, "causal_pad"),
    "ragged_t": (3, 13, 2, "causal_pad"),
    "single_t": (3, 1, 2, "causal_pad"),       # one query, one key
    "t63_tile_edge": (3, 63, 2, "causal_pad"),  # one row and key short of a 64 tile
}


def _both(case, dtype, seed=0):
    b, t, h, mask_case = CASES[case]
    jdt, tdt = DTYPES[dtype]
    arrays = _qkv(b, t, h, seed)
    mask = _mask(mask_case, b, t, seed + 1)
    jax_side = [jnp.asarray(a).astype(jdt) for a in arrays]
    torch_side = [torch.from_numpy(a).to(tdt) for a in arrays]
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    return jax_side, jmask, torch_side, tmask


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if isinstance(x, jax.Array) \
        else x.detach().float().numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_mic_tpu_kernel(case, dtype):
    (jq, jk, jv), jmask, (q, k, v), mask = _both(case, dtype)
    assert small_attention.supports(q, k, v, mask, 0.0, False)
    ref = jax_small.small_t_attention(jq, jk, jv, jmask, interpret=True)
    got = small_attention.small_t_attention(q, k, v, mask)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=0, atol=1e-2)
    np.testing.assert_allclose(_f32(got), _f32(ref), **tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_grads_match_mic_tpu_kernel(case, dtype):
    """d/d(q, k, v) of sum(out * w), w from numpy: mic_tpu's backward kernel
    (interpret mode) against the port's plain backward through autograd."""
    (jq, jk, jv), jmask, (q, k, v), mask = _both(case, dtype, seed=5)
    w = np.random.default_rng(9).normal(size=q.shape).astype(np.float32)

    def loss(q, k, v):
        out = jax_small.small_t_attention(q, k, v, jmask, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * w)

    ref = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = small_attention.small_t_attention(*leaves, mask)
    got = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(), leaves)
    frac = 1e-5 if dtype == "float32" else 2e-2
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == q.dtype, name
        a, b = _f32(a), _f32(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=frac * np.abs(b).max(), err_msg=name)


def test_backward_plain_is_the_kernel_algebra():
    """The plain backward recomputes p from q, k, v: dv from the bf16 p,
    ds from the f32 p.  Rounding p before dv moves dv off the f32-p value
    (the rounding is there), and a fully masked row attends key 0 only."""
    (_, _, _), _, (q, k, v), mask = _both("fully_masked_rows", "bfloat16", seed=7)
    bias = small_attention.mask_bias(mask, q.shape[0], q.shape[1])
    assert torch.equal(bias[1, 0], torch.cat([torch.zeros(1), torch.full((63,), torch.finfo(
        torch.float32).min)]))
    out = small_attention.small_t_attention_plain(q, k, v, bias)
    assert torch.equal(out[1, 0], v[1, 0])          # key 0's value
    do = torch.ones_like(q)
    dq, dk, dv = small_attention.small_t_attention_bwd_plain(q, k, v, bias, do)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) + bias[:, None]
    p = torch.softmax(s, dim=-1)
    dv_f32 = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    assert not torch.equal(dv, dv_f32.bfloat16())
    dv16 = torch.einsum("bhqk,bqhd->bkhd", p.bfloat16().float(), do.float()).bfloat16()
    assert torch.equal(dv, dv16)


def _bf16_ulp(x):
    """One bf16 unit in the last place of each entry's size (f32 tensor)."""
    _, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), (e - 8).clamp(min=-133))


def _hi_lo_backward(q, k, v, bias, do):
    """The card's bf16 backward in torch arithmetic: p and dS in f32, dS
    carried into dq = dS k and dk = dS^T q as bf16 hi + lo (hi = bf16(dS),
    lo = bf16(dS - hi)), each product of bf16 values exact in f32, dv from
    round(p); -> (dq, dk, dv) in bf16 and the sizes of dq's and dk's terms,
    sum_k |dS| |k| and sum_q |dS| |q|."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    p = torch.softmax(s if bias is None else s + bias[:, None], dim=-1)
    dof = do.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    hi = ds.bfloat16().float()
    lo = (ds - hi).bfloat16().float()
    dq = (torch.einsum("bhqk,bkhd->bqhd", hi, k.float())
          + torch.einsum("bhqk,bkhd->bqhd", lo, k.float()))
    dk = (torch.einsum("bhqk,bqhd->bkhd", hi, q.float())
          + torch.einsum("bhqk,bqhd->bkhd", lo, q.float()))
    dv = torch.einsum("bhqk,bqhd->bkhd", p.bfloat16().float(), dof)
    terms = (torch.einsum("bhqk,bkhd->bqhd", ds.abs(), k.float().abs()),
             torch.einsum("bhqk,bqhd->bkhd", ds.abs(), q.float().abs()))
    return (dq.bfloat16(), dk.bfloat16(), dv.bfloat16()), terms


@pytest.mark.parametrize("case", sorted(CASES))
def test_hi_lo_split_of_ds_matches_mic_tpu_kernel(case):
    """The bf16 backward kernel's arithmetic (dS as bf16 hi + lo into dq and
    dk) against mic_tpu's interpret-mode _bwd_kernel, which multiplies the
    f32 dS: dq and dk within one bf16 ulp of the size of their terms (the
    two differ by dS's 2^-17 and the order of f32 sums, then round once),
    dv equal but for that order; and at most 1e-2 of dq's and dk's entries
    not bit-equal to mic_tpu's (measured: up to 2.6e-3).  dS rounded once
    to bf16 instead stays within the ulp (2^-9 of each term is under an ulp
    of their sum) but moves 0.24-0.41 of dq's entries."""
    (jq, jk, jv), jmask, (q, k, v), mask = _both(case, "bfloat16", seed=13)
    do_np = np.random.default_rng(14).normal(size=q.shape).astype(np.float32)
    jdo, do = jnp.asarray(do_np).astype(jnp.bfloat16), torch.from_numpy(do_np).bfloat16()
    _, vjp = jax.vjp(lambda a, b, c: jax_small.small_t_attention(a, b, c, jmask, interpret=True),
                     jq, jk, jv)
    ref = [torch.from_numpy(_f32(x)) for x in vjp(jdo)]
    bias = small_attention.mask_bias(mask, q.shape[0], q.shape[1])
    got, terms = _hi_lo_backward(q, k, v, bias, do)
    for name, a, b, size in zip(("dq", "dk"), got, ref, terms):
        err = (a.float() - b).abs()
        assert not (err > _bf16_ulp(size)).any(), (name, float(err.max()))
        assert (a.float() != b).float().mean().item() <= 1e-2, name
    torch.testing.assert_close(got[2].float(), ref[2], rtol=0, atol=2e-2 * float(ref[2].abs().max()))


SHAPES = [  # (B, Tq, Tk, H, Dh, dtypes, mask shape)
    (2, 64, 64, 2, 64, ("float32",) * 3, (2, 1, 64, 64)),
    (2, 50, 50, 12, 64, ("bfloat16",) * 3, None),
    (2, 1, 1, 2, 64, ("float32",) * 3, None),
    (2, 65, 65, 2, 64, ("float32",) * 3, None),         # T > 64
    (2, 64, 50, 2, 64, ("float32",) * 3, None),         # Tq != Tk (cross-attention)
    (2, 50, 50, 2, 64, ("float32",) * 3, (2, 1, 1, 50)),  # a broadcast padding mask
    (2, 64, 64, 4, 32, ("float32",) * 3, None),         # Dh != 64
    (2, 64, 64, 2, 64, ("float32",) * 3, (2, 64, 64)),   # a 3-d mask
    (2, 64, 64, 2, 64, ("float32",) * 3, (2, 2, 64, 64)),  # a per-head mask
    (2, 64, 64, 2, 64, ("float32", "bfloat16", "float32"), None),  # mixed dtypes
]


@pytest.mark.parametrize("shape", range(len(SHAPES)))
def test_supports_matches_mic_tpu(shape):
    b, tq, tk, h, dh, dtypes, mask_shape = SHAPES[shape]
    jax_side = [jnp.zeros((b, t, h, dh), DTYPES[d][0]) for t, d in zip((tq, tk, tk), dtypes)]
    torch_side = [torch.zeros((b, t, h, dh), dtype=DTYPES[d][1])
                  for t, d in zip((tq, tk, tk), dtypes)]
    jmask = None if mask_shape is None else jnp.ones(mask_shape, bool)
    tmask = None if mask_shape is None else torch.ones(mask_shape, dtype=torch.bool)
    for dropout, weights in ((0.0, False), (0.1, False), (0.0, True)):
        assert (small_attention.supports(*torch_side, tmask, dropout, weights)
                == jax_small.supports(*jax_side, jmask, dropout, weights))


def _mic_tpu_branch(monkeypatch, backend, q, k, v, mask, impl, rate, rng, weights):
    """The branch mic_tpu's dot_product_attention takes on ``backend``, with
    its three implementations stubbed to name themselves."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setattr(jax_flash, "flash_attention", lambda *a, **kw: "flash")
    monkeypatch.setattr(jax_small, "small_t_attention", lambda *a, **kw: "small")
    monkeypatch.setattr(jax_attention, "_xla_attention", lambda *a, **kw: "xla")
    return jax_attention.dot_product_attention(q, k, v, mask, impl, rate, rng, weights)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("switch", [False, True])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_attention_gate_matches_mic_tpu(impl, switch, device, monkeypatch):
    """For every dropout (off, on, a rate without a generator), weights
    request and shape (one small_attn takes, a cross-attention and a head
    dim it does not), the port's branch is mic_tpu's with the card in the
    TPU's place."""
    if switch:
        monkeypatch.setenv("MIC_TPU_EXPERIMENTAL", "small_attn")
    else:
        monkeypatch.delenv("MIC_TPU_EXPERIMENTAL", raising=False)
    backend = {"cpu": "cpu", "cuda": "tpu"}[device]
    shapes = {"self T=64": ((2, 64, 2, 64), (2, 64, 2, 64)),
              "cross 64x50": ((2, 64, 2, 64), (2, 50, 2, 64)),
              "head dim 32": ((2, 64, 4, 32), (2, 64, 4, 32))}
    seen = set()
    for qs, ks in shapes.values():
        q, k = np.zeros(qs, np.float32), np.zeros(ks, np.float32)
        mask = np.ones((2, 1, qs[1], ks[1]), bool)
        tq, tk, tmask = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(mask)
        for rate, rng in ((0.0, None), (0.1, object()), (0.1, None)):
            for weights in (False, True):
                want = _mic_tpu_branch(monkeypatch, backend, q, k, k, mask, impl, rate, rng,
                                       weights)
                got = attention.attention_branch(tq, tk, tk, tmask, impl, rate, rng, weights,
                                                 on_card=device == "cuda")
                assert got == want, (qs, ks, rate, rng, weights)
                seen.add(got)
    assert seen == ({"flash", "xla"} if impl == "pallas" else
                    {"small", "xla"} if switch and device == "cuda" else {"xla"})


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_dot_product_attention_dispatches_on_cpu_tensors(impl, monkeypatch):
    """On CPU tensors the gate calls what ``attention_branch`` names:
    small_attn never runs there (mic_tpu: only on the TPU), "pallas" runs
    flash (a fully masked row outputs 0, where XLA attends uniformly), and
    a weights request or an active dropout forces XLA."""
    monkeypatch.setenv("MIC_TPU_EXPERIMENTAL", "small_attn")
    (_, _, _), _, (q, k, v), mask = _both("fully_masked_rows", "float32", seed=11)
    out = attention.dot_product_attention(q, k, v, mask, impl)
    xla = attention.xla_attention(q, k, v, mask)
    if impl == "pallas":
        assert torch.equal(out[1, 0], torch.zeros_like(out[1, 0]))
        assert not torch.equal(xla[1, 0], torch.zeros_like(xla[1, 0]))
        assert torch.allclose(out[0], xla[0], rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(out, xla)
    got, weights = attention.dot_product_attention(q, k, v, mask, impl, return_weights=True)
    assert torch.equal(got, xla) and weights.shape == (4, 2, 64, 64)
    gen = torch.Generator().manual_seed(0)
    dropped = attention.dot_product_attention(q, k, v, mask, impl, 0.5, gen)
    assert torch.equal(dropped, attention.xla_attention(q, k, v, mask, 0.5,
                                                        torch.Generator().manual_seed(0)))
