"""Lazy-attention mode "0", mic_tpu's XLA chain
(nn/attention.py::lazy_attention_chain), against
mic_tpu/nn/attention.py::mha_decode_step_lazy without ``amask``, and a
beam generate under MIC_TPU_FUSED_LAZY_ATTN=0 against mic_tpu's.

Both sides run the same chain: write the step column (quantized on an int8
cache), score every source row's cached positions, mask by ancestry and
t <= index, one softmax over (row, position).  Tolerances: float32 outputs
within 1e-5 of their largest magnitude (4.5e-8 measured; sums in another
order); bfloat16 within 2e-2 (one bf16 rounding of the attention output
near 1, through the o projection, as tests/test_torch_fused_step.py
states); written float columns within 1e-6 (each side projects with its own
matmul; bf16 within one bf16 ulp of 1), int8 columns within one step and
their scales within 1e-6 relative, every other column untouched.  The
generates are held to mic_tpu's as test_torch_captioner.py's beam cases:
sequences equal, scores within 1e-5.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mic_tpu.core.config import DecodeConfig
from mic_tpu.nn.attention import mha_decode_step_lazy as jax_mha_decode_step_lazy
from mic_tpu.ops.image_prep import preprocess_images as jax_preprocess
from mic_tpu.ops.quant import quantize_rows_dynamic as jax_quantize_rows
from mic_tpu_torch.models import mbart_decoder
from mic_tpu_torch.nn import attention
from mic_tpu_torch.ops import lazy_attention
from mic_tpu_torch.ops.image_prep import preprocess_images
from test_torch_captioner import _config, _images, _models

B, BEAMS, HEADS, DH, T = 2, 4, 2, 8, 16
D = HEADS * DH


def _params(rng):
    return {
        "qkv": {"kernel": rng.normal(size=(D, 3 * D)).astype(np.float32) * 0.1,
                "bias": rng.normal(size=(3 * D,)).astype(np.float32) * 0.1},
        "o": {"kernel": rng.normal(size=(D, D)).astype(np.float32) * 0.1,
              "bias": rng.normal(size=(D,)).astype(np.float32) * 0.1},
    }


def _caches(rng, layout, index):
    """(mic_tpu's caches, the port's) for one layout, positions >= index zero.
    mic_tpu's mode-"0" float cache is canonical (B*K, T, H, Dh), its int8
    caches per head {(B*K, T, H, Dh), (B*K, T, H)} or merged per row
    {(B*K, T, H*Dh), (B*K, T)}; the port stores every layout merged."""
    jax_side, port_side = [], []
    for _ in range(2):
        p = rng.normal(size=(B * BEAMS, T, HEADS, DH)).astype(np.float32) * 0.5
        p[:, index:] = 0.0
        if layout == "float":
            jax_side.append(p)
            port_side.append(torch.from_numpy(p.reshape(B * BEAMS, T, D).copy()))
        elif layout == "int8_per_head":
            values, scales = (np.asarray(a) for a in jax_quantize_rows(jnp.asarray(p)))
            jax_side.append({"q": values, "s": scales[..., 0]})
            port_side.append({"q": torch.from_numpy(values.reshape(B * BEAMS, T, D).copy()),
                              "s": torch.from_numpy(scales[..., 0].copy())})
        else:
            values, scales = (np.asarray(a) for a in jax_quantize_rows(
                jnp.asarray(p.reshape(B * BEAMS, T, D))))
            jax_side.append({"q": values, "s": scales[..., 0]})
            port_side.append({"q": torch.from_numpy(values.copy()),
                              "s": torch.from_numpy(scales[..., 0].copy())})
    return jax_side, port_side


def _check_columns(mine, theirs, index, dtype):
    others = np.arange(T) != index
    if isinstance(mine, dict):
        q, jq = mine["q"].numpy(), np.asarray(theirs["q"]).reshape(B * BEAMS, T, D)
        np.testing.assert_array_equal(q[:, others], jq[:, others])
        assert np.abs(q[:, index].astype(int) - jq[:, index].astype(int)).max() <= 1
        s, js = mine["s"].numpy(), np.asarray(theirs["s"])
        np.testing.assert_array_equal(s[:, others], js[:, others])
        np.testing.assert_allclose(s[:, index], js[:, index], rtol=1e-6)
        return
    got = mine.float().numpy()
    ref = np.asarray(theirs).astype(np.float32).reshape(B * BEAMS, T, D)
    np.testing.assert_array_equal(got[:, others], ref[:, others])
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    np.testing.assert_allclose(got[:, index], ref[:, index], rtol=tol, atol=tol)


@pytest.mark.parametrize("buckets", [(), (4, 8)])
@pytest.mark.parametrize("layout", ["float", "int8_per_head", "int8_per_row"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chain_matches_mic_tpu(dtype, layout, buckets):
    """mha_decode_step_lazy(chain=True) at write indices 0, 7 and 15 (the
    first, a middle and the last column; with buckets 4 and 8 every tier is
    read) against mic_tpu's chain on the same inputs."""
    tdtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    ndtype = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}[dtype]
    for index, seed in ((0, 0), (7, 1), (15, 2)):
        rng = np.random.default_rng(seed)
        params = _params(rng)
        x = rng.normal(size=(B * BEAMS, 1, D)).astype(np.float32)
        anc = rng.integers(0, BEAMS, (B, BEAMS, T)).astype(np.int32)
        anc[:, :, index:] = np.arange(BEAMS)[None, :, None]
        jcache, tcache = _caches(rng, layout, index)
        if layout == "float":
            jcache = [c.astype(ndtype) for c in jcache]
            tcache = [c.to(tdtype) for c in tcache]
        jparams = jax.tree.map(lambda a: jnp.asarray(a.astype(ndtype)), params)
        ref, rk, rv = jax_mha_decode_step_lazy(
            jparams, jnp.asarray(x.astype(ndtype)), *(jax.tree.map(jnp.asarray, c)
                                                      for c in jcache),
            jnp.asarray(anc), jnp.asarray(index, jnp.int32), HEADS, BEAMS, buckets=buckets)
        tparams = {k: {n: torch.from_numpy(a).to(tdtype) for n, a in p.items()}
                   for k, p in params.items()}
        got = attention.mha_decode_step_lazy(
            tparams, torch.from_numpy(x).to(tdtype), *tcache, torch.from_numpy(anc), index,
            HEADS, BEAMS, chain=True, buckets=buckets)
        assert got.dtype == tdtype
        ref = np.asarray(ref).astype(np.float32)
        bound = 1e-5 if dtype == "float32" else 2e-2
        assert np.abs(got.float().numpy() - ref).max() <= bound * np.abs(ref).max()
        for mine, theirs in zip(tcache, (rk, rv)):
            _check_columns(mine, theirs, index, tdtype)


def test_modes_take_the_chain_where_mic_tpu_does(monkeypatch):
    """mic_tpu's dispatch (models/mbart_decoder.py:424-441): the chain under
    mode "0" and under mode "1" where ``supports`` rejects the shape (here
    H*Dh = 32, not a multiple of 128); mode "2" keeps its kernel's plain
    version; an unknown mode raises.  attn_buckets reaches the chain."""
    seen = []
    real = attention.lazy_attention_chain
    monkeypatch.setattr(attention, "lazy_attention_chain",
                        lambda *a: seen.append(a[-1]) or real(*a))
    config = _config(600, decode=DecodeConfig())
    _, _, model, tparams = _models(config, seed=2, scale=0.5)
    px = preprocess_images(torch.from_numpy(_images(n=1, seed=3)), 32)
    for env, chain in ((dict(MIC_TPU_FUSED_LAZY_ATTN="0"), True),
                       (dict(MIC_TPU_FUSED_LAZY_ATTN="1"), True),
                       (dict(MIC_TPU_FUSED_LAZY_ATTN="2"), False),
                       (dict(MIC_TPU_FUSED_LAZY_ATTN="0",
                             MIC_TPU_EXPERIMENTAL="attn_buckets=2.4"), True)):
        for key in ("MIC_TPU_FUSED_LAZY_ATTN", "MIC_TPU_EXPERIMENTAL"):
            monkeypatch.delenv(key, raising=False)
        for key, value in env.items():
            monkeypatch.setenv(key, value)
        seen.clear()
        model.generate(tparams, px, num_beams=4, max_length=6, forced_bos_token_id=7)
        assert bool(seen) == chain, env
        if chain:
            assert set(seen) == {(2, 4) if "MIC_TPU_EXPERIMENTAL" in env else ()}
    monkeypatch.setenv("MIC_TPU_EXPERIMENTAL", "attn_buckets=auto")
    assert mbart_decoder.attn_buckets(64) == (32, 64) and mbart_decoder.attn_buckets(8) == ()
    assert not lazy_attention.supports(torch.zeros(8, 16, 16), 4, 2, 8)
    monkeypatch.setenv("MIC_TPU_FUSED_LAZY_ATTN", "3")
    monkeypatch.delenv("MIC_TPU_EXPERIMENTAL", raising=False)
    with pytest.raises(ValueError, match="unknown MIC_TPU_FUSED_LAZY_ATTN"):
        model.generate(tparams, px, num_beams=4, max_length=6, forced_bos_token_id=7)


GENERATE_CASES = {
    "bf16_cache": dict(dtype="float32", kw={}),
    "int8_kv": dict(dtype="float32", kw=dict(kv_quant="int8")),
    "int8_kv_merged": dict(dtype="float32", kw=dict(kv_quant="int8"),
                           experimental="merged_kv"),
    "buckets": dict(dtype="float32", kw={}, experimental="attn_buckets=auto"),
}


@pytest.mark.parametrize("case", sorted(GENERATE_CASES))
def test_generate_under_mode_0_matches_mic_tpu(case, monkeypatch):
    """Beam-4 generate under MIC_TPU_FUSED_LAZY_ATTN=0 (the float cache, the
    per-head int8 cache, the per-row one under merged_kv, and the chain over
    attn_buckets' tiers) equal to mic_tpu's CPU generate, which runs the
    same chain."""
    spec = GENERATE_CASES[case]
    monkeypatch.setenv("MIC_TPU_FUSED_LAZY_ATTN", "0")
    if "experimental" in spec:
        monkeypatch.setenv("MIC_TPU_EXPERIMENTAL", spec["experimental"])
    else:
        monkeypatch.delenv("MIC_TPU_EXPERIMENTAL", raising=False)
    config = _config(600, dtype=spec["dtype"])
    jax_model, jparams, model, tparams = _models(config, seed=2, scale=0.5)
    u8 = _images(n=3, seed=3)
    kw = dict(num_beams=4, max_length=16, forced_bos_token_id=7, **spec["kw"])
    ref = jax.jit(lambda p, x: jax_model.generate(p, x, **kw))(
        jparams, jax_preprocess(jnp.asarray(u8), 32))
    out = model.generate(tparams, preprocess_images(torch.from_numpy(u8), 32), **kw)
    np.testing.assert_array_equal(out.sequences.numpy(), np.asarray(ref.sequences))
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores), rtol=1e-5,
                               atol=1e-5)
