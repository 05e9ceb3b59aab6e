"""The port's cross-attention kernels' plain versions (ops/cross_attention.py)
against mic_tpu's Pallas kernels in interpret mode, and the merged cross
cache of the decode step (MIC_TPU_EXPERIMENTAL=merged_cross) against
mic_tpu's.

Both sides round q, the softmax weights and the output to bfloat16 in the
same places (mic_tpu's _attend_tiles), so kernel outputs are held within
1e-5 (f32 sums in another order; bit-equal where measured), the int8
trees each package quantizes from the same bf16 K/V bit-equal, and the
merged cache bit-equal, pad included.  A decode step on the merged lazy
cache is held within 1e-5 (float32 projections in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mic_tpu.models import mbart_decoder as jax_dec
from mic_tpu.nn.attention import mha_cross_grouped as jax_mha_cross_grouped
from mic_tpu.nn.cache import init_lazy_cache as jax_init_lazy_cache
from mic_tpu.ops import cross_attention as jax_cross
from mic_tpu.ops.quant import quantize_rows_dynamic as jax_quantize_rows
from mic_tpu_torch.models import mbart_decoder
from mic_tpu_torch.nn import attention
from mic_tpu_torch.nn.cache import LazyDecoderCache, init_lazy_cache
from mic_tpu_torch.ops import cross_attention
from mic_tpu_torch.ops.quant import quantize_rows_dynamic
from test_torch_captioner import TOL, _config, _models, _port

B, H, DH = 2, 2, 64


def _qkv(rng, k, s, s_pad=None):
    """q (B, K, H*Dh) and bf16 merged K/V (B, S_pad, H*Dh), zeros past S,
    as numpy float32 arrays already rounded to bfloat16."""
    hd = H * DH
    s_pad = s_pad or s
    q = rng.normal(size=(B, k, hd)).astype(np.float32) * 0.3
    kv = []
    for _ in range(2):
        a = np.zeros((B, s_pad, hd), np.float32)
        a[:, :s] = rng.normal(size=(B, s, hd)) * 0.5
        kv.append(np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)))
    return q, kv[0], kv[1]


def _bf16(a):
    return torch.tensor(a).to(torch.bfloat16)


def _assert_within_one_bf16_ulp(got, ref):
    """|got - ref| at most one bfloat16 ulp of ref (2**-8 of its binade)."""
    _, e = np.frexp(np.abs(ref))
    assert (np.abs(got - ref) <= np.ldexp(1.0, e - 8)).all()


@pytest.mark.parametrize("k", [1, 4, 9, 16])
@pytest.mark.parametrize("s,s_pad", [(13, 16), (50, 64), (64, 64)])
def test_dma_plain_matches_mic_tpu_interpret(s, s_pad, k):
    """Row 13: the merged padded cache, rows >= real_s dead, bf16 q, at
    beam counts past the earlier kernel's eight."""
    rng = np.random.default_rng(s + k)
    q, ek, ev = _qkv(rng, k, s, s_pad)
    ref = jax_cross.fused_cross_attention_dma(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(ek, jnp.bfloat16),
        jnp.asarray(ev, jnp.bfloat16), s, k, H, interpret=True)
    got = cross_attention.fused_cross_attention_dma(_bf16(q), _bf16(ek), _bf16(ev), s, k, H)
    assert got.dtype == torch.bfloat16 and got.shape == (B, k, H * DH)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **TOL)


def test_dma_plain_keeps_a_float_query_dtype():
    """A float32 q (the CPU decode step's) is rounded to bf16 inside and the
    output comes back float32, as mic_tpu's kernel does it."""
    rng = np.random.default_rng(7)
    q, ek, ev = _qkv(rng, 4, 50, 64)
    ref = jax_cross.fused_cross_attention_dma(
        jnp.asarray(q), jnp.asarray(ek, jnp.bfloat16), jnp.asarray(ev, jnp.bfloat16), 50, 4, H,
        interpret=True)
    got = cross_attention.fused_cross_attention_dma(torch.from_numpy(q), _bf16(ek), _bf16(ev),
                                                    50, 4, H)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("s_pad", [50, 24])
def test_dma_refuses_an_unaligned_pad_as_mic_tpu(s_pad):
    rng = np.random.default_rng(0)
    q, ek, ev = _qkv(rng, 4, 13, s_pad)
    with pytest.raises(ValueError, match="16-aligned"):
        jax_cross.fused_cross_attention_dma(jnp.asarray(q), jnp.asarray(ek), jnp.asarray(ev),
                                            13, 4, H, interpret=True)
    with pytest.raises(ValueError, match="16-aligned"):
        cross_attention.fused_cross_attention_dma(torch.from_numpy(q), torch.from_numpy(ek),
                                                  torch.from_numpy(ev), 13, 4, H)


@pytest.mark.parametrize("layout", ["canonical", "merged"])
@pytest.mark.parametrize("k", [1, 4, 9, 16])
@pytest.mark.parametrize("s", [50, 13])
def test_int8_plain_matches_mic_tpu_interpret(s, k, layout):
    """Row 14's int8 variant: {"q", "s"} caches that each package quantizes
    from the same bf16 K/V (bit-equal first), in the (B, S, H, Dh) and the
    merged (B, S, H*Dh) layouts, against mic_tpu's _kernel_q8."""
    rng = np.random.default_rng(10 * s + k)
    q, ek, ev = _qkv(rng, k, s)
    jcaches, tcaches = [], []
    for a in (ek, ev):
        a4 = a.reshape(B, s, H, DH)
        jv, js = jax_quantize_rows(jnp.asarray(a4, jnp.bfloat16))
        tv, ts = quantize_rows_dynamic(_bf16(a4))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        shape = (B, s, H, DH) if layout == "canonical" else (B, s, H * DH)
        jcaches.append({"q": jv.reshape(shape), "s": js[..., 0]})
        tcaches.append({"q": tv.reshape(shape), "s": ts[..., 0]})
    ref = jax_cross.fused_cross_attention(jnp.asarray(q, jnp.bfloat16), *jcaches, k, H,
                                          interpret=True)
    got = cross_attention.fused_cross_attention(_bf16(q), *tcaches, k, H)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **TOL)


@pytest.mark.parametrize("k", [1, 4, 9, 16])
@pytest.mark.parametrize("s", [50, 13])
def test_bf16_merged_layout_matches_mic_tpu_interpret(s, k):
    """Row 14's bf16 kernel also takes the merged (B, S, H*Dh) layout:
    within one bfloat16 ulp of mic_tpu's (its MXU fold sums the V product in
    another order, which can round the bf16 output the other way; 3 of 1024
    outputs at S=50, four beams)."""
    rng = np.random.default_rng(s if k == 4 else 100 * s + k)
    q, ek, ev = _qkv(rng, k, s)
    ref = jax_cross.fused_cross_attention(jnp.asarray(q, jnp.bfloat16),
                                          jnp.asarray(ek, jnp.bfloat16),
                                          jnp.asarray(ev, jnp.bfloat16), k, H, interpret=True)
    got = cross_attention.fused_cross_attention(_bf16(q), _bf16(ek), _bf16(ev), k, H)
    _assert_within_one_bf16_ulp(got.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("kernel", [False, True])
def test_mha_cross_grouped_merged_matches_jax(kernel, monkeypatch):
    """A merged cache goes to the merged kernel before ``kernel`` is read, in
    mic_tpu's order: the layer's cross-attention within 1e-5 of mic_tpu's
    (its DMA kernel in interpret mode), a float32 x, ``enc_len`` 13 of 16."""
    rng = np.random.default_rng(11)
    d = H * DH
    params = {n: {"kernel": rng.normal(size=(d, d)).astype(np.float32) * 0.1,
                  "bias": rng.normal(size=(d,)).astype(np.float32) * 0.1} for n in ("q", "o")}
    x = rng.normal(size=(B * 4, 1, d)).astype(np.float32)
    _, ek, ev = _qkv(rng, 4, 13, 16)
    ref = jax_mha_cross_grouped(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                                jnp.asarray(ek, jnp.bfloat16), jnp.asarray(ev, jnp.bfloat16),
                                None, H, 4, kernel=kernel, enc_len=13)
    calls = []
    for name in ("fused_cross_attention", "fused_cross_attention_dma"):
        def counted(*args, _fn=getattr(attention, name), _name=name):
            calls.append(_name)
            return _fn(*args)
        monkeypatch.setattr(attention, name, counted)
    tparams = {n: {k: torch.from_numpy(a) for k, a in p.items()} for n, p in params.items()}
    got = attention.mha_cross_grouped(tparams, torch.from_numpy(x), _bf16(ek), _bf16(ev), H,
                                      kernel=kernel, enc_len=13)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert calls == ["fused_cross_attention_dma"]


def test_init_cross_cache_merged_matches_jax():
    """init_cross_cache(merged=True): (L, B, S_pad, H*Dh), S=5 padded with
    zero rows to 16, against mic_tpu's (1e-5 inside, pad rows exactly 0)."""
    config = _config()
    cfg = config.decoder
    _, jparams, _, tparams = _models(config, seed=1)
    enc = np.random.default_rng(3).normal(
        size=(B, config.vision.seq_len, cfg.d_model)).astype(np.float32)
    jk, jv = jax_dec.init_cross_cache(jparams["decoder"], jnp.asarray(enc), cfg, merged=True)
    tk, tv = mbart_decoder.init_cross_cache(tparams["decoder"], torch.from_numpy(enc),
                                            _port(cfg), torch.float32, merged=True)
    s = config.vision.seq_len
    assert tk.shape == jk.shape == (cfg.num_layers, B, 16, cfg.d_model)
    for got, ref in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        assert not got[:, :, s:].any() and not np.asarray(ref)[:, :, s:].any()


@pytest.mark.parametrize("index", [0, 3])
def test_decoder_step_on_a_merged_cross_cache_matches_jax(index):
    """One lazy decode step with the merged cross cache and ``enc_len``
    (every layer through the merged kernel's plain version) against
    mic_tpu's (its DMA kernel in interpret mode): hidden states within 1e-5,
    columns other than ``index`` untouched."""
    config = _config()
    cfg = config.decoder
    _, jparams, _, tparams = _models(config, seed=1)
    b, beams, t = 2, 4, 8
    rng = np.random.default_rng(4 + index)
    s = config.vision.seq_len
    enc = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (b * beams, 1)).astype(np.int32)
    anc = rng.integers(0, beams, (b, beams, t)).astype(np.int32)
    anc[:, :, index:] = np.arange(beams)[None, :, None]

    jfused = jax_dec.fuse_qkv_params(jparams["decoder"])
    tfused = mbart_decoder.fuse_qkv_params(tparams["decoder"])
    ck, cv = jax_dec.init_cross_cache(jfused, jnp.asarray(enc), cfg, merged=True)
    jcache = jax_init_lazy_cache(cfg.num_layers, b, beams, t, s, cfg.num_heads, cfg.head_dim,
                                 merged=True)
    jcache = jcache._replace(cross_k=ck, cross_v=cv, ancestry=jnp.asarray(anc),
                             index=jnp.asarray(index, jnp.int32))
    step = jax.jit(jax_dec._decoder_step_lazy, static_argnums=(4, 5, 6, 7, 8))
    jh, jnew = step(jfused, jparams["shared"], jnp.asarray(tokens), jcache, cfg, jnp.float32,
                    None, beams, s)

    tck, tcv = mbart_decoder.init_cross_cache(tfused, torch.from_numpy(enc), _port(cfg),
                                              torch.float32, merged=True)
    tcache = init_lazy_cache(tck, tcv, beams, t, num_heads=cfg.num_heads)
    assert isinstance(tcache, LazyDecoderCache) and tcache.cross_k.ndim == 4
    tcache = LazyDecoderCache(self_k=tcache.self_k, self_v=tcache.self_v, cross_k=tck,
                              cross_v=tcv, ancestry=torch.from_numpy(anc), index=index)
    th, tnew = mbart_decoder.decoder_step(tfused, tparams["shared"], torch.from_numpy(tokens),
                                          tcache, _port(cfg), torch.float32, beams, enc_len=s)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    others = np.arange(t) != index
    for got, ref in zip(tnew.self_k + tnew.self_v, jnew.self_k + jnew.self_v):
        np.testing.assert_array_equal(got.numpy()[:, others], np.asarray(ref)[:, others])


def test_init_lazy_cache_per_head_scales_beside_a_merged_cross_cache():
    """The canonical int8 self cache (a scale per head, mode "1") beside a
    merged cross cache takes its head count from ``num_heads``."""
    cross = torch.zeros((2, 3, 16, 128), dtype=torch.bfloat16)
    cache = init_lazy_cache(cross, cross, 4, 8, "int8", merged=False, num_heads=2)
    assert cache.self_k[0]["q"].shape == (12, 8, 128)
    assert cache.self_k[0]["s"].shape == (12, 8, 2)
    with pytest.raises(ValueError, match="num_heads"):
        init_lazy_cache(cross, cross, 4, 8, "int8", merged=False)
