"""The port's decode attention on the physical cache (ops/decode_attention,
nn/attention.mha_decode_step, the physical and fused decoder steps) against
mic_tpu.

On the CPU the port's wrapper runs its plain version.  It is held to
mic_tpu's decode_attention both through that function's CPU branch and
through its Pallas kernel in interpret mode (as tests/test_decode_attention.py
runs it).  Tolerances: outputs within 1e-5 at float32 (f32 sums in another
order), at bfloat16 within one bf16 rounding of the output (2**-8 relative;
both sides sum in f32 and round once); the written caches bit-equal, every
other layer and column untouched (exact: values are only copied).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mic_tpu.models import mbart_decoder as jax_dec
from mic_tpu.nn.cache import DecoderCache as JaxDecoderCache
from mic_tpu.ops.decode_attention import decode_attention as jax_decode_attention
from mic_tpu_torch.models import mbart_decoder
from mic_tpu_torch.nn.cache import DecoderCache, init_cache
from mic_tpu_torch.ops.decode_attention import (
    UNROLL,
    decode_attention,
    decode_attention_plain,
    decode_attention_split_plain,
    decode_splits,
    lane_groups,
    walk_partition,
)
from test_decode_attention import run_interpret
from test_torch_captioner import TOL, _config, _models, _port

L, B, T, H, DH = 3, 4, 8, 2, 64
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, dtype):
    _, jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    ck = rng.normal(size=(L, B, T, H, DH)).astype(np.float32)
    cv = rng.normal(size=(L, B, T, H, DH)).astype(np.float32)
    q = (rng.normal(size=(B, 1, H, DH)) * 0.3).astype(np.float32)
    ks = rng.normal(size=(B, 1, H, DH)).astype(np.float32)
    vs = rng.normal(size=(B, 1, H, DH)).astype(np.float32)
    arrays = (q, ks, vs, ck, cv)
    jax_side = [jnp.asarray(a).astype(jdt) for a in arrays]
    torch_side = [torch.from_numpy(a).to(tdt) for a in arrays]
    return jax_side, torch_side


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if isinstance(x, jax.Array) \
        else x.float().numpy()


def _check(out, ck, cv, ref, rck, rcv, before, layer, index, dtype, bf16_tol=None):
    if dtype == "float32":
        np.testing.assert_allclose(_f32(out), _f32(ref), **TOL)
    else:
        np.testing.assert_allclose(_f32(out), _f32(ref), **(bf16_tol or dict(rtol=2**-8,
                                                                             atol=1e-6)))
    for got, want, old in zip((ck, cv), (rck, rcv), before):
        got, want, old = _f32(got), _f32(want), _f32(old)
        np.testing.assert_array_equal(got, want)
        keep = np.ones(got.shape[:3], bool)
        keep[layer, :, index] = False
        np.testing.assert_array_equal(got[keep], old[keep])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("index", [0, 1, T - 1])
def test_plain_matches_jax_cpu_branch(index, dtype):
    (jq, jks, jvs, jck, jcv), (q, ks, vs, ck, cv) = _inputs(index, dtype)
    before = (ck.clone(), cv.clone())
    layer = 1
    ref, rck, rcv = jax_decode_attention(jq, jks, jvs, jck, jcv, jnp.asarray(layer, jnp.int32),
                                         jnp.asarray(index, jnp.int32))
    out = decode_attention(q, ks, vs, ck, cv, layer, index)
    assert out.dtype == q.dtype and out.shape == q.shape
    _check(out, ck, cv, ref, rck, rcv, before, layer, index, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("index", [0, 1, T - 1])
def test_plain_matches_jax_interpret_kernel(index, dtype):
    """The TPU kernel itself (interpret mode): H * Dh = 128 takes its
    tile-aligned (rows, 128) layout, as the flagship's 1024 does.  At
    bfloat16 the TPU kernel rounds each q * k product and the softmax
    weights to bf16 before its f32 sums (the CPU branch and the port round
    only the output), so there the outputs (|out| < 2) agree within 3e-2:
    a few bf16 roundings of 2**-8 relative each."""
    (jq, jks, jvs, jck, jcv), (q, ks, vs, ck, cv) = _inputs(10 + index, dtype)
    before = (ck.clone(), cv.clone())
    layer = 2
    ref, rck, rcv = run_interpret(jq, jks, jvs, jck, jcv, layer, index, chunk=4, block_b=2)
    out = decode_attention_plain(q, ks, vs, ck, cv, layer, index)
    _check(out, ck, cv, ref, rck, rcv, before, layer, index, dtype, dict(rtol=0, atol=3e-2))


def _step_inputs(config, index, seed):
    cfg = config.decoder
    rng = np.random.default_rng(seed)
    n = 6  # 3 images x 2 beams
    enc = rng.normal(size=(3, config.vision.seq_len, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (n, 1)).astype(np.int32)
    shape = (cfg.num_layers, n, 8, cfg.num_heads, cfg.head_dim)
    prefix = [rng.normal(size=shape).astype(np.float32) for _ in range(2)]
    for p in prefix:
        p[:, :, index:] = 0.0
    return enc, tokens, prefix


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("index", [0, 5])
def test_decoder_step_matches_jax(index, fused, monkeypatch):
    """One physical decode step (all layers, 2 beams an image) on a cache
    with a random written prefix: mic_tpu's decoder_step, and with
    MIC_TPU_EXPERIMENTAL=fused_decode its _decoder_step_fused, against the
    port's on the same weights.  Hidden states within 1e-5; every cache
    column but ``index`` untouched; column ``index`` within 1e-6 (each side
    projects it with its own matmul)."""
    if fused:
        monkeypatch.setenv("MIC_TPU_EXPERIMENTAL", "fused_decode")
    config = _config()
    cfg = config.decoder
    jax_model, jparams, model, tparams = _models(config, seed=4)
    enc, tokens, prefix = _step_inputs(config, index, seed=index)
    ck, cv = jax_dec.init_cross_cache(jparams["decoder"], jnp.asarray(enc), cfg)
    jcache = JaxDecoderCache(self_k=jnp.asarray(prefix[0]), self_v=jnp.asarray(prefix[1]),
                             cross_k=ck, cross_v=cv, index=jnp.asarray(index, jnp.int32))
    jh, jnew = jax_dec.decoder_step(jparams["decoder"], jparams["shared"], jnp.asarray(tokens),
                                    jcache, cfg, jnp.float32, beams=2)

    calls = []
    monkeypatch.setattr(mbart_decoder, "decode_attention",
                        lambda *a: calls.append(a[5]) or decode_attention(*a))
    tck, tcv = mbart_decoder.init_cross_cache(tparams["decoder"], torch.from_numpy(enc),
                                              _port(cfg), torch.float32)
    tcache = init_cache(tck, tcv, 6, 8)
    tcache.self_k.copy_(torch.from_numpy(prefix[0]))
    tcache.self_v.copy_(torch.from_numpy(prefix[1]))
    tcache = DecoderCache(tcache.self_k, tcache.self_v, tck, tcv, index)
    th, tnew = mbart_decoder.decoder_step(tparams["decoder"], tparams["shared"],
                                          torch.from_numpy(tokens), tcache, _port(cfg),
                                          torch.float32, 2)
    assert calls == (list(range(cfg.num_layers)) if fused else [])
    assert tnew.index == index + 1 and int(jnew.index) == index + 1
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    others = [t for t in range(8) if t != index]
    for got, ref in ((tnew.self_k, jnew.self_k), (tnew.self_v, jnew.self_v)):
        got, ref = got.numpy(), np.asarray(ref)
        np.testing.assert_array_equal(got[:, :, others], ref[:, :, others])
        np.testing.assert_allclose(got[:, :, index], ref[:, :, index], rtol=1e-6, atol=1e-6)


def test_physical_beam_reorder_matches_jax():
    """DecoderCache.beam_reorder moves the self rows exactly as mic_tpu's
    one-hot beam_permute_matmul does; the cross K/V stay."""
    rng = np.random.default_rng(5)
    sk, sv = (rng.normal(size=(2, 6, 4, 2, 8)).astype(np.float32) for _ in range(2))
    xk = rng.normal(size=(2, 3, 5, 2, 8)).astype(np.float32)
    src = np.array([[1, 1], [0, 0], [1, 0]], np.int32)
    jcache = JaxDecoderCache(jnp.asarray(sk), jnp.asarray(sv), jnp.asarray(xk), jnp.asarray(xk),
                             jnp.asarray(3, jnp.int32)).beam_reorder(jnp.asarray(src), 2)
    tcache = DecoderCache(torch.from_numpy(sk), torch.from_numpy(sv), torch.from_numpy(xk),
                          torch.from_numpy(xk), 3).beam_reorder(torch.from_numpy(src), 2)
    np.testing.assert_array_equal(tcache.self_k.numpy(), np.asarray(jcache.self_k))
    np.testing.assert_array_equal(tcache.self_v.numpy(), np.asarray(jcache.self_v))
    np.testing.assert_array_equal(tcache.cross_k.numpy(), xk)
    assert tcache.index == 3 and tcache.batch == 6 and tcache.max_len == 4


H100_SMS = 132


@pytest.mark.parametrize("index", [0, 1, 15, 16, 31, 63, 127, 1023])
@pytest.mark.parametrize("rows", [1, 4, 32, 256])
def test_walk_split_covers_every_position_once(rows, index):
    """The CUDA kernel's walk (csrc/decode_attention.cu), as the wrapper
    sizes it for the H100's 132 SMs and 16 heads: every position 0..index
    falls to exactly one (split, lane group), in both lane widths (bf16,
    f32), and each split keeps at least one round of positions."""
    for elem in (2, 4):
        groups = lane_groups(elem)
        splits = decode_splits(rows, 16, index, H100_SMS, groups)
        assert splits in (1, 2, 4)
        parts = walk_partition(index, splits, groups)
        assert len(parts) == splits and all(len(p) == groups for p in parts)
        seen = sorted(t for split in parts for ts in split for t in ts)
        assert seen == list(range(index + 1))
        if splits > 1:
            assert min(sum(map(len, p)) for p in parts) >= groups * UNROLL


def test_decode_splits_fill_the_card():
    """One image of beam 4 (N = 4) at index 63 takes the largest split; a
    B = 256 batch, 4096 (row, head) pairs, needs none; nor does an early
    index, whose walk is short."""
    assert lane_groups(2) == 4 and lane_groups(4) == 2
    assert decode_splits(4, 16, 63, H100_SMS) == 4
    assert decode_splits(1, 16, 63, H100_SMS) == 4
    assert decode_splits(256, 16, 63, H100_SMS) == 1
    assert decode_splits(64, 16, 63, H100_SMS) == 2
    assert decode_splits(4, 16, 7, H100_SMS) == 1


T_SPLIT = 40


@pytest.mark.parametrize("splits", [2, 4])
@pytest.mark.parametrize("index", [0, 17, T_SPLIT - 1])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_split_plain_matches_jax_interpret_kernel(dtype, index, splits):
    """The kernel's split-and-merge arithmetic in plain torch (each lane
    group's online (max, sum, acc) over its positions, the groups merged by
    the xor butterfly, the splits in order) against mic_tpu's Pallas kernel
    in interpret mode, at the lane width of the dtype; the tolerances of
    test_plain_matches_jax_interpret_kernel."""
    _, jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(30 + index + splits)
    arrays = [rng.normal(size=(L, B, T_SPLIT, H, DH)).astype(np.float32) for _ in range(2)]
    arrays = [(rng.normal(size=(B, 1, H, DH)) * s).astype(np.float32)
              for s in (0.3, 1.0, 1.0)] + arrays
    jq, jks, jvs, jck, jcv = (jnp.asarray(a).astype(jdt) for a in arrays)
    q, ks, vs, ck, cv = (torch.from_numpy(a).to(tdt) for a in arrays)
    before = (ck.clone(), cv.clone())
    layer = 1
    ref, rck, rcv = run_interpret(jq, jks, jvs, jck, jcv, layer, index, chunk=8, block_b=2)
    groups = lane_groups(q.element_size())
    out = decode_attention_split_plain(q, ks, vs, ck, cv, layer, index, splits, groups)
    _check(out, ck, cv, ref, rck, rcv, before, layer, index, dtype, dict(rtol=0, atol=3e-2))
