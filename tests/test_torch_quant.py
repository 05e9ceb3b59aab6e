"""The port's int8 quantization (mic_tpu_torch/ops/quant.py, the int8
branches of nn/layers.py) against mic_tpu/ops/quant.py on the CPU.

Both sides quantize with one division per value and round half to even, so
every int8 value and f32 scale must be bit-equal, at float32 and after a
bfloat16 cast of the weights.  The int8 products are exact int32 on both
sides, and the epilogue rounds the same float32 products in the same order,
so int8 denses and int8 embeddings are bit-equal as well.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mic_tpu.core.config import CaptionerConfig, DecoderConfig, VisionConfig
from mic_tpu.models import mbart_decoder as jax_dec
from mic_tpu.models.captioner import Captioner as JaxCaptioner
from mic_tpu.nn.layers import dense as jax_dense
from mic_tpu.nn.layers import embed as jax_embed
from mic_tpu.ops import quant as jq
from mic_tpu_torch.core.params import make_serving_params, tree_leaves
from mic_tpu_torch.io.from_jax import from_jax
from mic_tpu_torch.models import mbart_decoder
from mic_tpu_torch.nn.layers import dense, embed
from mic_tpu_torch.ops import quant

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tree(seed=0):
    """A tiny captioner tree in mic_tpu's layout from numpy, with a few
    values planted on the rounding edges (exact halves of a scale step and
    an all-zero channel)."""
    config = CaptionerConfig(vision=VisionConfig.tiny(), decoder=DecoderConfig.tiny(vocab_size=300))
    shapes = jax.eval_shape(JaxCaptioner(config).init_params, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda s: (rng.normal(size=s.shape) * 0.05).astype(np.float32), shapes)
    fc1 = tree["decoder"]["layers"]["fc1"]["kernel"]           # (L, in, out)
    fc1[0, :, 3] = 0.0                                          # amax 0: the 1e-8 floor
    fc1[1, :4, 5] = [1.0, 0.5 / 127.0 * 3, -1.5 / 127.0, 2.5 / 127.0]  # half steps
    return tree


def _to_jax(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), tree)


def _assert_trees_equal(got, ref):
    ref = dict(tree_leaves(jax.tree.map(np.asarray, ref)))
    got = dict(tree_leaves(got))
    assert got.keys() == ref.keys()
    for path, want in ref.items():
        have = got[path]
        if want.dtype == np.int8:
            assert have.dtype == torch.int8, path
            np.testing.assert_array_equal(have.numpy(), want, err_msg=str(path))
        else:
            np.testing.assert_array_equal(have.float().numpy(), want.astype(np.float32),
                                          err_msg=str(path))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantize_params_for_decode_bit_equal_to_jax(dtype):
    """The generate order on both sides: cast, fuse QKV, quantize."""
    jdt, tdt = DTYPES[dtype]
    tree = _tree()
    jtree = _to_jax(tree, jdt)
    jtree = dict(jtree, decoder=jax_dec.fuse_qkv_params(jtree["decoder"]))
    ref = jq.quantize_params_for_decode(jtree)
    ttree = make_serving_params(from_jax(tree), tdt)
    ttree = dict(ttree, decoder=mbart_decoder.fuse_qkv_params(ttree["decoder"]))
    got = quant.quantize_params_for_decode(ttree)
    _assert_trees_equal(got, ref)
    layers = got["decoder"]["layers"]
    assert layers["self_attn"]["qkv"]["kernel_q"].shape == (2, 32, 96)
    # each (in, out) matrix column-major: the layout the CUDA int8 GEMM reads fast
    assert layers["self_attn"]["qkv"]["kernel_q"].stride() == (32 * 96, 1, 32)
    assert layers["self_attn"]["qkv"]["kernel_scale"].dtype == torch.float32
    assert "embedding" in got["decoder"]["pos_embed"] and "kernel" in got["proj"]
    assert got["shared"]["embedding_scale"].shape == (300,)


def test_from_jax_carries_a_quantized_tree_bit_equal():
    ref = jax.device_get(jq.quantize_params_for_decode(_to_jax(_tree(1), jnp.float32)))
    _assert_trees_equal(from_jax(ref), ref)


@pytest.mark.parametrize("shape", [(5, 48), (2, 3, 48), (1, 48)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantize_rows_and_int8_dense_bit_equal(shape, dtype):
    """quantize_rows_dynamic and int8_dense against quantize_rows_dynamic
    and int8_dense_native, with rows of ties on half steps and a zero row."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(len(shape))
    x = rng.normal(size=shape).astype(np.float32)
    x.reshape(-1, 48)[0, :3] = [127.0, 0.5, -1.5]              # scale 1: exact halves
    if x.shape[0] > 1:
        x.reshape(-1, 48)[1] = 0.0
    kernel = (rng.normal(size=(48, 40)) * 0.1).astype(np.float32)
    kq, ks = jq.quantize_array(jnp.asarray(kernel), axis=0)
    jp = {"kernel_q": kq, "kernel_scale": ks, "bias": jnp.asarray(rng.normal(size=40), jnp.float32)}
    tp = {name: torch.from_numpy(np.array(a)) for name, a in jp.items()}
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(x).to(tdt)
    for got, ref in zip(quant.quantize_rows_dynamic(tx), jq.quantize_rows_dynamic(jx)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ref = np.asarray(jq.int8_dense_native(jp, jx, jdt)).astype(np.float32)
    for got in (quant.int8_dense(tp, tx, tdt), dense(tp, tx)):
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), ref)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_stacked_int8_dense_and_dequant_match_jax(dtype):
    """A rank-3 kernel_q is dequantized in the compute dtype and contracted
    as jnp.dot contracts it; dequant_* equal mic_tpu's bit for bit."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(7)
    kq, ks = jq.quantize_array(jnp.asarray(rng.normal(size=(3, 16, 24)), jnp.float32), axis=1)
    jp = {"kernel_q": kq, "kernel_scale": ks}
    tp = {name: torch.from_numpy(np.array(a)) for name, a in jp.items()}
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    ref = np.asarray(jax_dense(jp, jnp.asarray(x).astype(jdt))).astype(np.float32)
    got = dense(tp, torch.from_numpy(x).to(tdt))
    assert got.shape == ref.shape == (2, 5, 3, 24)
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(), ref, **tol)
    np.testing.assert_array_equal(quant.dequant_dense(tp, tdt).float().numpy(),
                                  np.asarray(jq.dequant_dense(jp, jdt)).astype(np.float32))
    eq, es = jq.quantize_array(jnp.asarray(rng.normal(size=(30, 16)), jnp.float32), axis=1)
    je = {"embedding_q": eq, "embedding_scale": es}
    te = {name: torch.from_numpy(np.array(a)) for name, a in je.items()}
    np.testing.assert_array_equal(quant.dequant_embedding(te, tdt).float().numpy(),
                                  np.asarray(jq.dequant_embedding(je, jdt)).astype(np.float32))


@pytest.mark.parametrize("dtype", [None, *sorted(DTYPES)])
def test_embed_on_an_int8_table_matches_jax(dtype):
    """Gather int8 rows and scales, multiply in the compute dtype (float32
    when none is given): bit-equal."""
    rng = np.random.default_rng(3)
    eq, es = jq.quantize_array(jnp.asarray(rng.normal(size=(50, 24)) * 0.1, jnp.float32), axis=1)
    ids = rng.integers(0, 50, (3, 4)).astype(np.int32)
    jdt, tdt = DTYPES[dtype] if dtype else (None, None)
    ref = jax_embed({"embedding_q": eq, "embedding_scale": es}, jnp.asarray(ids), jdt)
    got = embed({"embedding_q": torch.from_numpy(np.array(eq)),
                 "embedding_scale": torch.from_numpy(np.array(es))}, torch.from_numpy(ids), tdt)
    assert got.dtype == (tdt or torch.float32)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref).astype(np.float32))
