"""The physical cache's beam reorder (ops/beam_permute.py) against mic_tpu's
beam_permute (its CPU path, take_along_axis) and beam_permute_matmul (the
one-hot contraction mic_tpu's physical cache runs), and
DecoderCache.beam_reorder through it.  A reorder only copies values, so
everything is held bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mic_tpu.ops.beam_permute import beam_permute as jax_beam_permute
from mic_tpu.ops.beam_permute import beam_permute_matmul as jax_beam_permute_matmul
from mic_tpu_torch.nn import cache as cache_mod
from mic_tpu_torch.nn.cache import init_cache
from mic_tpu_torch.ops import beam_permute as ops

SHAPES = {  # (L, B, K, T, H, Dh)
    "flagship_heads": (2, 3, 4, 8, 16, 64),
    "one_beam": (1, 2, 1, 4, 2, 8),
    "odd_row": (3, 2, 3, 5, 3, 7),  # T*H*Dh = 105, not a multiple of 8
}
INDICES = {
    "random": lambda rng, b, k: rng.integers(0, k, (b, k)),
    "identity": lambda rng, b, k: np.tile(np.arange(k), (b, 1)),
    "all_from_one": lambda rng, b, k: np.full((b, k), k - 1),
    "reversed": lambda rng, b, k: np.tile(np.arange(k)[::-1], (b, 1)),
}


def _inputs(shape, kind, seed, dtype=np.float32):
    l, b, k, t, h, dh = shape
    rng = np.random.default_rng(seed)
    kv = rng.normal(size=(l, b * k, t, h, dh)).astype(dtype)
    return kv, INDICES[kind](rng, b, k).astype(np.int32)


@pytest.mark.parametrize("kind", sorted(INDICES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_matches_mic_tpu(shape, kind):
    kv, idx = _inputs(SHAPES[shape], kind, len(shape) + len(kind))
    k = SHAPES[shape][2]
    got = ops.beam_permute(torch.from_numpy(kv), torch.from_numpy(idx), k).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_beam_permute(jnp.asarray(kv),
                                                                   jnp.asarray(idx), k)))
    np.testing.assert_array_equal(got, np.asarray(jax_beam_permute_matmul(jnp.asarray(kv),
                                                                          jnp.asarray(idx), k)))


def test_plain_copies_and_takes_int64_indices():
    """The result is a new tensor (the input is only read), bf16 values move
    unchanged, and int64 indices (what the beam search gathers) work alike."""
    kv, idx = _inputs(SHAPES["flagship_heads"], "random", 3)
    tkv = torch.from_numpy(kv).to(torch.bfloat16)
    before = tkv.clone()
    got = ops.beam_permute(tkv, torch.from_numpy(idx).long(), 4)
    assert torch.equal(tkv, before) and got.data_ptr() != tkv.data_ptr()
    ref = jax_beam_permute(jnp.asarray(kv, jnp.bfloat16), jnp.asarray(idx), 4)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


def test_decoder_cache_beam_reorder_goes_through_beam_permute(monkeypatch):
    """DecoderCache.beam_reorder moves both self planes through
    ops/beam_permute.py, once each, and leaves the per-image cross K/V."""
    l, b, k, t, h, dh = 2, 2, 4, 6, 2, 8
    rng = np.random.default_rng(5)
    cross = torch.from_numpy(rng.normal(size=(l, b, 5, h, dh)).astype(np.float32))
    cache = init_cache(cross, cross, b * k, t)
    cache.self_k.copy_(torch.from_numpy(rng.normal(size=cache.self_k.shape)))
    cache.self_v.copy_(torch.from_numpy(rng.normal(size=cache.self_v.shape)))
    idx = torch.from_numpy(rng.integers(0, k, (b, k)))
    calls = []

    def counted(kv, beam_indices, num_beams):
        calls.append(kv.data_ptr())
        return ops.beam_permute(kv, beam_indices, num_beams)

    monkeypatch.setattr(cache_mod, "beam_permute", counted)
    new = cache.beam_reorder(idx, k)
    assert calls == [cache.self_k.data_ptr(), cache.self_v.data_ptr()]
    for got, old in ((new.self_k, cache.self_k), (new.self_v, cache.self_v)):
        ref = jax_beam_permute_matmul(jnp.asarray(old.numpy()), jnp.asarray(idx.numpy()), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert new.cross_k is cache.cross_k and new.index == cache.index
