"""The port's top-k + logsumexp candidate select (ops/topk_lse.py) against
mic_tpu's topk_log_probs.

On the CPU the port's wrapper runs its plain version.  It is held to
mic_tpu's function through its CPU branch and to its Pallas kernel in
interpret mode (as tests/test_topk_lse.py runs it), on a ragged vocab, in
bf16 and f32, at k the search asks for up to 16 beams, and on rows with tied
maxima.  Ids equal (ties to the lower id on every side); log-probs within
1e-6: the logits keep every row's logsumexp below 8, where one float32 ulp
is 4.8e-7, and the two sides sum the logsumexp in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mic_tpu.ops.topk_lse import topk_log_probs as jax_topk_log_probs
from mic_tpu_torch.ops.topk_lse import topk_log_probs, topk_log_probs_plain
from test_topk_lse import run_kernel_interpret

N, V = 12, 997  # V is no multiple of the kernel's vocab block: a ragged tail
KS = [1, 2, 9, 13, 25, 37]  # 37: 16 beams with an n-gram ban (ROADMAP B45)


def _logits(dtype, seed):
    """Random logits; rows 0-3 carry ties: a repeated maximum, a tie
    straddling the vocab blocks, a constant row and ties inside the top k."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, V)).astype(np.float32)
    x[0, [5, 300, 900]] = 4.0
    x[1, [250, 256, 700]] = 3.5
    x[2] = 0.0
    x[3] = np.round(x[3] * 2)  # integer logits: ties all through the top k
    if dtype == "bfloat16":
        return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).bfloat16()
    return jnp.asarray(x), torch.from_numpy(x)


def _compare(lp, ids, ref_lp, ref_ids):
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref_lp), rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_cpu_branch(dtype, k):
    jx, tx = _logits(dtype, k)
    lp, ids = topk_log_probs(tx, k)
    assert lp.dtype == torch.float32 and ids.dtype == torch.int32 and lp.shape == (N, k)
    _compare(lp, ids, *jax_topk_log_probs(jx, k))
    assert (ids[2] == torch.arange(k)).all()  # a constant row: the lowest ids


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_interpret_kernel(dtype, k):
    """The TPU kernel with blocks of 4 rows by 256 vocab columns: the
    running top-k merges across blocks and the ragged tail is masked."""
    jx, tx = _logits(dtype, 20 + k)
    lp, ids = topk_log_probs_plain(tx, k)
    _compare(lp, ids, *run_kernel_interpret(jx, k, bn=4, bv=256))


def _edge_logits(dtype, seed):
    """Random logits with each row's largest values at its edges: row r's
    maximum in column r (rows 0-5: the first columns) or V - 12 + r (rows
    6-11: the last), a runner-up at the other edge, and the columns on both
    sides of the interpret kernel's 256-column blocks (255, 256; 767, 768)
    just below."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, V)).astype(np.float32)
    for r in range(N):
        top = r if r < 6 else V - 12 + r
        x[r, top] = 6.0
        x[r, V - 1 - r if r < 6 else r - 6] = 5.5
        x[r, [255, 256, 767, 768]] = [5.0, 5.25, 4.5, 4.75]
    if dtype == "bfloat16":
        return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).bfloat16()
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_edge_maxima_match_jax_interpret_kernel(dtype, k):
    """Maxima in a row's first and last columns and at block boundaries (where
    the card's kernel peels a row's unaligned head and tail and cuts its
    runs) come out as the TPU kernel's."""
    jx, tx = _edge_logits(dtype, 40 + k)
    lp, ids = topk_log_probs(tx, k)
    _compare(lp, ids, *run_kernel_interpret(jx, k, bn=4, bv=256))
    top = [r if r < 6 else V - 12 + r for r in range(N)]
    assert ids[:, 0].tolist() == top
