"""The port's fused LM head (mic_tpu_torch/ops/fused_head.py) against
mic_tpu/ops/fused_head.py::fused_head_topk and ::fused_head_topk_q8 on the
CPU.

On the CPU both run materialized-logits versions at float32: ids must be
equal and log-probs and lse within 1e-5 (float32 sums in another order; the
int8 exact/window logits are exact int32 sums on both sides).  V = 1300
spans three 512-wide bucket chunks and eleven 128-wide windows with a
padded tail.  The CUDA kernels are held to the plain versions in
tests/test_torch_cuda_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mic_tpu.ops.fused_head import _bucket_tiles, _bucket_topk_dense
from mic_tpu.ops.fused_head import fused_head_topk as jax_fused_head_topk
from mic_tpu.ops.fused_head import fused_head_topk_q8 as jax_fused_head_topk_q8
from mic_tpu.ops.quant import quantize_array
from mic_tpu_torch.ops.fused_head import (
    SMEM_LIMIT,
    _bucket_kernel,
    STREAM_ROWS,
    bucket_bf16_smem_bytes,
    bucket_bf16_stages,
    bucket_f32_route,
    bucket_f32_splits,
    bucket_f32_stream_smem_bytes,
    bucket_finish,
    bucket_finish_runs,
    bucket_q8_smem_bytes,
    bucket_topk_dense,
    bucket_width,
    chunk_runs,
    chunk_splits,
    fused_head_select,
    fused_head_topk,
    fused_head_topk_q8,
    select_bf16_smem_bytes,
    select_bf16_stages,
    check_bucket_f32,
    select_f32_smem_bytes,
    select_f32_stages,
    select_q8_smem_bytes,
    select_runs,
)
from mic_tpu_torch.ops.topk_lse import NEG_INF, top_k

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(n=6, d=32, v=1300, seed=0):
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(n, d)).astype(np.float32)
    weight = (rng.normal(size=(v, d)) * 0.5).astype(np.float32)
    bias = rng.normal(size=(v,)).astype(np.float32)
    return hidden, weight, bias


def _compare(hidden, weight, bias, k, select):
    ref = jax_fused_head_topk(jnp.asarray(hidden), jnp.asarray(weight).T,
                              jnp.asarray(bias), k, select)
    launches = fused_head_topk.launches
    got = fused_head_topk(torch.from_numpy(hidden), torch.from_numpy(weight),
                          torch.from_numpy(bias), k, select)
    assert fused_head_topk.launches == launches  # CPU tensors: the plain version
    lp, ids, lse = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(got[1].numpy(), ids)
    assert got[1].dtype == torch.int32
    np.testing.assert_allclose(got[0].numpy(), lp, **TOL)
    np.testing.assert_allclose(got[2].numpy(), lse, **TOL)
    return got


def _compare_q8(hidden, weight, bias, k, select):
    """Quantize the weight with mic_tpu, run both int8 heads."""
    wq, ws = (np.array(a) for a in quantize_array(jnp.asarray(weight), axis=1))
    ref = jax_fused_head_topk_q8(jnp.asarray(hidden), jnp.asarray(wq).T, jnp.asarray(ws),
                                 jnp.asarray(bias), k, select)
    counts = fused_head_topk_q8.launches, fused_head_select.launches
    got = fused_head_topk_q8(torch.from_numpy(hidden), torch.from_numpy(wq),
                             torch.from_numpy(ws), torch.from_numpy(bias), k, select)
    assert (fused_head_topk_q8.launches, fused_head_select.launches) == counts
    lp, ids, lse = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(got[1].numpy(), ids)
    assert got[1].dtype == torch.int32
    np.testing.assert_allclose(got[0].numpy(), lp, **TOL)
    np.testing.assert_allclose(got[2].numpy(), lse, **TOL)
    return got


@pytest.mark.parametrize("select", ["bucket", "exact", "window"])
@pytest.mark.parametrize("k", [1, 9])
def test_plain_matches_jax(select, k):
    _compare(*_inputs(seed=k), k, select)


@pytest.mark.parametrize("select", ["bucket", "exact", "window"])
@pytest.mark.parametrize("k", [1, 9])
def test_plain_q8_matches_jax(select, k):
    _compare_q8(*_inputs(seed=10 + k), k, select)


@pytest.mark.parametrize("n,k", [(6, 1), (6, 9), (70, 9)])
def test_plain_f32_matches_pallas_bucket_kernel(n, k):
    """A float32 model's row 4: mic_tpu's bucket kernel in interpret mode
    on float32 hidden rows and table (it casts the table to hidden.dtype)
    against the plain version: ids equal, log-probs and lse within 1e-5."""
    hidden, weight, bias = _inputs(n=n, seed=30 + k)
    ref = jax_fused_head_topk(jnp.asarray(hidden), jnp.asarray(weight).T, jnp.asarray(bias), k,
                              "bucket", interpret=True)
    got = fused_head_topk(torch.from_numpy(hidden), torch.from_numpy(weight),
                          torch.from_numpy(bias), k, "bucket")
    lp, ids, lse = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(got[1].numpy(), ids)
    np.testing.assert_allclose(got[0].numpy(), lp, **TOL)
    np.testing.assert_allclose(got[2].numpy(), lse, **TOL)


@pytest.mark.parametrize("select", ["exact", "window"])
def test_plain_f32_matches_pallas_select_kernel(select):
    """A float32 model's row 5: mic_tpu's exact/window kernel (``_kernel``)
    in interpret mode on float32 hidden rows and table against the plain
    version the float32 select kernel is held to on the card: ids equal,
    log-probs and lse within 1e-5."""
    hidden, weight, bias = _inputs(n=70, seed=50)
    ref = jax_fused_head_topk(jnp.asarray(hidden), jnp.asarray(weight).T, jnp.asarray(bias), 9,
                              select, interpret=True)
    got = fused_head_topk(torch.from_numpy(hidden), torch.from_numpy(weight),
                          torch.from_numpy(bias), 9, select)
    lp, ids, lse = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(got[1].numpy(), ids)
    np.testing.assert_allclose(got[0].numpy(), lp, **TOL)
    np.testing.assert_allclose(got[2].numpy(), lse, **TOL)


@pytest.mark.parametrize("select", ["exact", "window"])
@pytest.mark.parametrize("k", [17, 25, 37])
@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
def test_wide_select_plain_matches_jax(kind, k, select):
    """Past 16 candidates (ROADMAP B45: beam search asks for 2K + 5 a row
    under an n-gram ban, 37 at 16 beams), on V = 5000 (40 windows): the
    bf16 head on bf16-valued hidden rows and table, and the int8 head,
    against mic_tpu's functions; a float32 model's head against mic_tpu's
    exact/window kernel in interpret mode.  Ids equal, log-probs and lse
    within 1e-5."""
    hidden, weight, bias = _inputs(n=6, v=5000, seed=60 + k)
    if kind == "int8":
        _compare_q8(hidden, weight, bias, k, select)
        return
    if kind == "bf16":
        hidden, weight, bias = (torch.from_numpy(a).bfloat16().float().numpy()
                                for a in (hidden, weight, bias))
        _compare(hidden, weight, bias, k, select)
        return
    ref = jax_fused_head_topk(jnp.asarray(hidden), jnp.asarray(weight).T, jnp.asarray(bias), k,
                              select, interpret=True)
    got = fused_head_topk(torch.from_numpy(hidden), torch.from_numpy(weight),
                          torch.from_numpy(bias), k, select)
    lp, ids, lse = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(got[1].numpy(), ids)
    np.testing.assert_allclose(got[0].numpy(), lp, **TOL)
    np.testing.assert_allclose(got[2].numpy(), lse, **TOL)


@pytest.mark.parametrize("splits", [1, 3])
def test_f32_bucket_finish_matches_the_dense_bucket_select(splits):
    """The float32 bucket kernels' outputs, made here from dense f32 logits
    as their warps and blocks fold them (per bucket column, over the chunks
    of a run in order: the fixed-offset sum of exps, the strict running max
    and its id, starting at chunk 0's id), finished by
    ``bucket_finish_runs``: ids equal to the dense bucket select's, lp and
    lse within 1e-5 of it, at bucket widths 512 and 200 over a ragged V,
    with the walk cut into ``splits`` runs."""
    hidden, weight, bias = _inputs(n=5, d=16, v=1300, seed=44)
    logits = torch.from_numpy(hidden) @ torch.from_numpy(weight).T + torch.from_numpy(bias)
    for bv in (512, 200):
        nchunks = -(-1300 // bv)
        l = torch.zeros((splits, 5, bv))
        rmax = torch.full((splits, 5, bv), NEG_INF)
        rid = torch.arange(bv, dtype=torch.int32).repeat(splits, 5, 1)
        for z, (begin, end) in enumerate(chunk_runs(nchunks, splits)):
            for c in range(begin, end):
                cols = torch.arange(c * bv, min((c + 1) * bv, 1300))
                s = logits[:, cols]
                j = cols - c * bv
                l[z][:, j] += torch.exp(torch.clamp(s, max=60.0))
                up = s > rmax[z][:, j]
                rmax[z][:, j] = torch.where(up, s, rmax[z][:, j])
                rid[z][:, j] = torch.where(up, cols.int(), rid[z][:, j])
        lp, ids, lse = bucket_finish_runs(9, l, rmax, rid)
        tv, tids = bucket_topk_dense(logits, 9, bv)
        rlse = torch.logsumexp(logits, dim=-1, keepdim=True)
        assert torch.equal(ids, tids), bv
        torch.testing.assert_close(lse, rlse, **TOL)
        torch.testing.assert_close(lp, tv - rlse, **TOL)


def test_f32_bucket_splits_fill_the_card():
    """The float32 bucket tile runs one 64-row x 64-column block an SM (as
    the bf16 kernel: one run at the flagship N=1024, 16 x 8 blocks on 132
    SMs; 8 runs at N=65); the stream runs of at most 8 chunks a warp (62
    runs of the 489 chunks at bv 512, 326 of 2605 at bv 96), at least 8
    blocks of eight bucket columns an SM (8 runs of 62 chunks at bv 4096);
    never more runs than chunks."""
    assert bucket_f32_splits(1024, 250054, 512, 132, 0) == 1
    assert bucket_f32_splits(65, 250054, 512, 132, 0) == 8
    assert bucket_f32_splits(4, 250054, 512, 132, 4) == 62
    assert bucket_f32_splits(4, 250054, 96, 132, 4) == 326
    assert bucket_f32_splits(4, 250054, 4096, 132, 4) == 8
    assert bucket_f32_splits(4, 997, 512, 132, 4) == 2
    assert bucket_f32_splits(4096, 250054, 512, 132, 0) == 1


def test_f32_routes_and_shared_memory():
    """The float32 head's launch arithmetic as pure functions.  Every D that
    is a multiple of 4 up to 1408 fits 232,448 B on the route each N takes:
    the stream up to ``STREAM_ROWS`` rows (it holds that many in shared
    memory) and the 3xTF32 tile beyond (the bucket tile's ring and the
    select's stream both operands: the same bytes at every D; the bucket
    tile's fit is the kernel's own static_assert).  Every shape the FFMA kernel took is taken (D a multiple of 4, any
    V, any bucket width, 1 <= k <= bv); D off 4 and k past bv raise."""
    assert select_f32_stages() >= 2
    assert select_f32_smem_bytes(select_f32_stages()) <= SMEM_LIMIT
    for d in range(4, 1409, 4):
        for n in (1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 33, 64, 65, 1024, 4096):
            route = bucket_f32_route(n, d)
            assert (route == 0) == (n > STREAM_ROWS), (n, d)
            if route:
                assert n <= route == STREAM_ROWS
                assert bucket_f32_stream_smem_bytes(route, d) <= SMEM_LIMIT
    for n, d, v, k, bv in ((1024, 1024, 250054, 9, 512), (4, 1024, 250054, 1, 512),
                           (65, 100, 997, 9, 96), (70, 100, 997, 16, 200), (1, 4, 1, 1, 1),
                           (3, 1500, 7, 7, 7), (129, 2048, 300, 300, 300)):
        check_bucket_f32(n, d, v, k, bv)
    for n, d, v, k, bv in ((4, 98, 997, 9, 512), (4, 100, 997, 10, 9), (4, 100, 997, 0, 9)):
        with pytest.raises(ValueError, match="mic_fused_head_bucket_f32"):
            check_bucket_f32(n, d, v, k, bv)


def _tf32(x: torch.Tensor, rounded: bool = True) -> torch.Tensor:
    """float32 x with the low 13 mantissa bits dropped: rounded to nearest
    with ties away from zero (cvt.rna.tf32.f32) or truncated."""
    bits = x.view(torch.int32)
    if rounded:
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("rounded", [True, False])
def test_3xtf32_products_keep_f32_accuracy(rounded):
    """An emulation of csrc/tf32x3_wgmma.cuh's products: h and w split as x
    = hi + lo (hi by rounding to TF32's 10 mantissa bits, as cvt.rna does,
    or by truncating, as the kernels do; lo = x -
    hi rounded or truncated alike: the tensor core reads its top 10
    mantissa bits), lo h . hi w + hi h . lo w + hi h . hi w
    summed in float32, against the float64 products, at D=1024 with unit
    hidden rows and a 0.02 table (the flagship init's).  The error stays
    under 1e-5 (the three float32 sums' own rounding, about 2e-6), well
    inside ``_f32_head_case``'s 2e-4 on log-probs; one TF32 product alone
    (hi . hi) misses by more than a tenth of it."""
    rng = np.random.default_rng(7)
    h = torch.from_numpy(rng.normal(size=(16, 1024)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(2048, 1024)) * 0.02).astype(np.float32))

    def split(x):
        hi = _tf32(x, rounded)
        return hi, _tf32(x - hi, rounded)

    (hh, hl), (wh, wl) = split(h), split(w)
    approx = hl @ wh.T + hh @ wl.T + hh @ wh.T
    exact = h.double() @ w.double().T
    err = (approx.double() - exact).abs().max().item()
    one = (hh.double() @ wh.double().T - exact).abs().max().item()
    assert err < 1e-5, err
    assert one > 2e-5, one


@pytest.mark.parametrize("q8", [False, True])
def test_exact_and_window_ties(q8):
    """Zero hidden rows make the logits the bias (the int8 head's zero rows
    quantize to zero).  exact: equal values in id order.  window: inside a
    window the highest lane wins; equal window winners in window order."""
    hidden, weight, _ = _inputs(n=2)
    hidden[:] = 0.0
    bias = np.zeros(1300, np.float32)
    bias[[900, 40, 300]] = 3.0          # three ties, in three windows
    bias[[131, 250]] = 2.0              # one window (128-255): lane 122 wins
    bias[1290] = 2.0                    # the ragged last window
    run = _compare_q8 if q8 else _compare
    exact = run(hidden, weight, bias, 6, "exact")[1]
    window = run(hidden, weight, bias, 5, "window")[1]
    assert exact[0].tolist() == [40, 300, 900, 131, 250, 1290]
    assert window[0].tolist() == [40, 300, 900, 250, 1290]


def test_bucket_ties_take_the_earliest_chunk():
    """With zero hidden states the logits are the bias; equal values in
    every chunk of a bucket column must resolve to the earliest chunk, and
    equal bucket winners to the lower column, as on the TPU."""
    hidden, weight, _ = _inputs(n=3)
    hidden[:] = 0.0
    bias = np.zeros(1300, np.float32)
    bias[[5, 517, 1029]] = 2.0        # one bucket column, three chunks
    bias[[7, 519]] = 2.0              # a second column with the same winner value
    bias[[300, 812]] = 1.0
    _compare(hidden, weight, bias, 4, "bucket")
    _, ids, _ = fused_head_topk(torch.from_numpy(hidden), torch.from_numpy(weight),
                                torch.from_numpy(bias), 4, "bucket")
    assert ids[0, :3].tolist() == [5, 7, 300]


def test_top_k_breaks_ties_toward_the_lower_index():
    x = np.array([[1.0, 3.0, 3.0, NEG_INF, 3.0, 2.0, NEG_INF, 2.0],
                  [-1e7, -1e7, -1e7, -1e7, 0.0, -1e7, -1e7, -1e7]], np.float32)
    ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(x), 6)
    vals, idx = top_k(torch.from_numpy(x), 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_vals))
    assert idx[0].tolist() == [1, 2, 4, 5, 7, 0]


def test_bucket_finish_matches_the_dense_bucket_select():
    """The kernel's host-side finish, fed accumulator planes built from the
    logits as the kernel builds them, gives the plain bucket result."""
    hidden, weight, bias = _inputs(n=4, v=1100, seed=3)
    logits = hidden @ weight.T + bias
    pad = np.full((4, 1536 - 1100), NEG_INF, np.float32)
    s3 = np.concatenate([logits, pad], axis=1).reshape(4, 3, 512)
    l = np.exp(np.minimum(s3, 60.0)).sum(axis=1)
    rmax = s3.max(axis=1)
    rid = (s3.argmax(axis=1) * 512 + np.arange(512)).astype(np.int32)
    lp, ids, lse = bucket_finish(5, torch.from_numpy(l), torch.from_numpy(rmax),
                                 torch.from_numpy(rid))
    ref = fused_head_topk(torch.from_numpy(hidden), torch.from_numpy(weight),
                          torch.from_numpy(bias), 5, "bucket")
    np.testing.assert_array_equal(ids.numpy(), ref[1].numpy())
    np.testing.assert_allclose(lp.numpy(), ref[0].numpy(), **TOL)
    np.testing.assert_allclose(lse.numpy(), ref[2].numpy(), **TOL)


@pytest.mark.parametrize("bv", [None, 64, 96, 200, 256])
def test_bucket_bv_switch_matches_jax(monkeypatch, bv):
    """MIC_TPU_EXPERIMENTAL=bucket_bv=<w> sets the bucket width at every N, as
    mic_tpu's _bucket_tiles reads it (512 when unset), at any width: the
    bf16 and int8 bucket selects' candidates equal mic_tpu's
    _bucket_topk_dense at that width (N=8, D=64, V=4000, k=9; mic_tpu reads
    the switch at trace time, so its oracle is called with the width
    given).  At 64, 96 and 200 the candidates differ from those at 512 on
    this input."""
    if bv is None:
        monkeypatch.delenv("MIC_TPU_EXPERIMENTAL", raising=False)
    else:
        monkeypatch.setenv("MIC_TPU_EXPERIMENTAL", f"bucket_bv={bv}")
    width = bv or 512
    assert bucket_width() == _bucket_tiles(8)[1] == _bucket_tiles(1024)[1] == width
    hidden, weight, bias = _inputs(n=8, d=64, v=4000, seed=21)
    logits = jnp.dot(jnp.asarray(hidden), jnp.asarray(weight).T) + jnp.asarray(bias)
    vals, ids = (np.asarray(a) for a in _bucket_topk_dense(logits, 9, width))
    lse = np.asarray(jax.scipy.special.logsumexp(logits, axis=-1, keepdims=True))
    got = fused_head_topk(torch.from_numpy(hidden), torch.from_numpy(weight),
                          torch.from_numpy(bias), 9, "bucket")
    np.testing.assert_array_equal(got[1].numpy(), ids)
    np.testing.assert_allclose(got[0].numpy(), vals - lse, **TOL)
    wide = np.asarray(_bucket_topk_dense(logits, 9, 512)[1])
    assert (width in (64, 96, 200)) == (not np.array_equal(ids, wide))
    wq, ws = (np.array(a) for a in quantize_array(jnp.asarray(weight), axis=1))
    qlogits = (jnp.dot(jnp.asarray(hidden, jnp.bfloat16), jnp.asarray(wq, jnp.bfloat16).T,
                       preferred_element_type=jnp.float32) * jnp.asarray(ws) + jnp.asarray(bias))
    got = fused_head_topk_q8(torch.from_numpy(hidden), torch.from_numpy(wq), torch.from_numpy(ws),
                             torch.from_numpy(bias), 9, "bucket")
    np.testing.assert_array_equal(got[1].numpy(),
                                  np.asarray(_bucket_topk_dense(qlogits, 9, width)[1]))


H100_SMS = 132


@pytest.mark.parametrize("bv", [64, 96, 192, 200, 512])
@pytest.mark.parametrize("n", [1, 4, 63, 64, 65, 1024])
def test_bucket_runs_cover_every_chunk_once_in_order(n, bv):
    """The bucket kernels' split of the chunk walk, as the wrapper sizes it
    for the H100's 132 SMs at V = 250054 and V = 1300 (ceil(bv / 64) column
    groups, the last one partial when bv is not a multiple of 64):
    consecutive runs, in order, covering every chunk once; and the
    kernels' walk of a run (csrc/fused_head.cu, bucket_kernel: warpgroup w
    takes chunk begin + 2 p + w of stage pair p while it is below the run's
    end) visits each of the run's chunks once, in order."""
    for v in (250054, 1300):
        nchunks = -(-v // bv)
        splits = chunk_splits(n, v, bv, H100_SMS)
        assert 1 <= splits <= nchunks
        assert -(-n // 64) * -(-bv // 64) * splits <= max(H100_SMS, -(-n // 64) * -(-bv // 64))
        runs = chunk_runs(nchunks, splits)
        assert runs[0][0] == 0 and runs[-1][1] == nchunks
        assert all(b < e for b, e in runs)
        assert all(runs[z][1] == runs[z + 1][0] for z in range(splits - 1))
        walked = []
        for b, e in runs:
            pairs = (e - b + 1) // 2
            walked += [c for p in range(pairs) for c in (b + 2 * p, b + 2 * p + 1) if c < e]
        assert walked == list(range(nchunks))


@pytest.mark.parametrize("v", [997, 1997, 250054])
@pytest.mark.parametrize("n", [1, 4, 63, 64, 65, 1024])
def test_bf16_select_runs_cover_every_tile_once(n, v):
    """The bf16 select kernel's walk, as the wrapper sizes it (64-row tiles,
    select_runs over the 128-wide vocab tiles): consecutive runs covering
    every tile once, in order; in each run warpgroup w takes tiles begin +
    2 p + w, so the two warpgroups' walks (each written as a run of its own
    for the merge) together cover the run's tiles once, and its ring slices
    (slice s: depth block (s / 2) % nkb of pair (s / 2) / nkb for
    warpgroup s % 2) visit each (tile, depth block) once at D = 1024."""
    ntiles = -(-v // 128)
    runs = select_runs(n, v, H100_SMS, 64)
    assert 1 <= runs <= ntiles and -(-n // 64) * runs <= H100_SMS
    bounds = [(y * ntiles // runs, (y + 1) * ntiles // runs) for y in range(runs)]
    assert bounds[0][0] == 0 and bounds[-1][1] == ntiles
    assert all(bounds[y][1] == bounds[y + 1][0] for y in range(runs - 1))
    nkb = 1024 // 64
    covered = []
    for b, e in bounds:
        pairs = (e - b + 1) // 2
        slices = [(b + 2 * ((s >> 1) // nkb) + (s & 1), (s >> 1) % nkb)
                  for s in range(2 * pairs * nkb)]
        present = [(tile, kb) for tile, kb in slices if tile < e]
        assert sorted(present) == [(tile, kb) for tile in range(b, e) for kb in range(nkb)]
        walks = [list(range(b + w, e, 2)) for w in (0, 1)]
        assert sorted(walks[0] + walks[1]) == list(range(b, e))
        covered += sorted(walks[0] + walks[1])
    assert covered == list(range(ntiles))


def test_launch_sizes_fill_the_card():
    """N = 1024 rows fill the card with row tiles alone (one run); one image
    of beam 4 (N = 4) splits the walk as far as the SMs allow."""
    assert chunk_splits(1024, 250054, 512, H100_SMS) == 1
    assert chunk_splits(4, 250054, 512, H100_SMS) == 16
    assert select_runs(1024, 250054, H100_SMS, 128) == 16
    assert select_runs(4, 250054, H100_SMS, 128) == 132
    assert select_runs(4, 997, H100_SMS, 128) == 8
    assert select_runs(1024, 250054, H100_SMS, 64) == 8
    assert select_runs(4, 250054, H100_SMS, 64) == 132


@pytest.mark.parametrize("d", list(range(64, 1025, 64)))
def test_int8_head_kernels_fit_shared_memory(d):
    """Both int8 kernels' shared memory, as the kernels compute it, fits a
    block's 232,448 bytes at every D the head takes."""
    assert bucket_q8_smem_bytes(d) <= SMEM_LIMIT
    assert select_q8_smem_bytes(d) <= SMEM_LIMIT


@pytest.mark.parametrize("d", list(range(64, 1409, 64)))
def test_bf16_bucket_kernel_fits_shared_memory(d):
    """The bf16 bucket kernel takes every D the first port's kernel took
    (D % 64 == 0 up to 1408): its ring stages fit a block's 232,448 bytes
    beside the 64 resident hidden rows, three or more of them (the
    warpgroups' 48 KB merge goes through the ring), eight where they
    fit."""
    stages = bucket_bf16_stages(d)
    assert 3 <= stages <= 8
    assert bucket_bf16_smem_bytes(d, stages) <= SMEM_LIMIT
    assert stages == 8 or bucket_bf16_smem_bytes(d, stages + 1) > SMEM_LIMIT
    assert stages * 2 * 64 * 128 >= 3 * 32 * 128 * 4


@pytest.mark.parametrize("d", list(range(32, 1345, 32)))
def test_bf16_select_kernel_fits_shared_memory(d):
    """The bf16 exact/window kernel takes every D the first port's kernel
    took (D % 32 == 0 up to 1344): an even number of slots, two or more,
    fits beside the 64 resident rows (64-deep blocks: a D % 64 == 32 block
    is half zero fill) and the candidate lists; four or more (two a
    warpgroup: its next slice loads while it multiplies one) up to D =
    1024."""
    stages = select_bf16_stages(d)
    assert stages >= 2 and stages % 2 == 0
    assert select_bf16_smem_bytes(d, stages) <= SMEM_LIMIT
    assert stages == 8 or select_bf16_smem_bytes(d, stages + 2) > SMEM_LIMIT
    assert d > 1024 or stages >= 4


@pytest.mark.parametrize("d", list(range(64, 1025, 64)))
def test_wide_select_kernels_fit_shared_memory(d):
    """The selects' wide lists (k = 17-40, 44 entries a row) fit a block's
    232,448 bytes at every D of the flagship's width and below: the bf16
    select with three slots or more (the slots serve both warpgroups in
    turn), the int8 select with its three stages, the float32 select (the
    same at every D) with four, two a warpgroup."""
    stages = select_bf16_stages(d, 37)
    assert stages >= 3
    assert select_bf16_smem_bytes(d, stages, 37) <= SMEM_LIMIT
    assert stages == 8 or select_bf16_smem_bytes(d, stages + 1, 37) > SMEM_LIMIT
    assert select_q8_smem_bytes(d, 37) <= SMEM_LIMIT
    assert select_f32_stages(37) == 4
    assert select_f32_smem_bytes(4, 37) <= SMEM_LIMIT < select_f32_smem_bytes(6, 37)
    # the narrow instances' layouts are as before
    assert select_q8_smem_bytes(d) == select_q8_smem_bytes(d, 16)
    assert select_bf16_stages(d) == select_bf16_stages(d, 16)


@pytest.mark.parametrize("case", ["bucket D=1472", "bucket D=96", "bucket k>bv",
                                  "select D=1376", "select D=48", "select k=41"])
def test_head_kernels_refuse_shapes_they_do_not_take(monkeypatch, case):
    """The kernels' launchers raise on a shape their kernel does not take,
    before any launch (on the CPU tensors here, no library is built): the
    bucket kernel past D = 1408 or off D % 64, k above the bucket width;
    the bf16 select past D = 1344 or off D % 32, k above 40 (ROADMAP
    B41b)."""
    monkeypatch.setenv("MIC_TPU_EXPERIMENTAL", "bucket_bv=8")
    kind, what = case.split(" ")
    d = int(what[2:]) if what.startswith("D=") else 64
    k = {"k>bv": 9, "k=41": 41}.get(what, 1)
    hidden = torch.zeros((4, d), dtype=torch.bfloat16)
    weight = torch.zeros((300, d), dtype=torch.bfloat16)
    bias = torch.zeros((300,))
    with pytest.raises(ValueError, match="B41b" if what == "k=41" else None):
        if kind == "bucket":
            _bucket_kernel("mic_fused_head_bucket_bf16", hidden, weight, None, bias, k)
        else:
            fused_head_select(hidden, None, weight, None, bias, k, False)
