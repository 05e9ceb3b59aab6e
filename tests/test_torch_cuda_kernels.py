"""The port's CUDA kernels against their plain versions, on an NVIDIA card.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX (the card's machine has none); run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances: the kernels compute in bfloat16 with float32 accumulation in
another order than the plain versions: attention outputs within 2e-2 (one
bfloat16 rounding of values near 1), head log-probs within 2e-3 and lse
within 1e-3 relative; cache contents (int8 values and scales too) and
candidate ids exactly; the flash-CE kernels as each test states (bf16 dl
within one bf16 rounding; the save forward's statistics bit-equal to the
non-saving kernel's, its bf16 logits within one bf16 ulp of the f32
logits plus 1e-5; the backward contractions' demb entry by entry within
2**-7 of |dl|^T |h|, dbias within 1e-4 of its largest entry, dh within one
bf16 ulp of its largest).  The int8 exact/window head computes the plain
version's logits bit for bit (exact int32 sums, the same f32 epilogue), so
its ids are equal and its lp and lse within 1e-5; the bf16 exact/window
head's ids may differ only at near-ties, two logits within 1e-2.  The
int8 lazy attention is also bit-equal to plain where every sum is exact (q
= 0, V row scales powers of two) and across reruns.  The
decode-attention kernel's output is within 2e-2 in bf16 and 1e-5 in f32,
its written cache bit-equal; the top-k + logsumexp kernel's ids are equal
and its log-probs within 1e-5 (the same f32 values, the logsumexp summed in
another order).  The beam step's opt-in kernels: the blocked lazy attention
and the cross-attention within 2e-2 (bf16 weights and outputs after f32
sums in another order), the caches they read untouched, the blocked
kernel bit-equal to plain where every sum is exact (q = 0, integer V) and
across reruns; LN -> GEMM within
two bf16 ulps of the size of its terms, |product| + |bias| (the product and
the bias add each rounded once to bf16), plus 2**-8 of sum |xn| |w| (the
LN statistics, summed in another order, can round a bf16 xn the other way),
writing no row past N;
the fused MLP within 1e-2
of its largest output (fc1's bf16 intermediate can round the other way
before the fc2 sum), writing no row past N; both GEMM kernels bit-equal
across reruns.  The
full-sequence attention kernels (small-T forward and backward, flash
forward): outputs within 2e-2 in bf16 (a softmax weight rounded to bf16 the
other way, and the output's own rounding) and 1e-5 in f32, small-T
gradients within 2e-2 (bf16) or 1e-5 (f32) of their largest entry, a flash
row with no valid key exactly 0, reruns bit-equal; the bf16 forwards also
within one bf16 ulp of the size of their terms (sum |p| |v| / l) with at
most 0.2% (small-T) and 1% (flash) of their outputs not bit-equal to the
plain version's, the small-T bf16 gradients within one bf16 ulp of the size
of theirs with at most 1% of their entries not bit-equal, and NaN in the next image's K and V rows never reaching
an output.  The last four kernels:
the merged-cache cross-attention and the int8 cross-attention within 2e-2
at beams {1, 4, 9, 16} and S {1, 37, 50, 64} (and in chunks of rows at
long S), reruns bit-equal, the merged one bit-equal whether its pad rows
hold zeros or NaN (it never reads them), every cross kernel bit-equal to
plain where every sum is exact (q = 0, integer V, power-of-two V scales); the beam permute bit-equal (it copies); the int8 dequant GEMM
within one bf16 ulp of the plain output plus the worst-case error of f32
sums in another order, K * 2**-24 * sum |x| |w|.  A float32 model's
instances: row 2 within 1e-5 (f32 throughout, sums in another order), its
written int8 column and scales bit-equal; rows 3, 13 and 14 (and their
int8 forms under float32 q) within 2e-2, their float32 outputs holding
bfloat16 values, bit-equal to plain on exact sums; row 15 within (D 2**-24
+ 2**-20) of sum |xn| |w| + |bias| (3xTF32 products, statistics summed in
another order); row 16 within ``_mlp_f32_limit``, a tolerance fitted between
sound and faulty kernels; rows 9 and 10 in float32 (the save forward's
statistics bit-equal, its logits within a bf16 ulp; the contractions'
demb and dh within 1e-4 of what dl's own error moves them by); and the
refusals still standing (row 3 past 16 beams, the selects and row 17 past
40 candidates: ROADMAP B41b) raise before any launch.  Rows 3, 5, 5 f32, 6
and 17 past eight beams (B41, B45): row 3 at 9-16 beams in every form, the
selects and row 17 at k in {17, 25, 37, 40} against plain, ties too, and
the wide instances' first 16 candidates equal to the narrow ones'.
"""

import pytest
import torch

from mic_tpu_torch import _build
from mic_tpu_torch.core.config import CaptionerConfig, DecodeConfig, DecoderConfig, VisionConfig
from mic_tpu_torch.core.params import make_serving_params
from mic_tpu_torch.models.captioner import Captioner, init_params
from mic_tpu_torch.ops.flash_ce import (
    flash_ce_backward,
    flash_ce_backward_dl,
    flash_ce_backward_dl_plain,
    flash_ce_backward_save,
    flash_ce_backward_save_plain,
    flash_ce_contraction,
    flash_ce_dl,
    flash_ce_dl_plain,
    flash_ce_forward,
    flash_ce_forward_plain,
    main_columns,
)
from mic_tpu_torch.ops.fused_head import (
    _bucket_f32,
    _logits_q8,
    _logits_q8_bucket,
    bucket_f32_route,
    fused_head_select,
    fused_head_topk,
    fused_head_topk_plain,
    fused_head_topk_q8,
    fused_head_topk_q8_plain,
)
from mic_tpu_torch.ops.beam_permute import beam_permute, beam_permute_plain
from mic_tpu_torch.ops.cross_attention import (
    fused_cross_attention,
    fused_cross_attention_dma,
    fused_cross_attention_dma_plain,
    fused_cross_attention_plain,
    fused_cross_attention_q8,
)
from mic_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_plain
from mic_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_plain,
    decode_splits,
    lane_groups,
    walk_partition,
)
from mic_tpu_torch.ops import flash_attention as flash
from mic_tpu_torch.ops import flash_ce as fce
from mic_tpu_torch.ops import small_attention as small
from mic_tpu_torch.nn.layers import ACTIVATIONS
from mic_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_plain, gelu_erf
from mic_tpu_torch.ops.image_prep import preprocess_images
from mic_tpu_torch.ops.lazy_attention import (
    blocked_layout,
    build_ancestry_mask,
    fused_lazy_attention,
    fused_lazy_attention_plain,
    lazy_attention,
    lazy_attention_plain,
    lazy_attention_q8,
    lazy_attention_q8_plain,
)
from mic_tpu_torch.ops.ln_gemm import ln_gemm, ln_gemm_plain
from mic_tpu_torch.ops.quant import quantize_array, quantize_rows_dynamic
from mic_tpu_torch.ops.topk_lse import _RUN_COLS, topk_log_probs, topk_log_probs_plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("index", [0, 1, 9, 15])
def test_lazy_attention_kernel_matches_plain(cuda, index):
    b, beams, t, heads, hd = 3, 4, 16, 2, 128
    g = torch.Generator(device=cuda).manual_seed(index)

    def rand(*shape, scale=0.5):
        return (torch.randn(shape, generator=g, device=cuda) * scale).bfloat16()

    q, ks, vs = rand(b, beams, hd, scale=0.3), rand(b, beams, hd), rand(b, beams, hd)
    ck, cv = rand(b * beams, t, hd), rand(b * beams, t, hd)
    ck[:, index:] = 0
    cv[:, index:] = 0
    anc = torch.randint(0, beams, (b, beams, t), generator=g, device=cuda, dtype=torch.int32)
    anc[:, :, index:] = torch.arange(beams, device=cuda, dtype=torch.int32)[None, :, None]
    pk, pv = ck.clone(), cv.clone()
    launches = lazy_attention.launches
    out = lazy_attention(q, ck, cv, ks, vs, anc, index, heads)
    ref = lazy_attention_plain(q, pk, pv, ks, vs, anc, index, heads)
    torch.cuda.synchronize()
    assert lazy_attention.launches == launches + 1
    assert torch.equal(ck, pk) and torch.equal(cv, pv)
    assert not ck[:, index + 1:].any() and not cv[:, index + 1:].any()
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("k", [1, 9])
def test_fused_head_kernel_matches_plain(cuda, k):
    n, d, v = 70, 128, 1300  # two row tiles, the second partial; a ragged vocab tail
    g = torch.Generator(device=cuda).manual_seed(k)
    hidden = torch.randn((n, d), generator=g, device=cuda).bfloat16()
    weight = (torch.randn((v, d), generator=g, device=cuda) * 0.2).bfloat16()
    bias = (torch.randn((v,), generator=g, device=cuda) * 0.1).bfloat16()
    launches = fused_head_topk.launches
    lp, ids, lse = fused_head_topk(hidden, weight, bias, k)
    rlp, rids, rlse = fused_head_topk_plain(hidden, weight, bias, k, "bucket")
    torch.cuda.synchronize()
    assert fused_head_topk.launches == launches + 1
    assert torch.equal(ids, rids)
    torch.testing.assert_close(lp, rlp, rtol=0, atol=2e-3)
    torch.testing.assert_close(lse, rlse, rtol=1e-3, atol=0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bv", [32, 64, 96, 200, 256, 512, 1024])
@pytest.mark.parametrize("q8", [False, True])
def test_fused_head_bucket_kernels_take_the_bucket_bv_width(cuda, monkeypatch, q8, bv):
    """MIC_TPU_EXPERIMENTAL=bucket_bv=<w>: the bucket kernels at width w give
    the plain version's candidates at w, also where w is not a multiple of
    their 64-wide column group (the group's columns past w, which read the
    next chunk's rows, are left out)."""
    monkeypatch.setenv("MIC_TPU_EXPERIMENTAL", f"bucket_bv={bv}")
    hidden, weight, bias, wq, ws = _head_inputs(cuda, 70, 128, 1300, bv)
    if q8:
        got = fused_head_topk_q8(hidden, wq, ws, bias, 9, "bucket")
        ref = fused_head_topk_q8_plain(hidden, wq, ws, bias, 9, "bucket")
    else:
        got = fused_head_topk(hidden, weight, bias, 9, "bucket")
        ref = fused_head_topk_plain(hidden, weight, bias, 9, "bucket")
    torch.cuda.synchronize()
    assert torch.equal(got[1], ref[1])
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=2e-3)
    torch.testing.assert_close(got[2], ref[2], rtol=1e-3, atol=0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n", [4, 70, 1088])  # the walk split into runs of chunks, or not
def test_fused_head_kernel_earliest_chunk_wins_ties(cuda, n):
    """Every vocab chunk a copy of the first: each bucket column ties across
    all chunks, and the kernel keeps chunk 0's id however the walk is split."""
    d, v = 128, 512 * 7 + 100
    g = torch.Generator(device=cuda).manual_seed(n)
    hidden = torch.randn((n, d), generator=g, device=cuda).bfloat16()
    first = (torch.randn((512, d), generator=g, device=cuda) * 0.2).bfloat16()
    weight = first.repeat(8, 1)[:v].contiguous()
    bias = torch.zeros((v,), device=cuda, dtype=torch.bfloat16)
    lp, ids, lse = fused_head_topk(hidden, weight, bias, 9)
    rlp, rids, rlse = fused_head_topk_plain(hidden, weight, bias, 9, "bucket")
    torch.cuda.synchronize()
    assert torch.equal(ids, rids % 512)
    torch.testing.assert_close(lp, rlp, rtol=0, atol=2e-3)
    torch.testing.assert_close(lse, rlse, rtol=1e-3, atol=0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n", [4, 70, 1088])  # the walk split into runs of chunks, or not
def test_fused_head_q8_bucket_kernel_earliest_chunk_wins_ties(cuda, n):
    """The int8 bucket kernel on a weight whose every chunk is a copy of the
    first: each bucket column ties across all chunks, which its two
    warpgroups walk alternately, and chunk 0's id stands however the walk
    is split."""
    d, v = 128, 512 * 7 + 100
    g = torch.Generator(device=cuda).manual_seed(300 + n)
    hidden = torch.randn((n, d), generator=g, device=cuda).bfloat16()
    first = (torch.randn((512, d), generator=g, device=cuda) * 0.2).bfloat16()
    wq, ws = quantize_array(first.repeat(8, 1)[:v].contiguous(), axis=1)
    bias = torch.zeros((v,), device=cuda, dtype=torch.bfloat16)
    lp, ids, lse = fused_head_topk_q8(hidden, wq, ws, bias, 9, "bucket")
    rlp, rids, rlse = fused_head_topk_q8_plain(hidden, wq, ws, bias, 9, "bucket")
    torch.cuda.synchronize()
    assert torch.equal(ids, rids % 512)
    torch.testing.assert_close(lp, rlp, rtol=0, atol=2e-3)
    torch.testing.assert_close(lse, rlse, rtol=1e-3, atol=0)


@pytest.mark.requires_cuda
def test_generate_runs_through_both_kernels(cuda):
    config = CaptionerConfig(
        vision=VisionConfig.tiny(),
        decoder=DecoderConfig.tiny(vocab_size=1100, d_model=128, num_heads=2,
                                   ffn_dim=256, max_position_embeddings=64),
        dtype="bfloat16",
    )
    params = make_serving_params(init_params(config, torch.Generator(device=cuda).manual_seed(0),
                                             cuda))
    images = torch.randint(0, 256, (2, 40, 40, 3), dtype=torch.uint8, device=cuda)
    px = preprocess_images(images, 32, torch.bfloat16)
    lazy_attention.launches = fused_head_topk.launches = 0
    out = Captioner(config).generate(params, px, num_beams=4, max_length=12,
                                     forced_bos_token_id=7)
    torch.cuda.synchronize()
    assert lazy_attention.launches == config.decoder.num_layers * out.steps
    assert fused_head_topk.launches >= out.steps
    assert (out.sequences[:, 1] == 7).all() and torch.isfinite(out.scores).all()


# (images, beams, T, heads, index) of the int8 kernel's cases: the earlier
# T=16 cases; beams 1, 4 and 8 at indices 0, 1, 17 and T - 1; the
# flagship's decode shape; and the largest (K, T) the earlier kernel
# launched (a block of 32 K threads, 8 K T bytes of shared memory within
# the default 48 KB)
_Q8_ATTENTION_CASES = (
    [(3, 4, 16, 2, index) for index in (0, 1, 9, 15)]
    + [(3, beams, 32, 2, index) for beams in (1, 4, 8) for index in (0, 1, 17, 31)]
    + [(256, 4, 64, 16, index) for index in (0, 1, 17, 63)]
    + [(2, 32, 192, 2, 191), (1, 1, 6144, 2, 6143)]
)


def _q8_attention_inputs(cuda, b, beams, t, heads, index, seed):
    hd = heads * 64
    g = torch.Generator(device=cuda).manual_seed(seed)

    def rand(*shape, scale=0.5):
        return (torch.randn(shape, generator=g, device=cuda) * scale).bfloat16()

    def int8_cache():
        q, s = quantize_rows_dynamic(rand(b * beams, t, hd))
        return {"q": q, "s": s[..., 0].contiguous()}

    q, ks, vs = rand(b, beams, hd, scale=0.3), rand(b, beams, hd), rand(b, beams, hd)
    ck, cv = int8_cache(), int8_cache()
    anc = torch.randint(0, beams, (b, beams, t), generator=g, device=cuda, dtype=torch.int32)
    anc[:, :, index:] = torch.arange(beams, device=cuda, dtype=torch.int32)[None, :, None]
    return q, ck, cv, ks, vs, anc


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,beams,t,heads,index", _Q8_ATTENTION_CASES)
def test_lazy_attention_q8_kernel_matches_plain(cuda, b, beams, t, heads, index):
    """Outputs within 2e-2 of the plain version's, the step column's int8
    values and scales bit-equal, every other column untouched, and a rerun
    (on the cache the first call wrote) bit-equal."""
    q, ck, cv, ks, vs, anc = _q8_attention_inputs(cuda, b, beams, t, heads, index, 100 + index)
    before = [{n: a.clone() for n, a in c.items()} for c in (ck, cv)]
    pk, pv = ({n: a.clone() for n, a in c.items()} for c in (ck, cv))
    launches = lazy_attention_q8.launches
    out = lazy_attention_q8(q, ck, cv, ks, vs, anc, index, heads)
    written = [{n: a.clone() for n, a in c.items()} for c in (ck, cv)]
    again = lazy_attention_q8(q, ck, cv, ks, vs, anc, index, heads)
    ref = lazy_attention_q8_plain(q, pk, pv, ks, vs, anc, index, heads)
    torch.cuda.synchronize()
    assert lazy_attention_q8.launches == launches + 2
    assert torch.equal(out, again)
    others = torch.arange(t, device=cuda) != index
    for mine, plain, old, first in zip((ck, cv), (pk, pv), before, written):
        for name in ("q", "s"):
            assert torch.equal(mine[name], plain[name])
            assert torch.equal(mine[name], first[name])
            assert torch.equal(mine[name][:, others], old[name][:, others])
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("beams", [1, 4])
def test_lazy_attention_q8_kernel_exact_sums(cuda, beams):
    """q = 0 at index 63: every score is 0, the 64 live terms (63 cached and
    the step row) weigh 1/64 each, and with V row scales that are powers of
    two bf16 holds every weight exactly and every f32 sum is exact, in any
    order: the output is bit-equal to the plain version's."""
    b, t, heads, index = 8, 64, 16, 63
    q, ck, cv, ks, vs, anc = _q8_attention_inputs(cuda, b, beams, t, heads, index, 7 + beams)
    q = torch.zeros_like(q)
    g = torch.Generator(device=cuda).manual_seed(beams)
    cv["s"] = torch.exp2(torch.randint(-8, 1, cv["s"].shape, generator=g, device=cuda)
                         .float()).contiguous()
    pk, pv = ({n: a.clone() for n, a in c.items()} for c in (ck, cv))
    out = lazy_attention_q8(q, ck, cv, ks, vs, anc, index, heads)
    ref = lazy_attention_q8_plain(q, pk, pv, ks, vs, anc, index, heads)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def _head_inputs(cuda, n, d, v, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    hidden = torch.randn((n, d), generator=g, device=cuda).bfloat16()
    weight = (torch.randn((v, d), generator=g, device=cuda) * 0.2).bfloat16()
    bias = (torch.randn((v,), generator=g, device=cuda) * 0.1).bfloat16()
    wq, ws = quantize_array(weight, axis=1)
    return hidden, weight, bias, wq, ws


@pytest.mark.requires_cuda
@pytest.mark.parametrize("k", [1, 9])
def test_fused_head_q8_bucket_kernel_matches_plain(cuda, k):
    hidden, _, bias, wq, ws = _head_inputs(cuda, 70, 128, 1300, 20 + k)
    launches = fused_head_topk_q8.launches
    lp, ids, lse = fused_head_topk_q8(hidden, wq, ws, bias, k, "bucket")
    rlp, rids, rlse = fused_head_topk_q8_plain(hidden, wq, ws, bias, k, "bucket")
    torch.cuda.synchronize()
    assert fused_head_topk_q8.launches == launches + 1
    assert torch.equal(ids, rids)
    torch.testing.assert_close(lp, rlp, rtol=0, atol=2e-3)
    torch.testing.assert_close(lse, rlse, rtol=1e-3, atol=0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n,v", [(70, 1997), (4, 4099)])  # a partial row tile; ragged vocab
@pytest.mark.parametrize("k", [1, 9])
@pytest.mark.parametrize("select", ["exact", "window"])
@pytest.mark.parametrize("q8", [False, True])
def test_fused_head_select_kernel_matches_plain(cuda, q8, select, k, n, v):
    hidden, weight, bias, wq, ws = _head_inputs(cuda, n, 128, v, n + k)
    launches = fused_head_select.launches
    if q8:
        out = fused_head_topk_q8(hidden, wq, ws, bias, k, select)
        ref = fused_head_topk_q8_plain(hidden, wq, ws, bias, k, select)
    else:
        out = fused_head_topk(hidden, weight, bias, k, select)
        ref = fused_head_topk_plain(hidden, weight, bias, k, select)
    torch.cuda.synchronize()
    assert fused_head_select.launches == launches + 1
    (lp, ids, lse), (rlp, rids, rlse) = out, ref
    if q8:
        assert torch.equal(ids, rids)
        torch.testing.assert_close(lp, rlp, rtol=0, atol=1e-5)
        torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=0)
    else:
        logits = hidden.float() @ weight.float().T + bias.float()
        gap = (logits.gather(1, ids.long()) - logits.gather(1, rids.long())).abs()
        assert bool((gap[ids != rids] < 1e-2).all())
        torch.testing.assert_close(lse, rlse, rtol=1e-3, atol=0)
        torch.testing.assert_close(lp[ids == rids], rlp[ids == rids], rtol=0, atol=2e-3)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("q8", [False, True])
def test_fused_head_select_kernel_ties(cuda, q8):
    """Zero hidden rows: the logits are the bias.  exact: equal values in id
    order; window: the highest lane inside a window, then window order --
    across the row tiles and runs the kernel cuts the vocab into."""
    _, weight, _, wq, ws = _head_inputs(cuda, 4, 128, 5000, 30)
    hidden = torch.zeros((4, 128), device=cuda, dtype=torch.bfloat16)
    bias = torch.zeros((5000,), device=cuda, dtype=torch.bfloat16)
    bias[[4900, 40, 300, 2600]] = 3.0
    bias[[131, 250, 4999]] = 2.0
    for select, k, want in (("exact", 7, [40, 300, 2600, 4900, 131, 250, 4999]),
                            ("window", 6, [40, 300, 2600, 4900, 250, 4999])):
        if q8:
            ids = fused_head_topk_q8(hidden, wq, ws, bias, k, select)[1]
        else:
            ids = fused_head_topk(hidden, weight, bias, k, select)[1]
        torch.cuda.synchronize()
        assert ids.tolist() == [want] * 4, (select, ids.tolist())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n", [70, 1024])
@pytest.mark.parametrize("k", [17, 25, 37, 40])
@pytest.mark.parametrize("select", ["exact", "window"])
@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
def test_fused_head_select_wide_kernels_match_plain(cuda, kind, select, k, n):
    """The selects' wide instances (17 <= k <= 40, ROADMAP B45) against
    plain on V = 5000 (40 windows), D = 128: bf16 as the narrow one's
    tolerances, int8 ids equal and lp within 1e-5, float32 within
    ``_f32_head_close``; a rerun bit-equal; k = 16 (the narrow instance) on
    the same rows gives the wide one's first 16 ids."""
    hidden, weight, bias, wq, ws = _head_inputs(cuda, n, 128, 5000, 40 + n + k)

    def run(kk):
        if kind == "int8":
            return fused_head_topk_q8(hidden, wq, ws, bias, kk, select)
        if kind == "f32":
            return fused_head_topk(hidden.float(), weight.float(), bias.float(), kk, select)
        return fused_head_topk(hidden, weight, bias, kk, select)

    launches = fused_head_select.launches
    out, again, narrow = run(k), run(k), run(16)
    if kind == "int8":
        ref = fused_head_topk_q8_plain(hidden, wq, ws, bias, k, select)
    elif kind == "f32":
        ref = fused_head_topk_plain(hidden.float(), weight.float(), bias.float(), k, select)
    else:
        ref = fused_head_topk_plain(hidden, weight, bias, k, select)
    torch.cuda.synchronize()
    assert fused_head_select.launches == launches + 3
    assert all(torch.equal(a, c) for a, c in zip(out, again))
    assert torch.equal(narrow[1], out[1][:, :16])
    (lp, ids, lse), (rlp, rids, rlse) = out, ref
    if kind == "int8":
        assert torch.equal(ids, rids)
        torch.testing.assert_close(lp, rlp, rtol=0, atol=1e-5)
        torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=0)
    elif kind == "f32":
        _f32_head_close(out, ref, hidden.float() @ weight.float().T + bias.float())
    else:
        logits = hidden.float() @ weight.float().T + bias.float()
        gap = (logits.gather(1, ids.long()) - logits.gather(1, rids.long())).abs()
        assert bool((gap[ids != rids] < 1e-2).all())
        torch.testing.assert_close(lse, rlse, rtol=1e-3, atol=0)
        torch.testing.assert_close(lp[ids == rids], rlp[ids == rids], rtol=0, atol=2e-3)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
def test_fused_head_select_wide_kernel_ties(cuda, kind):
    """Zero hidden rows over a bias of ties (20 columns at 3, 20 at 2, the
    rest 0) at k = 37: the wide instances' ids equal the plain version's
    (the lower id first; the highest lane in a window, then window order),
    across the runs the kernels cut the vocab into; 41 candidates raise
    naming ROADMAP B41b before any launch."""
    _, weight, _, wq, ws = _head_inputs(cuda, 4, 128, 5000, 31)
    hidden = torch.zeros((4, 128), device=cuda, dtype=torch.bfloat16)
    bias = torch.zeros((5000,), device=cuda, dtype=torch.bfloat16)
    cols = torch.randperm(5000, generator=torch.Generator().manual_seed(5))[:40].to(cuda)
    bias[cols[:20]], bias[cols[20:]] = 3.0, 2.0

    def run(select, k):
        if kind == "int8":
            return fused_head_topk_q8(hidden, wq, ws, bias, k, select)
        if kind == "f32":
            return fused_head_topk(hidden.float(), weight.float(), bias.float(), k, select)
        return fused_head_topk(hidden, weight, bias, k, select)

    for select in ("exact", "window"):
        ids = run(select, 37)[1]
        ref = fused_head_topk_plain(hidden, weight, bias, 37, select)[1]
        torch.cuda.synchronize()
        assert torch.equal(ids, ref), (select, ids[0].tolist(), ref[0].tolist())
        launches = fused_head_select.launches
        with pytest.raises(ValueError, match="B41b"):
            run(select, 41)
        assert fused_head_select.launches == launches


_HEAD_TABLES = {}


def _q8_table(cuda, d, v):
    """An int8 tied table (V, D) with its row scales and a bf16 bias, made
    once a shape (the largest is the flagship's 256 MB int8 weight)."""
    if (d, v) not in _HEAD_TABLES:
        g = torch.Generator(device=cuda).manual_seed(d + v)
        weight = (torch.randn((v, d), generator=g, device=cuda) * 0.2).bfloat16()
        bias = (torch.randn((v,), generator=g, device=cuda) * 0.1).bfloat16()
        wq, ws = quantize_array(weight, axis=1)
        _HEAD_TABLES[(d, v)] = (wq, ws, bias)
    return _HEAD_TABLES[(d, v)]


HEAD_ROWS = [1, 4, 63, 64, 65, 1024]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("v", [1300, 250054])
@pytest.mark.parametrize("d", [128, 1024])
@pytest.mark.parametrize("n", HEAD_ROWS)
def test_fused_head_q8_bucket_kernel_sweep(cuda, n, d, v):
    """The int8 bucket kernel (wgmma, TMA) against its plain version across
    row counts around its 64-row tile, both widths and a ragged vocab: lp
    within 2e-3, lse within 1e-3 relative, ids equal but at near-ties (two
    logits within 1e-2: bf16 products summed in another order)."""
    wq, ws, bias = _q8_table(cuda, d, v)
    hidden = torch.randn((n, d), generator=torch.Generator(device=cuda).manual_seed(n),
                         device=cuda).bfloat16()
    launches = fused_head_topk_q8.launches
    lp, ids, lse = fused_head_topk_q8(hidden, wq, ws, bias, 9, "bucket")
    rlp, rids, rlse = fused_head_topk_q8_plain(hidden, wq, ws, bias, 9, "bucket")
    torch.cuda.synchronize()
    assert fused_head_topk_q8.launches == launches + 1
    logits = hidden.float() @ wq.float().T * ws.float() + bias.float()
    gap = (logits.gather(1, ids.long()) - logits.gather(1, rids.long())).abs()
    assert bool((gap[ids != rids] < 1e-2).all())
    torch.testing.assert_close(lp, rlp, rtol=0, atol=2e-3)
    torch.testing.assert_close(lse, rlse, rtol=1e-3, atol=0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("v", [1300, 250054])
@pytest.mark.parametrize("d", [128, 1024])
def test_fused_head_q8_bucket_kernel_exact_sums(cuda, d, v):
    """Small integer hidden values make every product and sum exact on both
    sides: the ids are the plain version's and each winner's lp is exactly
    the plain logit (acc * ws + b, unfused) minus the kernel's lse.  The
    bias is full f32 (with a bf16 bias an FMA would round the same), the
    logits below the bucket sum's clamp at 60."""
    wq, ws, _ = _q8_table(cuda, d, v)
    g = torch.Generator(device=cuda).manual_seed(d)
    hidden = torch.randint(-1, 2, (65, d), generator=g, device=cuda).bfloat16()
    bias = torch.randn((v,), generator=g, device=cuda) * 0.1
    lp, ids, lse = fused_head_topk_q8(hidden, wq, ws, bias, 9, "bucket")
    rlp, rids, rlse = fused_head_topk_q8_plain(hidden, wq, ws, bias, 9, "bucket")
    torch.cuda.synchronize()
    assert torch.equal(ids, rids)
    logits = _logits_q8_bucket(hidden, wq, ws, bias)
    assert torch.equal(lp, logits.gather(1, ids.long()) - lse)
    torch.testing.assert_close(lse, rlse, rtol=1e-3, atol=0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("v", [1997, 250054])
@pytest.mark.parametrize("d", [128, 1024])
@pytest.mark.parametrize("n", HEAD_ROWS)
@pytest.mark.parametrize("select", ["exact", "window"])
def test_fused_head_q8_select_kernel_sweep(cuda, select, n, d, v):
    """The int8 exact/window kernel (wgmma, TMA) against its plain version:
    ids equal, lse within 1e-5 relative and lp within 1e-4 (sums of exps in
    another order), and the logits bit-equal: each lp is exactly the plain
    logit at its id minus the kernel's lse, the subtraction the merge
    kernel does."""
    wq, ws, bias = _q8_table(cuda, d, v)
    hidden = torch.randn((n, d), generator=torch.Generator(device=cuda).manual_seed(n),
                         device=cuda).bfloat16()
    launches = fused_head_select.launches
    lp, ids, lse = fused_head_topk_q8(hidden, wq, ws, bias, 9, select)
    rlp, rids, rlse = fused_head_topk_q8_plain(hidden, wq, ws, bias, 9, select)
    torch.cuda.synchronize()
    assert fused_head_select.launches == launches + 1
    assert torch.equal(ids, rids)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=0)
    torch.testing.assert_close(lp, rlp, rtol=0, atol=1e-4)
    logits = _logits_q8(*quantize_rows_dynamic(hidden), wq, ws, bias)
    assert torch.equal(lp, logits.gather(1, ids.long()) - lse)


_BF16_TABLES = {}


def _bf16_table(cuda, d, v):
    """A bf16 tied table (V, D) and bias, made once a shape."""
    if (d, v) not in _BF16_TABLES:
        g = torch.Generator(device=cuda).manual_seed(3 * d + v)
        weight = (torch.randn((v, d), generator=g, device=cuda) * 0.02).bfloat16()
        bias = (torch.randn((v,), generator=g, device=cuda) * 0.1).bfloat16()
        _BF16_TABLES[(d, v)] = (weight, bias)
    return _BF16_TABLES[(d, v)]


def _bf16_head_check(hidden, weight, bias, got, ref, every_lp):
    """The bf16 heads against their plain version: ids equal but at
    near-ties (two logits within 1e-2: bf16 products summed in another
    order), lse within 1e-3 relative, lp within 2e-3: every entry
    (``every_lp``, the bucket) or where the ids agree (exact/window)."""
    (lp, ids, lse), (rlp, rids, rlse) = got, ref
    logits = hidden.float() @ weight.float().T + bias.float()
    gap = (logits.gather(1, ids.long()) - logits.gather(1, rids.long())).abs()
    assert bool((gap[ids != rids] < 1e-2).all())
    torch.testing.assert_close(lse, rlse, rtol=1e-3, atol=0)
    if not every_lp:
        same = ids == rids
        lp, rlp = lp[same], rlp[same]
    torch.testing.assert_close(lp, rlp, rtol=0, atol=2e-3)


BF16_HEAD_ROWS = [1, 4, 65, 1024]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("k", [1, 9, 16])
@pytest.mark.parametrize("v", [997, 250054])
@pytest.mark.parametrize("d", [64, 1024, 1408])
@pytest.mark.parametrize("n", BF16_HEAD_ROWS)
def test_fused_head_bucket_kernel_sweep(cuda, n, d, v, k):
    """The bf16 bucket kernel (wgmma with both operands in shared memory,
    fed by TMA) against its plain version across row counts, the smallest,
    the flagship's and the largest D it takes, a ragged and the flagship
    vocab, and k."""
    weight, bias = _bf16_table(cuda, d, v)
    hidden = torch.randn((n, d), generator=torch.Generator(device=cuda).manual_seed(n + k),
                         device=cuda).bfloat16()
    launches = fused_head_topk.launches
    got = fused_head_topk(hidden, weight, bias, k, "bucket")
    ref = fused_head_topk_plain(hidden, weight, bias, k, "bucket")
    torch.cuda.synchronize()
    assert fused_head_topk.launches == launches + 1
    _bf16_head_check(hidden, weight, bias, got, ref, True)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("v", [997, 250054])
@pytest.mark.parametrize("d", [64, 1024])
def test_fused_head_bucket_kernel_exact_sums(cuda, d, v):
    """Integer hidden values and a weight of multiples of 2**-6 make every
    product and every partial sum exact in f32 on both sides: the ids are
    the plain version's and each winner's lp is exactly the plain logit
    (acc + b, the bias in full f32) minus the kernel's lse."""
    g = torch.Generator(device=cuda).manual_seed(d + v)
    weight = (torch.randint(-8, 9, (v, d), generator=g, device=cuda) * 2.0 ** -6).bfloat16()
    hidden = torch.randint(-4, 5, (65, d), generator=g, device=cuda).bfloat16()
    bias = torch.randn((v,), generator=g, device=cuda) * 0.1
    lp, ids, lse = fused_head_topk(hidden, weight, bias, 9, "bucket")
    rlp, rids, rlse = fused_head_topk_plain(hidden, weight, bias, 9, "bucket")
    torch.cuda.synchronize()
    assert torch.equal(ids, rids)
    logits = hidden.float() @ weight.float().T + bias
    assert torch.equal(lp, logits.gather(1, ids.long()) - lse)
    torch.testing.assert_close(lse, rlse, rtol=1e-3, atol=0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("k", [1, 9, 16])
@pytest.mark.parametrize("v", [997, 250054])
@pytest.mark.parametrize("d", [64, 96, 1024, 1344])
@pytest.mark.parametrize("n", BF16_HEAD_ROWS)
@pytest.mark.parametrize("select", ["exact", "window"])
def test_fused_head_select_kernel_sweep(cuda, select, n, d, v, k):
    """The bf16 exact/window kernel (m64n128k16 with both operands in shared
    memory, fed by TMA) against its plain version across row counts, D
    (64, a D % 64 == 32 whose last slice is half TMA zero fill, the
    flagship's and the largest it takes), a ragged and the flagship vocab,
    and k (for window at most the vocab's windows: 8 at V = 997)."""
    weight, bias = _bf16_table(cuda, d, v)
    hidden = torch.randn((n, d), generator=torch.Generator(device=cuda).manual_seed(7 * n + k),
                         device=cuda).bfloat16()
    if select == "window":
        k = min(k, -(-v // 128))
    launches = fused_head_select.launches
    got = fused_head_topk(hidden, weight, bias, k, select)
    ref = fused_head_topk_plain(hidden, weight, bias, k, select)
    torch.cuda.synchronize()
    assert fused_head_select.launches == launches + 1
    _bf16_head_check(hidden, weight, bias, got, ref, False)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("select", ["bucket", "exact", "window"])
def test_int8_generate_runs_through_the_int8_kernels(cuda, select):
    config = CaptionerConfig(
        vision=VisionConfig.tiny(),
        decoder=DecoderConfig.tiny(vocab_size=1300, d_model=128, num_heads=2,
                                   ffn_dim=256, max_position_embeddings=64),
        decode=DecodeConfig(fused_select=select),
        dtype="bfloat16",
    )
    params = make_serving_params(init_params(config, torch.Generator(device=cuda).manual_seed(1),
                                             cuda))
    images = torch.randint(0, 256, (2, 40, 40, 3), dtype=torch.uint8, device=cuda)
    px = preprocess_images(images, 32, torch.bfloat16)
    lazy_attention_q8.launches = fused_head_topk_q8.launches = fused_head_select.launches = 0
    out = Captioner(config).generate(params, px, num_beams=4, max_length=12,
                                     forced_bos_token_id=7, quantize="int8", kv_quant="int8")
    torch.cuda.synchronize()
    assert lazy_attention_q8.launches == config.decoder.num_layers * out.steps
    head = fused_head_topk_q8 if select == "bucket" else fused_head_select
    assert head.launches >= out.steps
    assert (out.sequences[:, 1] == 7).all() and torch.isfinite(out.scores).all()


@pytest.mark.requires_cuda
def test_quantization_on_the_card_equals_the_cpu(cuda):
    """Weights and activation rows quantize to the same int8 values and f32
    scales on the card as on the CPU (where they equal mic_tpu's)."""
    g = torch.Generator().manual_seed(3)
    w = (torch.randn((3, 96, 200), generator=g) * 0.05).bfloat16()
    x = torch.randn((37, 96), generator=g)
    for axis in (1, 2):
        for got, ref in zip(quantize_array(w.to(cuda), axis), quantize_array(w, axis)):
            assert torch.equal(got.cpu(), ref)
    for got, ref in zip(quantize_rows_dynamic(x.to(cuda)), quantize_rows_dynamic(x)):
        assert torch.equal(got.cpu(), ref)


def _ce_inputs(cuda, n, d, v, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    h = torch.randn((n, d), generator=g, device=cuda).bfloat16()
    w = (torch.randn((v, d), generator=g, device=cuda) * 0.05).bfloat16()
    b = torch.randn((v,), generator=g, device=cuda) * 0.1
    y = torch.randint(0, v, (n,), generator=g, device=cuda, dtype=torch.int32)
    k = min(n, 3)
    y[:k] = v - 1 - torch.arange(k, device=cuda, dtype=torch.int32)  # labels in the ragged tail
    return h, w, b, y


# (N, V, D) around the walk's 128-row and 256-column tiles: one row, a row
# tile short by one, one row past a tile; a vocab a column short of a tile,
# a column past one, ragged; every D the walk takes, 64 to the flagship's
# 1024; labels in the last, partial vocab tile (_ce_inputs)
_CE_WALK_SHAPES = [(70, 997, 128), (64, 4099, 128), (1, 997, 64), (127, 257, 128),
                   (129, 255, 1024), (129, 4099, 64), (127, 250054, 1024)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n,v,d", _CE_WALK_SHAPES)
def test_flash_ce_forward_kernel_matches_plain(cuda, n, v, d):
    """lse and label logit within 1e-5 relative, sum of logits within 1e-4 of
    the row's sum of |logits|; a second launch bit-equal."""
    h, w, b, y = _ce_inputs(cuda, n, d, v, n)
    launches = flash_ce_forward.launches
    out = flash_ce_forward(h, w, b, y)
    again = flash_ce_forward(h, w, b, y)
    ref = flash_ce_forward_plain(h, w, b, y)
    torch.cuda.synchronize()
    assert flash_ce_forward.launches == launches + 2
    assert all(torch.equal(a, c) for a, c in zip(out, again))
    torch.testing.assert_close(out[0], ref[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out[1], ref[1], rtol=1e-5, atol=1e-5)
    l1 = (h.float() @ w.float().T + b).abs().sum(-1)
    assert bool(((out[2] - ref[2]).abs() <= 1e-4 * l1).all())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n,v,d", [(70, 997, 128), (1, 257, 64), (127, 255, 128),
                                   (129, 4099, 1024)])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_flash_ce_dl_kernel_matches_plain(cuda, smoothing, n, v, d):
    """dl within one bf16 rounding of the plain dl (and of its terms where
    they cancel), rows with rowscale 0 all
    zero, columns >= V never written, dbias within 1e-4 of its largest
    entry; dh/demb from the kernel's dl; a second launch bit-equal.  Shapes
    around the walk's 128 x 256 tiles, labels in the last vocab tile."""
    import mic_tpu_torch.ops.flash_ce as flash

    h, w, b, y = _ce_inputs(cuda, n, d, v, 7)
    lse = flash_ce_forward_plain(h, w, b, y)[0]
    rs = torch.rand((n,), generator=torch.Generator(device=cuda).manual_seed(8), device=cuda)
    if n > 1:  # a lone row keeps its rowscale
        rs[::5] = 0.0
    # dl written into a buffer with guard entries past its end, which must stay untouched
    buf = torch.full((n * v + 64,), 7.0, dtype=torch.bfloat16, device=cuda)
    launches = flash_ce_backward_dl.launches
    dl, dbias = flash_ce_dl(h, w, b, y, lse, rs, smoothing, out=buf[: n * v].view(n, v))
    dh, demb, dbias2 = flash_ce_backward_dl(h, w, b, y, lse, rs, smoothing)
    again = flash_ce_backward_dl(h, w, b, y, lse, rs, smoothing)
    dl_ref = flash._dl_plain(h, w, b, y, lse, rs, smoothing)
    torch.cuda.synchronize()
    assert flash_ce_backward_dl.launches == launches + 3
    assert torch.equal(dbias, dbias2)
    dl = dl.float()
    assert bool(buf[n * v:].eq(7.0).all())
    assert bool((dl[rs == 0] == 0).all())
    # one bf16 rounding of dl, plus one of its terms |p| + |target| where
    # p - target cancels
    low, conf_low = flash._targets(smoothing, v)
    target = torch.full_like(dl_ref, low)
    target.scatter_(1, y[:, None].long(), low + conf_low)
    terms = dl_ref.abs() + 2 * target * rs[:, None]
    assert bool(((dl - dl_ref.bfloat16().float()).abs()
                 <= (dl_ref.abs() + terms) * 2.0**-7 + 1e-30).all())
    torch.testing.assert_close(dbias, dl_ref.sum(0), rtol=0,
                               atol=1e-4 * dl_ref.sum(0).abs().max().item())
    assert all(torch.equal(a, c) for a, c in zip((dh, demb, dbias), again))
    ref = flash_ce_backward_dl_plain(h, w, b, y, lse, rs, smoothing)
    torch.testing.assert_close(demb, ref[1], rtol=0, atol=1e-3 * ref[1].abs().max().item())
    torch.testing.assert_close(dh.float(), ref[0].float(), rtol=0,
                               atol=2**-7 * ref[0].float().abs().max().item())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n,v,d", [(70, 997, 128), (64, 4099, 128), (70, 97, 128),
                                   (1, 997, 64), (129, 200, 128), (127, 300, 64),
                                   (129, 4099, 1024)])  # v_main 512, 4096, 0, 512, 128, 256, 4096
def test_flash_ce_save_forward_kernel_matches_plain(cuda, n, v, d):
    """The save forward: lse and sum of logits bit-equal to the non-saving
    kernel's; the f32 tail within 1e-5 of the plain version's; the bf16
    logits within one bf16 ulp of the f32 logits plus 1e-5 (the f32 sums in
    another order; near zero that is more than a logit's own ulp); a second
    launch bit-equal.  V = 200 puts v_main (128) inside a 256-wide tile."""
    h, w, b, y = _ce_inputs(cuda, n, d, v, n + 3)
    launches = flash_ce_forward.launches, flash_ce_forward.save_launches
    out = flash_ce_forward(h, w, b, y, save=True)
    again = flash_ce_forward(h, w, b, y, save=True)
    stats = flash_ce_forward(h, w, b, y)
    ref = flash_ce_forward_plain(h, w, b, y, save=True)
    torch.cuda.synchronize()
    assert (flash_ce_forward.launches, flash_ce_forward.save_launches) == (launches[0] + 1,
                                                                           launches[1] + 2)
    assert all(torch.equal(a, c) for a, c in zip(out, again))
    assert all(torch.equal(a, c) for a, c in zip(out[:3], stats))
    v_main = main_columns(v)
    assert out[3].shape == (n, v_main) and out[4].shape == (n, v - v_main)
    exact = (h.float() @ w.float().T + b)[:, :v_main]
    assert bool(((out[3].float() - exact).abs() <= _bf16_ulp(exact) + 1e-5).all())
    torch.testing.assert_close(out[4], ref[4], rtol=0, atol=1e-5)


# (N, V, D) of the backward contractions: N around their 64-row steps and
# the save blocks' 128 rows (1, 63, 65, 129, with the earlier 64 and 70),
# D under, at and past a warpgroup's 256-wide chunk and at the split
# route's widest, 1024 (64, 192, 128, 1024; 1280 for the save route, whose
# D has no bound); V ragged for the 64-row sweep steps, with v_main (the
# save route's span) 512 (V = 997), 4096 (4099), 128 (200), 256 (300) and
# 0 (97: all tail).
_CE_BWD_SHAPES = [(70, 997, 128), (64, 4099, 128), (70, 97, 128),
                  (1, 997, 64), (1, 200, 192), (1, 4099, 1024),
                  (63, 300, 64), (63, 997, 192), (63, 200, 1024),
                  (65, 4099, 64), (65, 97, 192), (65, 997, 1024),
                  (129, 200, 64), (129, 4099, 192), (129, 300, 1024)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n,v,d", _CE_BWD_SHAPES + [(65, 997, 1280)])
@pytest.mark.parametrize("route", ["split", "save"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_flash_ce_backward_kernels_match_plain(cuda, smoothing, route, n, v, d):
    """The split and save contractions against their plain versions on the
    same inputs (the split route's is the dl route's; the save route reads
    the plain version's saved logits).  demb entry by entry within 2**-7 of
    |dl|^T |h|, dl the plain bf16 dl: each side rounds dl to bf16 from f32
    sums in another order, at most one bf16 ulp apart, so a vocab row that
    holds no label is held to its own (small) size.  dbias within 1e-4 of
    its largest entry, dh within one bf16 ulp of its largest; a second
    launch bit-equal.  Labels sit in the last, partial vocab tile and on
    the save span's last column; every fifth row has rowscale 0.  Each
    contraction, launched alone into the front of a buffer of sentinels,
    writes its output and nothing past it.  The split route's D stops at
    _BWD_MAX_D (1024) and raises past it."""
    h, w, b, y = _ce_inputs(cuda, n, d, v, 2 * n + v + d)
    v_main = main_columns(v)
    if n > 3 and v_main:
        y[3] = v_main - 1
    lse, _, _, lg, tail = flash_ce_forward_plain(h, w, b, y, save=True)
    rs = torch.rand((n,), generator=torch.Generator(device=cuda).manual_seed(v), device=cuda)
    rs[::5] = 0.0
    if route == "split":
        fn, plain, extra = flash_ce_backward, flash_ce_backward_dl_plain, ()
        logits, cols = None, v
    else:
        fn, plain, extra, logits, cols = (flash_ce_backward_save, flash_ce_backward_save_plain,
                                          (lg, tail), lg, v_main)
    if route == "split" and d > fce._BWD_MAX_D:
        with pytest.raises(ValueError):
            fn(h, w, b, y, lse, rs, smoothing, None, *extra)
        return
    launches = fn.launches
    out = fn(h, w, b, y, lse, rs, smoothing, None, *extra)
    again = fn(h, w, b, y, lse, rs, smoothing, None, *extra)
    ref = plain(h, w, b, y, lse, rs, smoothing, None, *extra)
    torch.cuda.synchronize()
    # two calls, each one launch of the pair; none where the save route's
    # logits are all tail
    assert fn.launches == launches + (0 if cols == 0 else 2)
    assert all(torch.equal(a, c) for a, c in zip(out, again))
    assert out[0].dtype == torch.bfloat16 and out[1].shape == (v, d) and out[2].shape == (v,)
    dl = flash_ce_dl_plain(h, w, b, y, lse, rs, smoothing)[0].float()
    assert bool(((out[1] - ref[1]).abs() <= 2**-7 * (dl.abs().T @ h.float().abs())).all())
    for got, want, frac in ((out[0], ref[0], 2**-7), (out[2], ref[2], 1e-4)):
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=frac * want.float().abs().max().item())
    if cols == 0:
        return
    ops = fce._backward_operands("test", h, w, b, y, lse, rs, None, logits)
    sentinel = 7.0
    bufs = [torch.full((rows * width + 64,), sentinel, device=cuda)
            for rows, width in ((cols, d), (cols, 1), (n, d))]
    demb, dbias, dh = (buf[:rows * width].view(rows, width) if width > 1 else buf[:rows]
                       for buf, (rows, width) in zip(bufs, ((cols, d), (cols, 1), (n, d))))
    fce._contract("grad_w", h, *ops, smoothing, logits, demb, dbias)
    fce._contract("grad_h", h, *ops, smoothing, logits, dh)
    torch.cuda.synchronize()
    assert all(bool(buf[-64:].eq(sentinel).all()) for buf in bufs)
    assert torch.equal(demb, out[1][:cols]) and torch.equal(dbias, out[2][:cols])
    if route == "split":
        assert torch.equal(dh.to(h.dtype), out[0])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("trans", [0, 1])
def test_contraction_operand_forms_match_mm(cuda, trans):
    """The contractions' operand forms alone (csrc/head_wgmma.cuh): a
    register A fragment loaded by ldmatrix from a 64 x 64 box in the
    128-byte swizzle, K-major or (trans) stored transposed, times a
    row-major (64, 256) B read MN-major through desc_sw128_mn (boxes 8 KB
    apart, k atoms 1 KB apart), on one m64n256k16 chain: the f32 products
    of bf16 values summed in another order, within 1e-5 of torch.mm."""
    g = torch.Generator(device=cuda).manual_seed(40 + trans)
    a = torch.randn((64, 64), generator=g, device=cuda).bfloat16()
    b = torch.randn((64, 256), generator=g, device=cuda).bfloat16()
    stored = a.T.contiguous() if trans else a
    out = torch.full((64, 256), float("nan"), device=cuda)
    err = _build.lib().mic_flash_ce_operand_probe(
        stored.data_ptr(), b.data_ptr(), out.data_ptr(), trans,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "mic_flash_ce_operand_probe")
    torch.cuda.synchronize()
    torch.testing.assert_close(out, torch.mm(a.float(), b.float()), rtol=0, atol=1e-5)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("route", ["split", "save"])
def test_flash_ce_contraction_alone_equals_the_route(cuda, route):
    """Each contraction launched alone gives the route's outputs bit for bit
    (the main span's, for the save route) and counts no launch."""
    n, v = 70, 997
    h, w, b, y = _ce_inputs(cuda, n, 128, v, 5)
    lse, _, _, lg, tail = flash_ce_forward_plain(h, w, b, y, save=True)
    rs = torch.rand((n,), generator=torch.Generator(device=cuda).manual_seed(6), device=cuda)
    args = (h, w, b, y, lse, rs, 0.1)
    if route == "split":
        fn, extra, logits, cols = flash_ce_backward, (), None, v
    else:
        fn, extra, logits, cols = flash_ce_backward_save, (lg, tail), lg, main_columns(v)
    launches = fn.launches
    demb, dbias = flash_ce_contraction("grad_w", *args, logits_main=logits)
    dh = flash_ce_contraction("grad_h", *args, logits_main=logits)
    assert fn.launches == launches
    out = fn(*args, None, *extra)
    torch.cuda.synchronize()
    assert torch.equal(demb, out[1][:cols]) and torch.equal(dbias, out[2][:cols])
    if route == "split":
        assert torch.equal(dh.to(h.dtype), out[0])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("index", [0, 1, 9, 15])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_attention_kernel_matches_plain(cuda, dtype, index):
    """Three heads (a block of four warps, one idle): the output, the written
    column bit-equal to the plain version's, every other layer and column
    untouched."""
    layers, n, t, heads, dh, layer = 3, 5, 16, 3, 64, 1
    g = torch.Generator(device=cuda).manual_seed(200 + index)

    def rand(*shape, scale=0.5):
        return (torch.randn(shape, generator=g, device=cuda) * scale).to(dtype)

    q, ks, vs = rand(n, 1, heads, dh, scale=0.3), rand(n, 1, heads, dh), rand(n, 1, heads, dh)
    ck, cv = rand(layers, n, t, heads, dh), rand(layers, n, t, heads, dh)
    before = (ck.clone(), cv.clone())
    pk, pv = ck.clone(), cv.clone()
    launches = decode_attention.launches
    out = decode_attention(q, ks, vs, ck, cv, layer, index)
    ref = decode_attention_plain(q, ks, vs, pk, pv, layer, index)
    torch.cuda.synchronize()
    assert decode_attention.launches == launches + 1
    assert out.dtype == dtype and out.shape == q.shape
    assert torch.equal(ck, pk) and torch.equal(cv, pv)
    keep = torch.ones((layers, n, t), dtype=torch.bool, device=cuda)
    keep[layer, :, index] = False
    for mine, old in zip((ck, cv), before):
        assert torch.equal(mine[keep], old[keep])
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


def _split_end(n, heads, t, dtype):
    """The last position of the first split of the walk at index t - 1, as
    the wrapper sizes it on this card."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    groups = lane_groups(torch.empty((), dtype=dtype).element_size())
    splits = decode_splits(n, heads, t - 1, sms, groups)
    return max(max(ts, default=0) for ts in walk_partition(t - 1, splits, groups)[0])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("where", ["first", "second", "split_end", "last"])
@pytest.mark.parametrize("t", [16, 64, 128])
@pytest.mark.parametrize("n", [1, 4, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_attention_kernel_split_walk(cuda, dtype, n, t, where):
    """The flagship's 16 heads at N rows (the walk split as the wrapper
    sizes it: 4 ways at a few rows, none at 256), at index 0, 1, the last
    position of the first split and T - 1: the output within 2e-2 (bf16)
    or 1e-5 (f32), the written column bit-equal to the plain version's,
    every other layer and column untouched."""
    layers, heads, dh, layer = 2, 16, 64, 1
    index = {"first": 0, "second": 1, "split_end": _split_end(n, heads, t, dtype),
             "last": t - 1}[where]
    g = torch.Generator(device=cuda).manual_seed(400 + n + t + index)

    def rand(*shape, scale=0.5):
        return (torch.randn(shape, generator=g, device=cuda) * scale).to(dtype)

    q, ks, vs = rand(n, 1, heads, dh, scale=0.3), rand(n, 1, heads, dh), rand(n, 1, heads, dh)
    ck, cv = rand(layers, n, t, heads, dh), rand(layers, n, t, heads, dh)
    before = (ck.clone(), cv.clone())
    pk, pv = ck.clone(), cv.clone()
    launches = decode_attention.launches
    out = decode_attention(q, ks, vs, ck, cv, layer, index)
    ref = decode_attention_plain(q, ks, vs, pk, pv, layer, index)
    torch.cuda.synchronize()
    assert decode_attention.launches == launches + 1
    assert torch.equal(ck, pk) and torch.equal(cv, pv)
    keep = torch.ones((layers, n, t), dtype=torch.bool, device=cuda)
    keep[layer, :, index] = False
    for mine, old in zip((ck, cv), before):
        assert torch.equal(mine[keep], old[keep])
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.requires_cuda
def test_decode_attention_kernel_reads_no_position_past_index(cuda):
    """NaN in every cached position past the index (and in the column the
    step overwrites) never reaches an output."""
    layers, n, t, heads, dh, layer, index = 2, 4, 64, 16, 64, 0, 40
    g = torch.Generator(device=cuda).manual_seed(7)
    q, ks, vs = ((torch.randn((n, 1, heads, dh), generator=g, device=cuda) * s).bfloat16()
                 for s in (0.3, 0.5, 0.5))
    ck, cv = ((torch.randn((layers, n, t, heads, dh), generator=g, device=cuda) * 0.5)
              .bfloat16() for _ in range(2))
    pk, pv = ck.clone(), cv.clone()
    for c in (ck, cv):
        c[layer, :, index:] = float("nan")
    out = decode_attention(q, ks, vs, ck, cv, layer, index)
    ref = decode_attention_plain(q, ks, vs, pk, pv, layer, index)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
    assert torch.isnan(ck[layer, :, index + 1:].float()).all()


@pytest.mark.requires_cuda
def test_decode_attention_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros((2, 1, 2, 32), device=cuda, dtype=torch.bfloat16)
    cache = torch.zeros((1, 2, 4, 2, 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        decode_attention(x, x, x, cache, cache.clone(), 0, 0)
    x = torch.zeros((2, 1, 2, 64), device=cuda, dtype=torch.bfloat16)
    cache = torch.zeros((1, 2, 4, 2, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        decode_attention(x.float(), x, x, cache, cache.clone(), 0, 0)
    with pytest.raises(ValueError, match="index"):
        decode_attention(x, x, x, cache, cache.clone(), 0, 4)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("v", [997, 20011, 250054])  # odd: rows of every 16-byte alignment
@pytest.mark.parametrize("n", [1, 5, 70, 256])        # one run to many; a partial block
@pytest.mark.parametrize("k", [1, 2, 9, 13, 16, 17, 25, 37, 40])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_topk_lse_kernel_matches_plain(cuda, dtype, k, n, v):
    g = torch.Generator(device=cuda).manual_seed(300 + k)
    logits = (torch.randn((n, v), generator=g, device=cuda) * 2).to(dtype)
    launches = topk_log_probs.launches
    lp, ids = topk_log_probs(logits, k)
    again = topk_log_probs(logits, k)
    rlp, rids = topk_log_probs_plain(logits, k)
    torch.cuda.synchronize()
    assert topk_log_probs.launches == launches + 2
    assert lp.dtype == torch.float32 and ids.dtype == torch.int32 and lp.shape == (n, k)
    assert torch.equal(ids, rids)
    torch.testing.assert_close(lp, rlp, rtol=0, atol=1e-5)
    assert torch.equal(lp, again[0]) and torch.equal(ids, again[1])


def _planted_logits(g, n, v, offset, dtype):
    """(n, v) logits starting ``offset`` elements past an aligned address
    (rows of every 16-byte alignment as the rows go), each row with 16
    values from 60, 59, ..., 45 planted above the N(0, 4) rest (exact in
    bf16): rows r % 4 == 0 in their first 8 and last 8 columns (the largest
    in a column that moves with r), rows r % 4 == 1 on both sides of up to 8
    of their run boundaries (columns j c - 1 and j c, c the columns of a
    run where one wave holds every row's most runs, as it does at N=24) and
    the rest inside, rows r % 4 == 2 inside, rows r % 4 == 3 with their
    largest value twice, in the last column and 40 columns before it (the
    last run peels the one and walks the other: the lower id must win at
    k=1); rows r % 8 in {1, 2} a third -inf.  -> (logits, the planted
    columns (n, 16) in rank order)."""
    x = torch.randn((n * v + offset,), generator=g, device=g.device)[offset:].view(n, v) * 2
    c = -(-v // -(-v // _RUN_COLS))
    bounds = [j * c for j in range(1, -(-v // c))] or [v // 2]
    cols = torch.empty((n, 16), dtype=torch.int64)
    values = torch.arange(60.0, 44.0, -1.0)
    for r in range(n):
        kind, vals = r % 4, values
        if kind == 0:
            edge = list(range(8)) + list(range(v - 8, v))
            turn = r // 4 * 3 % 16
            picked = edge[turn:] + edge[:turn]
        elif kind == 1:
            at = [bounds[(r + i) % len(bounds)] for i in range(min(8, len(bounds)))]
            picked = [col for b in at for col in (b - 1, b)]
            picked += [v // 3 + 7 * i for i in range(16 - len(picked))]
        elif kind == 2:
            picked = [v // 5 + r + 13 * i for i in range(16)]
        else:
            picked = [v - 41, v - 1] + [v // 4 + 5 * i for i in range(14)]
            vals = torch.cat([values[:1], values[:15]])
        if r % 8 in (1, 2):
            x[r, ::3] = -torch.inf
        cols[r] = torch.tensor(picked)
        x[r, cols[r].to(x.device)] = vals.to(x.device)
    out = torch.empty((n * v + offset,), dtype=dtype, device=x.device)[offset:].view(n, v)
    out.copy_(x)
    return out, cols


@pytest.mark.requires_cuda
@pytest.mark.parametrize("v", [997, 20011, 250054])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_topk_lse_kernel_finds_planted_columns(cuda, dtype, v):
    """Rows of every 16-byte alignment (the logits 0-7 elements past an
    aligned address) whose largest values sit in their first and last 8
    columns and on both sides of run boundaries, some a third -inf: ids
    equal to plain and to the planted columns, reruns bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(330)
    for offset in range(8):
        x, cols = _planted_logits(g, 24, v, offset, dtype)
        for k in (1, 9, 16, 17, 37, 40):
            lp, ids = topk_log_probs(x, k)
            again = topk_log_probs(x, k)
            rlp, rids = topk_log_probs_plain(x, k)
            torch.cuda.synchronize()
            assert torch.equal(ids, rids), (offset, k)
            assert torch.equal(ids[:, :16].cpu().long(), cols[:, :k]), (offset, k)
            torch.testing.assert_close(lp, rlp, rtol=0, atol=1e-5)
            assert torch.equal(lp, again[0]) and torch.equal(ids, again[1])


@pytest.mark.requires_cuda
def test_topk_lse_kernel_ties_go_to_the_lower_id(cuda):
    """A constant row, a maximum repeated across the runs the kernel cuts the
    vocab into, and integer logits with ties all through the top k."""
    v = 20011
    g = torch.Generator(device=cuda).manual_seed(7)
    logits = torch.randn((4, v), generator=g, device=cuda)
    logits[0] = 0.0
    logits[1, [19000, 5, 9000]] = 9.0
    logits[2] = torch.round(logits[2] * 2)
    logits[3, ::3] = -torch.inf
    for dtype in (torch.float32, torch.bfloat16):
        x = logits.to(dtype)
        for k in (13, 16, 17, 37, 40):
            lp, ids = topk_log_probs(x, k)
            again = topk_log_probs(x, k)
            rlp, rids = topk_log_probs_plain(x, k)
            torch.cuda.synchronize()
            assert torch.equal(ids, rids)
            assert ids[0].tolist() == list(range(k)) and ids[1, :3].tolist() == [5, 9000, 19000]
            torch.testing.assert_close(lp, rlp, rtol=0, atol=1e-5)
            assert torch.equal(lp, again[0]) and torch.equal(ids, again[1])
    launches = topk_log_probs.launches
    with pytest.raises(ValueError, match="B41b"):
        topk_log_probs(logits, 41)
    assert topk_log_probs.launches == launches


@pytest.mark.requires_cuda
def test_greedy_generate_runs_through_the_new_kernels(cuda, monkeypatch):
    """Greedy on the dense logits under fused_decode,pallas_topk: the
    decode-attention kernel once a layer a step, the top-k + logsumexp kernel
    once a step but on the forced-BOS step."""
    monkeypatch.setenv("MIC_TPU_EXPERIMENTAL", "fused_decode,pallas_topk")
    monkeypatch.setenv("MIC_TPU_FUSED_HEAD", "0")
    config = CaptionerConfig(
        vision=VisionConfig.tiny(),
        decoder=DecoderConfig.tiny(vocab_size=1100, d_model=128, num_heads=2,
                                   ffn_dim=256, max_position_embeddings=64),
        dtype="bfloat16",
    )
    params = make_serving_params(init_params(config, torch.Generator(device=cuda).manual_seed(2),
                                             cuda))
    images = torch.randint(0, 256, (3, 40, 40, 3), dtype=torch.uint8, device=cuda)
    px = preprocess_images(images, 32, torch.bfloat16)
    decode_attention.launches = topk_log_probs.launches = 0
    out = Captioner(config).generate(params, px, num_beams=1, max_length=12,
                                     forced_bos_token_id=7, forced_eos_token_id=None)
    torch.cuda.synchronize()
    assert decode_attention.launches == config.decoder.num_layers * out.steps
    assert topk_log_probs.launches == out.steps - 1
    assert (out.sequences[:, 1] == 7).all() and torch.isfinite(out.scores).all()


def _blocked_inputs(cuda, g, b, beams, t, heads, q8, scale=0.5, dtype=torch.bfloat16):
    """q, the caches (in ``dtype``, or int8 dicts with per-head scales) and
    the step rows of row 3, q and the step rows in ``dtype``."""
    hd = heads * 64

    def rand(*shape, scale=scale):
        return (torch.randn(shape, generator=g, device=cuda) * scale).to(dtype)

    def cache():
        if not q8:
            return rand(b * beams, t, hd)
        values, scales = quantize_rows_dynamic(rand(b * beams, t, heads, 64))
        return {"q": values.reshape(b * beams, t, hd), "s": scales[..., 0].contiguous()}

    return rand(b, beams, hd, scale=0.3), cache(), cache(), rand(b, beams, hd), rand(b, beams, hd)


def _blocked_masks(cuda, g, b, beams, t, index):
    """An ancestry mask, random bits (several source rows live for one beam
    at one position) and no cached row live (every beam on its step row
    alone), each strict t < index."""
    anc = torch.randint(0, beams, (b, beams, t), generator=g, device=cuda, dtype=torch.int32)
    random_bits = torch.randint(0, 2, (b, beams * t, beams), generator=g, device=cuda)
    live = (torch.arange(t, device=cuda) < index).repeat(beams)[None, :, None]
    return {"ancestry": build_ancestry_mask(anc, index),
            "random bits": (random_bits * live).to(torch.int8),
            "step only": torch.zeros((b, beams * t, beams), dtype=torch.int8, device=cuda)}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("index", [0, 1, 17, 63])
@pytest.mark.parametrize("beams", [1, 4, 8, 9, 12, 16])
@pytest.mark.parametrize("q8", [False, True])
def test_fused_lazy_attention_kernel_matches_plain(cuda, q8, beams, index):
    """Mode "1" on an ancestry mask, on a mask of random bits (several
    source rows live for one beam at one position) and with only the step
    rows live: the cache untouched, a rerun bit-equal."""
    b, t, heads = 3, 64, 2
    g = torch.Generator(device=cuda).manual_seed(100 + 10 * beams + index)
    q, ck, cv, ks, vs = _blocked_inputs(cuda, g, b, beams, t, heads, q8)
    for name, amask in _blocked_masks(cuda, g, b, beams, t, index).items():
        before = [{n: a.clone() for n, a in c.items()} if q8 else c.clone() for c in (ck, cv)]
        launches = fused_lazy_attention.launches
        out = fused_lazy_attention(q, ck, cv, ks, vs, amask, beams, heads, positions=index)
        again = fused_lazy_attention(q, ck, cv, ks, vs, amask, beams, heads, positions=index)
        ref = fused_lazy_attention_plain(q, ck, cv, ks, vs, amask, beams, heads)
        torch.cuda.synchronize()
        assert fused_lazy_attention.launches == launches + 2
        assert torch.equal(out, again), name
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2, msg=name)
        for c, old in zip((ck, cv), before):
            assert all(torch.equal(c[n], old[n]) for n in old) if q8 else torch.equal(c, old)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("beams", [1, 3, 4, 8, 9, 12, 15, 16])
@pytest.mark.parametrize("q8", [False, True])
def test_fused_lazy_attention_kernel_exact_sums(cuda, q8, beams):
    """With q = 0 every admitted score is 0: each weight is 1 / (live rows
    + 1), the same f32 quotient in both versions, rounded to bf16 (times the
    V scale in int8), and with integer V values every sum is exact, so the
    kernel's outputs equal the plain version's bit for bit whatever order
    it sums in: a listed row dropped, or the step weight left unrounded,
    shows."""
    b, t, heads, index = 3, 64, 2, 63
    hd = heads * 64
    g = torch.Generator(device=cuda).manual_seed(200 + beams)
    q = torch.zeros((b, beams, hd), dtype=torch.bfloat16, device=cuda)
    ks = torch.randn((b, beams, hd), generator=g, device=cuda).bfloat16()
    vs = torch.randint(-3, 4, (b, beams, hd), generator=g, device=cuda).bfloat16()
    ck = torch.randn((b * beams, t, hd), generator=g, device=cuda).bfloat16()
    values = torch.randint(-3, 4, (b * beams, t, hd), generator=g, device=cuda)
    if q8:
        ck = {"q": values.to(torch.int8), "s": torch.ones((b * beams, t, heads), device=cuda)}
        cv = {"q": values.flip(1).to(torch.int8).contiguous(),
              "s": torch.randint(1, 3, (b * beams, t, heads), generator=g, device=cuda).float()}
    else:
        cv = values.bfloat16()
    for name, amask in _blocked_masks(cuda, g, b, beams, t, index).items():
        out = fused_lazy_attention(q, ck, cv, ks, vs, amask, beams, heads, positions=index)
        ref = fused_lazy_attention_plain(q, ck, cv, ks, vs, amask, beams, heads)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), name


@pytest.mark.requires_cuda
@pytest.mark.parametrize("beams,index", [(8, 850), (1, 58048), (16, 210), (15, 258)])
@pytest.mark.parametrize("q8", [False, True])
def test_fused_lazy_attention_kernel_walks_every_row_past_the_list(cuda, q8, beams, index):
    """Eight beams at 850 positions (sixteen at 210): the list of admitted
    rows no longer fits beside the scores (blocked_layout), so the walk
    takes every row, the dead ones at weight 0, in chunks of a few dozen
    staged rows; one beam at 58048 positions (the most the earlier kernel
    took) and fifteen at 258: a few staged rows at a time, K's and V's
    taking turns in one buffer."""
    b, t, heads = 1, index + 6, 2
    compact, stage, shared, _ = blocked_layout(beams, index, q8)
    assert not compact and stage < 128 and shared == (beams in (1, 15))
    g = torch.Generator(device=cuda).manual_seed(300)
    q, ck, cv, ks, vs = _blocked_inputs(cuda, g, b, beams, t, heads, q8)
    for name, amask in _blocked_masks(cuda, g, b, beams, t, index).items():
        out = fused_lazy_attention(q, ck, cv, ks, vs, amask, beams, heads, positions=index)
        ref = fused_lazy_attention_plain(q, ck, cv, ks, vs, amask, beams, heads)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2, msg=name)


def _cross_inputs(cuda, b, beams, s, heads, seed, exact=False):
    """q (B, K, H*Dh) and (B, S, H, Dh) K/V in bf16; with ``exact`` q = 0
    (every score 0) and integer V, so every sum of the V product is exact."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = (torch.randn((b, beams, heads * 64), generator=g, device=cuda) * 0.3).bfloat16()
    ek = (torch.randn((b, s, heads, 64), generator=g, device=cuda) * 0.5).bfloat16()
    ev = (torch.randn((b, s, heads, 64), generator=g, device=cuda) * 0.5).bfloat16()
    if exact:
        q.zero_()
        ev = torch.randint(-8, 9, (b, s, heads, 64), generator=g, device=cuda).bfloat16()
    return q, ek, ev


def _merged(c, s_pad, fill=0.0):
    """(B, S, H, Dh) -> the merged (B, S_pad, H*Dh) cache, ``fill`` past S."""
    b, s = c.shape[:2]
    out = torch.full((b, s_pad, c.shape[2] * c.shape[3]), fill, dtype=c.dtype, device=c.device)
    out[:, :s] = c.reshape(b, s, -1)
    return out


def _q8_cache(c, layout="canonical"):
    values, scales = quantize_rows_dynamic(c)
    shape = c.shape if layout == "canonical" else (*c.shape[:2], c.shape[2] * c.shape[3])
    return {"q": values.reshape(shape), "s": scales[..., 0].contiguous()}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("beams", [1, 4, 9, 16])
@pytest.mark.parametrize("s", [50, 37, 1, 64])
def test_fused_cross_attention_kernel_matches_plain(cuda, s, beams):
    """Any beam count (tiles of 16 beams) and encoder length; a rerun
    bit-equal."""
    b, heads = 3, 2
    q, ek, ev = _cross_inputs(cuda, b, beams, s, heads, s if beams == 4 else 100 * s + beams)
    launches = fused_cross_attention.launches
    out = fused_cross_attention(q, ek, ev, beams, heads)
    again = fused_cross_attention(q, ek, ev, beams, heads)
    ref = fused_cross_attention_plain(q, ek, ev, beams, heads)
    torch.cuda.synchronize()
    assert fused_cross_attention.launches == launches + 2
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
    assert torch.equal(out, again)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kernel", ["bf16", "merged", "int8"])
@pytest.mark.parametrize("beams", [1, 4, 9, 16])
def test_cross_attention_kernels_exact_sums(cuda, kernel, beams):
    """q = 0 (every weight 1/S, rounded alike), integer V and, in int8, V
    scales that are powers of two: every product and sum of the V product
    is exact, so each kernel is bit-equal to its plain version."""
    b, s, heads = 3, 50, 2
    q, ek, ev = _cross_inputs(cuda, b, beams, s, heads, 200 + beams, exact=True)
    if kernel == "bf16":
        out = fused_cross_attention(q, ek, ev, beams, heads)
        ref = fused_cross_attention_plain(q, ek, ev, beams, heads)
    elif kernel == "merged":
        mk, mv = _merged(ek, 64), _merged(ev, 64)
        out = fused_cross_attention_dma(q, mk, mv, s, beams, heads)
        ref = fused_cross_attention_dma_plain(q, mk, mv, s, beams, heads)
    else:
        g = torch.Generator(device=cuda).manual_seed(300 + beams)
        ck = _q8_cache(ek)
        cv = {"q": torch.randint(-127, 128, ev.shape, generator=g, device=cuda,
                                 dtype=torch.int8),
              "s": torch.exp2(torch.randint(-9, -3, (b, s, heads), generator=g,
                                            device=cuda).float())}
        out = fused_cross_attention_q8(q, ck, cv, beams, heads)
        ref = fused_cross_attention_plain(q, ck, cv, beams, heads)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("beams,s", [(4, 3000), (16, 2000), (33, 700), (1, 12000)])
def test_cross_attention_kernels_take_rows_in_chunks(cuda, beams, s):
    """Encoder lengths whose whole K and V tiles do not fit beside the
    scores: the rows go through in chunks, each V item's sums kept between
    them; every kernel within 2e-2 of plain, reruns bit-equal, the merged
    one also with NaN pad rows."""
    b, heads = 2, 2
    q, ek, ev = _cross_inputs(cuda, b, beams, s, heads, beams + s)
    s_pad = -(-s // 16) * 16 + 16
    mk, mv = _merged(ek, s_pad), _merged(ev, s_pad)
    nk, nv = _merged(ek, s_pad, float("nan")), _merged(ev, s_pad, float("nan"))
    caches = [_q8_cache(c) for c in (ek, ev)]
    runs = {
        "bf16": (lambda: fused_cross_attention(q, ek, ev, beams, heads),
                 fused_cross_attention_plain(q, ek, ev, beams, heads)),
        "merged": (lambda: fused_cross_attention_dma(q, mk, mv, s, beams, heads),
                   fused_cross_attention_dma_plain(q, mk, mv, s, beams, heads)),
        "int8": (lambda: fused_cross_attention_q8(q, *caches, beams, heads),
                 fused_cross_attention_plain(q, *caches, beams, heads)),
    }
    for name, (run, ref) in runs.items():
        out, again = run(), run()
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2, msg=name)
        assert torch.equal(out, again), name
    nan_pad = fused_cross_attention_dma(q, nk, nv, s, beams, heads)
    torch.cuda.synchronize()
    assert torch.equal(nan_pad, runs["merged"][0]())


def _bf16_ulp(x):
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), (e - 8).clamp(min=-133))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("d,o", [(256, 384), (160, 192), (1024, 3072)])  # 160: a partial slice
@pytest.mark.parametrize("n", [1, 8, 32, 70, 129, 256, 1024])
def test_ln_gemm_kernel_matches_plain(cuda, n, d, o):
    """Every output within two bf16 ulps of its terms plus 2**-8 of sum
    |xn| |w|, a rerun bit-equal, and the output a view of the first N rows
    of a larger buffer whose rows past N keep their sentinel (split and
    unsplit tiles: N = 1024 at O = 3072 runs unsplit, the others split)."""
    g = torch.Generator(device=cuda).manual_seed(n + d)
    x = (torch.randn((n, d), generator=g, device=cuda) * 2 + 0.5).bfloat16()
    scale = (1 + 0.1 * torch.randn((d,), generator=g, device=cuda)).bfloat16()
    shift = (0.1 * torch.randn((d,), generator=g, device=cuda)).bfloat16()
    w = (0.05 * torch.randn((d, o), generator=g, device=cuda)).bfloat16()
    bias = (0.1 * torch.randn((o,), generator=g, device=cuda)).bfloat16()
    buf = torch.full((n + 128, o), 7.0, dtype=torch.bfloat16, device=cuda)
    launches = ln_gemm.launches
    out = ln_gemm(x, scale, shift, w, bias, out=buf[:n])
    again = ln_gemm(x, scale, shift, w, bias)
    ref = ln_gemm_plain(x, scale, shift, w, bias)
    torch.cuda.synchronize()
    assert ln_gemm.launches == launches + 2
    assert out.data_ptr() == buf.data_ptr()
    assert bool((buf[n:] == 7.0).all())
    assert torch.equal(out, again)
    # where the bias cancels the product, one ulp of the product's rounding
    # is finer than one of the output: two of the terms' size; and the LN's
    # f32 statistics, summed in another order, can round any bf16 xn the
    # other way: 2**-8 of sum |xn| |w|
    terms = (ref.float() - bias.float()).abs() + bias.float().abs()
    l1 = torch.nn.functional.layer_norm(x.float(), (d,), scale.float(),
                                        shift.float()).abs() @ w.float().abs()
    assert bool(((out.float() - ref.float()).abs()
                 <= 2 * _bf16_ulp(terms) + 2.0**-8 * l1).all())


def _mlp_weights(cuda, g, d, f):
    w1 = (torch.randn((d, f), generator=g, device=cuda) * (1.6 / d**0.5)).bfloat16()
    b1 = (0.1 * torch.randn((f,), generator=g, device=cuda)).bfloat16()
    w2 = (torch.randn((f, d), generator=g, device=cuda) * (1.6 / f**0.5)).bfloat16()
    b2 = (0.1 * torch.randn((d,), generator=g, device=cuda)).bfloat16()
    return w1, b1, w2, b2


@pytest.mark.requires_cuda
@pytest.mark.parametrize("d,f", [(256, 1024), (1024, 4096)])
@pytest.mark.parametrize("n", [1, 8, 32, 70, 1024])
def test_fused_mlp_kernel_matches_plain(cuda, n, d, f):
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((n, d), generator=g, device=cuda).bfloat16()
    w1, b1, w2, b2 = _mlp_weights(cuda, g, d, f)
    launches = fused_mlp.launches
    out = fused_mlp(x, w1, b1, w2, b2)
    again = fused_mlp(x, w1, b1, w2, b2)
    ref = fused_mlp_plain(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert fused_mlp.launches == launches + 2
    assert torch.equal(out, again)
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2 * ref.float().abs().max().item()
    for act in ("gelu_tanh", "quick_gelu", "relu", "silu"):  # the epilogue's other activations
        out = fused_mlp(x, w1, b1, w2, b2, act)
        again = fused_mlp(x, w1, b1, w2, b2, act)
        ref = fused_mlp_plain(x, w1, b1, w2, b2, act)
        torch.cuda.synchronize()
        assert torch.equal(out, again), act
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= 1e-2 * ref.float().abs().max().item(), act
    with pytest.raises(ValueError, match="activation"):
        fused_mlp(x, w1, b1, w2, b2, "tanh")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("d,f", [(256, 1024), (1024, 4096)])
@pytest.mark.parametrize("n", [1, 70, 200, 1100, 2100])
def test_fused_mlp_kernel_writes_no_row_past_n(cuda, n, d, f):
    """N not a multiple of the kernel's 128-row tile, the output a view of
    the first N rows of a larger buffer: the rows past N keep their
    sentinel, the first N match the kernel's own output.  fc2 runs split
    (through its partials) at every N but 2100 at D=1024, where its 17 x 4
    tiles run unsplit (the tile's own epilogue)."""
    g = torch.Generator(device=cuda).manual_seed(1000 + n)
    x = torch.randn((n, d), generator=g, device=cuda).bfloat16()
    w1, b1, w2, b2 = _mlp_weights(cuda, g, d, f)
    pad = -n % 128 + 128
    buf = torch.full((n + pad, d), 7.0, dtype=torch.bfloat16, device=cuda)
    got = fused_mlp(x, w1, b1, w2, b2, out=buf[:n])
    ref = fused_mlp(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert got.data_ptr() == buf.data_ptr()
    assert torch.equal(buf[:n], ref)
    assert bool((buf[n:] == 7.0).all())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_fused_beam_generate_runs_through_the_new_kernels(cuda, monkeypatch, kv_quant):
    """MIC_TPU_FUSED_LAZY_ATTN=1 with fused_cross_attn,fused_mlp,ln_qkv: each
    of the four kernels once a layer a step (two images: N = 8 rows)."""
    monkeypatch.setenv("MIC_TPU_FUSED_LAZY_ATTN", "1")
    monkeypatch.setenv("MIC_TPU_EXPERIMENTAL", "fused_cross_attn,fused_mlp,ln_qkv")
    config = CaptionerConfig(
        vision=VisionConfig.tiny(),
        decoder=DecoderConfig.tiny(vocab_size=1100, d_model=128, num_heads=2,
                                   ffn_dim=512, max_position_embeddings=64),
        dtype="bfloat16",
    )
    params = make_serving_params(init_params(config, torch.Generator(device=cuda).manual_seed(3),
                                             cuda))
    images = torch.randint(0, 256, (2, 40, 40, 3), dtype=torch.uint8, device=cuda)
    px = preprocess_images(images, 32, torch.bfloat16)
    kernels = (fused_lazy_attention, fused_cross_attention, ln_gemm, fused_mlp)
    for fn in kernels:
        fn.launches = 0
    out = Captioner(config).generate(params, px, num_beams=4, max_length=12,
                                     forced_bos_token_id=7, kv_quant=kv_quant)
    torch.cuda.synchronize()
    assert [fn.launches for fn in kernels] == [config.decoder.num_layers * out.steps] * 4
    assert (out.sequences[:, 1] == 7).all() and torch.isfinite(out.scores).all()


def _attention_inputs(cuda, b, tq, tk, heads, dtype, mask_kind, seed):
    """q, k, v (B, T, H, 64) and a bool (B, 1, Tq, Tk) mask or None: causal
    with right padding, causal with left padding (rows with no valid key),
    or random with two rows fully masked."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = ((torch.randn((b, t, heads, 64), generator=g, device=cuda) * s).to(dtype)
               for t, s in ((tq, 0.3), (tk, 0.3), (tk, 1.0)))
    if mask_kind is None:
        return q, k, v, None
    if mask_kind == "random":
        mask = torch.rand((b, 1, tq, tk), generator=g, device=cuda) < 0.6
        mask[0, 0, :2] = False
        return q, k, v, mask
    lengths = torch.randint(1, tk + 1, (b,), generator=g, device=cuda)
    lengths[0] = tk
    pos = torch.arange(tk, device=cuda)
    pad = pos[None] >= tk - lengths[:, None] if mask_kind == "left" else pos[None] < lengths[:, None]
    causal = torch.tril(torch.ones((tq, tk), dtype=torch.bool, device=cuda))
    return q, k, v, causal[None, None] & pad[:, None, None, :]


SMALL_CASES = {"decoder": (3, 64, 2, "causal"), "left_padded": (3, 64, 2, "left"),
               "vision": (2, 50, 3, None), "ragged": (3, 13, 2, "causal"),
               "single": (3, 1, 2, None), "tile_short_by_one": (3, 63, 2, "causal"),
               "one_image_16_heads": (1, 64, 16, "causal")}

# The most a bf16 forward's outputs may differ from the plain version's bits,
# as a share of all outputs (_check_forward_bits): the kernels' f32 values
# differ from plain's only by the order of their sums (and flash's p by the
# 2^-17 of it that hi + lo leave, and its online rescaling), a few 2^-24 to
# 2^-17 of the terms' size, so an output's bits differ only where it lies
# that close to a bf16 rounding boundary.  Measured on the card (phase 35
# of chip_smoke.py): 4e-5 to 1.5e-4 of small-T's outputs, 1.0e-3 to 2.5e-3
# of flash's (its p carries more rounding); flash's p rounded once to bf16
# moves 0.35 of them, small-T's p left unrounded 0.40.  The limits are
# about 13x and 4x the largest measured share.
FORWARD_SHARE_LIMIT = {"small": 2e-3, "flash": 1e-2}


def _forward_terms(name, q, k, v, bias):
    """sum_k |p_k| |v_k| / l in f32 from the plain version's values: small-T's
    softmax rounded to bf16 (l = 1), flash's masked exp(s - m) over l."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if bias is not None:
        s = s + bias[:, None]
    if name == "small":
        p = torch.softmax(s, dim=-1).bfloat16().float()
    else:
        p = torch.where(s <= -5e29, 0.0, torch.exp(s - torch.clamp(s.amax(-1, keepdim=True),
                                                                   min=-1e30)))
        l = p.sum(-1, keepdim=True)
        p = p / torch.where(l == 0.0, 1.0, l)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float().abs())


# The most a bf16 backward's gradients may differ from the plain version's
# bits, as a share of all entries (_check_backward_bits): dq and dk carry dS
# as bf16 hi + lo (about 2^-17 of it left) and every f32 sum runs in
# another order.  Measured on the card (phase 35 of chip_smoke.py): 1.1e-3
# to 2.3e-3 of dq's and dk's entries, 4e-5 to 1.6e-4 of dv's; dS rounded
# once to bf16 moves 0.24 to 0.41 of dq's, which the one-ulp check alone
# does not catch.  The limit is about 4x the largest measured share.
BACKWARD_SHARE_LIMIT = 1e-2


def _check_backward_bits(grads, ref_grads, q, k, v, bias, do):
    """The bf16 gradients within one bf16 ulp of the size of their terms of
    the plain version's (dq's sum_k |dS| |k|, dk's sum_q |dS| |q|, dv's
    sum_q |round(p)| |do|), and at most BACKWARD_SHARE_LIMIT of each one's
    entries not bit-equal to it."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    p = torch.softmax(s if bias is None else s + bias[:, None], dim=-1)
    dof = do.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True))).abs()
    terms = (torch.einsum("bhqk,bkhd->bqhd", ds, k.float().abs()),
             torch.einsum("bhqk,bqhd->bkhd", ds, q.float().abs()),
             torch.einsum("bhqk,bqhd->bkhd", p.bfloat16().float(), dof.abs()))
    for name, got, ref, size in zip(("dq", "dk", "dv"), grads, ref_grads, terms):
        err = (got.float() - ref.float()).abs()
        assert not (err > _bf16_ulp(size)).any(), name
        share = (got != ref).float().mean().item()
        assert share <= BACKWARD_SHARE_LIMIT, (name, share)


def _check_forward_bits(name, got, ref, q, k, v, bias):
    """A bf16 forward within one bf16 ulp of the size of its terms of the
    plain output, and at most FORWARD_SHARE_LIMIT of its outputs not
    bit-equal to it."""
    err = (got.float() - ref.float()).abs()
    assert not (err > _bf16_ulp(_forward_terms(name, q, k, v, bias))).any(), name
    share = (got != ref).float().mean().item()
    assert share <= FORWARD_SHARE_LIMIT[name], (name, share)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", sorted(SMALL_CASES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_small_attention_kernels_match_plain(cuda, dtype, case):
    b, t, heads, kind = SMALL_CASES[case]
    q, k, v, mask = _attention_inputs(cuda, b, t, t, heads, dtype, kind, 300)
    bias = small.mask_bias(mask, b, t)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(301),
                     device=cuda).to(dtype)
    launches = (small.small_attention_forward.launches, small.small_attention_backward.launches)
    out = small.small_attention_forward(q, k, v, bias)
    grads = small.small_attention_backward(q, k, v, bias, do)
    again = small.small_attention_forward(q, k, v, bias)
    grads_again = small.small_attention_backward(q, k, v, bias, do)
    ref = small.small_t_attention_plain(q, k, v, bias)
    ref_grads = small.small_t_attention_bwd_plain(q, k, v, bias, do)
    torch.cuda.synchronize()
    assert (small.small_attention_forward.launches, small.small_attention_backward.launches) == (
        launches[0] + 2, launches[1] + 2)
    assert torch.equal(out, again) and out.dtype == dtype
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_again))
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        _check_forward_bits("small", out, ref, q, k, v, bias)
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref_grads):
        top = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        assert got.dtype == dtype and err <= tol * top, (name, err, top)
    if dtype == torch.bfloat16:
        _check_backward_bits(grads, ref_grads, q, k, v, bias, do)


FLASH_CASES = {"decoder": (3, 64, 64, 2, "causal"), "left_padded": (3, 64, 64, 2, "left"),
               "vision": (2, 50, 50, 3, None), "long_ragged": (2, 600, 600, 2, "random"),
               "cross_shape": (3, 70, 130, 2, "random"), "one": (1, 1, 1, 1, None),
               "one_key_past_a_tile": (3, 64, 65, 2, "random")}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_kernel_matches_plain(cuda, dtype, case):
    b, tq, tk, heads, kind = FLASH_CASES[case]
    q, k, v, mask = _attention_inputs(cuda, b, tq, tk, heads, dtype, kind, 310)
    bias = flash.mask_bias(mask, b, tq, tk)
    launches = flash.flash_attention_forward.launches
    out = flash.flash_attention_forward(q, k, v, bias)
    again = flash.flash_attention_forward(q, k, v, bias)
    ref = flash.flash_attention_plain(q, k, v, bias)
    torch.cuda.synchronize()
    assert flash.flash_attention_forward.launches == launches + 2
    assert torch.equal(out, again) and out.dtype == dtype
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        _check_forward_bits("flash", out, ref, q, k, v, bias)
    if mask is not None:
        dead = ~mask[:, 0].any(-1)
        assert not out[dead].any()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_forwards_read_no_row_past_the_sequence(cuda, dtype):
    """NaN in the next image's rows of K and V (the rows just past Tk of the
    last image the kernel sees) reaches no output: the kernels never read a
    row past the sequence, and their tiles' rows past it are zero."""
    for tq, tk, kind in ((64, 65, "random"), (70, 130, None)):
        q, k, v, mask = _attention_inputs(cuda, 4, tq, tk, 2, dtype, kind, 320)
        k[3:], v[3:] = float("nan"), float("nan")
        q, k, v = q[:3], k[:3], v[:3]
        bias = flash.mask_bias(None if mask is None else mask[:3], 3, tq, tk)
        out = flash.flash_attention_forward(q, k, v, bias)
        torch.cuda.synchronize()
        assert torch.isfinite(out.float()).all(), (tq, tk)
        torch.testing.assert_close(out.float(), flash.flash_attention_plain(q, k, v, bias).float(),
                                   rtol=2e-2, atol=2e-2)
    for t in (50, 13):
        q, k, v, _ = _attention_inputs(cuda, 4, t, t, 2, dtype, None, 321)
        k[3:], v[3:] = float("nan"), float("nan")
        out = small.small_attention_forward(q[:3], k[:3], v[:3])
        torch.cuda.synchronize()
        assert torch.isfinite(out.float()).all(), t


@pytest.mark.requires_cuda
def test_attention_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros((2, 64, 2, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(NotImplementedError):
        small.small_attention_forward(x, x, x)
    with pytest.raises(NotImplementedError):
        flash.flash_attention_forward(x, x, x)
    x = torch.zeros((2, 64, 4, 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="head_dim"):
        flash.flash_attention_forward(x, x, x)
    with pytest.raises(NotImplementedError, match="head_dim"):
        small.small_attention_backward(x, x, x, None, x)
    x = torch.zeros((2, 65, 2, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        small.small_attention_forward(x, x, x)
    x = torch.zeros((2, 2, 64, 64), device=cuda, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash.flash_attention_forward(x, x, x)


def _head_dim_64_config():
    return CaptionerConfig(
        vision=VisionConfig.tiny(hidden_size=128, num_heads=2),
        decoder=DecoderConfig.tiny(vocab_size=1100, d_model=128, num_heads=2, ffn_dim=256,
                                   max_position_embeddings=64),
        dtype="bfloat16",
    )


@pytest.mark.requires_cuda
def test_attention_switches_route_through_the_kernels(cuda, monkeypatch):
    """attn_impl="pallas": flash once per self-attention layer of each
    tower a forward, never on cross-attention; small_attn: the small-T
    forward per self-attention layer (the cross-attention's 8 x 5 is not
    Tq == Tk) and, under remat "masks", again in the backward's recompute,
    with one backward launch a layer."""
    from mic_tpu_torch.core.config import DataConfig, TrainConfig
    from mic_tpu_torch.train.trainer import Trainer

    config = _head_dim_64_config()
    layers = config.vision.num_layers + config.decoder.num_layers
    params = init_params(config, torch.Generator(device=cuda).manual_seed(4), cuda)
    px = torch.randn((2, 32, 32, 3), device=cuda).bfloat16()
    ids = torch.randint(4, 1100, (2, 8), device=cuda)
    mask = torch.ones_like(ids)
    mask[1, 5:] = 0
    flash.flash_attention_forward.launches = 0
    logits = Captioner(config, attn_impl="pallas")(params, px, ids, mask)
    torch.cuda.synchronize()
    assert flash.flash_attention_forward.launches == layers
    assert torch.isfinite(logits.float()).all()

    monkeypatch.setenv("MIC_TPU_EXPERIMENTAL", "small_attn")
    trainer = Trainer(config, DataConfig(max_seq_length=8, decode_size=40),
                      TrainConfig(per_device_batch_size=2, warmup_steps=1), device=cuda)
    trainer.build(10)
    state = trainer.init_state()
    batch = trainer.put_batch({
        "pixel_values": torch.randint(0, 256, (2, 40, 40, 3), dtype=torch.uint8).numpy(),
        "labels": ids.int().cpu().numpy(), "decoder_input_ids": ids.int().cpu().numpy(),
        "decoder_attention_mask": mask.int().cpu().numpy()})
    small.small_attention_forward.launches = small.small_attention_backward.launches = 0
    state, metrics = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    assert small.small_attention_forward.launches == 2 * layers
    assert small.small_attention_backward.launches == layers
    assert torch.isfinite(metrics["loss"]).all()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("beams", [1, 4, 9, 16])
@pytest.mark.parametrize("s,s_pad", [(50, 64), (37, 48), (64, 64), (1, 16)])
def test_fused_cross_attention_dma_kernel_matches_plain(cuda, s, s_pad, beams):
    """Rows at or past real_s never read: NaN there leaves the output
    bit-equal; a rerun bit-equal; any beam count."""
    b, heads = 3, 2
    q, ek, ev = _cross_inputs(cuda, b, beams, s, heads, s if beams == 4 else 100 * s + beams)
    mk, mv = _merged(ek, s_pad), _merged(ev, s_pad)
    launches = fused_cross_attention_dma.launches
    out = fused_cross_attention_dma(q, mk, mv, s, beams, heads)
    again = fused_cross_attention_dma(q, mk, mv, s, beams, heads)
    ref = fused_cross_attention_dma_plain(q, mk, mv, s, beams, heads)
    for c in (mk, mv):
        c[:, s:] = float("nan")
    nan_pad = fused_cross_attention_dma(q, mk, mv, s, beams, heads)
    torch.cuda.synchronize()
    assert fused_cross_attention_dma.launches == launches + 3
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
    assert torch.equal(out, again) and torch.equal(out, nan_pad)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("beams", [1, 4, 9, 16])
@pytest.mark.parametrize("s", [50, 37, 1, 64])
@pytest.mark.parametrize("layout", ["canonical", "merged"])
def test_fused_cross_attention_q8_kernel_matches_plain(cuda, layout, s, beams):
    """The int8 cross cache (a scale per image, position and head), both
    layouts, any beam count; a rerun bit-equal."""
    b, heads = 3, 2
    q, ek, ev = _cross_inputs(cuda, b, beams, s, heads, 8 if (beams, s) == (4, 50)
                              else 100 * s + beams)
    caches = [_q8_cache(c, layout) for c in (ek, ev)]
    launches = fused_cross_attention_q8.launches, fused_cross_attention.launches
    out = fused_cross_attention(q, *caches, beams, heads)
    again = fused_cross_attention(q, *caches, beams, heads)
    ref = fused_cross_attention_plain(q, *caches, beams, heads)
    torch.cuda.synchronize()
    assert (fused_cross_attention_q8.launches, fused_cross_attention.launches) == (
        launches[0] + 2, launches[1])
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
    assert torch.equal(out, again)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8])
@pytest.mark.parametrize("shape", [(2, 3, 4, 8, 16, 64), (3, 2, 3, 5, 3, 7), (1, 4, 1, 2, 2, 8)])
def test_beam_permute_kernel_matches_plain(cuda, shape, dtype):
    """(L, B, K, T, H, Dh): 16-byte rows, rows of 105 elements (no 16-byte
    alignment past the first), one beam."""
    l, b, k, t, h, dh = shape
    g = torch.Generator(device=cuda).manual_seed(t)
    kv = (torch.randn((l, b * k, t, h, dh), generator=g, device=cuda) * 50).to(dtype)
    idx = torch.randint(0, k, (b, k), generator=g, device=cuda)
    before = kv.clone()
    launches = beam_permute.launches
    out = beam_permute(kv, idx, k)
    torch.cuda.synchronize()
    assert beam_permute.launches == launches + 1
    assert torch.equal(out, beam_permute_plain(kv, idx, k)) and torch.equal(kv, before)


def _int8_matmul_operands(cuda, m, k, n, offset=0):
    """x (M, K) bf16, w_q (K, N) int8 ``offset`` bytes into its storage,
    scales in [0.01, 0.1)."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = (torch.randn((m, k), generator=g, device=cuda) * 0.3).bfloat16()
    flat = torch.randint(-128, 128, (k * n + offset,), generator=g, device=cuda,
                         dtype=torch.int8)
    scale = torch.rand((n,), generator=g, device=cuda) * 0.09 + 0.01
    return x, flat[offset:].view(k, n), scale


def _int8_matmul_holds(x, w_q, scale):
    """The kernel within one bf16 ulp of plain plus K 2**-24 sum |x| |w| (f32
    sums in another order), a rerun bit-equal, two launches counted."""
    launches = int8_matmul.launches
    out = int8_matmul(x, w_q, scale)
    again = int8_matmul(x, w_q, scale)
    ref = int8_matmul_plain(x, w_q, scale)
    torch.cuda.synchronize()
    assert int8_matmul.launches == launches + 2 and torch.equal(out, again)
    w = w_q.to(torch.bfloat16) * scale.to(torch.bfloat16)
    l1 = x.float().abs() @ w.float().abs()
    bound = _bf16_ulp(ref.float().abs()) + x.shape[1] * 2.0**-24 * l1
    assert bool(((out.float() - ref.float()).abs() <= bound).all())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("m,k,n,offset", [
    (4, 1024, 3072, 0), (70, 256, 384, 0), (3, 100, 70, 0), (65, 33, 250, 0),
    (1, 1024, 3072, 0), (8, 256, 384, 0), (64, 1024, 3072, 0), (65, 1024, 3072, 0),
    (1024, 1024, 3072, 0), (4, 1024, 249, 0), (65, 1001, 3074, 0), (4, 1000, 3078, 0),
    (1, 1000, 3074, 0), (8, 1024, 3072, 1), (64, 512, 4100, 0), (1024, 64, 250055, 0)])
def test_int8_matmul_kernel_matches_plain(cuda, m, k, n, offset):
    """Every instance (M up to 8, 64, more) on both weight paths (TMA at
    N % 16 == 0 with w_q 16-byte aligned; else cp.async and a realign: odd
    N, N % 16 in {2, 4, 6}, w_q one byte into its storage), ragged M, K
    (K % 8 != 0 and a last slice cut short) and N, and depth splits with a
    ragged last split (M <= 64 at N = 3072)."""
    _int8_matmul_holds(*_int8_matmul_operands(cuda, m, k, n, offset))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("m,k,n", [(4, 128, 3072), (65, 120, 249), (1024, 128, 3074),
                                   (8, 96, 250054)])
def test_int8_matmul_kernel_exact_sums(cuda, m, k, n):
    """Small-integer x, K <= 128 and scales of 8 significant bits whose
    products with w_q round: every f32 sum is exact in any order, so the
    kernel is bit-equal to plain (a scale applied after the sum, or a
    weight rounded another way, shows)."""
    g = torch.Generator(device=cuda).manual_seed(m + n)
    x = torch.randint(-3, 4, (m, k), generator=g, device=cuda).bfloat16()
    w_q = torch.randint(-128, 128, (k, n), generator=g, device=cuda, dtype=torch.int8)
    scale = torch.randint(128, 256, (n,), generator=g, device=cuda).float() * 2.0**-10
    out = int8_matmul(x, w_q, scale)
    torch.cuda.synchronize()
    assert torch.equal(out, int8_matmul_plain(x, w_q, scale))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("m,k,n", [(4, 1024, 3074), (64, 256, 3072), (1024, 128, 250)])
def test_int8_matmul_kernel_takes_scales_of_any_size(cuda, m, k, n):
    """Negative, zero and large scales (2^15 and more take the longer
    widening): within the bound of plain."""
    x, w_q, scale = _int8_matmul_operands(cuda, m, k, n)
    scale = scale - 0.055
    scale[::7] = 0.0
    scale[3::97] = 40000.0
    scale[5::211] = -3.0e5
    _int8_matmul_holds(x, w_q, scale)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", ["merged_cross", "merged_cross_int8", "physical"])
def test_beam_generate_runs_through_the_last_kernels(cuda, monkeypatch, case):
    """merged_cross: the merged cross-attention kernel once a layer a step,
    with the bf16 and the int8 KV cache; MIC_TPU_LAZY_CACHE=0: two beam
    permutes a step (self K and self V), merged_cross ignored."""
    monkeypatch.setenv("MIC_TPU_EXPERIMENTAL", "merged_cross")
    if case == "physical":
        monkeypatch.setenv("MIC_TPU_LAZY_CACHE", "0")
    config = CaptionerConfig(
        vision=VisionConfig.tiny(),
        decoder=DecoderConfig.tiny(vocab_size=1100, d_model=128, num_heads=2,
                                   ffn_dim=512, max_position_embeddings=64),
        dtype="bfloat16",
    )
    params = make_serving_params(init_params(config, torch.Generator(device=cuda).manual_seed(5),
                                             cuda))
    images = torch.randint(0, 256, (2, 40, 40, 3), dtype=torch.uint8, device=cuda)
    px = preprocess_images(images, 32, torch.bfloat16)
    fused_cross_attention_dma.launches = beam_permute.launches = 0
    out = Captioner(config).generate(params, px, num_beams=4, max_length=12,
                                     forced_bos_token_id=7,
                                     kv_quant="int8" if case.endswith("int8") else None)
    torch.cuda.synchronize()
    layers = config.decoder.num_layers
    want = (0, 2 * out.steps) if case == "physical" else (layers * out.steps, 0)
    assert (fused_cross_attention_dma.launches, beam_permute.launches) == want
    assert (out.sequences[:, 1] == 7).all() and torch.isfinite(out.scores).all()


# -- the float32 instances of rows 1, 4, 7 and 8 (a float32 model) -------------

@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,beams,t,heads,index", [(3, 4, 16, 2, i) for i in (0, 1, 9, 15)]
                         + [(256, 4, 64, 16, 63), (3, 3, 37, 2, 36)])
def test_lazy_attention_f32_kernel_matches_plain(cuda, b, beams, t, heads, index):
    """Row 1 on float32 caches, q and step rows: outputs within 1e-5 (f32
    sums in another order), the written cache bit-equal, columns past the
    index untouched, one launch counted."""
    hd = heads * 64
    g = torch.Generator(device=cuda).manual_seed(100 + index)

    def rand(*shape, scale=0.5):
        return torch.randn(shape, generator=g, device=cuda) * scale

    q, ks, vs = rand(b, beams, hd, scale=0.3), rand(b, beams, hd), rand(b, beams, hd)
    ck, cv = rand(b * beams, t, hd), rand(b * beams, t, hd)
    ck[:, index:] = 0
    cv[:, index:] = 0
    anc = torch.randint(0, beams, (b, beams, t), generator=g, device=cuda, dtype=torch.int32)
    anc[:, :, index:] = torch.arange(beams, device=cuda, dtype=torch.int32)[None, :, None]
    pk, pv = ck.clone(), cv.clone()
    launches = lazy_attention.launches
    out = lazy_attention(q, ck, cv, ks, vs, anc, index, heads)
    ref = lazy_attention_plain(q, pk, pv, ks, vs, anc, index, heads)
    torch.cuda.synchronize()
    assert lazy_attention.launches == launches + 1 and out.dtype == torch.float32
    assert torch.equal(ck, pk) and torch.equal(cv, pv)
    assert not ck[:, index + 1:].any() and not cv[:, index + 1:].any()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    with pytest.raises(TypeError, match="all bfloat16 or all float32"):
        lazy_attention(q.bfloat16(), ck, cv, ks, vs, anc, index, heads)


def _f32_head_close(got, ref, logits):
    """lse within 1e-5 relative, lp within 2e-4, ids equal but at near ties
    (two plain logits within 2e-4)."""
    (lp, ids, lse), (rlp, rids, rlse) = got, ref
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=0)
    torch.testing.assert_close(lp, rlp, rtol=0, atol=2e-4)
    differ = ids != rids
    gap = (logits.gather(1, ids.long()) - logits.gather(1, rids.long())).abs()
    assert bool((gap[differ] < 2e-4).all())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n,d,v,k,bv", [(1024, 1024, 250054, 9, 512), (4, 1024, 250054, 9, 512),
                                        (1, 100, 997, 1, 512), (65, 100, 997, 9, 96),
                                        (130, 64, 1300, 16, 200), (64, 128, 4099, 9, 512),
                                        (15, 1024, 250054, 9, 512), (16, 1024, 250054, 9, 512),
                                        (17, 1024, 250054, 9, 512), (8, 100, 997, 7, 512),
                                        (5, 1028, 4099, 16, 96)])
def test_fused_head_f32_kernel_matches_plain(cuda, monkeypatch, n, d, v, k, bv):
    """Row 4's float32 bucket kernels (the 3xTF32 tile, and the stream where
    N takes it: at and either side of the crossover, ``STREAM_ROWS``; runs
    of chunks or not, a depth off the 32-deep slices, a ragged vocab, other
    bucket widths) and row 5's float32 exact and window selects (k up to
    the windows there are): lse within 1e-5 relative, lp within 2e-4, ids
    equal but at near ties (two plain logits within 2e-4: both sum D
    products to f32 accuracy in other orders); a second launch bit-equal;
    one launch counted a call."""
    monkeypatch.setenv("MIC_TPU_EXPERIMENTAL", f"bucket_bv={bv}")
    g = torch.Generator(device=cuda).manual_seed(n + d + v)
    hidden = torch.randn((n, d), generator=g, device=cuda)
    weight = torch.randn((v, d), generator=g, device=cuda) * 0.02
    bias = torch.randn((v,), generator=g, device=cuda) * 0.1
    logits = hidden @ weight.T + bias
    launches = fused_head_topk.launches
    got = fused_head_topk(hidden, weight, bias, k)
    again = fused_head_topk(hidden, weight, bias, k)
    ref = fused_head_topk_plain(hidden, weight, bias, k, "bucket")
    torch.cuda.synchronize()
    assert fused_head_topk.launches == launches + 2
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    _f32_head_close(got, ref, logits)
    if bucket_f32_route(n, d):  # the tile at the same N
        tile = _bucket_f32(hidden, weight, bias, k, 0)
        assert all(torch.equal(a, c) for a, c in zip(tile, _bucket_f32(hidden, weight, bias, k, 0)))
        _f32_head_close(tile, ref, logits)
    for select in ("exact", "window"):
        if select == "window" and k > -(-v // 128):
            continue
        launches = fused_head_select.launches
        got = fused_head_topk(hidden, weight, bias, k, select)
        again = fused_head_topk(hidden, weight, bias, k, select)
        ref = fused_head_topk_plain(hidden, weight, bias, k, select)
        torch.cuda.synchronize()
        assert fused_head_select.launches == launches + 2
        assert all(torch.equal(a, c) for a, c in zip(got, again))
        _f32_head_close(got, ref, logits)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n,v,d", [(70, 997, 128), (1, 257, 64), (129, 4099, 100),
                                   (127, 250054, 1024), (4096, 250054, 1024)])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_flash_ce_f32_kernels_match_plain(cuda, n, v, d, smoothing):
    """Rows 7 and 8 on float32 hidden rows and table: lse and label logit
    within 1e-5 relative, the sum of logits within 1e-5 of the row's sum of
    |logits|; dl within 1e-4 of |dl| + 2 target rowscale (one relative
    error of p from the logits' f32 summation order), rowscale-0 rows zero,
    dbias within 1e-5 of its largest entry; reruns bit-equal.  The save
    forward (row 9's, float32): its statistics bit-equal to the non-saving
    call's, its bf16 main span within one bf16 ulp of the plain version's
    f32 logits plus 1e-5, its f32 tail within 1e-5 relative of the row's
    |logits| scale, a rerun bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(n + v + d)
    h = torch.randn((n, d), generator=g, device=cuda)
    w = torch.randn((v, d), generator=g, device=cuda) * 0.05
    b = torch.randn((v,), generator=g, device=cuda) * 0.1
    y = torch.randint(0, v, (n,), generator=g, device=cuda, dtype=torch.int32)
    y[:min(n, 3)] = v - 1 - torch.arange(min(n, 3), device=cuda, dtype=torch.int32)
    launches = (flash_ce_forward.launches, flash_ce_backward_dl.launches)
    out = flash_ce_forward(h, w, b, y)
    ref = flash_ce_forward_plain(h, w, b, y)
    torch.testing.assert_close(out[0], ref[0], rtol=1e-5, atol=0)
    torch.testing.assert_close(out[1], ref[1], rtol=1e-5, atol=1e-5)
    l1 = torch.cat([(h[i:i + 512] @ w.T + b).abs().sum(-1) for i in range(0, n, 512)])
    assert bool(((out[2] - ref[2]).abs() <= 1e-5 * l1).all())
    rs = torch.rand((n,), generator=g, device=cuda) / n
    rs[::7] = 0.0
    dl, dbias = flash_ce_dl(h, w, b, y, ref[0], rs, smoothing)
    dl2, dbias2 = flash_ce_dl(h, w, b, y, ref[0], rs, smoothing)
    rdl, rdbias = flash_ce_dl_plain(h, w, b, y, ref[0], rs, smoothing)
    torch.cuda.synchronize()
    assert (flash_ce_forward.launches, flash_ce_backward_dl.launches) == (launches[0] + 1,
                                                                          launches[1] + 2)
    assert torch.equal(dl, dl2) and torch.equal(dbias, dbias2) and dl.dtype == torch.float32
    assert not dl[rs == 0].any()
    low, conf_low = fce._targets(smoothing, v)
    for i in range(0, n, 256):
        target = torch.full_like(rdl[i:i + 256], low)
        target.scatter_(1, y[i:i + 256, None].long(), low + conf_low)
        limit = 1e-4 * (rdl[i:i + 256].abs() + 2 * target * rs[i:i + 256, None])
        assert bool(((dl[i:i + 256] - rdl[i:i + 256]).abs() <= limit).all())
    torch.testing.assert_close(dbias, rdbias, rtol=0, atol=1e-5 * rdbias.abs().max().item())
    saves = flash_ce_forward.save_launches
    got = flash_ce_forward(h, w, b, y, save=True)
    again = flash_ce_forward(h, w, b, y, save=True)
    torch.cuda.synchronize()
    assert flash_ce_forward.save_launches == saves + 2
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    assert all(torch.equal(a, c) for a, c in zip(got[:3], out))
    v_main = main_columns(v)
    assert got[3].dtype == torch.bfloat16 and got[3].shape == (n, v_main)
    assert got[4].dtype == torch.float32 and got[4].shape == (n, v - v_main)
    for i in range(0, n, 512):
        exact = h[i:i + 512] @ w.T + b
        main = exact[:, :v_main]
        assert bool(((got[3][i:i + 512].float() - main).abs() <= _bf16_ulp(main) + 1e-5).all())
        scale = (h[i:i + 512].abs() @ w[v_main:].abs().T + b[v_main:].abs())
        assert bool(((got[4][i:i + 512] - exact[:, v_main:]).abs() <= 1e-5 * scale).all())


@pytest.mark.requires_cuda
def test_f32_generate_and_train_step_run_the_f32_kernels(cuda):
    """A small float32 model (head dim 64) on the card: beam 4 through rows 1
    and 4 (f32) with sequences equal to the CPU's (plain versions) and
    scores within 1e-4; a train step on the default "auto" route launches
    rows 7 and 8 (f32) once each, its loss within 1e-5 relative of the
    CPU's on the same weights and batch (dropout off)."""
    from mic_tpu_torch.core.config import DataConfig, TrainConfig
    from mic_tpu_torch.core.params import tree_map
    from mic_tpu_torch.train.trainer import Trainer

    config = CaptionerConfig(
        vision=VisionConfig.tiny(),
        decoder=DecoderConfig.tiny(vocab_size=1100, d_model=128, num_heads=2, ffn_dim=256,
                                   max_position_embeddings=64),
        decode=DecodeConfig(fused_head="1", fused_select="bucket"),
    )
    assert config.dtype == "float32"
    params = init_params(config, torch.Generator(device=cuda).manual_seed(7), cuda)
    images = torch.randint(0, 256, (2, 40, 40, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(8))
    kw = dict(num_beams=4, max_length=12, forced_bos_token_id=7)
    lazy_attention.launches = fused_head_topk.launches = 0
    model = Captioner(config)
    gpu = model.generate(params, preprocess_images(images.to(cuda), 32, torch.float32), **kw)
    torch.cuda.synchronize()
    assert lazy_attention.launches == config.decoder.num_layers * gpu.steps
    assert fused_head_topk.launches >= gpu.steps
    cpu = model.generate(tree_map(lambda x: x.cpu(), params),
                         preprocess_images(images, 32, torch.float32), **kw)
    assert torch.equal(gpu.sequences.cpu(), cpu.sequences)
    torch.testing.assert_close(gpu.scores.cpu(), cpu.scores, rtol=0, atol=1e-4)

    rng = torch.Generator().manual_seed(9)
    batch = {"pixel_values": torch.randint(0, 256, (4, 40, 40, 3), dtype=torch.uint8,
                                           generator=rng).numpy(),
             "labels": torch.randint(4, 1100, (4, 8), generator=rng).int().numpy(),
             "decoder_input_ids": torch.randint(4, 1100, (4, 8), generator=rng).int().numpy(),
             "decoder_attention_mask": torch.ones((4, 8), dtype=torch.int32).numpy()}
    losses = {}
    for device in (cuda, torch.device("cpu")):
        trainer = Trainer(config, DataConfig(decode_size=40), TrainConfig(
            per_device_batch_size=4, warmup_steps=1, output_dir="unused"), device=device)
        trainer.build(4)
        state = trainer.init_state(tree_map(lambda x: x.detach().to(device).clone(), params))
        counts = (flash_ce_forward.launches, flash_ce_backward_dl.launches)
        state, metrics = trainer.train_step(state, trainer.put_batch(batch))
        losses[device.type] = metrics["loss"].item()
        if device.type == "cuda":
            assert (flash_ce_forward.launches, flash_ce_backward_dl.launches) == (
                counts[0] + 1, counts[1] + 1)
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-5 * abs(losses["cpu"])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,beams,t,heads,index", [(3, 4, 32, 2, i) for i in (0, 1, 17, 31)]
                         + [(256, 4, 64, 16, 17), (256, 4, 64, 16, 63), (3, 1, 37, 2, 36),
                            (2, 8, 64, 2, 63)])
def test_lazy_attention_q8_f32_kernel_matches_plain(cuda, b, beams, t, heads, index):
    """Row 2 on a float32 model's int8 cache (float32 q and step rows and
    output, the weights not rounded): outputs within 1e-5 (f32 sums in
    another order), the written int8 column and its scales bit-equal to
    the plain version's, the other columns untouched, a rerun bit-equal."""
    hd = heads * 64
    g = torch.Generator(device=cuda).manual_seed(400 + index + beams)
    q = torch.randn((b, beams, hd), generator=g, device=cuda) * 0.3
    ks, vs = (torch.randn((b, beams, hd), generator=g, device=cuda) * 0.5 for _ in range(2))
    caches = []
    for _ in range(2):
        prefix = torch.randn((b * beams, t, hd), generator=g, device=cuda) * 0.5
        prefix[:, index:] = 0
        values, scales = quantize_rows_dynamic(prefix)
        caches.append({"q": values, "s": scales[..., 0].contiguous()})
    anc = torch.randint(0, beams, (b, beams, t), generator=g, device=cuda, dtype=torch.int32)
    plain = [{n: a.clone() for n, a in c.items()} for c in caches]
    again = [{n: a.clone() for n, a in c.items()} for c in caches]
    before = [{n: a.clone() for n, a in c.items()} for c in caches]
    launches = lazy_attention_q8.launches
    out = lazy_attention_q8(q, *caches, ks, vs, anc, index, heads)
    rerun = lazy_attention_q8(q, *again, ks, vs, anc, index, heads)
    ref = lazy_attention_q8_plain(q, *plain, ks, vs, anc, index, heads)
    torch.cuda.synchronize()
    assert lazy_attention_q8.launches == launches + 2 and out.dtype == torch.float32
    assert torch.equal(out, rerun)
    for c, p, a in zip(caches, plain, again):
        for name in ("q", "s"):
            assert torch.equal(c[name], p[name]) and torch.equal(c[name], a[name]), name
    for c, b0 in zip(caches, before):
        for name in ("q", "s"):
            others = torch.arange(t, device=cuda) != index
            assert torch.equal(c[name][:, others], b0[name][:, others]), name
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("index", [0, 1, 17, 63])
@pytest.mark.parametrize("beams", [2, 4, 8, 9, 12, 16])
@pytest.mark.parametrize("q8", [False, True])
def test_fused_lazy_attention_f32_kernel_matches_plain(cuda, q8, beams, index):
    """Row 3 on a float32 model (mode "1"): the float32 cache and the
    per-head int8 cache under float32 q and step rows, on an ancestry mask,
    random bits and the step rows alone: within 2e-2 of plain (bf16 weights
    and outputs after f32 sums in another order), the caches untouched, a
    rerun bit-equal, the output float32 holding bfloat16 values."""
    b, t, heads = 3, 64, 2
    g = torch.Generator(device=cuda).manual_seed(500 + 10 * beams + index)
    q, ck, cv, ks, vs = _blocked_inputs(cuda, g, b, beams, t, heads, q8, dtype=torch.float32)
    for name, amask in _blocked_masks(cuda, g, b, beams, t, index).items():
        before = [{n: a.clone() for n, a in c.items()} if q8 else c.clone() for c in (ck, cv)]
        launches = fused_lazy_attention.launches
        out = fused_lazy_attention(q, ck, cv, ks, vs, amask, beams, heads, positions=index)
        again = fused_lazy_attention(q, ck, cv, ks, vs, amask, beams, heads, positions=index)
        ref = fused_lazy_attention_plain(q, ck, cv, ks, vs, amask, beams, heads)
        torch.cuda.synchronize()
        assert fused_lazy_attention.launches == launches + 2
        assert out.dtype == torch.float32 and torch.equal(out, out.bfloat16().float())
        assert torch.equal(out, again), name
        torch.testing.assert_close(out, ref, rtol=2e-2, atol=2e-2, msg=name)
        for c, old in zip((ck, cv), before):
            assert all(torch.equal(c[n], old[n]) for n in old) if q8 else torch.equal(c, old)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("beams", [1, 3, 4, 8, 9, 16])
@pytest.mark.parametrize("q8", [False, True])
def test_fused_lazy_attention_f32_kernel_exact_sums(cuda, q8, beams):
    """q = 0 and integer V (float32 values, or int8 with power-of-two V
    scales): every weight the same quotient, rounded alike, every sum
    exact, so the float32 instances equal the plain version bit for bit."""
    b, t, heads, index = 3, 64, 2, 63
    hd = heads * 64
    g = torch.Generator(device=cuda).manual_seed(600 + beams)
    q = torch.zeros((b, beams, hd), device=cuda)
    ks = torch.randn((b, beams, hd), generator=g, device=cuda)
    vs = torch.randint(-3, 4, (b, beams, hd), generator=g, device=cuda).float()
    values = torch.randint(-3, 4, (b * beams, t, hd), generator=g, device=cuda)
    if q8:
        ck = {"q": values.to(torch.int8), "s": torch.ones((b * beams, t, heads), device=cuda)}
        cv = {"q": values.flip(1).to(torch.int8).contiguous(),
              "s": torch.exp2(torch.randint(-2, 1, (b * beams, t, heads), generator=g,
                                            device=cuda).float())}
    else:
        ck = torch.randn((b * beams, t, hd), generator=g, device=cuda)
        cv = values.float()
    for name, amask in _blocked_masks(cuda, g, b, beams, t, index).items():
        out = fused_lazy_attention(q, ck, cv, ks, vs, amask, beams, heads, positions=index)
        ref = fused_lazy_attention_plain(q, ck, cv, ks, vs, amask, beams, heads)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), name


@pytest.mark.requires_cuda
def test_fused_lazy_attention_refuses_more_than_sixteen_beams(cuda):
    """Row 3 takes 1-16 beams: seventeen (a second M tile) raise on the
    card, in either dtype, before any launch, naming ROADMAP B41b; so do
    sixteen past the window whose scores fit a block (T = 256)."""
    b, heads = 2, 2
    for beams, t, index in ((17, 16, 3), (16, 256, 250)):
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device=cuda).manual_seed(9)
            q, ck, cv, ks, vs = _blocked_inputs(cuda, g, b, beams, t, heads, False, dtype=dtype)
            amask = torch.zeros((b, beams * t, beams), dtype=torch.int8, device=cuda)
            launches = fused_lazy_attention.launches
            with pytest.raises(ValueError, match="B41b"):
                fused_lazy_attention(q, ck, cv, ks, vs, amask, beams, heads, positions=index)
            assert fused_lazy_attention.launches == launches


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,beams,s,s_pad", [(256, 4, 50, 64), (3, 4, 37, 48), (3, 1, 50, 64),
                                             (3, 9, 50, 64), (3, 16, 1, 16), (2, 33, 64, 64)])
@pytest.mark.parametrize("kernel", ["f32", "merged_f32", "int8_f32q"])
def test_cross_attention_f32_kernels_match_plain(cuda, kernel, b, beams, s, s_pad):
    """Rows 14 and 13 on a float32 model (float32 q, encoder K/V and
    output; the merged cache padded to S_pad, NaN in its pad rows, which
    the kernel never reads) and row 14's int8 form under float32 q: within
    2e-2 of plain, a rerun bit-equal, the output float32 holding bfloat16
    values."""
    heads = 16 if b == 256 else 2
    g = torch.Generator(device=cuda).manual_seed(700 + beams + s)
    q = torch.randn((b, beams, heads * 64), generator=g, device=cuda) * 0.3
    ek, ev = (torch.randn((b, s, heads, 64), generator=g, device=cuda) * 0.5 for _ in range(2))
    if kernel == "f32":
        run = lambda: fused_cross_attention(q, ek, ev, beams, heads)  # noqa: E731
        ref = fused_cross_attention_plain(q, ek, ev, beams, heads)
        counter = fused_cross_attention
    elif kernel == "merged_f32":
        mk, mv = _merged(ek, s_pad), _merged(ev, s_pad)
        nk, nv = _merged(ek, s_pad, float("nan")), _merged(ev, s_pad, float("nan"))
        run = lambda: fused_cross_attention_dma(q, nk, nv, s, beams, heads)  # noqa: E731
        ref = fused_cross_attention_dma_plain(q, mk, mv, s, beams, heads)
        counter = fused_cross_attention_dma
    else:
        ck, cv = _q8_cache(ek), _q8_cache(ev)
        run = lambda: fused_cross_attention_q8(q, ck, cv, beams, heads)  # noqa: E731
        ref = fused_cross_attention_plain(q, ck, cv, beams, heads)
        counter = fused_cross_attention_q8
    launches = counter.launches
    out, again = run(), run()
    torch.cuda.synchronize()
    assert counter.launches == launches + 2
    assert out.dtype == torch.float32 and torch.equal(out, out.bfloat16().float())
    assert torch.equal(out, again)
    torch.testing.assert_close(out, ref, rtol=2e-2, atol=2e-2)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kernel", ["f32", "merged_f32", "int8_f32q"])
@pytest.mark.parametrize("beams", [1, 4, 9])
def test_cross_attention_f32_kernels_exact_sums(cuda, kernel, beams):
    """q = 0, integer V (and power-of-two V scales in int8): every sum
    exact, so each float32 instance equals its plain version bit for bit;
    and at S = 3000 the rows go through in chunks (within 2e-2)."""
    b, s, heads = 3, 50, 2
    g = torch.Generator(device=cuda).manual_seed(800 + beams)
    q = torch.zeros((b, beams, heads * 64), device=cuda)
    ek = torch.randn((b, s, heads, 64), generator=g, device=cuda)
    ev = torch.randint(-8, 9, (b, s, heads, 64), generator=g, device=cuda).float()
    if kernel == "f32":
        out = fused_cross_attention(q, ek, ev, beams, heads)
        ref = fused_cross_attention_plain(q, ek, ev, beams, heads)
    elif kernel == "merged_f32":
        mk, mv = _merged(ek, 64), _merged(ev, 64)
        out = fused_cross_attention_dma(q, mk, mv, s, beams, heads)
        ref = fused_cross_attention_dma_plain(q, mk, mv, s, beams, heads)
    else:
        ck = _q8_cache(ek)
        cv = {"q": torch.randint(-127, 128, ev.shape, generator=g, device=cuda, dtype=torch.int8),
              "s": torch.exp2(torch.randint(-9, -3, (b, s, heads), generator=g,
                                            device=cuda).float())}
        out = fused_cross_attention_q8(q, ck, cv, beams, heads)
        ref = fused_cross_attention_plain(q, ck, cv, beams, heads)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    s_long = 3000
    q = torch.randn((2, beams, heads * 64), generator=g, device=cuda) * 0.3
    ek, ev = (torch.randn((2, s_long, heads, 64), generator=g, device=cuda) * 0.5
              for _ in range(2))
    if kernel == "f32":
        out = fused_cross_attention(q, ek, ev, beams, heads)
        ref = fused_cross_attention_plain(q, ek, ev, beams, heads)
    elif kernel == "merged_f32":
        mk, mv = _merged(ek, s_long + 8), _merged(ev, s_long + 8)
        out = fused_cross_attention_dma(q, mk, mv, s_long, beams, heads)
        ref = fused_cross_attention_dma_plain(q, mk, mv, s_long, beams, heads)
    else:
        ck, cv = _q8_cache(ek), _q8_cache(ev)
        out = fused_cross_attention_q8(q, ck, cv, beams, heads)
        ref = fused_cross_attention_plain(q, ck, cv, beams, heads)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=2e-2, atol=2e-2)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("d,o", [(256, 384), (160, 192), (1024, 3072)])  # 160: a partial tile
@pytest.mark.parametrize("n", [1, 8, 32, 70, 256, 1024])
def test_ln_gemm_f32_kernel_matches_plain(cuda, n, d, o):
    """Row 15 on a float32 model (TF32 off on both sides): every output
    within (D 2**-24 + 2**-20) of sum |xn| |w| + |bias| (f32 sums in another
    order, the statistics summed in another order), a rerun bit-equal, the
    output a view of the first N rows of a larger buffer whose rows past N
    keep their sentinel (split and unsplit grids)."""
    g = torch.Generator(device=cuda).manual_seed(900 + n + d)
    x = torch.randn((n, d), generator=g, device=cuda) * 2 + 0.5
    scale = 1 + 0.1 * torch.randn((d,), generator=g, device=cuda)
    shift = 0.1 * torch.randn((d,), generator=g, device=cuda)
    w = 0.05 * torch.randn((d, o), generator=g, device=cuda)
    bias = 0.1 * torch.randn((o,), generator=g, device=cuda)
    buf = torch.full((n + 128, o), 7.0, device=cuda)
    launches = ln_gemm.launches
    out = ln_gemm(x, scale, shift, w, bias, out=buf[:n])
    again = ln_gemm(x, scale, shift, w, bias)
    ref = ln_gemm_plain(x, scale, shift, w, bias)
    torch.cuda.synchronize()
    assert ln_gemm.launches == launches + 2 and out.dtype == torch.float32
    assert out.data_ptr() == buf.data_ptr() and bool((buf[n:] == 7.0).all())
    assert torch.equal(out, again)
    l1 = (torch.nn.functional.layer_norm(x, (d,), scale, shift).abs() @ w.abs()
          + bias.abs())
    assert bool(((out - ref).abs() <= (d * 2.0**-24 + 2.0**-20) * l1).all())


# Row 16 f32's tolerance, a share of each output's sum |act(x w1 + b1)|
# |w2| + |b2| (chip_smoke.py::MLP_F32_TOL): fitted between what sound f32
# sums of the two products in two orders differ by and what the nearest
# faulty kernels (the tanh gelu for the erf one, TF32 products alone, a
# bf16 intermediate, b2 dropped) differ by; smoke phase 66 prints both
MLP_F32_TOL = 2.0**-18


def _mlp_f32_limit(x, w1, b1, w2, b2, act):
    """MLP_F32_TOL of sum |act(x w1 + b1)| |w2| + |b2|, entry by entry."""
    fn = gelu_erf if act == "gelu" else ACTIVATIONS[act]
    return MLP_F32_TOL * (fn(x @ w1 + b1).abs() @ w2.abs() + b2.abs())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "quick_gelu", "relu", "silu"])
@pytest.mark.parametrize("d,f", [(256, 1024), (1024, 4096)])
@pytest.mark.parametrize("n", [8, 32, 256, 1024])
def test_fused_mlp_f32_kernel_matches_plain(cuda, n, d, f, act):
    """Row 16 on a float32 model (TF32 off on both sides), every activation
    of its kernel: every output within ``_mlp_f32_limit`` of the plain
    version's (3xTF32 products against cuBLAS's f32 ones, summed in other
    orders; the gelu's erf by expf against torch.exp), a rerun bit-equal,
    the output a view of the first N rows of a larger buffer whose rows past
    N keep their sentinel (fc1 and fc2 split at N = 8 and 32, unsplit at
    1024), two launches counted."""
    g = torch.Generator(device=cuda).manual_seed(1600 + n + d)
    x = torch.randn((n, d), generator=g, device=cuda)
    w1, b1, w2, b2 = (t.float() for t in _mlp_weights(cuda, g, d, f))
    buf = torch.full((n + 128, d), 7.0, device=cuda)
    launches = fused_mlp.launches
    out = fused_mlp(x, w1, b1, w2, b2, act, out=buf[:n])
    again = fused_mlp(x, w1, b1, w2, b2, act)
    ref = fused_mlp_plain(x, w1, b1, w2, b2, act)
    torch.cuda.synchronize()
    assert fused_mlp.launches == launches + 2 and out.dtype == torch.float32
    assert out.data_ptr() == buf.data_ptr() and bool((buf[n:] == 7.0).all())
    assert torch.equal(out, again)
    assert bool(((out - ref).abs() <= _mlp_f32_limit(x, w1, b1, w2, b2, act)).all())


@pytest.mark.requires_cuda
def test_fused_mlp_refuses_mixed_dtypes(cuda):
    """Every operand bfloat16, or every one float32: a float32 x with bf16
    weights raises a TypeError before any launch."""
    g = torch.Generator(device=cuda).manual_seed(16)
    x = torch.randn((8, 256), generator=g, device=cuda)
    w1, b1, w2, b2 = _mlp_weights(cuda, g, 256, 1024)
    launches = fused_mlp.launches
    with pytest.raises(TypeError):
        fused_mlp(x, w1, b1, w2, b2)
    assert fused_mlp.launches == launches


def _f32_ce_inputs(cuda, n, v, d, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    h = torch.randn((n, d), generator=g, device=cuda)
    w = torch.randn((v, d), generator=g, device=cuda) * 0.05
    b = torch.randn((v,), generator=g, device=cuda) * 0.1
    y = torch.randint(0, v, (n,), generator=g, device=cuda, dtype=torch.int32)
    y[:min(n, 3)] = v - 1 - torch.arange(min(n, 3), device=cuda, dtype=torch.int32)
    rs = torch.rand((n,), generator=g, device=cuda) / n
    rs[::5] = 0.0
    return h, w, b, y, rs


def _f32_bwd_scales(h, w, b, y, lse, rs, smoothing):
    """(|dl| + 2 target rowscale)^T |h| and (|dl| + 2 target rowscale) |W|:
    what an error of 1e-4 of each dl entry's own size (row 8 f32's dl
    tolerance) moves each demb and dh entry by; dl the plain f32 one."""
    low, conf_low = fce._targets(smoothing, w.shape[0])
    demb = torch.zeros(w.shape, device=h.device)
    dh = torch.empty(h.shape, device=h.device)
    for i in range(0, h.shape[0], 512):
        rows = slice(i, i + 512)
        p = torch.exp(h[rows] @ w.T + b - lse[rows, None])
        dl = fce.dlogits(p, y[rows], rs[rows], smoothing).abs()
        target = torch.full_like(dl, low)
        target.scatter_(1, y[rows, None].long(), low + conf_low)
        dl += 2 * target * rs[rows, None]
        demb += dl.T @ h[rows].abs()
        dh[rows] = dl @ w.abs()
    return demb, dh


# (N, V, D) of the float32 backward contractions: one row and a row past
# the 128-row tiles; V ragged (v_main 512 of 997, 4096 of 4099); D = 100 (a
# multiple of 4, not of 64 or of the 96-column tile), 1088 (past the bf16
# split route's 1024), and the flagship step
_F32_BWD_SHAPES = [(1, 997, 128), (129, 4099, 100), (70, 997, 1088), (1, 4099, 64),
                   (129, 250054, 1024), (4096, 250054, 1024)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n,v,d", _F32_BWD_SHAPES)
@pytest.mark.parametrize("route", ["split", "save"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_flash_ce_f32_backward_kernels_match_plain(cuda, smoothing, route, n, v, d):
    """Rows 10 f32 (the split route: the dl walk a vocab chunk at a time,
    then both contractions) and 9 f32 (the save route's contractions from
    the plain version's saved logits, the f32 tail plain) against their
    plain versions on the same inputs, TF32 off: demb and dh entry by entry
    within 1e-4 of ``_f32_bwd_scales`` (dl formed in f32 on both sides, its
    exp and the logits' sums in other orders), dbias within 1e-5 of its
    largest entry; dh float32; a rerun bit-equal; one launch counted a
    call."""
    h, w, b, y, rs = _f32_ce_inputs(cuda, n, v, d, 3 * n + v + d)
    lse, _, _, lg, tail = flash_ce_forward_plain(h, w, b, y, save=True)
    if route == "split":
        fn, plain, extra = flash_ce_backward, flash_ce_backward_dl_plain, ()
    else:
        fn, plain, extra = flash_ce_backward_save, flash_ce_backward_save_plain, (lg, tail)
    launches = fn.launches
    out = fn(h, w, b, y, lse, rs, smoothing, None, *extra)
    again = fn(h, w, b, y, lse, rs, smoothing, None, *extra)
    torch.cuda.synchronize()
    assert fn.launches == launches + 2
    assert all(torch.equal(a, c) for a, c in zip(out, again))
    ref = plain(h, w, b, y, lse, rs, smoothing, None, *extra)
    assert out[0].dtype == out[1].dtype == out[2].dtype == torch.float32
    assert out[0].shape == (n, d) and out[1].shape == (v, d) and out[2].shape == (v,)
    demb_scale, dh_scale = _f32_bwd_scales(h, w, b, y, lse, rs, smoothing)
    assert bool(((out[1] - ref[1]).abs() <= 1e-4 * demb_scale).all())
    assert bool(((out[0] - ref[0]).abs() <= 1e-4 * dh_scale).all())
    torch.testing.assert_close(out[2], ref[2], rtol=0, atol=1e-5 * ref[2].abs().max().item())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n,v,d", [(129, 997, 100), (70, 4099, 64)])
def test_flash_ce_f32_split_chunks_agree(cuda, n, v, d):
    """The float32 split route cut into 256-column vocab chunks against one
    chunk: demb and dbias bit-equal (each vocab column's sums do not depend
    on the chunks), dh within 1e-5 of its largest entry (its chunks' parts
    added in another order); the chunk rule: a multiple of 128, the whole
    vocab at these N, 8192 columns at the flagship step."""
    h, w, b, y, rs = _f32_ce_inputs(cuda, n, v, d, 77)
    lse = flash_ce_forward_plain(h, w, b, y)[0]
    ops = fce._backward_operands("test", h, w, b, y, lse, rs, None)
    assert fce._split_chunk(n, v) >= v and fce._split_chunk(4096, 250054) == 8192
    whole = fce._split_f32(h, *ops[:5], 0.1)
    cut = fce._split_f32(h, *ops[:5], 0.1, chunk=256)
    torch.cuda.synchronize()
    assert torch.equal(whole[1], cut[1]) and torch.equal(whole[2], cut[2])
    torch.testing.assert_close(cut[0], whole[0], rtol=0,
                               atol=1e-5 * whole[0].abs().max().item())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", ["int8_kv", "fused_float", "fused_int8", "merged_cross"])
def test_f32_paths_run_the_f32_kernels(cuda, monkeypatch, case):
    """A small float32 model (two images: N = 8 rows) under each path of a
    float32 model's int8 cache and fused step: each new float32 kernel once a
    layer a step; sequences equal to the same generate on the CPU (plain
    versions), scores within 1e-2 (the attention kernels' bf16 roundings
    after f32 sums in another order)."""
    from mic_tpu_torch.core.params import tree_map

    env = {"int8_kv": {}, "merged_cross": {"MIC_TPU_EXPERIMENTAL": "merged_cross"},
           "fused_float": {"MIC_TPU_FUSED_LAZY_ATTN": "1",
                           "MIC_TPU_EXPERIMENTAL": "fused_cross_attn,ln_qkv"}}
    env["fused_int8"] = env["fused_float"]
    kernels = {"int8_kv": (lazy_attention_q8,), "merged_cross": (fused_cross_attention_dma,),
               "fused_float": (fused_lazy_attention, fused_cross_attention, ln_gemm)}
    kernels["fused_int8"] = kernels["fused_float"]
    for key in ("MIC_TPU_FUSED_LAZY_ATTN", "MIC_TPU_EXPERIMENTAL", "MIC_TPU_KV_QUANT"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env[case].items():
        monkeypatch.setenv(key, value)
    config = CaptionerConfig(
        vision=VisionConfig.tiny(),
        decoder=DecoderConfig.tiny(vocab_size=1100, d_model=128, num_heads=2,
                                   ffn_dim=512, max_position_embeddings=64),
    )
    assert config.dtype == "float32"
    params = init_params(config, torch.Generator(device=cuda).manual_seed(11), cuda)
    images = torch.randint(0, 256, (2, 40, 40, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(12))
    kw = dict(num_beams=4, max_length=12, forced_bos_token_id=7,
              kv_quant="int8" if case in ("int8_kv", "fused_int8") else None)
    for fn in kernels[case]:
        fn.launches = 0
    model = Captioner(config)
    gpu = model.generate(params, preprocess_images(images.to(cuda), 32, torch.float32), **kw)
    torch.cuda.synchronize()
    assert [fn.launches for fn in kernels[case]] == [config.decoder.num_layers * gpu.steps] * len(
        kernels[case])
    cpu = model.generate(tree_map(lambda x: x.cpu(), params),
                         preprocess_images(images, 32, torch.float32), **kw)
    assert torch.equal(gpu.sequences.cpu(), cpu.sequences)
    torch.testing.assert_close(gpu.scores.cpu(), cpu.scores, rtol=0, atol=1e-2)
