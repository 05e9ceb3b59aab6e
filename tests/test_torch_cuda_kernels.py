"""The port's CUDA kernels against their plain versions, on an NVIDIA card.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX (the card's machine has none); run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances: the kernels compute in bfloat16 with float32 accumulation in
another order than the plain versions: attention outputs within 2e-2 (one
bfloat16 rounding of values near 1), head log-probs within 2e-3 and lse
within 1e-3 relative; cache contents and candidate ids exactly.
"""

import pytest
import torch

from mic_tpu.core.config import CaptionerConfig, DecoderConfig, VisionConfig
from mic_tpu_torch.core.params import make_serving_params
from mic_tpu_torch.models.captioner import Captioner, init_params
from mic_tpu_torch.ops.fused_head import fused_head_topk, fused_head_topk_plain
from mic_tpu_torch.ops.image_prep import preprocess_images
from mic_tpu_torch.ops.lazy_attention import lazy_attention, lazy_attention_plain


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
