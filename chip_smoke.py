#!/usr/bin/env python3
"""Drive the PyTorch port (mic_tpu_torch) once on one CUDA card.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases, each of which raises on failure (none catches its own):
  1. build the CUDA kernels from mic_tpu_torch/csrc/;
  2. the lazy-attention kernel against its plain version at the flagship
     decode shape (B=256, K=4, T=64, H=16, Dh=64, bf16);
  3. the fused-head kernel against its plain version (N in {4, 1024},
     D=1024, V=250054, k in {1, 9}, bf16);
  4. each kernel's time beside its plain version's (CUDA events, median);
  5. the whole path: flagship-width random weights (CLIP ViT-B/32 ->
     12-layer mBART-50 -> tied 250054-token head), 8 images through
     preprocess_images -> Captioner.generate (beam 4, max_length 64), with
     launch counts that prove the kernels carried it; then a batch of 1
     and a batch of 256 timed for captions/s smoke figures (not a benchmark);
  6. the same path at a small width on the card against the CPU (plain
     versions) on the same weights.
It then prints the card's name and power limit, one JSON line describing
the kernels, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

FLAGSHIP_BOS = 250004  # mBART-50's en_XX language code


def require(ok, what: str) -> None:
    """Fail the run (asserts vanish under python -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def median_ms(fn, runs: int = 25) -> float:
    """Median device time of ``fn`` over ``runs`` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def check_lazy_attention(dev):
    from mic_tpu_torch.ops.lazy_attention import lazy_attention, lazy_attention_plain

    b, beams, t, heads, dh = 256, 4, 64, 16, 64
    hd = heads * dh
    g = torch.Generator(device=dev).manual_seed(1)

    def rand(*shape, scale=0.5):
        return (torch.randn(shape, generator=g, device=dev) * scale).bfloat16()

    worst = 0.0
    for index in (0, 1, 17, 63):
        q, ks, vs = rand(b, beams, hd, scale=0.3), rand(b, beams, hd), rand(b, beams, hd)
        ck, cv = rand(b * beams, t, hd), rand(b * beams, t, hd)
        ck[:, index:] = 0
        cv[:, index:] = 0
        anc = torch.randint(0, beams, (b, beams, t), generator=g, device=dev, dtype=torch.int32)
        anc[:, :, index:] = torch.arange(beams, device=dev, dtype=torch.int32)[None, :, None]
        pk, pv = ck.clone(), cv.clone()
        out = lazy_attention(q, ck, cv, ks, vs, anc, index, heads)
        ref = lazy_attention_plain(q, pk, pv, ks, vs, anc, index, heads)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        worst = max(worst, err)
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
        require(torch.equal(ck, pk) and torch.equal(cv, pv), "cache differs from plain")
        require(not ck[:, index + 1:].any() and not cv[:, index + 1:].any(), "dead column written")
        print(f"lazy_attention index={index}: max_abs_err={err:.6g}, cache bit-equal, "
              "columns > index zero", flush=True)
    index = 63
    kernel_ms = median_ms(lambda: lazy_attention(q, ck, cv, ks, vs, anc, index, heads))
    plain_ms = median_ms(lambda: lazy_attention_plain(q, pk, pv, ks, vs, anc, index, heads))
    print(f"lazy_attention time at B={b} K={beams} T={t} H={heads} index={index}: "
          f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    return worst, kernel_ms, plain_ms


def check_fused_head(dev):
    from mic_tpu_torch.ops.fused_head import fused_head_topk, fused_head_topk_plain

    d, v = 1024, 250054
    g = torch.Generator(device=dev).manual_seed(2)
    weight = (torch.randn((v, d), generator=g, device=dev) * 0.02).bfloat16()
    bias = (torch.randn((v,), generator=g, device=dev) * 0.1).bfloat16()
    worst = 0.0
    times = {}
    for n in (4, 1024):
        hidden = torch.randn((n, d), generator=g, device=dev).bfloat16()
        logits = hidden.float() @ weight.float().T + bias.float()
        for k in (1, 9):
            lp, ids, lse = fused_head_topk(hidden, weight, bias, k)
            rlp, rids, rlse = fused_head_topk_plain(hidden, weight, bias, k, "bucket")
            torch.cuda.synchronize()
            torch.testing.assert_close(lse, rlse, rtol=1e-3, atol=0)
            torch.testing.assert_close(lp, rlp, rtol=0, atol=2e-3)
            differ = ids != rids
            gap = (logits.gather(1, ids.long()) - logits.gather(1, rids.long())).abs()
            require(bool((gap[differ] < 1e-2).all()), "an id differs beyond a near-tie")
            err = (lp - rlp).abs().max().item()
            worst = max(worst, err)
            print(f"fused_head N={n} k={k}: lp max_abs_err={err:.6g}, lse max_rel_err="
                  f"{((lse - rlse).abs() / rlse.abs()).max().item():.3g}, "
                  f"near-tie id differences={int(differ.sum())}", flush=True)
        del logits
        times[n] = (median_ms(lambda: fused_head_topk(hidden, weight, bias, 9)),
                    median_ms(lambda: fused_head_topk_plain(hidden, weight, bias, 9, "bucket")))
        print(f"fused_head time at N={n} D={d} V={v} k=9: kernel {times[n][0]:.4f} ms, "
              f"plain {times[n][1]:.4f} ms", flush=True)
    return worst, *times[1024]


def run_whole_path(dev):
    from mic_tpu.core.config import CaptionerConfig
    from mic_tpu_torch.core.params import make_serving_params
    from mic_tpu_torch.models.captioner import Captioner, init_params
    from mic_tpu_torch.ops.fused_head import fused_head_topk
    from mic_tpu_torch.ops.image_prep import preprocess_images
    from mic_tpu_torch.ops.lazy_attention import lazy_attention

    config = CaptionerConfig.clip_vit_b32_mbart50(dtype="bfloat16")
    t0 = time.perf_counter()
    params = make_serving_params(
        init_params(config, torch.Generator(device=dev).manual_seed(0), dev)
    )
    torch.cuda.synchronize()
    print(f"flagship params made on the card in {time.perf_counter() - t0:.2f} s", flush=True)
    model = Captioner(config)
    kw = dict(num_beams=4, max_length=64, forced_bos_token_id=FLAGSHIP_BOS)

    def pixels(n, seed):
        u8 = np.random.default_rng(seed).integers(0, 256, (n, 256, 256, 3), dtype=np.uint8)
        return preprocess_images(torch.from_numpy(u8).to(dev), config.vision.image_size,
                                 torch.bfloat16)

    px = pixels(8, 0)
    lazy_attention.launches = 0
    fused_head_topk.launches = 0
    out = model.generate(params, px, **kw)
    torch.cuda.synchronize()
    launches = {"lazy_attention": lazy_attention.launches,
                "fused_head": fused_head_topk.launches}
    seqs = out.sequences.cpu()
    print(f"whole path, 8 images: {out.steps} decode steps, launches {launches}, "
          f"sequences {tuple(seqs.shape)}", flush=True)
    require(seqs.shape == (8, 64), f"sequences of shape {tuple(seqs.shape)}")
    require(bool((seqs[:, 1] == FLAGSHIP_BOS).all()), "forced BOS missing")
    require(bool(torch.isfinite(out.scores).all()), "non-finite scores")
    require(launches["lazy_attention"] == config.decoder.num_layers * out.steps,
            "lazy_attention launches != layers x decode steps")
    require(launches["fused_head"] >= out.steps, "fused_head launched less than once a step")
    again = model.generate(params, px, **kw)
    require(torch.equal(again.sequences.cpu(), seqs), "a second run gave other sequences")
    print("whole path: second run gave identical sequences", flush=True)

    for b in (1, 256):
        px = pixels(b, 1)
        for attempt in (1, 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model.generate(params, px, **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            require(bool(torch.isfinite(out.scores).all()), f"non-finite scores at B={b}")
            print(f"smoke figure (not a benchmark), run {attempt}: B={b} beam 4 max_length 64, "
                  f"{out.steps} steps in {seconds:.3f} s = {b / seconds:.1f} captions/s",
                  flush=True)
    return launches


def check_small_against_cpu(dev):
    """The card's path (both kernels) against the CPU path (plain versions)
    on the same bfloat16 weights at a small width with head_dim 64."""
    from mic_tpu.core.config import CaptionerConfig, DecodeConfig, DecoderConfig, VisionConfig
    from mic_tpu_torch.core.params import make_serving_params, tree_map
    from mic_tpu_torch.models.captioner import Captioner, init_params
    from mic_tpu_torch.ops.image_prep import preprocess_images

    config = CaptionerConfig(
        vision=VisionConfig.tiny(),
        decoder=DecoderConfig.tiny(vocab_size=1100, d_model=128, num_heads=2, ffn_dim=256,
                                   max_position_embeddings=64),
        decode=DecodeConfig(fused_select="bucket"),
        dtype="bfloat16",
    )
    params = make_serving_params(init_params(config, torch.Generator(device=dev).manual_seed(3),
                                             dev))
    u8 = torch.from_numpy(
        np.random.default_rng(4).integers(0, 256, (4, 40, 40, 3), dtype=np.uint8)
    )
    kw = dict(num_beams=4, max_length=16, forced_bos_token_id=7)
    model = Captioner(config)
    gpu = model.generate(params, preprocess_images(u8.to(dev), 32, torch.bfloat16), **kw)
    cpu = model.generate(tree_map(lambda x: x.cpu(), params),
                         preprocess_images(u8, 32, torch.bfloat16), **kw)
    score_err = (gpu.scores.cpu() - cpu.scores).abs().max().item()
    same = torch.equal(gpu.sequences.cpu(), cpu.sequences)
    print(f"small width, card vs CPU: sequences equal={same}, "
          f"max score difference={score_err:.3g}", flush=True)
    require(same, "card and CPU sequences differ")
    require(score_err < 2e-2, "card and CPU scores differ")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from mic_tpu_torch import _build

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s: {lib_path}",
          flush=True)

    attn_err, attn_ms, attn_plain_ms = check_lazy_attention(dev)
    head_err, head_ms, head_plain_ms = check_fused_head(dev)
    torch.cuda.empty_cache()
    launches = run_whole_path(dev)
    torch.cuda.empty_cache()
    check_small_against_cpu(dev)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kernels = [
        {"name": "lazy_attention", "route": "cuda",
         "source": "mic_tpu_torch/csrc/lazy_attention.cu",
         "replaces": "mic_tpu/ops/lazy_attention.py:668",
         "launches": launches["lazy_attention"], "max_abs_err": attn_err,
         "ms": attn_ms, "plain_ms": attn_plain_ms},
        {"name": "fused_head_bucket", "route": "cuda",
         "source": "mic_tpu_torch/csrc/fused_head.cu",
         "replaces": "mic_tpu/ops/fused_head.py:608",
         "launches": launches["fused_head"], "max_abs_err": head_err,
         "ms": head_ms, "plain_ms": head_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
