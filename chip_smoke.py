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
     versions) on the same weights;
  7. the flash-CE forward kernel against its plain version (N in {64, 4096},
     D=1024, V=250054, bf16, labels in the last vocab tile);
  8. the flash-CE dl kernel against its plain version (the same shapes,
     label smoothing 0 and 0.1, rows with rowscale 0, a guard past dl);
  9. both CE kernels' times beside their plain versions' at N=4096, and the
     dh / demb GEMMs over dl;
 10. training at flagship width: the port's Trainer takes 6 steps of batch
     64 x 64 with the TrainConfig defaults (fused CE on the dl route, remat
     "masks", bf16 moments and shadow params), twice from one seed, with
     launch counts that prove both CE kernels ran once a step, bit-equal
     reruns, and a step-time smoke figure (not a benchmark);
 11. three train steps at a small width on the card against the CPU.
It then prints the card's name and power limit, one JSON line describing
the kernels, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
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


CE_D, CE_V = 1024, 250054  # the flagship decoder width and vocab


def _ce_table(dev):
    g = torch.Generator(device=dev).manual_seed(5)
    weight = (torch.randn((CE_V, CE_D), generator=g, device=dev) * 0.02).bfloat16()
    bias = torch.randn((CE_V,), generator=g, device=dev) * 0.1
    return weight, bias


def _ce_rows(dev, n, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    hidden = torch.randn((n, CE_D), generator=g, device=dev).bfloat16()
    labels = torch.randint(0, CE_V, (n,), generator=g, device=dev, dtype=torch.int32)
    labels[:8] = CE_V - 1 - torch.arange(8, device=dev, dtype=torch.int32)  # in the last tile
    return hidden, labels


def check_flash_ce_forward(dev, weight, bias):
    """Kernel 3 against its plain version: lse and label logit within 1e-3
    relative, sum of logits within 1e-3 of the row's sum of |logits|; the
    smoothed loss built from each within 1e-3 relative."""
    from mic_tpu_torch.ops.fused_ce import expected_logit, normalizing
    from mic_tpu_torch.ops.flash_ce import flash_ce_forward, flash_ce_forward_plain

    worst = 0.0
    wf = weight.float()
    for n in (64, 4096):
        hidden, labels = _ce_rows(dev, n, n)
        out = flash_ce_forward(hidden, weight, bias, labels)
        ref = flash_ce_forward_plain(hidden, weight, bias, labels)
        torch.cuda.synchronize()
        l1 = torch.cat([(hidden[i:i + 512].float() @ wf.T + bias).abs().sum(-1)
                        for i in range(0, n, 512)])
        lse_rel = ((out[0] - ref[0]).abs() / ref[0].abs()).max().item()
        lbl_rel = ((out[1] - ref[1]).abs() / ref[1].abs().clamp(min=1.0)).max().item()
        z_rel = ((out[2] - ref[2]).abs() / l1).max().item()
        require(lse_rel < 1e-3 and lbl_rel < 1e-3, f"flash_ce_forward N={n}: lse/label logit")
        require(z_rel < 1e-3, f"flash_ce_forward N={n}: sum of logits")
        for ls in (0.0, 0.1):
            loss, loss_ref = ((s[0] - expected_logit(s[1], s[2], ls, CE_V)).mean()
                              - normalizing(ls, CE_V) for s in (out, ref))
            require(abs(loss.item() - loss_ref.item()) < 1e-3 * abs(loss_ref.item()),
                    f"flash_ce_forward N={n} smoothing {ls}: loss")
        worst = max(worst, (out[0] - ref[0]).abs().max().item())
        print(f"flash_ce_forward N={n} D={CE_D} V={CE_V}: lse max_rel_err={lse_rel:.3g}, "
              f"label logit max_rel_err={lbl_rel:.3g}, sum_logits max err / row L1="
              f"{z_rel:.3g}, lse max_abs_err={worst:.3g}", flush=True)
    del wf
    return worst


def _bf16_ulp(x):
    """One bf16 unit in the last place of each entry of a bf16 tensor."""
    _, e = torch.frexp(x.float())
    ulp = torch.ldexp(torch.ones_like(x, dtype=torch.float32), (e - 8).clamp(min=-133))
    return torch.where(x == 0, 2.0**-133, ulp)


def check_flash_ce_dl(dev, weight, bias):
    """Kernel 4 against its plain version: dl within one bf16 ulp of the
    plain bf16 dl (plus one of its terms where they cancel), rows with
    rowscale 0 zero, nothing written past dl's last row; dbias within 1e-4
    of its largest entry."""
    from mic_tpu_torch.ops.flash_ce import (
        _targets, flash_ce_dl, flash_ce_dl_plain, flash_ce_forward_plain,
    )

    worst = 0.0
    for n in (64, 4096):
        hidden, labels = _ce_rows(dev, n, n + 1)
        lse = flash_ce_forward_plain(hidden, weight, bias, labels)[0]
        rs = torch.rand((n,), generator=torch.Generator(device=dev).manual_seed(n), device=dev)
        rs = rs / n
        rs[::7] = 0.0
        for ls in (0.0, 0.1):
            buf = torch.full((n * CE_V + 256,), 3.0, dtype=torch.bfloat16, device=dev)
            dl, dbias = flash_ce_dl(hidden, weight, bias, labels, lse, rs, ls,
                                    out=buf[: n * CE_V].view(n, CE_V))
            ref, dbias_ref = flash_ce_dl_plain(hidden, weight, bias, labels, lse, rs, ls)
            torch.cuda.synchronize()
            require(bool(buf[n * CE_V:].eq(3.0).all()), "flash_ce_dl wrote past dl's end")
            require(not dl[rs == 0].any(), "flash_ce_dl: a rowscale-0 row is not zero")
            # where p nears the smoothed target, p - target cancels and one
            # ulp of the result is finer than the f32 logits' summation
            # order can promise: dl must be within one bf16 ulp of itself
            # plus one of the terms it is the difference of, |p| + |target|
            low, conf_low = _targets(ls, CE_V)
            differ, beyond, err = 0, 0, 0.0
            for i in range(0, n, 256):
                r = ref[i:i + 256].float()
                target = torch.full_like(r, low)
                target.scatter_(1, labels[i:i + 256, None].long(), low + conf_low)
                terms = (r.abs() + 2 * target * rs[i:i + 256, None]).bfloat16()
                d = (dl[i:i + 256].float() - r).abs()
                require(bool((d <= _bf16_ulp(ref[i:i + 256]) + _bf16_ulp(terms)).all()),
                        f"flash_ce_dl N={n}: dl beyond one bf16 ulp of dl and of its terms")
                differ += int((d > 0).sum())
                beyond += int((d > _bf16_ulp(ref[i:i + 256])).sum())
                err = max(err, d.max().item())
            db = (dbias - dbias_ref).abs().max().item() / dbias_ref.abs().max().item()
            require(db < 1e-4, f"flash_ce_dl N={n}: dbias")
            worst = max(worst, err)
            print(f"flash_ce_dl N={n} smoothing={ls}: dl entries differing from plain "
                  f"{differ} of {n * CE_V}, {beyond} of them by more than one ulp of dl "
                  f"(all within one of dl plus one of its terms), dl max_abs_err="
                  f"{err:.3g}, dbias max err / max |dbias|={db:.3g}, guard intact", flush=True)
            del buf, dl, ref
    return worst


def time_flash_ce(dev, weight, bias):
    """Both kernels and their plain versions at N=4096, and the dh / demb
    GEMMs over a bf16 dl: medians of 25 CUDA-event runs."""
    from mic_tpu_torch.ops.flash_ce import (
        _dl_gemms, flash_ce_dl, flash_ce_dl_plain, flash_ce_forward, flash_ce_forward_plain,
    )

    n = 4096
    hidden, labels = _ce_rows(dev, n, 11)
    lse = flash_ce_forward_plain(hidden, weight, bias, labels)[0]
    rs = torch.full((n,), 1.0 / n, device=dev)
    t = {
        "fwd": median_ms(lambda: flash_ce_forward(hidden, weight, bias, labels)),
        "fwd_plain": median_ms(lambda: flash_ce_forward_plain(hidden, weight, bias, labels)),
        "dl": median_ms(lambda: flash_ce_dl(hidden, weight, bias, labels, lse, rs, 0.1)),
        "dl_plain": median_ms(lambda: flash_ce_dl_plain(hidden, weight, bias, labels, lse, rs,
                                                        0.1)),
    }
    dl, _ = flash_ce_dl(hidden, weight, bias, labels, lse, rs, 0.1)
    dh_ms = median_ms(lambda: torch.mm(dl, weight, out_dtype=torch.float32))
    demb_ms = median_ms(lambda: torch.mm(dl.T, hidden, out_dtype=torch.float32))
    both_ms = median_ms(lambda: _dl_gemms(dl, weight, hidden))
    print(f"flash_ce_forward time at N={n} D={CE_D} V={CE_V}: kernel {t['fwd']:.4f} ms, "
          f"plain {t['fwd_plain']:.4f} ms", flush=True)
    print(f"flash_ce_dl time at N={n} D={CE_D} V={CE_V}: kernel {t['dl']:.4f} ms, "
          f"plain {t['dl_plain']:.4f} ms", flush=True)
    print(f"dl GEMMs (torch.mm bf16 -> f32 output, cuBLAS) at N={n}: dh {dh_ms:.4f} ms, "
          f"demb {demb_ms:.4f} ms, both {both_ms:.4f} ms", flush=True)
    return t


def _train_batches(config, n_batches, batch, seq, seed):
    """Batches in CaptionLoader's output format from seeded numpy: uint8
    crops at the decode size, captions of random length over a Zipf-like
    token set, the pad-prepend decoder shift."""
    rng = np.random.default_rng(seed)
    dec = config.decoder
    vocab = np.arange(4, 4 + 2000)
    p = 1.0 / np.arange(1, vocab.size + 1)
    out = []
    for _ in range(n_batches):
        labels = np.full((batch, seq), dec.pad_token_id, np.int32)
        mask = np.zeros((batch, seq), np.int32)
        for i, length in enumerate(rng.integers(8, seq + 1, batch)):
            labels[i, :length - 1] = rng.choice(vocab, length - 1, p=p / p.sum())
            labels[i, length - 1] = dec.eos_token_id
            mask[i, :length] = 1
        shifted = np.full_like(labels, dec.pad_token_id)
        shifted[:, 1:] = labels[:, :-1]
        out.append({
            "pixel_values": rng.integers(0, 256, (batch, 256, 256, 3), dtype=np.uint8),
            "labels": labels, "decoder_attention_mask": mask, "decoder_input_ids": shifted,
            "lang": np.zeros((batch,), np.int32),
        })
    return out


def run_training(dev):
    """The port's Trainer at flagship width, TrainConfig defaults (batch 64 x
    64 tokens, dropout 0.1, remat "masks", fused CE on the dl route, bf16
    moments and shadow) with warmup_steps=2: six steps, twice from one seed."""
    from mic_tpu.core.config import CaptionerConfig, DataConfig, TrainConfig
    from mic_tpu_torch.core.params import tree_leaves
    from mic_tpu_torch.ops.flash_ce import flash_ce_backward_dl, flash_ce_forward
    from mic_tpu_torch.train.trainer import Trainer

    config = CaptionerConfig.clip_vit_b32_mbart50(dtype="bfloat16")
    tc = TrainConfig(warmup_steps=2)
    dc = DataConfig()
    host = _train_batches(config, 6, tc.per_device_batch_size, dc.max_seq_length, 12)

    def one_run():
        trainer = Trainer(config, dc, tc, device=dev)
        trainer.build(steps_per_epoch=6)
        state = trainer.init_state()
        batches = [trainer.put_batch(b) for b in host]
        probe = trainer.put_batch(dict(host[0], loss_weight=np.ones(64, np.float32)))
        before = trainer.eval_step(state.params, probe)["loss"].item()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_ce_forward.launches = flash_ce_backward_dl.launches = 0
        losses, ms = [], []
        for batch in batches:
            t0 = time.perf_counter()
            state, metrics = trainer.train_step(state, batch)
            losses.append(metrics["loss"].item())  # waits for the step
            ms.append((time.perf_counter() - t0) * 1e3)
        launches = {"flash_ce_forward": flash_ce_forward.launches,
                    "flash_ce_backward_dl": flash_ce_backward_dl.launches}
        peak = torch.cuda.max_memory_allocated() / 2**30
        after = trainer.eval_step(state.params, probe)["loss"].item()
        return losses, ms, launches, peak, (before, after), state

    t0 = time.perf_counter()
    losses, ms, launches, peak, probe, state = one_run()
    print(f"training, flagship width, 6 steps of 64 x 64: losses {losses}, launches "
          f"{launches}, peak allocated {peak:.2f} GiB, probe-batch loss {probe[0]:.6f} -> "
          f"{probe[1]:.6f} ({time.perf_counter() - t0:.1f} s with init)", flush=True)
    require(all(np.isfinite(losses)), "a non-finite training loss")
    require(launches == {"flash_ce_forward": 6, "flash_ce_backward_dl": 6},
            "flash-CE kernels not launched exactly once per step")
    require(probe[1] < probe[0], "the loss on the repeated batch did not fall")
    params = [leaf.detach().clone() for _, leaf in tree_leaves(state.params)]
    del state
    torch.cuda.empty_cache()
    losses2, ms2, launches2, _, _, state2 = one_run()
    require(losses2 == losses, "a second run from the same seed gave other losses")
    require(all(torch.equal(a, b) for a, b in zip(params, (leaf for _, leaf in
                                                          tree_leaves(state2.params)))),
            "a second run from the same seed gave other params")
    step_ms = float(np.median(ms2[1:]))
    print("training: second run bit-equal (losses and every param)", flush=True)
    print(f"smoke figure (not a benchmark): flagship train step, batch 64 x 64, "
          f"median of steps 2-6 {step_ms:.1f} ms = {64 / step_ms * 1e3:.1f} samples/s "
          f"(step times {[round(x, 1) for x in ms2]} ms)", flush=True)
    return launches


def check_training_small_against_cpu(dev):
    """Three train steps at a small bf16 width, dropout 0, the dl route: the
    card (both CE kernels) against the CPU (plain versions) from the same
    weights.  Losses within 5e-3 relative (bf16 activations rounded in
    other orders); params within 2 x steps x lr absolute, the bound that
    Adam's normalized update allows a near-zero gradient."""
    from mic_tpu.core.config import (
        CaptionerConfig, DataConfig, DecoderConfig, TrainConfig, VisionConfig,
    )
    from mic_tpu_torch.core.params import tree_leaves, tree_map
    from mic_tpu_torch.models.captioner import init_params
    from mic_tpu_torch.train.trainer import Trainer

    config = CaptionerConfig(
        vision=VisionConfig.tiny(),
        decoder=DecoderConfig.tiny(vocab_size=1100, d_model=128, num_heads=2, ffn_dim=256,
                                   max_position_embeddings=64, dropout=0.0),
        dtype="bfloat16",
    )
    tc = TrainConfig(per_device_batch_size=4, learning_rate=1e-3, warmup_steps=1,
                     label_smoothing=0.1, flash_ce="dl")
    dc = DataConfig(max_seq_length=16, decode_size=40)
    params = init_params(config, torch.Generator().manual_seed(13))
    rng = np.random.default_rng(14)
    host = [{"pixel_values": rng.integers(0, 256, (4, 40, 40, 3), dtype=np.uint8),
             "labels": rng.integers(4, 1100, (4, 16)).astype(np.int32),
             "decoder_input_ids": rng.integers(4, 1100, (4, 16)).astype(np.int32),
             "decoder_attention_mask": np.ones((4, 16), np.int32)} for _ in range(3)]
    runs = {}
    for device in (dev, torch.device("cpu")):
        trainer = Trainer(config, dc, tc, device=device)
        trainer.build(10)
        state = trainer.init_state(tree_map(lambda x, d=device: x.clone().to(d), params))
        losses = []
        for batch in host:
            state, m = trainer.train_step(state, trainer.put_batch(batch))
            losses.append(m["loss"].item())
        runs[device.type] = (losses, [leaf.detach().cpu() for _, leaf in
                                      tree_leaves(state.params)])
    (lc, pc), (lh, ph) = runs["cuda"], runs["cpu"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    param_err = max((a - b).abs().max().item() for a, b in zip(pc, ph))
    print(f"training at a small width, card vs CPU: losses {lc} vs {lh}, max relative "
          f"difference {loss_rel:.3g}; params max abs difference {param_err:.3g}", flush=True)
    require(loss_rel < 5e-3, "card and CPU training losses differ")
    require(param_err < 2 * 3 * 1e-3, "card and CPU params differ")


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
    weight, bias = _ce_table(dev)
    fwd_err = check_flash_ce_forward(dev, weight, bias)
    dl_err = check_flash_ce_dl(dev, weight, bias)
    ce_ms = time_flash_ce(dev, weight, bias)
    del weight, bias
    torch.cuda.empty_cache()
    launches.update(run_training(dev))
    torch.cuda.empty_cache()
    check_training_small_against_cpu(dev)

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
        {"name": "flash_ce_forward", "route": "cuda",
         "source": "mic_tpu_torch/csrc/flash_ce.cu",
         "replaces": "mic_tpu/ops/flash_ce.py:259",
         "launches": launches["flash_ce_forward"], "max_abs_err": fwd_err,
         "ms": ce_ms["fwd"], "plain_ms": ce_ms["fwd_plain"]},
        {"name": "flash_ce_backward_dl", "route": "cuda",
         "source": "mic_tpu_torch/csrc/flash_ce.cu",
         "replaces": "mic_tpu/ops/flash_ce.py:725",
         "launches": launches["flash_ce_backward_dl"], "max_abs_err": dl_err,
         "ms": ce_ms["dl"], "plain_ms": ce_ms["dl_plain"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    # the run uses one card, whatever else the machine shows
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
    }}), flush=True)


if __name__ == "__main__":
    main()
