#!/usr/bin/env python3
"""Trace one flagship generate, or one flagship train step, on one CUDA
card and say where the device time goes.

Run from the root of a checkout of the port (it imports that checkout's
mic_tpu_torch and chip_smoke.py, and builds its kernels there):

    python3 tools/torch_trace_generate.py [--batch 256]
                                          [--paths bf16,int8,fused,merged,greedy] [--out FILE]
    python3 tools/torch_trace_generate.py --train [--routes dl,split,save] [--small-attn]
                                          [--out FILE]

For each path (bf16: the default knobs, the bucket head; int8: int8
weights and int8 KV cache, ``quantize="int8", kv_quant="int8"``; fused: the
fully fused beam step, bf16, under chip_smoke.FUSED_STEP's switches,
MIC_TPU_FUSED_LAZY_ATTN=1 and
MIC_TPU_EXPERIMENTAL=fused_cross_attn,fused_mlp,ln_qkv; merged: the merged
cross cache, MIC_TPU_EXPERIMENTAL=merged_cross; greedy: num_beams=1 on the
dense logits, MIC_TPU_EXPERIMENTAL=fused_decode,pallas_topk with
MIC_TPU_FUSED_HEAD=0, rows 18 and 17), on the
flagship at full width with random weights (chip_smoke.flagship): one
untraced generate to warm up, then one generate of B images (beam 4 but
on the greedy path), max_length 64, every caption's EOS pinned at position 63 (``eos_positions``,
so that the run takes 63 decode steps whatever the weights emit) under
torch.profiler.  From the trace: the device's kernels, copies and sets;
busy ms is the union of their intervals, window ms the host clock around
the synchronised generate, the idle share 1 - busy / window; launches per
step; and the kernels that take most device time, each as a share of the
sum of device time, grouped by name; and the device ms of the kernels of
rows 2, 3, 13, 14, 15, 16, 17 and 18 (``ROWS``: the int8 lazy attention of
the int8 path, the blocked lazy attention, the cross-attention, LN ->
GEMM's and the fused MLP's launches of the fused path, the merged
cross-attention of the merged path, the top-k + logsumexp and the decode
attention of the greedy path), each as a share of busy.  One JSON line per path goes to
stdout and, with --out, to FILE.

With --train: the port's Trainer at flagship width with the TrainConfig
defaults (batch 64 x 64 tokens, remat "masks"; warmup_steps=2) with the
fused loss on each route of --routes (TrainConfig.flash_ce; default "dl",
the CUDA default) on chip_smoke's seeded batches takes two untraced steps,
then one step under torch.profiler, the window being the host clock from
the step's call to its loss read; the same summary, launches counted for
the one step, one line a route.  With --small-attn, under
MIC_TPU_EXPERIMENTAL=small_attn (row 12's forward and backward in both
towers; their device ms as shares of busy).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.getcwd())

import chip_smoke  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# kernel-table rows by the full names of their kernels, in this tree and in
# the trees before their redesigns (the blocked attention shared
# attend_rows_kernel with the cross-attention, <T, true, true> its own and
# <T, false, false> the cross-attention's, which later had <T> alone; the
# split products' sums: the MLP's split_sum_kernel<Finish<..>>, LN ->
# GEMM's split_sum_kernel<AddBias>).  Rows 13 and 14 run one kernel; a
# path runs one of them (``PATH_ROWS``).
CROSS = (r"attend::tiles_kernel<|attend_rows_kernel<[^<>,]*>|"
         r"attend_rows_kernel<[^<>]*, false, false>")
ROWS = {
    "row 2": r"q8::split_kernel|lazy_attention_q8_kernel",
    "row 3": r"blocked::blocked_kernel<|attend_rows_kernel<[^<>]*, true, true>",
    "row 13": CROSS,
    "row 14": CROSS,
    "row 15": r"ln_gemm_kernel|split_sum_kernel<[^<>]*AddBias",
    "row 16": r"mlp_kernel<|mlp_finish_kernel<|fc1_act_kernel<|fc2_kernel|"
              r"split_sum_kernel<[^<>]*Finish<",
    # before their redesigns: the top-k's second launch, topk_lse_merge_kernel,
    # and the backward's small_attention_bwd_kernel<__nv_bfloat16>
    "row 17": r"topk_lse_kernel<|topk_lse_merge_kernel",
    "row 18": r"decode_attention",
    "row 12 forward": r"small_attention_fwd",
    "row 12 backward": r"small_attention_bwd",
}
# the rows a path can run, where not every row of ROWS
PATH_ROWS = {"fused": ("row 3", "row 14", "row 15", "row 16"),
             "merged": ("row 13",), "greedy": ("row 17", "row 18")}


def short_name(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    name = re.sub(r"\(.*$", "", name.replace("(anonymous namespace)::", ""))
    while "<" in name:
        stripped = re.sub(r"<[^<>]*>", "", name)
        if stripped == name:
            break
        name = stripped
    return name.split("::")[-1].split(" ")[-1] or name


def device_events(prof) -> list[tuple[str, str, float, float]]:
    """(category, name, start us, duration us) of every device event."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [(e.get("cat", ""), e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)))
            for e in events if e.get("ph") == "X" and e.get("cat", "") in DEVICE_CATS]


def busy_us(events) -> float:
    """The union of the events' intervals."""
    total, end = 0.0, float("-inf")
    for _, _, start, dur in sorted(events, key=lambda e: e[2]):
        stop = start + dur
        if start > end:
            total += dur
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


def summarize(prof, window_ms: float, label: str, steps: int, rows=ROWS) -> dict:
    """Busy ms, the idle share, launches per step and the top kernels of a
    trace whose window took ``window_ms`` on the host clock."""
    events = device_events(prof)
    kernels = [e for e in events if e[0] == "kernel"]
    if not kernels:
        raise SystemExit(f"{label}: the trace holds no device kernel")
    busy = busy_us(events) / 1e3
    by_name: dict[str, float] = {}
    for cat, name, _, dur in events:
        key = short_name(name) if cat == "kernel" else cat
        by_name[key] = by_name.get(key, 0.0) + dur
    total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    shares = {}
    for row, pattern in rows.items():
        hits = [dur for _, name, _, dur in kernels if re.search(pattern, name)]
        if hits:
            shares[row] = {"ms": sum(hits) / 1e3, "launches_per_step": len(hits) / steps,
                         "share_of_busy": sum(hits) / 1e3 / busy}
    return {
        "path": label, "steps": steps, "launches_per_step": len(kernels) / steps,
        "busy_ms": busy, "window_ms": window_ms, "idle_share": 1.0 - busy / window_ms,
        "device_ms_sum": total / 1e3,
        "top": [{"name": name, "ms": us / 1e3, "share": us / total} for name, us in top],
        "rows": shares,
    }


def trace_path(model, params, px, kw, label: str, batch: int, env=None) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with chip_smoke.knobs(**(env or {})):
        model.generate(params, px, **kw)  # warm-up: builds, allocator, first launches
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = model.generate(params, px, **kw)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
    rows = {row: ROWS[row] for row in PATH_ROWS.get(label, ROWS)}
    return dict(summarize(prof, window_ms, label, out.steps, rows), batch=batch)


def trace_train(dev, route: str, small_attn: bool = False) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from mic_tpu_torch.core.config import CaptionerConfig, DataConfig, TrainConfig
    from mic_tpu_torch.train.trainer import Trainer

    config = CaptionerConfig.clip_vit_b32_mbart50(dtype="bfloat16")
    tc = TrainConfig(warmup_steps=2, flash_ce=route)
    host = chip_smoke._train_batches(config, 3, tc.per_device_batch_size,
                                     DataConfig().max_seq_length, 12)
    trainer = Trainer(config, DataConfig(), tc, device=dev)
    trainer.build(steps_per_epoch=len(host))
    state = trainer.init_state()
    batches = [trainer.put_batch(b) for b in host]
    with chip_smoke.knobs(**({"MIC_TPU_EXPERIMENTAL": "small_attn"} if small_attn else {})):
        for batch in batches[:2]:  # warm-up: builds, allocator, first launches
            state, metrics = trainer.train_step(state, batch)
            metrics["loss"].item()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, metrics = trainer.train_step(state, batches[2])
            loss = metrics["loss"].item()  # waits for the step
            window_ms = (time.perf_counter() - t0) * 1e3
    label = f"train step, flash_ce {tc.flash_ce!r}" + (", small_attn" if small_attn else "")
    return dict(summarize(prof, window_ms, label, 1), batch=tc.per_device_batch_size,
                loss=loss)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--paths", default="bf16,int8")
    parser.add_argument("--out", default=None)
    parser.add_argument("--train", action="store_true")
    parser.add_argument("--routes", default="dl",
                        help="with --train: flash_ce routes, one trace each (dl,split,save,fwd)")
    parser.add_argument("--small-attn", action="store_true",
                        help="with --train: under MIC_TPU_EXPERIMENTAL=small_attn")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_trace_generate.py needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    if args.train:
        for route in args.routes.split(","):
            write_rows([dict(trace_train(dev, route, args.small_attn), card=card)], args.out)
            torch.cuda.empty_cache()
        return
    _, params, model, kw, pixels = chip_smoke.flagship(dev)
    px = pixels(args.batch, 1)
    kw = dict(kw, eos_positions=torch.full((args.batch,), 63, device=dev, dtype=torch.int32))
    paths = {"bf16": (kw, None), "int8": (dict(kw, quantize="int8", kv_quant="int8"), None),
             "fused": (kw, chip_smoke.FUSED_STEP), "merged": (kw, chip_smoke.MERGED_CROSS),
             "greedy": (dict(kw, num_beams=1),
                        dict(MIC_TPU_EXPERIMENTAL="fused_decode,pallas_topk",
                             MIC_TPU_FUSED_HEAD="0"))}
    rows = []
    for label in args.paths.split(","):
        path_kw, env = paths[label]
        rows.append(dict(trace_path(model, params, px, path_kw, label, args.batch, env=env),
                         card=card))
    write_rows(rows, args.out)


def write_rows(rows, out) -> None:
    for row in rows:
        print(json.dumps(row), flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
