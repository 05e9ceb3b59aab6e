#!/usr/bin/env python3
"""Trace one flagship beam-4 generate on one CUDA card and say where the
device time goes.

Run from the root of a checkout of the port (it imports that checkout's
mic_tpu_torch and chip_smoke.py, and builds its kernels there):

    python3 tools/torch_trace_generate.py [--batch 256] [--paths bf16,int8] [--out FILE]

For each path (bf16: the default knobs, the bucket head; int8: int8
weights and int8 KV cache, ``quantize="int8", kv_quant="int8"``), on the
flagship at full width with random weights (chip_smoke.flagship): one
untraced generate to warm up, then one generate of B images, beam 4,
max_length 64, every caption's EOS pinned at position 63 (``eos_positions``,
so that the run takes 63 decode steps whatever the weights emit) under
torch.profiler.  From the trace: the device's kernels, copies and sets;
busy ms is the union of their intervals, window ms the host clock around
the synchronised generate, the idle share 1 - busy / window; launches per
step; and the kernels that take most device time, each as a share of the
sum of device time, grouped by name.  One JSON line per path goes to stdout
and, with --out, to FILE.
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


def trace_path(model, params, px, kw, label: str, batch: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    model.generate(params, px, **kw)  # warm-up: builds, allocator, first launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = model.generate(params, px, **kw)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
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
    return {
        "path": label, "batch": batch, "steps": out.steps,
        "launches_per_step": len(kernels) / out.steps,
        "busy_ms": busy, "window_ms": window_ms, "idle_share": 1.0 - busy / window_ms,
        "device_ms_sum": total / 1e3,
        "top": [{"name": name, "ms": us / 1e3, "share": us / total} for name, us in top],
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--paths", default="bf16,int8")
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_trace_generate.py needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    _, params, model, kw, pixels = chip_smoke.flagship(dev)
    px = pixels(args.batch, 1)
    kw = dict(kw, eos_positions=torch.full((args.batch,), 63, device=dev, dtype=torch.int32))
    paths = {"bf16": kw, "int8": dict(kw, quantize="int8", kv_quant="int8")}
    rows = []
    for label in args.paths.split(","):
        row = dict(trace_path(model, params, px, paths[label], label, args.batch), card=card)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
