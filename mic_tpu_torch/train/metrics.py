"""Training observability (mic_tpu/train/metrics.py without JAX): scalars
to ``<output_dir>/metrics.jsonl``, one JSON object a line, and a step timer
that never synchronizes the device."""

from __future__ import annotations

import json
import os
import time
from typing import Mapping


class MetricLogger:
    def __init__(self, output_dir: str):
        os.makedirs(output_dir, exist_ok=True)
        self._jsonl = open(os.path.join(output_dir, "metrics.jsonl"), "a")

    def log(self, step: int, scalars: Mapping[str, float], prefix: str = "") -> None:
        flat = {(f"{prefix}/{k}" if prefix else k): float(v) for k, v in scalars.items()}
        self._jsonl.write(json.dumps({"step": int(step), **flat}) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()


class StepTimer:
    """Steps and samples per second over host time since the last reset.
    Steps are queued asynchronously, so a rate is only exact once the host
    has waited for the device (reading a loss does)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.t0 = time.perf_counter()
        self.steps = 0

    def tick(self, n: int = 1) -> None:
        self.steps += n

    def rates(self, samples_per_step: int) -> dict:
        dt = max(time.perf_counter() - self.t0, 1e-9)
        sps = self.steps / dt
        return {"steps_per_sec": sps, "samples_per_sec": sps * samples_per_step}
