"""LR schedule (mic_tpu/train/schedule.py): linear warmup from 0 to lr over
``warmup_steps``, then linear decay to 0 over the remaining steps, joined
at ``warmup_steps``.  The arithmetic is float32 in the order of optax's
linear_schedule and join_schedules, so the rates equal mic_tpu's."""

from __future__ import annotations

from typing import Callable

import numpy as np


def _linear(init: float, end: float, steps: int, count: int) -> np.float32:
    count = min(max(count, 0), steps)
    frac = np.float32(1) - np.float32(count) / np.float32(steps)
    return np.float32(init - end) * frac + np.float32(end)


def linear_warmup_linear_decay(learning_rate: float, total_steps: int,
                               warmup_steps: int) -> Callable[[int], float]:
    """-> fn(step) giving the learning rate, a float32 value, at ``step``."""
    warmup_len = max(warmup_steps, 1)
    decay_len = max(total_steps - warmup_steps, 1)

    def fn(step: int) -> float:
        step = int(step)
        if step < warmup_steps:
            return float(_linear(0.0, learning_rate, warmup_len, step))
        return float(_linear(learning_rate, 0.0, decay_len, step - warmup_steps))

    return fn
