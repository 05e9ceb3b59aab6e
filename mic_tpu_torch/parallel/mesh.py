"""The ("data", "model") process mesh (mic_tpu/parallel/mesh.py), over
torch.distributed's ranks: one rank a device, rank = d * tp + m for data
index d and model index m (mic_tpu's reshape of its device list).  The
batch splits over "data"; "model" is tensor parallelism, which the port
does not train yet (ROADMAP A7b): ``tp = 1`` makes every rank a model
group of its own and "data" the whole world."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch.distributed as dist

from mic_tpu_torch.parallel.distributed import world

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape`` {axis: size}; ``groups`` {axis: the process group of this
    rank along it (None: the default group, or a group of one rank)};
    ``coords`` {axis: this rank's index along it}."""

    shape: dict
    groups: dict
    coords: dict

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]


def make_mesh(dp: int = -1, tp: int = 1, world_size: Optional[int] = None) -> Mesh:
    """Build a ("data", "model") mesh over the ranks. dp=-1 means all
    remaining ranks.  ``world_size`` defaults to the default group's (1
    without one); the errors are mic_tpu's."""
    rank, n = world()
    if world_size is not None:
        n = world_size
    if dp == -1:
        if n % tp != 0:
            raise ValueError(f"{n} devices not divisible by tp={tp}")
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != {n} devices")
    if tp > 1 and dist.is_available() and dist.is_initialized():
        raise NotImplementedError(f"tp={tp}: the model axis's process groups come with "
                                  "tensor parallelism (ROADMAP A7b)")
    # tp = 1 (or no process group): "data" is the default group, "model" a
    # group of one rank
    return Mesh({DATA_AXIS: dp, MODEL_AXIS: tp}, {DATA_AXIS: None, MODEL_AXIS: None},
                {DATA_AXIS: rank // tp, MODEL_AXIS: rank % tp})
