#!/usr/bin/env python3
"""The port's Trainer in several processes, held against one process: the
rank (``python3 tools/torch_rank_worker.py SPEC RANK``), the launcher
(``spawn``) and the comparison (``loss_gaps``, ``param_gaps``), shared by
tests/test_torch_parallel.py (gloo on the CPU) and chip_smoke.py (phase
60: gloo, two ranks on one card; ``--cards N``: NCCL, a card a rank).

SPEC is a JSON file:
  ``world``        the number of ranks
  ``init_method``  a ``file://`` rendezvous for init_process_group, with
                   ``backend``; or ``contract`` true: ``spawn`` sets
                   mic_tpu's environment contract on every rank
                   (MIC_TPU_COORDINATOR on localhost, MIC_TPU_NUM_PROCESSES,
                   MIC_TPU_PROCESS_ID, LOCAL_RANK, MIC_TPU_DIST_BACKEND) and
                   the rank calls parallel/distributed.py::initialize_from_env
  ``device``       "cpu", "cuda:0", or null for the rank's own card
                   (cuda:LOCAL_RANK)
  ``cases``        each with its ``model``, ``data`` and ``train`` configs
                   (dicts) and ``out`` directory, and optionally
                   ``params`` (whole float32 params to start from, a
                   ``torch.save`` file; else drawn from the seed),
                   ``batches`` (global batches, ``.npz`` with one array a
                   key and batch, ``<key>_<i>``: a step on this rank's rows
                   of each), ``steps_per_epoch`` (10), ``checkpoint`` (save,
                   restore in a new Trainer of the same layout, record
                   whether every part came back bit-equal) or ``loop`` (run
                   ``Trainer.train()`` on the data config instead).

For each case every rank writes ``rank<r>.json`` to ``out``: the global
batch's losses, each step's time (host clock, after a device sync), the
training kernels' launches during the steps, the bytes of its params and
moments, its peak device memory; rank 0 also writes the whole state (parts
gathered) to ``final.pt``.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mic_tpu_torch.core.config import CaptionerConfig, DataConfig, TrainConfig  # noqa: E402
from mic_tpu_torch.core.params import tree_leaves, tree_map  # noqa: E402
from mic_tpu_torch.parallel.distributed import initialize_from_env  # noqa: E402
from mic_tpu_torch.parallel.sharding import tree_bytes  # noqa: E402
from mic_tpu_torch.train.trainer import Trainer  # noqa: E402


def _batches(path) -> list:
    data = np.load(path)
    keys = sorted({name.rsplit("_", 1)[0] for name in data.files})
    n = len(data.files) // len(keys)
    return [{k: data[f"{k}_{i}"] for k in keys} for i in range(n)]


def _bits_equal(a, b) -> bool:
    pairs = [(a.params, b.params), (a.opt_state.mu, b.opt_state.mu),
             (a.opt_state.nu, b.opt_state.nu)]
    if a.shadow is not None:
        pairs.append((a.shadow, b.shadow))
    return all(x.dtype == y.dtype and x.shape == y.shape
               and torch.equal(x.detach().view(torch.uint8), y.detach().view(torch.uint8))
               for ta, tb in pairs for (_, x), (_, y) in zip(tree_leaves(ta), tree_leaves(tb)))


def _launches(reset: bool = False) -> dict:
    """The training path's kernel launch counters (flash-CE and the
    full-sequence attention kernels) that are not 0; set to 0 with
    ``reset``."""
    from mic_tpu_torch.ops import flash_attention, flash_ce, small_attention

    fields = {"flash_ce_forward": (flash_ce.flash_ce_forward, "launches"),
              "flash_ce_forward_save": (flash_ce.flash_ce_forward, "save_launches"),
              "flash_ce_backward_dl": (flash_ce.flash_ce_backward_dl, "launches"),
              "flash_ce_backward": (flash_ce.flash_ce_backward, "launches"),
              "flash_ce_backward_save": (flash_ce.flash_ce_backward_save, "launches"),
              "small_attention_forward": (small_attention.small_attention_forward, "launches"),
              "small_attention_backward": (small_attention.small_attention_backward, "launches"),
              "flash_attention": (flash_attention.flash_attention_forward, "launches")}
    if reset:
        for fn, attr in fields.values():
            setattr(fn, attr, 0)
    return {name: getattr(fn, attr) for name, (fn, attr) in fields.items()
            if getattr(fn, attr)}


def run_case(case: dict, rank: int, device) -> None:
    mc = CaptionerConfig.from_dict(case["model"])
    dc = DataConfig.from_dict(case["data"])
    tc = TrainConfig.from_dict(case["train"])
    if case.get("loop"):
        Trainer(mc, dc, tc, device=device).train()
        return
    trainer = Trainer(mc, dc, tc, device=device)
    on_card = trainer.device.type == "cuda"
    trainer.build(case.get("steps_per_epoch", 10))
    params = torch.load(case["params"], weights_only=True) if case.get("params") else None
    state = trainer.init_state(params)
    batches = [trainer.put_batch(trainer.local_rows(b)) for b in _batches(case["batches"])]
    if on_card:
        torch.cuda.synchronize(trainer.device)
        torch.cuda.reset_peak_memory_stats(trainer.device)
    _launches(reset=True)
    losses, ms = [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, batch)
        losses.append(float(metrics["loss"]))
        if on_card:
            torch.cuda.synchronize(trainer.device)
        ms.append((time.perf_counter() - t0) * 1e3)
    record = {"losses": losses, "ms": ms, "launches": _launches(), "ranks": trainer.ranks,
              "fsdp": trainer.fsdp, "device": str(trainer.device),
              "backend": dist.get_backend(),
              "state_bytes": tree_bytes({"params": state.params, "mu": state.opt_state.mu,
                                         "nu": state.opt_state.nu}),
              "peak_gib": (torch.cuda.max_memory_allocated(trainer.device) / 2**30
                           if on_card else None)}
    whole = {"params": trainer.full_params(state.params),
             "mu": trainer.full_params(state.opt_state.mu),
             "nu": trainer.full_params(state.opt_state.nu)}
    if rank == 0:
        torch.save(tree_map(lambda t: t.detach().cpu(), whole),
                   os.path.join(case["out"], "final.pt"))
    del whole
    if case.get("checkpoint"):
        trainer.save(state.step, state, {"epoch": 0, "next_batch": state.step})
        again = Trainer(mc, dc, tc, device=device)
        again.build(case.get("steps_per_epoch", 10))
        restored, meta = again.restore(again.ckpt)
        record["resumed_bit_equal"] = (_bits_equal(state, restored)
                                       and restored.step == state.step
                                       and meta == {"epoch": 0, "next_batch": state.step})
    with open(os.path.join(case["out"], f"rank{rank}.json"), "w") as f:
        json.dump(record, f)
    if on_card:
        del trainer, state, batches
        torch.cuda.empty_cache()


def rank_main(spec_path: str, rank: int) -> None:
    with open(spec_path) as f:
        spec = json.load(f)
    torch.manual_seed(1234 + rank)  # nothing may read the default generator
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if spec.get("contract"):
        assert initialize_from_env(), "the environment contract did not start a group"
    else:
        dist.init_process_group(spec["backend"], init_method=spec["init_method"], rank=rank,
                                world_size=spec["world"])
    try:
        for case in spec["cases"]:
            run_case(case, rank, spec.get("device"))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(spec: dict, root: str, timeout: float, env: dict | None = None,
          backend: str = "gloo") -> list[str]:
    """Write ``spec`` under ``root`` and run its ``world`` ranks, each
    waited for with ``timeout`` seconds of its own; ranks still running
    then are killed.  ``env`` is added to every rank's environment;
    ``backend`` is the contract's where ``spec`` asks for it.  Raises with
    a failed rank's output -> every rank's output."""
    path = os.path.join(root, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    port = _free_port()
    procs = []
    for rank in range(spec["world"]):
        rank_env = {**os.environ, **(env or {})}
        if spec.get("contract"):
            rank_env.update(MIC_TPU_COORDINATOR=f"localhost:{port}",
                            MIC_TPU_NUM_PROCESSES=str(spec["world"]),
                            MIC_TPU_PROCESS_ID=str(rank), LOCAL_RANK=str(rank),
                            MIC_TPU_DIST_BACKEND=backend)
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), path,
                                       str(rank)], env=rank_env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        if proc.returncode != 0:
            raise RuntimeError(f"rank {rank} exited {proc.returncode}:\n{log[-4000:]}")
    return logs


def loss_gaps(got, want) -> list:
    """|got - want| / |want|, step by step."""
    return [abs(a - b) / abs(b) for a, b in zip(got, want)]


def param_gaps(got: dict, want: dict, close: float) -> tuple[float, float]:
    """Params ``got`` against ``want`` ({path: tensor}, every path of
    ``want`` in ``got`` with its dtype and shape) -> (the largest
    difference, the largest share of a leaf's entries beyond ``close``).
    The share leaves out the key biases: a key bias adds one constant to
    all of a query's scores, which the softmax cancels, so its gradient is
    rounding noise, whole, and Adam moves it by about lr a step whatever
    the noise's size."""
    worst, far = 0.0, 0.0
    for path, ref in want.items():
        x = got[path]
        if x.dtype != ref.dtype or x.shape != ref.shape:
            raise ValueError(f"{path}: {x.dtype} {tuple(x.shape)} against "
                             f"{ref.dtype} {tuple(ref.shape)}")
        diff = (x.double().to(ref.device) - ref.double()).abs()
        worst = max(worst, diff.max().item())
        if tuple(path[-2:]) != ("k", "bias"):
            far = max(far, (diff > close).double().mean().item())
    return worst, far


if __name__ == "__main__":
    rank_main(sys.argv[1], int(sys.argv[2]))
