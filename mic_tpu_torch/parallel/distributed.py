"""Multi-process bootstrap (mic_tpu/parallel/distributed.py) and the
collectives the trainer runs over it.

``initialize_from_env()`` wires ``torch.distributed.init_process_group``
from the environment, keeping mic_tpu's contract (set by your launcher on
every process):
  MIC_TPU_COORDINATOR    host:port of rank 0 (opts in)
  MIC_TPU_NUM_PROCESSES  the process count
  MIC_TPU_PROCESS_ID     this process's rank
or, under torchrun, ``MIC_TPU_DISTRIBUTED=1`` with torchrun's RANK,
WORLD_SIZE, MASTER_ADDR and MASTER_PORT.  The backend is NCCL, one card a
rank (``cuda:LOCAL_RANK``); ``backend="gloo"`` (or MIC_TPU_DIST_BACKEND=gloo)
asks for gloo, as the CPU tests do.  Nothing switches backend by itself.

Gloo reduces CUDA tensors only in ``all_reduce`` and ``broadcast``: the
gather and scatter collectives below copy CUDA tensors through host memory
on a gloo group, and run on the device under NCCL.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# bytes of float gradient per all_reduce of the data-parallel step
BUCKET_BYTES = 64 << 20


def initialize_from_env(env: Optional[dict] = None, backend: Optional[str] = None) -> bool:
    """Initialize the default process group if the environment opts in.

    Returns True when a process group was initialized, False when neither
    MIC_TPU_COORDINATOR nor MIC_TPU_DISTRIBUTED=1 is set.  Call it before
    the Trainer is built (cli/train.py does)."""
    env = os.environ if env is None else env
    coordinator = env.get("MIC_TPU_COORDINATOR")
    auto = env.get("MIC_TPU_DISTRIBUTED", "") == "1"
    if not coordinator and not auto:
        return False
    backend = backend or env.get("MIC_TPU_DIST_BACKEND", "nccl")
    if coordinator:
        missing = [k for k in ("MIC_TPU_NUM_PROCESSES", "MIC_TPU_PROCESS_ID") if k not in env]
        if missing:
            raise ValueError(f"MIC_TPU_COORDINATOR={coordinator} needs {' and '.join(missing)}")
        init_method = f"tcp://{coordinator}"
        world, rank = int(env["MIC_TPU_NUM_PROCESSES"]), int(env["MIC_TPU_PROCESS_ID"])
    else:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if k not in env]
        if missing:
            raise ValueError(f"MIC_TPU_DISTRIBUTED=1 needs torchrun's {', '.join(missing)}")
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    if backend == "nccl":
        torch.cuda.set_device(local_device(env, rank))
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    logger.info("torch.distributed initialized: rank %d of %d (%s)", rank, world, backend)
    return True


def local_device(env: Optional[dict] = None, rank: Optional[int] = None) -> torch.device:
    """This rank's card: ``cuda:LOCAL_RANK`` (torchrun sets it), else the
    rank modulo the visible card count."""
    env = os.environ if env is None else env
    if "LOCAL_RANK" in env:
        return torch.device("cuda", int(env["LOCAL_RANK"]))
    rank = dist.get_rank() if rank is None else rank
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


def world() -> tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _staged(tensor: torch.Tensor, group) -> bool:
    return tensor.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_sum(tensors: list, group=None, bucket_bytes: int = BUCKET_BYTES) -> list:
    """Each tensor summed over ``group`` -> new tensors (views of flat
    buckets of about ``bucket_bytes``, one dtype a bucket), in order."""
    out, bucket, size = [], [], 0

    def flush():
        if not bucket:
            return
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        offset = 0
        for t in bucket:
            out.append(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()
        bucket.clear()

    for t in tensors:
        if bucket and (t.dtype != bucket[0].dtype or size + t.nbytes > bucket_bytes):
            flush()
            size = 0
        bucket.append(t)
        size += t.nbytes
    flush()
    return out


def all_gather_dim(shard: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The shards of every rank concatenated along ``dim``, in rank order."""
    n = dist.get_world_size(group)
    src = shard.contiguous()
    if _staged(src, group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(shard.device)


def reduce_scatter_dim(full: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The sum over ``group`` of ``full``, split along ``dim``: this rank's
    part.  Gloo has no reduce-scatter of CUDA tensors: it sums the whole
    tensor (``all_reduce``) and keeps this rank's part."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    if dist.get_backend(group) == "gloo":
        total = full.contiguous().clone()
        dist.all_reduce(total, group=group)
        return total.chunk(n, dim)[rank].contiguous()
    out = torch.empty_like(full.chunk(n, dim)[rank], memory_format=torch.contiguous_format)
    dist.reduce_scatter(out, [p.contiguous() for p in full.chunk(n, dim)], group=group)
    return out


def gather_objects(obj, group=None) -> list:
    """Every rank's ``obj``, in rank order, on every rank."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out
