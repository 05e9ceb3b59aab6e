"""Param and train-state persistence (mic_tpu/io/checkpoint.py), in the
port's own format: ``torch.save`` of nested dicts of tensors, read back by
``torch.load(..., weights_only=True)``.  Every leaf keeps its dtype and
shape (bf16 moments stay bf16).

- ``save_params`` / ``load_params``: a model directory's ``params.pt``
  (beside its config.json, models/captioner.py::save_pretrained);
- ``TrainCheckpointManager``: ``<output_dir>/checkpoints/<step>/{state.pt,
  meta.json}``, the train state (train/state.py::checkpoint_tree) and the
  data position, with rotation.  A save with ``data_meta`` (the
  trainer's) is written before ``save`` returns; one without it is copied
  to host memory and written by a background thread, as mic_tpu's Orbax
  manager writes it (``enable_async_checkpointing``); ``wait`` and
  ``close`` block on that write.

Files are written under a temporary name, flushed to disk and renamed, so
a step directory or a params file appears only when it is complete.

mic_tpu's Orbax trees (``<dir>/params/``, ``checkpoints/<step>/default/``)
are stored through tensorstore, which the port does not use: they raise a
ValueError here.  mic_tpu params cross over in-process instead, through
io/from_jax.py.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Optional

import torch

PARAMS_FILE = "params.pt"
STATE_FILE = "state.pt"
META_FILE = "meta.json"
ORBAX_PARAMS_DIR = "params"  # mic_tpu's model-directory layout

_FROM_JAX = ("mic_tpu's checkpoints are Orbax (tensorstore) trees, which the port cannot read; "
             "carry mic_tpu params across in-process with mic_tpu_torch/io/from_jax.py "
             "(from_jax(jax.device_get(params)), opt_state_from_jax for the optimizer) and "
             "save them with the port's save_params / TrainCheckpointManager")


def _abs(path: str) -> str:
    return os.path.abspath(path)


def _write(obj: Any, path: str) -> None:
    """torch.save to ``path`` and flush it to disk."""
    with open(path, "wb") as f:
        torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())


def _sync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _detached(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {key: _detached(value) for key, value in tree.items()}
    return tree.detach() if isinstance(tree, torch.Tensor) else tree


def _host_copy(tree: Any) -> Any:
    """Every tensor copied to host memory (a CPU tensor cloned too: the
    optimizer updates params and moments in place while the copy is
    written)."""
    if isinstance(tree, dict):
        return {key: _host_copy(value) for key, value in tree.items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach()
        return tree.clone() if tree.device.type == "cpu" else tree.to("cpu")
    return tree


def save_params(directory: str, params: Any) -> None:
    directory = _abs(directory)
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{PARAMS_FILE}.", dir=directory)
    os.close(fd)
    try:
        _write(_detached(params), tmp)
        os.replace(tmp, os.path.join(directory, PARAMS_FILE))
    except BaseException:
        os.unlink(tmp)
        raise
    _sync_dir(directory)


def load_params(directory: str, device="cpu") -> Any:
    """The params of a model directory, on ``device``."""
    directory = _abs(directory)
    path = os.path.join(directory, PARAMS_FILE)
    if not os.path.exists(path):
        if os.path.isdir(os.path.join(directory, ORBAX_PARAMS_DIR)):
            raise ValueError(f"{directory} holds a mic_tpu Orbax param tree "
                             f"({ORBAX_PARAMS_DIR}/), not the port's {PARAMS_FILE}: {_FROM_JAX}")
        raise FileNotFoundError(f"no {PARAMS_FILE} under {directory}")
    return torch.load(path, map_location=device, weights_only=True)


class TrainCheckpointManager:
    """Step-indexed train-state checkpoints with rotation and resume.

    Layout: <output_dir>/checkpoints/<step>/{state.pt, meta.json}.
    ``state.pt`` holds train/state.py::checkpoint_tree (params, opt_state,
    step, the dropout generator's state); meta.json the data position
    (epoch, batches consumed) so the loader can skip ahead.  Nothing is
    created on disk before the first save.

    One write at a time: a save without ``data_meta`` hands its host copy to
    a writer thread and returns; the next ``save``, ``wait``, ``close`` and
    every read of the directory (``all_steps``, ``latest_step``,
    ``restore``) first wait for it, and re-raise the error a failed write
    left.  Rotation runs after a write completes, in the same thread.
    """

    def __init__(self, output_dir: str, max_to_keep: Optional[int] = 6):
        self.directory = os.path.join(_abs(output_dir), "checkpoints")
        self.max_to_keep = max_to_keep
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def all_steps(self) -> list[int]:
        """The complete steps on disk, oldest first."""
        self.wait()
        return self._steps_on_disk()

    def _steps_on_disk(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(name) for name in os.listdir(self.directory) if name.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, data_meta: Optional[dict] = None) -> bool:
        """Write ``state`` (and ``data_meta``) as ``step``, then rotate.  A
        step already on disk is not written again (False), as in mic_tpu.
        Without ``data_meta`` the write completes in the background."""
        self.wait()
        if os.path.isdir(os.path.join(self.directory, str(step))):
            return False
        if data_meta is not None:
            self._write_step(step, _detached(state), data_meta)
            return True
        host = _host_copy(state)
        self._writer = threading.Thread(target=self._write_in_background, args=(step, host),
                                        name=f"checkpoint-{step}", daemon=True)
        self._writer.start()
        return True

    def _write_in_background(self, step: int, state: Any) -> None:
        try:
            self._write_step(step, state, None)
        except BaseException as err:  # re-raised by the caller's next save/wait/close
            self._error = err

    def _write_step(self, step: int, state: Any, data_meta: Optional[dict]) -> None:
        """The step directory under a temporary name, flushed, renamed into
        place, then rotation."""
        final = os.path.join(self.directory, str(step))
        os.makedirs(self.directory, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=f".{step}.", dir=self.directory)
        try:
            _write(state, os.path.join(tmp, STATE_FILE))
            if data_meta is not None:
                with open(os.path.join(tmp, META_FILE), "w") as f:
                    json.dump(data_meta, f)
                    f.flush()
                    os.fsync(f.fileno())
            _sync_dir(tmp)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        _sync_dir(self.directory)
        if self.max_to_keep is not None:
            for old in self._steps_on_disk()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))

    @classmethod
    def open(cls, path: str) -> tuple["TrainCheckpointManager", Optional[int]]:
        """Open an existing checkpoint tree for restore, accepting any of:
        a run's output_dir (containing ``checkpoints/``), the ``checkpoints``
        dir itself, or a specific ``checkpoints/<step>`` dir.  Returns
        (manager, step) where step is pinned only for the last form."""
        path = _abs(path)
        base = os.path.basename(path)
        step: Optional[int] = None
        if base.isdigit() and os.path.basename(os.path.dirname(path)) == "checkpoints":
            step = int(base)
            path = os.path.dirname(path)
        if os.path.basename(path) == "checkpoints":
            path = os.path.dirname(path)
        if not os.path.isdir(os.path.join(path, "checkpoints")):
            raise FileNotFoundError(f"no checkpoints/ directory under {path}")
        # rotation must never delete from a tree that is only read
        return cls(path, max_to_keep=None), step

    def restore(self, step: Optional[int] = None, device="cpu"):
        """(state tree on ``device``, data meta or None) of ``step`` (default:
        the latest), or (None, None) when there is no checkpoint.  A write
        in flight completes first."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        step_dir = os.path.join(self.directory, str(step))
        path = os.path.join(step_dir, STATE_FILE)
        if not os.path.exists(path):
            if os.path.isdir(step_dir):
                raise ValueError(f"{step_dir} holds no {STATE_FILE}: {_FROM_JAX}")
            raise FileNotFoundError(f"no checkpoint of step {step} under {self.directory}")
        state = torch.load(path, map_location=device, weights_only=True)
        meta = None
        meta_path = os.path.join(step_dir, META_FILE)
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        return state, meta

    def wait(self) -> None:
        """Block until no write is in flight; re-raise the error of a write
        that failed (once)."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        """Wait for the write in flight, as ``wait``; nothing else is held
        open between calls."""
        self.wait()
