"""The physical cache's beam reorder: the CUDA kernel and its plain version.

Counterpart of mic_tpu/ops/beam_permute.py::beam_permute: for a stacked
(L, B*K, T, H, Dh) self K or V cache and the within-group source beams
(B, K), row b*K + n of every layer takes row b*K + beam_indices[b, n].  The
result is a new tensor; the input is only read.  mic_tpu's physical cache
moves its rows with the XLA ``beam_permute_matmul``, the same function.

``beam_permute`` takes the plain version (an ``index_select``) for tensors
on the CPU and its kernel (csrc/beam_permute.cu) for tensors on a CUDA
device; it never falls back from one to the other.  The kernel reads the
indices on the card and does not check them: each must lie in [0, K).
"""

from __future__ import annotations

import torch

from mic_tpu_torch import _build


def _source_rows(beam_indices: torch.Tensor, num_beams: int) -> torch.Tensor:
    b = beam_indices.shape[0]
    base = torch.arange(b, device=beam_indices.device)[:, None] * num_beams
    return (base + beam_indices.long()).reshape(-1)


def beam_permute_plain(kv: torch.Tensor, beam_indices: torch.Tensor,
                       num_beams: int) -> torch.Tensor:
    """kv (L, B*K, ...), beam_indices (B, K) -> the reordered copy."""
    return kv.index_select(1, _source_rows(beam_indices, num_beams))


def beam_permute(kv: torch.Tensor, beam_indices: torch.Tensor, num_beams: int) -> torch.Tensor:
    """Reorder every layer's beam rows: -> a new (L, B*K, ...) tensor."""
    if kv.device.type == "cpu":
        return beam_permute_plain(kv, beam_indices, num_beams)
    if kv.device.type != "cuda":
        raise ValueError(f"beam_permute: unsupported device {kv.device}")
    name = "beam_permute"
    layers, rows = kv.shape[:2]
    if (beam_indices.ndim != 2 or beam_indices.shape[1] != num_beams
            or beam_indices.shape[0] * num_beams != rows):
        raise ValueError(f"{name} kernel: beam_indices {tuple(beam_indices.shape)} do not "
                         f"match {rows} rows of {num_beams} beams")
    if kv.element_size() not in (1, 2, 4, 8):
        raise TypeError(f"{name} kernel: unsupported element size {kv.element_size()}")
    idx = beam_indices.to(torch.int32).contiguous()
    _build.check_operands(name, (kv, idx))
    out = torch.empty_like(kv)
    if kv.numel() == 0:
        return out
    err = _build.lib().mic_beam_permute(
        kv.data_ptr(), idx.data_ptr(), out.data_ptr(), layers, rows, num_beams,
        kv.numel() // (layers * rows), kv.element_size(),
        torch.cuda.current_stream(kv.device).cuda_stream,
    )
    _build.check(err, "mic_beam_permute")
    beam_permute.launches += 1
    return out


beam_permute.launches = 0
