"""The decode KV caches (mic_tpu/nn/cache.py): the physical
``DecoderCache`` of greedy, sampling and ``lazy_cache=False`` beam search,
and the lazy beam-search cache ``LazyDecoderCache``.

``DecoderCache`` stacks every layer's self K/V as one (L, N, T, H, Dh)
tensor per plane (N = images x beams) and the cross K/V once per image as
(L, B, S, H, Dh); the decode step writes each layer's column ``index`` in
place.  A beam reorder moves the self K/V rows (``beam_reorder``, through
ops/beam_permute.py).

In ``LazyDecoderCache`` row b*K + k of each layer's self K/V always holds what running slot k of
image b wrote at each step; which row holds a beam's token at position t is
tracked in ``ancestry``.  A beam reorder therefore moves no cache bytes: it
composes the ancestry.  The self K/V values are always stored
(B*K, T, H*Dh), the same memory as mic_tpu's canonical (B*K, T, H, Dh),
and the decode step writes each layer's new column into them in place.
With ``kv_quant="int8"`` each layer's K and V are int8 values and f32
scales in one of mic_tpu's two layouts:
  - merged (the default; lazy-attention mode "2"): {"q": (B*K, T, H*Dh)
    int8, "s": (B*K, T)}, one scale per cached ROW;
  - canonical (``merged=False``; mode "1"): {"q": (B*K, T, H*Dh) int8,
    "s": (B*K, T, H)}, one scale per (row, position, head).

Shapes of ``LazyDecoderCache``:
  self_k / self_v : L-list of (B*K, max_len, H*Dh), or of int8 dicts
  cross_k/ cross_v: (L, B, enc_len, H, Dh) -- per image, beam-invariant;
                    or merged (L, B, S_pad, H*Dh), S padded with zero rows
                    to a multiple of 16 (MIC_TPU_EXPERIMENTAL=merged_cross)
  ancestry        : (B, K, max_len) int32
  index           : host int -- number of positions already written
"""

from __future__ import annotations

import dataclasses

import torch

from mic_tpu_torch.ops.beam_permute import beam_permute


@dataclasses.dataclass(frozen=True)
class LazyDecoderCache:
    self_k: list
    self_v: list
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    ancestry: torch.Tensor
    index: int

    def beam_reorder(self, beam_indices: torch.Tensor, num_beams: int) -> "LazyDecoderCache":
        """Compose the ancestry with the chosen within-group source slots
        (B, K).  Written positions (< index) inherit the source beam's
        ancestry; unwritten ones reset to the identity."""
        b, k, t = self.ancestry.shape
        gathered = self.ancestry.gather(
            1, beam_indices.long()[:, :, None].expand(b, k, t)
        )
        ident = torch.arange(num_beams, dtype=torch.int32, device=self.ancestry.device)
        written = torch.arange(t, device=self.ancestry.device) < self.index
        ancestry = torch.where(written[None, None, :], gathered, ident[None, :, None])
        return dataclasses.replace(self, ancestry=ancestry.contiguous())


def init_lazy_cache(cross_k: torch.Tensor, cross_v: torch.Tensor, num_beams: int,
                    max_len: int, kv_quant: str | None = None,
                    merged: bool = True, num_heads: int | None = None) -> LazyDecoderCache:
    """Zeroed self K/V (one tensor, or int8 dict, per layer) and identity
    ancestry around the projected cross K/V (L, B, S, H, Dh), or merged
    (L, B, S_pad, H*Dh), whose layer count, batch, width, dtype and device
    the self cache takes.  An int8 cache has per-row scales when ``merged``,
    else per-head ones; those need ``num_heads`` beside a merged cross cache."""
    num_layers, batch = cross_k.shape[:2]
    if cross_k.ndim == 5:
        num_heads = cross_k.shape[3]
    elif num_heads is None and kv_quant and not merged:
        raise ValueError("init_lazy_cache: per-head int8 scales beside a merged cross cache "
                         "need num_heads")
    device = cross_k.device
    shape = (batch * num_beams, max_len, cross_k.shape[3:].numel())
    scales = shape[:2] if merged else (*shape[:2], num_heads)
    if kv_quant == "int8":
        def kv():
            return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
                    "s": torch.zeros(scales, dtype=torch.float32, device=device)}
    elif kv_quant:
        raise ValueError(f"unsupported kv_quant: {kv_quant!r}")
    else:
        def kv():
            return torch.zeros(shape, dtype=cross_k.dtype, device=device)
    ancestry = torch.arange(num_beams, dtype=torch.int32, device=device)
    return LazyDecoderCache(
        self_k=[kv() for _ in range(num_layers)],
        self_v=[kv() for _ in range(num_layers)],
        cross_k=cross_k,
        cross_v=cross_v,
        ancestry=ancestry[None, :, None].expand(batch, num_beams, max_len).contiguous(),
        index=0,
    )


@dataclasses.dataclass(frozen=True)
class DecoderCache:
    """The physical cache: self_k / self_v (L, N, T, H, Dh), cross_k /
    cross_v (L, B, S, H, Dh) per image, index a host int (positions
    already written)."""

    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    index: int

    @property
    def batch(self) -> int:
        return self.self_k.shape[1]

    @property
    def max_len(self) -> int:
        return self.self_k.shape[2]

    def beam_reorder(self, beam_indices: torch.Tensor, num_beams: int) -> "DecoderCache":
        """Physical beam reorder: row b*K + k of the self K/V takes row
        b*K + beam_indices[b, k] (within-group sources, (B, K)), the row move
        of mic_tpu/ops/beam_permute.py, one ops/beam_permute.py call a plane.
        The cross K/V are per image and never move."""
        return dataclasses.replace(
            self,
            self_k=beam_permute(self.self_k, beam_indices, num_beams),
            self_v=beam_permute(self.self_v, beam_indices, num_beams),
        )


def init_cache(cross_k: torch.Tensor, cross_v: torch.Tensor, batch: int,
               max_len: int) -> DecoderCache:
    """Zeroed (L, batch, max_len, H, Dh) self K/V around the projected cross
    K/V (L, B, S, H, Dh), whose layer count, heads, dtype and device the
    self cache takes; ``batch`` is images x beams."""
    num_layers, _, _, num_heads, head_dim = cross_k.shape
    shape = (num_layers, batch, max_len, num_heads, head_dim)
    return DecoderCache(
        self_k=torch.zeros(shape, dtype=cross_k.dtype, device=cross_k.device),
        self_v=torch.zeros(shape, dtype=cross_k.dtype, device=cross_k.device),
        cross_k=cross_k,
        cross_v=cross_v,
        index=0,
    )
