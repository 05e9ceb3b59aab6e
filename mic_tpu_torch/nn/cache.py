"""The lazy beam-search KV cache (mic_tpu/nn/cache.py::LazyDecoderCache).

Row b*K + k of each layer's self K/V always holds what running slot k of
image b wrote at each step; which row holds a beam's token at position t is
tracked in ``ancestry``.  A beam reorder therefore moves no cache bytes: it
composes the ancestry.  The port has one layout, the merged
(B*K, T, H*Dh) one the attention kernel reads, and the decode step writes
each layer's new column into it in place.

Shapes:
  self_k / self_v : L-list of (B*K, max_len, H*Dh)
  cross_k/ cross_v: (L, B, enc_len, H, Dh) -- per image, beam-invariant
  ancestry        : (B, K, max_len) int32
  index           : host int -- number of positions already written
"""

from __future__ import annotations

import dataclasses

import torch


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
                    max_len: int) -> LazyDecoderCache:
    """Zeroed merged self K/V (one tensor per layer) and identity ancestry
    around the projected cross K/V (L, B, S, H, Dh), whose layer count,
    batch, heads, dtype and device the self cache takes."""
    num_layers, batch, _, num_heads, head_dim = cross_k.shape
    kw = dict(dtype=cross_k.dtype, device=cross_k.device)
    shape = (batch * num_beams, max_len, num_heads * head_dim)
    ancestry = torch.arange(num_beams, dtype=torch.int32, device=cross_k.device)
    return LazyDecoderCache(
        self_k=[torch.zeros(shape, **kw) for _ in range(num_layers)],
        self_v=[torch.zeros(shape, **kw) for _ in range(num_layers)],
        cross_k=cross_k,
        cross_v=cross_v,
        ancestry=ancestry[None, :, None].expand(batch, num_beams, max_len).contiguous(),
        index=0,
    )
