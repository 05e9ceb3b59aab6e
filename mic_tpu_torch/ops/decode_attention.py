"""Decode-step self-attention on the physical cache: the CUDA kernel and its
plain version.

Counterpart of mic_tpu/ops/decode_attention.py::decode_attention
(MIC_TPU_EXPERIMENTAL=fused_decode).  The stacked (L, N, T, H, Dh) self K/V
of nn/cache.py::DecoderCache gain the step's K/V at [layer, :, index] IN
PLACE, and the step attends over positions 0..index with an f32 softmax.
The layer and the index are host ints (launch arguments on CUDA).

The wrapper takes the plain version for tensors on the CPU and its kernel
(csrc/decode_attention.cu) for tensors on a CUDA device; it never falls
back from one to the other.
"""

from __future__ import annotations

import torch

from mic_tpu_torch import _build

# masked scores (mic_tpu/ops/decode_attention.py NEG_INF)
NEG_INF = -1e30
_ENTRIES = {torch.bfloat16: "mic_decode_attention_bf16", torch.float32: "mic_decode_attention_f32"}
# csrc/decode_attention.cu: positions a lane group reads a round (kUnroll),
# the most splits of a pair (kMaxSplits, the warps of a block), and the
# warps an SM keeps in flight that the split count aims for
UNROLL = 4
MAX_SPLITS = 4
WARPS_PER_SM = 16


def lane_groups(elem_bytes: int, head_dim: int = 64) -> int:
    """Positions one warp load covers: 32 lanes over rows of ``head_dim``
    elements read 16 bytes a lane (4 in bf16, 2 in f32)."""
    return 32 * 16 // (head_dim * elem_bytes)


def decode_splits(rows: int, heads: int, index: int, sms: int, groups: int = 4) -> int:
    """How many warps (1, 2 or 4) the kernel cuts each (row, head) pair's
    walk over positions 0..index into: doubled while the warps stay within
    ``WARPS_PER_SM`` an SM and each split keeps at least one full round of
    ``groups`` x ``UNROLL`` positions."""
    splits = 1
    while (splits < MAX_SPLITS and rows * heads * splits * 2 <= sms * WARPS_PER_SM
           and index + 1 >= 2 * splits * groups * UNROLL):
        splits *= 2
    return splits


def walk_partition(index: int, splits: int, groups: int = 4):
    """The kernel's partition of positions 0..index: split s takes
    [s * P // splits, (s + 1) * P // splits) of the P = index + 1 positions,
    and its lane group g the positions b + g, b + g + groups, ... of that
    range -> positions[s][g] (lists)."""
    positions = index + 1
    out = []
    for s in range(splits):
        b, e = s * positions // splits, (s + 1) * positions // splits
        out.append([list(range(b + g, e, groups)) for g in range(groups)])
    return out


def _merge(a, b):
    """Fold online softmax states (m, l, acc), as the kernel's merge_state."""
    (m, l, acc), (om, ol, oacc) = a, b
    mm = torch.maximum(m, om)
    empty = mm == float("-inf")
    safe = torch.where(empty, torch.zeros_like(mm), mm)
    wa = torch.where(m == float("-inf"), torch.zeros_like(m), torch.exp(m - safe))
    wb = torch.where(om == float("-inf"), torch.zeros_like(om), torch.exp(om - safe))
    return (torch.where(empty, m, mm), l * wa + ol * wb, acc * wa[..., None] + oacc * wb[..., None])


def decode_attention_split_plain(q, k_step, v_step, cache_k, cache_v, layer: int, index: int,
                                 splits: int, groups: int = 4) -> torch.Tensor:
    """The kernel's arithmetic in plain torch: the column written, each lane
    group's online (max, sum, acc) over its positions of
    ``walk_partition``, the groups of a split merged by the kernel's xor
    butterfly, then the splits in order -> (N, 1, H, Dh) in q's dtype."""
    cache_k[layer, :, index] = k_step[:, 0]
    cache_v[layer, :, index] = v_step[:, 0]
    qf = q[:, 0].float()                                   # (N, H, Dh)
    kl, vl = cache_k[layer].float(), cache_v[layer].float()
    ninf = torch.full(qf.shape[:2], float("-inf"), device=q.device)
    empty = (ninf, torch.zeros_like(ninf), torch.zeros_like(qf))
    states = []
    for split in walk_partition(index, splits, groups):
        lanes = []
        for ts in split:
            m, l, acc = empty
            for t in ts:
                s = (qf * kl[:, t]).sum(-1)
                mx = torch.maximum(m, s)
                scale, p = torch.exp(m - mx), torch.exp(s - mx)
                m, l, acc = mx, l * scale + p, acc * scale[..., None] + p[..., None] * vl[:, t]
            lanes.append((m, l, acc))
        width = 1
        while width < groups:  # the butterfly: group g with g ^ width
            lanes = [_merge(lanes[g], lanes[g ^ width]) for g in range(groups)]
            width *= 2
        states.append(lanes[0])
    m, l, acc = states[0]
    for other in states[1:]:
        m, l, acc = _merge((m, l, acc), other)
    return (acc / l[..., None])[:, None].to(q.dtype)


def decode_attention_plain(q, k_step, v_step, cache_k, cache_v, layer: int,
                           index: int) -> torch.Tensor:
    """mic_tpu's off-TPU branch: write the column, then f32 scores from the
    f32-cast q and K over all T positions, -1e30 beyond ``index``, softmax,
    the f32 weighted V sum, cast to q's dtype.

    q, k_step, v_step (N, 1, H, Dh), q already scaled by Dh**-0.5; caches
    (L, N, T, H, Dh) -> (N, 1, H, Dh); the caches gain column ``index`` of
    layer ``layer``."""
    cache_k[layer, :, index] = k_step[:, 0]
    cache_v[layer, :, index] = v_step[:, 0]
    kl, vl = cache_k[layer], cache_v[layer]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kl.float())
    valid = torch.arange(kl.shape[1], device=q.device) <= index
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, vl.float())
    return out.to(q.dtype)


def decode_attention(q, k_step, v_step, cache_k, cache_v, layer: int,
                     index: int) -> torch.Tensor:
    """One layer's decode attention at write position ``index``:
    -> (N, 1, H, Dh); the caches gain column ``index`` of layer ``layer``."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_step, v_step, cache_k, cache_v, layer, index)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    layers, n, t, heads, dh = cache_k.shape
    entry = _ENTRIES.get(q.dtype)
    tensors = (q, k_step, v_step, cache_k, cache_v)
    if entry is None or any(x.dtype != q.dtype for x in tensors):
        raise TypeError("decode_attention kernel: q, step rows and caches must all be "
                        "bfloat16 or all float32")
    if dh != 64:
        raise ValueError(f"decode_attention kernel: head_dim must be 64, got {dh}")
    if not (0 <= layer < layers and 0 <= index < t):
        raise ValueError(f"decode_attention kernel: layer={layer}, index={index}, "
                         f"cache {tuple(cache_k.shape)}")
    if (q.shape != (n, 1, heads, dh) or k_step.shape != q.shape or v_step.shape != q.shape
            or cache_v.shape != cache_k.shape):
        raise ValueError("decode_attention kernel: inconsistent shapes")
    for x in tensors:
        if x.device != q.device or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("decode_attention kernel: tensors must be contiguous, "
                             "16-byte aligned and on one device")
    out = torch.empty_like(q)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits = decode_splits(n, heads, index, sms, lane_groups(q.element_size(), dh))
    err = getattr(_build.lib(), entry)(
        q.data_ptr(), k_step.data_ptr(), v_step.data_ptr(), cache_k.data_ptr(),
        cache_v.data_ptr(), out.data_ptr(), layers, n, t, heads, dh, layer, index, splits,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, entry)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
