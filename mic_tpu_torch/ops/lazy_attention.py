"""Lazy-beam decode self-attention: the CUDA kernel and its plain version.

Counterpart of mic_tpu/ops/lazy_attention.py::fused_lazy_attention_dma.  The
beam cache (nn/cache.py LazyDecoderCache) is never reordered; attention
scores every source row a query beam's ancestry names and the step's own
K/V row.  Both versions write the step K/V into column ``index`` of the
merged (B*K, T, H*Dh) caches IN PLACE and return only the attention output.

``lazy_attention_q8`` is the same on the int8 cache ({"q": int8 values,
"s": (B*K, T) f32 per-row scales}), following the TPU's _kernel_dma_q8
(q and the step rows bfloat16, or float32 on a float32 model):
the cached rows are read as int8 with their row scales on the scores and
the weights, and the step's own K/V row enters UNQUANTIZED (scale 1); the
step rows are quantized per merged row (ops/quant.py::quantize_rows_dynamic;
the kernel computes the same bits itself) only to be written into column
``index``.  Its kernel is a split two-pass walk, one block per beam row over
every head (``q8_layout`` shapes the block, ``q8_walk`` gives each thread's
positions).

``fused_lazy_attention`` is mode "1" (MIC_TPU_FUSED_LAZY_ATTN=1), the
counterpart of mic_tpu's blocked ``fused_lazy_attention``: it reads the
PRE-update cache and never writes it (the caller stores the step column
after it), takes liveness from the per-step (B, J*T, K) ancestry mask of
``build_ancestry_mask`` (strict t < index, shared by every layer), and
scores each beam's own step row unquantized.  Its int8 cache is mic_tpu's
canonical layout: {"q": (B*K, T, H*Dh) int8, "s": (B*K, T, H) f32}, one
scale per (row, position, head).  Its kernel is a split row walk: the rows
some beam admits gathered into a list, their K and V head rows copied into
shared memory once, both products on mma.sync (``blocked_layout`` lays out
the block's shared memory); a float32 model's cache (float32 rows, q and
step rows) takes the same walk with f32 FMAs, and its per-head int8 cache
takes float32 q and step rows.  Its plain version is ``attend_rows_plain``,
mic_tpu's _attend_tiles, which ops/cross_attention.py shares.  ``resolve_mode`` and ``supports`` pick the mode as mic_tpu does;
mode "0", mic_tpu's XLA chain, is plain tensor code in
nn/attention.py::lazy_attention_chain.

Each wrapper takes the plain version for tensors on the CPU and its kernel
(csrc/lazy_attention.cu) for tensors on a CUDA device; it never falls back
from one to the other.
"""

from __future__ import annotations

import math

import torch

from mic_tpu_torch import _build
from mic_tpu_torch.core.knobs import override
from mic_tpu_torch.ops.quant import quantize_rows_dynamic

# mic_tpu/nn/attention.py masks scores with finfo(float32).min, never -inf
_MASK_VALUE = torch.finfo(torch.float32).min
# the column-writing kernel's entry points by the dtype of q, caches and step rows
_LAZY_ENTRIES = {torch.bfloat16: "mic_lazy_attention_bf16",
                 torch.float32: "mic_lazy_attention_f32"}
# the int8 cache's, by the dtype of q and the step rows
_Q8_ENTRIES = {torch.bfloat16: "mic_lazy_attention_q8",
               torch.float32: "mic_lazy_attention_q8_f32"}


def lazy_attention_plain(q, cache_k, cache_v, k_step, v_step, ancestry,
                         index: int, num_heads: int) -> torch.Tensor:
    """The ``attend`` of mic_tpu/nn/attention.py::mha_decode_step_lazy on the
    merged layout: write the step column, then attend over t <= index.

    q, k_step, v_step (B, K, H*Dh), q already scaled by Dh**-0.5; caches
    (B*K, T, H*Dh); ancestry (B, K, T) int32 -> (B, K, H*Dh) in q.dtype."""
    b, beams, hd = q.shape
    dh = hd // num_heads
    cache_k[:, index] = k_step.reshape(b * beams, hd)
    cache_v[:, index] = v_step.reshape(b * beams, hd)
    tb = index + 1
    kg = cache_k[:, :tb].reshape(b, beams, tb, num_heads, dh)
    vg = cache_v[:, :tb].reshape(b, beams, tb, num_heads, dh)
    q4 = q.reshape(b, beams, num_heads, dh)
    scores = torch.einsum("bkhd,bjthd->bhkjt", q4.float(), kg.float())
    src = torch.arange(beams, device=q.device, dtype=ancestry.dtype)
    sel = ancestry[:, :, :tb, None] == src                  # (B, K, tb, J)
    mask = sel.permute(0, 1, 3, 2)                          # (B, K, J, tb)
    scores = torch.where(mask[:, None], scores, _MASK_VALUE)
    w = torch.softmax(scores.reshape(b, num_heads, beams, beams * tb), dim=-1)
    w = w.reshape(b, num_heads, beams, beams, tb).to(q.dtype)
    out = torch.einsum("bhkjt,bjthd->bkhd", w, vg.to(q.dtype))
    return out.reshape(b, beams, hd)


def lazy_attention(q, cache_k, cache_v, k_step, v_step, ancestry,
                   index: int, num_heads: int) -> torch.Tensor:
    """One layer's lazy-beam decode attention at write position ``index``
    (a host int): -> (B, K, H*Dh); the caches gain column ``index``."""
    if q.device.type == "cpu":
        return lazy_attention_plain(
            q, cache_k, cache_v, k_step, v_step, ancestry, index, num_heads
        )
    if q.device.type != "cuda":
        raise ValueError(f"lazy_attention: unsupported device {q.device}")
    b, beams, hd = q.shape
    t = cache_k.shape[1]
    dh = hd // num_heads
    tensors = (q, cache_k, cache_v, k_step, v_step)
    if q.dtype not in _LAZY_ENTRIES or any(x.dtype != q.dtype for x in tensors):
        raise TypeError("lazy_attention kernel: q, caches and step rows must be all bfloat16 "
                        "or all float32")
    if ancestry.dtype != torch.int32:
        raise TypeError("lazy_attention kernel: ancestry must be int32")
    if dh != 64 or hd != num_heads * dh:
        raise ValueError(f"lazy_attention kernel: head_dim must be 64, got {hd}/{num_heads}")
    if not 1 <= beams <= 32 or not 0 <= index < t:
        raise ValueError(f"lazy_attention kernel: beams={beams}, index={index}, T={t}")
    if (cache_k.shape != (b * beams, t, hd) or cache_v.shape != cache_k.shape
            or k_step.shape != q.shape or v_step.shape != q.shape
            or ancestry.shape != (b, beams, t)):
        raise ValueError("lazy_attention kernel: inconsistent shapes")
    for x in (*tensors, ancestry):
        if x.device != q.device or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("lazy_attention kernel: tensors must be contiguous, "
                             "16-byte aligned and on one device")
    out = torch.empty_like(q)
    entry = _LAZY_ENTRIES[q.dtype]
    err = getattr(_build.lib(), entry)(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        k_step.data_ptr(), v_step.data_ptr(), ancestry.data_ptr(),
        out.data_ptr(), b, beams, t, num_heads, dh, index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, entry)
    lazy_attention.launches += 1
    return out


lazy_attention.launches = 0  # both dtypes' launches


def lazy_attention_q8_plain(q, cache_k, cache_v, k_step, v_step, ancestry,
                            index: int, num_heads: int) -> torch.Tensor:
    """mic_tpu's _kernel_dma_q8 math in q's dtype (at bfloat16, the TPU
    kernel's): scores over the pre-update int8 rows t < index the ancestry
    names, times their K row scales, plus each beam's unquantized step row;
    f32 softmax; the cached weights times their V row scales, then both
    weights rounded to q's dtype before the V product; f32 sums.  Then the
    quantized step rows and their scales go into column ``index``.

    q, k_step, v_step (B, K, H*Dh); cache_k/v {"q": (B*K, T, H*Dh) int8,
    "s": (B*K, T) f32}; ancestry (B, K, T) int32 -> (B, K, H*Dh) in q.dtype."""
    b, beams, hd = q.shape
    dh = hd // num_heads
    dt = q.dtype

    def rows(cache):  # the live prefix as (B, J, t, H, Dh) f32 and scales (B, J, t)
        vals = cache["q"][:, :index].to(dt).float()
        return (vals.reshape(b, beams, index, num_heads, dh),
                cache["s"][:, :index].reshape(b, beams, index))

    kg, ks = rows(cache_k)
    vg, vs = rows(cache_v)
    q4 = q.reshape(b, beams, num_heads, dh).float()
    ks4 = k_step.to(dt).reshape(b, beams, num_heads, dh).float()
    vs4 = v_step.to(dt).reshape(b, beams, num_heads, dh).float()
    scores = torch.einsum("bkhd,bjthd->bhkjt", q4, kg) * ks[:, None, None]
    src = torch.arange(beams, device=q.device, dtype=ancestry.dtype)
    mask = (ancestry[:, :, :index, None] == src).permute(0, 1, 3, 2)   # (B, K, J, t)
    scores = torch.where(mask[:, None], scores, _MASK_VALUE)
    s_step = torch.einsum("bkhd,bkhd->bhk", q4, ks4)
    w = torch.softmax(
        torch.cat([scores.reshape(b, num_heads, beams, beams * index), s_step[..., None]], -1),
        dim=-1,
    )
    w_cache = w[..., :-1].reshape(b, num_heads, beams, beams, index) * vs[:, None, None]
    w_cache = w_cache.to(dt).float()
    w_step = w[..., -1].to(dt).float()                                 # (B, H, K)
    out = torch.einsum("bhkjt,bjthd->bkhd", w_cache, vg)
    out = out + w_step.permute(0, 2, 1)[..., None] * vs4
    out = out.reshape(b, beams, hd).to(dt)

    bk = b * beams
    k8, ksc = quantize_rows_dynamic(k_step.reshape(bk, hd))
    v8, vsc = quantize_rows_dynamic(v_step.reshape(bk, hd))
    cache_k["q"][:, index] = k8
    cache_k["s"][:, index] = ksc[:, 0]
    cache_v["q"][:, index] = v8
    cache_v["s"][:, index] = vsc[:, 0]
    return out


def lazy_attention_q8(q, cache_k, cache_v, k_step, v_step, ancestry,
                      index: int, num_heads: int) -> torch.Tensor:
    """One layer's lazy-beam decode attention on the int8 cache at write
    position ``index``: -> (B, K, H*Dh); the caches gain column ``index``
    (int8 values and scale) in place."""
    if q.device.type == "cpu":
        return lazy_attention_q8_plain(
            q, cache_k, cache_v, k_step, v_step, ancestry, index, num_heads
        )
    if q.device.type != "cuda":
        raise ValueError(f"lazy_attention_q8: unsupported device {q.device}")
    b, beams, hd = q.shape
    t = cache_k["q"].shape[1]
    dh = hd // num_heads
    if q.dtype not in _Q8_ENTRIES or any(x.dtype != q.dtype for x in (k_step, v_step)):
        raise TypeError("lazy_attention_q8 kernel: q and step rows must be all bfloat16 or all "
                        "float32")
    if any(c["q"].dtype != torch.int8 or c["s"].dtype != torch.float32
           for c in (cache_k, cache_v)):
        raise TypeError("lazy_attention_q8 kernel: caches must be int8 values, f32 scales")
    if ancestry.dtype != torch.int32:
        raise TypeError("lazy_attention_q8 kernel: ancestry must be int32")
    if dh != 64 or hd != num_heads * dh:
        raise ValueError(f"lazy_attention_q8 kernel: head_dim must be 64, got {hd}/{num_heads}")
    if beams < 1 or not 0 <= index < t:
        raise ValueError(f"lazy_attention_q8 kernel: beams={beams}, index={index}, T={t}")
    if (any(c["q"].shape != (b * beams, t, hd) or c["s"].shape != (b * beams, t)
            for c in (cache_k, cache_v))
            or k_step.shape != q.shape or v_step.shape != q.shape
            or ancestry.shape != (b, beams, t)):
        raise ValueError("lazy_attention_q8 kernel: inconsistent shapes")
    if b * beams * t >= 2**31:
        raise ValueError(f"lazy_attention_q8 kernel: B*K*T = {b * beams * t} positions "
                         "(fewer than 2**31)")
    group, groups, _ = q8_layout(num_heads, index)
    tensors = (q, cache_k["q"], cache_k["s"], cache_v["q"], cache_v["s"], k_step, v_step,
               ancestry)
    for x in tensors:
        if x.device != q.device or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("lazy_attention_q8 kernel: tensors must be contiguous, "
                             "16-byte aligned and on one device")
    out = torch.empty_like(q)
    entry = _Q8_ENTRIES[q.dtype]
    err = getattr(_build.lib(), entry)(
        *(x.data_ptr() for x in tensors), out.data_ptr(),
        b, beams, t, num_heads, dh, index, group, groups,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, entry)
    lazy_attention_q8.launches += 1
    return out


lazy_attention_q8.launches = 0  # both dtypes' launches

# the shared memory a block of csrc/lazy_attention.cu's kernels may take
_MAX_SMEM = 232448
# namespace q8: the threads a block takes at most (128: at the flagship's
# 64 registers, all 1024 blocks of B=256 K=4 resident at once; 256-thread
# blocks measured 5-20% slower), and the positions a thread loads before it
# folds them
_Q8_THREADS = 128
_Q8_BATCH = 4


def _align16(x: int) -> int:
    return -(-x // 16) * 16


def _q8_bytes(index: int, group: int, groups: int) -> int:
    """q8::Layout's bytes: the sources, K and V row scales and scores of the
    ``index`` live positions (scores for each of the ``group`` heads), the
    position groups' sixteen partial sums a piece, the step scores and
    weights, and the warps' amaxes.  No row of q or the step is staged, so
    the bfloat16 and float32 instances share it."""
    return (3 * _align16(4 * index) + _align16(4 * group * index) + 256 * group * groups
            + _align16(8 * group) + 256)


def q8_layout(heads: int, index: int) -> tuple[int, int, int]:
    """-> (group, groups, shared bytes) of the int8 kernel's block: the heads
    a pass takes, ``group``, the largest divisor of ``heads`` up to 32 whose
    scores fit a block's shared memory, and the position groups, ``groups``:
    as many as 128 threads allow, 4 * group * groups a multiple of 32 (a
    warp never straddles the block's end).  Thread (g, c) of the block takes
    piece c (16 dims) of the group's heads at positions t = g (mod groups)."""
    widest = min(heads, _Q8_THREADS // 4)
    for group in sorted((g for g in range(1, widest + 1) if heads % g == 0), reverse=True):
        step = 32 // math.gcd(4 * group, 32)  # groups in steps that keep whole warps
        groups = _Q8_THREADS // (4 * group) // step * step
        if groups and _q8_bytes(index, group, groups) <= _MAX_SMEM:
            return group, groups, _q8_bytes(index, group, groups)
    raise ValueError(f"lazy_attention_q8 kernel: index {index} does not fit a block's shared "
                     f"memory ({_q8_bytes(index, 1, _Q8_THREADS // 4)} > {_MAX_SMEM} bytes)")


def q8_walk(index: int, groups: int) -> list[list[int]]:
    """The positions each position group walks, in its order: group g takes
    t = (r * 4 + u) * groups + g for rounds r and batch slots u, four
    positions loaded before any is folded, every round of every group
    (the kernel's loops are uniform across the block) and t < index only."""
    rounds = -(-index // (_Q8_BATCH * groups))
    return [[t for r in range(rounds) for u in range(_Q8_BATCH)
             if (t := (r * _Q8_BATCH + u) * groups + g) < index] for g in range(groups)]


def resolve_mode(max_length: int, mode: str = "auto") -> str:
    """mic_tpu's lazy decode-attention mode: "0" (its XLA chain,
    nn/attention.py::lazy_attention_chain), "1" (the blocked kernel,
    ``fused_lazy_attention``), "2" (the kernel that writes the column
    itself, ``lazy_attention``).  The
    MIC_TPU_FUSED_LAZY_ATTN override wins, then ``mode``, then "auto",
    which is "2": mic_tpu's choice on its accelerator.  (Off the TPU
    mic_tpu's "auto" is "0"; the port runs mode "2" on the CPU too, whose
    plain version is the same math as that chain.)  ``max_length`` is
    unused, as in mic_tpu."""
    del max_length
    raw = override("MIC_TPU_FUSED_LAZY_ATTN")
    if raw is not None:
        return raw
    return "2" if mode == "auto" else mode


def supports(cache_k, beams: int, num_heads: int, head_dim: int) -> bool:
    """mic_tpu's shape guard for mode "1": at least two beams, H*Dh a
    multiple of 128, beams*T a multiple of 16, and an int8 cache with
    per-head (B*K, T, H) scales."""
    if beams < 2:
        return False
    if isinstance(cache_k, dict) and cache_k["s"].ndim != 3:
        return False
    kv = cache_k["q"] if isinstance(cache_k, dict) else cache_k
    t = kv.shape[1]
    return (num_heads * head_dim) % 128 == 0 and (beams * t) % 16 == 0


def check_mode(mode: str) -> None:
    """Raise on a MIC_TPU_FUSED_LAZY_ATTN value that is no mode.  Every mode
    runs: "2" and "1" on their kernels, "0" on mic_tpu's XLA chain
    (nn/attention.py::lazy_attention_chain), which mic_tpu also takes for
    mode "1" where ``supports`` rejects the shape
    (models/mbart_decoder.py::_decoder_step_lazy decides, before any
    launch)."""
    if mode not in ("0", "1", "2"):
        raise ValueError(f"unknown MIC_TPU_FUSED_LAZY_ATTN mode {mode!r}")


def build_ancestry_mask(ancestry: torch.Tensor, index: int) -> torch.Tensor:
    """(B, K, T) int32 ancestry and the write index -> the (B, J*T, K) int8
    mask every layer of the step shares: mask[b, j*T + t, k] == 1 iff query
    beam k's token at position t lives in row j and t < index (STRICT: the
    step's own K/V come in as separate rows)."""
    b, k, t = ancestry.shape
    live = torch.arange(t, device=ancestry.device) < index
    j = torch.arange(k, dtype=ancestry.dtype, device=ancestry.device)
    sel = (ancestry[:, None, :, :] == j[None, :, None, None]) & live
    return sel.permute(0, 1, 3, 2).reshape(b, k * t, k).to(torch.int8)


def attend_rows_plain(q, k_rows, v_rows, num_heads: int, live=None, k_scale=None,
                      v_scale=None, k_step=None, v_step=None) -> torch.Tensor:
    """mic_tpu's _attend_tiles, the plain version of the blocked lazy
    attention's kernel (csrc/lazy_attention.cu, namespace blocked) and of
    the cross-attention's (csrc/attend_rows.cuh): q and the step rows
    rounded to bfloat16; f32 scores of every cached row (times its K scale
    where given), dead ones finfo(float32).min, and each beam's step row
    where given; softmax as exp(s - max) / sum; cached weights times their
    V scales; every weight rounded to bfloat16; f32 sums, one bfloat16
    rounding of the output, then q's dtype.

    q (B, K, H*Dh); k_rows / v_rows (B, R, H, Dh); live (B, R, K) int8 or
    None (every row live); k_scale / v_scale (B, R, H) or None; k_step /
    v_step (B, K, H*Dh) or None -> (B, K, H*Dh)."""
    b, k, hd = q.shape
    dh = hd // num_heads
    r = k_rows.shape[1]
    bf = torch.bfloat16
    qf = q.to(bf).float().reshape(b, k, num_heads, dh)
    s = torch.einsum("bkhd,brhd->bhkr", qf, k_rows.float())
    if k_scale is not None:
        s = s * k_scale.permute(0, 2, 1)[:, :, None, :]
    if live is not None:
        s = torch.where((live != 0).permute(0, 2, 1)[:, None], s, _MASK_VALUE)
    if k_step is not None:
        ksf = k_step.to(bf).float().reshape(b, k, num_heads, dh)
        s = torch.cat([s, torch.einsum("bkhd,bkhd->bhk", qf, ksf)[..., None]], dim=-1)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = e / e.sum(dim=-1, keepdim=True)
    w_cache = w[..., :r]
    if v_scale is not None:
        w_cache = w_cache * v_scale.permute(0, 2, 1)[:, :, None, :]
    out = torch.einsum("bhkr,brhd->bkhd", w_cache.to(bf).float(), v_rows.float())
    if v_step is not None:
        vsf = v_step.to(bf).float().reshape(b, k, num_heads, dh)
        out = out + w[..., r].to(bf).float().permute(0, 2, 1)[..., None] * vsf
    return out.reshape(b, k, hd).to(bf).to(q.dtype)


def fused_lazy_attention_plain(q, cache_k, cache_v, k_step, v_step, amask, beams: int,
                               num_heads: int) -> torch.Tensor:
    """mic_tpu's blocked kernel: ``attend_rows_plain`` over every cached row
    of an image (the whole window, as the TPU kernel reads it), live where
    the mask says, with the per-head scales of the int8 cache, and each
    beam's step row.

    q, k_step, v_step (B, K, H*Dh); caches (B*K, T, H*Dh), or int8 dicts
    with (B*K, T, H) scales; amask (B, K*T, K) int8 -> (B, K, H*Dh)."""
    b, _, hd = q.shape
    dh = hd // num_heads
    quant = isinstance(cache_k, dict)

    def rows(cache):  # -> (B, J*T, H, Dh)
        return (cache["q"] if quant else cache).reshape(b, -1, num_heads, dh)

    def scales(cache):  # -> (B, J*T, H)
        return cache["s"].reshape(b, -1, num_heads) if quant else None

    return attend_rows_plain(q, rows(cache_k), rows(cache_v), num_heads, live=amask,
                             k_scale=scales(cache_k), v_scale=scales(cache_v),
                             k_step=k_step, v_step=v_step)


# csrc/lazy_attention.cu, namespace blocked: the warps of a block and the
# most rows a chunk stages (224: at K=4, index 63, every image's admitted
# rows in one chunk and three blocks an SM, four at small indices; at most
# the block's 256 threads); on a float32 cache, whose staged rows take
# 272 bytes, 96 (three blocks an SM at K=4, index 63)
_BLOCKED_WARPS = 8
_STAGE_ROWS = 224
_STAGE_ROWS_F32 = 96


def _stage_bytes(stage: int, q8: bool, f32: bool = False) -> int:
    """A chunk of ``stage`` staged head rows, 144 bytes each (272 on a
    float32 cache; and their f32 scales in int8)."""
    return stage * (272 if f32 else 144) + (_align16(4 * stage) if q8 else 0)


def blocked_layout(beams: int, positions: int, q8: bool = False,
                   f32: bool = False) -> tuple[bool, int, bool, int]:
    """-> (compact, stage, shared, shared bytes) of the blocked kernel's
    block, as csrc/lazy_attention.cu lays it out: the f32 scores, then
    weights, of every (beam, row) of the K * positions rows of an image (at
    least the eight warps' partial sums, which reuse them); where compact
    the list of the rows some beam admits, with the warps' counts (rows no
    beam admits are never read); on a float32 cache (``f32``) the beams' q
    rows in f32; and a chunk of ``stage`` K rows and one of V rows, copied
    in by cp.async at a 144-byte pitch (272 on a float32 cache; up to
    _STAGE_ROWS rows, _STAGE_ROWS_F32 on a float32 cache, fewer where shared
    memory is short), or where ``shared`` one chunk that K's and V's rows
    take in turn.  Compact where the list fits beside two chunks of
    min(rows, 32) rows; else the walk takes every row, the dead ones at
    weight 0."""
    rows = beams * positions
    weights = _align16(4 * max(beams * rows, _BLOCKED_WARPS * beams * 64))
    q_rows = _align16(4 * beams * 64) if f32 else 0
    want = max(1, min(_STAGE_ROWS_F32 if f32 else _STAGE_ROWS, rows))
    for compact, buffers in ((True, 2), (False, 2), (False, 1)):
        fixed = weights + (_align16(4 * (rows + _BLOCKED_WARPS)) if compact else 0) + q_rows
        stage = min(want, max(0, _MAX_SMEM - fixed) // (buffers * _stage_bytes(1, q8, f32)))
        while stage and fixed + buffers * _stage_bytes(stage, q8, f32) > _MAX_SMEM:
            stage -= 1
        if stage >= (min(want, 32) if compact else 1):
            return compact, stage, buffers == 1, fixed + buffers * _stage_bytes(stage, q8, f32)
    raise ValueError(f"fused_lazy_attention kernel: {beams} beams x {positions} positions do "
                     f"not fit a block's shared memory ({weights} > {_MAX_SMEM} bytes)")


def fused_lazy_attention(q, cache_k, cache_v, k_step, v_step, amask, beams: int,
                         num_heads: int, positions: int | None = None) -> torch.Tensor:
    """Mode "1" of one layer: -> (B, K, H*Dh); the caches are read, never
    written.  ``positions`` (the write index) bounds the positions the
    kernel walks: the strict mask admits none at or past it.  The plain
    version reads the whole window."""
    if q.device.type == "cpu":
        return fused_lazy_attention_plain(q, cache_k, cache_v, k_step, v_step, amask, beams,
                                          num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"fused_lazy_attention: unsupported device {q.device}")
    name = "fused_lazy_attention"
    b, k, hd = q.shape
    dh = hd // num_heads
    quant = isinstance(cache_k, dict)
    kq, vq = (cache_k["q"], cache_v["q"]) if quant else (cache_k, cache_v)
    t = kq.shape[1]
    positions = t if positions is None else positions
    if q.dtype not in (torch.bfloat16, torch.float32) or any(
            x.dtype != q.dtype for x in (k_step, v_step)):
        raise TypeError(f"{name} kernel: q and step rows must be all bfloat16 or all float32")
    if any(x.dtype != (torch.int8 if quant else q.dtype) for x in (kq, vq)):
        raise TypeError(f"{name} kernel: caches must be in q's dtype, or int8 dicts")
    if quant and any(c["s"].dtype != torch.float32 for c in (cache_k, cache_v)):
        raise TypeError(f"{name} kernel: int8 cache scales must be float32")
    if amask.dtype != torch.int8:
        raise TypeError(f"{name} kernel: the ancestry mask must be int8")
    if dh != 64 or hd != num_heads * dh or beams != k or not 1 <= k <= 8:
        raise ValueError(f"{name} kernel: head_dim 64 and 1-8 beams, got {hd}/{num_heads}, "
                         f"beams={beams}")
    if not 0 <= positions <= t:
        raise ValueError(f"{name} kernel: positions={positions}, T={t}")
    if (kq.shape != (b * k, t, hd) or vq.shape != kq.shape or k_step.shape != q.shape
            or v_step.shape != q.shape or amask.shape != (b, k * t, k)
            or (quant and any(c["s"].shape != (b * k, t, num_heads) for c in (cache_k, cache_v)))):
        raise ValueError(f"{name} kernel: inconsistent shapes")
    f32 = q.dtype == torch.float32
    compact, stage, shared, _ = blocked_layout(k, positions, quant, f32 and not quant)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if quant:
        tensors = (q, kq, cache_k["s"], vq, cache_v["s"], k_step, v_step, amask)
        _build.check_operands(name, tensors)
        entry = "mic_lazy_attention_blocked_q8_f32" if f32 else "mic_lazy_attention_blocked_q8"
    else:
        tensors = (q, kq, vq, k_step, v_step, amask)
        _build.check_operands(name, tensors)
        entry = "mic_lazy_attention_blocked_f32" if f32 else "mic_lazy_attention_blocked_bf16"
    err = getattr(_build.lib(), entry)(
        *(x.data_ptr() for x in tensors), out.data_ptr(), b, k, t, positions, num_heads, dh,
        int(compact), stage, int(shared), stream,
    )
    _build.check(err, entry)
    fused_lazy_attention.launches += 1
    return out


fused_lazy_attention.launches = 0  # every cache form's and dtype's launches
