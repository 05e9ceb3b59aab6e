"""Int8 weight-only quantization for the decode path (mic_tpu/ops/quant.py).

Format, as in the JAX package: a dense {"kernel": (in, out)} becomes
{"kernel_q": int8 (in, out), "kernel_scale": f32 (out,)}, a stacked
(L, in, out) kernel keeps its L axis with scales (L, out), and the shared
embedding {"embedding": (V, D)} becomes {"embedding_q": int8 (V, D),
"embedding_scale": f32 (V,)}.  Every rounding is half-to-even
(``torch.round``, as ``jnp.round``), so a tree quantized here is bit-equal
to one quantized by mic_tpu from the same weights.

The int8 x int8 products run in ``torch._int_mm`` (exact int32), outside
any kernel of this package, where mic_tpu leaves them to XLA.  Its CUDA
route (cuBLASLt) is fast only with the weight column-major: on an H100 a
row-major (1024, 3072) int8 weight took 3-9x longer than the same weight
column-major, and longer than the bf16 product.  So the quantized kernels
keep mic_tpu's (..., in, out) shape and values, but each (in, out) matrix
is laid out column-major (out-major) in memory.
"""

from __future__ import annotations

import torch

from mic_tpu_torch.core.params import Params


def quantize_array(w: torch.Tensor, axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8: -> (int8 values, f32 scales along axis).
    The scale is amax / 127.0 (a division, unlike quantize_rows_dynamic)."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    # a tensor divisor: CUDA torch turns division by a Python scalar into a
    # multiplication by its reciprocal, which rounds differently
    scale = torch.clamp(amax, min=1e-8) / torch.tensor(127.0, device=amax.device)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(axis)


def quantize_params_for_decode(params: Params, subtrees: tuple = ("decoder", "shared")) -> Params:
    """Quantize the dense kernels and the shared embedding of the decode
    subtrees.  Vision, ``proj``, LayerNorms, biases and position embeddings
    are left as they are."""

    def rec(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for name, child in node.items():
            kernel = child.get("kernel") if isinstance(child, dict) else None
            if kernel is not None and kernel.ndim in (2, 3):
                # stacked (L, in, out): scales per (L, out); 2-D: per out
                q, s = quantize_array(kernel, axis=kernel.ndim - 2)
                q = q.transpose(-1, -2).contiguous().transpose(-1, -2)  # column-major
                new = {"kernel_q": q, "kernel_scale": s}
                if "bias" in child:
                    new["bias"] = child["bias"]
                out[name] = new
            elif name == "shared" and isinstance(child, dict) and "embedding" in child:
                q, s = quantize_array(child["embedding"], axis=1)
                out[name] = {"embedding_q": q, "embedding_scale": s}
            else:
                out[name] = rec(child)
        return out

    out = dict(params)
    for key in subtrees:
        if key == "shared" and "shared" in params:
            out["shared"] = rec({"shared": params["shared"]})["shared"]
        elif key in params:
            out[key] = rec(params[key])
    return out


def quantize_rows_dynamic(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 activation quantization -> (int8 values,
    f32 scales (..., 1)).  The scale is amax * (1.0 / 127.0), a
    multiplication, as in mic_tpu."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) * (1.0 / 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 (M, K) x int8 (K, N) -> int32 (M, N) through
    ``torch._int_mm``.  On CUDA its cuBLASLt route takes M > 16 and K, N
    multiples of 8, so the operands are zero-padded to that there (zeros
    add nothing to an integer sum) and the result cut back; ``a`` goes in
    row-major and ``b`` column-major, copied only where it is not already
    so (the quantized kernels are stored that way)."""
    m, k = a.shape
    n = b.shape[1]
    if a.device.type != "cuda":
        return torch._int_mm(a, b)
    mp, kp, np_ = max(_round_up(m, 8), 24), _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k) or not a.is_contiguous():
        a = torch.nn.functional.pad(a, (0, kp - k, 0, mp - m)).contiguous()
    bt = b.t()
    if (kp, np_) != (k, n) or not bt.is_contiguous():
        bt = torch.nn.functional.pad(bt, (0, kp - k, 0, np_ - n)).contiguous()
    return torch._int_mm(a, bt.t())[:m, :n]


def int8_dense(params: Params, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x (..., in) @ int8 kernel (in, out) as an int8 x int8 product on the
    row-quantized activation (mic_tpu's int8_dense_native):
    acc * xs * kernel_scale in f32, cast to ``dtype``, then + bias."""
    xq, xs = quantize_rows_dynamic(x)
    lead = x.shape[:-1]
    acc = int8_matmul(xq.reshape(-1, x.shape[-1]), params["kernel_q"])
    acc = acc.reshape(*lead, acc.shape[-1])
    y = (acc.float() * xs * params["kernel_scale"]).to(dtype)
    if "bias" in params:
        y = y + params["bias"].to(dtype)
    return y


def dequant_dense(params: Params, dtype: torch.dtype) -> torch.Tensor:
    """The (..., in, out) kernel of a quantized dense in ``dtype`` (values
    and scales each cast to ``dtype`` first, as in mic_tpu)."""
    return params["kernel_q"].to(dtype) * params["kernel_scale"].to(dtype)[..., None, :]


def dequant_embedding(params: Params, dtype: torch.dtype) -> torch.Tensor:
    return params["embedding_q"].to(dtype) * params["embedding_scale"].to(dtype)[:, None]
