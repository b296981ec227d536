"""Weight-only int8 storage and the per-position int8 KV quantizer.

Counterpart of triton_dist_tpu/kernels/quant.py. Weights are quantized
per output column (reducing over the contraction axis) and the KV cache
per position (reducing over head_dim); both use `s = max|x| / 127`,
floored at 1e-8, and round half to even, so the int8 values equal the
JAX package's bitwise on the same f32 input.

`qmm` is a plain product outside any kernel: the int8 weight is widened
to the activation dtype and multiplied with f32 accumulation, and the
per-column scale is applied after the product (exact for per-column
scales). A fused int8-weight GEMM is later work.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch


@dataclasses.dataclass
class QuantW:
    """int8 weight + per-output-column f32 scale."""
    q: torch.Tensor   # [K, N] int8
    s: torch.Tensor   # [N] f32


Weight = Union[torch.Tensor, QuantW]


def quantize_int8(w: Weight) -> QuantW:
    """Per-output-channel symmetric int8 quantization: [K, N] -> s [N]
    (or [E, K, N] -> s [E, N]); the reduction runs over the contraction
    axis."""
    if isinstance(w, QuantW):
        return w
    wf = w.float()
    axis = wf.dim() - 2
    s = torch.clamp_min(wf.abs().amax(dim=axis), 1e-8) / 127.0
    q = torch.round(wf / s.unsqueeze(axis)).to(torch.int8)
    return QuantW(q=q, s=s)


def quantize_int8_rows(ws) -> list:
    """quantize_int8 of the weight whose row shards (the contraction axis
    split over ranks) are ws, one per rank on its device: every shard
    takes the whole weight's per-column scale (the largest |x| over all
    rows), so the int8 values equal those of the unsplit weight."""
    if isinstance(ws[0], QuantW):
        return list(ws)
    dev = ws[0].device
    amax = torch.stack([w.float().abs().amax(dim=0).to(dev) for w in ws]).amax(dim=0)
    s = torch.clamp_min(amax, 1e-8) / 127.0
    out = []
    for w in ws:
        sw = s.to(w.device)
        out.append(QuantW(q=torch.round(w.float() / sw).to(torch.int8), s=sw))
    return out


def quantize_kv_int8(x: torch.Tensor):
    """Per-position symmetric int8 KV quantization over the trailing
    head_dim axis: x [..., d] -> (q int8 [..., d], s f32 [...])."""
    xf = x.float()
    s = torch.clamp_min(xf.abs().amax(dim=-1), 1e-8) / 127.0
    return torch.round(xf / s.unsqueeze(-1)).to(torch.int8), s


def dequantize_kv_int8(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Inverse map of quantize_kv_int8's storage: int8 [..., d] with
    per-position scales [...] -> f32."""
    return q.float() * s.float().unsqueeze(-1)


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with an f32 result and f32 accumulation, without widening
    the weight to f32 on the card: a [D, V] head in f32 would be written
    and read again on every decode step."""
    if x.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        return torch.mm(x, w, out_dtype=torch.float32)
    return x.float() @ w.float()


def qmm(x: torch.Tensor, w: Weight,
        out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [M, K] @ w for a plain weight or a QuantW (scale applied after
    the product). The result has x's dtype unless out_dtype is given
    (the f32 logits of the lm_head)."""
    if isinstance(w, QuantW):
        y = _mm_f32(x, w.q.to(x.dtype)) * w.s
        return y.to(out_dtype or x.dtype)
    if out_dtype is None:
        return x @ w
    return _mm_f32(x, w).to(out_dtype)
