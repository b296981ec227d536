"""Shared layer math: RMSNorm, RoPE, weight packing.

Counterpart of triton_dist_tpu/layers/common.py (`rms_norm`,
`precompute_rope`, `apply_rope`, `apply_rope_slots`,
`shard_cols_packed`).
"""

from __future__ import annotations

import numpy as np
import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6):
    """RMSNorm computed in f32; the result keeps x's dtype even for an
    f32 weight."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def precompute_rope(head_dim: int, max_seq: int, theta: float = 1e6,
                    device=None):
    """cos/sin tables [max_seq, head_dim//2] in f32 (Qwen3: theta=1e6),
    computed in float64 with numpy as the JAX package does."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    freqs = np.outer(np.arange(max_seq), inv)
    return (torch.from_numpy(np.cos(freqs).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(freqs).astype(np.float32)).to(device))


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor):
    """Rotate half-split pairs in f32: x [..., S, H, D]; cos/sin
    [max_seq, D/2]; positions [S]. Returns x's dtype."""
    c = cos[positions][:, None, :]
    s = sin[positions][:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def apply_rope_slots(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                     pos: torch.Tensor):
    """Per-slot RoPE: x [B, S, H, D]; pos [B] — row b rotates at
    positions pos[b] .. pos[b]+S-1 (the continuous-batching tick, where
    every row is a different request). A position past the tables (a
    verify window's padding near the end of a slot) takes the last row,
    as the JAX gather clamps. Returns x's dtype."""
    p = pos[:, None] + torch.arange(x.shape[1], device=pos.device)   # [B, S]
    p = p.clamp(max=cos.shape[0] - 1)
    c = cos[p][:, :, None, :]
    s = sin[p][:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def shard_cols_packed(mats, n: int) -> torch.Tensor:
    """Pack column-parallel weights into n per-rank blocks, each the
    concat of every input's rank slice: [m0_r | m1_r | ...] for rank r."""
    blocks = []
    for r in range(n):
        for m in mats:
            cols = m.shape[1] // n
            blocks.append(m[:, r * cols:(r + 1) * cols])
    return torch.cat(blocks, dim=1)


# ---------------------------------------------------------------- sharding
# Weights here are tensors or int8 QuantW (kernels/quant.py): a column
# slice takes its scales along, a row slice keeps them whole (per-column
# scales reduce over every row, so the row shards of a quantized weight
# share the global scales, as the JAX package shards them).

def _cols(w, lo: int, hi: int):
    from triton_dist_tpu_torch.kernels.quant import QuantW
    if isinstance(w, QuantW):
        return QuantW(q=w.q[:, lo:hi], s=w.s[lo:hi])
    return w[:, lo:hi]


def _cat_cols(ws):
    from triton_dist_tpu_torch.kernels.quant import QuantW
    if isinstance(ws[0], QuantW):
        return QuantW(q=torch.cat([w.q for w in ws], dim=1), s=torch.cat([w.s for w in ws]))
    return torch.cat(ws, dim=1)


def weight_to(w, device):
    """A weight (tensor or QuantW) on `device`, contiguous."""
    from triton_dist_tpu_torch.kernels.quant import QuantW
    if isinstance(w, QuantW):
        return QuantW(q=w.q.to(device).contiguous(), s=w.s.to(device).contiguous())
    return w.to(device).contiguous()


def split_packed(w, widths, n: int) -> list:
    """The n per-rank blocks of a column-packed weight [m0 | m1 | ...]
    (widths: each part's columns): rank r's block is [m0_r | m1_r | ...],
    shard_cols_packed's layout, cut from the one-rank packing."""
    offs = np.cumsum([0] + list(widths))
    out = []
    for r in range(n):
        out.append(_cat_cols([_cols(w, int(o) + r * wd // n, int(o) + (r + 1) * wd // n)
                              for o, wd in zip(offs[:-1], widths)]))
    return out


def unpack_cols_packed(w, widths, n: int):
    """The inverse of shard_cols_packed over n ranks: a weight packed as n
    blocks [m0_r | m1_r | ...] back to the one-rank packing [m0 | m1 |
    ...] (widths: each part's whole width)."""
    blk = sum(widths) // n
    parts = []
    for j, wd in enumerate(widths):
        off = sum(widths[:j]) // n
        parts += [_cols(w, r * blk + off, r * blk + off + wd // n) for r in range(n)]
    return _cat_cols(parts)


def split_rows(w, n: int) -> list:
    """The n row shards of a row-parallel weight (QuantW scales whole)."""
    from triton_dist_tpu_torch.kernels.quant import QuantW
    rows = (w.q if isinstance(w, QuantW) else w).shape[0] // n
    if isinstance(w, QuantW):
        return [QuantW(q=w.q[r * rows:(r + 1) * rows], s=w.s) for r in range(n)]
    return [w[r * rows:(r + 1) * rows] for r in range(n)]
