"""The GEMM kernel behind the world-size-1 forms of ag_gemm and gemm_rs.

`gemm(a, b)` launches the hand-written CUDA kernel (csrc/gemm.cu) for
CUDA tensors and takes the plain PyTorch version, `gemm_ref`, only for
CPU tensors. b is a tensor or an int8 QuantW panel (widened to a's dtype
for the product, its per-column scale applied after it). Each launch
counts as `gemm` in the launch counts, whether ag_gemm
(kernels/allgather_gemm.py) or gemm_rs (kernels/gemm_reduce_scatter.py)
made it.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels.quant import QuantW


def gemm_ref(a: torch.Tensor, b) -> torch.Tensor:
    """a [M, K] @ b [K, N] as an f32 product rounded once to a's dtype
    (the TPU kernels' f32 accumulation); a QuantW b is widened to a's
    dtype and its scale applied per column before the rounding."""
    if isinstance(b, QuantW):
        return (a.float() @ b.q.to(a.dtype).float() * b.s.float()).to(a.dtype)
    return (a.float() @ b.float()).to(a.dtype)


def _unit_stride(t: torch.Tensor) -> bool:
    """One of the two dims has stride 1 and the other a 16-byte multiple."""
    rows, cols = t.stride()
    lead = rows if cols == 1 else cols if rows == 1 else None
    return lead is not None and lead * t.element_size() % 16 == 0


def gemm(a: torch.Tensor, b) -> torch.Tensor:
    """a [M, K] @ b [K, N] -> [M, N] contiguous in a's dtype, f32
    accumulation. bf16 or f32; each operand row- or column-major (a
    transposed view is taken as it is); b may be a QuantW (its int8 panel
    row-major under a bf16 a). bf16 on the card also needs K and N to be
    multiples of 8 (M too for a column-major a), and each operand's
    leading stride a 16-byte multiple."""
    quant = isinstance(b, QuantW)
    bq = b.q if quant else b
    if a.dim() != 2 or bq.dim() != 2 or a.shape[1] != bq.shape[0]:
        raise ValueError(f"gemm: want a [M, K] and b [K, N], got {tuple(a.shape)} and "
                         f"{tuple(bq.shape)}")
    want_b = torch.int8 if quant else a.dtype
    if a.dtype not in (torch.bfloat16, torch.float32) or bq.dtype != want_b:
        raise ValueError(f"gemm: a {a.dtype}, b {bq.dtype}: want bf16 or f32 alike, or an "
                         "int8 QuantW b")
    if a.device != bq.device:
        raise ValueError(f"gemm: a on {a.device}, b on {bq.device}")
    if a.device.type == "cpu":
        return gemm_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"gemm: unsupported device {a.device}")
    (M, K), N = a.shape, bq.shape[1]
    # an int8 panel is read 8 bytes at a time along its rows
    b_ok = (bq.stride(1) == 1 and bq.stride(0) % 8 == 0 and bq.data_ptr() % 8 == 0 if quant
            else _unit_stride(bq) and bq.data_ptr() % 16 == 0)
    if a.dtype == torch.bfloat16 and (
            K % 8 or N % 8 or not _unit_stride(a) or not b_ok
            or (a.stride(1) != 1 and M % 8) or a.data_ptr() % 16):
        raise ValueError(
            f"gemm: bf16 takes K={K} and N={N} in multiples of 8 and row- or column-major "
            f"operands with 16-byte aligned lines, an int8 b row-major with 8-byte aligned "
            f"rows (a strides {a.stride()}, b strides {bq.stride()})")
    scale = 0
    if quant:
        if (b.s.dtype != torch.float32 or tuple(b.s.shape) != (N,) or b.s.device != a.device
                or not b.s.is_contiguous()):
            raise ValueError(f"gemm: the QuantW scale must be [{N}] f32 on {a.device}")
        scale = b.s.data_ptr()
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(a.device):
        _build.ext().gemm(_build.DTYPE_CODES[a.dtype], _build.DTYPE_CODES[bq.dtype],
                          a.data_ptr(), a.stride(0), a.stride(1), bq.data_ptr(), bq.stride(0),
                          bq.stride(1), scale, out.data_ptr(), M, N, K,
                          _build.stream_ptr(a.device))
    _build.count("gemm")
    return out
