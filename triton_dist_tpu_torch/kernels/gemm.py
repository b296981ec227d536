"""The GEMM kernel behind the world-size-1 forms of ag_gemm and gemm_rs.

`gemm(a, b)` launches the hand-written CUDA kernel (csrc/gemm.cu) for
CUDA tensors and takes the plain PyTorch version, `gemm_ref`, only for
CPU tensors. Each launch counts as `gemm` in the launch counts, whether
ag_gemm (kernels/allgather_gemm.py) or gemm_rs
(kernels/gemm_reduce_scatter.py) made it.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels import _build


def gemm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] as an f32 product rounded once to a's dtype
    (the TPU kernels' f32 accumulation)."""
    return (a.float() @ b.float()).to(a.dtype)


def _unit_stride(t: torch.Tensor) -> bool:
    """One of the two dims has stride 1 and the other a 16-byte multiple."""
    rows, cols = t.stride()
    lead = rows if cols == 1 else cols if rows == 1 else None
    return lead is not None and lead * t.element_size() % 16 == 0


def gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] -> [M, N] contiguous in a's dtype, f32
    accumulation. bf16 or f32; each operand row- or column-major (a
    transposed view is taken as it is). bf16 on the card also needs K and
    N to be multiples of 8 (M too for a column-major a), and each
    operand's leading stride a 16-byte multiple."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm: want a [M, K] and b [K, N], got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"gemm: a {a.dtype}, b {b.dtype}: want bf16 or f32 alike")
    if a.device != b.device:
        raise ValueError(f"gemm: a on {a.device}, b on {b.device}")
    if a.device.type == "cpu":
        return gemm_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"gemm: unsupported device {a.device}")
    (M, K), N = a.shape, b.shape[1]
    if a.dtype == torch.bfloat16 and (
            K % 8 or N % 8 or not _unit_stride(a) or not _unit_stride(b)
            or (a.stride(1) != 1 and M % 8) or a.data_ptr() % 16 or b.data_ptr() % 16):
        raise ValueError(
            f"gemm: bf16 takes K={K} and N={N} in multiples of 8 and row- or column-major "
            f"operands with 16-byte aligned lines (a strides {a.stride()}, b strides "
            f"{b.stride()})")
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(a.device):
        _build.ext().gemm(_build.DTYPE_CODES[a.dtype], a.data_ptr(), a.stride(0), a.stride(1),
                          b.data_ptr(), b.stride(0), b.stride(1), out.data_ptr(), M, N, K,
                          _build.stream_ptr(a.device))
    _build.count("gemm")
    return out
