"""Grouped GEMM: the per-expert products of the MoE layers.

Counterpart of triton_dist_tpu/kernels/group_gemm.py. Tokens arrive
pre-grouped into capacity-padded per-expert batches x [E, C, D]
(kernels/ep_a2a.py `group_tokens_by_expert`); each expert's batch is
multiplied by its own weights w [E, D, F]. Padding rows are computed and
masked by the caller, as on the TPU. `grouped_gemm` launches the
hand-written CUDA kernel (csrc/grouped_gemm.cu) for CUDA tensors and
takes the plain PyTorch version, `grouped_gemm_ref`, only for CPU
tensors. The JAX `block_c`/`block_f` tile arguments and their tuned
lookup are Pallas tiling knobs with no counterpart here: the kernel
picks its own tiles from C.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels import _build


def grouped_gemm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [E, C, D] @ w [E, D, F] -> [E, C, F]: torch.bmm in f32, rounded
    once to x's dtype (the JAX reference's f32 accumulation)."""
    return torch.bmm(x.float(), w.float()).to(x.dtype)


def grouped_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grouped GEMM x [E, C, D] @ w [E, D, F] -> [E, C, F] in x's dtype.
    On the card both are bf16; x's rows are contiguous (any expert
    stride), w is contiguous, D is a multiple of 32 and F of 8."""
    if x.device.type == "cpu":
        return grouped_gemm_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_gemm: unsupported device {x.device}")
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] or w.shape[1] != x.shape[2]:
        raise ValueError(f"grouped_gemm: want x [E, C, D] and w [E, D, F], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"grouped_gemm: the kernel takes bf16, got {x.dtype} and {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"grouped_gemm: x on {x.device}, w on {w.device}")
    E, C, D = x.shape
    F = w.shape[2]
    if D % 32 or F % 8:
        raise ValueError(f"grouped_gemm: D={D} must be a multiple of 32 and F={F} of 8")
    if (x.stride(2) != 1 or (C > 1 and x.stride(1) != D) or x.stride(0) % 8
            or not w.is_contiguous() or x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError(
            "grouped_gemm: x needs contiguous rows and a 16-byte aligned expert stride, "
            f"w contiguous (x strides {x.stride()}, w strides {w.stride()})")
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        _build.ext().grouped_gemm(x.data_ptr(), x.stride(0), w.data_ptr(), out.data_ptr(),
                                  E, C, D, F, _build.stream_ptr(x.device))
    _build.count("grouped_gemm")
    return out
