"""Fused SwiGLU activation over a packed [gate | up] matrix.

Counterpart of triton_dist_tpu/kernels/swiglu.py. `swiglu` launches the
hand-written CUDA kernel (csrc/swiglu.cu) for a CUDA tensor and takes
the plain PyTorch version, `swiglu_ref`, only for a CPU tensor.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels import _build


def swiglu_ref(x2: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up for x2 = [..., 2I] packed [gate | up], rounded as
    the kernel rounds: the sigmoid in f32 rounded to x2's dtype, then
    g * sigmoid(g) and that times up, each rounded to x2's dtype."""
    g, u = x2.chunk(2, dim=-1)
    sig = torch.sigmoid(g.float()).to(g.dtype)
    return (g * sig) * u


def swiglu(x2: torch.Tensor) -> torch.Tensor:
    """SwiGLU over a 2-D [M, 2I] input packed [gate | up] -> [M, I]."""
    if x2.device.type == "cpu":
        return swiglu_ref(x2)
    if x2.device.type != "cuda":
        raise ValueError(f"swiglu: unsupported device {x2.device}")
    if x2.dim() != 2 or x2.shape[1] % 2:
        raise ValueError(f"swiglu: want [M, 2I], got {tuple(x2.shape)}")
    if x2.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"swiglu: dtype {x2.dtype} is not bf16 or f32")
    M, I = x2.shape[0], x2.shape[1] // 2
    size = x2.element_size()
    if (x2.stride(1) != 1 or (I * size) % 16 or (x2.stride(0) * size) % 16
            or x2.data_ptr() % 16):
        raise ValueError(
            "swiglu: columns must be contiguous and every row and the gate/up "
            f"halves 16-byte aligned (shape {tuple(x2.shape)}, strides "
            f"{x2.stride()})")
    out = torch.empty((M, I), dtype=x2.dtype, device=x2.device)
    with torch.cuda.device(x2.device):
        _build.ext().swiglu(_build.DTYPE_CODES[x2.dtype], x2.data_ptr(), out.data_ptr(),
                            M, I, x2.stride(0), _build.stream_ptr(x2.device))
    _build.count("swiglu")
    return out
