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

w may be a strided view of a larger panel, or a pair of such views taken
as the column blocks of one panel: a tensor-parallel rank's panels are
views of the one-rank model's (layers/tp_moe.py), its [gate_r | up_r] two
column blocks of the [gate | up] panel and its w_down rows a slice along
the rows, and the kernel reads them where they lie.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels import _build


def column_blocks(w) -> tuple:
    """w's column blocks: (w,) for a tensor, the pair itself for a pair."""
    return tuple(w) if isinstance(w, (tuple, list)) else (w,)


def grouped_gemm_ref(x: torch.Tensor, w) -> torch.Tensor:
    """x [E, C, D] @ w [E, D, F] (or its column blocks, side by side) ->
    [E, C, F]: torch.bmm in f32, rounded once to x's dtype (the JAX
    reference's f32 accumulation)."""
    blocks = column_blocks(w)
    wf = blocks[0].float() if len(blocks) == 1 else torch.cat([b.float() for b in blocks], 2)
    return torch.bmm(x.float(), wf).to(x.dtype)


def grouped_gemm(x: torch.Tensor, w) -> torch.Tensor:
    """Grouped GEMM x [E, C, D] @ w [E, D, F] -> [E, C, F] in x's dtype; w
    a tensor or a pair of column blocks [E, D, F0] and [E, D, F - F0] with
    equal strides. On the card both are bf16; x's rows are contiguous (any
    expert stride); w has unit column stride, its row and expert strides
    and widths are multiples of 8 and its blocks lie at 16-byte aligned
    addresses; D is a multiple of 32."""
    if x.device.type == "cpu":
        return grouped_gemm_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_gemm: unsupported device {x.device}")
    blocks = column_blocks(w)
    w0 = blocks[0]
    if len(blocks) > 2 or any(b.shape[:2] != w0.shape[:2] or b.stride() != w0.stride()
                              or b.dtype != w0.dtype or b.device != w0.device
                              for b in blocks):
        raise ValueError("grouped_gemm: w is a tensor or two column blocks of equal shape "
                         f"[E, D, .] and strides, got {[tuple(b.shape) for b in blocks]} "
                         f"strides {[b.stride() for b in blocks]}")
    F = sum(b.shape[2] for b in blocks)
    if x.dim() != 3 or w0.dim() != 3 or w0.shape[0] != x.shape[0] or w0.shape[1] != x.shape[2]:
        raise ValueError(f"grouped_gemm: want x [E, C, D] and w [E, D, F], got "
                         f"{tuple(x.shape)} and {[tuple(b.shape) for b in blocks]}")
    if x.dtype != torch.bfloat16 or w0.dtype != torch.bfloat16:
        raise ValueError(f"grouped_gemm: the kernel takes bf16, got {x.dtype} and {w0.dtype}")
    if w0.device != x.device:
        raise ValueError(f"grouped_gemm: x on {x.device}, w on {w0.device}")
    E, C, D = x.shape
    w_es, w_ld = w0.stride(0), w0.stride(1)
    if D % 32 or any(b.shape[2] % 8 for b in blocks):
        raise ValueError(f"grouped_gemm: D={D} must be a multiple of 32 and the widths "
                         f"{[b.shape[2] for b in blocks]} of 8")
    if (x.stride(2) != 1 or (C > 1 and x.stride(1) != D) or x.stride(0) % 8
            or x.data_ptr() % 16 or w0.stride(2) != 1 or w_es % 8 or w_ld % 8
            or any(b.data_ptr() % 16 for b in blocks)):
        raise ValueError(
            "grouped_gemm: x needs contiguous rows and a 16-byte aligned expert stride, w a "
            "unit column stride, row and expert strides of whole 16-byte vectors and 16-byte "
            f"aligned blocks (x strides {x.stride()}, w strides {w0.stride()})")
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    w1 = blocks[1].data_ptr() if len(blocks) == 2 else 0
    with torch.cuda.device(x.device):
        _build.ext().grouped_gemm(x.data_ptr(), x.stride(0), w0.data_ptr(), w1, w_es, w_ld,
                                  w0.shape[2], out.data_ptr(), E, C, D, F,
                                  _build.stream_ptr(x.device))
    _build.count("grouped_gemm")
    return out
