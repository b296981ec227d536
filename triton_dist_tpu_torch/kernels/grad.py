"""Differentiable ag_gemm and gemm_rs at world size 1: training through
the GEMM kernel.

Counterpart of triton_dist_tpu/kernels/grad.py (`ag_gemm_grad`,
`gemm_rs_grad`). Each op is a torch.autograd.Function whose backward
closes over the two ops, as the JAX custom VJPs do:

    y = ag_gemm(a, b)    da = gemm_rs(dy, b^T)    db = ag^T @ dy
    y = gemm_rs(a, b)    da = ag_gemm(dy, b^T)    db = a^T @ dy

b^T is a view (the GEMM kernel takes either major order), and each db is
a plain torch.matmul, as the JAX package computes it outside any kernel.
`gemm_ar_grad`, `grouped_gemm_grad`, the all-to-all VJPs and the two
ops over more than one rank (the rings of csrc/ag_gemm.cu and gemm_rs.cu
under autograd) are not ported yet.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels.allgather_gemm import ag_gemm
from triton_dist_tpu_torch.kernels.gemm_reduce_scatter import gemm_rs


def _one_rank(op: str, world_size: int) -> None:
    """The training ops run at one rank; their multi-rank forms (the
    rings under autograd) are not ported."""
    if world_size != 1:
        raise NotImplementedError(f"{op} over {world_size} ranks (multi-rank training): "
                                  "not yet ported")


class _AgGemm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        y, ag = ag_gemm(a, b, return_ag=True)
        ctx.save_for_backward(ag, b)
        return y

    @staticmethod
    def backward(ctx, dy):
        ag, b = ctx.saved_tensors
        dy = dy.contiguous()
        da = gemm_rs(dy, b.T) if ctx.needs_input_grad[0] else None
        db = ag.T @ dy if ctx.needs_input_grad[1] else None
        return da, db


class _GemmRs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return gemm_rs(a, b)

    @staticmethod
    def backward(ctx, dy):
        a, b = ctx.saved_tensors
        dy = dy.contiguous()
        da = ag_gemm(dy, b.T) if ctx.needs_input_grad[0] else None
        db = a.T @ dy if ctx.needs_input_grad[1] else None
        return da, db


def ag_gemm_grad(world_size: int = 1):
    """Differentiable ag_gemm: op(a [M, K], b [K, N]) -> [M, N]."""
    _one_rank("ag_gemm_grad", world_size)
    return _AgGemm.apply


def gemm_rs_grad(world_size: int = 1):
    """Differentiable gemm_rs: op(a [M, K], b [K, N]) -> [M, N]."""
    _one_rank("gemm_rs_grad", world_size)
    return _GemmRs.apply
