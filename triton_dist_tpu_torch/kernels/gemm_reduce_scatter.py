"""GEMM-ReduceScatter at world size 1.

Counterpart of triton_dist_tpu/kernels/gemm_reduce_scatter.py
(`gemm_rs`): C = reduce_scatter(A @ B). With one rank the reduction and
the scatter are the identity and the kernel's body is the whole product,
which the GEMM kernel computes (kernels/gemm.py, csrc/gemm.cu). The ring
over several ranks (row 15 of the port's kernel table) is not ported:
asking for more than one rank raises.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels.allgather_gemm import check_world_size
from triton_dist_tpu_torch.kernels.gemm import gemm, gemm_ref


def gemm_rs_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of gemm_rs at world size 1."""
    return gemm_ref(a, b)


def gemm_rs(a: torch.Tensor, b: torch.Tensor, *, world_size: int = 1) -> torch.Tensor:
    """C = reduce_scatter(A @ B): a [M, K] (column-sharded; whole at one
    rank), b [K, N] (row-sharded; whole at one rank) -> [M, N] in a's
    dtype (row-sharded; whole at one rank)."""
    check_world_size("gemm_rs", world_size, b)
    return gemm(a, b)
