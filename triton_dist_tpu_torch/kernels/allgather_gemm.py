"""AllGather-GEMM at world size 1.

Counterpart of triton_dist_tpu/kernels/allgather_gemm.py (`ag_gemm`):
C = allgather(A) @ B. With one rank the gather is the identity and the
kernel's body is the whole product, which the GEMM kernel computes
(kernels/gemm.py, csrc/gemm.cu). The ring over several ranks (row 14 of
the port's kernel table) is not ported: asking for more than one rank
raises.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels.gemm import gemm, gemm_ref
from triton_dist_tpu_torch.kernels.quant import QuantW


def check_world_size(op: str, world_size: int, b) -> None:
    """Raise for what the world-size-1 forms of ag_gemm and gemm_rs do not
    take: more than one rank, or int8 weights."""
    if world_size != 1:
        raise NotImplementedError(f"{op} over {world_size} ranks (the ring form): not yet "
                                  "ported")
    if isinstance(b, QuantW):
        raise NotImplementedError(f"{op} with int8 weights: not yet ported")


def ag_gemm_ref(a: torch.Tensor, b: torch.Tensor, *, return_ag: bool = False):
    """Plain version of ag_gemm at world size 1."""
    y = gemm_ref(a, b)
    return (y, a) if return_ag else y


def ag_gemm(a: torch.Tensor, b: torch.Tensor, *, world_size: int = 1,
            return_ag: bool = False):
    """C = allgather(A) @ B: a [M, K] (row-sharded; whole at one rank), b
    [K, N] (column-sharded; whole at one rank) -> [M, N] in a's dtype.
    With return_ag also returns the gathered A, as the JAX op does for the
    backward, which here is a itself."""
    check_world_size("ag_gemm", world_size, b)
    y = gemm(a, b)
    return (y, a) if return_ag else y
