"""gemm_allreduce: counterpart of triton_dist_tpu/kernels/gemm_allreduce.py
(`gemm_allreduce`; the TPU kernel `_gemm_ar_kernel` of `_gemm_ar_call`).

C = sum over ranks of A_r @ B_r, replicated: the small-batch TP decode
epilogue of the "gemm_ar" backend in one kernel (csrc/gemm_allreduce.cu).
A_r [M, k_loc] is rank r's K-shard of the activations, B_r [k_loc, N] its
row shard of the weight, a tensor or an int8 QuantW (widened to A's dtype
for the product, its per-column scale applied after it). Each rank's
partial is rounded to A's dtype, then the n partials are summed in rank
order in f32 and rounded once; `gemm_allreduce_ref` does the same, so the
kernel differs from it only by its product's summation order.

The JAX function takes a `GemmARContext`; this one takes the mesh, the
only part of that context it needs: the context's block_n (the Pallas
tile width, tuned per shape) has no counterpart, since the CUDA kernel's
tile is fixed (gemm_tile.cuh).
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels import _comm
from triton_dist_tpu_torch.kernels._build import DTYPE_CODES
from triton_dist_tpu_torch.kernels.gemm import gemm_ref
from triton_dist_tpu_torch.kernels.quant import QuantW
from triton_dist_tpu_torch.kernels.reduce_scatter import ordered_sum
from triton_dist_tpu_torch.runtime.symm_mem import create_symm_buffer


def gemm_allreduce_ref(a, b) -> list:
    """Plain version: the partials rounded to A's dtype (gemm_ref), summed
    in rank order in f32 on rank 0's device; each rank's copy on its
    device."""
    out = ordered_sum([gemm_ref(x, w) for x, w in zip(a, b)], list(range(len(a))), False)
    return [out.to(x.device) for x in a]


def gemm_allreduce(a, b, *, mesh) -> list:
    """C = allreduce(A @ B): a and b lists with one [M, k_loc] and one
    [k_loc, N] (tensor or QuantW) per rank; returns each rank's [M, N] in
    A's dtype."""
    n = mesh.size
    _comm.check_parts(a, mesh, "gemm_allreduce A")
    quant = isinstance(b[0], QuantW)
    bq = [w.q if quant else w for w in b]
    _comm.check_parts(bq, mesh, "gemm_allreduce B")
    M, K = a[0].shape
    N = bq[0].shape[1]
    if bq[0].shape[0] != K:
        raise ValueError(f"gemm_allreduce: A [{M}, {K}] @ B {tuple(bq[0].shape)}")
    if a[0].device.type == "cpu":
        return gemm_allreduce_ref(a, b)
    adt, bdt = a[0].dtype, bq[0].dtype
    ok = (adt == torch.bfloat16 and bdt in (torch.bfloat16, torch.int8) and K % 8 == 0
          and N % 8 == 0) or (adt == bdt == torch.float32 and N % 4 == 0)
    if not ok:
        raise ValueError(f"gemm_allreduce: A {adt} [{M}, {K}], B {bdt} [{K}, {N}]; the kernel "
                         "takes bf16 A with a bf16 or int8 B (K, N multiples of 8), or f32 "
                         "with f32 (N a multiple of 4)")
    scales = []
    if quant:
        scales = [w.s for w in b]
        _comm.check_parts(scales, mesh, "gemm_allreduce scales", ndim=1)
        if scales[0].dtype != torch.float32 or scales[0].shape[0] != N:
            raise ValueError("gemm_allreduce: QuantW scales must be [N] f32")
    outs = _comm.empty_like_parts(a, (M, N))
    land = create_symm_buffer("gemm_ar", (n, M, N), adt, mesh=mesh)
    bm = 128 if adt == torch.bfloat16 else 64
    G = _comm.ctas(mesh, -(-M // bm) * -(-N // bm))

    def call(lib, first, n_local, epoch, sig, st):
        lib.gemm_allreduce(DTYPE_CODES[adt], DTYPE_CODES[bdt], [x.data_ptr() for x in a],
                           [w.data_ptr() for w in bq], [s.data_ptr() for s in scales],
                           [o.data_ptr() for o in outs], land.ptrs, sig, first, n_local,
                           epoch, M, N, K, G, st)

    _comm.launch("gemm_allreduce", mesh, call)
    return outs
