"""GroupGEMM-AllReduce: counterpart of triton_dist_tpu/kernels/moe_reduce_ar.py
(`moe_reduce_ar`, `moe_reduce_ar_ref`; the TPU kernel `_moe_ar_kernel` of
its `_call`).

y[e] = sum over ranks of h_r[e] @ w_r[e], replicated: the down products of
the tensor-parallel MoE layer's decode form (layers/tp_moe.py
fwd_fused_ar), the product and its all-reduce in one kernel
(csrc/moe_reduce_ar.cu, counted as `moe_reduce_ar`). Rank r holds h_r [E,
M, F_r] and w_r [E, F_r, D] (a strided view of the one-rank panel is taken
as it lies) and gets [E, M, D] in h's dtype. Each rank's partial is rounded
to h's dtype, then the n partials are summed in rank order in f32 and
rounded once, as the TPU kernel does; `moe_reduce_ar_ref` does the same on
CPU tensors. At one rank the call is the grouped GEMM (counted as
`grouped_gemm`).

The JAX knobs (collective_id, resident_b) and int8 QuantW panels raise
NotImplementedError.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels import _comm
from triton_dist_tpu_torch.kernels._build import DTYPE_CODES
from triton_dist_tpu_torch.kernels.group_gemm import grouped_gemm, grouped_gemm_ref
from triton_dist_tpu_torch.kernels.reduce_scatter import ordered_sum
from triton_dist_tpu_torch.runtime.symm_mem import symm_workspace


def moe_reduce_ar_ref(h, w) -> list:
    """Plain version: the partials rounded to h's dtype (grouped_gemm_ref),
    summed in rank order in f32 on rank 0's device, rounded once; each
    rank's copy on its device."""
    out = ordered_sum([grouped_gemm_ref(a, b) for a, b in zip(h, w)], list(range(len(h))),
                      False)
    return [out.to(a.device) for a in h]


def moe_reduce_ar(h, w, *, mesh, collective_id=None, resident_b=None) -> list:
    """y = allreduce(h_r @ w_r) per expert: h, w lists over `mesh` (rank r's
    [E, M, F_r] and [E, F_r, D]) -> each rank's [E, M, D]."""
    if collective_id is not None or resident_b is not None:
        raise NotImplementedError("moe_reduce_ar collective_id / resident_b: not yet ported")
    n = mesh.size
    b0, b1, es, ld, D, _ = _comm.moe_operands("moe_reduce_ar", h, w, mesh, False)
    if b1:
        raise ValueError("moe_reduce_ar: the down panel is one block, not a pair")
    if n == 1:
        return [grouped_gemm(h[0], w[0])]
    if h[0].device.type == "cpu":
        return moe_reduce_ar_ref(h, w)
    E, M, F = h[0].shape
    dt = h[0].dtype
    land = symm_workspace("moe_ar_land", n * E * M, (D,), dt, mesh=mesh)
    outs = _comm.empty_like_parts(h, (E, M, D))
    tile = 128 if dt == torch.bfloat16 else 64
    G = _comm.ctas(mesh, E * -(-M // tile) * -(-D // tile))

    def call(lib, first, n_local, epoch, sig, st):
        lib.moe_reduce_ar(DTYPE_CODES[dt], [t.data_ptr() for t in h],
                          [b.data_ptr() for b in b0], es, ld, [o.data_ptr() for o in outs],
                          land.ptrs, sig, first, n_local, epoch, E, M, D, F, G, st)

    _comm.launch("moe_reduce_ar", mesh, call)
    return outs
