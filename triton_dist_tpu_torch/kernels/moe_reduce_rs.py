"""GroupGEMM-ReduceScatter: counterpart of
triton_dist_tpu/kernels/moe_reduce_rs.py (`moe_reduce_rs`,
`moe_reduce_rs_ref`; the TPU kernel `_moe_rs_kernel` of its `_call`).

y[e] = reduce_scatter(sum over ranks of h_r[e] @ w_r[e]) along each
expert's rows: the down products of the tensor-parallel MoE layer's fused
form (layers/tp_moe.py fwd_fused). Over a mesh of n ranks the operands are
lists, one per rank: rank r holds h_r [E, M, F_r] (its F-shard of the
expert activations) and w_r [E, F_r, D] (its row shard of the down panel;
a strided view of the one-rank panel is taken as it lies), and gets rows
[r M / n, (r + 1) M / n) of every expert of the sum, [E, M / n, D] in h's
dtype: the ring kernel csrc/moe_reduce_rs.cu on CUDA tensors (counted as
`moe_reduce_rs`), `moe_reduce_rs_ref` on CPU tensors. The roundings are
the TPU kernel's: each rank's partial rounded to h's dtype, then the
ring's sum, rounded at every hop, chunk c starting at rank c + 1 and ending
at rank c (reduce_scatter_ref's ring order). At one rank the call is the
grouped GEMM (counted as `grouped_gemm`).

The JAX knobs (collective_id, resident_b, wb_depth, ablate) and int8
QuantW panels raise NotImplementedError. The partial and the ring's
landing slots live in workspaces sized to the largest row count seen.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels import _comm
from triton_dist_tpu_torch.kernels._build import DTYPE_CODES
from triton_dist_tpu_torch.kernels.group_gemm import grouped_gemm, grouped_gemm_ref
from triton_dist_tpu_torch.kernels.reduce_scatter import ordered_sum, ring_order
from triton_dist_tpu_torch.runtime.symm_mem import symm_workspace


def moe_reduce_rs_ref(h, w) -> list:
    """Plain version: rank c's rows of every expert, each rank's partial
    of them h_r @ w_r rounded to h's dtype (grouped_gemm_ref), summed in
    the ring's order (rank c + 1 first, c last) in f32, rounded at every
    hop (reduce_scatter_ref's ring); rank c's [E, M / n, D] on its device.
    Only the rows a chunk needs are multiplied."""
    n = len(h)
    m = h[0].shape[1] // n
    return [ordered_sum([grouped_gemm_ref(a[:, c * m:(c + 1) * m], b) for a, b in zip(h, w)],
                        ring_order(c, n), True).to(h[c].device) for c in range(n)]


def moe_reduce_rs(h, w, *, mesh, collective_id=None, resident_b=None, wb_depth=None,
                  ablate: frozenset = frozenset()) -> list:
    """y = reduce_scatter(sum of h_r @ w_r) per expert: h, w lists over
    `mesh` (rank r's [E, M, F_r] and [E, F_r, D]) -> each rank's [E, M / n,
    D]; M must be a multiple of n."""
    if collective_id is not None or resident_b is not None or wb_depth is not None or ablate:
        raise NotImplementedError("moe_reduce_rs collective_id / resident_b / wb_depth / "
                                  "ablate: not yet ported")
    n = mesh.size
    b0, b1, es, ld, D, _ = _comm.moe_operands("moe_reduce_rs", h, w, mesh, True)
    if b1:
        raise ValueError("moe_reduce_rs: the down panel is one block, not a pair")
    if n == 1:
        return [grouped_gemm(h[0], w[0])]
    if h[0].device.type == "cpu":
        return moe_reduce_rs_ref(h, w)
    E, M, F = h[0].shape
    m = M // n
    dt = h[0].dtype
    cvec = E * m * D * h[0].element_size() // 16
    partial = symm_workspace("moe_rs_partial", E * M, (D,), dt, mesh=mesh)
    land = symm_workspace("moe_rs_land", (n - 1) * E * m, (D,), dt, mesh=mesh)
    outs = _comm.empty_like_parts(h, (E, m, D))
    tile = 128 if dt == torch.bfloat16 else 64
    G = _comm.ctas(mesh, max(E * -(-M // tile) * -(-D // tile), -(-cvec // 512)))

    def call(lib, first, n_local, epoch, sig, st):
        lib.moe_reduce_rs(DTYPE_CODES[dt], [t.data_ptr() for t in h],
                          [b.data_ptr() for b in b0], es, ld, [o.data_ptr() for o in outs],
                          partial.ptrs, land.ptrs, sig, first, n_local, epoch, E, M, D, F, cvec,
                          G, st)

    _comm.launch("moe_reduce_rs", mesh, call)
    return outs
