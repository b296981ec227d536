"""AllGather-GroupGEMM: counterpart of triton_dist_tpu/kernels/ag_group_gemm.py
(`ag_group_gemm`, `ag_group_gemm_ref`; the TPU kernel `_ag_group_gemm_kernel`
of its `_call`).

y[e] = allgather(x)[e] @ w[e] for every expert: the gate/up products of
the tensor-parallel MoE layer's fused form (layers/tp_moe.py fwd_fused).
Over a mesh of n ranks the operands are lists, one per rank: rank r holds
its capacity chunk x_r [E, c, D] (rows [r c, (r + 1) c) of each expert of
the grouped tokens [E, n c, D]) and its column panel w_r [E, D, N_r] (a
tensor, a strided view, or the pair of column blocks [gate_r | up_r] that
grouped_gemm takes), and gets [E, n c, N_r] in x's dtype: the ring kernel
csrc/ag_group_gemm.cu on CUDA tensors (one launch per distinct device,
counted as `ag_group_gemm`), `ag_group_gemm_ref` on CPU tensors. At one
rank the gather is the identity and the call is the grouped GEMM
(kernels/group_gemm.py, counted as `grouped_gemm`).

The JAX function takes the global arrays, a mesh and an axis name; this
one takes the mesh and the per-rank lists. Its tuning knobs (block_n,
resident_b, wb_depth, ablate, collective_id) stage the TPU kernel's VMEM
tiles and feed its kprof and sweep tools, none of which the port has:
anything but their defaults raises NotImplementedError, as do int8 QuantW
panels. The gathered tokens live in a symmetric workspace sized to the
largest row count seen (runtime/symm_mem.py symm_workspace).
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels import _comm
from triton_dist_tpu_torch.kernels._build import DTYPE_CODES
from triton_dist_tpu_torch.kernels.group_gemm import grouped_gemm, grouped_gemm_ref
from triton_dist_tpu_torch.runtime.symm_mem import symm_workspace


def ag_group_gemm_ref(x, w) -> list:
    """Plain version: each rank's panel times the gathered tokens (the
    chunks concatenated along the rows), f32 accumulation, rounded once
    (grouped_gemm_ref); each rank's result on its device."""
    full = torch.cat([t.to(x[0].device) for t in x], dim=1)
    return [grouped_gemm_ref(full.to(t.device), wr) for t, wr in zip(x, w)]


def ag_group_gemm(x, w, *, mesh, block_n=None, collective_id=None, resident_b=None,
                  wb_depth=None, ablate: frozenset = frozenset()) -> list:
    """y_r = allgather(x)[e] @ w_r[e] per expert: x, w lists over `mesh`
    (rank r's chunk [E, c, D] and panel [E, D, N_r]) -> each rank's [E, n
    c, N_r]."""
    if (block_n is not None or collective_id is not None or resident_b is not None
            or wb_depth is not None or ablate):
        raise NotImplementedError("ag_group_gemm block_n / collective_id / resident_b / "
                                  "wb_depth / ablate: not yet ported")
    n = mesh.size
    b0, b1, es, ld, N, split = _comm.moe_operands("ag_group_gemm", x, w, mesh, False)
    if n == 1:
        return [grouped_gemm(x[0], w[0])]
    if x[0].device.type == "cpu":
        return ag_group_gemm_ref(x, w)
    E, c, D = x[0].shape
    M = n * c
    cv = c * D * x[0].element_size() // 16
    gathered = symm_workspace("ag_group_gemm_x", E * M, (D,), x[0].dtype, mesh=mesh)
    outs = _comm.empty_like_parts(x, (E, M, N))
    tile = 128 if x[0].dtype == torch.bfloat16 else 64
    G = _comm.ctas(mesh, max(E * -(-M // tile) * -(-N // tile), -(-E * cv // 512)))
    dt = DTYPE_CODES[x[0].dtype]

    def call(lib, first, n_local, epoch, sig, st):
        lib.ag_group_gemm(dt, [t.data_ptr() for t in x], [b.data_ptr() for b in b0],
                          [b.data_ptr() for b in b1], es, ld, gathered.ptrs,
                          [o.data_ptr() for o in outs], sig, first, n_local, epoch, E, M, N, D,
                          split, cv, G, st)

    _comm.launch("ag_group_gemm", mesh, call)
    return outs
