"""AllGather-GEMM: counterpart of triton_dist_tpu/kernels/allgather_gemm.py
(`ag_gemm`; the TPU kernel `_ag_gemm_kernel` of `_ag_gemm_call`).

C = allgather(A) @ B, the column-parallel QKV and gate/up projections of
the "dist" backend. Over a mesh of n > 1 ranks (runtime/bootstrap.py) the
operands are lists, one per rank: rank r holds the row shard A_r [m, K]
and the column shard B_r [K, N_r] (a tensor or an int8 QuantW), and gets
C_r = allgather(A) @ B_r, [n * m, N_r] in A's dtype: the ring kernel
csrc/ag_gemm.cu on CUDA tensors (one launch per distinct device, counted
as `ag_gemm`), `ag_gemm_ref` on CPU tensors. At one rank the gather is the
identity and the tensor form, ag_gemm(a, b), is the GEMM kernel
(kernels/gemm.py, csrc/gemm.cu, counted as `gemm`), which training uses.

The JAX function takes a context (or a mesh and an axis name) and global
arrays; this one takes the mesh and the per-rank lists, and the context's
block_n (the Pallas tile width) has no counterpart: the CUDA tile is
fixed (csrc/gemm_tile.cuh). The gathered A lives in a symmetric workspace
sized to the largest row count seen (runtime/symm_mem.py symm_workspace);
return_ag returns a copy of it per rank.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels import _comm
from triton_dist_tpu_torch.kernels._build import DTYPE_CODES
from triton_dist_tpu_torch.kernels.gemm import gemm, gemm_ref
from triton_dist_tpu_torch.runtime.symm_mem import symm_workspace


def ag_gemm_ref(a, b, *, return_ag: bool = False):
    """Plain version: the gathered A times each rank's B shard, f32
    accumulation, rounded once (gemm_ref). a, b: a tensor each (one rank)
    or lists, one per rank (each rank's result and gathered A on its
    device)."""
    if isinstance(a, torch.Tensor):
        y = gemm_ref(a, b)
        return (y, a) if return_ag else y
    full = torch.cat([x.to(a[0].device) for x in a])
    outs = [gemm_ref(full.to(x.device), w) for x, w in zip(a, b)]
    return (outs, [full.to(x.device) for x in a]) if return_ag else outs


def ag_gemm(a, b, *, mesh=None, return_ag: bool = False):
    """C = allgather(A) @ B. One rank: a [M, K] and b [K, N] tensors (or a
    QuantW) -> [M, N] (the GEMM kernel). n > 1: a and b lists over `mesh`,
    rank r's A_r [m, K] and B_r [K, N_r] -> each rank's [n * m, N_r]. With
    return_ag also returns the gathered A (each rank's copy), as the JAX
    op does for the backward."""
    if isinstance(a, torch.Tensor):
        y = gemm(a, b)
        return (y, a) if return_ag else y
    if mesh is None:
        raise ValueError("ag_gemm: lists of per-rank shards need the mesh")
    n = mesh.size
    bq, scales = _comm.ring_gemm_operands("ag_gemm", a, b, mesh)
    m, K = a[0].shape
    M, N = n * m, bq[0].shape[1]
    if m * K * a[0].element_size() % 16:
        raise ValueError(f"ag_gemm: an A chunk [{m}, {K}] {a[0].dtype} is not a whole number "
                         "of 16-byte vectors, which the ring moves")
    if a[0].device.type == "cpu":
        return ag_gemm_ref(a, b, return_ag=return_ag)
    cvec = _comm.nvec16(a[0], "ag_gemm A chunk")
    gathered = symm_workspace("ag_gemm_a", M, (K,), a[0].dtype, mesh=mesh)
    ag = [t[:M] for t in gathered.tensors]
    outs = _comm.empty_like_parts(a, (M, N))
    bm = 128 if a[0].dtype == torch.bfloat16 else 64
    G = _comm.ctas(mesh, max(-(-M // bm) * -(-N // bm), -(-cvec // 512)))

    def call(lib, first, n_local, epoch, sig, st):
        lib.ag_gemm(DTYPE_CODES[a[0].dtype], DTYPE_CODES[bq[0].dtype],
                    [x.data_ptr() for x in a], [w.data_ptr() for w in bq],
                    [s.data_ptr() for s in scales], gathered.ptrs,
                    [o.data_ptr() for o in outs], sig, first, n_local, epoch, cvec, M, N, K,
                    G, st)

    _comm.launch("ag_gemm", mesh, call)
    return (outs, [t.clone() for t in ag]) if return_ag else outs
