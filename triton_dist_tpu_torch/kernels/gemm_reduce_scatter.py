"""GEMM-ReduceScatter: counterpart of
triton_dist_tpu/kernels/gemm_reduce_scatter.py (`gemm_rs`; the TPU kernel
`_gemm_rs_kernel` of `_gemm_rs_call`).

C = reduce_scatter(A @ B), the row-parallel O and down projections of the
"dist" backend. Over a mesh of n > 1 ranks the operands are lists, one
per rank: rank r holds A_r [M, k_r] (its K-shard of the activations) and
B_r [k_r, N] (its row shard of the weight, a tensor or an int8 QuantW),
and gets rows [r * M / n, (r + 1) * M / n) of the sum, [M / n, N] in A's
dtype: the ring kernel csrc/gemm_rs.cu on CUDA tensors (counted as
`gemm_rs`), `gemm_rs_ref` on CPU tensors. The roundings are the Pallas
kernel's: each rank's partial rounded to A's dtype, then the ring's sum,
rounded at every hop, chunk c starting at rank c + 1 and ending at rank c
(reduce_scatter_ref's ring order). At one rank the reduction and the
scatter are the identity and the tensor form, gemm_rs(a, b), is the GEMM
kernel (kernels/gemm.py, csrc/gemm.cu, counted as `gemm`).

The rank's partial and the ring's landing slots live in workspaces sized
to the largest M seen (runtime/symm_mem.py symm_workspace).
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels import _comm
from triton_dist_tpu_torch.kernels._build import DTYPE_CODES
from triton_dist_tpu_torch.kernels.gemm import gemm, gemm_ref
from triton_dist_tpu_torch.kernels.reduce_scatter import ReduceScatterMethod, reduce_scatter_ref
from triton_dist_tpu_torch.runtime.symm_mem import symm_workspace


def gemm_rs_ref(a, b):
    """Plain version: each rank's partial A_r @ B_r rounded to A's dtype
    (gemm_ref), then the ring reduce-scatter's order and roundings. a, b:
    a tensor each (one rank) or lists, one per rank."""
    if isinstance(a, torch.Tensor):
        return gemm_ref(a, b)
    return reduce_scatter_ref([gemm_ref(x, w) for x, w in zip(a, b)],
                              method=ReduceScatterMethod.RING)


def gemm_rs(a, b, *, mesh=None):
    """C = reduce_scatter(A @ B). One rank: a [M, K] and b [K, N] tensors
    (or a QuantW) -> [M, N] (the GEMM kernel). n > 1: a and b lists over
    `mesh`, rank r's A_r [M, k_r] and B_r [k_r, N] -> each rank's [M / n,
    N]; M must be a multiple of n."""
    if isinstance(a, torch.Tensor):
        return gemm(a, b)
    if mesh is None:
        raise ValueError("gemm_rs: lists of per-rank shards need the mesh")
    n = mesh.size
    bq, scales = _comm.ring_gemm_operands("gemm_rs", a, b, mesh)
    M, K = a[0].shape
    N = bq[0].shape[1]
    if M % n:
        raise ValueError(f"gemm_rs: M={M} must be divisible by the axis size n={n}; "
                         "trailing rows would be silently dropped from the scatter")
    m = M // n
    dt = a[0].dtype
    if a[0].device.type == "cpu":
        return gemm_rs_ref(a, b)
    # a chunk [m, N] is whole 16-byte vectors: N is a multiple of 8 in
    # bf16, of 4 in f32 (ring_gemm_operands)
    cvec = m * N * a[0].element_size() // 16
    partial = symm_workspace("gemm_rs_partial", M, (N,), dt, mesh=mesh)
    land = symm_workspace("gemm_rs_land", (n - 1) * m, (N,), dt, mesh=mesh)
    outs = _comm.empty_like_parts(a, (m, N))
    bm = 128 if dt == torch.bfloat16 else 64
    G = _comm.ctas(mesh, max(-(-M // bm) * -(-N // bm), -(-cvec // 512)))

    def call(lib, first, n_local, epoch, sig, st):
        lib.gemm_rs(DTYPE_CODES[dt], DTYPE_CODES[bq[0].dtype], [x.data_ptr() for x in a],
                    [w.data_ptr() for w in bq], [s.data_ptr() for s in scales],
                    [o.data_ptr() for o in outs], partial.ptrs, land.ptrs, sig, first,
                    n_local, epoch, cvec, M, N, K, G, st)

    _comm.launch("gemm_rs", mesh, call)
    return outs
