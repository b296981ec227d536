"""all_reduce: counterpart of triton_dist_tpu/kernels/allreduce.py
(`AllReduceMethod`, `get_auto_allreduce_method`, `all_reduce`; the TPU
kernels `_one_shot_ar_kernel` and `_two_shot_ar_kernel` of
`_ar_pallas`).

The sum of n partials [M, cols] (a list, one per rank), replicated: a
list of each rank's copy. One-shot: every rank sums the n partials in
rank order in f32 and rounds once. Two-shot (n | M; otherwise the
one-shot, as in JAX): a ring reduce-scatter, rounding at every hop, then
a ring all-gather of the reduced chunks. `all_reduce_ref` follows each
method's order and roundings, so the kernel (csrc/allreduce.cu) equals it
bitwise and every rank's copy is the same. The TP layers' "flash"/"xla"
modes at n > 1 take `all_reduce_ref` as their psum epilogue (XLA's psum
is no Pallas kernel).
"""

from __future__ import annotations

import enum

import torch

from triton_dist_tpu_torch.kernels import _comm
from triton_dist_tpu_torch.kernels._build import DTYPE_CODES
from triton_dist_tpu_torch.kernels.reduce_scatter import chunk_sum, ordered_sum, ring_order
from triton_dist_tpu_torch.runtime.symm_mem import create_symm_buffer


class AllReduceMethod(enum.Enum):
    AUTO = "auto"
    ONE_SHOT = "one_shot"
    TWO_SHOT = "two_shot"


_ONE_SHOT_MAX_BYTES = 1 << 20


def get_auto_allreduce_method(nbytes: int, n: int) -> AllReduceMethod:
    """Size-based selection, the JAX rule."""
    if n <= 2 or nbytes * (n - 1) <= _ONE_SHOT_MAX_BYTES:
        return AllReduceMethod.ONE_SHOT
    return AllReduceMethod.TWO_SHOT


def resolve_method(method: AllReduceMethod, M: int, cols: int, itemsize: int,
                   n: int) -> AllReduceMethod:
    """AUTO by size; the two-shot's ring needs n | M, else the one-shot."""
    if method == AllReduceMethod.AUTO:
        method = get_auto_allreduce_method(M * cols * itemsize, n)
    if method == AllReduceMethod.TWO_SHOT and M % n:
        method = AllReduceMethod.ONE_SHOT
    return method


def all_reduce_ref(parts, *, method: AllReduceMethod = AllReduceMethod.ONE_SHOT) -> list:
    """Plain version in `method`'s order and roundings (plain copies to
    rank 0's device and a sum there), one result per distinct device,
    shared by the ranks that live on it."""
    n = len(parts)
    if method == AllReduceMethod.TWO_SHOT:
        out = torch.cat([chunk_sum(parts, c, ring_order(c, n), True) for c in range(n)])
    else:
        out = ordered_sum(parts, list(range(n)), False)
    copies = {}
    return [copies.setdefault(p.device, out.to(p.device)) for p in parts]


def all_reduce(parts, *, mesh, method: AllReduceMethod = AllReduceMethod.AUTO) -> list:
    """Sum the ranks' partials [M, cols]; returns each rank's copy of the
    sum (at n = 1 the partial itself, as in JAX)."""
    _comm.check_parts(parts, mesh, "all_reduce")
    n = mesh.size
    if n == 1:
        return [parts[0]]
    M, cols = parts[0].shape
    method = resolve_method(method, M, cols, parts[0].element_size(), n)
    if parts[0].device.type == "cpu":
        return all_reduce_ref(parts, method=method)
    if parts[0].dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"all_reduce: {parts[0].dtype}; the kernel sums f32 or bf16")
    nvec = _comm.nvec16(parts[0], "all_reduce")
    two = method == AllReduceMethod.TWO_SHOT
    if two and nvec % n:
        raise ValueError(f"all_reduce two-shot: a chunk of [{M // n}, {cols}] {parts[0].dtype} "
                         "is not a whole number of 16-byte vectors, which the kernel moves")
    outs = _comm.empty_like_parts(parts, (M, cols))
    land = create_symm_buffer("ar_two_shot" if two else "ar_one_shot",
                              ((n - 1, M // n, cols) if two else (n, M, cols)),
                              parts[0].dtype, mesh=mesh)
    G = _comm.ctas(mesh, -(-(nvec // n if two else nvec) // 512))

    def call(lib, first, n_local, epoch, sig, st):
        lib.all_reduce(DTYPE_CODES[parts[0].dtype], int(two), [p.data_ptr() for p in parts],
                       [o.data_ptr() for o in outs], land.ptrs, sig, first, n_local, epoch,
                       nvec, G, st)

    _comm.launch("all_reduce", mesh, call, method.value)
    return outs
