"""reduce_scatter: counterpart of triton_dist_tpu/kernels/reduce_scatter.py
(`ReduceScatterMethod`, `get_auto_reduce_scatter_method`,
`reduce_scatter`; the TPU kernels `_one_shot_rs_kernel` and
`_ring_rs_kernel` of `_rs_pallas`).

n partials [M, cols] (a list, one per rank) summed; rank r keeps rows
[r*M/n, (r+1)*M/n). The one-shot sums the n contributions of a chunk in
rank order in f32 and rounds once; the ring rounds to the dtype at every
hop, chunk c starting with rank c+1's partial and ending at rank c.
`reduce_scatter_ref` follows each method's order and roundings, so the
kernel (csrc/reduce_scatter.cu) equals it bitwise.
"""

from __future__ import annotations

import enum

import torch

from triton_dist_tpu_torch.kernels import _comm
from triton_dist_tpu_torch.kernels._build import DTYPE_CODES
from triton_dist_tpu_torch.runtime.symm_mem import create_symm_buffer


class ReduceScatterMethod(enum.Enum):
    AUTO = "auto"
    ONE_SHOT = "one_shot"
    RING = "ring"


_ONE_SHOT_MAX_BYTES = 1 << 20


def get_auto_reduce_scatter_method(nbytes_per_chunk: int, n: int) -> ReduceScatterMethod:
    """Size-based selection, the JAX rule."""
    if n <= 2 or nbytes_per_chunk * (n - 1) <= _ONE_SHOT_MAX_BYTES:
        return ReduceScatterMethod.ONE_SHOT
    return ReduceScatterMethod.RING


def ordered_sum(xs, order, rounding: bool) -> torch.Tensor:
    """xs[order[0]] + xs[order[1]] + ... in f32 on xs[0]'s device, rounded
    to the dtype after every addition (a ring) or once at the end."""
    dev, dt = xs[0].device, xs[0].dtype
    acc = xs[order[0]].to(dev).float()
    for r in order[1:]:
        acc = acc + xs[r].to(dev).float()
        if rounding:
            acc = acc.to(dt).float()
    return acc.to(dt)


def chunk_sum(parts, c: int, order, rounding: bool) -> torch.Tensor:
    """ordered_sum of the rows of chunk c (of n = len(parts) chunks)."""
    m = parts[0].shape[0] // len(parts)
    return ordered_sum([p[c * m:(c + 1) * m] for p in parts], order, rounding)


def ring_order(c: int, n: int) -> list:
    """The ranks whose partials a ring adds into chunk c, in order: c+1
    first, c last."""
    return [(c + 1 + j) % n for j in range(n)]


def reduce_scatter_ref(parts, *, method: ReduceScatterMethod = ReduceScatterMethod.ONE_SHOT
                       ) -> list:
    """Plain version, in `method`'s order and roundings (AUTO is not
    resolved here); rank r's chunk on its device."""
    n = len(parts)
    ring = method == ReduceScatterMethod.RING
    return [chunk_sum(parts, r, ring_order(r, n) if ring else list(range(n)), ring)
            .to(parts[r].device) for r in range(n)]


def reduce_scatter(parts, *, mesh,
                   method: ReduceScatterMethod = ReduceScatterMethod.AUTO) -> list:
    """Sum the ranks' partials [M, cols] and scatter row chunks: returns
    rank r's [M/n, cols]. M must be a multiple of n."""
    _comm.check_parts(parts, mesh, "reduce_scatter")
    n = mesh.size
    M, cols = parts[0].shape
    if n == 1:
        return [parts[0]]
    if M % n:
        raise ValueError(f"reduce_scatter: M={M} must be divisible by the axis size n={n}; "
                         "trailing rows would be silently dropped")
    m = M // n
    if method == ReduceScatterMethod.AUTO:
        method = get_auto_reduce_scatter_method(m * cols * parts[0].element_size(), n)
    if parts[0].device.type == "cpu":
        return reduce_scatter_ref(parts, method=method)
    if parts[0].dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"reduce_scatter: {parts[0].dtype}; the kernel sums f32 or bf16")
    nvec = _comm.nvec16(parts[0], "reduce_scatter")
    if nvec % n:
        raise ValueError(f"reduce_scatter: a chunk of [{m}, {cols}] {parts[0].dtype} is not a "
                         "whole number of 16-byte vectors, which the kernel moves")
    cvec = nvec // n
    outs = _comm.empty_like_parts(parts, (m, cols))
    ring = method == ReduceScatterMethod.RING
    land = create_symm_buffer("rs_ring" if ring else "rs_one_shot",
                              ((n - 1) if ring else n, m, cols), parts[0].dtype, mesh=mesh)
    G = _comm.ctas(mesh, -(-cvec // 512))

    def call(lib, first, n_local, epoch, sig, st):
        lib.reduce_scatter(DTYPE_CODES[parts[0].dtype], int(ring),
                           [p.data_ptr() for p in parts], [o.data_ptr() for o in outs],
                           land.ptrs, sig, first, n_local, epoch, cvec, G, st)

    _comm.launch("reduce_scatter", mesh, call, method.value)
    return outs
