"""all_to_all: counterpart of triton_dist_tpu/kernels/all_to_all.py
(`all_to_all`, `low_latency_all_to_all`; `all_to_all` is also the
device step `_a2a_pallas` that ep_a2a.py `combine_a2a` reaches).

Each rank's tensor holds n equal chunks along its first dimension, chunk
p addressed to rank p; afterwards chunk p of rank d's result is the chunk
that rank p addressed to d (the JAX `y[d, p] = x[p, d]` over the global
[n, n, C, ...] array, one [n, C, ...] block per rank here). The tensors
are a list with one per rank of the mesh (runtime/bootstrap.py). On CUDA
tensors the wrappers launch csrc/a2a.cu, one launch per distinct device;
on CPU tensors they take `all_to_all_ref`. The kernel moves bytes, so the
result is bitwise the exchange. `low_latency_all_to_all` ships each row
as ep_a2a.py `pack_rows_int8` packs it (int8 payload plus the f32 scale
as 4 trailing bytes) and unpacks it after the exchange.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels import _comm


def all_to_all_ref(xs) -> list:
    """Plain version: rank d's result is the concatenation over p of
    chunk d of rank p's tensor, on rank d's device."""
    n = len(xs)
    C = xs[0].shape[0] // n
    return [torch.cat([xs[p][d * C:(d + 1) * C].to(xs[d].device) for p in range(n)])
            for d in range(n)]


def _check(xs, mesh, what: str) -> None:
    _comm.check_parts(xs, mesh, what, ndim=xs[0].dim() if len(xs) else 2)
    if xs[0].dim() < 1 or xs[0].shape[0] % mesh.size:
        raise ValueError(f"{what}: the first dimension ({tuple(xs[0].shape)}) holds one chunk "
                         f"per rank; {mesh.size} ranks do not divide it")


def exchange(name: str, xs, mesh, metas=None):
    """Launch csrc/a2a.cu over the mesh on CUDA tensors (`name` is the
    launch count: "all_to_all", or "dispatch_a2a" with the metadata
    tensors `metas`, one per rank, moved in the same launch). Returns
    the outputs (and the metadata outputs)."""
    n = mesh.size
    outs = [torch.empty_like(x) for x in xs]
    mouts = None if metas is None else [torch.empty_like(m) for m in metas]
    chunk = xs[0].numel() * xs[0].element_size() // n
    mchunk = 0 if metas is None else metas[0].numel() * metas[0].element_size() // n
    G = _comm.ctas(mesh, max(1, -(-(chunk + mchunk) // (16 * 512))))
    ptrs = lambda ts: [t.data_ptr() for t in ts]  # noqa: E731

    def call(lib, first, n_local, epoch, sig, st):
        if metas is None:
            lib.all_to_all(ptrs(xs), ptrs(outs), sig, first, n_local, epoch, chunk, G, st)
        else:
            lib.dispatch_a2a(ptrs(xs), ptrs(metas), ptrs(outs), ptrs(mouts), sig, first,
                             n_local, epoch, chunk, mchunk, G, st)

    _comm.launch(name, mesh, call)
    return outs if metas is None else (outs, mouts)


def all_to_all(xs, *, mesh) -> list:
    """xs: one [n*C, ...] (or [n, C, ...]) tensor per rank, chunk p for rank
    p. Returns each rank's [n*C, ...] result, chunk p from rank p: the
    kernel on CUDA tensors, all_to_all_ref on CPU tensors; one rank
    returns its tensor. Also the device step of ep_a2a.combine_a2a (the
    JAX `_a2a_pallas`)."""
    _check(xs, mesh, "all_to_all")
    if mesh.size == 1:
        return list(xs)
    if xs[0].device.type == "cpu":
        return all_to_all_ref(xs)
    return exchange("all_to_all", xs, mesh)


def low_latency_all_to_all(xs, *, mesh, quantize: bool = True) -> list:
    """all_to_all with each row of the trailing dimension D packed to
    int8 with its f32 scale ([rows, D + 4] int8 on the wire, one exchange)
    and unpacked after it, in the input dtype. Lossy (one int8 rounding per
    row); quantize=False, or one rank, is the plain all_to_all."""
    n = mesh.size
    if n == 1 or not quantize:
        return all_to_all(xs, mesh=mesh)
    from triton_dist_tpu_torch.kernels.ep_a2a import pack_rows_int8, unpack_rows_int8
    D = xs[0].shape[-1]
    packed = all_to_all([pack_rows_int8(x.reshape(-1, D)) for x in xs], mesh=mesh)
    return [unpack_rows_int8(p, D, x.dtype).reshape(x.shape) for p, x in zip(packed, xs)]
