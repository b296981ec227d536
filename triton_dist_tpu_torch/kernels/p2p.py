"""The pipeline's neighbour put: counterpart of
triton_dist_tpu/kernels/p2p.py (`p2p_shift`, `p2p_push_pages`).

A value sharded over a mesh of n ranks is a list of tensors, one per rank
on its device (runtime/bootstrap.py). `p2p_shift` moves rank i's tensor to
rank (i + 1) % n (reverse: (i - 1) % n), every rank sending and receiving
once: the stage handoff of layers/pp.py's PPipeline. On CUDA tensors it
launches csrc/p2p.cu (row 17), one launch per distinct device; on CPU
tensors it takes `p2p_shift_ref`. The kernel moves raw bytes, so the
result is bitwise the input. `p2p_push_pages` carries one payload from
rank src to rank dst over (dst - src) % n such shifts, as the JAX
function does for a KV page payload of disaggregated serving.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels import _comm


def p2p_shift_ref(xs, reverse: bool = False) -> list:
    """Plain version: rank j's result is a copy of rank (j - 1) % n's
    tensor (reverse: (j + 1) % n's) on rank j's device."""
    n = len(xs)
    step = 1 if reverse else -1
    return [xs[(j + step) % n].to(xs[j].device, copy=True) for j in range(n)]


def p2p_shift(xs, *, mesh, reverse: bool = False) -> list:
    """xs: one tensor per rank, alike in shape and dtype. Returns ys with
    ys[(i + 1) % n] equal to xs[i] (reverse: ys[(i - 1) % n]): the kernel
    on CUDA tensors, p2p_shift_ref on CPU tensors; one rank returns its
    tensor."""
    _comm.check_parts(xs, mesh, "p2p_shift", ndim=xs[0].dim() if len(xs) else 1)
    if mesh.size == 1:
        return list(xs)
    if xs[0].device.type == "cpu":
        return p2p_shift_ref(xs, reverse)
    outs = [torch.empty_like(x) for x in xs]
    nbytes = xs[0].numel() * xs[0].element_size()
    G = _comm.ctas(mesh, max(1, -(-nbytes // (16 * 512))))

    def call(lib, first, n_local, epoch, sig, st):
        lib.p2p_shift([x.data_ptr() for x in xs], [o.data_ptr() for o in outs], sig, first,
                      n_local, epoch, nbytes, int(reverse), G, st)

    _comm.launch("p2p_shift", mesh, call)
    return outs


def p2p_push_pages(x: torch.Tensor, *, mesh, src: int = 0, dst: int = 1) -> torch.Tensor:
    """The bytes of x, held by rank src, landed at rank dst: rank src's
    plane holds x and every other rank's zeros, and (dst - src) % n
    p2p_shift launches carry it a hop each, as the JAX function does (a
    hop moves n planes, the zeros too). Returns the payload on dst's
    device, bitwise x; src == dst returns x."""
    n = mesh.size
    src, dst = src % n, dst % n
    hops = (dst - src) % n
    if hops == 0:
        return x
    buf = [x.to(d).contiguous() if r == src else torch.zeros(x.shape, dtype=x.dtype, device=d)
           for r, d in enumerate(mesh.devices)]
    for _ in range(hops):
        buf = p2p_shift(buf, mesh=mesh)
    return buf[dst]
