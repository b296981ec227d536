"""Launch plumbing shared by the collectives' wrappers (allgather.py,
reduce_scatter.py, allreduce.py, gemm_allreduce.py, and the rings of
allgather_gemm.py and gemm_reduce_scatter.py).

A collective takes one tensor per rank of a mesh (runtime/bootstrap.py),
tensor r on rank r's device. On the CPU the wrapper takes its plain
version; on CUDA it launches its kernel once per distinct device of the
mesh, back to back, with the call's epoch, every rank's pointers and the
ranks' signal pads (csrc/launchers.h CommArgs), and counts each launch.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels._build import count, ext, stream_ptr
from triton_dist_tpu_torch.kernels.quant import QuantW
from triton_dist_tpu_torch.runtime.symm_mem import signal_pad


def check_parts(parts, mesh, what: str, ndim: int = 2) -> None:
    """One contiguous tensor per rank, alike in shape and dtype, tensor r
    on the mesh's device r."""
    if len(parts) != mesh.size:
        raise ValueError(f"{what}: {len(parts)} tensors for a mesh of {mesh.size} ranks")
    p0 = parts[0]
    for r, (p, d) in enumerate(zip(parts, mesh.devices)):
        if p.dim() != ndim or p.shape != p0.shape or p.dtype != p0.dtype:
            raise ValueError(f"{what}: rank {r} has {tuple(p.shape)} {p.dtype}, rank 0 "
                             f"{tuple(p0.shape)} {p0.dtype} ({ndim} dims expected)")
        if p.device != d:
            raise ValueError(f"{what}: rank {r}'s tensor lies on {p.device}, its rank on {d}")
        if p.device.type == "cuda" and not p.is_contiguous():
            raise ValueError(f"{what}: rank {r}'s tensor is not contiguous")


def nvec16(t: torch.Tensor, what: str) -> int:
    """t's size in 16-byte vectors; raises unless it is a whole number of
    them at a 16-byte aligned address."""
    nbytes = t.numel() * t.element_size()
    if nbytes % 16 or t.data_ptr() % 16:
        raise ValueError(f"{what}: the kernels move 16-byte vectors; {tuple(t.shape)} "
                         f"{t.dtype} is {nbytes} bytes at {t.data_ptr() % 16} past 16")
    return nbytes // 16


def ring_gemm_operands(what: str, a, b, mesh):
    """Check the ring GEMMs' operands, one per rank: A [., K] (bf16 or
    f32) and B [K, N] in A's dtype or an int8 QuantW with an [N] f32
    scale; bf16 takes K and N in multiples of 8, f32 N in multiples of 4
    (the kernels' 16-byte vectors). Returns (the B tensors, the scales or
    an empty list)."""
    check_parts(a, mesh, f"{what} A")
    quant = isinstance(b[0], QuantW)
    bq = [w.q if quant else w for w in b]
    check_parts(bq, mesh, f"{what} B")
    K, N = a[0].shape[1], bq[0].shape[1]
    adt, bdt = a[0].dtype, bq[0].dtype
    if bq[0].shape[0] != K:
        raise ValueError(f"{what}: A [., {K}] @ B {tuple(bq[0].shape)}")
    if (adt not in (torch.bfloat16, torch.float32) or bdt != (torch.int8 if quant else adt)
            or (adt == torch.bfloat16 and (K % 8 or N % 8)) or N % 4):
        raise ValueError(f"{what}: A {adt} [., {K}], B {bdt} [{K}, {N}]; the kernel takes "
                         "bf16 or f32 A with B of its dtype or an int8 QuantW, K and N "
                         "multiples of 8 in bf16, N of 4 in f32")
    scales = []
    if quant:
        scales = [w.s for w in b]
        check_parts(scales, mesh, f"{what} scales", ndim=1)
        if scales[0].dtype != torch.float32 or scales[0].shape[0] != N:
            raise ValueError(f"{what}: QuantW scales must be [{N}] f32")
    return bq, scales


def ctas(mesh, work: int) -> int:
    """CTAs per rank, the same on every device: enough for `work` units of
    512 vectors (or tiles), at most one CTA per SM for the ranks of the
    busiest device, at most 256 (the signal pad's layout)."""
    sms = min(torch.cuda.get_device_properties(d).multi_processor_count
              for d, _ in mesh.device_groups())
    per = sms // max(len(rs) for _, rs in mesh.device_groups())
    return max(1, min(per, work, 256))


def launch(name: str, mesh, call, method: str | None = None) -> None:
    """call(lib, first_rank, n_local, epoch, sig_ptrs, stream) once per
    distinct device, under that device, with one epoch for the call;
    each launch counted under `name` and its method."""
    lib = ext()
    epoch = mesh.next_epoch()
    sig = signal_pad(mesh).ptrs
    for dev, ranks in mesh.device_groups():
        with torch.cuda.device(dev):
            call(lib, ranks[0], len(ranks), epoch, sig, stream_ptr(dev))
        count(name, method)


def empty_like_parts(parts, shape, dtype=None) -> list:
    return [torch.empty(shape, dtype=dtype or p.dtype, device=p.device) for p in parts]
