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


def moe_operands(what: str, a, w, mesh, rows_divide: bool):
    """Check the TP-MoE comm GEMMs' operands, one per rank: A [E, M, K]
    (contiguous, bf16 or f32; M a multiple of n where rows_divide) and B
    rank r's [E, K, N_r] panel in A's dtype, a strided view or a pair of
    column blocks with equal strides (grouped_gemm's forms), the same widths
    on every rank. Returns (block 0 of each rank, block 1 of each rank or an
    empty list, the expert strides, the row strides, N, block 0's width)."""
    from triton_dist_tpu_torch.kernels.group_gemm import column_blocks
    if any(isinstance(b, QuantW) for wr in w for b in column_blocks(wr)):
        raise NotImplementedError(f"{what} with int8 QuantW panels: not yet ported")
    check_parts(a, mesh, f"{what} A", ndim=3)
    E, M, K = a[0].shape
    blocks = [column_blocks(wr) for wr in w]
    if len(blocks) != mesh.size or len({len(b) for b in blocks}) != 1 or len(blocks[0]) > 2:
        raise ValueError(f"{what}: one panel (or one pair of column blocks) per rank")
    widths = tuple(b.shape[2] for b in blocks[0])
    for r, (bs, d) in enumerate(zip(blocks, mesh.devices)):
        for b in bs:
            if (b.dim() != 3 or tuple(b.shape[:2]) != (E, K) or b.dtype != a[0].dtype
                    or b.device != d or b.stride() != bs[0].stride()):
                raise ValueError(f"{what}: rank {r}'s B {tuple(b.shape)} {b.dtype} on "
                                 f"{b.device} strides {b.stride()}, want [{E}, {K}, .] "
                                 f"{a[0].dtype} on {d}, its blocks' strides equal")
        if tuple(b.shape[2] for b in bs) != widths:
            raise ValueError(f"{what}: rank {r}'s column widths differ from rank 0's")
    if rows_divide and M % mesh.size:
        raise ValueError(f"{what}: {M} rows an expert, not divisible by the axis size "
                         f"{mesh.size}")
    N, vec = sum(widths), 16 // a[0].element_size()
    dt = a[0].dtype
    if a[0].device.type == "cuda":
        if (dt not in (torch.bfloat16, torch.float32) or K % vec
                or any(wd % vec for wd in widths)
                or (dt == torch.bfloat16 and any(
                    bs[0].stride(0) % 8 or bs[0].stride(1) % 8 for bs in blocks))
                or any(bs[0].stride(2) != 1 or any(b.data_ptr() % 16 for b in bs)
                       for bs in blocks)):
            raise ValueError(f"{what}: A {dt} [E, M, {K}], B widths {widths}; the kernel "
                             "takes bf16 or f32 with B in A's dtype, unit column stride, "
                             f"K and the widths multiples of {vec}, blocks at 16-byte aligned "
                             "addresses, in bf16 B's row and expert strides multiples of 8")
    return ([bs[0] for bs in blocks], [bs[1] for bs in blocks] if len(widths) == 2 else [],
            [bs[0].stride(0) for bs in blocks], [bs[0].stride(1) for bs in blocks], N,
            widths[0])


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
