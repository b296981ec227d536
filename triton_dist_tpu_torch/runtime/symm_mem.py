"""Symmetric buffers: counterpart of triton_dist_tpu/runtime/symm_mem.py
(`create_symm_buffer`, `clear_registry`), plus `symm_workspace`, a
buffer grown to the largest row count asked for.

A symmetric buffer is one tensor of the same local shape per rank, on the
rank's device; a collective kernel writes into a peer's copy through its
device pointer. The registry is keyed as the JAX one is (name, local
shape, dtype, mesh, axis), so repeated calls reuse the same memory, and
buffers live until `clear_registry`. Every rank also owns one signal pad
(`signal_pad`): SIGNAL_SLOTS 32-bit flags, zeroed once and never reset,
since every wait compares a flag with the call's epoch
(runtime/bootstrap.py). The kernels take the n peers' addresses by value
in their launch parameters (csrc/launchers.h `CommArgs`), so no device
table of addresses has to be kept in step with the registry.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

# the signal pad's layout, shared with csrc/shmem.cuh: slots [0, 8) the
# barrier (one flag per source rank), then three regions of 8 x 256 data
# flags (source rank or ring step x CTA)
SIGNAL_SLOTS = 64 + 3 * 8 * 256


@dataclasses.dataclass(eq=False)
class SymmBuffer:
    """A named buffer of `local_shape` on every rank of `mesh`."""

    name: str
    local_shape: Tuple[int, ...]
    dtype: torch.dtype
    mesh: object
    tensors: list

    @property
    def ptrs(self) -> list:
        return [t.data_ptr() for t in self.tensors]


_REGISTRY: Dict[tuple, SymmBuffer] = {}


def create_symm_buffer(name: str, local_shape, dtype=torch.float32, *, mesh,
                       axis: str = "tp") -> SymmBuffer:
    """A zeroed `local_shape` buffer on every rank of `mesh`, cached by
    key."""
    key = (name, tuple(int(s) for s in local_shape), dtype, mesh, axis)
    if key not in _REGISTRY:
        _REGISTRY[key] = _allocate(name, key[1], dtype, mesh)
    return _REGISTRY[key]


def symm_workspace(name: str, rows: int, row_shape, dtype, *, mesh,
                   axis: str = "tp") -> SymmBuffer:
    """A symmetric buffer of at least `rows` rows of `row_shape`, keyed
    without the rows (name, row shape, dtype, mesh, axis) and grown to the
    largest row count asked for: the reference's max_M-padded workspace
    (its allgather_gemm.py:447), so that serving's many row counts share
    one buffer. The caller takes views of its first rows; a larger request
    replaces the buffer (the kernels never keep its address past a
    call)."""
    row_shape = tuple(int(s) for s in row_shape)
    key = (name, ("rows",) + row_shape, dtype, mesh, axis)
    buf = _REGISTRY.get(key)
    if buf is None or buf.local_shape[0] < rows:
        buf = _REGISTRY[key] = _allocate(name, (int(rows),) + row_shape, dtype, mesh)
    return buf


def _allocate(name: str, shape, dtype, mesh) -> SymmBuffer:
    buf = SymmBuffer(name=name, local_shape=shape, dtype=dtype, mesh=mesh,
                     tensors=[torch.zeros(shape, dtype=dtype, device=d) for d in mesh.devices])
    groups = mesh.device_groups()
    if len(groups) > 1 and mesh.is_cuda:
        # a peer may write a flag into this rank's pad as soon as its own
        # stream reaches a collective: the zeros must have landed first
        for d, _ in groups:
            torch.cuda.synchronize(d)
    return buf


def signal_pad(mesh) -> SymmBuffer:
    """The mesh's signal pads, one per rank."""
    return create_symm_buffer("signal", (SIGNAL_SLOTS,), torch.int32, mesh=mesh)


def clear_registry() -> None:
    """Drop every buffer (a later call allocates zeroed ones again)."""
    _REGISTRY.clear()
