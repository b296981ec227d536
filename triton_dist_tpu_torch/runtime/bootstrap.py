"""The device mesh: counterpart of triton_dist_tpu/runtime/bootstrap.py
(`make_mesh`, `DistContext`, `next_collective_id`).

The JAX package is one program over a `Mesh` whose per-device code runs
under `shard_map`. The port keeps that shape in one process: a mesh is a
list of torch devices, one per rank, and a sharded value is a Python list
of tensors, tensor r on rank r's device. A device may repeat:
`[cuda:0, cuda:1, cuda:2, cuda:3]` is four cards, `[cuda:0] * 4` four
ranks emulated on one card, `[cpu] * 4` the CPU, where every collective
takes its plain version. No `torch.distributed`, NCCL or gloo is used:
one process drives every rank, and the collectives' kernels reach their
peers through device pointers (peer access between distinct cards, plain
pointers between ranks of one card).

The ranks of one device are contiguous (rank = the device's first rank +
the local index), so that one launch per distinct device covers all the
ranks it holds. `Mesh.next_epoch()` is the per-mesh call counter that the
collectives take as their epoch: every signal a call writes carries it,
and every wait compares with it, so flags are zeroed once and never
reset (the role of `next_collective_id`'s disjoint barrier semaphores).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from triton_dist_tpu_torch.runtime.device import resolve_device


class Mesh:
    """The ranks of one tensor-parallel axis ("tp"), one device each.
    Compared and hashed by identity: two meshes over the same devices
    keep separate epochs and symmetric buffers."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        groups: dict = {}
        for r, d in enumerate(self.devices):
            if d in groups and groups[d][-1] != r - 1:
                raise ValueError(
                    f"the ranks of {d} are not contiguous in {self.devices}: one launch "
                    "per device covers its ranks as first_rank + local index")
            groups.setdefault(d, []).append(r)
        self._groups = [(d, rs) for d, rs in groups.items()]
        self._epoch = 0

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def is_cuda(self) -> bool:
        return self.devices[0].type == "cuda"

    def device_groups(self) -> list:
        """[(device, [its ranks])] in rank order: one launch each."""
        return list(self._groups)

    def next_epoch(self) -> int:
        """The next collective call's epoch (1, 2, ...)."""
        self._epoch += 1
        if self._epoch >= 1 << 31:
            raise RuntimeError("the mesh's collective epoch overflowed")
        return self._epoch

    def replicate(self, t: torch.Tensor) -> list:
        """One copy of t per rank, on its device (the tensor itself where
        the device is t's: ranks of one device share it)."""
        return [t.to(d) for d in self.devices]

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n: Optional[int] = None, devices=None) -> Mesh:
    """A mesh of n ranks. devices: one per rank (strings or
    torch.device); by default every visible card, one rank each. A
    CUDA device without a card raises (resolve_device), as does a mesh
    of distinct cards where one cannot reach another by peer access;
    for distinct cards, peer access is enabled for every ordered
    pair."""
    if devices is None:
        if not torch.cuda.is_available():
            resolve_device("cuda")          # raises: no card
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        if n is not None:
            if n > len(devices):
                raise RuntimeError(f"a mesh of {n} cards was asked for; "
                                   f"{len(devices)} are visible")
            devices = devices[:n]
    devs = [resolve_device(d) for d in devices]
    if n is not None and n != len(devs):
        raise ValueError(f"mesh of {n} ranks given {len(devs)} devices")
    mesh = Mesh(devs)
    cards = sorted({d.index for d in devs if d.type == "cuda"})
    if cards and any(d.type != "cuda" for d in devs):
        raise ValueError(f"a mesh mixes CUDA and CPU devices: {devs}")
    if len(cards) > 1:
        _enable_peer_access(cards)
    return mesh


def _enable_peer_access(cards) -> None:
    from triton_dist_tpu_torch.kernels._build import ext
    for i in cards:
        for j in cards:
            if i != j and not torch.cuda.can_device_access_peer(i, j):
                raise RuntimeError(f"cuda:{i} cannot reach cuda:{j} by peer access; "
                                   "the collectives need every pair")
    lib = ext()
    for i in cards:
        for j in cards:
            if i != j:
                lib.enable_peer_access(i, j)


_SINGLE: dict = {}


def mesh_of(device) -> Mesh:
    """The one-rank mesh of a device (cached): the mesh of a model that
    was built without one."""
    dev = torch.device(device)
    if dev not in _SINGLE:
        _SINGLE[dev] = Mesh([dev])
    return _SINGLE[dev]
