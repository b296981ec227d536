"""all_gather: counterpart of triton_dist_tpu/kernels/allgather.py
(`AllGatherMethod`, `get_auto_all_gather_method`, `all_gather`; the TPU
kernels `_one_shot_kernel` and `_ring_kernel` of `_ag_pallas`).

Each rank's row shard [m, cols] gathered to [n*m, cols] on every rank.
The shards are a list with one tensor per rank of the mesh; the result is
a list of each rank's copy. On CUDA tensors the wrapper launches
csrc/allgather.cu (one launch per distinct device); on CPU tensors it
takes `all_gather_ref`. The method only changes how the bytes travel:
every method's result is bitwise the concatenation.
"""

from __future__ import annotations

import enum

import torch

from triton_dist_tpu_torch.kernels import _comm


class AllGatherMethod(enum.Enum):
    AUTO = "auto"
    ONE_SHOT = "one_shot"   # every rank pushes to every peer
    RING = "ring"           # neighbour forwarding


_ONE_SHOT_MAX_BYTES = 1 << 20


def get_auto_all_gather_method(nbytes_per_shard: int, n: int) -> AllGatherMethod:
    """Size-based selection, the JAX rule."""
    if n <= 2 or nbytes_per_shard * (n - 1) <= _ONE_SHOT_MAX_BYTES:
        return AllGatherMethod.ONE_SHOT
    return AllGatherMethod.RING


def resolve_method(method: AllGatherMethod, shard: torch.Tensor, n: int) -> AllGatherMethod:
    if method == AllGatherMethod.AUTO:
        return get_auto_all_gather_method(shard.numel() * shard.element_size(), n)
    return method


def all_gather_ref(shards) -> list:
    """Plain version: the concatenation, one copy per rank's device."""
    full = torch.cat([s.to(shards[0].device) for s in shards], dim=0)
    return [full.to(s.device) for s in shards]


def all_gather(shards, *, mesh, method: AllGatherMethod = AllGatherMethod.AUTO) -> list:
    """Gather the ranks' shards [m, cols] (a list, one per rank) into
    [n*m, cols] on every rank; returns each rank's copy."""
    _comm.check_parts(shards, mesh, "all_gather")
    n = mesh.size
    method = resolve_method(method, shards[0], n)
    if shards[0].device.type == "cpu":
        return all_gather_ref(shards)
    m = shards[0].shape[0]
    svec = _comm.nvec16(shards[0], "all_gather")
    outs = _comm.empty_like_parts(shards, (n * m,) + tuple(shards[0].shape[1:]))
    code = 0 if method == AllGatherMethod.ONE_SHOT else 1
    G = _comm.ctas(mesh, -(-svec // 512))

    def call(lib, first, n_local, epoch, sig, st):
        lib.all_gather(code, [s.data_ptr() for s in shards], [o.data_ptr() for o in outs],
                       sig, first, n_local, epoch, svec, G, st)

    _comm.launch("all_gather", mesh, call, method.value)
    return outs
