"""The kernel registry: one canonical call for each ported kernel.

Counterpart of triton_dist_tpu/kernels/__init__.py (`KernelSpec`,
`kernel_registry` and the build functions `_b_flash_decode`,
`_b_flash_decode_paged`, `_b_kv_update`, `_b_grouped_gemm`, `_b_swiglu`,
`_b_gdn`, `_b_flash_attention`, and the collectives' `_b_allgather`,
`_b_reduce_scatter`, `_b_allreduce`, `_b_ag_gemm`, `_b_gemm_rs`,
`_b_gemm_ar`, `_b_all_to_all`, `_b_ep_dispatch_combine`, `_b_ep_fused`,
`_b_ag_group_gemm`, `_b_moe_reduce`, and the sequence-parallel
`_b_sp_flash_decode`, `_b_kv_scatter`, `_b_sp_ring`, and `_b_p2p`): the
eight specs whose `min_devices` is 1, whose build takes a device, and the
twenty of the ported collectives (min_devices 2, kind "comm"),
whose build takes a mesh (runtime/bootstrap.py) and returns one input
per rank.
Each build function draws its inputs from the same
`np.random.RandomState(seed)`, in the same order and shapes, as its JAX
counterpart, so that both registries' canonical calls see equal inputs.
The one difference is grouped_gemm's: its kernel takes bf16, so the
drawn values are rounded to bf16.

`KernelSpec` keeps the fields the port reads (name, module, kind, build,
min_devices, inplace); the JAX spec's protocol, vmem_budget,
ablation_phases, tunables, tune_dims and variants feed tools the port
does not have yet (tdcheck, kprof, tune, sweep). The registry is read by
`tools/perf_report.py` (`registry_coverage`) and by chip_smoke.py, which
runs every spec on the card and holds it to the same spec run on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One registered kernel. build(device) -> (fn, args): fn(*args) is
    the public op at small canonical shapes, its tensors on `device`; for
    min_devices > 1, build(mesh), args holding each rank's tensors.
    kind: "compute", "paged" or "comm" (the JAX spec's category).
    inplace: the positions in args that the call updates in place (the
    JAX spec's input/output aliasing)."""

    name: str
    module: str
    kind: str
    build: Callable
    min_devices: int = 1
    inplace: Tuple[int, ...] = ()


def _f32(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)) * 0.1


def _on(device, *ts):
    return tuple(t.to(device) for t in ts)


def _b_flash_decode(device):
    from triton_dist_tpu_torch.kernels.flash_attn import flash_decode
    rng = np.random.RandomState(13)
    B, Hq, Hkv, T, d = 2, 4, 2, 256, 128
    q = _f32(rng, B, 1, Hq, d)
    k = _f32(rng, B, Hkv, T, d)
    v = _f32(rng, B, Hkv, T, d)
    return (lambda q_, k_, v_: flash_decode(q_, k_, v_, T)), _on(device, q, k, v)


def _b_flash_decode_paged(partial: bool):
    def build(device):
        from triton_dist_tpu_torch.kernels.paged_kv import (flash_decode_paged,
                                                            flash_decode_paged_partial)
        rng = np.random.RandomState(14)
        B, Hq, Hkv, d, page, maxp = 2, 4, 2, 128, 128, 4
        NP = B * Hkv * maxp
        q = _f32(rng, B, 1, Hq, d)
        pages = _f32(rng, NP, page, d)
        table = torch.arange(NP, dtype=torch.int32).reshape(B * Hkv, maxp)
        kv_lens = torch.tensor([page * maxp, page], dtype=torch.int32, device=device)
        args = _on(device, q, pages, pages, table)
        if partial:
            owned = torch.ones(B * Hkv, maxp, dtype=torch.int32, device=device)
            return (lambda q_, pk, pv, t_: flash_decode_paged_partial(
                q_, pk, pv, t_, kv_lens=kv_lens, tile_owned=owned)), args
        return (lambda q_, pk, pv, t_: flash_decode_paged(q_, pk, pv, t_,
                                                          kv_lens=kv_lens)), args
    return build


def _b_kv_update(device):
    from triton_dist_tpu_torch.kernels.flash_attn import kv_update
    rng = np.random.RandomState(15)
    B, H, T, d, S = 1, 2, 256, 128, 8
    cache = _f32(rng, B, H, T, d)
    new = _f32(rng, B, H, S, d)
    return (lambda c, n_: kv_update(c, n_, 0)), _on(device, cache, new)


def _b_grouped_gemm(device):
    from triton_dist_tpu_torch.kernels.group_gemm import grouped_gemm
    rng = np.random.RandomState(16)
    x = _f32(rng, 2, 64, 128)
    w = _f32(rng, 2, 128, 128)
    return grouped_gemm, _on(device, x.to(torch.bfloat16), w.to(torch.bfloat16))


def _b_swiglu(device):
    from triton_dist_tpu_torch.kernels.swiglu import swiglu
    rng = np.random.RandomState(17)
    return swiglu, _on(device, _f32(rng, 64, 256))


def _b_gdn(device):
    from triton_dist_tpu_torch.kernels.gdn import gdn_fwd
    rng = np.random.RandomState(18)
    B, H, T, d = 1, 2, 128, 128
    q = _f32(rng, B, H, T, d)
    k = _f32(rng, B, H, T, d)
    v = _f32(rng, B, H, T, d)
    g = torch.from_numpy((-np.abs(rng.rand(B, H, T)) * 0.1).astype(np.float32))
    b = torch.from_numpy(rng.rand(B, H, T).astype(np.float32))
    return gdn_fwd, _on(device, q, k, v, g, b)


def _b_flash_attention(device):
    from triton_dist_tpu_torch.kernels.flash_attn_train import flash_attention
    rng = np.random.RandomState(19)
    B, S, Hq, Hkv, d = 1, 128, 2, 2, 128
    q = _f32(rng, B, S, Hq, d)
    k = _f32(rng, B, Hkv, S, d)
    v = _f32(rng, B, Hkv, S, d)
    return flash_attention, _on(device, q, k, v)


def _split(x, mesh, dim=0):
    """x cut into mesh.size blocks along dim, block r on rank r's device."""
    return [t.contiguous().to(d) for t, d in zip(x.chunk(mesh.size, dim), mesh.devices)]


def _b_allgather(method: str):
    def build(mesh):
        from triton_dist_tpu_torch.kernels.allgather import AllGatherMethod, all_gather
        x = _f32(np.random.RandomState(0), 8 * mesh.size, 128)
        return (lambda *xs: all_gather(list(xs), mesh=mesh, method=AllGatherMethod(method)),
                tuple(_split(x, mesh)))
    return build


def _b_partials(op: str, method: str):
    """reduce_scatter and all_reduce: the [n, 8n, 128] partials, rank r's
    slice r."""
    def build(mesh):
        from triton_dist_tpu_torch.kernels.allreduce import AllReduceMethod, all_reduce
        from triton_dist_tpu_torch.kernels.reduce_scatter import (ReduceScatterMethod,
                                                                   reduce_scatter)
        n = mesh.size
        x = _f32(np.random.RandomState(0), n, 8 * n, 128)
        if op == "rs":
            fn = lambda *xs: reduce_scatter(  # noqa: E731
                list(xs), mesh=mesh, method=ReduceScatterMethod(method))
        else:
            fn = lambda *xs: all_reduce(list(xs), mesh=mesh,  # noqa: E731
                                        method=AllReduceMethod(method))
        return fn, tuple(t[0] for t in _split(x, mesh))
    return build


def _b_ag_gemm(mesh):
    """A [8n, 128] sharded on rows, B [128, 32n] on columns (seed 2, the
    JAX order: a, then b); args: the n A shards, then the n B shards."""
    from triton_dist_tpu_torch.kernels.allgather_gemm import ag_gemm
    n = mesh.size
    rng = np.random.RandomState(2)
    a, b = _f32(rng, 8 * n, 128), _f32(rng, 128, 32 * n)
    return ((lambda *ab: ag_gemm(list(ab[:n]), list(ab[n:]), mesh=mesh)),
            tuple(_split(a, mesh, 0) + _split(b, mesh, 1)))


def _b_gemm_rs(mesh):
    """A [8n, 128] sharded on columns, B [128, 128] on rows (seed 3, the
    JAX order); args: the n A shards, then the n B shards."""
    from triton_dist_tpu_torch.kernels.gemm_reduce_scatter import gemm_rs
    n = mesh.size
    rng = np.random.RandomState(3)
    a, b = _f32(rng, 8 * n, 128), _f32(rng, 128, 128)
    return ((lambda *ab: gemm_rs(list(ab[:n]), list(ab[n:]), mesh=mesh)),
            tuple(_split(a, mesh, 1) + _split(b, mesh, 0)))


def _b_gemm_ar(mesh):
    """A [8, 128] sharded on columns, B [128, 128] on rows (seed 4, drawn
    in the JAX order: a, then b); args: the n A shards, then the n B
    shards."""
    from triton_dist_tpu_torch.kernels.gemm_allreduce import gemm_allreduce
    n = mesh.size
    rng = np.random.RandomState(4)
    a, b = _f32(rng, 8, 128), _f32(rng, 128, 128)
    return ((lambda *ab: gemm_allreduce(list(ab[:n]), list(ab[n:]), mesh=mesh)),
            tuple(_split(a, mesh, 1) + _split(b, mesh, 0)))


def _b_all_to_all(low_latency: bool):
    """x [n, n, 8, 128] (seed 1), rank r's block x[r]."""
    def build(mesh):
        from triton_dist_tpu_torch.kernels.all_to_all import all_to_all, low_latency_all_to_all
        n = mesh.size
        x = _f32(np.random.RandomState(1), n, n, 8, 128)
        fn = low_latency_all_to_all if low_latency else all_to_all
        return (lambda *xs: fn(list(xs), mesh=mesh)), tuple(t[0] for t in _split(x, mesh))
    return build


def _b_ep_dispatch_combine(mesh):
    """x [8n, 128] and router logits [8n, 2n] (seed 8, in that order),
    row-sharded; 2n experts, top-2, capacity 8n; args: the n x shards,
    then the n logit shards."""
    from triton_dist_tpu_torch.kernels.ep_a2a import create_ep_a2a_context, ep_dispatch_combine
    n = mesh.size
    rng = np.random.RandomState(8)
    T, D, E = 8 * n, 128, 2 * n
    x, logits = _f32(rng, T, D), _f32(rng, T, E)
    ctx = create_ep_a2a_context(mesh, num_experts=E, capacity=T)
    return ((lambda *xl: ep_dispatch_combine(list(xl[:n]), list(xl[n:]), 2, ctx)),
            tuple(_split(x, mesh) + _split(logits, mesh)))


def _b_ep_fused(mesh):
    """ep_moe_fused_device at E_loc=2, cap_e=16, D=I=128 (seed 9: x
    [n*2*16*n, 128], w_gu [2n, 128, 256], w_d [2n, 128, 128]); args: the
    n x shards, the n w_gu shards, the n w_d shards."""
    from triton_dist_tpu_torch.kernels.ep_fused import ep_moe_fused_device
    n = mesh.size
    rng = np.random.RandomState(9)
    E_loc, cap_e, D, I = 2, 16, 128, 128
    x = _f32(rng, n * E_loc * cap_e * n, D)
    wgu = _f32(rng, E_loc * n, D, 2 * I)
    wd = _f32(rng, E_loc * n, I, D)
    return ((lambda *a: ep_moe_fused_device(list(a[:n]), list(a[n:2 * n]), list(a[2 * n:]),
                                            mesh=mesh, cap_e=cap_e)),
            tuple(_split(x, mesh) + _split(wgu, mesh) + _split(wd, mesh)))


def _b_ag_group_gemm(mesh):
    """x_e [2, 8n, 128] sharded on its capacity rows, w [2, 128, 128] on
    its columns (seed 10, the JAX order); args: the n chunks, then the n
    column panels."""
    from triton_dist_tpu_torch.kernels.ag_group_gemm import ag_group_gemm
    n = mesh.size
    rng = np.random.RandomState(10)
    xe, we = _f32(rng, 2, 8 * n, 128), _f32(rng, 2, 128, 128)
    return ((lambda *a: ag_group_gemm(list(a[:n]), list(a[n:]), mesh=mesh)),
            tuple(_split(xe, mesh, 1) + _split(we, mesh, 2)))


def _b_moe_reduce(which: str):
    """h [2, 8n, 128] sharded on its columns, w2 [2, 128, 128] on its rows
    (seed 11, the JAX order); args: the n h shards, then the n w2 shards."""
    def build(mesh):
        from triton_dist_tpu_torch.kernels.moe_reduce_ar import moe_reduce_ar
        from triton_dist_tpu_torch.kernels.moe_reduce_rs import moe_reduce_rs
        n = mesh.size
        rng = np.random.RandomState(11)
        h, w2 = _f32(rng, 2, 8 * n, 128), _f32(rng, 2, 128, 128)
        op = moe_reduce_ar if which == "ar" else moe_reduce_rs
        return ((lambda *a: op(list(a[:n]), list(a[n:]), mesh=mesh)),
                tuple(_split(h, mesh, 2) + _split(w2, mesh, 1)))
    return build


def _b_sp_flash_decode(mesh):
    """q [1, 1, 4, 128] replicated, k and v [1, 2, 16n, 128] sharded on T
    (seed 5, the JAX order), combine "dist"; args: the n q copies, the n k
    windows, the n v windows."""
    from triton_dist_tpu_torch.kernels.sp_flash_decode import sp_flash_decode
    n = mesh.size
    rng = np.random.RandomState(5)
    B, Hq, Hkv, T, d = 1, 4, 2, 16 * n, 128
    q, k, v = _f32(rng, B, 1, Hq, d), _f32(rng, B, Hkv, T, d), _f32(rng, B, Hkv, T, d)
    return ((lambda *a: sp_flash_decode(list(a[:n]), list(a[n:2 * n]), list(a[2 * n:]), T,
                                        mesh=mesh, combine="dist")),
            tuple(mesh.replicate(q) + _split(k, mesh, 2) + _split(v, mesh, 2)))


def _b_kv_scatter(mesh):
    """cache and new [1, 2, 16n, 128], both sharded on positions (seed 6,
    the JAX order; s_loc = t_loc); args: the n cache windows (updated in
    place), then the n new blocks."""
    from triton_dist_tpu_torch.kernels.sp_flash_decode import kv_cache_scatter
    n = mesh.size
    rng = np.random.RandomState(6)
    cache, new = _f32(rng, 1, 2, 16 * n, 128), _f32(rng, 1, 2, 16 * n, 128)
    return ((lambda *a: kv_cache_scatter(list(a[:n]), list(a[n:]), mesh=mesh)),
            tuple(_split(cache, mesh, 2) + _split(new, mesh, 2)))


def _b_sp_ring(mesh):
    """q [1, 8n, 2, 128] sharded on positions, k and v [1, 2, 8n, 128]
    (seed 7, the JAX order), causal, mode "ring_shmem"; args: the n q, k,
    v shards in that order."""
    from triton_dist_tpu_torch.kernels.sp_attention import sp_ring_attention
    n = mesh.size
    rng = np.random.RandomState(7)
    B, H, S, d = 1, 2, 8 * n, 128
    q, k, v = _f32(rng, B, S, H, d), _f32(rng, B, H, S, d), _f32(rng, B, H, S, d)
    return ((lambda *a: sp_ring_attention(list(a[:n]), list(a[n:2 * n]), list(a[2 * n:]),
                                          mesh=mesh, mode="ring_shmem")),
            tuple(_split(q, mesh, 1) + _split(k, mesh, 2) + _split(v, mesh, 2)))


def _b_p2p(mesh):
    """x [n, 8, 128] (seed 0), rank r's block x[r]."""
    from triton_dist_tpu_torch.kernels.p2p import p2p_shift
    x = _f32(np.random.RandomState(0), mesh.size, 8, 128)
    return (lambda *xs: p2p_shift(list(xs), mesh=mesh)), tuple(t[0] for t in _split(x, mesh))


@functools.lru_cache(maxsize=None)
def kernel_registry() -> dict:
    """The canonical enumeration of the port's kernels: name -> KernelSpec."""
    specs = [
        KernelSpec("flash_decode", "kernels.flash_attn", "compute", _b_flash_decode),
        KernelSpec("flash_decode_paged", "kernels.paged_kv", "paged",
                   _b_flash_decode_paged(False)),
        KernelSpec("flash_decode_paged_partial", "kernels.paged_kv", "paged",
                   _b_flash_decode_paged(True)),
        KernelSpec("kv_update", "kernels.flash_attn", "compute", _b_kv_update, inplace=(0,)),
        KernelSpec("grouped_gemm", "kernels.group_gemm", "compute", _b_grouped_gemm),
        KernelSpec("swiglu", "kernels.swiglu", "compute", _b_swiglu),
        KernelSpec("gdn_fwd", "kernels.gdn", "compute", _b_gdn),
        KernelSpec("flash_attention", "kernels.flash_attn_train", "compute",
                   _b_flash_attention),
        KernelSpec("allgather_one_shot", "kernels.allgather", "comm",
                   _b_allgather("one_shot"), min_devices=2),
        KernelSpec("allgather_ring", "kernels.allgather", "comm", _b_allgather("ring"),
                   min_devices=2),
        KernelSpec("reduce_scatter_one_shot", "kernels.reduce_scatter", "comm",
                   _b_partials("rs", "one_shot"), min_devices=2),
        KernelSpec("reduce_scatter_ring", "kernels.reduce_scatter", "comm",
                   _b_partials("rs", "ring"), min_devices=2),
        KernelSpec("allreduce_one_shot", "kernels.allreduce", "comm",
                   _b_partials("ar", "one_shot"), min_devices=2),
        KernelSpec("allreduce_two_shot", "kernels.allreduce", "comm",
                   _b_partials("ar", "two_shot"), min_devices=2),
        KernelSpec("ag_gemm", "kernels.allgather_gemm", "comm", _b_ag_gemm, min_devices=2),
        KernelSpec("gemm_rs", "kernels.gemm_reduce_scatter", "comm", _b_gemm_rs,
                   min_devices=2),
        KernelSpec("gemm_ar", "kernels.gemm_allreduce", "comm", _b_gemm_ar, min_devices=2),
        KernelSpec("p2p_shift", "kernels.p2p", "comm", _b_p2p, min_devices=2),
        KernelSpec("all_to_all", "kernels.all_to_all", "comm", _b_all_to_all(False),
                   min_devices=2),
        KernelSpec("low_latency_all_to_all", "kernels.all_to_all", "comm",
                   _b_all_to_all(True), min_devices=2),
        KernelSpec("ep_dispatch_combine", "kernels.ep_a2a", "comm", _b_ep_dispatch_combine,
                   min_devices=2),
        KernelSpec("ep_fused", "kernels.ep_fused", "comm", _b_ep_fused, min_devices=2),
        KernelSpec("ag_group_gemm", "kernels.ag_group_gemm", "comm", _b_ag_group_gemm,
                   min_devices=2),
        KernelSpec("moe_reduce_rs", "kernels.moe_reduce_rs", "comm", _b_moe_reduce("rs"),
                   min_devices=2),
        KernelSpec("moe_reduce_ar", "kernels.moe_reduce_ar", "comm", _b_moe_reduce("ar"),
                   min_devices=2),
        KernelSpec("sp_flash_decode_dist", "kernels.sp_flash_decode", "comm",
                   _b_sp_flash_decode, min_devices=2),
        KernelSpec("kv_cache_scatter", "kernels.sp_flash_decode", "comm", _b_kv_scatter,
                   min_devices=2, inplace=(0,)),
        KernelSpec("sp_ring_shmem", "kernels.sp_attention", "comm", _b_sp_ring,
                   min_devices=2),
    ]
    return {s.name: s for s in specs}
