"""Per-op roofline report: each ported kernel's time on the card against
the least time the card could take (its SOL, tools/perf_model.py).

    python3 -m triton_dist_tpu_torch.tools.perf_report [--json PATH] [--cards 4]

Counterpart of triton_dist_tpu/tools/perf_report.py (`_time`, `chain`,
`_ROW_OF`, `registry_coverage`, `sol_frac_rows`, `run_report`) for the
rows one card runs in the port, at the JAX report's on-chip shapes, bf16:
ag_gemm and gemm_rs at world size 1 (M=256, K=N=4096), flash_decode (B=8,
16 query and 8 kv heads, T=2048, d=128), flash_decode_paged (the same
keys in 128-row pages) and gdn_fwd(pallas) (B=8, H=16, T=2048,
dk=dv=128, C=64). With --cards 4 (a mesh of four cards,
runtime/bootstrap.py make_mesh) it adds the collectives' rows at the JAX
report's shapes in bf16 (`comm_rows`: all_gather of [256, 4096] shards,
all_reduce and reduce_scatter of [4 x 256, 4096] partials, gemm_allreduce
[256, 4096/4] @ [4096/4, 4096], the rings ag_gemm(ring) [256/4, 4096] x 4
@ [4096, 4096/4] and gemm_rs(ring) [256, 4096/4] @ [4096/4, 4096]; the
expert-parallel rows all_to_all and low_latency_all_to_all of [256,
4096] a rank, ep_dispatch_combine of 1024 rows of 1024 over 8 experts,
top-2, and ep_fused, the JAX report's EP_MoE(mode="ep_fused") at E=8,
D=1024, I=512, 1024 rows, top-2, capacity 1.25; the tensor-parallel MoE
rows ag_group_gemm, moe_reduce_rs and moe_reduce_ar at E=8, capT=512,
D=N=1024; the sequence-parallel rows sp_flash_decode(dist) at the
flash_decode row's shape with its 2048 keys split over the cards,
kv_cache_scatter of [8, 8, 2048, 128] blocks into [8, 8, 4096, 128]
windows split over the cards, and the JAX report's sp_ring(ring_shmem)
beside sp_ring(ring) at B=2, 16 query and kv heads, S=256, d=128; the
Ulysses rows ulysses_qkv_gemm_a2a and ulysses_o_a2a_gemm at the JAX
report's B=2, S=2048, D=N=1024; the pipeline rows pp_gpipe_fwd, the JAX
report's tanh stage at D=1024 over 16 microbatches of 64 rows, and
p2p_shift of its [64, 1024] handoff),
against perf_model.collective_sol_us over NVLink plus, for the GEMMs,
one card's share of the product (gemm_sol_us on the per-card dims). Each
row carries its plain version,
so that a caller can hold the op's output at the timed shape against it
(chip_smoke.py does). It needs a card and raises without one: no row is
ever timed on the CPU.
"""

from __future__ import annotations

import argparse
import datetime
import functools
import json
import os
import subprocess
from typing import Callable, NamedTuple

import numpy as np
import torch

from triton_dist_tpu_torch.tools.perf_model import chip_specs, gemm_sol_us, sol_report

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# registry name -> this report's row name, where they differ (the JAX
# report's map)
_ROW_OF = {"gdn_fwd": "gdn_fwd(pallas)", "allgather_one_shot": "all_gather(one_shot)",
           "allgather_ring": "all_gather(ring)", "allreduce_one_shot": "all_reduce(one_shot)",
           "allreduce_two_shot": "all_reduce(two_shot)",
           "reduce_scatter_one_shot": "reduce_scatter", "reduce_scatter_ring": "reduce_scatter",
           "gemm_ar": "gemm_allreduce", "sp_flash_decode_dist": "sp_flash_decode(dist)",
           "sp_ring_shmem": "sp_ring(ring_shmem)"}


def chain(op):
    """A step that threads a data dependence through the timed loop: the
    op's output nudges one element of its input by a negligible amount
    (two tiny launches), so launch i+1 reads what launch i wrote."""
    def step(v):
        out = op(v)
        out = out[0] if isinstance(out, tuple) else out
        # a collective's input and output are lists, one tensor per rank
        for x, o in (zip(v, out) if isinstance(v, list) else [(v, out)]):
            x.view(-1)[:1].add_(o.reshape(-1)[:1].to(x.dtype), alpha=1e-30)
        return v
    return step


def _time(step, x0, *, k1: int = 8, k2: int = 40, reps: int = 3, slopes: int = 3) -> float:
    """Two-point timing: the per-op time is the slope between k1 and k2
    chained launches, each run bracketed by CUDA events, which cancels
    the fixed cost of a run; the best of `reps` runs at each point, and
    one slope from the minima over `slopes` rounds (the JAX harness's
    rule). Returns microseconds."""
    def run(k):
        v = x0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            v = step(v)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    run(k1)                                  # warm-up
    t1s, t2s = [], []
    for _ in range(slopes):
        t1s.append(min(run(k1) for _ in range(reps)))
        t2s.append(min(run(k2) for _ in range(reps)))
    return max((min(t2s) - min(t1s)) / (k2 - k1), 1e-6) * 1e3


def registry_coverage(measured_ops):
    """The report's rows against the port's kernel registry: a registered
    kernel with no row here is listed under `uncovered`."""
    from triton_dist_tpu_torch.kernels import kernel_registry
    measured = set(measured_ops)
    reg = kernel_registry()
    return {"kernels_registered": len(reg),
            "uncovered": sorted(n for n in reg if _ROW_OF.get(n, n) not in measured)}


def sol_frac_rows(report):
    """One `{op}_sol_frac` row per measured op of a run_report() dict."""
    env = report.get("env", {})
    return [{"metric": f"{r['op']}_sol_frac", "value": round(float(r["sol_frac"]), 5),
             "unit": "frac of SOL", "achieved_us": round(float(r["achieved_us"]), 3),
             "sol_us": round(float(r["sol_us"]), 3), "device": env.get("device")}
            for r in report.get("ops", [])]


def _env(spec) -> dict:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    try:
        git = subprocess.run(["git", "-C", _REPO, "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True, timeout=10).stdout.strip()
        dirty = bool(subprocess.run(["git", "-C", _REPO, "status", "--porcelain"],
                                    capture_output=True, text=True,
                                    timeout=10).stdout.strip())
    except (OSError, subprocess.SubprocessError):
        git, dirty = "", False
    return {"device": torch.cuda.get_device_name(0), "card": card,
            "ndev": torch.cuda.device_count(), "chip": spec.name,
            "git": (git + ("+dirty" if dirty else "")) if git else "unknown",
            "date": datetime.datetime.now(datetime.timezone.utc).isoformat(
                timespec="seconds")}


class Row(NamedTuple):
    """One row of the report: `fn(*args)` is one launch of the op at the
    timed shape and `plain(*args)` its plain version on the same inputs;
    the timed loop chains through args[0]."""
    op: str
    fn: Callable
    plain: Callable
    args: tuple
    sol_us: float
    note: str = ""


def report_rows(spec) -> list:
    """The report's rows at the JAX report's on-chip shapes, bf16, their
    inputs drawn on the card from seed 0."""
    from triton_dist_tpu_torch.kernels import (ag_gemm, ag_gemm_ref, flash_decode,
                                               flash_decode_paged, flash_decode_paged_ref,
                                               flash_decode_ref, gdn_chunk_ref, gdn_fwd,
                                               gemm_rs, gemm_rs_ref)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    dt = torch.bfloat16
    rows = []

    def randn(*shape, sc=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * sc).to(dt)

    M, K, N = 256, 4096, 4096
    a, b = randn(M, K), randn(K, N)
    rows.append(Row("ag_gemm", ag_gemm, ag_gemm_ref, (a, b),
                    gemm_sol_us(M, K, N, spec=spec), "world size 1"))
    rows.append(Row("gemm_rs", gemm_rs, gemm_rs_ref, (a, b),
                    gemm_sol_us(M, K, N, spec=spec), "world size 1"))

    B, Hq, Hkv, T, d = 8, 16, 8, 2048, 128
    q = randn(B, 1, Hq, d)
    k, v = randn(B, Hkv, T, d), randn(B, Hkv, T, d)
    kv_us = 2 * B * Hkv * T * d * 2 / (spec.hbm_gbps * 1e9) * 1e6
    rows.append(Row("flash_decode", flash_decode, flash_decode_ref, (q, k, v, T), kv_us))
    pg = 128
    maxp = T // pg
    pk, pv = k.reshape(B * Hkv * maxp, pg, d), v.reshape(B * Hkv * maxp, pg, d)
    table = torch.arange(B * Hkv * maxp, dtype=torch.int32, device=dev).reshape(-1, maxp)
    lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    rows.append(Row("flash_decode_paged",
                    lambda u, pk, pv, t, n: flash_decode_paged(u, pk, pv, t, kv_lens=n),
                    lambda u, pk, pv, t, n: flash_decode_paged_ref(u, pk, pv, t, kv_lens=n),
                    (q, pk, pv, table, lens), kv_us,
                    "same bytes as flash_decode; gap = page-walk overhead"))

    # GDN: q and k rows of unit norm (as the model normalises them), so
    # the delta rule stays a contraction; the JAX report's roofline, data
    # traffic against the chunk products
    Bg, Hg, Tg, dk, dv, C = 8, 16, 2048, 128, 128, 64
    unit = lambda x: (x.float() / x.float().norm(dim=-1, keepdim=True)).to(dt)  # noqa: E731
    qg, kg = unit(randn(Bg, Hg, Tg, dk)), unit(randn(Bg, Hg, Tg, dk))
    vg = randn(Bg, Hg, Tg, dv, sc=0.3)
    gg = -torch.rand(Bg, Hg, Tg, generator=gen, device=dev) * 0.1
    bg = torch.rand(Bg, Hg, Tg, generator=gen, device=dev)
    gdn_bytes = Bg * Hg * Tg * (2 * dk + 2 * dv) * 2
    gdn_flops = 2 * Bg * Hg * Tg * (2 * C * dk + 2 * C * dv + 2 * dk * dv)
    gdn_sol = max(gdn_bytes / (spec.hbm_gbps * 1e9),
                  gdn_flops / (spec.bf16_tflops * 1e12)) * 1e6
    rows.append(Row("gdn_fwd(pallas)", functools.partial(gdn_fwd, chunk=C),
                    functools.partial(gdn_chunk_ref, chunk=C), (qg, kg, vg, gg, bg), gdn_sol))
    return rows


def comm_rows(spec, mesh) -> list:
    """The collectives' rows over `mesh` (the JAX report's shapes, bf16;
    each rank's input on its device), against collective_sol_us: the
    NVLink time of the whole tensor's payload."""
    from triton_dist_tpu_torch import kernels as K
    from triton_dist_tpu_torch.tools.perf_model import collective_sol_us
    n = mesh.size
    gen = torch.Generator(device=mesh.devices[0]).manual_seed(0)
    M, K_, N = 256, 4096, 4096

    def parts(*shape, sc=1.0):
        return [(torch.randn(shape, generator=gen, device=mesh.devices[0]) * sc)
                .to(torch.bfloat16).to(d) for d in mesh.devices]

    full = n * M * N * 2
    shards, partials = parts(M, N), parts(n * M, N, sc=1.0 / n)
    rows = []
    for meth in ("one_shot", "ring"):
        m = K.AllGatherMethod(meth)
        rows.append(Row(f"all_gather({meth})",
                        lambda v, m=m: K.all_gather(v, mesh=mesh, method=m),
                        lambda v: K.all_gather_ref(v), (shards,),
                        collective_sol_us("ag", full, n, spec=spec)))
    for meth in ("one_shot", "two_shot"):
        m = K.AllReduceMethod(meth)
        rows.append(Row(f"all_reduce({meth})",
                        lambda v, m=m: K.all_reduce(v, mesh=mesh, method=m),
                        lambda v, m=m: K.all_reduce_ref(v, method=m), (partials,),
                        collective_sol_us("ar", full, n, spec=spec)))
    rows.append(Row("reduce_scatter", lambda v: K.reduce_scatter(v, mesh=mesh),
                    lambda v: K.reduce_scatter_ref(
                        v, method=K.get_auto_reduce_scatter_method(M * N * 2, n)),
                    (partials,), collective_sol_us("rs", full, n, spec=spec), "auto method"))
    a, b = parts(M, K_ // n), parts(K_ // n, N, sc=(K_ // n) ** -0.5)
    rows.append(Row("gemm_allreduce", lambda u, w: K.gemm_allreduce(u, w, mesh=mesh),
                    lambda u, w: K.gemm_allreduce_ref(u, w), (a, b),
                    gemm_sol_us(M, K_ // n, N, spec=spec)
                    + collective_sol_us("ar", M * N * 2, n, spec=spec)))
    rows.append(Row("gemm_rs(ring)", lambda u, w: K.gemm_rs(u, w, mesh=mesh),
                    lambda u, w: K.gemm_rs_ref(u, w), (a, b),
                    gemm_sol_us(M, K_ // n, N, spec=spec)
                    + collective_sol_us("rs", M * N * 2, n, spec=spec)))
    a_rows, b_cols = parts(M // n, K_), parts(K_, N // n, sc=K_ ** -0.5)
    rows.append(Row("ag_gemm(ring)", lambda u, w: K.ag_gemm(u, w, mesh=mesh),
                    lambda u, w: K.ag_gemm_ref(u, w), (a_rows, b_cols),
                    gemm_sol_us(M, K_, N // n, spec=spec)
                    + collective_sol_us("ag", M * K_ * 2, n, spec=spec)))
    return (rows + ep_rows(spec, mesh, parts) + tp_moe_rows(spec, mesh, parts)
            + sp_rows(spec, mesh, parts) + ulysses_pp_rows(spec, mesh, parts))


def ulysses_pp_rows(spec, mesh, parts) -> list:
    """The Ulysses fused GEMMs at the JAX report's shape (B=2, S=2048,
    D=N=1024, bf16) against one card's share of the product plus the
    all-to-all's NVLink time (the JAX report's SOL); the GPipe forward of
    its tanh stage (D=1024, 16 microbatches of 64 rows) against the ticks
    times one stage's product, the ideal schedule's span; p2p_shift of
    that pipeline's [64, 1024] handoff against one rank's bytes over
    NVLink."""
    from triton_dist_tpu_torch import kernels as K
    from triton_dist_tpu_torch.layers import PPipeline
    from triton_dist_tpu_torch.tools.perf_model import collective_sol_us
    n = mesh.size
    Bu, Su, Du, Nu = 2, 2048, 1024, 1024
    a2a = collective_sol_us("a2a", Bu * Su // n * Nu * 2 * n, n, spec=spec)
    xu = parts(Bu, Su // n, Du, sc=0.1)
    wu = mesh.replicate(parts(Du, Nu, sc=0.1)[0])
    xo = parts(Bu, Su, Nu // n, sc=0.1)
    wo = mesh.replicate(parts(Nu, Du, sc=0.1)[0])
    rows = [Row("ulysses_qkv_gemm_a2a", lambda v, w: K.qkv_gemm_a2a(v, w, mesh=mesh),
                lambda v, w: K.qkv_gemm_a2a([t.cpu() for t in v], [t.cpu() for t in w],
                                            mesh=_cpu_mesh(n)),
                (xu, wu), gemm_sol_us(Bu * Su // n, Du, Nu, spec=spec) + a2a),
            Row("ulysses_o_a2a_gemm", lambda v, w: K.o_a2a_gemm(v, w, mesh=mesh),
                K.o_a2a_gemm_ref, (xo, wo), gemm_sol_us(Bu * Su // n, Nu, Du, spec=spec) + a2a)]
    Mp, Bp, Dp = 4 * max(n, 2), 64, 1024
    g = torch.Generator(device=mesh.devices[0]).manual_seed(1)
    stages = [{"w": (torch.randn(Dp, Dp, generator=g, device=mesh.devices[0]) * Dp ** -0.5)
               .to(torch.bfloat16), "b": (torch.randn(Dp, generator=g, device=mesh.devices[0])
                                          * 0.1).to(torch.bfloat16)} for _ in range(n)]

    def stage(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    pipe = PPipeline.init(stages, stage, mesh=mesh)

    def in_order(v):
        out = []
        for x in v:
            for p in stages:
                x = stage(p, x)
            out.append(x)
        return torch.stack(out)

    xp = (torch.randn(Mp, Bp, Dp, generator=g, device=mesh.devices[0]) * 0.3).to(torch.bfloat16)
    rows.append(Row("pp_gpipe_fwd", lambda v: pipe(v)[0], in_order, (xp,),
                    (Mp + n - 1) * gemm_sol_us(Bp, Dp, Dp, spec=spec),
                    f"M={Mp} microbatches, {Mp + n - 1} ticks; SOL = ideal schedule span"))
    rows.append(Row("p2p_shift", lambda v: K.p2p_shift(v, mesh=mesh), K.p2p_shift_ref,
                    (parts(Bp, Dp),), collective_sol_us("p2p", Bp * Dp * 2, n, spec=spec),
                    "the pipeline's handoff"))
    return rows


def sp_rows(spec, mesh, parts) -> list:
    """The sequence-parallel rows over `mesh` (bf16): sp_flash_decode with
    the "dist" combine against one card's share of the KV read plus the
    partials' all-gather over NVLink; kv_cache_scatter against one
    block's NVLink time; the rings against the causal products shared by
    the cards (the JAX report's SOL, divided over them; the blocks'
    puts hide under the products)."""
    from triton_dist_tpu_torch import kernels as K
    from triton_dist_tpu_torch.tools.perf_model import collective_sol_us
    n = mesh.size
    B, Hq, Hkv, T, d = 8, 16, 8, 2048, 128
    q = mesh.replicate(parts(B, 1, Hq, d)[0])         # the replicated query
    kw, vw = parts(B, Hkv, T // n, d), parts(B, Hkv, T // n, d)
    kv_us = 2 * B * Hkv * T * d * 2 / (spec.hbm_gbps * 1e9) * 1e6 / n
    rows = [Row("sp_flash_decode(dist)",
                lambda u, k_, v_: K.sp_flash_decode(u, k_, v_, T, mesh=mesh, combine="dist"),
                lambda u, k_, v_: K.sp_flash_decode(u, k_, v_, T, mesh=mesh, combine="xla"),
                (q, kw, vw),
                kv_us + collective_sol_us("ag", n * B * Hq * (d + 2) * 4, n, spec=spec))]
    S = 2048
    cache, new = parts(B, Hkv, 2 * S // n, d), parts(B, Hkv, S // n, d)
    rows.append(Row("kv_cache_scatter", lambda c, u: K.kv_cache_scatter(c, u, mesh=mesh),
                    lambda c, u: K.kv_cache_scatter_ref([t.clone() for t in c], u),
                    (cache, new),
                    collective_sol_us("p2p", B * Hkv * S // n * d * 2, n, spec=spec)))
    Bs, Hs, Ss, ds = 2, 16, 256, 128
    qr = parts(Bs, Ss // n, Hs, ds, sc=0.3)
    kr, vr = parts(Bs, Hs, Ss // n, ds, sc=0.3), parts(Bs, Hs, Ss // n, ds, sc=0.3)
    ring_sol = 2 * 2 * Bs * Hs * Ss * Ss * ds / 2 / (spec.bf16_tflops * 1e12) * 1e6 / n

    def plain_ring(u, k_, v_):
        acc, _, l_ = K.ring_attn_ref(u, k_, v_, scale=ds ** -0.5)
        return [(a / x.clamp_min(1e-30)[..., None]).to(u[0].dtype) for a, x in zip(acc, l_)]

    for mode in ("ring_shmem", "ring"):
        rows.append(Row(f"sp_ring({mode})",
                        lambda u, k_, v_, mm=mode: K.sp_ring_attention(u, k_, v_, mesh=mesh,
                                                                       mode=mm),
                        plain_ring, (qr, kr, vr), ring_sol,
                        "latency-bound at this size; compare the two modes"))
    return rows


def tp_moe_rows(spec, mesh, parts) -> list:
    """The tensor-parallel MoE rows over `mesh` at the JAX report's shape
    (E=8 experts, capT=512 rows an expert, D=N=1024, bf16; each rank's
    panel its own columns or rows): ag_group_gemm against one card's share
    of the product plus the gathered tokens' NVLink time, moe_reduce_rs and
    moe_reduce_ar against their share plus the partials' (the JAX report's
    SOL)."""
    from triton_dist_tpu_torch import kernels as K
    from triton_dist_tpu_torch.tools.perf_model import collective_sol_us
    n = mesh.size
    E, capT, Dm, Nm = 8, 512, 1024, 1024
    xe = [t.reshape(E, capT // n, Dm) for t in parts(E * capT // n, Dm, sc=0.1)]
    we = [t.reshape(E, Dm, Nm // n) for t in parts(E * Dm, Nm // n, sc=0.1)]
    he = [t.reshape(E, capT, Nm // n) for t in parts(E * capT, Nm // n, sc=0.1)]
    w2 = [t.reshape(E, Nm // n, Dm) for t in parts(E * Nm // n, Dm, sc=0.1)]
    prod = gemm_sol_us(E * capT, Nm // n, Dm, spec=spec)
    return [Row("ag_group_gemm", lambda u, w: K.ag_group_gemm(u, w, mesh=mesh),
                lambda u, w: K.ag_group_gemm_ref(u, w), (xe, we),
                gemm_sol_us(E * capT, Dm, Nm // n, spec=spec)
                + collective_sol_us("ag", E * capT * Dm * 2, n, spec=spec)),
            Row("moe_reduce_rs", lambda u, w: K.moe_reduce_rs(u, w, mesh=mesh),
                lambda u, w: K.moe_reduce_rs_ref(u, w), (he, w2),
                prod + collective_sol_us("rs", E * capT * Dm * 2, n, spec=spec)),
            Row("moe_reduce_ar", lambda u, w: K.moe_reduce_ar(u, w, mesh=mesh),
                lambda u, w: K.moe_reduce_ar_ref(u, w), (he, w2),
                prod + collective_sol_us("ar", E * capT * Dm * 2, n, spec=spec))]


def _cpu_twin(mesh, fn):
    """fn's plain version: the same call on a mesh of CPU ranks, the
    inputs copied there and the outputs back."""
    cpu = _cpu_mesh(mesh.size)

    def plain(*args):
        out = fn(cpu, *[[t.cpu() for t in a] for a in args])
        return [o.to(d) for o, d in zip(out, mesh.devices)]
    return plain


def ep_rows(spec, mesh, parts) -> list:
    """The expert-parallel rows over `mesh` (bf16; comm_rows's `parts`
    draws each rank's input): the two exchanges against the NVLink time
    of the whole payload; ep_dispatch_combine (route, dispatch, combine,
    no expert) against both exchanges' payload; ep_fused against the
    expert products of its capacity rows on one card's share plus both
    exchanges (the JAX report's SOL)."""
    from triton_dist_tpu_torch import kernels as K
    from triton_dist_tpu_torch.layers import EP_MoE
    from triton_dist_tpu_torch.tools.perf_model import collective_sol_us
    n = mesh.size
    M, N = 256, 4096
    x = parts(M, N)
    full = n * M * N * 2
    rows = [Row("all_to_all", lambda v: K.all_to_all(v, mesh=mesh), K.all_to_all_ref, (x,),
                collective_sol_us("a2a", full, n, spec=spec)),
            Row("low_latency_all_to_all", lambda v: K.low_latency_all_to_all(v, mesh=mesh),
                _cpu_twin(mesh, lambda m, v: K.low_latency_all_to_all(v, mesh=m)), (x,),
                collective_sol_us("a2a", n * M * (N + 4), n, spec=spec), "int8 wire")]
    T, D, E = 1024, 1024, 8
    xt, lg = parts(T // n, D), parts(T // n, E)

    def edc(m, xs, ls):
        ctx = K.create_ep_a2a_context(m, num_experts=E, capacity=T // n * 2)
        return K.ep_dispatch_combine(xs, ls, 2, ctx)

    rows.append(Row("ep_dispatch_combine", lambda u, w: edc(mesh, u, w),
                    _cpu_twin(mesh, edc), (xt, lg),
                    2 * collective_sol_us("a2a", n * n * (T // n * 2) * D * 2, n, spec=spec),
                    "no expert_fn"))
    # ep_fused at the JAX report's shape, weights drawn as it draws them
    rng = np.random.RandomState(7)
    Ee, De, Ie, Te = 8, 1024, 512, 1024
    bf = torch.bfloat16
    w = [torch.from_numpy(a.astype(np.float32)).to(bf) for a in (
        rng.randn(De, Ee) * 0.5, rng.randn(Ee, De, Ie) * De ** -0.5,
        rng.randn(Ee, De, Ie) * De ** -0.5, rng.randn(Ee, Ie, De) * Ie ** -0.5)]
    xe = torch.from_numpy((rng.randn(Te, De) * 0.3).astype(np.float32)).to(bf)
    moe = EP_MoE.init(*[t.to(mesh.devices[0]) for t in w], mesh=mesh, top_k=2,
                      capacity_factor=1.25)
    moe_cpu = EP_MoE.init(*w, mesh=_cpu_mesh(n), top_k=2, capacity_factor=1.25)
    cap_rows = Ee * moe._cap_e(Te // n) * n
    ep_sol = (gemm_sol_us(cap_rows, De, 2 * Ie, spec=spec) + gemm_sol_us(cap_rows, Ie, De,
                                                                         spec=spec)
              + 2 * collective_sol_us("a2a", cap_rows * De * 2, n, spec=spec))
    rows.append(Row("ep_fused", lambda v: moe(v, "ep_fused"),
                    lambda v: [o.to(d) for o, d in zip(moe_cpu([t.cpu() for t in v],
                                                               "ep_fused"), mesh.devices)],
                    (moe._shard(xe.to(mesh.devices[0])),), ep_sol,
                    "EP_MoE(mode='ep_fused')"))
    return rows


def _cpu_mesh(n: int):
    from triton_dist_tpu_torch.runtime import make_mesh
    return make_mesh(n, devices=["cpu"] * n)


def run_report(write_json=None, rows=None, mesh=None) -> dict:
    """Time every row of `rows` (by default report_rows(), and comm_rows()
    over `mesh` when it spans more than one card) on the card; returns
    {"env", "ops", "registry"}."""
    if not torch.cuda.is_available():
        raise RuntimeError("perf_report: needs an NVIDIA card (no CPU rows)")
    spec = chip_specs()
    env = _env(spec)
    out_rows = []
    if rows is None:
        rows = report_rows(spec)
        if mesh is not None and len(mesh.device_groups()) > 1:
            rows += comm_rows(spec, mesh)
    for r in rows:
        x0 = r.args[0]
        x0 = [t.clone() for t in x0] if isinstance(x0, list) else x0.clone()
        t = _time(chain(lambda u, r=r: r.fn(u, *r.args[1:])), x0)
        out_rows.append({"op": r.op, "achieved_us": t, "sol_us": r.sol_us,
                         "sol_frac": r.sol_us / t, "note": r.note})
        print(sol_report(r.op, t, r.sol_us) + (f"  [{r.note}]" if r.note else ""), flush=True)

    out = {"env": env, "ops": out_rows,
           "registry": registry_coverage([r["op"] for r in out_rows])}
    if write_json:
        with open(write_json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {write_json}", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None)
    ap.add_argument("--cards", type=int, default=1,
                    help="with 4: add the collectives' rows over make_mesh(4)")
    args = ap.parse_args()
    mesh = None
    if args.cards > 1:
        from triton_dist_tpu_torch.runtime import make_mesh
        mesh = make_mesh(args.cards)
    report = run_report(args.json, mesh=mesh)
    print(json.dumps(report["env"]), flush=True)


if __name__ == "__main__":
    main()
