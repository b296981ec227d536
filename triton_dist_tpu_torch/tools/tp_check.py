"""Tensor-parallel checks of the port on the card: the six collectives'
kernels against their plain versions, and Qwen3 decode and paged serving
over a mesh of four ranks against the one-rank plain engine.

    python3 -m triton_dist_tpu_torch.tools.tp_check [--cards 4] [--json PATH]

(`--ep`, `--tp-moe`, `--sp` and `--pp` run the expert-parallel,
tensor-parallel MoE, sequence-parallel and pipeline-parallel checks
instead; the last two are in tools/sp_check.py and tools/pp_check.py.)

Without --cards the four ranks are emulated on one card
(`make_mesh(4, devices=["cuda:0"] * 4)`): the same device code, with
every rank's CTAs resident on the one card and peers reached through
plain pointers, so it proves the kernels' arithmetic, signalling and
epochs, but not NVLink peer access nor the ordering of stores across
cards. `--cards 4` runs the same checks on `make_mesh(4)` over cuda:0-3
(peer access enabled between every pair) and raises when fewer than four
cards are visible. It needs a card and raises without one. chip_smoke.py
calls `run` on the emulated mesh.

Checks, each failing the run (tools/checks.py CheckFailed):
- kernel rows: all_reduce (one-shot at the serving tick's 64 rows, two-shot
  at the engine's 128), all_gather and reduce_scatter (both methods) in
  bf16 at the decode shapes, every method in f32 at the registry's
  shapes, all bitwise equal to their plain versions with every rank's
  copy equal, over CALLS calls on fresh inputs; gemm_allreduce at the O
  and down projections (bf16 and int8 panels) within GEMM_AR_LIMIT of its
  plain version (max |d| over max |plain|; tools/fault_margin.py --tp);
  the ag_gemm and gemm_rs rings (the "dist" projections: QKV and gate/up,
  O and down) at the engine's 128 rows, the serving tick's 64 and the
  prefill's 16384, bf16 and int8 panels, and the registry's f32 shapes,
  within AG_GEMM_LIMIT / GEMM_RS_LIMIT of their plain versions; each row
  timed (CUDA events) beside its plain version, one PyTorch call
  where one computes the function, and its bound: the card's memory for
  ranks emulated on one card (each input read once, each output written
  once), NVLink (perf_model.collective_sol_us) across cards;
- engine: Qwen3-1.7B at full width (seeded random weights), B=128 after a
  128-token prompt, Engine(backend="ar", "gemm_ar", "dist" and "mega")
  over the mesh: on "ar"/"gemm_ar" prefill launches no comm kernel (it runs on
  "xla"), decode launches the layers' kernels and its comm kernel, "ar"
  its all_reduce two-shot only (3 x 512 KiB > 1 MiB); on "dist" prefill
  and decode each launch the layers' kernels and exactly two ag_gemm and
  two gemm_rs a layer and forward, and no other comm kernel; the logits,
  teacher-forced, held to the one-rank "xla" engine by the margin rule
  (tools/checks.py, GATE);
- the tensor-parallel megakernel (row 5's TP form, mega_decode.cu's
  mega_decode_tp): one layer at Qwen3-1.7B's widths split over the mesh
  (B=128, pos=200, T=264, the cache past pos at 100x) within
  MEGA_TP_LIMIT of its plain version (max |d y| over 1 + max |plain y|,
  chip_smoke.py's row 5a rule; tools/fault_margin.py --mega-tp), every
  rank's y bitwise equal, the cache rows at pos within one bf16 ulp and
  every other row unchanged; then Engine(backend="mega") over the mesh
  at B=128: prefill on "flash" launches flash_decode, kv_update and
  swiglu alone, decode exactly one TP megakernel launch per layer per
  step per device and nothing else, the logits teacher-forced against the
  one-rank "xla" engine by the margin rule;
- paged serving: ContinuousScheduler(paged=True) at 64 slots on
  "gemm_ar", "ar" and "dist" over the serving traffic's first N_REQ
  requests (tools/checks.py `serving_requests`, chip_smoke.py's traffic);
  admissions launch no comm kernel on "ar"/"gemm_ar" and the two rings
  alone on "dist", ticks launch the backend's comm kernels alone, "ar"
  its all_reduce one-shot only (64 rows), comm_kernel_dispatches > 0;
  then every served stream of the three backends, teacher-forced through
  the one-rank plain engine, by the margin rule.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from triton_dist_tpu_torch.tools.checks import (  # noqa: F401 (GATE: fault_margin.py)
    GATE, check, margin_gate, only_launched, serving_requests, set_capacity, tf_gate)

# gemm_allreduce, ag_gemm and gemm_rs against their plain versions: max
# |d| over max |plain| (tools/fault_margin.py --tp)
GEMM_AR_LIMIT = 2e-2
AG_GEMM_LIMIT = 2e-2
GEMM_RS_LIMIT = 2e-2
# row 5's TP form against its plain version: max |d y| over 1 + max |plain
# y| (tools/fault_margin.py --mega-tp)
MEGA_TP_LIMIT = 1e-2
CALLS = 3                       # fresh-input calls checked per kernel row
WARM_LAUNCHES, WARM_S = 64, 0.01  # idle_share's warm-up step: launches a card, then a wait
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12
B, S, GEN, TF_STEPS = 128, 128, 16, 8
SERVE_B, SERVE_CHUNK, SERVE_MAX_SEQ, PAGE = 64, 16, 224, 16
N_REQ = 16
D, I, HQ, HKV, HD = 2048, 6144, 16, 8, 128

SOURCES = {
    "all_gather": ("triton_dist_tpu_torch/kernels/csrc/allgather.cu",
                   "triton_dist_tpu/kernels/allgather.py:119"),
    "reduce_scatter": ("triton_dist_tpu_torch/kernels/csrc/reduce_scatter.cu",
                       "triton_dist_tpu/kernels/reduce_scatter.py:192"),
    "all_reduce": ("triton_dist_tpu_torch/kernels/csrc/allreduce.cu",
                   "triton_dist_tpu/kernels/allreduce.py:198"),
    "gemm_allreduce": ("triton_dist_tpu_torch/kernels/csrc/gemm_allreduce.cu",
                       "triton_dist_tpu/kernels/gemm_allreduce.py:225"),
    "ag_gemm": ("triton_dist_tpu_torch/kernels/csrc/ag_gemm.cu",
                "triton_dist_tpu/kernels/allgather_gemm.py:341"),
    "gemm_rs": ("triton_dist_tpu_torch/kernels/csrc/gemm_rs.cu",
                "triton_dist_tpu/kernels/gemm_reduce_scatter.py:315"),
    "all_to_all": ("triton_dist_tpu_torch/kernels/csrc/a2a.cu",
                   "triton_dist_tpu/kernels/all_to_all.py:67"),
    "dispatch_a2a": ("triton_dist_tpu_torch/kernels/csrc/a2a.cu",
                     "triton_dist_tpu/kernels/ep_a2a.py:396"),
    "ep_moe_fused": ("triton_dist_tpu_torch/kernels/csrc/ep_fused.cu",
                     "triton_dist_tpu/kernels/ep_fused.py:491"),
    "ag_group_gemm": ("triton_dist_tpu_torch/kernels/csrc/ag_group_gemm.cu",
                      "triton_dist_tpu/kernels/ag_group_gemm.py:285"),
    "moe_reduce_rs": ("triton_dist_tpu_torch/kernels/csrc/moe_reduce_rs.cu",
                      "triton_dist_tpu/kernels/moe_reduce_rs.py:293"),
    "moe_reduce_ar": ("triton_dist_tpu_torch/kernels/csrc/moe_reduce_ar.cu",
                      "triton_dist_tpu/kernels/moe_reduce_ar.py:215"),
    "p2p_shift": ("triton_dist_tpu_torch/kernels/csrc/p2p.cu",
                  "triton_dist_tpu/kernels/p2p.py:48"),
    "mega_decode": ("triton_dist_tpu_torch/kernels/csrc/mega_decode.cu",
                    "triton_dist_tpu/mega/decode_layer.py:462"),
}
# the comm kernels each backend runs (the one-rank GEMM kernel, "gemm",
# runs on none of them at n > 1)
BACKEND_COMM = {"ar": ("all_reduce",), "gemm_ar": ("gemm_allreduce",),
                "dist": ("ag_gemm", "gemm_rs"), "mega": ()}


def sync(mesh) -> None:
    for d, _ in mesh.device_groups():
        torch.cuda.synchronize(d)


def cuda_ms(fn, mesh, reps: int = 20, warmup: int = 3) -> float:
    """Median ms of fn(), one CUDA event pair on rank 0's device each, after
    every device has drained (a collective on rank 0 ends only once its
    peers' data has landed)."""
    dev = mesh.devices[0]
    for _ in range(warmup):
        fn()
    sync(mesh)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.device(dev):
            start.record()
            fn()
            end.record()
        sync(mesh)
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def emulated(mesh) -> bool:
    return len(mesh.device_groups()) == 1


def bound_ms(mesh, op: str, nbytes_io: float, payload: int, flops: float = 0.0,
             flops_per_s: float = BF16_FLOPS_PER_S):
    """(ms, "bytes" | "operations"): on one card the inputs read once and
    the outputs written once over its memory rate, or the operations over
    the peak of their type; across cards the NVLink time of the payload
    (perf_model.collective_sol_us) or one card's share of the operations."""
    from triton_dist_tpu_torch.tools.perf_model import collective_sol_us
    n = mesh.size
    t_ops = flops / flops_per_s * 1e3 / (1 if emulated(mesh) else n)
    if emulated(mesh):
        t_bytes = nbytes_io / HBM_BYTES_PER_S * 1e3
    else:
        t_bytes = collective_sol_us(op, payload, n) / 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def measure(rows, mesh, name, case, fresh, kernel, plain, library, nbytes_io, payload, op,
            tol_rel, flops=0.0, flops_per_s=BF16_FLOPS_PER_S, replicated=True, bound=None):
    """One kernel row, appended to `rows`: fresh() -> inputs; kernel(inputs)
    and plain(inputs) -> per-rank lists, held over CALLS calls on fresh
    inputs. tol_rel None: bitwise, and, where the result is replicated,
    every rank's copy equal to rank 0's; else max |d| over max |plain| per
    rank within tol_rel. Then the kernel, its plain version and the
    library call (None: no PyTorch call computes the function) timed on
    one more fresh input, beside the bound."""
    n = mesh.size
    worst = 0.0
    for _ in range(CALLS):
        args = fresh()
        out, ref = kernel(*args), plain(*args)
        sync(mesh)
        for r in range(n):
            o, p = out[r].to(mesh.devices[0]), ref[r].to(mesh.devices[0])
            if tol_rel is None:
                check(torch.equal(o, p), f"{name} [{case}] rank {r}: not bitwise equal "
                      f"to the plain version (max |d| {(o.float() - p.float()).abs().max()})")
                check(not replicated or torch.equal(o, out[0].to(mesh.devices[0])),
                      f"{name} [{case}]: rank {r}'s copy differs from rank 0's")
            else:
                err = ((o.float() - p.float()).abs().max()
                       / p.float().abs().max().clamp_min(1e-30)).item()
                worst = max(worst, err)
                check(err <= tol_rel, f"{name} [{case}] rank {r}: {err:.3g} of max > "
                      f"{tol_rel}")
    args = fresh()
    b_ms, b_by = bound or bound_ms(mesh, op, nbytes_io, payload, flops, flops_per_s)
    src, rep = SOURCES[name]
    r = dict(name=name, case=case + (" (4 ranks emulated on one card)" if emulated(mesh)
                                     else f" ({n} cards)"),
             route="cuda", source=src, replaces=rep, launches=None, max_abs_err=worst,
             tol=tol_rel if tol_rel is not None else 0.0,
             ms=cuda_ms(lambda: kernel(*args), mesh),
             plain_ms=cuda_ms(lambda: plain(*args), mesh, reps=5),
             bound_ms=b_ms, bound_by=b_by,
             library_ms=None if library is None else cuda_ms(lambda: library(*args), mesh))
    rows.append(r)
    gap = "bitwise" if tol_rel is None else f"{worst:.3g} of max"
    print(f"kernel {name} [{r['case']}]: {gap} over {CALLS} calls, ms {r['ms']:.4f} "
          f"plain_ms {r['plain_ms']:.4f} library_ms "
          f"{r['library_ms'] if library is None else round(r['library_ms'], 4)} bound_ms "
          f"{b_ms:.4f} ({b_by})", flush=True)


def kernel_rows(mesh, seed: int = 0) -> list:
    """The kernel rows (launches left None for the caller), each held to
    its plain version over CALLS calls on fresh inputs."""
    from triton_dist_tpu_torch import kernels as K
    n = mesh.size
    gen = torch.Generator(device=mesh.devices[0]).manual_seed(seed)
    rows = []

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        t = torch.randn(shape, generator=gen, device=mesh.devices[0], dtype=torch.float32)
        return (t * scale).to(dtype)

    def parts(shape, dtype, scale=1.0):
        return [randn(*shape, dtype=dtype, scale=scale).to(d) for d in mesh.devices]

    def row(*args, **kw):
        measure(rows, mesh, *args, **kw)

    one = emulated(mesh)
    if not one:
        import torch.cuda.comm as comm      # the library yardsticks across cards
    f32, bf16 = torch.float32, torch.bfloat16
    # all_reduce: the serving tick's 64 rows (one-shot), the engine's 128
    # (two-shot), and both at the registry's f32 [8n, 128]
    ar_cases = [("one_shot", SERVE_B, D, bf16), ("two_shot", B, D, bf16),
                ("one_shot", 8 * n, 128, f32), ("two_shot", 8 * n, 128, f32)]
    for meth, M, cols, dt in ar_cases:
        method = K.AllReduceMethod(meth)
        es = torch.finfo(dt).bits // 8
        lib = (None if one else
               (lambda *xs: comm.reduce_add(list(xs), destination=mesh.devices[0].index)))
        row("all_reduce", f"{meth} [{M}, {cols}] {str(dt)[6:]}",
            lambda M=M, cols=cols, dt=dt: parts((M, cols), dt),
            lambda *xs, m=method: K.all_reduce(list(xs), mesh=mesh, method=m),
            lambda *xs, m=method: K.all_reduce_ref(list(xs), method=m), lib,
            2 * n * M * cols * es, M * cols * es, "ar", None)
    # all_gather: the engine's [128, 2048] from [128/n, 2048] shards; the
    # registry's [8, 128] f32 shards
    for meth, m_, cols, dt in (("one_shot", B // n, D, bf16), ("ring", B // n, D, bf16),
                               ("one_shot", 8, 128, f32), ("ring", 8, 128, f32)):
        method = K.AllGatherMethod(meth)
        es = torch.finfo(dt).bits // 8
        lib = ((lambda *xs: torch.cat(xs)) if one else
               (lambda *xs: comm.gather(list(xs), destination=mesh.devices[0].index)))
        row("all_gather", f"{meth} shards [{m_}, {cols}] {str(dt)[6:]}",
            lambda m_=m_, cols=cols, dt=dt: parts((m_, cols), dt),
            lambda *xs, m=method: K.all_gather(list(xs), mesh=mesh, method=m),
            lambda *xs: K.all_gather_ref(list(xs)), lib,
            (n * m_ + n * n * m_) * cols * es, n * m_ * cols * es, "ag", None)
    # reduce_scatter: the engine's [128, 2048] partials; the registry's
    # [8n, 128] f32
    for meth, M, cols, dt in (("one_shot", B, D, bf16), ("ring", B, D, bf16),
                              ("one_shot", 8 * n, 128, f32), ("ring", 8 * n, 128, f32)):
        method = K.ReduceScatterMethod(meth)
        es = torch.finfo(dt).bits // 8
        row("reduce_scatter", f"{meth} [{M}, {cols}] {str(dt)[6:]}",
            lambda M=M, cols=cols, dt=dt: parts((M, cols), dt),
            lambda *xs, m=method: K.reduce_scatter(list(xs), mesh=mesh, method=m),
            lambda *xs, m=method: K.reduce_scatter_ref(list(xs), method=m), None,
            (n * M + M) * cols * es, M * cols * es, "rs", None, replicated=False)
    # gemm_allreduce: the O projection [M, Hq*hd/n] @ [Hq*hd/n, D] and the
    # down projection [M, I/n] @ [I/n, D], M = 128 (engine) and 64 (serving),
    # bf16 and int8 panels; the registry's f32 [8, 128/n] @ [128/n, 128]
    for M, k_loc, what in ((B, HQ * HD // n, "o_proj"), (B, I // n, "down"),
                           (SERVE_B, HQ * HD // n, "o_proj"), (SERVE_B, I // n, "down")):
        for wt in ("bf16", "int8"):
            def fresh(M=M, k_loc=k_loc, wt=wt):
                a = parts((M, k_loc), bf16)
                w = [randn(k_loc, D, scale=k_loc ** -0.5) for _ in range(n)]
                if wt == "int8":
                    w = [K.quantize_int8(x) for x in w]
                w = [K.QuantW(q=x.q.to(d), s=x.s.to(d)) if wt == "int8" else x.to(d)
                     for x, d in zip(w, mesh.devices)]
                return a, w
            lib = None
            if wt == "bf16":
                # one product over the concatenated shards (rank 0's device)
                def lib(a, w):
                    return torch.cat([x.to(mesh.devices[0]) for x in a], 1) @ torch.cat(
                        [x.to(mesh.devices[0]) for x in w], 0)
            wbytes = k_loc * D * (2 if wt == "bf16" else 1) + (4 * D if wt == "int8" else 0)
            row("gemm_allreduce", f"{what} M={M} K={k_loc}x{n} N={D} {wt}", fresh,
                lambda a, w: K.gemm_allreduce(a, w, mesh=mesh),
                lambda a, w: K.gemm_allreduce_ref(a, w), lib,
                n * (M * k_loc * 2 + wbytes + M * D * 2), M * D * 2, "ar", GEMM_AR_LIMIT,
                flops=2.0 * M * k_loc * n * D)
    # ag_gemm and gemm_rs: the "dist" projections at the engine's decode
    # rows, the serving tick's and the prefill's (B*S), bf16 and int8
    # panels; ag_gemm QKV [M/n, D] x n @ [D, (Hq + 2 Hkv) hd / n] and gate/up
    # [D, 2I/n], gemm_rs O [M, Hq hd / n] @ [., D] and down [M, I/n] @ [., D]
    def weights(k_, n_, wt):
        w = [randn(k_, n_, scale=k_ ** -0.5) for _ in range(n)]
        return [K.QuantW(q=x.q.to(d), s=x.s.to(d)) if wt == "int8" else x.to(d)
                for x, d in zip([K.quantize_int8(x) if wt == "int8" else x for x in w],
                                mesh.devices)]

    def cat_lib(dim_a, dim_b):
        def lib(a, w):
            return torch.cat([x.to(mesh.devices[0]) for x in a], dim_a) @ torch.cat(
                [x.to(mesh.devices[0]) for x in w], dim_b)
        return lib

    for M in (B, SERVE_B, B * S):
        for what, n_loc in (("qkv", (HQ + 2 * HKV) * HD // n), ("gate_up", 2 * I // n)):
            for wt in ("bf16", "int8"):
                wbytes = D * n_loc * (2 if wt == "bf16" else 1) + (4 * n_loc if wt == "int8"
                                                                    else 0)
                row("ag_gemm", f"{what} M={M} K={D} N={n_loc}x{n} {wt}",
                    lambda M=M, n_loc=n_loc, wt=wt: (parts((M // n, D), bf16),
                                                      weights(D, n_loc, wt)),
                    lambda a, w: K.ag_gemm(a, w, mesh=mesh),
                    lambda a, w: K.ag_gemm_ref(a, w),
                    # one rank's product: the gathered rows times its shard
                    (lambda a, w: torch.cat([x.to(mesh.devices[0]) for x in a]) @ w[0])
                    if wt == "bf16" else None,
                    n * (M // n * D * 2 + wbytes + M * n_loc * 2), M * D * 2, "ag",
                    AG_GEMM_LIMIT, flops=2.0 * M * D * n_loc * n)
        for what, k_loc in (("o_proj", HQ * HD // n), ("down", I // n)):
            for wt in ("bf16", "int8"):
                wbytes = k_loc * D * (2 if wt == "bf16" else 1) + (4 * D if wt == "int8" else 0)
                row("gemm_rs", f"{what} M={M} K={k_loc}x{n} N={D} {wt}",
                    lambda M=M, k_loc=k_loc, wt=wt: (parts((M, k_loc), bf16),
                                                      weights(k_loc, D, wt)),
                    lambda a, w: K.gemm_rs(a, w, mesh=mesh),
                    lambda a, w: K.gemm_rs_ref(a, w),
                    cat_lib(1, 0) if wt == "bf16" else None,
                    n * (M * k_loc * 2 + wbytes + M // n * D * 2), M * D * 2, "rs",
                    GEMM_RS_LIMIT, flops=2.0 * M * k_loc * n * D)
    # the registry's f32 shapes
    row("ag_gemm", f"registry [8x{n}, 128] @ [128, 32x{n}] f32",
        lambda: (parts((8, 128), f32, 0.1), parts((128, 32), f32, 0.1)),
        lambda a, w: K.ag_gemm(a, w, mesh=mesh), lambda a, w: K.ag_gemm_ref(a, w), None,
        n * (8 * 128 + 128 * 32 + 8 * n * 32) * 4, 8 * n * 128 * 4, "ag", AG_GEMM_LIMIT,
        flops=2.0 * 8 * n * 128 * 32 * n, flops_per_s=F32_FLOPS_PER_S)
    row("gemm_rs", f"registry [8x{n}, {128 // n}x{n}] @ [., 128] f32",
        lambda: (parts((8 * n, 128 // n), f32, 0.1), parts((128 // n, 128), f32, 0.1)),
        lambda a, w: K.gemm_rs(a, w, mesh=mesh), lambda a, w: K.gemm_rs_ref(a, w), None,
        n * (8 * n * 128 // n + 128 // n * 128 + 8 * 128) * 4, 8 * n * 128 * 4, "rs",
        GEMM_RS_LIMIT, flops=2.0 * 8 * n * 128 * 128, flops_per_s=F32_FLOPS_PER_S)
    row("gemm_allreduce", f"registry [8, {128 // n}x{n}] @ [., 128] f32",
        lambda: (parts((8, 128 // n), f32, 0.1), parts((128 // n, 128), f32, 0.1)),
        lambda a, w: K.gemm_allreduce(a, w, mesh=mesh),
        lambda a, w: K.gemm_allreduce_ref(a, w), None,
        n * (8 * 128 // n + 128 // n * 128 + 8 * 128) * 4, 8 * 128 * 4, "ar", GEMM_AR_LIMIT,
        flops=2.0 * 8 * 128 * 128, flops_per_s=F32_FLOPS_PER_S)
    return rows


def mega_full_layer(gen, dev, B_=B, pos=200, T=264, D_=D, F_=I, Hq=HQ, Hkv=HKV, hd=HD):
    """Row 5's inputs at Qwen3-1.7B's widths: the layer's weight dict (f32
    norms, bf16 panels, the rope rows at pos), x [B, D] f32 and the caches
    [B, Hkv, T, hd] bf16, the positions past pos at 100x, drawn from gen
    (chip_smoke.py's row 5a draws them in this order)."""
    from triton_dist_tpu_torch.layers import precompute_rope

    def rn(*shape, sc=1.0):
        return torch.randn(shape, generator=gen, device=dev) * sc

    w = dict(w_ln1=1 + 0.1 * rn(1, D_), q_norm=1 + 0.1 * rn(1, hd),
             k_norm=1 + 0.1 * rn(1, hd), w_ln2=1 + 0.1 * rn(1, D_),
             w_qkv=rn(D_, (Hq + 2 * Hkv) * hd, sc=D_ ** -0.5).bfloat16(),
             w_o=rn(Hq * hd, D_, sc=(Hq * hd) ** -0.5).bfloat16(),
             w_gu=rn(D_, 2 * F_, sc=D_ ** -0.5).bfloat16(),
             w_d=rn(F_, D_, sc=F_ ** -0.5).bfloat16())
    cos, sin = precompute_rope(hd, 4096, device=dev)
    w.update(cos_row=cos[pos:pos + 1], sin_row=sin[pos:pos + 1])
    x = rn(B_, D_)
    ck = rn(B_, Hkv, T, hd).bfloat16()
    cv = rn(B_, Hkv, T, hd).bfloat16()
    ck[:, :, pos + 1:] *= 100
    cv[:, :, pos + 1:] *= 100
    return w, x, ck, cv, (cos, sin)


def mega_tp_split(mesh, w, ck, cv, T: int):
    """The full layer split over the mesh, as Engine(backend="mega") splits
    a model (the JAX engine's contiguous column split of the packed
    [q | k | v] and [gate | up] panels, row split of w_o and w_d; kv heads
    by rank): (the TP MegaDecodeLayer, each rank's weight dict, each rank's
    k and v caches), rank r's on its device."""
    from triton_dist_tpu_torch.layers.common import split_packed, split_rows
    from triton_dist_tpu_torch.mega import MegaDecodeLayer
    n = mesh.size
    hd, Hkv = ck.shape[3], ck.shape[1]
    Hq, F_ = w["w_o"].shape[0] // hd, w["w_d"].shape[0]
    qkv = split_packed(w["w_qkv"], (Hq * hd, Hkv * hd, Hkv * hd), n)
    gu = split_packed(w["w_gu"], (F_, F_), n)
    wo, wd = split_rows(w["w_o"], n), split_rows(w["w_d"], n)
    h = Hkv // n
    ws, cks, cvs = [], [], []
    for r, d in enumerate(mesh.devices):
        ws.append(dict({k: w[k].to(d) for k in ("w_ln1", "q_norm", "k_norm", "w_ln2",
                                                 "cos_row", "sin_row")},
                       w_qkv=qkv[r].to(d).contiguous(), w_o=wo[r].to(d).contiguous(),
                       w_gu=gu[r].to(d).contiguous(), w_d=wd[r].to(d).contiguous()))
        cks.append(ck[:, r * h:(r + 1) * h].to(d).contiguous())
        cvs.append(cv[:, r * h:(r + 1) * h].to(d).contiguous())
    layer = MegaDecodeLayer(d_model=w["w_o"].shape[1], n_heads=Hq // n, n_kv_heads=h,
                            head_dim=hd, ffn=F_ // n, T=T, tp=n, mesh=mesh)
    return layer, ws, cks, cvs


def mega_tp_per_op(mesh, w, rope, pos: int, mode: str = "gemm_ar"):
    """The port's per-op layer over the mesh on `mode` (TP_Attn and TP_MLP
    split as to_mesh splits them), on the same weights: fn(xs, cks, cvs)
    -> each rank's output, the yardstick of the TP megakernel layer."""
    from triton_dist_tpu_torch.layers import TP_Attn, TP_MLP, rms_norm
    hd = w["q_norm"].shape[1]
    attn = TP_Attn(w_qkv=w["w_qkv"], w_o=w["w_o"], q_norm=w["q_norm"].reshape(-1),
                   k_norm=w["k_norm"].reshape(-1), n_heads=w["w_o"].shape[0] // hd,
                   n_kv_heads=(w["w_qkv"].shape[1] // hd - w["w_o"].shape[0] // hd) // 2,
                   head_dim=hd).to_mesh(mesh)
    mlp = TP_MLP(w_gate_up=w["w_gu"], w_down=w["w_d"]).to_mesh(mesh)
    ln1 = mesh.replicate(w["w_ln1"].reshape(-1))
    ln2 = mesh.replicate(w["w_ln2"].reshape(-1))
    coss, sins = mesh.replicate(rope[0]), mesh.replicate(rope[1])

    def fn(xs, cks, cvs):
        xb = [x.bfloat16() for x in xs]
        a, _ = attn.fwd_cached([rms_norm(x, g) for x, g in zip(xb, ln1)], coss, sins,
                               xs[0].shape[0], list(zip(cks, cvs)), pos, mode)
        x2 = [x + ar for x, ar in zip(xb, a)]
        y = mlp([rms_norm(x, g) for x, g in zip(x2, ln2)], mode)
        return [x + yr for x, yr in zip(x2, y)]
    return fn


def mega_tp_bytes(w, B_: int, pos: int, n: int, Hkv: int, hd: int) -> int:
    """Row 5's TP form: each input read once, each output written once:
    the weights (the ranks' shards together), K/V of the keys walked,
    every rank's x and y, and of each all-reduce section the n f32
    partials in and the n sums out (as the all_reduce rows count a
    collective; the slots the one-shot pushes are its own traffic)."""
    n_params = sum(w[k].numel() for k in ("w_qkv", "w_o", "w_gu", "w_d"))
    D_ = w["w_o"].shape[1]
    return (2 * n_params + 2 * n * B_ * D_ * 4 + 2 * B_ * Hkv * (pos + 1) * hd * 2
            + 2 * 2 * n * B_ * D_ * 4)


def mega_tp_gaps(ys, ys_ref, cks, cvs, ck0, cv0, ck_ref, cv_ref, pos: int, label: str):
    """Row 5's TP checks (one call's outputs): every rank's y bitwise equal
    to rank 0's; the new cache rows within one bf16 ulp of the plain
    version's largest; every other row unchanged. Returns the gap, max |d
    y| over 1 + max |plain y| (the worst rank)."""
    dev = ys[0].device
    for r, y in enumerate(ys):
        check(torch.equal(y.to(dev), ys[0]), f"{label}: rank {r}'s y differs from rank 0's")
    gap = max(((y.to(dev) - yr.to(dev)).abs().max()
               / (1 + yr.to(dev).abs().max())).item() for y, yr in zip(ys, ys_ref))
    k, v = (torch.cat([t.to(dev) for t in ts], 1) for ts in (cks, cvs))
    kr, vr = (torch.cat([t.to(dev) for t in ts], 1) for ts in (ck_ref, cv_ref))
    other = torch.arange(k.shape[2], device=dev) != pos
    new = max((a[:, :, pos].float() - b[:, :, pos].float()).abs().max().item()
              for a, b in ((k, kr), (v, vr)))
    top = max(b[:, :, pos].float().abs().max().item() for b in (kr, vr))
    check(new <= 2 ** -7 * top, f"{label}: new K/V rows {new} > one bf16 ulp of {top}")
    changed = int(((k != ck0) | (v != cv0))[:, :, other].sum())
    check(changed == 0, f"{label}: {changed} other cache entries changed")
    return gap


def device_ms(fn, mesh, symbol: str, reps: int = 10) -> float:
    """Mean device ms of one record of the kernels whose name holds
    `symbol` over reps calls of fn() under torch.profiler: the kernel's
    own time, without the host work around its launch (on n cards, a
    card's)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync(mesh)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync(mesh)
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA and symbol in e.key]
    check(bool(ev), f"device_ms: the profile holds no {symbol} kernel")
    return sum(e.self_device_time_total for e in ev) / sum(e.count for e in ev) / 1e3


def mega_tp_row(mesh, seed: int = 0, inputs=None, pos: int = 200) -> dict:
    """Row 5's TP form held to its plain version (the checks of
    mega_tp_gaps, within MEGA_TP_LIMIT of 1 + max |plain y|), then timed
    beside its plain version and the port's per-op "gemm_ar" layer on the
    same shards; launches left None. inputs: mega_full_layer's (w, x, ck,
    cv, rope) with w's rope rows at pos, checked in one call; else CALLS
    calls on fresh ones at the engine's decode shape (B=128, T=264). ms is
    the event pair around the wrapper's call, device_ms the kernel's own
    time."""
    from triton_dist_tpu_torch.mega import mega_decode_layer_ref
    dev0 = mesh.devices[0]
    gen = torch.Generator(device=dev0).manual_seed(seed)
    n, T = mesh.size, 264
    gap = err = 0.0
    tol = float("inf")
    for _ in range(1 if inputs else CALLS):
        w, x, ck, cv, rope = inputs or mega_full_layer(gen, dev0, pos=pos, T=T)
        T = ck.shape[2]
        layer, ws, cks, cvs = mega_tp_split(mesh, w, ck, cv, T)
        ck0 = torch.cat([t.to(dev0) for t in cks], 1)
        cv0 = torch.cat([t.to(dev0) for t in cvs], 1)
        kr, vr = [t.clone() for t in cks], [t.clone() for t in cvs]
        xs = mesh.replicate(x)
        ys, _, _ = layer(xs, pos, ws, cks, cvs)
        ys_ref, _, _ = mega_decode_layer_ref(xs, pos, ws, kr, vr, n_heads=layer.n_heads,
                                             n_kv_heads=layer.n_kv_heads,
                                             head_dim=layer.head_dim, tp=n)
        sync(mesh)
        g = mega_tp_gaps(ys, ys_ref, cks, cvs, ck0, cv0, kr, vr, pos, "mega_decode tp")
        check(g <= MEGA_TP_LIMIT, f"mega_decode tp: gap {g} > {MEGA_TP_LIMIT}")
        gap = max(gap, g)
        err = max(err, max((y.to(dev0) - yr.to(dev0)).abs().max().item()
                           for y, yr in zip(ys, ys_ref)))
        tol = min(tol, MEGA_TP_LIMIT * (1 + max(yr.abs().max().item() for yr in ys_ref)))
    Bx, hd, Hkv = x.shape[0], ck.shape[3], ck.shape[1]
    Hq = w["w_o"].shape[0] // hd
    per_op = mega_tp_per_op(mesh, w, rope, pos)
    nbytes = mega_tp_bytes(w, Bx, pos, n, Hkv, hd)
    flops = 2.0 * Bx * sum(w[k].numel() for k in ("w_qkv", "w_o", "w_gu", "w_d")) \
        + 4.0 * hd * Hq * Bx * (pos + 1)
    if emulated(mesh):
        b_ms, b_by = max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                         (flops / BF16_FLOPS_PER_S * 1e3, "operations"))
    else:
        from triton_dist_tpu_torch.tools.perf_model import collective_sol_us
        b_ms, b_by = max((nbytes / n / HBM_BYTES_PER_S * 1e3, "bytes"),
                         (2 * collective_sol_us("ar", Bx * w["w_o"].shape[1] * 4, n) / 1e3,
                          "bytes"),
                         (flops / n / BF16_FLOPS_PER_S * 1e3, "operations"))
    src, rep = SOURCES["mega_decode"]

    def call():
        return layer(xs, pos, ws, cks, cvs)

    r = dict(name="mega_decode/tp",
             case=f"TP form B={Bx} pos={pos} T={T} bf16, D={w['w_o'].shape[1]} "
                  f"F/{n}={w['w_d'].shape[0] // n} Hq/{n}={Hq // n} Hkv/{n}={Hkv // n}"
                  + (f" ({n} ranks emulated on one card)" if emulated(mesh)
                     else f" ({n} cards)"),
             route="cuda", source=src, replaces=rep, launches=None, max_abs_err=err,
             tol=tol, gap=gap, ms=cuda_ms(call, mesh),
             device_ms=device_ms(call, mesh, "mega_tp_kernel"),
             plain_ms=cuda_ms(lambda: mega_decode_layer_ref(
                 xs, pos, ws, kr, vr, n_heads=layer.n_heads, n_kv_heads=layer.n_kv_heads,
                 head_dim=hd, tp=n), mesh, reps=5),
             bound_ms=b_ms, bound_by=b_by, library_ms=None,
             per_op_layer_ms=cuda_ms(lambda: per_op(xs, kr, vr), mesh))
    print(f"kernel mega_decode/tp [{r['case']}]: max_abs_err {err:.3g} (tol {tol:.3g}), gap "
          f"{gap:.3g} of 1 + max (limit {MEGA_TP_LIMIT}) over {1 if inputs else CALLS} "
          f"call(s), every rank's y bitwise equal; ms {r['ms']:.4f} device_ms "
          f"{r['device_ms']:.4f} plain_ms {r['plain_ms']:.4f} per-op gemm_ar layer ms "
          f"{r['per_op_layer_ms']:.4f} bound_ms {b_ms:.4f} ({b_by})", flush=True)
    return r


def idle_share(fn, steps: int, wall_s: float, label: str, devices: int = 1,
               expect=None):
    """torch.profiler over fn() (steps decode steps), one window: the
    devices' busy ms per step, summed over `devices` cards, against the
    timed run's wall ms per step; the idle share on one card (None on
    several, where device time holds waits on peers). The window is
    complete when it holds a device record for each kernel launch call it
    recorded on the host and, for each (symbol, count) in `expect`,
    exactly count records of kernels whose name holds symbol; an
    incomplete window is reported and gives None (not measured). A
    warm-up step runs first with the tracer on and its records dropped: a
    window traced from a cold start lost the records of its first
    launches (chip_smoke.py's later phases, 31-52 of 52-11,000)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    def drain():
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        for d in range(torch.cuda.device_count()):
            for _ in range(WARM_LAUNCHES):
                torch.zeros(1, device=f"cuda:{d}")
        drain()
        time.sleep(WARM_S)
        prof.step()
        fn()
        drain()
    ev = prof.key_averages()
    # the step's own span on the device timeline is no work
    dev = [e for e in ev if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.key.startswith("ProfilerStep")]
    kernels = sum(e.count for e in dev if not e.key.startswith(("Memcpy", "Memset")))
    calls = sum(e.count for e in ev if e.device_type != torch.autograd.DeviceType.CUDA
                and e.key.startswith(("cudaLaunch", "cuLaunch")) and "Kernel" in e.key)
    got = {sym: sum(e.count for e in dev if sym in e.key) for sym in (expect or {})}
    busy = sum(e.self_device_time_total for e in dev) / 1e3 / steps
    if kernels < calls or any(got[sym] != n for sym, n in (expect or {}).items()):
        print(f"profile {label}: window incomplete, {kernels} kernel records for {calls} "
              f"launch calls, {got} of {expect}: idle share not measured; "
              f"{lost_launches(prof)}", flush=True)
        return None
    # on several cards a collective's device time holds its wait for peers
    # that the one host thread has not launched yet: busy is then no work
    idle = 1 - busy / devices / (wall_s * 1e3) if devices == 1 else None
    print(f"profile {label}: device busy {busy:.3f} ms per step of {wall_s * 1e3:.3f} ms "
          f"wall, summed over {devices} card(s) ({share(idle)} idle"
          f"{'' if devices == 1 else ': the device time holds waits on peers'}), "
          f"{sum(e.count for e in dev) // steps} device records per step, {kernels} kernel "
          f"records for {calls} launch calls", flush=True)
    return idle


def lost_launches(prof, most: int = 3) -> str:
    """The launch calls of a profile that have no kernel record (matched
    by correlation id in its trace): each one's place among the window's
    launches, its offset in the window and the ops that made it."""
    import json
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/trace.json"
        prof.export_chrome_trace(path)
        with open(path) as f:
            ev = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    kernels = {e["args"].get("correlation") for e in ev if e.get("cat") == "kernel"}
    calls = sorted((e for e in ev if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and e["name"].startswith(("cudaLaunch", "cuLaunch"))
                    and "Kernel" in e["name"]), key=lambda e: e["ts"])
    t0 = min(e["ts"] for e in ev)
    out = []
    for i, e in enumerate(calls):
        if e["args"].get("correlation") not in kernels and len(out) < most:
            ops = [o["name"] for o in ev if o.get("cat") == "cpu_op"
                   and o["args"].get("External id") == e["args"].get("External id")]
            out.append(f"launch {i} of {len(calls)} ({e['name']}, +{e['ts'] - t0:.0f} us, "
                       f"ops {ops[:3]})")
    return "no kernel record for " + ("; ".join(out) if out else "none by correlation")


def share(v) -> str:
    """An idle share for a line of output."""
    return "not measured" if v is None else f"{v:.1%}"


def engine_check(m, k, mesh, ref_model, model, ids, backend: str, card: str) -> dict:
    """Engine(backend) over the mesh: launch counts around prefill and
    decode, ms/step, then the logits teacher-forced against the one-rank
    plain engine."""
    eng = m.Engine(model, max_seq=S + GEN + 8, backend=backend, device=mesh.devices[0])
    eng.decode(*eng.prefill(ids), 2)                 # warm-up
    sync(mesh)
    k.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = eng.prefill(ids)
    sync(mesh)
    prefill_s = time.perf_counter() - t0
    c_prefill = k.launch_counts()
    k.reset_launch_counts()
    t0 = time.perf_counter()
    toks = eng.decode(logits, cache, GEN)
    sync(mesh)
    decode_s = time.perf_counter() - t0
    c_decode = k.launch_counts()
    by_method = k.method_counts()
    comm = BACKEND_COMM[backend]
    path = ("flash_decode", "kv_update", "swiglu") + comm
    # a collective counts one launch per distinct device of the mesh
    per_call = len(mesh.device_groups())
    L = model.config.num_layers
    if backend == "mega":
        # prefill on "flash" (its psum the plain version's); each decode
        # step one TP megakernel launch per layer and device, and nothing else
        only_launched(c_prefill, path, "tp mega prefill (on flash)")
        for name in path:
            check(c_prefill[name] > 0, f"tp mega: prefill launched no {name} ({c_prefill})")
        want = L * GEN * per_call
        check(c_decode["mega_decode"] == want and by_method.get("mega_decode tp") == want,
              f"tp mega: decode launched mega_decode {c_decode['mega_decode']} times "
              f"({by_method}); want {want}, all of the TP form")
        path = ("mega_decode",)
    elif backend == "dist":
        # prefill through the rings too: two ag_gemm and two gemm_rs a
        # layer and forward
        want = 2 * L * per_call
        for name in comm:
            check(c_prefill[name] == want and c_decode[name] == want * GEN,
                  f"tp dist: {name} launched {c_prefill[name]} times in prefill, "
                  f"{c_decode[name]} in decode; want {want} and {want * GEN}")
        only_launched(c_prefill, path, "tp dist prefill")
    elif backend != "mega":
        only_launched(c_prefill, (), f"tp {backend} prefill (on xla)")
    for name in path:
        check(c_decode[name] > 0, f"tp {backend}: {name} did not run in decode ({c_decode})")
    only_launched(c_decode, path, f"tp {backend} decode")
    if backend == "ar":
        # [128, 2048] bf16: 3 x 512 KiB > 1 MiB, the auto rule's two-shot
        only_launched(by_method, ("all_reduce two_shot",), "tp ar decode (methods)")
    check(tuple(toks.shape) == (B, GEN), f"tp {backend}: tokens {tuple(toks.shape)}")
    step_ms = decode_s * 1e3 / GEN
    print(f"engine tp={mesh.size} {backend} on {card}: prefill {prefill_s * 1e3:.1f} ms "
          f"(B={B}, S={S}, on {eng.prefill_backend}), decode {GEN} steps {decode_s * 1e3:.1f} ms "
          f"({step_ms:.2f} ms/step); launches prefill {c_prefill} decode {c_decode} "
          f"{by_method}", flush=True)
    ref = m.Engine(ref_model, max_seq=S + GEN + 8, backend="xla", device=mesh.devices[0])
    lf, cf = eng.prefill(ids)
    lr, cr = ref.prefill(ids)
    forced, errs = 0, []
    for t in range(TF_STEPS + 1):
        err, _, n_sure = margin_gate(lf, lr, f"tp {backend} step {t}")
        errs.append(err / lr.abs().max().item())
        forced += n_sure
        if t == TF_STEPS:
            break
        lf = eng.decode_step(toks[:, t], cf)
        lr = ref.decode_step(toks[:, t], cr)
    # the mega window's kernels are known exactly: one TP launch a layer,
    # step and device
    idle = idle_share(lambda: [eng.decode_step(toks[:, t], cf) for t in range(TF_STEPS,
                                                                               TF_STEPS + 2)],
                      2, decode_s / GEN, f"tp {backend} decode", len(mesh.device_groups()),
                      {"mega_tp_kernel": 2 * L * per_call} if backend == "mega" else None)
    print(f"engine tp={mesh.size} {backend}: teacher-forced vs one-rank xla, prefill and "
          f"{TF_STEPS} steps: max|d| / max|ref| per step {[round(e, 5) for e in errs]} "
          f"(gate {GATE}), {forced} greedy tokens checked", flush=True)
    return dict(prefill=c_prefill, decode=c_decode, methods=by_method, ms_per_step=step_ms,
                idle=idle, gaps=errs, prefill_ms=prefill_s * 1e3)


def serving_check(m, k, mesh, model, reqs, backend: str, card: str):
    """ContinuousScheduler(paged=True) over the mesh on `backend`. Returns
    (the launch counts, the served streams by rid)."""
    eng = m.Engine(model, max_seq=SERVE_MAX_SEQ, backend=backend, device=mesh.devices[0])
    admit = {}
    inner = eng.admit_slot_paged

    def counted_admit(*a, **kw):
        before = k.launch_counts()
        out = inner(*a, **kw)
        for c, v in k.launch_counts().items():
            admit[c] = admit.get(c, 0) + v - before[c]
        return out

    eng.admit_slot_paged = counted_admit
    sched = m.ContinuousScheduler(eng, batch=SERVE_B, chunk=SERVE_CHUNK, paged=True,
                                  page=PAGE)
    k.reset_launch_counts()
    t0 = time.perf_counter()
    out = sched.run([m.Request(r.rid, r.ids, r.gen_len) for r in reqs])
    sync(mesh)
    wall = time.perf_counter() - t0
    counts = k.launch_counts()
    by_method = k.method_counts()
    comm = BACKEND_COMM[backend]
    ticks = {c: v - admit.get(c, 0) for c, v in counts.items()}
    # admissions: the batch-1 forward of each suffix, on "xla" (no kernel)
    # for "ar"/"gemm_ar", through the layers' kernels and the rings on "dist"
    admit_path = ("flash_decode", "kv_update", "swiglu") + comm if backend == "dist" else ()
    for c in admit_path:
        check(admit.get(c, 0) > 0, f"tp serving {backend}: admissions launched no {c} "
              f"({admit})")
    only_launched(admit, admit_path, f"tp serving {backend} admissions")
    for c in comm:
        check(ticks[c] > 0, f"tp serving {backend}: ticks launched {c} {ticks[c]} times")
    check(eng.comm_kernel_dispatches > 0,
          f"tp serving {backend}: dispatches {eng.comm_kernel_dispatches}")
    only_launched(ticks, ("flash_decode_paged", "swiglu") + comm,
                  f"tp serving {backend} ticks")
    if backend == "ar":
        # a tick's [64, 2048] bf16: 3 x 256 KiB <= 1 MiB, the one-shot
        only_launched(by_method, ("all_reduce one_shot",), "tp serving ar (methods)")
    for r in reqs:
        check(len(out[r.rid]) == r.gen_len, f"tp serving {backend}: rid {r.rid} served "
              f"{len(out[r.rid])} of {r.gen_len}")
    toks = sum(len(out[r.rid]) for r in reqs)
    print(f"serving tp={mesh.size} paged {backend} on {card}: {len(reqs)} requests over "
          f"{SERVE_B} slots, {toks} tokens in {wall:.2f} s ({toks / wall:.1f} tok/s), "
          f"comm_kernel_dispatches {eng.comm_kernel_dispatches}, launches {counts} "
          f"(admissions {admit}) {by_method}", flush=True)
    return counts, out


def run(mesh, *, card: str, n_layers=None, n_req: int = N_REQ, mega_row: bool = True) -> dict:
    """Every check on `mesh`; returns the kernel rows and the launch counts
    of each phase. mega_row: row 5's TP form too (chip_smoke.py measures
    it as case 5c, on row 5a's inputs)."""
    import triton_dist_tpu_torch.kernels as k
    import triton_dist_tpu_torch.models as m
    t0 = time.perf_counter()
    rows = kernel_rows(mesh) + ([mega_tp_row(mesh)] if mega_row else [])
    print(f"[tp {time.perf_counter() - t0:.1f} s] kernel rows done", flush=True)
    cfg = m.qwen3_1p7b()
    if n_layers is not None:
        import dataclasses
        cfg = dataclasses.replace(cfg, num_layers=n_layers)
    gen = torch.Generator(device=mesh.devices[0]).manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=mesh.devices[0])
    ref_model = m.DenseLLM.random_init(cfg, device=mesh.devices[0], seed=0)
    model = ref_model.to_mesh(mesh)
    counts = {}
    for backend in ("ar", "gemm_ar", "dist", "mega"):
        counts[backend] = engine_check(m, k, mesh, ref_model, model, ids, backend, card)
        print(f"[tp {time.perf_counter() - t0:.1f} s] engine {backend} done", flush=True)
    reqs = serving_requests(m, cfg.vocab_size, n_req)
    served = []
    for backend in ("gemm_ar", "ar", "dist"):
        counts[backend]["paged"], out = serving_check(m, k, mesh, model, reqs, backend, card)
        served += [(r.ids, out[r.rid]) for r in reqs]
        print(f"[tp {time.perf_counter() - t0:.1f} s] serving {backend} done", flush=True)
    forced, n_streams = tf_gate(m, ref_model, None, served, "tp serving", SERVE_MAX_SEQ)
    print(f"serving tp={mesh.size}: {forced} tokens of the {n_streams} distinct streams "
          f"that gemm_ar, ar and dist served for {len(reqs)} requests checked against "
          f"one-rank xla", flush=True)
    print(f"[tp {time.perf_counter() - t0:.1f} s] served streams checked", flush=True)
    return dict(rows=rows, counts=counts)


# ----------------------------------------------------------------------
# expert parallelism: Qwen3-30B-A3B over the mesh (Engine "ep"/"ep_flash")
# ----------------------------------------------------------------------

# ep_moe_fused against its plain version: max |d| over max |plain|
# (tools/fault_margin.py --ep); the EP engines against the one-rank plain
# engine, dropless with the routing pinned: logits (MOE_LIMIT) and served
# tokens (MOE_SERVE_LIMIT), chip_smoke.py's MoE limits
EP_FUSED_LIMIT = 2e-2
MOE_LIMIT, MOE_SERVE_LIMIT = 3e-2, 2e-2
E_MOE, TOPK, I_MOE = 128, 8, 768
EP_TF_B, EP_TF_S = 4, 64                       # the dropless teacher-forced arm
# the dropless serving arm: one wave of requests on as many slots, each
# asking for at most EP_DL_GEN tokens (one tick), every stream
# teacher-forced (at 48 layers an EP step of four slots is host-bound at
# about 0.65 s: the one-rank MoE arm's 8 requests on 4 slots and 32-64
# tokens would take 80 s a backend)
EP_DL_REQS, EP_DL_SLOTS, EP_DL_GEN = 4, 4, 16
# the capacity-2.0 serving arms: the traffic's first n_req requests, each
# asking for at most EP_SERVE_GEN tokens (two ticks of SERVE_CHUNK; the
# traffic asks for 32-64)
EP_SERVE_GEN = 32


def _ep_caps(mesh, t_loc: int, cf=2.0, payload_int8=False):
    """EP_MoE._caps / _cap_e of Qwen3-30B-A3B's layer over `mesh`."""
    from triton_dist_tpu_torch.layers import EP_MoE
    lay = EP_MoE(w_router=[torch.empty((D, E_MOE), device="meta")], w_gate_up=[],
                 w_down=[], mesh=mesh, top_k=TOPK, capacity_factor=cf,
                 payload_int8=payload_int8)
    return lay._caps(t_loc), lay._cap_e(t_loc)


def ep_kernel_rows(mesh, seed: int = 0) -> list:
    """Rows 18-20 at the EP path's shapes (launches left None): the
    combine all_to_all and the dispatch_a2a (payload and metadata) at the
    decode step's capacities (B=128 rows, capacity 2.0) and the prefill's
    (B*S rows), in bf16 and on the int8 wire (pack_rows_int8 rows), and at
    the registry's f32 shapes (low_latency_all_to_all's packed rows too),
    all bitwise to their plain versions; ep_moe_fused_device at the
    serving layer's shape (the decode step's 32 rows a rank, capacity
    2.0), bf16 and int8 panels, and the registry's f32 shape, within
    EP_FUSED_LIMIT."""
    from triton_dist_tpu_torch import kernels as K
    from triton_dist_tpu_torch.kernels import ep_a2a
    from triton_dist_tpu_torch.kernels.ep_fused import (ep_moe_fused_device,
                                                         ep_moe_fused_device_ref)
    n = mesh.size
    one = emulated(mesh)
    dev0 = mesh.devices[0]
    gen = torch.Generator(device=dev0).manual_seed(seed)
    rows = []

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        t = torch.randn(shape, generator=gen, device=dev0, dtype=torch.float32)
        return (t * scale).to(dtype)

    def parts(shape, dtype, scale=1.0):
        return [randn(*shape, dtype=dtype, scale=scale).to(d) for d in mesh.devices]

    def int8_parts(shape):
        return [torch.randint(-127, 128, shape, generator=gen, device=dev0,
                              dtype=torch.int8).to(d) for d in mesh.devices]

    def meta_parts(R):
        return [torch.stack([torch.randint(0, E_MOE // n, (R,), generator=gen, device=dev0),
                             torch.randint(0, 2, (R,), generator=gen, device=dev0)], 1)
                .to(torch.int32).to(d) for d in mesh.devices]

    def cat_lib(xs):
        """One torch.cat of every rank's chunks in destination order: the
        whole exchange into one buffer (ranks emulated on one card)."""
        C = xs[0].shape[0] // n
        return torch.cat([xs[p][d * C:(d + 1) * C] for d in range(n) for p in range(n)])

    def as_bytes(pairs):
        return [torch.cat([x.reshape(-1).view(torch.uint8), m.reshape(-1).view(torch.uint8)])
                for x, m in zip(*pairs)]

    cases = []
    for label, M in (("decode", B), ("prefill", B * S)):
        (pair, _), _ = _ep_caps(mesh, M // n)
        (pair8, _), _ = _ep_caps(mesh, M // n, payload_int8=True)
        cases += [(f"{label} [{n}x{pair}, {D}] bf16", n * pair, (D,), torch.bfloat16),
                  (f"{label} int8 wire [{n}x{pair8}, {D}+4]", n * pair8, (D + 4,), torch.int8)]
    cases.append((f"registry [{n}x8, 128] f32", n * 8, (128,), torch.float32))
    for case, R, cols, dt in cases:
        es = torch.finfo(dt).bits // 8 if dt.is_floating_point else 1
        fresh = ((lambda R=R, cols=cols: (int8_parts((R,) + cols),)) if dt == torch.int8 else
                 (lambda R=R, cols=cols, dt=dt: (parts((R,) + cols, dt),)))
        nb = R * cols[0] * es
        measure(rows, mesh, "all_to_all", case, fresh,
                lambda xs: K.all_to_all(xs, mesh=mesh), lambda xs: K.all_to_all_ref(xs),
                (lambda xs: cat_lib(xs)) if one else None, 2 * n * nb, n * nb, "a2a", None,
                replicated=False)
        measure(rows, mesh, "dispatch_a2a", case + f" + [{R}, 2] int32 metadata",
                lambda fresh=fresh, R=R: (fresh()[0], meta_parts(R)),
                lambda xs, ms: as_bytes(ep_a2a.dispatch_a2a(xs, ms, mesh=mesh)),
                lambda xs, ms: as_bytes((K.all_to_all_ref(xs), K.all_to_all_ref(ms))),
                (lambda xs, ms: (cat_lib(xs), cat_lib(ms))) if one else None,
                2 * n * (nb + R * 8), n * (nb + R * 8), "a2a", None, replicated=False)
    # low_latency_all_to_all at the registry's shape: pack, exchange, unpack
    measure(rows, mesh, "all_to_all", f"low_latency_all_to_all registry [{n}, 8, 128] f32",
            lambda: (parts((n, 8, 128), torch.float32, 0.1),),
            lambda xs: K.low_latency_all_to_all(xs, mesh=mesh),
            lambda xs: [ep_a2a.unpack_rows_int8(p, 128, torch.float32).reshape(n, 8, 128)
                        for p in K.all_to_all_ref([ep_a2a.pack_rows_int8(x.reshape(-1, 128))
                                                   for x in xs])],
            None, 2 * n * n * 8 * 132, n * n * 8 * 132, "a2a", None, replicated=False)

    # row 20 at the serving layer's shape and the registry's f32 shape
    E_loc = E_MOE // n
    _, cap_e = _ep_caps(mesh, B // n)
    fused = [("serving layer", E_loc, cap_e, D, I_MOE, torch.bfloat16, "bf16"),
             ("serving layer", E_loc, cap_e, D, I_MOE, torch.bfloat16, "int8"),
             ("registry", 2, 16, 128, 128, torch.float32, "f32")]
    for what, El, ce, Dm, Im, dt, wt in fused:
        rows_x = n * El * ce
        es = torch.finfo(dt).bits // 8

        def fresh(El=El, ce=ce, Dm=Dm, Im=Im, dt=dt, wt=wt):
            xs = parts((n * El * ce, Dm), dt, 0.3 if dt == torch.bfloat16 else 0.1)
            wgu = [randn(El, Dm, 2 * Im, dtype=dt, scale=Dm ** -0.5) for _ in range(n)]
            wd = [randn(El, Im, Dm, dtype=dt, scale=Im ** -0.5) for _ in range(n)]
            if wt == "int8":
                wgu, wd = [K.quantize_int8(w) for w in wgu], [K.quantize_int8(w) for w in wd]
                wgu = [K.QuantW(q=w.q.to(d), s=w.s.to(d)) for w, d in zip(wgu, mesh.devices)]
                wd = [K.QuantW(q=w.q.to(d), s=w.s.to(d)) for w, d in zip(wd, mesh.devices)]
            else:
                wgu = [w.to(d) for w, d in zip(wgu, mesh.devices)]
                wd = [w.to(d) for w, d in zip(wd, mesh.devices)]
            return xs, wgu, wd

        wes = 1 if wt == "int8" else es
        w_bytes = 3 * El * Dm * Im * wes + (El * (2 * Im + Dm) * 4 if wt == "int8" else 0)
        x_bytes = rows_x * Dm * es
        flops = 2.0 * rows_x * Dm * 3 * Im                 # one rank's products
        peak = BF16_FLOPS_PER_S if dt == torch.bfloat16 else F32_FLOPS_PER_S
        if one:
            t_b = n * (2 * x_bytes + w_bytes) / HBM_BYTES_PER_S * 1e3
            t_o = n * flops / peak * 1e3
        else:
            from triton_dist_tpu_torch.tools.perf_model import collective_sol_us
            t_b = max((2 * x_bytes + w_bytes) / HBM_BYTES_PER_S * 1e3,
                      2 * collective_sol_us("a2a", n * x_bytes, n) / 1e3)
            t_o = flops / peak * 1e3
        measure(rows, mesh, "ep_moe_fused",
                f"{what} E_loc={El} cap_e={ce} D={Dm} I={Im} x[{rows_x}, {Dm}] "
                f"{str(dt)[6:]}" + (" int8 panels" if wt == "int8" else ""), fresh,
                lambda xs, wgu, wd, ce=ce: ep_moe_fused_device(xs, wgu, wd, mesh=mesh,
                                                               cap_e=ce),
                lambda xs, wgu, wd, ce=ce: ep_moe_fused_device_ref(xs, wgu, wd, cap_e=ce),
                None, 0, 0, "a2a", EP_FUSED_LIMIT, replicated=False,
                bound=(t_b, "bytes") if t_b >= t_o else (t_o, "operations"))
    return rows


def ep_allowed(backend: str) -> tuple:
    """The kernels an EP forward may launch: the attention's ("ep": the
    "dist" rings; "ep_flash": the flash kernels), the grouped GEMM and the
    two exchanges."""
    attn = ("ag_gemm", "gemm_rs") if backend == "ep" else ()
    return ("flash_decode", "kv_update", "grouped_gemm", "dispatch_a2a",
            "all_to_all") + attn


def ep_engine_check(m, k, mesh, model, ids, backend: str, card: str) -> dict:
    """Engine(backend) on the EP model at capacity 2.0: prefill B x S and
    GEN decode steps, timed, with exact launch counts of the EP kernels
    (one dispatch_a2a, one all_to_all and two grouped_gemm, over the
    experts of the device's ranks, a layer and forward, per distinct
    device) and the attention rings' on "ep"; then the idle share of one
    profiled step."""
    eng = m.Engine(model, max_seq=S + GEN + 8, backend=backend, device=mesh.devices[0])
    eng.decode(*eng.prefill(ids[:, :8]), 2)                 # warm-up
    sync(mesh)
    k.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = eng.prefill(ids)
    sync(mesh)
    prefill_s = time.perf_counter() - t0
    c_prefill = k.launch_counts()
    k.reset_launch_counts()
    t0 = time.perf_counter()
    toks = eng.decode(logits, cache, GEN)
    sync(mesh)
    decode_s = time.perf_counter() - t0
    c_decode = k.launch_counts()
    L, n = model.config.num_layers, mesh.size
    per_call = len(mesh.device_groups())
    for label, c, fw in (("prefill", c_prefill, 1), ("decode", c_decode, GEN)):
        want = {"dispatch_a2a": L * per_call * fw, "all_to_all": L * per_call * fw,
                "grouped_gemm": 2 * L * per_call * fw}
        if backend == "ep":
            want.update(ag_gemm=L * per_call * fw, gemm_rs=L * per_call * fw)
        for name, w in want.items():
            check(c[name] == w, f"ep engine {backend} {label}: {name} launched {c[name]} "
                  f"times, want {w} ({c})")
        check(c["flash_decode"] > 0, f"ep engine {backend} {label}: no flash_decode ({c})")
        only_launched(c, ep_allowed(backend), f"ep engine {backend} {label}")
    check(tuple(toks.shape) == (B, GEN) and bool(torch.isfinite(logits).all()),
          f"ep engine {backend}: tokens {tuple(toks.shape)}, logits finite "
          f"{bool(torch.isfinite(logits).all())}")
    step_ms = decode_s * 1e3 / GEN
    # one profiled step: key_averages over 27,000 launches is itself seconds
    idle = idle_share(lambda: eng.decode_step(toks[:, 0], cache), 1, decode_s / GEN,
                      f"ep {backend} decode", len(mesh.device_groups()))
    print(f"engine ep={n} {backend} on {card}: prefill {prefill_s * 1e3:.1f} ms (B={B}, "
          f"S={S}), decode {GEN} steps {decode_s * 1e3:.1f} ms ({step_ms:.2f} ms/step, "
          f"{B * GEN / decode_s:.1f} tok/s), launches a step "
          f"{sum(c_decode.values()) // GEN}; prefill {c_prefill} decode {c_decode}", flush=True)
    return dict(prefill=c_prefill, decode=c_decode, ms_per_step=step_ms, idle=idle,
                prefill_ms=prefill_s * 1e3)


def moe_gate(m, mesh, one, model, ids, backend: str, label: str = "ep", **eng_kw) -> dict:
    """Dropless, routing pinned (tools/fault_margin.py RouteTape: the mesh
    model's forward records, the one-rank plain engine replays): prefill
    EP_TF_B x EP_TF_S and TF_STEPS teacher-forced steps by the margin rule
    at MOE_LIMIT; then four slot-chunk steps on each, whose routing loads
    [expert_tokens, drops] must be equal, with no drop. eng_kw: the mesh
    engine's (prefill_backend)."""
    from triton_dist_tpu_torch.tools.fault_margin import RouteTape
    dev = mesh.devices[0]
    ids_tf = ids[:EP_TF_B, :EP_TF_S]
    max_seq = EP_TF_S + TF_STEPS + 8
    ref = m.Engine(one, max_seq=max_seq, backend="xla", device=dev)
    eng = m.Engine(model, max_seq=max_seq, backend=backend, device=dev, **eng_kw)
    tape, errs, forced = RouteTape(), [], 0
    with tape.record():
        lf, cf = eng.prefill(ids_tf)
    with tape.replay():
        lr, cr = ref.prefill(ids_tf)
    for t in range(TF_STEPS + 1):
        check(tape.done(), f"{label} {backend} dropless: step {t} replayed {tape.used} of "
                           f"{len(tape.calls)} routing calls")
        err, _, n_sure = margin_gate(lf, lr, f"{label} {backend} dropless step {t}", MOE_LIMIT)
        errs.append(round(err / lr.abs().max().item(), 5))
        forced += n_sure
        if t < TF_STEPS:
            tok = torch.argmax(lr, -1)
            with tape.record():
                lf = eng.decode_step(tok, cf)
            with tape.replay():
                lr = ref.decode_step(tok, cr)
    check(forced > 0, f"{label} {backend} dropless: no token passed the margin rule")
    pos = torch.full((EP_TF_B,), EP_TF_S + TF_STEPS, dtype=torch.int32, device=dev)
    act = torch.ones(EP_TF_B, dtype=torch.bool, device=dev)
    with tape.record():
        load_f = eng.slot_chunk(lf, cf, pos, act, chunk=4)[4].cpu()
    with tape.replay():
        load_r = ref.slot_chunk(lr, cr, pos, act, chunk=4)[4].cpu()
    L = model.config.num_layers
    check(torch.equal(load_f, load_r) and int(load_f[-1]) == 0
          and int(load_f[:-1].sum()) == EP_TF_B * TOPK * L * 4,
          f"{label} {backend} dropless: slot-chunk load {load_f.tolist()} against the plain "
          f"engine's {load_r.tolist()}")
    print(f"engine {label} {backend} dropless: teacher-forced vs one-rank plain, routing pinned, "
          f"B={EP_TF_B} S={EP_TF_S} and {TF_STEPS} steps: max|d logits| / max|logit| per "
          f"step {errs} (limit {MOE_LIMIT}), {forced} greedy tokens checked; a 4-step slot "
          f"chunk's load equal to the plain engine's ({int(load_f[:-1].sum())} routed "
          f"entries, {int(load_f[-1])} dropped)", flush=True)
    del cf, cr
    return dict(gaps=errs)


def moe_served_check(m, mesh, one, model, backend, reqs, out, label, **eng_kw) -> tuple:
    """The served streams of `reqs`, teacher-forced: the mesh model's slot
    forward (mode `backend`, contiguous slots over the mesh) along prompt +
    served tokens, the one-rank plain engine replaying its expert
    selection (RouteTape). Each served token must be the mesh forward's
    argmax wherever its top-2 margin exceeds twice MOE_SERVE_LIMIT of its
    largest logit, and its logits stay within MOE_LIMIT of the plain
    ones. Returns (tokens checked, the largest relative logit gap)."""
    from triton_dist_tpu_torch.tools.fault_margin import RouteTape
    dev = mesh.devices[0]
    n = len(reqs)
    eng = m.Engine(model, max_seq=SERVE_MAX_SEQ, backend=backend, device=dev, **eng_kw)
    ref = m.Engine(one, max_seq=SERVE_MAX_SEQ, backend="xla", device=dev)
    cf, cr, tape = eng.make_slot_cache(n), ref.make_slot_cache(n), RouteTape()
    lf, lr = [], []
    for b, r in enumerate(reqs):
        with tape.record():
            lf.append(eng.prefill_into_slot(cf, b, r.ids)[0])
        with tape.replay():
            lr.append(ref.prefill_into_slot(cr, b, r.ids)[0])
    lf, lr = torch.stack(lf), torch.stack(lr)
    lens = torch.tensor([r.gen_len for r in reqs], device=dev)
    gen = max(r.gen_len for r in reqs)
    toks = torch.zeros((n, gen), dtype=torch.int64, device=dev)
    for b, r in enumerate(reqs):
        toks[b, :r.gen_len] = torch.as_tensor(np.asarray(out[r.rid]), device=dev)
    pos = torch.tensor([len(r.ids) for r in reqs], dtype=torch.int32, device=dev)
    forced, worst = 0, 0.0
    for t in range(gen):
        live = t < lens
        gap = ((lf - lr).abs().amax(-1) / lr.abs().amax(-1))[live].max().item()
        check(tape.done() and gap <= MOE_LIMIT,
              f"{label}: step {t} logits max|d| / max|logit| {gap} > {MOE_LIMIT} "
              "(routing pinned)")
        worst = max(worst, gap)
        top2 = lf.topk(2, dim=-1).values
        sure = ((top2[:, 0] - top2[:, 1]) > 2 * MOE_SERVE_LIMIT * lf.abs().amax(-1)) & live
        check(bool((torch.argmax(lf, -1) == toks[:, t])[sure].all()),
              f"{label}: step {t}: a served token differs from the forward's argmax where "
              "the margin exceeds the tolerance")
        forced += int(sure.sum())
        if t + 1 < gen:
            with tape.record():
                lf, cf = model.forward_tokens_slots(toks[:, t:t + 1], cf, pos, mode=backend)
            with tape.replay():
                lr, cr = one.forward_tokens_slots(toks[:, t:t + 1], cr, pos, mode="xla")
            pos = torch.clamp(pos + 1, max=SERVE_MAX_SEQ - 1)
    check(forced > 0, f"{label}: no served token passed the margin rule")
    del cf, cr
    return forced, worst


def moe_serving_check(m, k, mesh, model, reqs, backend: str, card: str, batch: int,
                      need=None, allowed=None, label: str = "ep", **eng_kw):
    """ContinuousScheduler(paged=True) at `batch` slots on the mesh
    model's engine: the admissions and the ticks each launch the kernels
    of `need` (by default the EP path's dispatch_a2a, all_to_all and
    grouped_gemm) and only those of `allowed` (the EP path's and the paged
    decode); every request served in full; the routing load read back: the
    ticks' routed entries = layers x top-k x slots x steps. Returns (launch
    counts, streams, the scheduler's stats)."""
    need = need or ("dispatch_a2a", "all_to_all", "grouped_gemm")
    allowed = allowed or ep_allowed(backend) + ("flash_decode_paged",)
    eng = m.Engine(model, max_seq=SERVE_MAX_SEQ, backend=backend, device=mesh.devices[0],
                   **eng_kw)
    admit, steps = {}, [0]
    inner, tick = eng.admit_slot_paged, eng.paged_slot_chunk

    def counted_admit(*a, **kw):
        before = k.launch_counts()
        out = inner(*a, **kw)
        for c, v in k.launch_counts().items():
            admit[c] = admit.get(c, 0) + v - before[c]
        return out

    def counted_tick(*a, chunk, **kw):
        steps[0] += chunk
        return tick(*a, chunk=chunk, **kw)

    eng.admit_slot_paged, eng.paged_slot_chunk = counted_admit, counted_tick
    sched = m.ContinuousScheduler(eng, batch=batch, chunk=SERVE_CHUNK, paged=True, page=PAGE)
    k.reset_launch_counts()
    t0 = time.perf_counter()
    out = sched.run([m.Request(r.rid, r.ids, r.gen_len) for r in reqs])
    sync(mesh)
    wall = time.perf_counter() - t0
    counts = k.launch_counts()
    ticks = {c: v - admit.get(c, 0) for c, v in counts.items()}
    for part, c in (("admissions", admit), ("ticks", ticks)):
        for name in need:
            check(c.get(name, 0) > 0, f"{label} serving {backend} {part}: no {name} ({c})")
        only_launched(c, allowed, f"{label} serving {backend} {part}")
    for r in reqs:
        check(len(out[r.rid]) == r.gen_len, f"{label} serving {backend}: rid {r.rid} served "
              f"{len(out[r.rid])} of {r.gen_len}")
    st = sched.stats()
    E, L = model.config.num_experts, model.config.num_layers
    routed = sum(st.get(f"expert_tokens{{expert={e}}}", 0) for e in range(E))
    check(routed == L * TOPK * batch * steps[0],
          f"{label} serving {backend}: {routed} routed entries over {steps[0]} tick steps of "
          f"{batch} slots, want {L * TOPK * batch * steps[0]}")
    toks = sum(len(out[r.rid]) for r in reqs)
    print(f"serving {label}={mesh.size} paged {backend} on {card}: {len(reqs)} requests over "
          f"{batch} slots, {toks} tokens in {wall:.2f} s ({toks / wall:.1f} tok/s); MoE "
          f"drops {st['moe_capacity_drops']} of {routed} routed entries, imbalance "
          f"{st['expert_load_imbalance']:.3f}; launches admissions {admit} ticks {ticks}",
          flush=True)
    return counts, out, st


def ep_layer_check(mesh, model) -> dict:
    """Layer 0 of the EP model at the serving layer's shape (B=128 rows):
    EP_MoE(mode="ep_fused") with its bf16 panels and with int8 panels
    (quantize_int8_experts) against fwd_ep on the same rows, dropless (the
    same routing and no drop on either path; max |d| over max |fwd_ep|,
    MOE_LIMIT, 0.1 for the int8 weights' rounding), then each timed at
    capacity 2.0 beside the fwd_ep chain."""
    from triton_dist_tpu_torch import kernels as K
    lay = model.layers[0].moe
    dev = mesh.devices[0]
    gen = torch.Generator(device=dev).manual_seed(3)
    x = (torch.randn((B, D), generator=gen, device=dev) * 0.5).to(model.config.torch_dtype)
    xs = lay._shard(x)
    layers = (("bf16", lay), ("int8 panels", lay.quantize_int8_experts()))
    out = {}
    cf = lay.capacity_factor
    for _, l_ in layers:
        l_.capacity_factor = "dropless"
    try:
        ref = lay(xs, "ep")
        K.reset_launch_counts()
        for label, l_ in layers:
            k0 = K.launch_counts()["ep_moe_fused"]
            got = l_(xs, "ep_fused")
            sync(mesh)
            check(K.launch_counts()["ep_moe_fused"] - k0 == len(mesh.device_groups()),
                  f"ep layer ep_fused {label}: launches")
            if label == "int8 panels":
                out["launches"] = K.launch_counts()
                only_launched(out["launches"], ("ep_moe_fused",), "ep layer ep_fused")
            err = max(((g.float() - r.float()).abs().max() / r.float().abs().max()).item()
                      for g, r in zip(got, ref))
            limit = MOE_LIMIT if label == "bf16" else 0.1
            check(err <= limit, f"ep layer ep_fused {label} vs fwd_ep: {err} > {limit}")
            out[f"ep_fused {label}"] = err
    finally:
        for _, l_ in layers:
            l_.capacity_factor = cf
    out["ep ms"] = cuda_ms(lambda: lay(xs, "ep"), mesh, reps=10)
    for label, l_ in layers:
        out[f"ep_fused {label} ms"] = cuda_ms(lambda: l_(xs, "ep_fused"), mesh, reps=10)
    print(f"ep layer 0, B={B} rows: dropless, ep_fused bf16 {out['ep_fused bf16']:.4g} and "
          f"int8 panels {out['ep_fused int8 panels']:.4g} of max from fwd_ep; at capacity "
          f"{cf}: fwd_ep chain {out['ep ms']:.4f} ms, ep_fused bf16 "
          f"{out['ep_fused bf16 ms']:.4f} ms, int8 panels {out['ep_fused int8 panels ms']:.4f} "
          "ms", flush=True)
    return out


def run_ep(mesh, *, card: str, one=None, n_layers=None, n_req: int = N_REQ) -> dict:
    """Every EP check on `mesh`: the kernel rows of rows 18-20; then
    Qwen3-30B-A3B (`one`, the one-rank model at capacity 2.0, or drawn
    here from seed 0, bf16) split over the mesh (its expert panels views of
    the one-rank model's): per backend "ep" and "ep_flash" the engine at
    B=128, the dropless gate, paged serving of the traffic's first n_req
    requests (at most EP_SERVE_GEN tokens each) at 64 slots, and the
    dropless serving arm (EP_DL_REQS
    requests on EP_DL_SLOTS slots, at most EP_DL_GEN tokens each) whose
    streams are held to the plain engine; then ep_fused at the serving
    layer. Returns
    the kernel rows and the launch counts and metrics of each phase."""
    import triton_dist_tpu_torch.kernels as k
    import triton_dist_tpu_torch.models as m
    t0 = time.perf_counter()
    rows = ep_kernel_rows(mesh)
    print(f"[ep {time.perf_counter() - t0:.1f} s] kernel rows done", flush=True)
    cfg = m.qwen3_30b_a3b()
    if one is None:
        if n_layers is not None:
            import dataclasses
            cfg = dataclasses.replace(cfg, num_layers=n_layers)
        one = m.AutoLLM.from_config(cfg, device=mesh.devices[0], seed=0, capacity_factor=2.0)
    one = cut_layers(one, n_layers)
    cfg = one.config
    model = one.to_mesh(mesh, "ep")
    gen = torch.Generator(device=mesh.devices[0]).manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=mesh.devices[0])
    reqs = [m.Request(r.rid, r.ids, min(r.gen_len, EP_SERVE_GEN))
            for r in serving_requests(m, cfg.vocab_size, max(n_req, EP_DL_REQS))]
    res = {}
    for backend in m.engine.EP_BACKENDS:
        res[backend] = ep_engine_check(m, k, mesh, model, ids, backend, card)
        print(f"[ep {time.perf_counter() - t0:.1f} s] engine {backend} done", flush=True)
        c, _, st = moe_serving_check(m, k, mesh, model, reqs[:n_req], backend, card, SERVE_B)
        res[backend]["paged"] = c
        print(f"[ep {time.perf_counter() - t0:.1f} s] serving {backend} done", flush=True)
        set_capacity(one, "dropless")
        set_capacity(model, "dropless")
        try:
            res[backend].update(moe_gate(m, mesh, one, model, ids, backend))
            dl = [m.Request(r.rid, r.ids, min(r.gen_len, EP_DL_GEN)) for r in reqs[:EP_DL_REQS]]
            _, out, st = moe_serving_check(m, k, mesh, model, dl, backend, card, EP_DL_SLOTS)
            check(st["moe_capacity_drops"] == 0,
                  f"ep serving {backend} dropless: {st['moe_capacity_drops']} drops")
            forced, worst = moe_served_check(m, mesh, one, model, backend, dl, out,
                                             f"ep serving {backend} dropless")
            print(f"serving ep {backend} dropless: {forced} served tokens of {len(dl)} "
                  f"requests checked against the EP forward's argmax (margin rule at "
                  f"{MOE_SERVE_LIMIT}), its logits within {worst:.5f} of the one-rank plain "
                  f"engine's (routing pinned, limit {MOE_LIMIT})", flush=True)
        finally:
            set_capacity(one, 2.0)
            set_capacity(model, 2.0)
        print(f"[ep {time.perf_counter() - t0:.1f} s] dropless {backend} done", flush=True)
    res["layer"] = ep_layer_check(mesh, model)
    print(f"[ep {time.perf_counter() - t0:.1f} s] ep_fused layer done", flush=True)
    del model
    return dict(rows=rows, counts=res)


# ----------------------------------------------------------------------
# tensor-parallel MoE: Qwen3-30B-A3B (moe_impl="tp") over the mesh
# ----------------------------------------------------------------------

# ag_group_gemm, moe_reduce_rs and moe_reduce_ar against their plain
# versions, and TP_MoE's fused forms against the same forms on the plain
# kernels: max |d| over max |plain| (tools/fault_margin.py --tp-moe)
TP_MOE_LIMIT = 2e-2
# the backends the TP-MoE engine arms drive, and their prefill: "gemm_ar"
# prefills on "flash" (its default, "xla", would run the dense all-experts
# oracle over B x S rows: [E, B S, D] a rank)
TP_MOE_BACKENDS = {"dist": None, "gemm_ar": "flash"}
# the dropless serving arm: requests on slots, at most EP_DL_GEN tokens each
TP_MOE_DL_REQS, TP_MOE_DL_SLOTS = 8, 4
# row 23's large case: moe_reduce_ar lands every rank's [E, cap, D]
# partial on every rank, n^2 E cap D elements on one card (17 GB at the
# B x S prefill's capacity); B x S / 8 rows fit beside the model
TP_MOE_AR_ROWS = B * S // 8


def _tp_moe_layer(cf=2.0, top_k=TOPK):
    """A meta-device TP_MoE of Qwen3-30B-A3B's shape (for its capacities)."""
    from triton_dist_tpu_torch.layers import TP_MoE
    meta = torch.empty((D, E_MOE), device="meta")
    return TP_MoE(w_router=meta, w_gate_up=meta, w_down=meta, top_k=top_k,
                  capacity_factor=cf)


def tp_moe_kernel_rows(mesh, seed: int = 0) -> list:
    """Rows 21-23 at the TP-MoE path's shapes (launches left None), each
    within TP_MOE_LIMIT of its plain version over CALLS calls: ag_group_gemm
    and moe_reduce_rs at the fused form's capacities (rank-local routing of
    B/n and B S/n rows at capacity 2.0, the n chunks gathered), moe_reduce_ar
    at fused_ar's (B rows replicated, and TP_MOE_AR_ROWS), all on
    Qwen3-30B-A3B's panels as a rank takes them (views: gate_r and up_r two
    column blocks of one [E, D, 2I] panel, w_down's rows), bf16; and the
    registry's f32 shapes. The library call is one torch.bmm on the gathered
    (row 21) or concatenated (rows 22-23) operands on one card."""
    from triton_dist_tpu_torch import kernels as K
    n = mesh.size
    dev0 = mesh.devices[0]
    one = emulated(mesh)
    gen = torch.Generator(device=dev0).manual_seed(seed)
    rows = []
    lay = _tp_moe_layer()

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        t = torch.randn(shape, generator=gen, device=dev0, dtype=torch.float32)
        return (t * scale).to(dtype)

    def parts(shape, dtype, scale=1.0):
        return [randn(*shape, dtype=dtype, scale=scale).to(d) for d in mesh.devices]

    def panels(E, K_, N_, dtype, kind):
        """Each rank's panel, cut from one whole panel as a rank takes it:
        "pair" the column blocks (gate_r, up_r) of [E, K, n N] (N_ = 2 i
        columns a rank), "cols" the columns of [E, K, n N], "rows" the rows
        of [E, n K, N] (w_down's slab); views on rank 0's device, copies on
        the others'. Returns (the ranks' panels, rank 0's as one tensor,
        the whole)."""
        if kind == "rows":
            w = randn(E, K_ * n, N_, dtype=dtype, scale=(K_ * n) ** -0.5)
            return [w[:, r * K_:(r + 1) * K_].to(d) for r, d in enumerate(mesh.devices)], w
        w = randn(E, K_, N_ * n, dtype=dtype, scale=K_ ** -0.5)
        if kind == "cols":
            return [w[:, :, r * N_:(r + 1) * N_].to(d) for r, d in enumerate(mesh.devices)], \
                w[:, :, :N_]
        i = N_ // 2
        ws = [(w[:, :, r * i:(r + 1) * i].to(d), w[:, :, n * i + r * i:n * i + (r + 1) * i].to(d))
              for r, d in enumerate(mesh.devices)]
        return ws, torch.cat(ws[0], 2)

    from triton_dist_tpu_torch.runtime import symm_mem
    I_r = I_MOE // n
    cap_dec, cap_pre = lay._cap(B // n), lay._cap(B * S // n)
    bf16, f32 = torch.bfloat16, torch.float32
    for what, E, c, D_, N_, dt in (("decode", E_MOE, cap_dec, D, 2 * I_r, bf16),
                                   ("prefill", E_MOE, cap_pre, D, 2 * I_r, bf16),
                                   ("registry", 2, 8, 128, 128 // n, f32)):
        es = torch.finfo(dt).bits // 8
        capT = n * c
        ws, w0 = panels(E, D_, N_, dt, "pair" if dt == bf16 else "cols")
        measure(rows, mesh, "ag_group_gemm",
                f"{what} E={E} capT={n}x{c} D={D_} N={N_}x{n} {str(dt)[6:]}"
                + (" [gate_r | up_r] views" if dt == bf16 else ""),
                lambda E=E, c=c, D_=D_, dt=dt, ws=ws: (parts((E, c, D_), dt, 0.3), ws),
                lambda xs, ws: K.ag_group_gemm(xs, ws, mesh=mesh),
                lambda xs, ws: K.ag_group_gemm_ref(xs, ws),
                (lambda xs, ws, w0=w0: torch.bmm(torch.cat(xs, 1), w0)) if one else None,
                n * (E * c * D_ + E * D_ * N_ + E * capT * N_) * es, E * capT * D_ * es, "ag",
                TP_MOE_LIMIT, flops=2.0 * E * capT * D_ * N_ * n,
                flops_per_s=BF16_FLOPS_PER_S if dt == bf16 else F32_FLOPS_PER_S)
        del ws, w0
        symm_mem.clear_registry()          # the gathered tokens' workspace
    for name, cases in (
            ("moe_reduce_rs", (("decode", E_MOE, n * cap_dec, I_r, D, bf16),
                               ("prefill", E_MOE, n * cap_pre, I_r, D, bf16),
                               ("registry", 2, 8 * n, 128 // n, 128, f32))),
            ("moe_reduce_ar", (("decode", E_MOE, lay._cap(B), I_r, D, bf16),
                               (f"{TP_MOE_AR_ROWS} rows", E_MOE, lay._cap(TP_MOE_AR_ROWS), I_r,
                                D, bf16),
                               ("registry", 2, 8 * n, 128 // n, 128, f32)))):
        rs = name == "moe_reduce_rs"
        op = K.moe_reduce_rs if rs else K.moe_reduce_ar
        ref = K.moe_reduce_rs_ref if rs else K.moe_reduce_ar_ref
        for what, E, capT, F_, D_, dt in cases:
            es = torch.finfo(dt).bits // 8
            ws, whole = panels(E, F_, D_, dt, "rows")
            measure(rows, mesh, name,
                    f"{what} E={E} capT={capT} F={F_}x{n} D={D_} {str(dt)[6:]}"
                    + (" w_down row views" if dt == bf16 else ""),
                    lambda E=E, capT=capT, F_=F_, dt=dt, ws=ws: (parts((E, capT, F_), dt, 0.3),
                                                                 ws),
                    lambda hs, ws, op=op: op(hs, ws, mesh=mesh),
                    lambda hs, ws, ref=ref: ref(hs, ws),
                    (lambda hs, ws, whole=whole: torch.bmm(torch.cat(hs, 2), whole))
                    if one else None,
                    n * (E * capT * F_ + E * F_ * D_ + E * (capT // n if rs else capT) * D_) * es,
                    E * capT * D_ * es, "rs" if rs else "ar", TP_MOE_LIMIT,
                    flops=2.0 * E * capT * F_ * D_ * n,
                    flops_per_s=BF16_FLOPS_PER_S if dt == bf16 else F32_FLOPS_PER_S,
                    replicated=not rs)
            del ws, whole
            symm_mem.clear_registry()      # the partials' and landing workspaces
    return rows


def tp_moe_allowed(backend: str) -> tuple:
    """The kernels a TP-MoE forward may launch: the attention's ("dist": its
    two rings; "gemm_ar": gemm_allreduce; "flash" none but the attention
    kernels), the grouped GEMM and, on "dist", the FFN's all_gather and
    reduce_scatter."""
    comm = {"dist": ("ag_gemm", "gemm_rs", "all_gather", "reduce_scatter"),
            "gemm_ar": ("gemm_allreduce",), "ar": ("all_reduce",)}.get(backend, ())
    return ("flash_decode", "kv_update", "grouped_gemm") + comm


def tp_moe_engine_check(m, k, mesh, model, ids, backend: str, card: str) -> dict:
    """Engine(backend) on the TP-MoE model at capacity 2.0: prefill B x S
    (on "dist" through itself, on "gemm_ar" on "flash") and GEN decode
    steps, timed, with exact launch counts a layer and forward (grouped_gemm
    two a rank; on "dist" ag_gemm, gemm_rs, all_gather and reduce_scatter
    one each, on "gemm_ar" gemm_allreduce one, per distinct device); then
    the idle share of one profiled step."""
    pre = TP_MOE_BACKENDS[backend]
    eng = m.Engine(model, max_seq=S + GEN + 8, backend=backend, prefill_backend=pre,
                   device=mesh.devices[0])
    eng.decode(*eng.prefill(ids[:, :8]), 2)                 # warm-up
    sync(mesh)
    k.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = eng.prefill(ids)
    sync(mesh)
    prefill_s = time.perf_counter() - t0
    c_prefill = k.launch_counts()
    k.reset_launch_counts()
    t0 = time.perf_counter()
    toks = eng.decode(logits, cache, GEN)
    sync(mesh)
    decode_s = time.perf_counter() - t0
    c_decode = k.launch_counts()
    L, n = model.config.num_layers, mesh.size
    per_call = len(mesh.device_groups())
    for label, c, fw, mode in (("prefill", c_prefill, 1, eng.prefill_backend),
                               ("decode", c_decode, GEN, backend)):
        want = {"grouped_gemm": 2 * n * L * fw}
        comm = {"dist": ("ag_gemm", "gemm_rs", "all_gather", "reduce_scatter"),
                "gemm_ar": ("gemm_allreduce",)}.get(mode, ())
        want.update({name: L * per_call * fw for name in comm})
        for name, w in want.items():
            check(c[name] == w, f"tp-moe engine {backend} {label}: {name} launched {c[name]} "
                  f"times, want {w} ({c})")
        check(c["flash_decode"] > 0, f"tp-moe engine {backend} {label}: no flash_decode ({c})")
        only_launched(c, tp_moe_allowed(mode), f"tp-moe engine {backend} {label}")
    check(tuple(toks.shape) == (B, GEN) and bool(torch.isfinite(logits).all()),
          f"tp-moe engine {backend}: tokens {tuple(toks.shape)}, logits finite "
          f"{bool(torch.isfinite(logits).all())}")
    step_ms = decode_s * 1e3 / GEN
    idle = idle_share(lambda: eng.decode_step(toks[:, 0], cache), 1, decode_s / GEN,
                      f"tp-moe {backend} decode", len(mesh.device_groups()))
    print(f"engine tp-moe tp={n} {backend} on {card}: prefill {prefill_s * 1e3:.1f} ms (B={B}, "
          f"S={S}, on {eng.prefill_backend}), decode {GEN} steps {decode_s * 1e3:.1f} ms "
          f"({step_ms:.2f} ms/step, {B * GEN / decode_s:.1f} tok/s), launches a step "
          f"{sum(c_decode.values()) // GEN}; prefill {c_prefill} decode {c_decode}", flush=True)
    return dict(prefill=c_prefill, decode=c_decode, ms_per_step=step_ms, idle=idle,
                prefill_ms=prefill_s * 1e3)


@contextlib.contextmanager
def plain_kernels():
    """TP_MoE's kernels swapped for their plain versions (the layer calls
    them through layers/tp_moe.py's module names): the same forms, the
    plain arithmetic."""
    from triton_dist_tpu_torch import kernels as K
    from triton_dist_tpu_torch.layers import tp_moe
    names = ("grouped_gemm", "ag_group_gemm", "moe_reduce_rs", "moe_reduce_ar")
    real = {nm: getattr(tp_moe, nm) for nm in names}
    plain = {"grouped_gemm": K.grouped_gemm_ref,
             "ag_group_gemm": lambda x, w, mesh: K.ag_group_gemm_ref(x, w),
             "moe_reduce_rs": lambda h, w, mesh: K.moe_reduce_rs_ref(h, w),
             "moe_reduce_ar": lambda h, w, mesh: K.moe_reduce_ar_ref(h, w)}
    for nm in names:
        setattr(tp_moe, nm, plain[nm])
    try:
        yield
    finally:
        for nm in names:
            setattr(tp_moe, nm, real[nm])


def tp_moe_layer_check(mesh, model) -> dict:
    """Layer 0 of the TP-MoE model at the serving layer's shape (B=128
    rows), capacity 2.0: TP_MoE(mode="fused") (ag_group_gemm,
    moe_reduce_rs) and mode="fused_ar" (grouped_gemm, moe_reduce_ar), each
    against the same form on the plain kernels (the same routing: the
    router products are the same ops on the same rows) within
    TP_MOE_LIMIT, with exact launch counts; then each timed beside the
    serving forms' chains (fwd_dist, fwd_local)."""
    from triton_dist_tpu_torch import kernels as K
    lay = model.layers[0].moe
    dev = mesh.devices[0]
    n, per_call = mesh.size, len(mesh.device_groups())
    gen = torch.Generator(device=dev).manual_seed(3)
    x = (torch.randn((B, D), generator=gen, device=dev) * 0.5).to(model.config.torch_dtype)
    shards, copies = list(x.chunk(n)), mesh.replicate(x)
    shards = [s.to(d) for s, d in zip(shards, mesh.devices)]
    out = {}
    want = {"fused": {"ag_group_gemm": per_call, "moe_reduce_rs": per_call},
            "fused_ar": {"grouped_gemm": n, "moe_reduce_ar": per_call}}
    K.reset_launch_counts()
    for mode, xs in (("fused", shards), ("fused_ar", copies)):
        before = K.launch_counts()
        got = lay(xs, mode)
        sync(mesh)
        c = {nm: v - before[nm] for nm, v in K.launch_counts().items()}
        for nm, w in want[mode].items():
            check(c[nm] == w, f"tp-moe layer {mode}: {nm} launched {c[nm]} times, want {w}")
        only_launched(c, tuple(want[mode]), f"tp-moe layer {mode}")
        with plain_kernels():
            ref = lay(xs, mode)
        err = max(((g.float() - r.float()).abs().max() / r.float().abs().max()).item()
                  for g, r in zip(got, ref))
        check(err <= TP_MOE_LIMIT, f"tp-moe layer {mode} vs plain kernels: {err} > "
              f"{TP_MOE_LIMIT}")
        out[mode] = err
    out["launches"] = K.launch_counts()
    for mode, xs in (("fused", shards), ("dist", shards), ("fused_ar", copies),
                     ("flash", copies)):
        out[f"{mode} ms"] = cuda_ms(lambda mode=mode, xs=xs: lay(xs, mode), mesh, reps=10)
    print(f"tp-moe layer 0, B={B} rows, capacity {lay.capacity_factor}: fused "
          f"{out['fused']:.4g} and fused_ar {out['fused_ar']:.4g} of max from the plain "
          f"kernels; ms fused {out['fused ms']:.4f} (fwd_dist chain {out['dist ms']:.4f}), "
          f"fused_ar {out['fused_ar ms']:.4f} (fwd_local chain {out['flash ms']:.4f})",
          flush=True)
    return out


def cut_layers(model, n_layers):
    """`model` over its first n_layers layers (the same storage), or the
    model itself."""
    if n_layers is None or n_layers >= model.config.num_layers:
        return model
    import dataclasses
    return dataclasses.replace(model, layers=model.layers[:n_layers],
                               config=dataclasses.replace(model.config, num_layers=n_layers))


def run_tp_moe(mesh, *, card: str, one=None, n_layers=None, n_req: int = N_REQ) -> dict:
    """Every TP-MoE check on `mesh`: the kernel rows of rows 21-23; then
    Qwen3-30B-A3B (`one`, the one-rank model at capacity 2.0, or drawn here
    from seed 0, bf16; cut to its first n_layers layers, the same storage)
    split over the mesh with moe_impl="tp" (its rank panels views of the
    one-rank model's): per backend of TP_MOE_BACKENDS the engine at B=128;
    paged serving on "dist" of the traffic's first n_req requests (at most
    EP_SERVE_GEN tokens each) at 64 slots; dropless, the gate with the
    routing pinned and the serving arm (TP_MOE_DL_REQS requests on
    TP_MOE_DL_SLOTS slots, at most EP_DL_GEN tokens each) whose streams are
    held to the plain engine; then the fused layer forms. Returns the kernel
    rows and the launch counts and metrics of each phase."""
    import triton_dist_tpu_torch.kernels as k
    import triton_dist_tpu_torch.models as m
    t0 = time.perf_counter()
    rows = tp_moe_kernel_rows(mesh)
    print(f"[tp-moe {time.perf_counter() - t0:.1f} s] kernel rows done", flush=True)
    cfg = m.qwen3_30b_a3b()
    if one is None:
        if n_layers is not None:
            import dataclasses
            cfg = dataclasses.replace(cfg, num_layers=n_layers)
        one = m.AutoLLM.from_config(cfg, device=mesh.devices[0], seed=0, capacity_factor=2.0)
    one = cut_layers(one, n_layers)
    cfg = one.config
    model = one.to_mesh(mesh, "tp")
    gen = torch.Generator(device=mesh.devices[0]).manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=mesh.devices[0])
    reqs = [m.Request(r.rid, r.ids, min(r.gen_len, EP_SERVE_GEN))
            for r in serving_requests(m, cfg.vocab_size, max(n_req, TP_MOE_DL_REQS))]
    res = {}
    for backend in TP_MOE_BACKENDS:
        res[backend] = tp_moe_engine_check(m, k, mesh, model, ids, backend, card)
        print(f"[tp-moe {time.perf_counter() - t0:.1f} s] engine {backend} done", flush=True)
    dist_kernels = ("grouped_gemm", "ag_gemm", "gemm_rs", "all_gather", "reduce_scatter")
    res["dist"]["paged"], _, _ = moe_serving_check(
        m, k, mesh, model, reqs[:n_req], "dist", card, SERVE_B, dist_kernels,
        tp_moe_allowed("dist") + ("flash_decode_paged",), "tp-moe")
    print(f"[tp-moe {time.perf_counter() - t0:.1f} s] serving dist done", flush=True)
    set_capacity(one, "dropless")
    set_capacity(model, "dropless")
    try:
        for backend, pre in TP_MOE_BACKENDS.items():
            kw = {} if pre is None else {"prefill_backend": pre}
            res[backend].update(moe_gate(m, mesh, one, model, ids, backend, "tp-moe", **kw))
            dl = [m.Request(r.rid, r.ids, min(r.gen_len, EP_DL_GEN))
                  for r in reqs[:TP_MOE_DL_REQS]]
            # the admissions run on the prefill backend ("gemm_ar": "flash",
            # no comm kernel), the ticks on the backend
            _, out, st = moe_serving_check(
                m, k, mesh, model, dl, backend, card, TP_MOE_DL_SLOTS,
                dist_kernels if backend == "dist" else ("grouped_gemm",),
                tp_moe_allowed(backend) + tp_moe_allowed(pre or backend)
                + ("flash_decode_paged",), "tp-moe", **kw)
            check(st["moe_capacity_drops"] == 0,
                  f"tp-moe serving {backend} dropless: {st['moe_capacity_drops']} drops")
            forced, worst = moe_served_check(m, mesh, one, model, backend, dl, out,
                                             f"tp-moe serving {backend} dropless", **kw)
            res[backend]["served"] = dict(forced=forced, worst=worst)
            print(f"serving tp-moe {backend} dropless: {forced} served tokens of {len(dl)} "
                  f"requests checked against the forward's argmax (margin rule at "
                  f"{MOE_SERVE_LIMIT}), its logits within {worst:.5f} of the one-rank plain "
                  f"engine's (routing pinned, limit {MOE_LIMIT})", flush=True)
            print(f"[tp-moe {time.perf_counter() - t0:.1f} s] dropless {backend} done",
                  flush=True)
    finally:
        set_capacity(one, 2.0)
        set_capacity(model, 2.0)
    res["layer"] = tp_moe_layer_check(mesh, model)
    print(f"[tp-moe {time.perf_counter() - t0:.1f} s] fused layer forms done", flush=True)
    del model
    return dict(rows=rows, counts=res)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1,
                    help="1: four ranks emulated on cuda:0; 4: cuda:0-3")
    ap.add_argument("--layers", type=int, default=None, help="cut the model's depth")
    ap.add_argument("--requests", type=int, default=N_REQ)
    ap.add_argument("--json", default=None, help="write the rows and summary here")
    ap.add_argument("--ep", action="store_true",
                    help="the expert-parallel checks alone (run_ep, Qwen3-30B-A3B)")
    ap.add_argument("--tp-moe", action="store_true",
                    help="the tensor-parallel MoE checks alone (run_tp_moe, Qwen3-30B-A3B)")
    ap.add_argument("--sp", action="store_true",
                    help="the sequence-parallel checks alone (tools/sp_check.py run_sp, "
                         "Qwen3-1.7B)")
    ap.add_argument("--pp", action="store_true",
                    help="the pipeline-parallel checks alone (tools/pp_check.py run_pp, "
                         "Qwen3-1.7B's MLP blocks)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("tp_check needs an NVIDIA card")
    from triton_dist_tpu_torch.kernels import _build
    from triton_dist_tpu_torch.runtime import make_mesh
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.ext()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    if args.cards == 4:
        if torch.cuda.device_count() < 4:
            raise RuntimeError(f"--cards 4 needs four cards; {torch.cuda.device_count()} "
                               "visible")
        mesh = make_mesh(4)
    elif args.cards == 1:
        mesh = make_mesh(4, devices=["cuda:0"] * 4)
    else:
        raise ValueError("--cards is 1 or 4")
    if args.pp:
        from triton_dist_tpu_torch.tools.pp_check import run_pp
        res = run_pp(mesh, card=card.replace("\n", "; "), n_layers=args.layers)
    elif args.sp:
        from triton_dist_tpu_torch.tools.sp_check import SP_REQS, run_sp
        res = run_sp(mesh, card=card.replace("\n", "; "), n_layers=args.layers,
                     n_req=min(args.requests, SP_REQS))
    else:
        fn = run_tp_moe if args.tp_moe else run_ep if args.ep else run
        res = fn(mesh, card=card.replace("\n", "; "), n_layers=args.layers,
                 n_req=args.requests)
    summary = {b: {kk: v for kk, v in c.items()
                   if kk in ("ms_per_step", "idle", "gaps", "prefill_ms", "served") or "ms" in kk
                   or kk.startswith(("ep_fused", "fused"))}
               for b, c in res["counts"].items()}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=card, mesh=[str(d) for d in mesh.devices], rows=res["rows"],
                           engine=summary), f, indent=1)
    print(json.dumps(dict(ok=True, mesh=[str(d) for d in mesh.devices], engine=summary)),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
