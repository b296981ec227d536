"""Tensor-parallel checks of the port on the card: the six collectives'
kernels against their plain versions, and Qwen3 decode and paged serving
over a mesh of four ranks against the one-rank plain engine.

    python3 -m triton_dist_tpu_torch.tools.tp_check [--cards 4] [--json PATH]

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
  128-token prompt, Engine(backend="ar", "gemm_ar" and "dist") over the
  mesh: on "ar"/"gemm_ar" prefill launches no comm kernel (it runs on
  "xla"), decode launches the layers' kernels and its comm kernel, "ar"
  its all_reduce two-shot only (3 x 512 KiB > 1 MiB); on "dist" prefill
  and decode each launch the layers' kernels and exactly two ag_gemm and
  two gemm_rs a layer and forward, and no other comm kernel; the logits,
  teacher-forced, held to the one-rank "xla" engine by the margin rule
  (tools/checks.py, GATE);
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
import json
import statistics
import subprocess
import time

import torch

from triton_dist_tpu_torch.tools.checks import (  # noqa: F401 (GATE: fault_margin.py)
    GATE, check, margin_gate, only_launched, serving_requests, tf_gate)

# gemm_allreduce, ag_gemm and gemm_rs against their plain versions: max
# |d| over max |plain| (tools/fault_margin.py --tp)
GEMM_AR_LIMIT = 2e-2
AG_GEMM_LIMIT = 2e-2
GEMM_RS_LIMIT = 2e-2
CALLS = 3                       # fresh-input calls checked per kernel row
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
}
# the comm kernels each backend runs (the one-rank GEMM kernel, "gemm",
# runs on none of them at n > 1)
BACKEND_COMM = {"ar": ("all_reduce",), "gemm_ar": ("gemm_allreduce",),
                "dist": ("ag_gemm", "gemm_rs")}


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

    def row(name, case, fresh, kernel, plain, library, nbytes_io, payload, op, tol_rel,
            flops=0.0, flops_per_s=BF16_FLOPS_PER_S):
        """fresh() -> inputs; kernel(inputs) and plain(inputs) -> per-rank
        lists. tol_rel None: bitwise, and every rank's copy equal where
        the result is replicated (all but reduce_scatter)."""
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
                    check(name == "reduce_scatter" or torch.equal(o, out[0].to(mesh.devices[0])),
                          f"{name} [{case}]: rank {r}'s copy differs from rank 0's")
                else:
                    err = ((o.float() - p.float()).abs().max()
                           / p.float().abs().max().clamp_min(1e-30)).item()
                    worst = max(worst, err)
                    check(err <= tol_rel, f"{name} [{case}] rank {r}: {err:.3g} of max > "
                          f"{tol_rel}")
        args = fresh()
        b_ms, b_by = bound_ms(mesh, op, nbytes_io, payload, flops, flops_per_s)
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
            (n * M + M) * cols * es, M * cols * es, "rs", None)
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


def idle_share(fn, steps: int, wall_s: float, label: str) -> float:
    """torch.profiler over fn() (steps decode steps): the device's busy
    ms per step against the timed run's wall ms per step."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in ev) / 1e3 / steps
    idle = 1 - busy / (wall_s * 1e3)
    print(f"profile {label}: device busy {busy:.3f} ms per step of {wall_s * 1e3:.3f} ms "
          f"wall ({idle:.1%} idle, busy summed over the mesh's devices), "
          f"{sum(e.count for e in ev) // steps} device launches per step", flush=True)
    return idle


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
    if backend == "dist":
        # prefill through the rings too: two ag_gemm and two gemm_rs a
        # layer and forward
        want = 2 * L * per_call
        for name in comm:
            check(c_prefill[name] == want and c_decode[name] == want * GEN,
                  f"tp dist: {name} launched {c_prefill[name]} times in prefill, "
                  f"{c_decode[name]} in decode; want {want} and {want * GEN}")
        only_launched(c_prefill, path, "tp dist prefill")
    else:
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
    idle = idle_share(lambda: [eng.decode_step(toks[:, t], cf) for t in range(TF_STEPS,
                                                                               TF_STEPS + 2)],
                      2, decode_s / GEN, f"tp {backend} decode")
    print(f"engine tp={mesh.size} {backend}: teacher-forced vs one-rank xla, prefill and "
          f"{TF_STEPS} steps: max|d| / max|ref| per step {[round(e, 5) for e in errs]} "
          f"(gate {GATE}), {forced} greedy tokens checked", flush=True)
    return dict(prefill=c_prefill, decode=c_decode, ms_per_step=step_ms, idle=idle,
                gaps=errs, prefill_ms=prefill_s * 1e3)


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


def run(mesh, *, card: str, n_layers=None, n_req: int = N_REQ) -> dict:
    """Every check on `mesh`; returns the kernel rows and the launch counts
    of each phase."""
    import triton_dist_tpu_torch.kernels as k
    import triton_dist_tpu_torch.models as m
    t0 = time.perf_counter()
    rows = kernel_rows(mesh)
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
    for backend in ("ar", "gemm_ar", "dist"):
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1,
                    help="1: four ranks emulated on cuda:0; 4: cuda:0-3")
    ap.add_argument("--layers", type=int, default=None, help="cut the model's depth")
    ap.add_argument("--requests", type=int, default=N_REQ)
    ap.add_argument("--json", default=None, help="write the rows and summary here")
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
    res = run(mesh, card=card.replace("\n", "; "), n_layers=args.layers,
              n_req=args.requests)
    summary = {b: {kk: v for kk, v in c.items()
                   if kk in ("ms_per_step", "idle", "gaps", "prefill_ms")}
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
