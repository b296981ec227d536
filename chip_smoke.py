#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (triton_dist_tpu_torch) on one
NVIDIA card: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the CUDA kernels from kernels/csrc/ (one
   torch.utils.cpp_extension.load of every source and the binding, into
   build/torch_ext/) and prints the build seconds.
3. Kernel phase: at the shapes of the main path (Qwen3-1.7B, B=128,
   S=128), holds each kernel against its plain PyTorch version on the
   same inputs, with the tolerance stated, and times the kernel, the
   plain version and one PyTorch library call of the same function with
   CUDA events. bound_ms is the larger of bytes / HBM rate and flops /
   bf16 peak, from the H100 SXM data sheet.
4. Engine phases, bf16 then int8 (quantize_int8 weights and an int8 KV
   cache): Qwen3-1.7B at full width (28 layers, random weights from a
   seeded torch.Generator), Engine(backend="flash") prefill and decode.
   Launch counts are reset just before prefill and before decode and
   read just after each; every kernel must have run in both. The logits
   are then checked, teacher-forced, against the plain ("xla") backend.
5. Prints one JSON line of per-kernel results, then, last, the device
   line {"ok": true, "device": {...}}.

Exits non-zero, printing no result, if there is no CUDA device, if the
package is not beside this script, or if any phase fails.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor-core peak, same source
B, S, GEN, T_KERNEL, KV_DECODE = 128, 128, 32, 264, 200
TF_STEPS = 8                   # teacher-forced decode steps checked per phase


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn() on the card, one CUDA event pair each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(out, ref) -> float:
    return (out.float() - ref.float()).abs().max().item()


def kernel_phase(k, gen):
    """Each kernel against its plain version at the main path's shapes."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    Hq, Hkv, d, I = 16, 8, 128, 6144
    rows = []

    def row(name, case, source, replaces, out, ref, tol, kernel_fn, plain_fn,
            library_fn, nbytes, flops, launch_key):
        err = max_err(out, ref)
        check(err <= tol, f"{name} {case}: max_abs_err {err} > tol {tol}")
        b_ms, b_by = bound(nbytes, flops)
        r = dict(name=name, case=case, route="cuda", source=source,
                 replaces=replaces, launches=None, max_abs_err=err, tol=tol,
                 ms=cuda_ms(kernel_fn), plain_ms=cuda_ms(plain_fn, reps=5),
                 bound_ms=b_ms, bound_by=b_by,
                 library_ms=None if library_fn is None else cuda_ms(library_fn))
        rows.append((r, launch_key))
        print(f"kernel {name} [{case}]: max_abs_err {err:.3g} (tol {tol:.3g}) "
              f"ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
              f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} "
              f"bound_ms {b_ms:.4f} ({b_by})", flush=True)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    fd_src = "triton_dist_tpu_torch/kernels/csrc/flash_decode.cu"
    fd_rep = "triton_dist_tpu/kernels/flash_attn.py:406"
    for phase, Sq, kv_len in (("prefill", S, S), ("decode", 1, KV_DECODE)):
        q = randn(B, Sq, Hq, d)
        # the cache tail past kv_len holds large values (and, once
        # quantized, large scales): a kernel that reads one key past
        # kv_len puts nearly all its weight there and fails the check
        kc = randn(B, Hkv, T_KERNEL, d)
        vc = randn(B, Hkv, T_KERNEL, d)
        kc[:, :, kv_len:] *= 100
        vc[:, :, kv_len:] *= 100
        # causal work: row s sees kv_len - Sq + s + 1 keys; QK and PV 2*d each
        keys = sum(kv_len - Sq + s + 1 for s in range(Sq)) * B * Hq
        flops = 4 * d * keys
        qo_bytes = 2 * q.numel() * 2
        kv_bytes = 2 * B * Hkv * kv_len * d
        for kvt in ("bf16", "int8"):
            if kvt == "bf16":
                kw = {}
                kk, vv = kc, vc
                nbytes = qo_bytes + 2 * kv_bytes
                qT = q.transpose(1, 2)
                kT, vT = kc[:, :, :kv_len], vc[:, :, :kv_len]
                library = (lambda qT=qT, kT=kT, vT=vT, c=Sq > 1:
                           F.scaled_dot_product_attention(qT, kT, vT, is_causal=c,
                                                          enable_gqa=True))
            else:
                kk, ks = k.quantize_kv_int8(kc)
                vv, vs = k.quantize_kv_int8(vc)
                kw = dict(k_scale=ks, v_scale=vs)
                nbytes = qo_bytes + kv_bytes + 2 * B * Hkv * kv_len * 4
                library = None      # no one PyTorch call takes an int8 cache
            out = k.flash_decode(q, kk, vv, kv_len, **kw)
            ref = k.flash_decode_ref(q, kk, vv, kv_len, **kw)
            torch.cuda.synchronize()
            row("flash_decode", f"{phase} S={Sq} kv_len={kv_len} T={T_KERNEL} {kvt}",
                fd_src, fd_rep, out, ref, 1e-2 * (1 + ref.float().abs().max().item()),
                lambda: k.flash_decode(q, kk, vv, kv_len, **kw),
                lambda: k.flash_decode_ref(q, kk, vv, kv_len, **kw),
                library, nbytes, flops, (kvt, phase))

    kv_src = "triton_dist_tpu_torch/kernels/csrc/kv_update.cu"
    kv_rep = "triton_dist_tpu/kernels/flash_attn.py:448"
    for phase, Sn, pos in (("prefill", S, 0), ("decode", 1, KV_DECODE - 1)):
        for kvt, dt in (("bf16", torch.bfloat16), ("int8", torch.int8)):
            # new rows as the layer hands them over: a [B, Hkv, S, d] view
            # of [B, S, Hkv, d]
            src = randn(B, Sn, Hkv, d).mul(20).to(dt)
            new = src.transpose(1, 2)
            cache = torch.zeros(B, Hkv, T_KERNEL, d, device=dev, dtype=dt)
            out = k.kv_update(cache.clone(), new, pos)
            ref = k.kv_update_ref(cache.clone(), new, pos)
            torch.cuda.synchronize()
            idx = torch.arange(pos, pos + Sn, device=dev)
            row("kv_update", f"{phase} S={Sn} pos={pos} T={T_KERNEL} {kvt}", kv_src,
                kv_rep, out, ref, 0.0, lambda: k.kv_update(cache, new, pos),
                lambda: k.kv_update_ref(cache, new, pos),
                lambda: cache.index_copy_(2, idx, new),
                2 * new.numel() * new.element_size(), 0, (kvt, phase))

    sw_src = "triton_dist_tpu_torch/kernels/csrc/swiglu.cu"
    sw_rep = "triton_dist_tpu/kernels/swiglu.py:51"
    for phase, M in (("prefill", B * S), ("decode", B)):
        x = randn(M, 2 * I) * 3
        out = k.swiglu(x)
        ref = k.swiglu_ref(x)
        torch.cuda.synchronize()
        g, u = x.chunk(2, dim=-1)
        # bitwise: the plain version rounds in the kernel's order (sigmoid
        # in f32 rounded to bf16, then two rounded products), so a kernel
        # that drops a rounding step differs from it in the last bit
        differ = int((out.view(torch.int16) != ref.view(torch.int16)).sum())
        check(differ == 0, f"swiglu M={M}: {differ} elements differ from the "
                           "plain version in their bits")
        row("swiglu", f"{phase} M={M} I={I} bf16", sw_src, sw_rep, out, ref,
            0.0, lambda: k.swiglu(x),
            lambda: k.swiglu_ref(x), lambda: F.silu(g) * u,
            3 * M * I * 2, 0, ("bf16", phase))
    return rows


def profile_decode(model, cache, toks, label, step_s):
    """Device time of two decode steps by kernel (torch.profiler), beside the
    step's wall time from the timed run: what share of a step the card
    is busy, and with what."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(toks.shape[1]):
            model.forward_tokens(toks[:, t].long()[:, None], cache, mode="flash")
        torch.cuda.synchronize()
    # device-side events only (kernels, copies, fills); the operator rows
    # on the host carry their kernels' device time too
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    steps = toks.shape[1]
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3 / steps
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:8]
    print(f"profile {label} decode: device busy {busy_ms:.3f} ms per step of "
          f"{step_s * 1e3:.3f} ms wall ({1 - busy_ms / (step_s * 1e3):.1%} idle); "
          f"device launches per step {sum(e.count for e in ev) // steps}; top: "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3 / steps:.3f} ms"
                      for e in top), flush=True)


def engine_phase(m, k, model, kv_dtype, label, ids, card):
    """Drive Engine(backend="flash") prefill + decode through the entry
    points, with the launch counts read around each; then hold the
    logits against the plain backend, teacher-forced."""
    eng = m.Engine(model, max_seq=S + GEN + 8, backend="flash", kv_dtype=kv_dtype)
    # warm-up (cuBLAS handles and heuristics, allocator), not counted
    eng.decode(*eng.prefill(ids), 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = eng.prefill(ids)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    c_prefill = k.launch_counts()
    k.reset_launch_counts()
    t0 = time.perf_counter()
    toks = eng.decode(logits, cache, GEN)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    c_decode = k.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for name in c_prefill:
        check(c_prefill[name] > 0 and c_decode[name] > 0,
              f"{label}: kernel {name} did not run on the main path "
              f"(prefill {c_prefill[name]}, decode {c_decode[name]})")
    check(tuple(toks.shape) == (B, GEN), f"{label}: tokens {tuple(toks.shape)}")
    check(bool(torch.isfinite(logits).all()), f"{label}: non-finite logits")
    print(f"engine {label} on {card}: prefill {prefill_s * 1e3:.1f} ms (B={B}, S={S}), "
          f"decode {GEN} steps {decode_s * 1e3:.1f} ms "
          f"({decode_s * 1e3 / GEN:.2f} ms/step) = "
          f"{B * GEN / decode_s:.1f} tok/s, peak memory {peak / 2**30:.2f} GiB; "
          f"launches prefill {c_prefill} decode {c_decode}", flush=True)

    # teacher-forced check: feed both backends the flash tokens and hold
    # the logits together at every step; greedy tokens must agree
    # wherever the plain backend's top-2 margin exceeds the tolerance
    ref_eng = m.Engine(model, max_seq=S + GEN + 8, backend="xla", kv_dtype=kv_dtype)
    lf, cf = eng.prefill(ids)
    lr, cr = ref_eng.prefill(ids)
    errs, tols, forced = [], [], 0
    for t in range(TF_STEPS + 1):
        # 5e-2 of the largest logit. The clean gap is about 2% (bf16
        # activations through 28 layers; the kernel rounds P to bf16
        # before the PV product, as the TPU kernel does, and the plain
        # attention keeps it in f32). Planted attention faults (a causal
        # leak, a dropped newest key, a missing softmax or V scale) give
        # 25% or more at their worst step
        # (triton_dist_tpu_torch/tools/fault_margin.py); a
        # read one key past kv_len stays within the clean gap here and is
        # caught by the kernel phase's cache-tail check instead.
        tol = 5e-2 * lr.abs().max().item()
        err = (lf - lr).abs().max().item()
        errs.append(err)
        tols.append(tol)
        check(err <= tol, f"{label}: step {t} logits max|d| {err} > tol {tol}")
        top2 = lr.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * tol
        agree = torch.argmax(lf, -1) == torch.argmax(lr, -1)
        check(bool(agree[sure].all()), f"{label}: step {t} greedy token differs "
                                       "where the margin exceeds the tolerance")
        forced += int(sure.sum())
        if t == TF_STEPS:
            break
        tok = toks[:, t].long()[:, None]
        lf, cf = model.forward_tokens(tok, cf, mode="flash")
        lr, cr = model.forward_tokens(tok, cr, mode="xla")
    profile_decode(model, cf, toks[:, TF_STEPS:TF_STEPS + 2], label, decode_s / GEN)
    print(f"engine {label}: teacher-forced vs plain backend, prefill and "
          f"{TF_STEPS} steps: max|d logits| per step "
          f"{[round(e, 4) for e in errs]} (tol {[round(x, 4) for x in tols]}), "
          f"{forced} greedy tokens checked", flush=True)
    return dict(prefill=c_prefill, decode=c_decode)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import triton_dist_tpu_torch.kernels as k
        import triton_dist_tpu_torch.models as m
        from triton_dist_tpu_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script: {e}",
              file=sys.stderr)
        return 2

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.ext()
    print(f"build: {time.perf_counter() - t0:.1f} s (cpp_extension.load of "
          f"{', '.join(_build.KERNELS)} and the binding)", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = kernel_phase(k, gen)

    cfg = m.qwen3_1p7b()
    ids = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
    model = m.AutoLLM.from_config(cfg, device="cuda", seed=0)
    counts = {"bf16": engine_phase(m, k, model, None, "bf16", ids, card)}
    model = model.quantize_int8()
    counts["int8"] = engine_phase(m, k, model, torch.int8, "int8", ids, card)

    out = []
    for r, (kvt, phase) in rows:
        r["launches"] = counts[kvt][phase][r["name"]]
        out.append(r)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
