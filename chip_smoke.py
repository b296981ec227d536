#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (triton_dist_tpu_torch) on one
NVIDIA card: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the CUDA kernels from kernels/csrc/ (one
   torch.utils.cpp_extension.load of every source and the binding, into
   build/torch_ext/) and prints the build seconds.
3. Kernel phase: at the shapes of the main path (Qwen3-1.7B, B=128,
   S=128; the serving tick's B=128 slots with seeded mixed lengths in
   [1, 264] for flash_decode_paged and flash_decode with per-row
   kv_lens), holds each kernel against its plain PyTorch version on the
   same inputs, with the tolerance stated, and times the kernel, the
   plain version and one PyTorch library call of the same function
   (where there is one) with CUDA events. bound_ms is the larger of
   bytes / HBM rate and flops / bf16 peak, from the H100 SXM data
   sheet, counting the bytes this run's lengths need.
4. Engine phases, bf16 then int8 (quantize_int8 weights and an int8 KV
   cache): Qwen3-1.7B at full width (28 layers, random weights from a
   seeded torch.Generator), Engine(backend="flash") prefill and decode.
   Launch counts are reset just before prefill and before decode and
   read just after each; every kernel of that path (flash_decode,
   kv_update, swiglu) must have run in both. The logits
   are then checked, teacher-forced, against the plain ("xla") backend.
5. Serving phases: the same model through ContinuousScheduler
   (Engine(backend="flash")), 128 seeded requests over 64 slots, chunk
   16: four 96-token system prompts, each shared by 32 requests, with
   distinct 16-48-token tails and 32-64-token budgets. The paged
   scheduler with the radix prefix cache (page 16) in bf16 and int8,
   then the contiguous scheduler in bf16. Launch counts are reset just
   before each run and read just after; every kernel of the path must
   have run, and the paged runs must hit the prefix cache. Tokens of 8
   seeded-chosen requests are held, teacher-forced, against the plain
   ("xla") contiguous engine. A tick probe then runs one bare tick under
   torch.cuda.set_sync_debug_mode("error") (a tick that synchronises
   with the host fails) and one under torch.profiler (the idle share).
6. Prints one JSON line of per-kernel results, then, last, the device
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

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor-core peak, same source
B, S, GEN, T_KERNEL, KV_DECODE = 128, 128, 32, 264, 200
TF_STEPS = 8                   # teacher-forced decode steps checked per phase
PAGE = 16
# serving: slots, chunk, slot capacity (prompt <= 144 + gen <= 64 plus the
# paged pool's chunk margin of 15), requests, system prompts and their
# length, requests teacher-forced against the plain engine
SERVE_B, SERVE_CHUNK, SERVE_MAX_SEQ = 64, 16, 224
N_REQ, N_SYS, SYS_LEN, TF_REQS = 128, 4, 96, 8


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

    # the serving tick: B slots at seeded mixed lengths, one query each;
    # one length ends mid-page, one on a page boundary, one at 1
    lens = torch.randint(1, T_KERNEL + 1, (B,), generator=gen, device=dev,
                         dtype=torch.int32)
    lens[:3] = torch.tensor([T_KERNEL, 16 * PAGE, 1], dtype=torch.int32)
    n_keys = int(lens.sum())
    q1 = randn(B, 1, Hq, d)
    flops = 4 * d * Hq * n_keys
    q_bytes = 2 * q1.numel() * 2
    t_idx = torch.arange(T_KERNEL, device=dev)
    valid = t_idx[None, :] < lens[:, None]                      # [B, T]

    # flash_decode with per-row kv_lens over the contiguous cache, the
    # cache past each row's length filled with 100x values
    kc = randn(B, Hkv, T_KERNEL, d)
    vc = randn(B, Hkv, T_KERNEL, d)
    kc[~valid[:, None, :, None].expand_as(kc)] *= 100
    vc[~valid[:, None, :, None].expand_as(vc)] *= 100
    sdpa_mask = valid[:, None, None, :]
    for kvt in ("bf16", "int8"):
        if kvt == "bf16":
            kw, kk, vv = {}, kc, vc
            nbytes = q_bytes + 2 * Hkv * n_keys * d * 2 + B * 4
            library = (lambda: F.scaled_dot_product_attention(
                q1.transpose(1, 2), kc, vc, attn_mask=sdpa_mask, enable_gqa=True))
        else:
            kk, ks = k.quantize_kv_int8(kc)
            vv, vs = k.quantize_kv_int8(vc)
            kw = dict(k_scale=ks, v_scale=vs)
            nbytes = q_bytes + 2 * Hkv * n_keys * (d + 4) + B * 4
            library = None      # no one PyTorch call takes an int8 cache
        out = k.flash_decode(q1, kk, vv, kv_lens=lens, **kw)
        ref = k.flash_decode_ref(q1, kk, vv, kv_lens=lens, **kw)
        torch.cuda.synchronize()
        row("flash_decode", f"slots S=1 kv_lens in [1, {T_KERNEL}] T={T_KERNEL} {kvt}",
            fd_src, fd_rep, out, ref, 1e-2 * (1 + ref.float().abs().max().item()),
            lambda: k.flash_decode(q1, kk, vv, kv_lens=lens, **kw),
            lambda: k.flash_decode_ref(q1, kk, vv, kv_lens=lens, **kw),
            library, nbytes, flops,
            # launches: those of the contiguous serving run (bf16); int8
            # serves paged only, so its row counts flash_decode's
            # launches in the paged int8 run (its admissions)
            (kvt, "contiguous" if kvt == "bf16" else "paged"))

    # flash_decode_paged: the table maps each stream's tiles to a random
    # permutation of the pool; entries past a stream's pages point at
    # random pages, and every row no stream uses (the trash page 0, pages
    # no table maps, rows past each stream's length) holds 100x values,
    # and so, once quantized, 100x scales
    maxp = -(-T_KERNEL // PAGE)
    X = B * Hkv
    NP = 1 + X * maxp
    table = (1 + torch.randperm(NP - 1, generator=gen, device=dev)[:X * maxp]
             ).reshape(X, maxp).to(torch.int32)
    lens_x = lens.repeat_interleave(Hkv)
    n_pages = (lens_x + PAGE - 1) // PAGE
    past = torch.arange(maxp, device=dev)[None, :] >= n_pages[:, None]
    table[past] = torch.randint(0, NP, (int(past.sum()),), generator=gen, device=dev,
                                dtype=torch.int32)
    used = torch.zeros(NP * PAGE, dtype=torch.bool, device=dev)
    pos = torch.arange(maxp * PAGE, device=dev)
    live = pos[None, :] < lens_x[:, None]
    used[(table.long()[:, pos // PAGE] * PAGE + pos % PAGE)[live]] = True
    used = used.reshape(NP, PAGE)
    pk = randn(NP, PAGE, d)
    pv = randn(NP, PAGE, d)
    pk[~used] *= 100
    pv[~used] *= 100
    fdp_src = "triton_dist_tpu_torch/kernels/csrc/flash_decode_paged.cu"
    fdp_rep = "triton_dist_tpu/kernels/paged_kv.py:411"
    table_bytes = int(n_pages.sum()) * 4
    for kvt in ("bf16", "int8"):
        if kvt == "bf16":
            kw, kk, vv = {}, pk, pv
            nbytes = q_bytes + 2 * Hkv * n_keys * d * 2 + table_bytes + B * 4
        else:
            kk, ks = k.quantize_kv_int8(pk)
            vv, vs = k.quantize_kv_int8(pv)
            kw = dict(k_scale=ks, v_scale=vs)
            nbytes = q_bytes + 2 * Hkv * n_keys * (d + 4) + table_bytes + B * 4
        out = k.flash_decode_paged(q1, kk, vv, table, kv_lens=lens, **kw)
        ref = k.flash_decode_paged_ref(q1, kk, vv, table, kv_lens=lens, **kw)
        torch.cuda.synchronize()
        # no one PyTorch call reads K/V through a page table: library null
        row("flash_decode_paged", f"slots S=1 kv_lens in [1, {T_KERNEL}] page={PAGE} "
            f"{kvt}", fdp_src, fdp_rep, out, ref,
            1e-2 * (1 + ref.float().abs().max().item()),
            lambda: k.flash_decode_paged(q1, kk, vv, table, kv_lens=lens, **kw),
            lambda: k.flash_decode_paged_ref(q1, kk, vv, table, kv_lens=lens, **kw),
            None, nbytes, flops, (kvt, "paged"))
    del kc, vc, pk, pv, kk, vv, kw
    torch.cuda.empty_cache()

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
    for name in ("flash_decode", "kv_update", "swiglu"):
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


def serving_requests(m, vocab: int):
    """The serving traffic, seeded: N_SYS system prompts of SYS_LEN
    tokens, each shared by N_REQ / N_SYS requests in a shuffled order,
    each request adding a distinct 16-48-token tail and asking for 32-64
    tokens."""
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, vocab, SYS_LEN) for _ in range(N_SYS)]
    which = rng.permutation(np.arange(N_REQ) % N_SYS)
    return [m.Request(rid=i, ids=np.concatenate(
                [prompts[w], rng.randint(0, vocab, rng.randint(16, 49))]).astype(np.int32),
                gen_len=int(rng.randint(32, 65)))
            for i, w in enumerate(which)]


def serving_phase(m, k, model, kv_dtype, label, paged, reqs, card):
    """Drive ContinuousScheduler through its entry points with the launch
    counts read around the run, then hold the tokens of TF_REQS seeded
    requests, teacher-forced, against the plain contiguous engine."""
    eng = m.Engine(model, max_seq=SERVE_MAX_SEQ, backend="flash", kv_dtype=kv_dtype)

    def scheduler():
        return m.ContinuousScheduler(eng, batch=SERVE_B, chunk=SERVE_CHUNK,
                                     paged=paged, page=PAGE)

    # warm-up (cuBLAS handles and heuristics, allocator), not counted
    scheduler().run(reqs[:2])
    sched = scheduler()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k.reset_launch_counts()
    t0 = time.perf_counter()
    out = sched.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = k.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    st = sched.stats()
    path = (("flash_decode_paged",) if paged else ()) + ("flash_decode", "kv_update",
                                                         "swiglu")
    for name in path:
        check(counts[name] > 0, f"{label}: kernel {name} did not run on the serving "
                                f"path ({counts})")
    check(not sched.rejected, f"{label}: rejected {sched.rejected}")
    check(all(len(out[r.rid]) == r.gen_len for r in reqs),
          f"{label}: a request did not get its budget")
    if paged:
        check(st["hits"] > 0, f"{label}: no prefix-cache hit")
    tokens = sum(r.gen_len for r in reqs)
    ttft, itl = st["ttft_ms"], st["inter_token_ms"]
    summary = dict(tok_per_s=tokens / wall, wall_s=wall, tokens=tokens,
                   ttft_p50_ms=ttft["p50"], ttft_p99_ms=ttft["p99"],
                   itl_p50_ms=itl["p50"], itl_p99_ms=itl["p99"],
                   prefill_skip_frac=st.get("prefill_skip_frac"), hits=st.get("hits"),
                   preemptions=st["preemptions"], peak_gib=peak / 2**30,
                   launches=counts)
    print(f"serving {label} on {card}: {json.dumps(summary)}", flush=True)
    tick_probe(m, eng, paged, reqs, label)

    # teacher-forced: the plain engine over prompt + emitted tokens; each
    # emitted token must be its argmax wherever its top-2 margin exceeds
    # twice 5e-2 of the largest logit (the engine phase's rule)
    ref = m.Engine(model, max_seq=SERVE_MAX_SEQ, backend="xla", kv_dtype=kv_dtype)
    picks = np.random.RandomState(2).choice(len(reqs), TF_REQS, replace=False)
    forced = 0
    for i in picks:
        r = reqs[i]
        toks = out[r.rid]
        logits, cache = ref.prefill(r.ids[None])
        for t in range(r.gen_len):
            tol = 5e-2 * logits.abs().max().item()
            top2 = logits[0].topk(2).values
            if (top2[0] - top2[1]).item() > 2 * tol:
                check(int(logits[0].argmax()) == int(toks[t]),
                      f"{label}: request {r.rid} token {t} differs from the plain "
                      "engine where the margin exceeds the tolerance")
                forced += 1
            logits, cache = model.forward_tokens(
                torch.tensor([[int(toks[t])]], device="cuda"), cache, mode="xla")
    check(forced > 0, f"{label}: no token passed the margin rule")
    print(f"serving {label}: teacher-forced vs plain contiguous engine, "
          f"{TF_REQS} requests, {forced} tokens checked", flush=True)
    del sched, eng, ref
    torch.cuda.empty_cache()
    return counts


def tick_probe(m, eng, paged, reqs, label):
    """One wave of SERVE_B requests admitted by one poll (timed), then two
    bare decode ticks of SERVE_CHUNK steps on the resulting slots: the
    first under torch.cuda.set_sync_debug_mode("error"), so a tick that
    synchronises with the host fails the run, and timed with no profiler;
    the second under torch.profiler for the device's busy time by
    kernel, hence the tick's idle share."""
    from torch.profiler import ProfilerActivity, profile
    sched = m.ContinuousScheduler(eng, batch=SERVE_B, chunk=SERVE_CHUNK, paged=paged,
                                  page=PAGE)
    for r in reqs[:SERVE_B]:
        sched.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched.poll()                         # SERVE_B admissions + one tick
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    slots = sched.slots
    tick = eng.paged_slot_chunk if paged else eng.slot_chunk

    def run_tick():
        _, slots.logits, slots.cache, slots.pos = tick(
            slots.logits, slots.cache, slots.pos, slots.active, chunk=SERVE_CHUNK)

    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run_tick()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    tick_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_tick()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3 / SERVE_CHUNK
    step_ms = tick_s * 1e3 / SERVE_CHUNK
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:6]
    print(f"tick {label}: first poll ({SERVE_B} admissions + one tick) "
          f"{first_s * 1e3:.1f} ms; a bare tick of {SERVE_CHUNK} steps with no "
          f"host sync (sync debug mode 'error'): {step_ms:.3f} ms/step wall, device "
          f"busy {busy_ms:.3f} ms/step ({1 - busy_ms / step_ms:.1%} idle), "
          f"device launches per step {sum(e.count for e in ev) // SERVE_CHUNK}; top: "
          + "; ".join(f"{e.key[:50]} {e.self_device_time_total / 1e3 / SERVE_CHUNK:.3f} ms"
                      for e in top), flush=True)
    del sched, slots


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

    reqs = serving_requests(m, cfg.vocab_size)
    model = m.AutoLLM.from_config(cfg, device="cuda", seed=0)
    counts["bf16"]["paged"] = serving_phase(m, k, model, None, "paged bf16", True, reqs,
                                            card)
    counts["bf16"]["contiguous"] = serving_phase(m, k, model, None, "contiguous bf16",
                                                 False, reqs, card)
    model = model.quantize_int8()
    counts["int8"]["paged"] = serving_phase(m, k, model, torch.int8, "paged int8", True,
                                            reqs, card)

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
