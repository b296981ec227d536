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
6. Megakernel phases (backend="mega", one persistent CUDA kernel per
   decode layer): rows 5a (mega_decode, B=128, pos=200, T=264) and 6a/6b
   (mega_paged_decode, 64 slots at lengths in [1, 224], page 16, bf16 and
   int8 pools, two retired slots on the trash page), each held against
   its plain version with the cache past each length, unmapped pages and
   the trash page poisoned with 100x values, and timed beside the port's
   per-op flash layer (layers/tp_attn.py + tp_mlp.py) on the same inputs;
   the engine phase on "mega" (bf16: prefill on flash, 32 decode steps of
   28 megakernel launches each, teacher-forced against the plain backend,
   profiled); the paged serving phases on "mega" (bf16 and int8 KV, the
   same 128 requests), with their tick probes. Launch checks: exactly 28
   megakernel launches per decode step and per tick step, no
   flash_decode_paged or swiglu launch inside a mega tick, flash_decode
   and kv_update launched only by the admissions.
7. Prints one JSON line of per-kernel results, then, last, the device
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
N_LAYERS = 28                  # Qwen3-1.7B: one megakernel launch per layer per step
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


def mega_kernel_phase(gen):
    """Rows 5a, 6a, 6b: each megakernel layer against its plain version at
    Qwen3-1.7B's width (D=2048, F=6144, Hq=16, Hkv=8, hd=128), timed
    beside the port's per-op flash layer on the same inputs."""
    from triton_dist_tpu_torch.kernels.quant import quantize_kv_int8
    from triton_dist_tpu_torch.layers import TP_Attn, TP_MLP, precompute_rope, rms_norm
    from triton_dist_tpu_torch.mega import (MegaDecodeLayer, MegaPagedDecodeLayer,
                                            mega_decode_layer_ref,
                                            mega_paged_decode_layer_ref)
    dev = torch.device("cuda")
    D, F, Hq, Hkv, hd = 2048, 6144, 16, 8, 128
    rows = []

    def rn(*shape, sc=1.0):
        return torch.randn(shape, generator=gen, device=dev) * sc

    w = dict(w_ln1=1 + 0.1 * rn(1, D), q_norm=1 + 0.1 * rn(1, hd),
             k_norm=1 + 0.1 * rn(1, hd), w_ln2=1 + 0.1 * rn(1, D),
             w_qkv=rn(D, (Hq + 2 * Hkv) * hd, sc=D ** -0.5).bfloat16(),
             w_o=rn(Hq * hd, D, sc=(Hq * hd) ** -0.5).bfloat16(),
             w_gu=rn(D, 2 * F, sc=D ** -0.5).bfloat16(),
             w_d=rn(F, D, sc=F ** -0.5).bfloat16())
    n_params = D * (Hq + 2 * Hkv) * hd + Hq * hd * D + D * 2 * F + F * D
    cos, sin = precompute_rope(hd, 4096, device=dev)
    # the port's per-op flash layer over the same weights (the yardstick)
    attn = TP_Attn(w_qkv=w["w_qkv"], w_o=w["w_o"], q_norm=w["q_norm"].reshape(-1),
                   k_norm=w["k_norm"].reshape(-1), n_heads=Hq, n_kv_heads=Hkv, head_dim=hd)
    mlp = TP_MLP(w_gate_up=w["w_gu"], w_down=w["w_d"])

    def per_op(x, attend):
        xb = x.bfloat16()
        a, _ = attend(rms_norm(xb, w["w_ln1"].reshape(-1)))
        x2 = xb + a
        return x2 + mlp(rms_norm(x2, w["w_ln2"].reshape(-1)), "flash")

    def row(name, case, source, replaces, y, y_ref, live, pool_errs, kernel_fn, plain_fn,
            per_op_fn, nbytes, flops, launch_key):
        # the residual stream is O(1-10): f32 sums in another order over
        # K = 2048-6144 and the bf16 roundings of xn, q, P, attn, on and h
        # flipping by one ulp where the two land on a rounding boundary
        err = max_err(y[live], y_ref[live])
        tol = 1e-2 * (1 + y_ref[live].abs().max().item())
        check(err <= tol, f"{name} {case}: y max_abs_err {err} > tol {tol}")
        for what, e, t in pool_errs:
            check(e <= t, f"{name} {case}: {what} {e} > {t}")
        b_ms, b_by = bound(nbytes, flops)
        r = dict(name=name, case=case, route="cuda", source=source, replaces=replaces,
                 launches=None, max_abs_err=err, tol=tol, ms=cuda_ms(kernel_fn),
                 plain_ms=cuda_ms(plain_fn, reps=5), bound_ms=b_ms, bound_by=b_by,
                 library_ms=None, per_op_layer_ms=cuda_ms(per_op_fn),
                 pool_checks={what: e for what, e, _ in pool_errs})
        rows.append((r, launch_key))
        print(f"kernel {name} [{case}]: max_abs_err {err:.3g} (tol {tol:.3g}) ms "
              f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} per-op flash layer ms "
              f"{r['per_op_layer_ms']:.4f} bound_ms {b_ms:.4f} ({b_by}); pools "
              f"{r['pool_checks']}", flush=True)

    # 5a: contiguous, every row at pos; the cache past pos holds 100x values
    pos = KV_DECODE
    x = rn(B, D)
    wd = dict(w, cos_row=cos[pos:pos + 1], sin_row=sin[pos:pos + 1])
    ck = rn(B, Hkv, T_KERNEL, hd).bfloat16()
    cv = rn(B, Hkv, T_KERNEL, hd).bfloat16()
    ck[:, :, pos + 1:] *= 100
    cv[:, :, pos + 1:] *= 100
    layer = MegaDecodeLayer(d_model=D, n_heads=Hq, n_kv_heads=Hkv, head_dim=hd, ffn=F,
                            T=T_KERNEL)
    k1, v1, k2, v2 = ck.clone(), cv.clone(), ck.clone(), cv.clone()
    y, _, _ = layer(x, pos, wd, k1, v1)
    y_ref, _, _ = mega_decode_layer_ref(x, pos, wd, k2, v2, n_heads=Hq, n_kv_heads=Hkv,
                                        head_dim=hd)
    torch.cuda.synchronize()
    other = torch.arange(T_KERNEL, device=dev) != pos
    pool_errs = [
        # the new row: one bf16 ulp of the largest value, where the f32
        # row's rounding lands on the other side of a boundary
        ("new K/V rows max|d|", max(max_err(k1[:, :, pos], k2[:, :, pos]),
                                    max_err(v1[:, :, pos], v2[:, :, pos])),
         2 ** -7 * max(k2[:, :, pos].float().abs().max().item(),
                       v2[:, :, pos].float().abs().max().item())),
        ("other cache rows changed", float(((k1 != ck) | (v1 != cv))[:, :, other].sum()),
         0.0)]
    n_keys = B * Hkv * (pos + 1)
    kb, vb = k1.clone(), v1.clone()
    row("mega_decode", f"B={B} pos={pos} T={T_KERNEL} bf16",
        "triton_dist_tpu_torch/kernels/csrc/mega_decode.cu",
        "triton_dist_tpu/mega/decode_layer.py:462", y, y_ref, slice(None), pool_errs,
        lambda: layer(x, pos, wd, kb, vb),
        lambda: mega_decode_layer_ref(x, pos, wd, kb, vb, n_heads=Hq, n_kv_heads=Hkv,
                                      head_dim=hd),
        lambda: per_op(x, lambda h: attn.fwd_cached(h, cos, sin, B, (kb, vb), pos,
                                                    "flash")),
        2 * n_params + 2 * B * D * 4 + 2 * n_keys * hd * 2,
        2 * B * n_params + 4 * hd * Hq * B * (pos + 1), ("bf16", "mega decode"))
    del ck, cv, k1, v1, k2, v2, kb, vb
    torch.cuda.empty_cache()

    # 6a/6b: 64 slots at lengths in [1, 224]; slot b's new token sits at
    # lens[b] - 1. Two retired slots map only the trash page (their rows
    # are not compared: their writes race there). Entries past a stream's
    # pages point at random pages; every row no live stream reads or
    # writes (the trash page, unmapped pages, rows past each length)
    # holds 100x values.
    Bp, cap = SERVE_B, SERVE_MAX_SEQ
    maxp = cap // PAGE
    X = Bp * Hkv
    NP = 1 + X * maxp
    lens = torch.randint(1, cap + 1, (Bp,), generator=gen, device=dev, dtype=torch.int32)
    lens[:3] = torch.tensor([cap, 8 * PAGE, 1], dtype=torch.int32)
    posd = (lens - 1).to(torch.int32)
    table = (1 + torch.randperm(NP - 1, generator=gen, device=dev)[:X * maxp]
             ).reshape(X, maxp).to(torch.int32)
    lens_x = lens.repeat_interleave(Hkv)
    n_pages = (lens_x + PAGE - 1) // PAGE
    past = torch.arange(maxp, device=dev)[None, :] >= n_pages[:, None]
    table[past] = torch.randint(0, NP, (int(past.sum()),), generator=gen, device=dev,
                                dtype=torch.int32)
    retired = torch.zeros(Bp, dtype=torch.bool, device=dev)
    retired[-2:] = True
    table[retired.repeat_interleave(Hkv)] = 0
    live = ~retired
    tpos = torch.arange(maxp * PAGE, device=dev)
    used = torch.zeros(NP * PAGE, dtype=torch.bool, device=dev)
    reads = (tpos[None, :] < lens_x[:, None]) & live.repeat_interleave(Hkv)[:, None]
    used[(table.long()[:, tpos // PAGE] * PAGE + tpos % PAGE)[reads]] = True
    used = used.reshape(NP, PAGE)
    pk = rn(NP, 1, PAGE, hd)
    pv = rn(NP, 1, PAGE, hd)
    pk[:, 0][~used] *= 100
    pv[:, 0][~used] *= 100
    xp = rn(Bp, D)
    wp = dict(w, cos_row=cos[posd.long()], sin_row=sin[posd.long()])
    player = MegaPagedDecodeLayer(d_model=D, n_heads=Hq, n_kv_heads=Hkv, head_dim=hd,
                                  ffn=F, page=PAGE, maxp=maxp)
    n_keys = int(lens[live].sum()) * Hkv
    written = torch.zeros((NP, PAGE), dtype=torch.bool, device=dev)
    wpage = table.long()[torch.arange(X, device=dev), (lens_x - 1) // PAGE]
    written[wpage[live.repeat_interleave(Hkv)],
            ((lens_x - 1) % PAGE)[live.repeat_interleave(Hkv)]] = True
    keep = ~written
    keep[0] = False                      # the trash page: retired slots race there
    for kvt in ("bf16", "int8"):
        if kvt == "bf16":
            pools = (pk.bfloat16(), pv.bfloat16())
            kv_row = hd * 2
        else:
            qk, sk = quantize_kv_int8(pk)
            qv, sv = quantize_kv_int8(pv)
            pools = (qk, qv, sk, sv)
            kv_row = hd + 4
        a = [t.clone() for t in pools]
        b_ = [t.clone() for t in pools]
        out = player(xp, posd, wp, a[0], a[1], table, *a[2:])
        ref = mega_paged_decode_layer_ref(xp, posd, wp, b_[0], b_[1], table, *b_[2:],
                                          n_heads=Hq, n_kv_heads=Hkv, head_dim=hd)
        torch.cuda.synchronize()
        pool_errs = [("unwritten pool rows changed",
                      float(sum(int((o[:, 0][keep] != t[:, 0][keep]).sum())
                                for o, t in zip(out[1:], pools))), 0.0)]
        if kvt == "bf16":
            top = max(r_[:, 0][written].float().abs().max().item() for r_ in ref[1:3])
            pool_errs.append(("new rows max|d|", max(max_err(o[:, 0][written],
                                                             r_[:, 0][written])
                                                     for o, r_ in zip(out[1:3], ref[1:3])),
                              2 ** -7 * top))
        else:
            # an int8 level where the f32 row lands within a rounding
            # boundary of the plain version's; the scales to f32 rounding
            pool_errs.append(("new rows max|d int8|", max(max_err(o[:, 0][written],
                                                                  r_[:, 0][written])
                                                          for o, r_ in zip(out[1:3],
                                                                           ref[1:3])),
                              1.0))
            pool_errs.append(("new scales max rel|d|", max(
                ((o[:, 0][written] - r_[:, 0][written]).abs()
                 / r_[:, 0][written]).max().item() for o, r_ in zip(out[3:], ref[3:])),
                1e-2))
        c = [t.clone() for t in pools]
        attend_pools = (c[0], c[1]) + tuple(c[2:])
        row("mega_paged_decode", f"{Bp} slots lens in [1, {cap}] page={PAGE} {kvt}",
            "triton_dist_tpu_torch/kernels/csrc/mega_paged_decode.cu",
            "triton_dist_tpu/mega/decode_layer.py:919", out[0], ref[0], live, pool_errs,
            lambda: player(xp, posd, wp, c[0], c[1], table, *c[2:]),
            lambda: mega_paged_decode_layer_ref(xp, posd, wp, c[0], c[1], table, *c[2:],
                                                n_heads=Hq, n_kv_heads=Hkv, head_dim=hd),
            lambda: per_op(xp, lambda h: attn.fwd_cached_slots_paged(
                h, cos, sin, Bp, attend_pools, table, posd, "flash")),
            2 * n_params + 2 * Bp * D * 4 + 2 * n_keys * kv_row + int(
                n_pages[live.repeat_interleave(Hkv)].sum()) * 4,
            2 * Bp * n_params + 4 * hd * Hq * int(lens[live].sum()),
            (kvt, "mega paged"))
    return rows


def profile_decode(eng, cache, toks, label, step_s):
    """Device time of two decode steps by kernel (torch.profiler), beside the
    step's wall time from the timed run: what share of a step the card
    is busy, and with what."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(toks.shape[1]):
            eng.decode_step(toks[:, t], cache)
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


def engine_phase(m, k, model, kv_dtype, label, ids, card, backend="flash"):
    """Drive Engine(backend) prefill + decode through the entry points,
    with the launch counts read around each; then hold the logits against
    the plain backend, teacher-forced."""
    eng = m.Engine(model, max_seq=S + GEN + 8, backend=backend, kv_dtype=kv_dtype)
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
    per_op = ("flash_decode", "kv_update", "swiglu")
    for name in per_op:
        check(c_prefill[name] > 0 and (backend == "mega" or c_decode[name] > 0),
              f"{label}: kernel {name} did not run on the main path "
              f"(prefill {c_prefill[name]}, decode {c_decode[name]})")
    if backend == "mega":
        # decode is the megakernel alone: one launch per layer per step
        check(c_decode["mega_decode"] == N_LAYERS * GEN
              and all(c_decode[n] == 0 for n in per_op + ("flash_decode_paged",)),
              f"{label}: decode launches {c_decode}, want mega_decode == "
              f"{N_LAYERS * GEN} and no per-op kernel")
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
        lf = eng.decode_step(toks[:, t], cf)
        lr = ref_eng.decode_step(toks[:, t], cr)
    profile_decode(eng, cf, toks[:, TF_STEPS:TF_STEPS + 2], label, decode_s / GEN)
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


def serving_phase(m, k, model, kv_dtype, label, paged, reqs, card, backend="flash"):
    """Drive ContinuousScheduler through its entry points with the launch
    counts read around the run, then hold the tokens of TF_REQS seeded
    requests, teacher-forced, against the plain contiguous engine."""
    eng = m.Engine(model, max_seq=SERVE_MAX_SEQ, backend=backend, kv_dtype=kv_dtype)

    def scheduler():
        return m.ContinuousScheduler(eng, batch=SERVE_B, chunk=SERVE_CHUNK,
                                     paged=paged, page=PAGE)

    # warm-up (cuBLAS handles and heuristics, allocator), not counted
    scheduler().run(reqs[:2])
    sched = scheduler()
    ticks = []
    step_chunk = sched.slots.step_chunk
    sched.slots.step_chunk = lambda chunk: ticks.append(chunk) or step_chunk(chunk)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k.reset_launch_counts()
    t0 = time.perf_counter()
    out = sched.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = k.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    # drop the tick counter: it and the slots referred to each other
    del sched.slots.step_chunk, step_chunk
    st = sched.stats()
    if backend == "mega":
        # ticks: 28 megakernel launches per step and nothing else of the
        # per-op decode; admissions: one batch-1 flash forward each
        admits = N_REQ + st["preemptions"]
        steps = sum(ticks)
        check(counts["mega_paged_decode"] == N_LAYERS * steps
              and counts["flash_decode_paged"] == 0
              and counts["flash_decode"] == N_LAYERS * admits
              and counts["kv_update"] == 2 * N_LAYERS * admits
              and counts["swiglu"] == N_LAYERS * admits,
              f"{label}: launches {counts} for {steps} tick steps and {admits} "
              "admissions")
    else:
        path = (("flash_decode_paged",) if paged else ()) + ("flash_decode",
                                                             "kv_update", "swiglu")
        for name in path:
            check(counts[name] > 0, f"{label}: kernel {name} did not run on the "
                                    f"serving path ({counts})")
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
                   tick_steps=sum(ticks), launches=counts)
    print(f"serving {label} on {card}: {json.dumps(summary)}", flush=True)
    tick_probe(m, k, eng, paged, reqs, label)

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


def tick_probe(m, k, eng, paged, reqs, label):
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

    k.reset_launch_counts()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run_tick()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    tick_s = time.perf_counter() - t0
    counts = k.launch_counts()
    if eng.backend == "mega":
        check(counts["mega_paged_decode"] == N_LAYERS * SERVE_CHUNK
              and sum(counts.values()) == counts["mega_paged_decode"],
              f"tick {label}: launches {counts}, want only mega_paged_decode == "
              f"{N_LAYERS * SERVE_CHUNK}")
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
          f"device launches per step {sum(e.count for e in ev) // SERVE_CHUNK}, "
          f"kernel launches {counts}; top: "
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

    t_start = time.perf_counter()

    def stamp(what):
        print(f"[{time.perf_counter() - t_start:.1f} s] {what} done", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = kernel_phase(k, gen)
    rows += mega_kernel_phase(gen)
    stamp("kernel phases")

    cfg = m.qwen3_1p7b()
    ids = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
    model = m.AutoLLM.from_config(cfg, device="cuda", seed=0)
    counts = {"bf16": engine_phase(m, k, model, None, "bf16", ids, card)}
    stamp("engine bf16")
    counts["bf16"]["mega decode"] = engine_phase(m, k, model, None, "mega bf16", ids,
                                                 card, backend="mega")["decode"]
    stamp("engine mega bf16")
    model = model.quantize_int8()
    counts["int8"] = engine_phase(m, k, model, torch.int8, "int8", ids, card)
    stamp("engine int8")

    reqs = serving_requests(m, cfg.vocab_size)
    model = m.AutoLLM.from_config(cfg, device="cuda", seed=0)
    counts["bf16"]["paged"] = serving_phase(m, k, model, None, "paged bf16", True, reqs,
                                            card)
    stamp("serving paged bf16")
    counts["bf16"]["contiguous"] = serving_phase(m, k, model, None, "contiguous bf16",
                                                 False, reqs, card)
    stamp("serving contiguous bf16")
    # the megakernel takes bf16 weights; its int8 configuration is the
    # int8 KV pool alone
    counts["bf16"]["mega paged"] = serving_phase(m, k, model, None, "mega paged bf16",
                                                 True, reqs, card, backend="mega")
    stamp("serving mega paged bf16")
    counts["int8"]["mega paged"] = serving_phase(m, k, model, torch.int8,
                                                 "mega paged int8-KV", True, reqs, card,
                                                 backend="mega")
    stamp("serving mega paged int8-KV")
    model = model.quantize_int8()
    counts["int8"]["paged"] = serving_phase(m, k, model, torch.int8, "paged int8", True,
                                            reqs, card)
    stamp("serving paged int8")

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
