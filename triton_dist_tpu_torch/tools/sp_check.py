"""Sequence-parallel checks of the port on the card: the five SP kernels
against their plain versions, the SPAttn and UlyssesAttn layers at
Qwen3-1.7B's attention widths, and Qwen3-1.7B served over a mesh of four
ranks with its paged pool's page ids split over them.

    python3 -m triton_dist_tpu_torch.tools.tp_check --sp [--cards 4] [--layers L]

Without --cards the four ranks are emulated on one card (`make_mesh(4,
devices=["cuda:0"] * 4)`; see tools/tp_check.py). chip_smoke.py calls
`run_sp` on the emulated mesh.

Checks, each failing the run (tools/checks.py CheckFailed):
- kernel rows: lse_combine (row 24; the serving tick's 8 slots and the
  SPAttn decode, f32 partials with rows that own no key on any rank, which
  must give 0), kv_scatter (row 25; the SPAttn prefill's 4096-position
  blocks into 8192-position windows, bf16, bitwise, the untouched rows
  kept) and ring_attn (row 26; the SPAttn prefill, B=1, 16384 positions,
  Hq=16, Hkv=8, d=128, bf16, causal), and each at its registry spec's
  shape in f32, each within SP_KERNEL_LIMIT of its
  plain version (max |d| over max |plain|; tools/fault_margin.py --sp)
  over CALLS calls on fresh inputs, timed beside the plain version, one
  PyTorch call where one computes the function (kv_scatter: one copy_ of
  the whole block; ring_attn: scaled_dot_product_attention over the whole
  sequence on one card) and the bound; then the registry's three SP
  specs (f32) on the mesh against the same specs on a CPU mesh;
- Ulysses kernel rows: gemm_a2a (row 28; the QKV projection of the
  Ulysses prefill, a [4096, 2048] a rank against w [2048, 4096]) and
  o_a2a_gemm (row 27; the O projection, x [16384, 512] a rank against w
  [2048, 2048]), bf16, and each at a small f32 shape (the JAX report's CPU
  shape: B=1, S=8n, D=N=64), within ULYSSES_KERNEL_LIMIT of their plain
  versions (tools/fault_margin.py --ulysses), timed beside the plain
  version, one rank's product in torch.matmul and the bound;
- UlyssesAttn at the SPAttn widths below, B=1 x S=16384 over four ranks:
  prefill(mode="fused") launches one gemm_a2a and one o_a2a_gemm a device
  and one flash_decode a rank, and nothing else; "unfused" two all_to_all
  a device and one flash_decode a rank, and nothing else; "xla" no kernel;
  fused against unfused and both against "xla" within ULYSSES_GATE
  (max |d| over max |xla|); ulysses_dispatch then ulysses_combine bitwise
  the input; the three modes timed beside SPAttn's ring_shmem and ring;
- SPAttn: D=2048, Hq=16, Hkv=8, hd=128, QK-norms, bf16, seeded random
  weights, B=1 x S=16384 over four ranks, a cache of T=32768:
  prefill(mode="ring_shmem") against prefill(mode="ring") (outputs and
  cache windows), launching one ring_attn and two kv_scatter (a distinct
  device of the mesh); then SP_DECODE_STEPS decode steps with combine
  "dist" against "xla", one lse_combine a step (and device);
- serving: Qwen3-1.7B (all 28 layers, or --layers) bf16, seeded random
  weights, sp_combine "dist", Engine(backend="flash"),
  ContinuousScheduler(paged=True, page=16) at SP_SLOTS slots: SP_REQS
  requests sharing a 1024-token system prompt, each with a distinct tail
  (prompts of 3072-4096 tokens), SP_GEN tokens each; the prefix cache must
  hit, only the SP path's kernels launch (the admissions' flash_decode,
  kv_update, swiglu; the ticks' flash_decode_paged_partial, lse_combine,
  swiglu); every served stream, teacher-forced through the one-rank plain
  engine, by the margin rule at SP_GATE; every shard's residency 0 once
  the radix tree is dropped, and per-shard conservation; then the same
  prompts admitted into a fresh pool and SP_TF_STEPS decode steps whose
  logits with combine "dist" are held to "xla" by the margin rule at
  SP_GATE; and one bare tick of SP_TICK_STEPS steps, timed with no host
  sync, then profiled (the idle share).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from triton_dist_tpu_torch.tools.checks import check, margin_gate, only_launched, tf_gate

# the SP kernels against their plain versions: max |d| over max |plain|
# (tools/fault_margin.py --sp)
SP_KERNEL_LIMIT = 2e-2
# the SP engine's logits against the plain engine's, by the margin rule
# (tools/fault_margin.py --sp: clean 2.05% of the largest logit on the H100
# at 4k-token contexts, a row written one place off 3.54%, the other faults
# 85% or more)
SP_GATE = 3e-2
CALLS = 2
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12
D, HQ, HKV, HD = 2048, 16, 8, 128
SP_S, SP_T = 16384, 32768       # SPAttn: the prefill's positions, the cache's
SP_DECODE_STEPS = 16
SP_SLOTS, SP_REQS, SP_GEN, SP_SYS = 8, 8, 32, 1024
SP_PROMPT = (3072, 4096)
SP_CHUNK, SP_PAGE = 16, 16
SP_MAX_SEQ = SP_PROMPT[1] + SP_GEN + SP_CHUNK
SP_TF_STEPS, SP_TICK_STEPS = 4, 4
# rows 27-28 against their plain versions, and the Ulysses modes against
# one another and "xla": max |d| over max |reference|
# (tools/fault_margin.py --ulysses)
ULYSSES_KERNEL_LIMIT = 2e-2
ULYSSES_GATE = 2e-2

SOURCES = {
    "lse_combine": ("triton_dist_tpu_torch/kernels/csrc/lse_combine.cu",
                    "triton_dist_tpu/kernels/sp_flash_decode.py:131"),
    "kv_scatter": ("triton_dist_tpu_torch/kernels/csrc/kv_scatter.cu",
                   "triton_dist_tpu/kernels/sp_flash_decode.py:330"),
    "ring_attn": ("triton_dist_tpu_torch/kernels/csrc/ring_attn.cu",
                  "triton_dist_tpu/kernels/sp_attention.py:385"),
    "gemm_a2a": ("triton_dist_tpu_torch/kernels/csrc/gemm_a2a.cu",
                 "triton_dist_tpu/kernels/sp_attention.py:855"),
    "o_a2a_gemm": ("triton_dist_tpu_torch/kernels/csrc/a2a_gemm.cu",
                   "triton_dist_tpu/kernels/sp_attention.py:816"),
}
# the registry's SP specs against the CPU mesh: the kernels' f32 sums in
# another order than the plain versions'
REGISTRY_LIMIT = 1e-5


def _rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def _gap(outs, refs, dev) -> float:
    return max(_rel(o.to(dev), r.to(dev)) for o, r in zip(outs, refs))


def _bound(nbytes: float, flops: float, flops_per_s: float):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / flops_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def _row(rows, mesh, name, case, fresh, kernel, plain, library, nbytes, flops, flops_per_s,
         tol, bitwise=False):
    """One kernel row: kernel(args) and plain(args) -> per-rank lists over
    CALLS fresh inputs, within tol (max |d| over max |plain|) or bitwise;
    then the three timed on one more fresh input (tools/tp_check.py
    cuda_ms) beside the bound (the card's memory for ranks emulated on one
    card; one card's share otherwise)."""
    from triton_dist_tpu_torch.tools.tp_check import cuda_ms, emulated, sync
    dev0 = mesh.devices[0]
    worst = 0.0
    for _ in range(CALLS):
        args = fresh()
        out, ref = kernel(*args), plain(*args)
        sync(mesh)
        for r, (o, p) in enumerate(zip(out, ref)):
            if bitwise:
                check(torch.equal(o.to(dev0), p.to(dev0)),
                      f"{name} [{case}] rank {r}: not bitwise equal to the plain version")
            else:
                err = _rel(o.to(dev0), p.to(dev0))
                worst = max(worst, err)
                check(err <= tol, f"{name} [{case}] rank {r}: {err:.3g} of max > {tol}")
    args = fresh()
    n = 1 if emulated(mesh) else mesh.size
    b_ms, b_by = _bound(nbytes / n, flops / n, flops_per_s)
    src, rep = SOURCES[name]
    r = dict(name=name, case=case + (" (4 ranks emulated on one card)" if emulated(mesh)
                                     else f" ({mesh.size} cards)"),
             route="cuda", source=src, replaces=rep, launches=None, max_abs_err=worst,
             tol=0.0 if bitwise else tol, ms=cuda_ms(lambda: kernel(*args), mesh),
             plain_ms=cuda_ms(lambda: plain(*args), mesh, reps=5),
             bound_ms=b_ms, bound_by=b_by,
             library_ms=None if library is None else cuda_ms(lambda: library(*args), mesh))
    rows.append(r)
    print(f"kernel {name} [{r['case']}]: {'bitwise' if bitwise else f'{worst:.3g} of max'} "
          f"over {CALLS} calls, ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
          f"{r['library_ms'] if library is None else round(r['library_ms'], 4)} bound_ms "
          f"{b_ms:.4f} ({b_by})", flush=True)


def kernel_rows(mesh, seed: int = 0) -> list:
    """Rows 24-26 at the SP phase's shapes and at the registry specs'
    (f32; launches left None)."""
    import torch.nn.functional as F

    from triton_dist_tpu_torch import kernels as K
    from triton_dist_tpu_torch.tools.tp_check import emulated
    n = mesh.size
    dev0 = mesh.devices[0]
    gen = torch.Generator(device=dev0).manual_seed(seed)
    one_card = emulated(mesh)          # the library calls run on one card
    bf, f32 = torch.bfloat16, torch.float32
    rows = []

    def parts(*shape, dtype=f32):
        return [torch.randn(shape, generator=gen, device=dev0, dtype=dtype).to(d)
                for d in mesh.devices]

    # row 24: the decode tick's slots, the SPAttn decode, the registry's call
    for case, B, hq in ((f"decode tick, {SP_SLOTS} slots x Hq={HQ}, d={HD}", SP_SLOTS, HQ),
                        (f"SPAttn decode, B=1 x Hq={HQ}, d={HD}", 1, HQ),
                        (f"registry, B=1 x Hq=4, d={HD}", 1, 4)):
        R = B * hq

        def fresh(B=B, hq=hq):
            acc, m = parts(B, 1, hq, HD), parts(B, 1, hq)
            l = [x.abs() + 0.1 for x in parts(B, 1, hq)]
            for r in range(n):               # a row that owns no key on any rank
                acc[r][0, 0, 0], m[r][0, 0, 0], l[r][0, 0, 0] = 0.0, -1e30, 0.0
            acc[1][0, 0, 1], m[1][0, 0, 1], l[1][0, 0, 1] = 0.0, -1e30, 0.0
            return acc, m, l

        def kernel(acc, m, l):
            return K.sp_combine_partials(acc, m, l, mesh=mesh, combine="dist")

        def plain(acc, m, l):
            R_ = acc[0].numel() // HD
            return [o.reshape(acc[0].shape) for o in K.lse_combine_dist_ref(
                [a.reshape(R_, HD) for a in acc],
                [torch.stack([x.reshape(R_), y.reshape(R_)]) for x, y in zip(m, l)])]

        _row(rows, mesh, "lse_combine", case, fresh, kernel, plain, None,
             n * (R * HD + 2 * R) * 4 + n * R * HD * 4, 0.0, F32_FLOPS_PER_S, SP_KERNEL_LIMIT)
        for o in kernel(*fresh()):
            check(bool(torch.isfinite(o).all()) and bool((o[0, 0, 0] == 0).all()),
                  "lse_combine: a row that owns no key must give 0")

    # row 25: the SPAttn prefill's blocks (bf16), the registry's (f32)
    for case, hkv, s_loc, t_loc, dt in (
            (f"SPAttn prefill, {n} blocks of {SP_S // n} positions into windows of "
             f"{SP_T // n}, Hkv={HKV}, d={HD}, bf16", HKV, SP_S // n, SP_T // n, bf),
            (f"registry, {n} blocks of 16 positions into windows of 16, Hkv=2, d={HD}, f32",
             2, 16, 16, f32)):

        def fresh(hkv=hkv, s_loc=s_loc, t_loc=t_loc, dt=dt):
            """(the kernel's cache, the plain version's copy of it, the new
            blocks): each writes in place into its own."""
            cache = parts(1, hkv, t_loc, HD, dtype=dt)
            return cache, [c.clone() for c in cache], parts(1, hkv, s_loc, HD, dtype=dt)

        def kernel(ck, cp, new):
            return K.kv_cache_scatter(ck, new, mesh=mesh)

        def plain(ck, cp, new):
            return K.kv_cache_scatter_ref(cp, new)

        S, T = n * s_loc, n * t_loc
        ck, cp, new = fresh()
        kernel(ck, cp, new)
        check(torch.equal(torch.cat([o.to(dev0) for o in ck], 2)[:, :, S:],
                          torch.cat([c.to(dev0) for c in cp], 2)[:, :, S:]),
              "kv_scatter: a cache row past the blocks changed")
        whole = torch.empty(1, hkv, T, HD, dtype=dt, device=dev0)
        _row(rows, mesh, "kv_scatter", case, fresh, kernel, plain,
             (lambda ck, cp, nw, w=whole, S=S: w[:, :, :S].copy_(torch.cat(nw, 2)))
             if one_card else None,
             2 * hkv * S * HD * whole.element_size(), 0.0, BF16_FLOPS_PER_S, 0.0,
             bitwise=True)

    # row 26: the SPAttn prefill (bf16, GQA), the registry's call (f32)
    for case, hq, hkv, s_loc, dt in (
            (f"SPAttn prefill, B=1 x S={SP_S} over {n} ranks, Hq={HQ} Hkv={HKV} d={HD}, "
             "bf16, causal", HQ, HKV, SP_S // n, bf),
            (f"registry, B=1 x S={8 * n}, Hq=Hkv=2, d={HD}, f32, causal", 2, 2, 8, f32)):

        def fresh(hq=hq, hkv=hkv, s_loc=s_loc, dt=dt):
            return (parts(1, s_loc, hq, HD, dtype=dt), parts(1, hkv, s_loc, HD, dtype=dt),
                    parts(1, hkv, s_loc, HD, dtype=dt))

        def plain(q, k, v):
            acc, _, l = K.ring_attn_ref(q, k, v, scale=HD ** -0.5, causal=True)
            return [(a / x.clamp_min(1e-30)[..., None]).to(q[0].dtype) for a, x in zip(acc, l)]

        def sdpa(q, k, v):
            return F.scaled_dot_product_attention(
                torch.cat(q, 1).transpose(1, 2), torch.cat(k, 2), torch.cat(v, 2),
                is_causal=True, enable_gqa=True)

        S = n * s_loc
        isz = 2 if dt == bf else 4
        _row(rows, mesh, "ring_attn", case, fresh,
             lambda q, k, v: K.sp_ring_attention(q, k, v, mesh=mesh, mode="ring_shmem"),
             plain, sdpa if one_card else None,
             (hq + 2 * hkv) * S * HD * isz + hq * S * (HD + 2) * 4,
             4.0 * HD * S * (S + 1) // 2 * hq, BF16_FLOPS_PER_S if dt == bf else F32_FLOPS_PER_S,
             SP_KERNEL_LIMIT)
    return rows


SP_SPECS = ("sp_flash_decode_dist", "kv_cache_scatter", "sp_ring_shmem")


def registry_check(mesh) -> dict:
    """The registry's three SP specs (f32) on the mesh against the same
    specs on a CPU mesh; returns their launch counts."""
    from triton_dist_tpu_torch import kernels as K
    from triton_dist_tpu_torch.runtime import make_mesh
    from triton_dist_tpu_torch.tools.tp_check import sync
    cpu = make_mesh(mesh.size, devices=["cpu"] * mesh.size)
    K.reset_launch_counts()
    outs = {}
    for name in SP_SPECS:
        fn, args = K.kernel_registry()[name].build(mesh)
        outs[name] = fn(*args)
    sync(mesh)
    counts = K.launch_counts()
    allowed = ("lse_combine", "kv_scatter", "ring_attn", "flash_decode_partial")
    for c in allowed:
        check(counts[c] > 0, f"sp registry: {c} did not run ({counts})")
    only_launched(counts, allowed, "sp registry")
    for name in SP_SPECS:
        fn, args = K.kernel_registry()[name].build(cpu)
        for r, (got, want) in enumerate(zip(outs[name], fn(*args))):
            err = _rel(got.cpu(), want)
            check(err <= REGISTRY_LIMIT, f"sp registry {name} rank {r}: card against CPU "
                  f"{err} > {REGISTRY_LIMIT}")
        print(f"sp registry {name}: card against its CPU run within {REGISTRY_LIMIT}",
              flush=True)
    return counts


def sp_attn_check(mesh, seed: int = 0) -> dict:
    """SPAttn at Qwen3-1.7B's attention widths (see the module
    docstring). Returns the launch counts of the ring_shmem prefill and
    of the dist decode steps."""
    from triton_dist_tpu_torch import kernels as K
    from triton_dist_tpu_torch.layers import SPAttn, precompute_rope
    from triton_dist_tpu_torch.tools.tp_check import sync
    n = mesh.size
    dev0 = mesh.devices[0]
    gen = torch.Generator(device=dev0).manual_seed(seed)
    bf = torch.bfloat16

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=dev0) * shape[0] ** -0.5).to(bf)

    lay = SPAttn.init(w(D, HQ * HD), w(D, HKV * HD), w(D, HKV * HD), w(HQ * HD, D), mesh=mesh,
                      n_heads=HQ, n_kv_heads=HKV, head_dim=HD,
                      q_norm=torch.rand(HD, generator=gen, device=dev0) + 0.5,
                      k_norm=torch.rand(HD, generator=gen, device=dev0) + 0.5)
    cos, sin = precompute_rope(HD, SP_T, 1e6, device=dev0)
    x = torch.randn(1, SP_S, D, generator=gen, device=dev0).to(bf)
    xs = [t.contiguous().to(d) for t, d in zip(x.chunk(n, 1), mesh.devices)]
    res = {"ms": {}}
    outs = {}
    for mode in ("ring", "ring_shmem"):
        ck, cv = lay.alloc_cache(1, SP_T, dtype=bf)
        K.reset_launch_counts()
        sync(mesh)
        t0 = time.perf_counter()
        out, ck, cv, L = lay.prefill(xs, cos, sin, ck, cv, mode=mode)
        sync(mesh)
        outs[mode] = (out, ck, cv, time.perf_counter() - t0)
        res[f"prefill {mode}"] = K.launch_counts()
        res["ms"][mode] = outs[mode][3] * 1e3
    # a collective launches once a distinct device of the mesh
    ndev = len(mesh.device_groups())
    c = res["prefill ring_shmem"]
    check(c["ring_attn"] == ndev and c["kv_scatter"] == 2 * ndev,
          f"SPAttn prefill ring_shmem: launches {c}, want one ring_attn and two kv_scatter "
          f"a device")
    only_launched(c, ("ring_attn", "kv_scatter"), "SPAttn prefill ring_shmem")
    gap = _gap(outs["ring_shmem"][0], outs["ring"][0], dev0)
    check(gap <= SP_KERNEL_LIMIT, f"SPAttn prefill ring_shmem against ring: {gap:.3g} of max")
    for a, b in zip(outs["ring_shmem"][1] + outs["ring_shmem"][2],
                    outs["ring"][1] + outs["ring"][2]):
        check(torch.equal(a, b), "SPAttn prefill: the cache windows differ between modes")
    _, ck, cv, _ = outs["ring_shmem"]
    caches = {c_: ([t.clone() for t in ck], [t.clone() for t in cv]) for c_ in ("xla", "dist")}
    worst = 0.0
    ms = {}
    K.reset_launch_counts()
    for step in range(SP_DECODE_STEPS):
        xn = torch.randn(1, 1, D, generator=gen, device=dev0).to(bf)
        got = {}
        for comb, (k_, v_) in caches.items():
            before = K.launch_counts()
            t0 = time.perf_counter()
            o, _, _, _ = lay.decode(mesh.replicate(xn), cos, sin, k_, v_, L + step,
                                    combine=comb)
            sync(mesh)
            ms[comb] = ms.get(comb, 0.0) + (time.perf_counter() - t0) * 1e3
            got[comb] = o
            if comb == "dist":
                after = K.launch_counts()
                check(after["lse_combine"] - before["lse_combine"] == ndev,
                      "SPAttn decode dist: one lse_combine a step and device")
        worst = max(worst, _gap(got["dist"], got["xla"], dev0))
    check(worst <= SP_KERNEL_LIMIT, f"SPAttn decode dist against xla: {worst:.3g} of max")
    res["decode"] = K.launch_counts()
    only_launched(res["decode"], ("flash_decode_partial", "lse_combine"), "SPAttn decode")
    print(f"SPAttn D={D} Hq={HQ} Hkv={HKV} hd={HD} bf16 over {n} ranks: prefill S={SP_S} "
          f"ring_shmem {outs['ring_shmem'][3] * 1e3:.1f} ms (ring {outs['ring'][3] * 1e3:.1f} "
          f"ms), {gap:.3g} of max apart; {SP_DECODE_STEPS} decode steps at T={SP_T}, dist "
          f"against xla {worst:.3g} of max, {ms['dist'] / SP_DECODE_STEPS:.2f} / "
          f"{ms['xla'] / SP_DECODE_STEPS:.2f} ms a step (dist / xla), launches "
          f"{ {k_: v_ for k_, v_ in res['decode'].items() if v_} }", flush=True)
    return res


def ulysses_rows(mesh, seed: int = 0) -> list:
    """Rows 27-28 at the Ulysses prefill's shapes (bf16) and at a small f32
    shape (launches left None)."""
    from triton_dist_tpu_torch import kernels as K
    n = mesh.size
    dev0 = mesh.devices[0]
    gen = torch.Generator(device=dev0).manual_seed(seed)
    bf, f32 = torch.bfloat16, torch.float32
    rows = []

    def parts(*shape, dtype, sc=1.0):
        return [(torch.randn(shape, generator=gen, device=dev0) * sc).to(dtype).to(d)
                for d in mesh.devices]

    def whole(*shape, dtype):
        return mesh.replicate((torch.randn(shape, generator=gen, device=dev0)
                               * shape[0] ** -0.5).to(dtype))

    C = (HQ + 2 * HKV) // n * HD
    for case, B, S, Dm, Nq, No, dt in (
            (f"Ulysses prefill B=1 x S={SP_S} over {n} ranks, D={D}, QKV N={n * C}, O N={HQ * HD}, "
             "bf16", 1, SP_S, D, n * C, HQ * HD, bf),
            (f"small f32, B=1 x S={8 * n}, D=N=64", 1, 8 * n, 64, 64, 64, f32)):
        m = B * S // n
        isz = 2 if dt == bf else 4
        fps = BF16_FLOPS_PER_S if dt == bf else F32_FLOPS_PER_S

        def fresh_qkv(m=m, Dm=Dm, Nq=Nq, dt=dt):
            return parts(m, Dm, dtype=dt), whole(Dm, Nq, dtype=dt)

        _row(rows, mesh, "gemm_a2a", f"QKV: {case}", fresh_qkv,
             lambda a, w: K.gemm_all_to_all(a, w, mesh=mesh), K.gemm_all_to_all_ref,
             lambda a, w: torch.matmul(a[0], w[0]),
             n * (m * Dm + Dm * Nq + m * Nq) * isz, 2.0 * n * m * Dm * Nq, fps,
             ULYSSES_KERNEL_LIMIT)

        def fresh_o(B=B, S=S, Dm=Dm, No=No, dt=dt):
            return parts(B, S, No // n, dtype=dt), whole(No, Dm, dtype=dt)

        _row(rows, mesh, "o_a2a_gemm", f"O: {case}", fresh_o,
             lambda x, w: K.o_a2a_gemm(x, w, mesh=mesh), K.o_a2a_gemm_ref,
             lambda x, w, No=No: torch.matmul(x[0].reshape(-1, No), w[0]),
             n * (m * No + No * Dm + m * Dm) * isz, 2.0 * n * m * No * Dm, fps,
             ULYSSES_KERNEL_LIMIT)
    return rows


def ulysses_layer(mesh, gen):
    """UlyssesAttn at Qwen3-1.7B's attention widths (D, HQ, HKV, HD,
    QK-norms, bf16), its weights drawn from `gen`, and the rope tables for
    SP_S positions."""
    from triton_dist_tpu_torch.layers import UlyssesAttn, precompute_rope
    dev0 = mesh.devices[0]

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=dev0) * shape[0] ** -0.5).to(
            torch.bfloat16)

    lay = UlyssesAttn.init(w(D, HQ * HD), w(D, HKV * HD), w(D, HKV * HD), w(HQ * HD, D),
                           mesh=mesh, n_heads=HQ, n_kv_heads=HKV, head_dim=HD,
                           q_norm=torch.rand(HD, generator=gen, device=dev0) + 0.5,
                           k_norm=torch.rand(HD, generator=gen, device=dev0) + 0.5)
    return lay, precompute_rope(HD, SP_S, 1e6, device=dev0)


def ulysses_input(mesh, gen) -> list:
    """A B=1 x SP_S prefill's x [1, SP_S, D] bf16, as the ranks' blocks."""
    x = torch.randn(1, SP_S, D, generator=gen, device=mesh.devices[0]).to(torch.bfloat16)
    return [t.contiguous().to(d) for t, d in zip(x.chunk(mesh.size, 1), mesh.devices)]


def ulysses_check(mesh, seed: int = 0, spattn_ms=None) -> dict:
    """UlyssesAttn at Qwen3-1.7B's attention widths (see the module
    docstring). Returns the launch counts of each prefill mode, their
    times and the gaps."""
    from triton_dist_tpu_torch import kernels as K
    from triton_dist_tpu_torch.tools.tp_check import sync
    n = mesh.size
    dev0 = mesh.devices[0]
    gen = torch.Generator(device=dev0).manual_seed(seed)
    bf = torch.bfloat16
    lay, (cos, sin) = ulysses_layer(mesh, gen)
    xs = ulysses_input(mesh, gen)
    outs, ms, counts = {}, {}, {}
    for mode in ("fused", "unfused", "xla"):
        lay.prefill(xs, cos, sin, mode=mode)             # warm-up
        K.reset_launch_counts()
        sync(mesh)
        t0 = time.perf_counter()
        outs[mode] = lay.prefill(xs, cos, sin, mode=mode)
        sync(mesh)
        ms[mode] = (time.perf_counter() - t0) * 1e3
        counts[mode] = K.launch_counts()
    ndev = len(mesh.device_groups())
    c = counts["fused"]
    check(c["gemm_a2a"] == ndev and c["o_a2a_gemm"] == ndev and c["flash_decode"] == n,
          f"Ulysses fused prefill: launches {c}, want one gemm_a2a and one o_a2a_gemm a "
          "device and one flash_decode a rank")
    only_launched(c, ("gemm_a2a", "o_a2a_gemm", "flash_decode"), "Ulysses fused prefill")
    c = counts["unfused"]
    check(c["all_to_all"] == 2 * ndev and c["flash_decode"] == n,
          f"Ulysses unfused prefill: launches {c}, want two all_to_all a device and one "
          "flash_decode a rank")
    only_launched(c, ("all_to_all", "flash_decode"), "Ulysses unfused prefill")
    only_launched(counts["xla"], (), "Ulysses xla prefill")
    gaps = {"fused-unfused": _gap(outs["fused"], outs["unfused"], dev0),
            "fused-xla": _gap(outs["fused"], outs["xla"], dev0),
            "unfused-xla": _gap(outs["unfused"], outs["xla"], dev0)}
    for k_, g in gaps.items():
        check(g <= ULYSSES_GATE, f"Ulysses prefill {k_}: {g:.3g} of max > {ULYSSES_GATE}")
    C = (HQ + 2 * HKV) // n * HD
    seq = [(torch.randn(1, SP_S // n, n, C, generator=gen, device=dev0)).to(bf).to(d)
           for d in mesh.devices]
    back = K.ulysses_combine(K.ulysses_dispatch(seq, mesh=mesh), mesh=mesh)
    sync(mesh)
    for a, b in zip(back, seq):
        check(torch.equal(a, b), "ulysses_dispatch then ulysses_combine: not the input")
    sp = spattn_ms or {}
    print(f"UlyssesAttn D={D} Hq={HQ} Hkv={HKV} hd={HD} bf16 over {n} ranks, prefill "
          f"S={SP_S}: fused {ms['fused']:.1f} ms, unfused {ms['unfused']:.1f} ms, xla "
          f"{ms['xla']:.1f} ms (SPAttn ring_shmem {sp.get('ring_shmem', float('nan')):.1f} ms, "
          f"ring {sp.get('ring', float('nan')):.1f} ms); gaps "
          f"{ {k_: float(f'{g:.3g}') for k_, g in gaps.items()} } (limit {ULYSSES_GATE}); "
          f"dispatch then combine bitwise; fused launches "
          f"{ {k_: v for k_, v in counts['fused'].items() if v} }", flush=True)
    return dict(counts=counts, ms=ms, gaps=gaps)


def sp_requests(m, vocab: int):
    """SP_REQS requests sharing an SP_SYS-token system prompt, each with a
    distinct tail (prompts of SP_PROMPT tokens), SP_GEN tokens each."""
    rng = np.random.RandomState(4)
    sys_ = rng.randint(0, vocab, SP_SYS)
    return [m.Request(rid=i, ids=np.concatenate(
                [sys_, rng.randint(0, vocab, int(rng.randint(*SP_PROMPT)) - SP_SYS)]
            ).astype(np.int32), gen_len=SP_GEN) for i in range(SP_REQS)]


SERVE_KERNELS = ("flash_decode", "kv_update", "swiglu", "flash_decode_paged_partial",
                 "lse_combine")


def serving_check(m, k, mesh, one, card: str, n_req: int = SP_REQS) -> dict:
    """Qwen3-1.7B served over the mesh (see the module docstring); `one`
    is the one-rank model on rank 0's device. Returns the launch counts
    and metrics."""
    from triton_dist_tpu_torch.models.prefix_cache import RefcountedPages
    from triton_dist_tpu_torch.tools.tp_check import idle_share, share, sync
    dev0 = mesh.devices[0]
    model = one.to_mesh(mesh, "sp", sp_combine="dist")
    eng = m.Engine(model, max_seq=SP_MAX_SEQ, backend="flash", device=dev0)
    reqs = sp_requests(m, one.config.vocab_size)[:n_req]
    sched = m.ContinuousScheduler(eng, batch=SP_SLOTS, chunk=SP_CHUNK, paged=True, page=SP_PAGE)
    k.reset_launch_counts()
    sync(mesh)
    t0 = time.perf_counter()
    out = sched.run([dataclasses.replace(r) for r in reqs])
    sync(mesh)
    wall = time.perf_counter() - t0
    counts = k.launch_counts()
    for c in SERVE_KERNELS:
        check(counts[c] > 0, f"sp serving: {c} did not run ({counts})")
    only_launched(counts, SERVE_KERNELS, "sp serving")
    st = sched.stats()
    check(st["hits"] > 0 and not sched.rejected, f"sp serving: hits {st['hits']}, rejected "
          f"{sched.rejected}")
    for r in reqs:
        check(len(out[r.rid]) == r.gen_len, f"sp serving: rid {r.rid} served "
              f"{len(out[r.rid])} of {r.gen_len}")
    pool = sched.slots.prefix.pool
    sched.slots.prefix.tree.evict_until(10 ** 9)
    check(pool.pages_in_use_by_shard == [0] * mesh.size,
          f"sp serving: residency at idle {pool.pages_in_use_by_shard}")
    check(all(a + o == pool.pages_per_shard for a, o in
              zip(pool.available_by_shard, pool.outstanding_by_shard)),
          "sp serving: pages not conserved per shard")
    toks = sum(len(out[r.rid]) for r in reqs)
    ttft = st["ttft_ms"]
    print(f"serving sp={mesh.size} paged dist on {card}: {len(reqs)} requests of "
          f"{min(len(r.ids) for r in reqs)}-{max(len(r.ids) for r in reqs)} prompt tokens over "
          f"{SP_SLOTS} slots, {toks} tokens in {wall:.2f} s ({toks / wall:.1f} tok/s), TTFT "
          f"mean {ttft['mean']:.1f} ms p99 {ttft['p99']:.1f} ms, hits {st['hits']}, skipped "
          f"{st['prefill_tokens_skipped']} prompt tokens, wait by kind "
          f"{ {k_: round(v, 3) for k_, v in st['device_wait_s_by_kind'].items() if v} }, "
          f"launches {counts}", flush=True)
    del sched
    forced, n_streams = tf_gate(m, one, None, [(r.ids, out[r.rid]) for r in reqs],
                                "sp serving", SP_MAX_SEQ, limit=SP_GATE)
    print(f"serving sp={mesh.size}: {forced} tokens of the {n_streams} streams checked "
          f"against the one-rank xla engine (margin rule at {SP_GATE})", flush=True)
    # dist against xla on one pool: the same prompts admitted by hand
    pcache = eng.make_paged_slot_cache(SP_SLOTS, page=SP_PAGE)
    pool = RefcountedPages(pcache.num_pages, one.config.num_kv_heads, shards=mesh.size)
    maxp = pcache.max_pages
    trash = np.full((one.config.num_kv_heads,), pcache.trash, np.int32)
    logits, pos = [], []
    for b, r in enumerate((reqs * SP_SLOTS)[:SP_SLOTS]):
        need = -(-(len(r.ids) + SP_TF_STEPS + 2 * SP_TICK_STEPS) // SP_PAGE)
        rows = np.full((one.config.num_kv_heads, maxp), pcache.trash, np.int32)
        for j in range(need):
            rows[:, j] = pool.alloc_group()
        lg, pcache = eng.admit_slot_paged(pcache, b, r.ids, rows, 0, trash, trash, 0)
        logits.append(lg)
        pos.append(len(r.ids))
    logits = torch.stack(logits)
    pos = torch.tensor(pos, dtype=torch.int32, device=dev0)
    xla = dataclasses.replace(model, sp_combine="xla")
    worst = 0.0
    for t in range(SP_TF_STEPS):
        tok = torch.argmax(logits, -1)[:, None]
        ld, _ = model.forward_tokens_slots_paged(tok, pcache, pos)
        lx, _ = xla.forward_tokens_slots_paged(tok, pcache, pos)
        err, _, _ = margin_gate(ld, lx, f"sp dist against xla step {t}", SP_GATE)
        worst = max(worst, err / lx.abs().max().item())
        logits, pos = ld, pos + 1
    print(f"sp logits dist against xla: {SP_TF_STEPS} steps of {SP_SLOTS} slots within "
          f"{worst:.3g} of the largest logit (limit {SP_GATE})", flush=True)
    # one bare tick, no host sync allowed, then profiled
    active = torch.ones(SP_SLOTS, dtype=torch.bool, device=dev0)
    k.reset_launch_counts()
    sync(mesh)
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.paged_slot_chunk(logits, pcache, pos, active, chunk=SP_TICK_STEPS)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sync(mesh)
    tick_s = time.perf_counter() - t0
    tick = k.launch_counts()
    L = one.config.num_layers
    ndev = len(mesh.device_groups())
    check(tick["flash_decode_paged_partial"] == L * SP_TICK_STEPS * mesh.size
          and tick["lse_combine"] == L * SP_TICK_STEPS * ndev,
          f"sp tick: launches {tick}, want {mesh.size} partials a layer and step and one "
          "lse_combine a layer, step and device")
    only_launched(tick, ("flash_decode_paged_partial", "lse_combine", "swiglu"), "sp tick")
    pos = pos + SP_TICK_STEPS
    idle = idle_share(lambda: eng.paged_slot_chunk(logits, pcache, pos, active,
                                                   chunk=SP_TICK_STEPS),
                      SP_TICK_STEPS, tick_s / SP_TICK_STEPS, f"sp tick ({SP_SLOTS} slots)",
                      ndev)
    print(f"tick sp={mesh.size} ({SP_SLOTS} slots, contexts {pos.min().item()}-"
          f"{pos.max().item()}): {tick_s * 1e3 / SP_TICK_STEPS:.3f} ms/step wall, "
          f"{sum(tick.values()) // SP_TICK_STEPS} kernel launches a step, {share(idle)} idle",
          flush=True)
    return dict(serving=counts, tick=tick, tok_per_s=toks / wall, ttft_ms=ttft["mean"],
                ms_per_step=tick_s * 1e3 / SP_TICK_STEPS, idle=idle, gaps=[worst],
                served=dict(forced=forced))


def run_sp(mesh, *, card: str, n_layers=None, n_req: int = SP_REQS,
           ulysses: bool = True) -> dict:
    """Every SP check on `mesh`: the kernel rows, the registry specs,
    SPAttn, the Ulysses rows and UlyssesAttn (unless `ulysses` is False:
    chip_smoke.py runs them in a phase of their own), then Qwen3-1.7B
    (n_layers of its 28) served over the mesh.
    Returns the kernel rows and the launch counts of each phase."""
    import triton_dist_tpu_torch.kernels as k
    import triton_dist_tpu_torch.models as m
    t0 = time.perf_counter()
    rows = kernel_rows(mesh)
    print(f"[sp {time.perf_counter() - t0:.1f} s] kernel rows done", flush=True)
    counts = {"registry": registry_check(mesh)}
    counts["layer"] = sp_attn_check(mesh)
    print(f"[sp {time.perf_counter() - t0:.1f} s] registry and SPAttn done", flush=True)
    if ulysses:
        rows += ulysses_rows(mesh)
        counts["ulysses"] = ulysses_check(mesh, spattn_ms=counts["layer"]["ms"])
        print(f"[sp {time.perf_counter() - t0:.1f} s] Ulysses done", flush=True)
    cfg = m.qwen3_1p7b()
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=n_layers)
    one = m.DenseLLM.random_init(cfg, device=mesh.devices[0], seed=0)
    counts["serving"] = serving_check(m, k, mesh, one, card, n_req)
    print(f"[sp {time.perf_counter() - t0:.1f} s] serving done", flush=True)
    del one
    return dict(rows=rows, counts=counts)
