"""Pipeline-parallel checks of the port on the card: row 17 (p2p_shift)
against its plain version, PPipeline over Qwen3-1.7B's MLP blocks, and
p2p_push_pages of one prompt's KV payload.

    python3 -m triton_dist_tpu_torch.tools.tp_check --pp [--cards 4] [--layers L]

Without --cards the four ranks are emulated on one card (`make_mesh(4,
devices=["cuda:0"] * 4)`; see tools/tp_check.py). chip_smoke.py calls
`run_pp` on the emulated mesh.

Checks, each failing the run (tools/checks.py CheckFailed):
- kernel rows: p2p_shift at the pipeline's handoff ([128, 2048] bf16 a
  rank), at one hop of the push payload ([28, 512, 16, 128] bf16 a rank)
  and at the registry spec's shape ([8, 128] f32 a rank), bitwise equal to
  its plain version over CALLS calls on fresh inputs, timed beside the
  plain version, one copy_ of a rank's buffer (one card) or its .to() onto
  the next card (four cards), and the bound;
- the registry's p2p_shift spec on the mesh, bitwise its run on a CPU mesh;
- PPipeline: Qwen3-1.7B (seeded random weights, bf16), its 28 MLP blocks
  (or --layers: a multiple of the ranks; each block the post-attention
  RMSNorm, the gate/up product, the swiglu kernel, the down product and
  the residual) as four stages over the mesh, PP_M = 8 microbatches of
  [128, 2048] (11 ticks), replicate_out both ways: the output bitwise the
  blocks applied in order on rank 0's device; launches: p2p_shift once a
  tick and device, swiglu once a block, stage and tick, nothing else;
  timed beside the blocks in order;
- push: p2p_push_pages of k and v [28, 512, 16, 128] bf16 (one 1024-token
  Qwen3-1.7B prompt: 28 layers of 512 pages of 16 rows, 58.7 MB each)
  from rank 0 to rank 1 (one hop) and to rank 2 (two hops), bitwise, one
  p2p_shift a hop and device and nothing else, timed beside one copy_ of
  the payload (one card) or its .to() onto dst's card (four cards).
"""

from __future__ import annotations

import dataclasses
import time

import torch

from triton_dist_tpu_torch.kernels import qmm, swiglu
from triton_dist_tpu_torch.layers import rms_norm
from triton_dist_tpu_torch.tools.checks import check, only_launched

PP_M, PP_B = 8, 128              # microbatches, rows a microbatch
PUSH_SHAPE = (28, 512, 16, 128)  # one prompt's k (or v): layers x pages x page x head dim
PP_SPECS = ("p2p_shift",)        # the registry specs this check runs


def mlp_block(p, x):
    """One Qwen3 MLP block: x + down(swiglu(rms_norm(x) @ gate_up))."""
    return x + qmm(swiglu(qmm(rms_norm(x, p["ln"]), p["w_gu"])), p["w_d"])


def stage_fn(blocks, x):
    """A stage: its blocks in order."""
    for p in blocks:
        x = mlp_block(p, x)
    return x


def kernel_rows(mesh, seed: int = 0) -> list:
    """Row 17 at the pipeline's, the push's and the registry's shapes
    (launches left None)."""
    from triton_dist_tpu_torch import kernels as K
    from triton_dist_tpu_torch.tools.tp_check import emulated, measure
    n = mesh.size
    dev0 = mesh.devices[0]
    gen = torch.Generator(device=dev0).manual_seed(seed)
    rows = []
    for case, shape, dt in ((f"PP handoff, [{PP_B}, 2048] a rank, bf16", (PP_B, 2048),
                             torch.bfloat16),
                            (f"push hop, {list(PUSH_SHAPE)} a rank, bf16", PUSH_SHAPE,
                             torch.bfloat16),
                            ("registry, [8, 128] a rank, f32", (8, 128), torch.float32)):
        nbytes = torch.Size(shape).numel() * (2 if dt == torch.bfloat16 else 4)

        def fresh(shape=shape, dt=dt):
            return ([torch.randn(shape, generator=gen, device=dev0).to(dt).to(d)
                     for d in mesh.devices],)

        if emulated(mesh):
            sink = torch.empty(shape, dtype=dt, device=dev0)
            library = lambda xs, sink=sink: sink.copy_(xs[0])  # noqa: E731
        else:
            library = lambda xs: xs[0].to(mesh.devices[1])  # noqa: E731
        measure(rows, mesh, "p2p_shift", case, fresh, lambda xs: K.p2p_shift(xs, mesh=mesh),
                K.p2p_shift_ref, library, 2 * n * nbytes, nbytes, "p2p", None,
                replicated=False)
    return rows


def registry_check(mesh) -> dict:
    """The p2p_shift spec on the mesh against the same spec on a CPU mesh;
    returns its launch counts."""
    from triton_dist_tpu_torch import kernels as K
    from triton_dist_tpu_torch.runtime import make_mesh
    from triton_dist_tpu_torch.tools.tp_check import sync
    cpu = make_mesh(mesh.size, devices=["cpu"] * mesh.size)
    K.reset_launch_counts()
    fn, args = K.kernel_registry()["p2p_shift"].build(mesh)
    out = fn(*args)
    sync(mesh)
    counts = K.launch_counts()
    check(counts["p2p_shift"] == len(mesh.device_groups()),
          f"pp registry: p2p_shift launches {counts['p2p_shift']}")
    only_launched(counts, PP_SPECS, "pp registry")
    fn, args = K.kernel_registry()["p2p_shift"].build(cpu)
    for r, (got, want) in enumerate(zip(out, fn(*args))):
        check(torch.equal(got.cpu(), want), f"pp registry p2p_shift rank {r}: not bitwise "
              "its CPU run")
    print("pp registry p2p_shift: bitwise its CPU run", flush=True)
    return counts


def pipeline_check(mesh, one, card: str, seed: int = 0) -> dict:
    """PPipeline over the model's MLP blocks (see the module docstring).
    Returns the launch counts of each output form and the times."""
    from triton_dist_tpu_torch import kernels as K
    from triton_dist_tpu_torch.layers import PPipeline
    from triton_dist_tpu_torch.tools.tp_check import sync
    n = mesh.size
    dev0 = mesh.devices[0]
    L = len(one.layers)
    check(L % n == 0, f"pp: {L} blocks do not split over {n} stages")
    blocks = [{"ln": ly.ln_mlp, "w_gu": ly.mlp.w_gate_up, "w_d": ly.mlp.w_down}
              for ly in one.layers]
    per = L // n
    pipe = PPipeline.init([blocks[s * per:(s + 1) * per] for s in range(n)], stage_fn,
                          mesh=mesh)
    gen = torch.Generator(device=dev0).manual_seed(seed)
    D = one.config.hidden_size
    x = torch.randn(PP_M, PP_B, D, generator=gen, device=dev0).to(blocks[0]["w_gu"].dtype)
    stage_fn(blocks, x[0])                               # warm-up
    sync(mesh)
    t0 = time.perf_counter()
    ref = torch.stack([stage_fn(blocks, x[i]) for i in range(PP_M)])
    sync(mesh)
    seq_ms = (time.perf_counter() - t0) * 1e3
    ticks, ndev = PP_M + n - 1, len(mesh.device_groups())
    res = {"sequential_ms": seq_ms}
    for rep in (True, False):
        pipe(x, replicate_out=rep)                       # warm-up
        K.reset_launch_counts()
        sync(mesh)
        t0 = time.perf_counter()
        out = pipe(x, replicate_out=rep)
        sync(mesh)
        label = f"PPipeline replicate_out={rep}"
        res[f"{label} ms"] = (time.perf_counter() - t0) * 1e3
        c = res[label] = K.launch_counts()
        check(c["p2p_shift"] == ticks * ndev and c["swiglu"] == ticks * L,
              f"{label}: launches {c}, want p2p_shift {ticks} x {ndev} and swiglu "
              f"{ticks} x {L}")
        only_launched(c, ("p2p_shift", "swiglu"), label)
        check(len(out) == n, f"{label}: {len(out)} outputs for {n} ranks")
        for r, o in enumerate(out):
            want = ref if rep or r == n - 1 else torch.zeros_like(ref)
            check(torch.equal(o.to(dev0), want), f"{label} rank {r}: not bitwise the "
                  f"{L} blocks in order")
    print(f"PPipeline on {card}: {n} stages of {per} Qwen3-1.7B MLP blocks, {PP_M} "
          f"microbatches of [{PP_B}, {D}] {x.dtype}, {ticks} ticks: bitwise the blocks in "
          f"order, "
          f"{res['PPipeline replicate_out=True ms']:.1f} ms (replicate_out=True), "
          f"{res['PPipeline replicate_out=False ms']:.1f} ms (False), against "
          f"{seq_ms:.1f} ms for the blocks in order on one rank; launches "
          f"{ {k_: v for k_, v in res['PPipeline replicate_out=True'].items() if v} }",
          flush=True)
    return res


def push_check(mesh, card: str, seed: int = 0) -> dict:
    """p2p_push_pages of one prompt's k and v (see the module docstring).
    Returns the launch counts of each push and the times."""
    from triton_dist_tpu_torch import kernels as K
    from triton_dist_tpu_torch.tools.tp_check import cuda_ms, emulated, sync
    dev0 = mesh.devices[0]
    gen = torch.Generator(device=dev0).manual_seed(seed)
    kv = [torch.randn(PUSH_SHAPE, generator=gen, device=dev0).to(torch.bfloat16)
          for _ in range(2)]
    mb = sum(t.numel() * t.element_size() for t in kv) / 1e6
    ndev = len(mesh.device_groups())
    res = {}
    for dst in (1, 2):
        K.reset_launch_counts()
        got = [K.p2p_push_pages(t, mesh=mesh, src=0, dst=dst) for t in kv]
        sync(mesh)
        c = res[f"push dst {dst}"] = K.launch_counts()
        check(c["p2p_shift"] == 2 * dst * ndev, f"push to {dst}: launches {c}, want "
              f"{2 * dst} x {ndev} p2p_shift")
        only_launched(c, PP_SPECS, f"push to {dst}")
        for g, t in zip(got, kv):
            check(g.device == mesh.devices[dst] and torch.equal(g.to(dev0), t),
                  f"push to {dst}: not bitwise the payload")
        res[f"push dst {dst} ms"] = cuda_ms(
            lambda dst=dst: [K.p2p_push_pages(t, mesh=mesh, src=0, dst=dst) for t in kv],
            mesh, reps=5)
    if emulated(mesh):
        sinks = [torch.empty_like(t) for t in kv]
        res["library ms"] = cuda_ms(lambda: [s.copy_(t) for s, t in zip(sinks, kv)], mesh)
        lib = "one copy_"
    else:
        res["library ms"] = cuda_ms(lambda: [t.to(mesh.devices[1]) for t in kv], mesh)
        lib = "one .to(cuda:1)"
    print(f"push on {card}: k and v {list(PUSH_SHAPE)} bf16 ({mb:.1f} MB) from rank 0, "
          f"bitwise: to rank 1 (one hop) {res['push dst 1 ms']:.3f} ms, to rank 2 (two hops) "
          f"{res['push dst 2 ms']:.3f} ms, {lib} of the payload {res['library ms']:.3f} ms",
          flush=True)
    return res


def run_pp(mesh, *, card: str, n_layers=None) -> dict:
    """Every PP check on `mesh`: the kernel rows, the registry spec, the
    pipeline over Qwen3-1.7B's MLP blocks (n_layers of its 28), the push.
    Returns the kernel rows and the launch counts of each phase."""
    import triton_dist_tpu_torch.models as m
    t0 = time.perf_counter()
    rows = kernel_rows(mesh)
    counts = {"registry": registry_check(mesh)}
    print(f"[pp {time.perf_counter() - t0:.1f} s] kernel rows and registry done", flush=True)
    cfg = m.qwen3_1p7b()
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=n_layers)
    one = m.DenseLLM.random_init(cfg, device=mesh.devices[0], seed=0)
    counts["pipeline"] = pipeline_check(mesh, one, card)
    del one
    counts["push"] = push_check(mesh, card)
    print(f"[pp {time.perf_counter() - t0:.1f} s] pipeline and push done", flush=True)
    return dict(rows=rows, counts=counts)
