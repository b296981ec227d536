"""Where the time of one megakernel layer goes, phase by phase.

    python3 -m triton_dist_tpu_torch.tools.mega_phases

At chip_smoke.py's shapes (Qwen3-1.7B width: D=2048, F=6144, Hq=16,
Hkv=8, hd=128, random weights): mega_decode at B=128, pos=200, T=264,
and mega_paged_decode at 64 slots with seeded lengths in [1, 224], page
16, bf16. Each layer is launched once with its whole program (which
fills the scratch), then timed (CUDA events, median of 20) with its
whole program and with each phase alone: the kernel runs the phase list
it is given, so a one-task program launches the same cooperative grid
for that phase only. Beside each phase: its bound, the larger of its
bytes over 3.35 TB/s and its flops over 989 TFLOP/s (H100 SXM data
sheet). The whole launch minus the sum of its phases is what the grid
barriers, the launch and the phases' tails cost. Needs one card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import types

import torch

HBM, PEAK = 3.35e12, 989e12
D, F, Hq, Hkv, hd = 2048, 6144, 16, 8, 128


def _ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def _bound(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM, flops / PEAK) * 1e3


def _phase_bounds(B: int, n_keys: int, kv_row_bytes: int) -> dict:
    """Bytes and flops of each phase alone (each input read once, each
    output written once)."""
    N = (Hq + 2 * Hkv) * hd
    return {
        "ln1": _bound(B * D * 4 + B * D * 2, 0),
        "qkv_mm": _bound(D * N * 2 + B * D * 2 + B * N * 4, 2 * B * D * N),
        "attend": _bound(B * N * 4 + n_keys * kv_row_bytes * 2 + B * Hq * hd * 2,
                         4 * hd * (Hq // Hkv) * n_keys),
        "o_proj": _bound(Hq * hd * D * 2 + B * Hq * hd * 2 + 2 * B * D * 4,
                         2 * B * Hq * hd * D),
        "ln2": _bound(B * D * 4 + B * D * 2, 0),
        "gate_up_swiglu": _bound(D * 2 * F * 2 + B * D * 2 + B * F * 2, 2 * B * D * 2 * F),
        "down_proj": _bound(F * D * 2 + B * F * 2 + 2 * B * D * 4, 2 * B * F * D),
    }


def _report(label, layer, call, bounds) -> dict:
    whole = layer.program if hasattr(layer, "program") else None
    programs = getattr(layer, "programs", None)
    prog = programs[False] if programs else whole
    call()
    torch.cuda.synchronize()
    row = {"whole_ms": _ms(call), "phases": {}}
    for task in prog.tasks:
        one = types.SimpleNamespace(tasks=[task])
        if programs:
            layer.programs = {False: one, True: one}
        else:
            layer.program = one
        try:
            row["phases"][task.name] = {"ms": _ms(call), "bound_ms": bounds[task.name]}
        finally:
            if programs:
                layer.programs = programs
            else:
                layer.program = whole
    row["sum_ms"] = sum(p["ms"] for p in row["phases"].values())
    row["bound_ms"] = sum(bounds.values())
    print(f"mega_phases {label}: whole {row['whole_ms']:.4f} ms, phases alone "
          + ", ".join(f"{n} {p['ms']:.4f} (bound {p['bound_ms']:.4f})"
                      for n, p in row["phases"].items())
          + f"; sum {row['sum_ms']:.4f}, barriers and launch "
          f"{row['whole_ms'] - row['sum_ms']:.4f}", flush=True)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("mega_phases: needs an NVIDIA card", file=sys.stderr)
        return 2
    from triton_dist_tpu_torch.layers import precompute_rope
    from triton_dist_tpu_torch.mega import MegaDecodeLayer, MegaPagedDecodeLayer
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, sc=1.0):
        return torch.randn(shape, generator=gen, device=dev) * sc

    w = dict(w_ln1=1 + 0.1 * rn(1, D), q_norm=1 + 0.1 * rn(1, hd),
             k_norm=1 + 0.1 * rn(1, hd), w_ln2=1 + 0.1 * rn(1, D),
             w_qkv=rn(D, (Hq + 2 * Hkv) * hd, sc=D ** -0.5).bfloat16(),
             w_o=rn(Hq * hd, D, sc=(Hq * hd) ** -0.5).bfloat16(),
             w_gu=rn(D, 2 * F, sc=D ** -0.5).bfloat16(),
             w_d=rn(F, D, sc=F ** -0.5).bfloat16())
    cos, sin = precompute_rope(hd, 4096, device=dev)
    out = {"card": card}

    B, T, pos = 128, 264, 200
    x = rn(B, D)
    ck, cv = rn(B, Hkv, T, hd).bfloat16(), rn(B, Hkv, T, hd).bfloat16()
    wd = dict(w, cos_row=cos[pos:pos + 1], sin_row=sin[pos:pos + 1])
    layer = MegaDecodeLayer(d_model=D, n_heads=Hq, n_kv_heads=Hkv, head_dim=hd, ffn=F, T=T)
    out["mega_decode B=128 pos=200"] = _report(
        "mega_decode B=128 pos=200", layer, lambda: layer(x, pos, wd, ck, cv),
        _phase_bounds(B, B * Hkv * (pos + 1), hd * 2))

    Bp, page, cap = 64, 16, 224
    maxp = cap // page
    NP = 1 + Bp * Hkv * maxp
    lens = torch.randint(1, cap + 1, (Bp,), generator=gen, device=dev, dtype=torch.int32)
    posd = (lens - 1).to(torch.int32)
    table = (1 + torch.randperm(NP - 1, generator=gen, device=dev)).reshape(
        Bp * Hkv, maxp).to(torch.int32)
    pk, pv = rn(NP, 1, page, hd).bfloat16(), rn(NP, 1, page, hd).bfloat16()
    xp = rn(Bp, D)
    wp = dict(w, cos_row=cos[posd.long()], sin_row=sin[posd.long()])
    player = MegaPagedDecodeLayer(d_model=D, n_heads=Hq, n_kv_heads=Hkv, head_dim=hd,
                                  ffn=F, page=page, maxp=maxp)
    out["mega_paged_decode 64 slots bf16"] = _report(
        "mega_paged_decode 64 slots bf16", player,
        lambda: player(xp, posd, wp, pk, pv, table),
        _phase_bounds(Bp, int(lens.sum()) * Hkv, hd * 2))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
