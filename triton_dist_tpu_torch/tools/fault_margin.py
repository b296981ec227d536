"""How far planted attention faults move the teacher-forced logits, next
to the clean kernel's gap: the reading behind the logit tolerance of
chip_smoke.py's engine phase.

    python3 -m triton_dist_tpu_torch.tools.fault_margin

Qwen3-1.7B at full width (28 layers, random weights, seed 0), B=128,
S=128, bf16 and int8 configurations as in chip_smoke.py. The plain
("xla") backend runs prefill and 8 greedy decode steps on its own
tokens; the flash backend is then fed the same tokens, once clean and
once per planted fault, and each step's max|d logits| is divided by the
plain backend's largest logit. A fault is planted by wrapping the
attention layer's `flash_decode` at run time (the kernel itself is
unchanged):

    kv_len+1        every call attends one key past its causal frontier
                    (prefill: the next token; decode: an unwritten row)
    decode kv_len+1 the same in decode steps only
    decode kv_len-1 decode steps drop the newest key
    scale=1         the softmax scale is left out
    v_scale=1       (int8) P is not multiplied by the V scales

    python3 -m triton_dist_tpu_torch.tools.fault_margin --mega

holds the megakernel decode path (Engine(backend="mega"), bf16) to the
same reference instead: prefill on flash, then each decode step through
the 28 megakernel launches, clean and with a fault the kernel plants
itself (mega/decode_layer.py FAULT):

    mega drop newest key    the attention walk stops one key short
    mega no residual        o_proj leaves out the attention residual

Prints one line per configuration and case with the largest relative gap
over the steps and whether a limit of LIMIT times the largest logit
catches it; needs one card.
"""

from __future__ import annotations

import json
import sys

import torch

LIMIT = 5e-2
B, S, STEPS = 128, 128, 8


def _faults(real, int8: bool):
    faults = {
        "kv_len+1": lambda q, k, v, n, **kw: real(q, k, v, n + 1, **kw),
        "decode kv_len+1": lambda q, k, v, n, **kw: real(
            q, k, v, n + (q.shape[1] == 1), **kw),
        "decode kv_len-1": lambda q, k, v, n, **kw: real(
            q, k, v, n - (q.shape[1] == 1), **kw),
        "scale=1": lambda q, k, v, n, **kw: real(q, k, v, n, **{**kw, "scale": 1.0}),
    }
    if int8:
        faults["v_scale=1"] = lambda q, k, v, n, **kw: real(
            q, k, v, n, **{**kw, "v_scale": torch.ones_like(kw["v_scale"])})
    return faults


def _forced_logits(model, eng, ids, toks, mode):
    """Logits of prefill and each teacher-forced step, as a list."""
    logits, cache = eng.prefill(ids)
    out = [logits]
    for t in range(toks.shape[1]):
        logits, cache = model.forward_tokens(toks[:, t:t + 1], cache, mode=mode)
        out.append(logits)
    return out


def run_config(m, tp_attn, model, kv_dtype, label, B=B, S=S, mega=False):
    max_seq = S + STEPS + 8
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(1)
    ids = torch.randint(0, model.config.vocab_size, (B, S), generator=gen, device=dev)
    ref_eng = m.Engine(model, max_seq=max_seq, backend="xla", kv_dtype=kv_dtype,
                       device=dev)
    logits, cache = ref_eng.prefill(ids)
    ref, toks = [logits], []
    for _ in range(STEPS):
        toks.append(torch.argmax(logits, -1)[:, None])
        logits, cache = model.forward_tokens(toks[-1], cache, mode="xla")
        ref.append(logits)
    toks = torch.cat(toks, dim=1)
    del cache
    results = {}

    def report(name, got):
        rel = [((g - r).abs().max() / r.abs().max()).item() for g, r in zip(got, ref)]
        results[name] = rel
        worst = max(rel)
        print(f"fault_margin {label} {name}: max|d logits| / max|logit| per step "
              f"{[round(x, 5) for x in rel]}; worst {worst:.5f} -> "
              f"{'caught' if worst > LIMIT else 'NOT caught'} at {LIMIT}", flush=True)

    if mega:
        from triton_dist_tpu_torch.mega import decode_layer
        eng = m.Engine(model, max_seq=max_seq, backend="mega", device=dev)
        for name, fault in (("mega clean", 0), ("mega drop newest key", 1),
                            ("mega no residual", 2)):
            decode_layer.FAULT = fault
            try:
                logits, cache = eng.prefill(ids)
                got = [logits] + [eng.decode_step(toks[:, t], cache)
                                  for t in range(toks.shape[1])]
            finally:
                decode_layer.FAULT = 0
            report(name, got)
        return results
    eng = m.Engine(model, max_seq=max_seq, backend="flash", kv_dtype=kv_dtype,
                   device=dev)
    real = tp_attn.flash_decode
    cases = {"clean": real, **_faults(real, kv_dtype is not None)}
    for name, fn in cases.items():
        tp_attn.flash_decode = fn
        try:
            got = _forced_logits(model, eng, ids, toks, "flash")
        finally:
            tp_attn.flash_decode = real
        report(name, got)
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("fault_margin: needs an NVIDIA card", file=sys.stderr)
        return 2
    import triton_dist_tpu_torch.models as m
    from triton_dist_tpu_torch.layers import tp_attn
    model = m.AutoLLM.from_config(m.qwen3_1p7b(), device="cuda", seed=0)
    if "--mega" in sys.argv[1:]:
        out = {"limit": LIMIT, "mega bf16": run_config(m, tp_attn, model, None,
                                                       "mega bf16", mega=True)}
        print(json.dumps(out), flush=True)
        return 0
    out = {"limit": LIMIT, "bf16": run_config(m, tp_attn, model, None, "bf16")}
    model = model.quantize_int8()
    out["int8"] = run_config(m, tp_attn, model, torch.int8, "int8")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
