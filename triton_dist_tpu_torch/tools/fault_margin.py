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

    python3 -m triton_dist_tpu_torch.tools.fault_margin --mega-tp [--cards 4] [--layers 28]

holds the tensor-parallel megakernel (row 5's TP form) over four ranks
(emulated on one card, or four cards) instead. First one layer at
tp_check.py's row 5 TP shape (Qwen3-1.7B's widths split by four, B=128,
pos=200, T=264) against its plain version, as max |d y| over 1 + max
|plain y| (the worst rank), against tp_check.MEGA_TP_LIMIT, clean and
with each fault the kernel plants itself (mega/decode_layer.py FAULT),
every faulted call right after a clean call on other inputs, so that
the landing slots hold that call's partials:

    mega drop newest key        the attention walk stops one key short
    mega tp fold skips a rank   both all-reduce sections fold without rank
                                me+1's partial
    mega tp fold before wait    both sections fold before their pushes and
                                arrival waits (the rank's own slot holds the
                                previous call's partial)
    mega tp partial twice       both sections fold rank me+1's partial twice

Then the engine: Qwen3-1.7B (all 28 layers, or --layers) over the mesh,
Engine(backend="mega"), B=128 after a 128-token prompt, teacher-forced
against the one-rank "xla" engine, clean and with each fault, against
tp_check.GATE.

    python3 -m triton_dist_tpu_torch.tools.fault_margin --moe

holds the MoE path instead: Qwen3-30B-A3B at full width and depth
(48 layers, 128 experts, top-8, random weights, seed 0, bf16) with every
layer at capacity "dropless", B=4, S=64 (chip_smoke.py's dropless
teacher-forced arm). The flash backend (grouped_gemm kernel) is held to
the plain backend (the dense all-experts oracle), clean and with a
grouped_gemm fault planted by wrapping the layer module's
`grouped_gemm` at run time:

    moe skip K panel       the first 32-deep panel of the contraction is
                           left out (x's first 32 columns read as zero)
    moe expert 0 zeroed    expert 0's outputs are zero

Left free, the two paths route differently wherever a near tie at rank
8/9 flips on bf16 noise, and every flip moves a token's FFN output: the
clean run is shown once that way, with its count of flips. The checked
runs pin the plain backend's routing to the flash path's (RouteTape), so
the gap is the kernels'; the limit is MOE_LIMIT. Each fault is also
planted in one full-width layer (layer 0, M=128 tokens) held to its
plain composition (grouped_gemm_ref), as chip_smoke.py's layer phase
holds it, at 1e-2 of the largest output. Then chip_smoke.py's dropless
serving arm runs, clean and with each fault, and its served tokens are
held to the argmax of the contiguous flash engine teacher-forced along
them: the largest top-2 margin at which they disagree, and how many
tokens clear twice each limit of SERVE_GRID (chip_smoke.py's
MOE_SERVE_LIMIT is chosen from these).

    python3 -m triton_dist_tpu_torch.tools.fault_margin --train

holds the training path instead: Qwen3-1.7B at full width and depth
(random weights, seed 0, bf16), one step of DenseLLM.forward_train on
chip_smoke.py's batch (B=4, S=1024, mean next-token cross-entropy). The
plain mode ("xla") gives the reference loss and gradients; mode "train"
(the kernels) runs clean and with each planted fault, and each run's
loss gap and, per parameter, max|d grad| / max|grad| are printed, the
loss gap against TRAIN_LOSS_LIMIT and the worst gradient gap over the
parameters against TRAIN_GRAD_LIMIT (chip_smoke.py's):

    dq drops its last KV tile     the dq kernel stops one 32-key tile short
                                  of each block's causal frontier
                                  (flash_attn_train.FAULT = 1)
    dk/dv skips a query block     the dk/dv kernel leaves out the first
                                  32-row query block of its walk (FAULT = 2)
    gemm skips a K panel          every GEMM launch of ag_gemm and gemm_rs
                                  reads A's first 32 columns as zero

    python3 -m triton_dist_tpu_torch.tools.fault_margin --ep [--cards]

holds the fused EP-MoE kernel (ep_moe_fused_device, four ranks emulated
on one card, or four cards) to its plain version at tp_check.py's shapes,
clean and with each fault planted in the plain version's inputs or
outputs (as --tp plants the collectives' faults), against
tp_check.EP_FUSED_LIMIT:

    ep dropped peer slab         rank 0's slab for the last peer never lands
    ep stale epoch               the previous call's inputs and panels
    ep slab in the wrong rank's slot  two origins' slabs for one peer swap
    ep valid bit flipped         rank 0's first slot is taken for empty
    ep result to the wrong origin  two origins' results from one peer swap

    python3 -m triton_dist_tpu_torch.tools.fault_margin --gdn

holds the GDN forward instead: the gdn_fwd kernel (mode "pallas") at
chip_smoke.py's rows 10a-10e (GDN_CASES, built by gdn_case) against its
plain version gdn_chunk_ref on the same inputs. The gap of a row is the
larger of max|d o| / max|o| and max|d S_T| / max|S_T|. Each fault is
planted by wrapping the plain version's inputs (the kernel is
unchanged), and its gap is that of the faulted plain run against the
clean one, the gap a kernel with that fault would show:

    gdn drop one beta       token T/2 is not written (beta = 0)
    gdn g shifted a token   each token takes the previous token's decay
    gdn drop S0             the initial state is left out (rows with S0)

The limit is GDN_LIMIT (chip_smoke.py's).

    python3 -m triton_dist_tpu_torch.tools.fault_margin --tp [--cards 4]

holds the tensor-parallel path over four ranks (emulated on one card, or
four cards with --cards 4) instead. First the GEMM collectives at
tp_check.py's decode shapes (M = 128 and 64, bf16 and int8 panels):
gemm_allreduce (kernel B) and gemm_rs (kernel F) at the O and down
projections, ag_gemm (kernel E) at the QKV and gate/up ones, each against
its plain version: the clean gap (max |d| over max |plain|, the worst
rank) beside the gap of the plain version run with a fault planted in its
inputs, the gap a kernel with that fault would show:

    tp drop a rank          rank n-1's partial (ag_gemm: its A chunk) is
                            left out
    tp stale epoch          the previous call's data is read (the previous
                            call's inputs)
    tp chunk twice          gemm_allreduce: rank 1's first 128 x 128 tile
                            is added twice; gemm_rs: rank 1's partial is
                            added twice to chunk 0; ag_gemm: chunk 1 also
                            lands in chunk 2's slot

against tp_check.GEMM_AR_LIMIT, AG_GEMM_LIMIT and GEMM_RS_LIMIT. Then the
engine: Qwen3-1.7B at full width and depth over the mesh on "gemm_ar",
"ar" and "dist", teacher-forced against the one-rank "xla" engine as
tp_check.py holds it, clean and with each fault planted in every
epilogue by wrapping layers/tp_attn.py `tp_down` (rank n-1's input
zeroed; the previous epilogue's output of the same shape returned; rank
1's partial added again to the first M/n rows, on "dist" to rank 0's row
shard), against tp_check.GATE.

    python3 -m triton_dist_tpu_torch.tools.fault_margin --tp-moe [--cards 4] [--layers 24]

holds the tensor-parallel MoE path over four ranks (emulated on one card,
or four cards) instead. First rows 21-23 at tp_check.py's decode shapes
(Qwen3-30B-A3B's panels cut as a rank takes them, bf16): ag_group_gemm,
moe_reduce_rs and moe_reduce_ar, each against its plain version, the
clean gap beside the gap of the plain version run with a fault planted
in its inputs or outputs, against tp_check.TP_MOE_LIMIT:

    tp-moe drop a rank      rank n-1's chunk (ag_group_gemm) or partial
                            (the reductions) is left out
    tp-moe stale epoch      the previous call's inputs and panels are read
    tp-moe chunk twice      ag_group_gemm: chunk 1 also lands in chunk 2's
                            slot; moe_reduce_rs: rank 1's partial is added
                            twice to chunk 0; moe_reduce_ar: rank 1's first
                            tile is added twice on every rank

Then the engine: Qwen3-30B-A3B (its first 24 layers, or --layers; dropless)
over the mesh with moe_impl="tp" on "dist" and "gemm_ar", teacher-forced
against the one-rank "xla" engine with the routing pinned (RouteTape), clean
and with each fault planted in every layer's rank partials by wrapping
layers/tp_moe.py `TP_MoE._expert_mlp_sharded` (the last rank's zeroed; the
previous call's of the same shape returned; rank 1's added to rank 0's),
against MOE_LIMIT.

    python3 -m triton_dist_tpu_torch.tools.fault_margin --sp [--cards 4] [--layers 28]

holds the sequence-parallel path over four ranks (emulated on one card,
or four cards) instead. First rows 24-26 at tools/sp_check.py's shapes
(the decode tick's partials, the SPAttn prefill's blocks and ring at a
quarter of its length), each against its plain version: the clean gap
beside the gap of the plain version run with a fault planted in its
inputs, against sp_check.SP_KERNEL_LIMIT:

    sp drop a rank          lse_combine: rank n-1's partial never arrives
                            (taken as the neutral (0, -1e30, 0)); ring_attn:
                            rank 0's block never arrives (its step skipped
                            on the ranks it reaches; the causal mask hides
                            rank n-1's from every other rank)
    sp stale epoch          lse_combine: rank 1's landed partial is the
                            previous call's; ring_attn: step 1 reads the
                            previous call's block
    sp wrong offset         kv_scatter: every block lands one row past its
                            place in its owner's window
    sp ring step skipped    ring_attn: step 1's block is never consumed

Then the engine: Qwen3-1.7B (all 28 layers, or --layers) over the mesh,
sp_combine "dist", SP_SLOTS slots admitted with the SP serving traffic's
prompts, SP_TF_STEPS greedy decode steps through the paged SP forward,
teacher-forced against the one-rank "xla" engine's slot forward, clean
and with each fault planted in every layer (wrapping
kernels/sp_flash_decode.py sp_combine_partials: rank n-1's partial made
neutral, or the previous call's output of the same shape returned; or
layers/tp_attn.py sp_paged_context: every new row written one row past
its place), against sp_check.SP_GATE.

    python3 -m triton_dist_tpu_torch.tools.fault_margin --ulysses [--cards 4]

holds the Ulysses kernels and layer over four ranks (emulated on one card,
or four cards) instead. First rows 28 (gemm_a2a) and 27 (o_a2a_gemm) at
tools/sp_check.py's Ulysses prefill shapes, each against its plain
version: the clean gap beside the gap of the plain version with a fault
planted in what lands, against sp_check.ULYSSES_KERNEL_LIMIT:

    ulysses wrong owner     rank 0's chunk for owner 1 lands at owner 2 (in
                            its slot 0), and owner 1's slot 0 stays zeros
    ulysses stale epoch     every owner reads rank 1's slot before it
                            arrives: the previous call's chunk (of another
                            input)
    ulysses drop a rank     rank n-1's chunks never land (zeros)

Then the layer: UlyssesAttn at sp_check's widths, B=1 x 16384 positions,
mode "fused" against "xla", clean (and "unfused" against "xla"), and with
each fault planted in row 28's output (wrapping
kernels/sp_attention.py gemm_all_to_all) or in row 27's landed chunks
(wrapping layers/sp_attn.py o_a2a_gemm with the plain arithmetic on the
faulted chunks), against sp_check.ULYSSES_GATE.

Prints one line per configuration and case with the largest relative gap
over the steps and whether a limit of LIMIT times the largest logit
catches it; needs one card.
"""

from __future__ import annotations

import contextlib
import json
import sys

import numpy as np
import torch

LIMIT = 5e-2
MOE_LIMIT = 3e-2                # chip_smoke.py's MOE_LIMIT
B, S, STEPS = 128, 128, 8
MOE_B, MOE_S = 4, 64
# chip_smoke.py's dropless serving arm, and the limits tried on its tokens
MOE_DL_REQS, MOE_DL_SLOTS, SERVE_MAX_SEQ = 8, 4, 224
SERVE_GRID = (0.01, 0.02, 0.03, 0.05, 0.07, 0.1)
TRAIN_B, TRAIN_S = 4, 1024      # chip_smoke.py's training step
TRAIN_LOSS_LIMIT, TRAIN_GRAD_LIMIT = 1e-4, 0.15    # chip_smoke.py's
GDN_LIMIT = 1e-2                # chip_smoke.py's
# chip_smoke.py's GDN rows: (case, B, H, T, dk, dv, chunk, dtype, S0, decay):
# 10a the JAX report's on-chip shape; 10b one Qwen3-Next-80B-A3B GDN
# layer's prefill (32 value heads, the 16 q/k heads repeated to them,
# head dims 128) at 8192 tokens; 10c the registry's shape with S0; 10d a
# ragged T; 10e the deep-decay span (g in [-3.5, -2.5) a token). decay
# "mild": g in [-0.1, 0)
GDN_CASES = (
    ("10a", 8, 16, 2048, 128, 128, 64, torch.bfloat16, False, "mild"),
    ("10b", 1, 32, 8192, 128, 128, 64, torch.bfloat16, False, "mild"),
    ("10c", 1, 2, 128, 128, 128, 64, torch.float32, True, "mild"),
    ("10d", 2, 8, 200, 64, 64, 32, torch.float32, True, "mild"),
    ("10e", 1, 2, 128, 128, 128, 64, torch.float32, False, "deep"),
)


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


class RouteTape:
    """Pins the MoE expert selection of one forward onto another. Under
    record(), every routing call (layers.tp_moe.route, and the EP layers'
    layers.ep_moe.route_ranks, whose ranks' selections are kept as one call
    of the forward's real rows, in row order) runs as usual and its top-k
    experts are kept in call order; under replay(), each call takes the
    next recorded selection in place of its own top-k, weighted by its own
    softmax renormalised over it (what route gives for that selection).
    Two paths that differ by bf16 noise then route alike, and their gap is
    that of their kernels, not of near ties at rank k / k+1 flipping and
    moving a token's whole FFN output. A one-rank path and an EP path may
    record and replay each other."""

    def __init__(self):
        self.calls, self.used = [], 0

    @contextlib.contextmanager
    def _routing(self, fn, fn_ranks):
        from triton_dist_tpu_torch.layers import ep_moe, tp_moe
        real, real_ranks = tp_moe.route, ep_moe.route_ranks
        tp_moe.route, ep_moe.route_ranks = fn, fn_ranks
        try:
            yield self
        finally:
            tp_moe.route, ep_moe.route_ranks = real, real_ranks

    def record(self):
        from triton_dist_tpu_torch.kernels.ep_a2a import route
        from triton_dist_tpu_torch.layers.ep_moe import route_ranks
        self.calls, self.used = [], 0

        def rec(logits, k, **kw):
            w, idx = route(logits, k, **kw)
            self.calls.append(idx)
            return w, idx

        def rec_ranks(logits, k, rows=None):
            out = route_ranks(logits, k, rows)
            dev = out[0][1].device
            idx = torch.cat([i.to(dev).reshape(-1, k) for _, i in out])
            self.calls.append(idx if rows is None else idx[:rows])
            return out
        return self._routing(rec, rec_ranks)

    def _next(self, rows: int, k: int):
        idx = self.calls[self.used]
        self.used += 1
        if tuple(idx.shape) != (rows, k):
            raise ValueError(f"replayed selection {tuple(idx.shape)} for a routing "
                             f"call of {rows} rows, top-{k}")
        return idx

    def replay(self):
        def pick(logits, idx, norm_topk=True):
            w = torch.softmax(logits.float(), dim=-1).gather(1, idx.long())
            return (w / w.sum(dim=-1, keepdim=True) if norm_topk else w), idx

        def rep(logits, k, norm_topk=True):
            return pick(logits, self._next(logits.shape[0], k).to(logits.device), norm_topk)

        def rep_ranks(logits, k, rows=None):
            sizes = [lg.numel() // lg.shape[-1] for lg in logits]
            idx = self._next(sum(sizes) if rows is None else rows, k)
            # padding rows (past `rows`) take experts 0..k-1: they route
            # nowhere (layers/ep_moe.py)
            pad = torch.arange(k, device=idx.device).expand(sum(sizes) - idx.shape[0], k)
            idx = torch.cat([idx, pad.to(idx.dtype)])
            out, r0 = [], 0
            for lg, m in zip(logits, sizes):
                lg2 = lg.reshape(m, lg.shape[-1])
                w, i = pick(lg2, idx[r0:r0 + m].to(lg.device))
                out.append((w.reshape(lg.shape[:-1] + (k,)), i.reshape(lg.shape[:-1] + (k,))))
                r0 += m
            return out
        return self._routing(rep, rep_ranks)

    def done(self) -> bool:
        """Every recorded call was replayed."""
        return self.used == len(self.calls)


def _flips(a, b) -> int:
    """(token, layer) routing choices whose expert sets differ."""
    return sum(int((x.sort(1).values != y.sort(1).values).any(1).sum())
               for x, y in zip(a, b))


def _rel(got, ref) -> float:
    return ((got - ref).abs().max() / ref.abs().max()).item()


def _plain_layer(layer, x, gemm):
    """TP_MoE.fwd_local composed from the port's pieces with `gemm` as
    the grouped GEMM."""
    from triton_dist_tpu_torch.kernels.ep_a2a import (group_tokens_by_expert, route,
                                                     scatter_weighted)
    M = x.shape[0]
    topk_w, topk_idx = route(x @ layer.w_router, layer.top_k)
    x_e, inv, tok = group_tokens_by_expert(x, topk_idx, layer.num_experts, layer._cap(M))
    y_e = layer._expert_mlp_sharded(x_e, gemm=gemm)[0]
    return scatter_weighted(y_e, inv, tok, topk_w, M).to(x.dtype)


def _gemm_faults(real):
    def skip_panel(x, w):
        x = x.clone()
        x[..., :32] = 0
        return real(x, w)

    def zero_expert(x, w):
        out = real(x, w)
        out[0] = 0
        return out
    return {"moe clean": real, "moe skip K panel": skip_panel,
            "moe expert 0 zeroed": zero_expert}


def _caught(worst: float, limit: float) -> str:
    return f"{'caught' if worst > limit else 'NOT caught'} at {limit}"


def run_moe(m, model):
    """The MoE engine path, dropless: the plain backend's tokens, then
    flash clean and with each planted grouped_gemm fault, teacher-forced
    on them against the plain backend with the routing pinned to the
    flash path's (RouteTape), as chip_smoke.py's dropless arm; the clean
    flash path also once with free routing, with its routing flips."""
    from triton_dist_tpu_torch.layers import tp_moe
    for ly in model.layers:
        ly.moe.capacity_factor = "dropless"
    max_seq = MOE_S + STEPS + 8
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(1)
    ids = torch.randint(0, model.config.vocab_size, (MOE_B, MOE_S), generator=gen,
                        device=dev)
    ref_eng = m.Engine(model, max_seq=max_seq, backend="xla", device=dev)
    eng = m.Engine(model, max_seq=max_seq, backend="flash", device=dev)
    ref_tape = RouteTape()
    with ref_tape.record():
        logits, cache = ref_eng.prefill(ids)
        free_ref, toks = [logits], []
        for _ in range(STEPS):
            toks.append(torch.argmax(logits, -1))
            logits = ref_eng.decode_step(toks[-1], cache)
            free_ref.append(logits)
    del cache

    def pinned():
        """Per step: flash (recording its routing), then the plain
        backend replaying it; the relative logit gap per step."""
        tape, rel = RouteTape(), []
        with tape.record():
            lf, cf = eng.prefill(ids)
        with tape.replay():
            lr, cr = ref_eng.prefill(ids)
        rel.append(_rel(lf, lr))
        for t in range(STEPS):
            with tape.record():
                lf = eng.decode_step(toks[t], cf)
            with tape.replay():
                lr = ref_eng.decode_step(toks[t], cr)
            rel.append(_rel(lf, lr))
        assert tape.done()
        return rel

    results = {}
    tape = RouteTape()
    with tape.record():
        logits, cache = eng.prefill(ids)
        free = [logits] + [eng.decode_step(toks[t], cache) for t in range(STEPS)]
    del cache
    rel = [_rel(g, r) for g, r in zip(free, free_ref)]
    flips, rows = _flips(tape.calls, ref_tape.calls), sum(a.shape[0] for a in tape.calls)
    results["moe clean, free routing"] = rel
    results["routing flips"] = [flips, rows]
    print(f"fault_margin moe dropless clean, free routing: max|d logits| / max|logit| "
          f"per step {[round(x, 5) for x in rel]}; routing differs from the plain path in "
          f"{flips} of {rows} (token, layer) choices", flush=True)

    from triton_dist_tpu_torch.kernels import grouped_gemm_ref
    layer = model.layers[0].moe
    layer.capacity_factor = 2.0
    x = torch.randn((B, model.config.hidden_size), generator=gen, device=dev,
                    dtype=model.config.torch_dtype)
    y_ref = _plain_layer(layer, x, grouped_gemm_ref)
    layer.capacity_factor = "dropless"
    real = tp_moe.grouped_gemm
    for name, fn in _gemm_faults(real).items():
        tp_moe.grouped_gemm = fn
        try:
            rel = pinned()
            layer.capacity_factor = 2.0
            y = layer.fwd_local(x)
        finally:
            tp_moe.grouped_gemm = real
            layer.capacity_factor = "dropless"
        layer_rel = _rel(y.float(), y_ref.float())
        results[name + " layer"] = layer_rel
        results[name] = rel
        print(f"fault_margin moe dropless {name}, routing pinned: max|d logits| / "
              f"max|logit| per step {[round(x, 5) for x in rel]}; worst {max(rel):.5f} -> "
              f"{_caught(max(rel), MOE_LIMIT)}; layer 0 at M={B}, capacity 2.0, vs its "
              f"plain composition: max|d| / max|y| {layer_rel:.5f} -> "
              f"{_caught(layer_rel, 1e-2)}", flush=True)
    return results


def served_vs_contiguous(m, model, reqs, out, ref=None):
    """Teacher-force the contiguous flash engine along each request's
    prompt and served tokens. Per served token: its top-2 margin over
    its largest logit, and whether the served token is its argmax. With
    ref (a plain-backend engine), also the plain backend's logits with
    the routing pinned to the flash engine's, and the largest relative
    gap between the two."""
    fl = m.Engine(model, max_seq=SERVE_MAX_SEQ, backend="flash", device=model.device)
    margins, agree, worst = [], [], 0.0
    for r in reqs:
        toks = out[r.rid]
        tape = RouteTape()
        with tape.record():
            lf, cf = fl.prefill(r.ids[None])
        if ref is not None:
            with tape.replay():
                lr, cr = ref.prefill(r.ids[None])
        for t in range(r.gen_len):
            top = lf[0].topk(2).values
            margins.append(((top[0] - top[1]) / lf.abs().max()).item())
            agree.append(int(lf[0].argmax()) == int(toks[t]))
            if ref is not None:
                worst = max(worst, _rel(lf, lr))
            tok = torch.tensor([[int(toks[t])]], device=model.device)
            with tape.record():
                lf, cf = model.forward_tokens(tok, cf, mode="flash")
            if ref is not None:
                with tape.replay():
                    lr, cr = model.forward_tokens(tok, cr, mode="xla")
    return margins, agree, worst


def run_moe_serving(m, model):
    """chip_smoke.py's dropless MoE serving arm (paged, radix cache, the
    first MOE_DL_REQS requests on MOE_DL_SLOTS slots), clean and with each
    planted grouped_gemm fault; each run's served tokens held to the
    contiguous flash engine teacher-forced along them. A disagreement at
    a top-2 margin above twice a limit fails the margin rule at that
    limit: the largest such margin is the noise the rule must clear
    (clean) or the fault's reach (planted)."""
    from triton_dist_tpu_torch.layers import tp_moe
    for ly in model.layers:
        ly.moe.capacity_factor = "dropless"
    from triton_dist_tpu_torch.tools.checks import serving_requests
    reqs = serving_requests(m, model.config.vocab_size, MOE_DL_REQS)
    eng = m.Engine(model, max_seq=SERVE_MAX_SEQ, backend="flash", device=model.device)
    ref = m.Engine(model, max_seq=SERVE_MAX_SEQ, backend="xla", device=model.device)
    real = tp_moe.grouped_gemm
    results = {}
    for name, fn in _gemm_faults(real).items():
        tp_moe.grouped_gemm = fn
        try:
            out = m.ContinuousScheduler(eng, batch=MOE_DL_SLOTS, chunk=16, paged=True,
                                        page=16).run(reqs)
        finally:
            tp_moe.grouped_gemm = real
        margins, agree, worst = served_vs_contiguous(
            m, model, reqs, out, ref if fn is real else None)
        bad = [mg for mg, a in zip(margins, agree) if not a]
        reach = max(bad, default=0.0)
        cleared = {L: sum(mg > 2 * L for mg in margins) for L in SERVE_GRID}
        results[name] = dict(tokens=len(margins), disagree=len(bad), max_margin=reach,
                             cleared=cleared, pinned_gap=worst if fn is real else None)
        print(f"fault_margin moe dropless serving {name}: {len(bad)} of {len(margins)} "
              f"served tokens differ from the contiguous flash engine's argmax, the "
              f"largest at top-2 margin {reach:.5f} of the largest logit; tokens whose "
              f"margin clears twice a limit L: {cleared}"
              + (f"; contiguous flash vs plain, routing pinned, along the served tokens: "
                 f"max|d logits| / max|logit| {worst:.5f}" if fn is real else ""),
              flush=True)
    return results


def train_batch(cfg, B=TRAIN_B, S=TRAIN_S):
    """The training batch of chip_smoke.py: token ids and labels [B, S]
    from a generator seeded 1, on the card."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
    labels = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
    return ids, labels


def train_loss(model, ids, labels, mode):
    """Mean next-token cross-entropy of forward_train (the JAX example's
    loss: -mean log p(label))."""
    logits = model.forward_train(ids, mode)
    return torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                             labels.reshape(-1))


def grads_of(model, ids, labels, mode):
    """(loss, {name: gradient}) of one backward; the gradients are taken
    off the model."""
    for _, p in model.named_parameters():
        p.grad = None
    loss = train_loss(model, ids, labels, mode)
    loss.backward()
    grads = {}
    for n, p in model.named_parameters():
        grads[n], p.grad = p.grad, None
    return loss.item(), grads


def grad_gaps(got, ref) -> dict:
    """max |got - ref| / max |ref| of each parameter's gradient."""
    return {n: ((got[n].float() - ref[n].float()).abs().max()
                / ref[n].float().abs().max()).item() for n in ref}


@contextlib.contextmanager
def _train_fault(case: str):
    from triton_dist_tpu_torch.kernels import (allgather_gemm, flash_attn_train,
                                               gemm_reduce_scatter)
    real = allgather_gemm.gemm

    def skip_panel(a, b):
        a = a.clone()
        a[:, :32] = 0
        return real(a, b)
    flash_attn_train.FAULT = {"dq drops its last KV tile": 1,
                              "dk/dv skips a query block": 2}.get(case, 0)
    if case == "gemm skips a K panel":
        allgather_gemm.gemm = gemm_reduce_scatter.gemm = skip_panel
    try:
        yield
    finally:
        flash_attn_train.FAULT = 0
        allgather_gemm.gemm = gemm_reduce_scatter.gemm = real


def gdn_case(case, device="cuda", seed=0) -> dict:
    """The inputs of GDN_CASES row `case`, made on `device` from `seed`:
    q and k rows of unit norm (as the model normalises them, which keeps
    the delta rule a contraction) but in 10e (the JAX deep-decay test's
    0.3 randn); v 0.3 randn; beta in [0, 1); S0 0.05 randn. Returns the
    gdn_fwd keyword arguments (q, k, v, g, beta, S0, chunk)."""
    name, B, H, T, dk, dv, chunk, dt, s0, decay = next(c for c in GDN_CASES if c[0] == case)
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def unit(x):
        return x if decay == "deep" else x / x.norm(dim=-1, keepdim=True)
    Hqk = 16 if name == "10b" else H       # 10b: 16 q/k heads for 32 value heads
    q = unit(randn(B, Hqk, T, dk) * 0.3)
    k = unit(randn(B, Hqk, T, dk) * 0.3)
    if Hqk != H:
        q, k = q.repeat_interleave(H // Hqk, 1), k.repeat_interleave(H // Hqk, 1)
    v = randn(B, H, T, dv) * 0.3
    u = torch.rand((B, H, T), generator=gen, device=device)
    g = -(2.5 + u) if decay == "deep" else -0.1 * u
    beta = torch.rand((B, H, T), generator=gen, device=device)
    return dict(q=q.to(dt).contiguous(), k=k.to(dt).contiguous(), v=v.to(dt), g=g,
                beta=beta, S0=randn(B, H, dk, dv) * 0.05 if s0 else None, chunk=chunk)


def gdn_gap(got, ref) -> float:
    """max over (o, S_T) of max|got - ref| / max|ref|."""
    return max(_rel(a.float(), b.float()) for a, b in zip(got, ref))


def gdn_faults(kw: dict) -> dict:
    """The planted faults of GDN_CASES rows, as wrapped inputs of the
    plain version: name -> gdn_fwd keyword arguments."""
    T = kw["q"].shape[2]
    beta = kw["beta"].clone()
    beta[..., T // 2] = 0
    out = {"gdn drop one beta": dict(kw, beta=beta),
           "gdn g shifted a token": dict(kw, g=torch.roll(kw["g"], 1, -1))}
    if kw["S0"] is not None:
        out["gdn drop S0"] = dict(kw, S0=None)
    return out


def run_gdn():
    """Each GDN_CASES row: the kernel against its plain version, clean,
    beside each planted fault's gap."""
    from triton_dist_tpu_torch.kernels import gdn_chunk_ref, gdn_fwd
    results = {}
    for case in GDN_CASES:
        kw = gdn_case(case[0])
        ref = gdn_chunk_ref(**kw)
        res = {"gdn clean": gdn_gap(gdn_fwd(**kw), ref)}
        for name, fkw in gdn_faults(kw).items():
            res[name] = gdn_gap(gdn_chunk_ref(**fkw), ref)
        torch.cuda.synchronize()
        results[case[0]] = res
        print(f"gdn {case[0]}: " + "; ".join(
            f"{n} {g:.3g} ({_caught(g, GDN_LIMIT)})" for n, g in res.items()), flush=True)
        del kw, ref
    return results


def run_train(m):
    """The training step, plain against the kernels clean and with each
    planted fault."""
    model = m.AutoLLM.from_config(m.qwen3_1p7b(), device="cuda", seed=0).requires_grad_()
    ids, labels = train_batch(model.config)
    loss_x, ref = grads_of(model, ids, labels, "xla")
    results = {}
    for case in ("train clean", "dq drops its last KV tile", "dk/dv skips a query block",
                 "gemm skips a K panel"):
        with _train_fault(case):
            loss_k, got = grads_of(model, ids, labels, "train")
        gaps = grad_gaps(got, ref)
        worst = max(gaps, key=gaps.get)
        loss_gap = abs(loss_k - loss_x) / abs(loss_x)
        results[case] = dict(loss_gap=loss_gap, worst=gaps[worst], worst_param=worst,
                             median=sorted(gaps.values())[len(gaps) // 2])
        top = sorted(gaps, key=gaps.get, reverse=True)[:4]
        print(f"train {case}: loss {loss_k:.6f} vs plain {loss_x:.6f} (gap {loss_gap:.3g}); "
              f"gradient gap worst {gaps[worst]:.5f} ({worst}), median "
              f"{results[case]['median']:.5f}; top {[(n, round(gaps[n], 5)) for n in top]}; "
              f"loss {_caught(loss_gap, TRAIN_LOSS_LIMIT)}, gradients "
              f"{_caught(gaps[worst], TRAIN_GRAD_LIMIT)}", flush=True)
        del got
    return results


def tp_kernel_faults(mesh, seed: int = 0) -> dict:
    """The GEMM collectives at the decode shapes: the clean gap and each
    planted fault's (see the module docstring)."""
    from triton_dist_tpu_torch import kernels as K
    from triton_dist_tpu_torch.kernels.gemm import gemm_ref
    from triton_dist_tpu_torch.tools import tp_check as tc
    n = mesh.size
    dev0 = mesh.devices[0]
    gen = torch.Generator(device=dev0).manual_seed(seed)

    def draw(rows, k_, n_, wt):
        a = [torch.randn(rows, k_, generator=gen, device=dev0).bfloat16().to(d)
             for d in mesh.devices]
        w = [(torch.randn(k_, n_, generator=gen, device=dev0) * k_ ** -0.5).bfloat16()
             for _ in range(n)]
        if wt == "int8":
            w = [K.quantize_int8(x) for x in w]
        return a, [K.QuantW(q=x.q.to(d), s=x.s.to(d)) if wt == "int8" else x.to(d)
                   for x, d in zip(w, mesh.devices)]

    def with_rank(xs, r, x):
        return xs[:r] + [x] + xs[r + 1:]

    def gemm_ar(a, w, prev_a, prev_w):
        twice = K.gemm_allreduce_ref(a, w)[0].clone()
        tile = gemm_ref(a[1], w[1])[:128, :128].to(twice.device)
        twice[:128, :128] = (twice[:128, :128].float() + tile.float()).to(twice.dtype)
        return (K.gemm_allreduce(a, w, mesh=mesh), K.gemm_allreduce_ref,
                [twice] + K.gemm_allreduce_ref(a, w)[1:])

    def gemm_rs(a, w, prev_a, prev_w):
        out = K.gemm_rs_ref(a, w)
        m = out[0].shape[0]
        twice = (out[0].float() + gemm_ref(a[1], w[1])[:m].float().to(dev0)).to(out[0].dtype)
        return K.gemm_rs(a, w, mesh=mesh), K.gemm_rs_ref, [twice] + out[1:]

    def ag_gemm(a, w, prev_a, prev_w):
        return (K.ag_gemm(a, w, mesh=mesh), K.ag_gemm_ref,
                K.ag_gemm_ref(with_rank(a, 2, a[1].to(a[2].device)), w))

    # (name, limit, op, the rows of A and its K and N per rank, case)
    ops = []
    for M in (tc.B, tc.SERVE_B):
        for what, k_loc in (("o_proj", tc.HQ * tc.HD // n), ("down", tc.I // n)):
            ops += [("gemm_allreduce", tc.GEMM_AR_LIMIT, gemm_ar, (M, k_loc, tc.D), what),
                    ("gemm_rs", tc.GEMM_RS_LIMIT, gemm_rs, (M, k_loc, tc.D), what)]
        for what, n_loc in (("qkv", (tc.HQ + 2 * tc.HKV) * tc.HD // n),
                            ("gate_up", 2 * tc.I // n)):
            ops.append(("ag_gemm", tc.AG_GEMM_LIMIT, ag_gemm, (M // n, tc.D, n_loc), what))
    results = {}
    for name, limit, op, shape, what in ops:
        for wt in ("bf16", "int8"):
            prev_a, prev_w = draw(*shape, wt)
            a, w = draw(*shape, wt)
            out, plain, twice = op(a, w, prev_a, prev_w)
            ref = plain(a, w)

            def gap(outs):
                return max(_rel(o.float().to(dev0), r.float().to(dev0))
                           for o, r in zip(outs, ref))

            res = {"tp clean": gap(out),
                   "tp drop a rank": gap(plain(with_rank(a, n - 1, torch.zeros_like(a[-1])),
                                               w)),
                   "tp stale epoch": gap(plain(prev_a, prev_w)),
                   "tp chunk twice": gap(twice)}
            torch.cuda.synchronize()
            key = f"{name} {what} M={shape[0] * (n if name == 'ag_gemm' else 1)} {wt}"
            results[key] = res
            print(f"tp kernel {key}: " + "; ".join(
                f"{c} {g:.3g} ({_caught(g, limit)})" for c, g in res.items()), flush=True)
    return results


@contextlib.contextmanager
def _tp_fault(case: str):
    """Plant `case` in every "ar"/"gemm_ar"/"dist" epilogue
    (layers/tp_attn.py tp_down, as both layer modules hold it)."""
    from triton_dist_tpu_torch.kernels.quant import qmm
    from triton_dist_tpu_torch.layers import tp_attn, tp_mlp
    real = tp_attn.tp_down
    last = {}

    def faulty(mode, hs, ws, mesh):
        if mode not in ("ar", "gemm_ar", "dist") or case == "tp clean":
            return real(mode, hs, ws, mesh)
        if case == "tp drop a rank":
            return real(mode, hs[:-1] + [torch.zeros_like(hs[-1])], ws, mesh)
        out = real(mode, hs, ws, mesh)
        if case == "tp stale epoch":
            key = (tuple(out[0].shape), tuple(hs[0].shape))
            prev, last[key] = last.get(key), out
            return out if prev is None else prev
        if mode == "dist":             # rank 0 holds chunk 0 of the sum
            rows = out[0].shape[0]
            return [out[0] + qmm(hs[1], ws[1])[:rows].to(out[0].device)] + out[1:]
        rows = out[0].shape[0] // len(out)
        extra = qmm(hs[1], ws[1])[:rows]
        return [torch.cat([o[:rows] + extra.to(o.device), o[rows:]]) for o in out]

    tp_attn.tp_down = tp_mlp.tp_down = faulty
    try:
        yield
    finally:
        tp_attn.tp_down = tp_mlp.tp_down = real


def run_tp(m, mesh) -> dict:
    """The GEMM collectives' faults, then the engine's on "gemm_ar", "ar"
    and "dist"."""
    from triton_dist_tpu_torch.tools import tp_check as tc
    results = {"kernel": tp_kernel_faults(mesh)}
    cfg = m.qwen3_1p7b()
    gen = torch.Generator(device=mesh.devices[0]).manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (tc.B, tc.S), generator=gen,
                        device=mesh.devices[0])
    ref_model = m.DenseLLM.random_init(cfg, device=mesh.devices[0], seed=0)
    model = ref_model.to_mesh(mesh)
    ref = m.Engine(ref_model, max_seq=tc.S + STEPS + 8, backend="xla", device=mesh.devices[0])
    lr0, cr = ref.prefill(ids)
    refs, toks, lr = [lr0], [], lr0
    for _ in range(STEPS):
        toks.append(torch.argmax(lr, -1))
        lr = ref.decode_step(toks[-1], cr)
        refs.append(lr)
    del cr
    for backend in ("gemm_ar", "ar", "dist"):
        eng = m.Engine(model, max_seq=tc.S + STEPS + 8, backend=backend,
                       device=mesh.devices[0])
        res = {}
        for case in ("tp clean", "tp drop a rank", "tp stale epoch", "tp chunk twice"):
            with _tp_fault(case):
                lf, cf = eng.prefill(ids)
                gaps = []
                for t, want in enumerate(refs):
                    gaps.append(_rel(lf, want))
                    if t < STEPS:
                        lf = eng.decode_step(toks[t], cf)
            res[case] = max(gaps)
            print(f"tp engine {backend} {case}: worst step gap {res[case]:.4g} "
                  f"({_caught(res[case], tc.GATE)}); per step "
                  f"{[round(g, 4) for g in gaps]}", flush=True)
            del cf
        results[f"engine {backend}"] = res
    return results


MEGA_TP_FAULTS = {"mega tp clean": 0, "mega drop newest key": 1,
                  "mega tp fold skips a rank": 3, "mega tp fold before wait": 4,
                  "mega tp partial twice": 5}


def run_mega_tp(m, mesh, n_layers: int = 28, seed: int = 0) -> dict:
    """The TP megakernel's planted faults: one layer against its plain
    version, then the engine against the one-rank plain engine (the
    module docstring)."""
    from triton_dist_tpu_torch.mega import decode_layer, mega_decode_layer_ref
    from triton_dist_tpu_torch.tools import tp_check as tc
    dev0 = mesh.devices[0]
    gen = torch.Generator(device=dev0).manual_seed(seed)
    pos, T = 200, 264
    w, x, ck, cv, _ = tc.mega_full_layer(gen, dev0, pos=pos, T=T)
    layer, ws, cks, cvs = tc.mega_tp_split(mesh, w, ck, cv, T)
    xs = mesh.replicate(x)
    other = mesh.replicate(torch.randn(x.shape, generator=gen, device=dev0))
    kr, vr = [t.clone() for t in cks], [t.clone() for t in cvs]
    ys_ref, _, _ = mega_decode_layer_ref(xs, pos, ws, kr, vr, n_heads=layer.n_heads,
                                         n_kv_heads=layer.n_kv_heads, head_dim=tc.HD,
                                         tp=mesh.size)
    kernel = {}
    for name, fault in MEGA_TP_FAULTS.items():
        k1, v1 = [t.clone() for t in cks], [t.clone() for t in cvs]
        layer(other, pos, ws, [t.clone() for t in cks], [t.clone() for t in cvs])
        decode_layer.FAULT = fault
        try:
            ys, _, _ = layer(xs, pos, ws, k1, v1)
            tc.sync(mesh)
        finally:
            decode_layer.FAULT = 0
        gap = max(((y.to(dev0) - yr.to(dev0)).abs().max()
                   / (1 + yr.to(dev0).abs().max())).item() for y, yr in zip(ys, ys_ref))
        equal = all(torch.equal(y.to(dev0), ys[0]) for y in ys)
        kernel[name] = gap
        print(f"mega tp kernel {name}: gap {gap:.4g} ({_caught(gap, tc.MEGA_TP_LIMIT)}); "
              f"ranks bitwise equal: {equal}", flush=True)
    results = {"kernel": kernel}
    import dataclasses
    cfg = dataclasses.replace(m.qwen3_1p7b(), num_layers=n_layers)
    ids = torch.randint(0, cfg.vocab_size, (tc.B, tc.S), generator=gen, device=dev0)
    ref_model = m.DenseLLM.random_init(cfg, device=dev0, seed=0)
    model = ref_model.to_mesh(mesh)
    ref = m.Engine(ref_model, max_seq=tc.S + STEPS + 8, backend="xla", device=dev0)
    lr0, cr = ref.prefill(ids)
    refs, toks, lr = [lr0], [], lr0
    for _ in range(STEPS):
        toks.append(torch.argmax(lr, -1))
        lr = ref.decode_step(toks[-1], cr)
        refs.append(lr)
    del cr, ref_model
    eng = m.Engine(model, max_seq=tc.S + STEPS + 8, backend="mega", device=dev0)
    engine = {}
    for name, fault in MEGA_TP_FAULTS.items():
        lf, cf = eng.prefill(ids)
        gaps = [_rel(lf, refs[0])]
        decode_layer.FAULT = fault
        try:
            for t in range(STEPS):
                lf = eng.decode_step(toks[t], cf)
                gaps.append(_rel(lf, refs[t + 1]))
        finally:
            decode_layer.FAULT = 0
        engine[name] = max(gaps)
        print(f"mega tp engine {name}: worst step gap {engine[name]:.4g} "
              f"({_caught(engine[name], tc.GATE)}); per step {[round(g, 4) for g in gaps]}",
              flush=True)
        del cf
    results[f"engine {n_layers} layers"] = engine
    return results


def ep_fused_faults(mesh, seed: int = 0) -> dict:
    """ep_moe_fused_device at tp_check's shapes (the serving layer's bf16
    and int8 panels, the registry's f32): the kernel's clean gap to its
    plain version, and each planted fault's, as max |d| over max |plain|
    over the ranks (see the module docstring)."""
    from triton_dist_tpu_torch.kernels.ep_fused import (ep_moe_fused_device,
                                                         ep_moe_fused_device_ref)
    from triton_dist_tpu_torch.tools import tp_check as tc
    n = mesh.size
    dev0 = mesh.devices[0]
    gen = torch.Generator(device=dev0).manual_seed(seed)
    E_loc = tc.E_MOE // n
    _, cap_e = tc._ep_caps(mesh, tc.B // n)
    results = {}
    for what, El, ce, Dm, Im, dt, wt in (
            ("serving layer", E_loc, cap_e, tc.D, tc.I_MOE, torch.bfloat16, "bf16"),
            ("serving layer", E_loc, cap_e, tc.D, tc.I_MOE, torch.bfloat16, "int8"),
            ("registry", 2, 16, 128, 128, torch.float32, "f32")):
        def draw():
            xs = [(torch.randn(n * El * ce, Dm, generator=gen, device=dev0) * 0.3).to(dt)
                  .to(d) for d in mesh.devices]
            wgu = [(torch.randn(El, Dm, 2 * Im, generator=gen, device=dev0) * Dm ** -0.5)
                   .to(dt) for _ in range(n)]
            wd = [(torch.randn(El, Im, Dm, generator=gen, device=dev0) * Im ** -0.5).to(dt)
                  for _ in range(n)]
            if wt == "int8":
                from triton_dist_tpu_torch.kernels.quant import quantize_int8
                wgu, wd = [quantize_int8(w) for w in wgu], [quantize_int8(w) for w in wd]
            return xs, wgu, wd

        prev = draw()
        xs, wgu, wd = draw()
        plain = lambda x_, g_=wgu, d_=wd: ep_moe_fused_device_ref(x_, g_, d_, cap_e=ce)  # noqa
        ref = plain(xs)

        def gap(outs):
            return max(_rel(o.float().to(dev0), r.float().to(dev0)) for o, r in zip(outs, ref))

        def slabs(x):
            return x.reshape(n, El * ce, Dm)

        def edit(fn):
            out = [x.clone() for x in xs]
            fn(out)
            return out

        # a dropped peer slab: rank 0's slab for peer n-1 never lands
        dropped = edit(lambda o: slabs(o[0])[n - 1].zero_())
        # a slab landed in the wrong rank's slot: peer 1 takes rank 2's
        # slab where rank 1's belongs (and the reverse)
        swapped = [x.clone() for x in xs]
        slabs(swapped[1])[1], slabs(swapped[2])[1] = slabs(xs[2])[1], slabs(xs[1])[1]
        # a valid bit flipped: rank 0's first slot taken for empty
        flipped = edit(lambda o: o[0][0].zero_())
        wrong_origin = [y.clone() for y in ref]
        wrong_origin[0][1], wrong_origin[1][1] = ref[1][1], ref[0][1]
        res = {"ep clean": gap(ep_moe_fused_device(xs, wgu, wd, mesh=mesh, cap_e=ce)),
               "ep dropped peer slab": gap(plain(dropped)),
               "ep stale epoch": gap(ep_moe_fused_device_ref(prev[0], prev[1], prev[2],
                                                             cap_e=ce)),
               "ep slab in the wrong rank's slot": gap(plain(swapped)),
               "ep valid bit flipped": gap(plain(flipped)),
               "ep result to the wrong origin": gap(wrong_origin)}
        torch.cuda.synchronize()
        key = f"ep_moe_fused {what} E_loc={El} cap_e={ce} {wt}"
        results[key] = res
        print(f"ep kernel {key}: " + "; ".join(
            f"{c} {g:.3g} ({_caught(g, tc.EP_FUSED_LIMIT)})" for c, g in res.items()),
            flush=True)
    return results


def tp_moe_kernel_faults(mesh, seed: int = 0) -> dict:
    """Rows 21-23 at tp_check.py's decode shapes (Qwen3-30B-A3B's panels as
    a rank takes them, views of one panel, bf16): the kernel's clean gap to
    its plain version and each planted fault's, as max |d| over max |plain|
    over the ranks (see the module docstring)."""
    from triton_dist_tpu_torch import kernels as K
    from triton_dist_tpu_torch.kernels.group_gemm import grouped_gemm_ref
    from triton_dist_tpu_torch.tools import tp_check as tc
    n = mesh.size
    dev0 = mesh.devices[0]
    gen = torch.Generator(device=dev0).manual_seed(seed)
    lay = tc._tp_moe_layer()
    E, D, i = tc.E_MOE, tc.D, tc.I_MOE // n

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev0) * scale).bfloat16()

    def draw(name):
        if name == "ag_group_gemm":
            c = lay._cap(tc.B // n)
            w = randn(E, D, 2 * i * n, scale=D ** -0.5)
            ws = [(w[:, :, r * i:(r + 1) * i].to(d), w[:, :, n * i + r * i:n * i + (r + 1) * i]
                   .to(d)) for r, d in enumerate(mesh.devices)]
            return [randn(E, c, D, scale=0.3).to(d) for d in mesh.devices], ws
        capT = n * lay._cap(tc.B // n) if name == "moe_reduce_rs" else lay._cap(tc.B)
        w = randn(E, i * n, D, scale=(i * n) ** -0.5)
        return ([randn(E, capT, i, scale=0.3).to(d) for d in mesh.devices],
                [w[:, r * i:(r + 1) * i].to(d) for r, d in enumerate(mesh.devices)])

    def with_rank(xs, r, x):
        return xs[:r] + [x] + xs[r + 1:]

    results = {}
    for name, kernel, plain in (("ag_group_gemm", K.ag_group_gemm, K.ag_group_gemm_ref),
                                ("moe_reduce_rs", K.moe_reduce_rs, K.moe_reduce_rs_ref),
                                ("moe_reduce_ar", K.moe_reduce_ar, K.moe_reduce_ar_ref)):
        prev = draw(name)
        a, w = draw(name)
        ref = plain(a, w)

        def gap(outs):
            return max(_rel(o.float().to(dev0), r.float().to(dev0)) for o, r in zip(outs, ref))

        if name == "ag_group_gemm":      # chunk 1 also lands in chunk 2's slot
            twice = plain(with_rank(a, 2, a[1].to(a[2].device)), w)
        elif name == "moe_reduce_rs":    # rank 1's partial added twice to chunk 0
            m = ref[0].shape[1]
            extra = grouped_gemm_ref(a[1][:, :m], w[1]).to(dev0)
            twice = [(ref[0].float() + extra.float()).to(ref[0].dtype)] + ref[1:]
        else:                            # rank 1's first tile added twice
            tile = grouped_gemm_ref(a[1], w[1])[:1, :128, :128].to(dev0)
            twice = [o.clone() for o in ref]
            for o in twice:
                o[:1, :128, :128] = (o[:1, :128, :128].float() + tile.float().to(o.device)
                                     ).to(o.dtype)
        res = {"tp-moe clean": gap(kernel(a, w, mesh=mesh)),
               "tp-moe drop a rank": gap(plain(with_rank(a, n - 1, torch.zeros_like(a[-1])),
                                               w)),
               "tp-moe stale epoch": gap(plain(*prev)),
               "tp-moe chunk twice": gap(twice)}
        torch.cuda.synchronize()
        results[name] = res
        print(f"tp-moe kernel {name}: " + "; ".join(
            f"{c} {g:.3g} ({_caught(g, tc.TP_MOE_LIMIT)})" for c, g in res.items()), flush=True)
        del prev, a, w, ref, twice
    return results


@contextlib.contextmanager
def _tp_moe_fault(case: str):
    """Plant `case` in every TP_MoE layer's rank partials
    (layers/tp_moe.py `_expert_mlp_sharded`, what fwd_dist reduce-scatters
    and fwd_local sums)."""
    from triton_dist_tpu_torch.layers.tp_moe import TP_MoE
    real = TP_MoE._expert_mlp_sharded
    last = {}

    def faulty(self, x_e, gemm=None):
        parts = real(self, x_e, gemm)
        if case == "tp-moe drop a rank":
            return parts[:-1] + [torch.zeros_like(parts[-1])]
        if case == "tp-moe stale epoch":
            key = tuple(parts[0].shape)
            prev, last[key] = last.get(key), parts
            return parts if prev is None else prev
        if case == "tp-moe chunk twice":
            return [parts[0] + parts[1].to(parts[0].device)] + parts[1:]
        return parts

    TP_MoE._expert_mlp_sharded = faulty
    try:
        yield
    finally:
        TP_MoE._expert_mlp_sharded = real


def run_tp_moe(m, mesh, n_layers: int) -> dict:
    """Rows 21-23's faults, then the TP-MoE engine gate's: Qwen3-30B-A3B
    (its first n_layers layers, dropless) over the mesh on "dist" and
    "gemm_ar", teacher-forced against the one-rank plain engine with the
    routing pinned (RouteTape), clean and with each fault planted in the
    rank partials, against MOE_LIMIT."""
    from triton_dist_tpu_torch.tools import tp_check as tc
    results = {"kernel": tp_moe_kernel_faults(mesh)}
    dev = mesh.devices[0]
    one = tc.cut_layers(m.AutoLLM.from_config(m.qwen3_30b_a3b(), device=dev, seed=0,
                                              capacity_factor="dropless"), n_layers)
    model = one.to_mesh(mesh, "tp")
    gen = torch.Generator(device=dev).manual_seed(0)
    ids = torch.randint(0, one.config.vocab_size, (tc.EP_TF_B, tc.EP_TF_S), generator=gen,
                        device=dev)
    max_seq = tc.EP_TF_S + STEPS + 8
    ref = m.Engine(one, max_seq=max_seq, backend="xla", device=dev)
    for backend, pre in tc.TP_MOE_BACKENDS.items():
        eng = m.Engine(model, max_seq=max_seq, backend=backend, prefill_backend=pre,
                       device=dev)
        res = {}
        for case in ("tp-moe clean", "tp-moe drop a rank", "tp-moe stale epoch",
                     "tp-moe chunk twice"):
            tape, gaps = RouteTape(), []
            with _tp_moe_fault(case):
                with tape.record():
                    lf, cf = eng.prefill(ids)
                with tape.replay():
                    lr, cr = ref.prefill(ids)
                for t in range(STEPS + 1):
                    gaps.append(_rel(lf, lr))
                    if t < STEPS:
                        tok = torch.argmax(lr, -1)
                        with tape.record():
                            lf = eng.decode_step(tok, cf)
                        with tape.replay():
                            lr = ref.decode_step(tok, cr)
            res[case] = max(gaps)
            print(f"tp-moe engine {backend} {case}: worst step gap {res[case]:.4g} "
                  f"({_caught(res[case], MOE_LIMIT)}); per step "
                  f"{[round(g, 4) for g in gaps]}", flush=True)
            del cf, cr
        results[f"engine {backend}"] = res
    return results


def sp_kernel_faults(mesh, seed: int = 0) -> dict:
    """Rows 24-26: the clean gap and each planted fault's (see the module
    docstring)."""
    from triton_dist_tpu_torch import kernels as K
    from triton_dist_tpu_torch.tools import sp_check as sc
    n = mesh.size
    dev0 = mesh.devices[0]
    gen = torch.Generator(device=dev0).manual_seed(seed)
    bf = torch.bfloat16

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev0, dtype=dtype)

    def gap(outs, refs):
        return max(_rel(o.float().to(dev0), r.float().to(dev0)) for o, r in zip(outs, refs))

    results = {}
    # lse_combine at the decode tick's partials
    R = sc.SP_SLOTS * sc.HQ

    def partials():
        return ([randn(R, sc.HD).to(d) for d in mesh.devices],
                [torch.stack([randn(R), randn(R).abs() + 0.1]).to(d) for d in mesh.devices])

    prev, cur = partials(), partials()
    acc, st = cur
    ref = K.lse_combine_dist_ref(acc, st)
    out = K.sp_combine_partials([a.reshape(sc.SP_SLOTS, 1, sc.HQ, sc.HD) for a in acc],
                                [s_[0].reshape(sc.SP_SLOTS, 1, sc.HQ) for s_ in st],
                                [s_[1].reshape(sc.SP_SLOTS, 1, sc.HQ) for s_ in st],
                                mesh=mesh, combine="dist")
    neutral = torch.stack([torch.full_like(st[-1][0], -1e30), torch.zeros_like(st[-1][1])])
    results["lse_combine"] = {
        "sp clean": gap([o.reshape(R, sc.HD) for o in out], ref),
        "sp drop a rank": gap(K.lse_combine_dist_ref(acc[:-1] + [torch.zeros_like(acc[-1])],
                                                     st[:-1] + [neutral]), ref),
        "sp stale epoch": gap(K.lse_combine_dist_ref(acc[:1] + [prev[0][1]] + acc[2:],
                                                     st[:1] + [prev[1][1]] + st[2:]), ref)}
    # kv_scatter at the SPAttn prefill's blocks
    s_loc, t_loc = sc.SP_S // n, sc.SP_T // n
    cache = [randn(1, sc.HKV, t_loc, sc.HD, dtype=bf).to(d) for d in mesh.devices]
    new = [randn(1, sc.HKV, s_loc, sc.HD, dtype=bf).to(d) for d in mesh.devices]
    ref = K.kv_cache_scatter_ref([c.clone() for c in cache], new)
    out = K.kv_cache_scatter([c.clone() for c in cache], new, mesh=mesh)
    off = [c.clone() for c in cache]
    for p, blk in enumerate(new):
        owner, o = divmod(p * s_loc, t_loc)
        off[owner][:, :, o + 1:o + 1 + s_loc] = blk[:, :, :t_loc - o - 1].to(off[owner].device)
    results["kv_scatter"] = {"sp clean": gap(out, ref), "sp wrong offset": gap(off, ref)}
    # ring_attn at a quarter of the SPAttn prefill's length
    sl = s_loc // 4

    def qkv():
        return ([randn(1, sl, sc.HQ, sc.HD, dtype=bf).to(d) for d in mesh.devices],
                [randn(1, sc.HKV, sl, sc.HD, dtype=bf).to(d) for d in mesh.devices],
                [randn(1, sc.HKV, sl, sc.HD, dtype=bf).to(d) for d in mesh.devices])

    (pq, pk, pv), (q, k, v) = qkv(), qkv()

    def ring(kk, vv, skip=None, blocks=None):
        """The plain ring with step `skip` left out, or step 1's block taken
        from `blocks` (the previous call's)."""
        outs = []
        for me in range(n):
            state = None
            for r in range(n):
                src = (me - r) % n
                if skip is not None and skip(me, r, src):
                    continue
                kb, vb = (blocks if blocks is not None and r == 1 else (kk, vv))
                valid, q_off = (sl if src <= me else 0), (me - src) * sl
                from triton_dist_tpu_torch.kernels.flash_attn import _partial_ref, _unfold_q
                a, m_, l_ = _partial_ref(q[me], kb[src].to(q[me].device), vb[src].to(
                    q[me].device), valid, q_off, sc.HD ** -0.5)
                part = (_unfold_q(a, 1, sl, sc.HKV), _unfold_q(m_, 1, sl, sc.HKV),
                        _unfold_q(l_, 1, sl, sc.HKV))
                state = part if state is None else K.sp_attention._lse_accumulate(state, part)
            outs.append(state[0] / state[2].clamp_min(1e-30)[..., None])
        return outs

    ref = ring(k, v)
    out = K.sp_ring_attention(q, k, v, mesh=mesh, mode="ring_shmem")
    results["ring_attn"] = {
        "sp clean": gap(out, ref),
        "sp drop a rank": gap(ring(k, v, skip=lambda me, r, src: src == 0 and me != src), ref),
        "sp stale epoch": gap(ring(k, v, blocks=(pk, pv)), ref),
        "sp ring step skipped": gap(ring(k, v, skip=lambda me, r, src: r == 1), ref)}
    torch.cuda.synchronize()
    for name, res in results.items():
        print(f"sp kernel {name}: " + "; ".join(
            f"{c} {g:.3g} ({_caught(g, sc.SP_KERNEL_LIMIT)})" for c, g in res.items()),
              flush=True)
    return results


@contextlib.contextmanager
def _sp_fault(case: str):
    """Plant `case` in every layer's SP attend (see the module docstring)."""
    from triton_dist_tpu_torch.layers import tp_attn
    # the module (the package re-exports the function sp_flash_decode over
    # the submodule's name)
    spd = sys.modules["triton_dist_tpu_torch.kernels.sp_flash_decode"]
    real_comb, real_ctx = spd.sp_combine_partials, tp_attn.sp_paged_context
    last = {}

    def comb(acc, m_, l_, **kw):
        if case == "sp drop a rank":
            acc = acc[:-1] + [torch.zeros_like(acc[-1])]
            m_ = m_[:-1] + [torch.full_like(m_[-1], -1e30)]
            l_ = l_[:-1] + [torch.zeros_like(l_[-1])]
        out = real_comb(acc, m_, l_, **kw)
        if case == "sp stale epoch":
            key = tuple(out[0].shape)
            prev, last[key] = last.get(key), out
            return out if prev is None else prev
        return out

    def ctx(*a, **kw):
        out = real_ctx(*a, **kw)
        if case == "sp wrong offset":
            page = a[1].page
            out = [dict(c, row=(c["row"] + 1) % page) for c in out]
        return out

    spd.sp_combine_partials, tp_attn.sp_paged_context = comb, ctx
    try:
        yield
    finally:
        spd.sp_combine_partials, tp_attn.sp_paged_context = real_comb, real_ctx


def run_sp(m, mesh, n_layers) -> dict:
    """Rows 24-26's faults, then the engine's (see the module docstring)."""
    import dataclasses

    from triton_dist_tpu_torch.models.prefix_cache import RefcountedPages
    from triton_dist_tpu_torch.tools import sp_check as sc
    results = {"kernel": sp_kernel_faults(mesh)}
    cfg = dataclasses.replace(m.qwen3_1p7b(), num_layers=n_layers)
    dev0 = mesh.devices[0]
    one = m.DenseLLM.random_init(cfg, device=dev0, seed=0)
    model = one.to_mesh(mesh, "sp", sp_combine="dist")
    reqs = sc.sp_requests(m, cfg.vocab_size)[:sc.SP_SLOTS]
    max_seq = sc.SP_MAX_SEQ
    # the one-rank plain engine's logits along its own greedy tokens
    ref = m.Engine(one, max_seq=max_seq, backend="xla", device=dev0)
    cache = ref.make_slot_cache(len(reqs))
    lr = torch.stack([ref.prefill_into_slot(cache, b, r.ids)[0] for b, r in enumerate(reqs)])
    pos0 = torch.tensor([len(r.ids) for r in reqs], dtype=torch.int32, device=dev0)
    refs, toks, pos = [lr], [], pos0
    for _ in range(sc.SP_TF_STEPS):
        toks.append(torch.argmax(lr, -1))
        lr, cache = one.forward_tokens_slots(toks[-1][:, None], cache, pos, mode="xla")
        refs.append(lr)
        pos = pos + 1
    del cache
    eng = m.Engine(model, max_seq=max_seq, backend="flash", device=dev0)
    res = {}
    for case in ("sp clean", "sp drop a rank", "sp stale epoch", "sp wrong offset"):
        pcache = eng.make_paged_slot_cache(len(reqs), page=sc.SP_PAGE)
        pool = RefcountedPages(pcache.num_pages, cfg.num_kv_heads, shards=mesh.size)
        trash = np.full((cfg.num_kv_heads,), pcache.trash, np.int32)
        lf = []
        for b, r in enumerate(reqs):
            rows = np.full((cfg.num_kv_heads, pcache.max_pages), pcache.trash, np.int32)
            for j in range(-(-(len(r.ids) + sc.SP_TF_STEPS) // sc.SP_PAGE)):
                rows[:, j] = pool.alloc_group()
            lf.append(eng.admit_slot_paged(pcache, b, r.ids, rows, 0, trash, trash, 0)[0])
        gaps, lf, pos = [_rel(torch.stack(lf), refs[0])], None, pos0
        with _sp_fault(case):
            for t in range(sc.SP_TF_STEPS):
                lf, _ = model.forward_tokens_slots_paged(toks[t][:, None], pcache, pos)
                gaps.append(_rel(lf, refs[t + 1]))
                pos = pos + 1
        res[case] = max(gaps)
        print(f"sp engine dist {case}: worst step gap {res[case]:.4g} "
              f"({_caught(res[case], sc.SP_GATE)}); per step {[round(g, 4) for g in gaps]}",
              flush=True)
        del pcache
    results["engine dist"] = res
    return results


def _ulysses_edit(case: str, outs, prev):
    """Plant `case` in row 28's per-rank outputs [n, m, Nc] (copies; prev:
    the previous call's outputs of the same shape)."""
    n = len(outs)
    o = [t.clone() for t in outs]
    if case == "ulysses wrong owner":
        o[2][0] = outs[1][0].to(o[2].device)
        o[1][0].zero_()
    elif case == "ulysses stale epoch":
        for j in range(n):
            o[j][1] = prev[j][1]
    elif case == "ulysses drop a rank":
        for j in range(n):
            o[j][n - 1].zero_()
    return o


def _ulysses_chunks(case: str, chunks, prev):
    """Plant `case` in what row 27's owners receive: owner me multiplies
    chunk me of rank q's chunks (copies; prev: the previous call's)."""
    n = len(chunks)
    c = [t.clone() for t in chunks]
    if case == "ulysses wrong owner":
        c[0][2] = chunks[0][1]
        c[0][1].zero_()
    elif case == "ulysses stale epoch":
        for me in range(n):
            if me != 1:
                c[1][me] = prev[1][me]
    elif case == "ulysses drop a rank":
        for me in range(n - 1):
            c[n - 1][me].zero_()
    return c


ULYSSES_CASES = ("ulysses wrong owner", "ulysses stale epoch", "ulysses drop a rank")


def ulysses_faults(mesh, seed: int = 0) -> dict:
    """Rows 27-28's faults, then the layer's (see the module docstring)."""
    from triton_dist_tpu_torch import kernels as K
    from triton_dist_tpu_torch.kernels import sp_attention
    from triton_dist_tpu_torch.layers import sp_attn
    from triton_dist_tpu_torch.tools import sp_check as sc
    n = mesh.size
    dev0 = mesh.devices[0]
    gen = torch.Generator(device=dev0).manual_seed(seed)
    bf = torch.bfloat16

    def parts(*shape):
        return [torch.randn(shape, generator=gen, device=dev0).to(bf).to(d)
                for d in mesh.devices]

    def gap(outs, refs):
        return max(_rel(o.float().to(dev0).reshape(r.shape), r.float().to(dev0))
                   for o, r in zip(outs, refs))

    results = {}
    C = (sc.HQ + 2 * sc.HKV) // n * sc.HD
    m = sc.SP_S // n
    w = mesh.replicate((torch.randn(sc.D, n * C, generator=gen, device=dev0)
                        * sc.D ** -0.5).to(bf))
    prev_a, a = parts(m, sc.D), parts(m, sc.D)
    ref, prev = K.gemm_all_to_all_ref(a, w), K.gemm_all_to_all_ref(prev_a, w)
    res = {"ulysses clean": gap(K.gemm_all_to_all(a, w, mesh=mesh), ref)}
    for case in ULYSSES_CASES:
        res[case] = gap(_ulysses_edit(case, ref, prev), ref)
    results["gemm_a2a"] = res
    No = sc.HQ * sc.HD
    wo = mesh.replicate((torch.randn(No, sc.D, generator=gen, device=dev0)
                         * No ** -0.5).to(bf))
    prev_x, x = parts(1, sc.SP_S, No // n), parts(1, sc.SP_S, No // n)
    chunks = [sp_attention.o_chunks(t, n) for t in x]
    prev_c = [sp_attention.o_chunks(t, n) for t in prev_x]
    ref = sp_attention.o_a2a_gemm_from_chunks(chunks, wo)
    res = {"ulysses clean": gap(K.o_a2a_gemm(x, wo, mesh=mesh), ref)}
    for case in ULYSSES_CASES:
        res[case] = gap(sp_attention.o_a2a_gemm_from_chunks(
            _ulysses_chunks(case, chunks, prev_c), wo), ref)
    results["o_a2a_gemm"] = res
    torch.cuda.synchronize()
    for name, r in results.items():
        print(f"ulysses kernel {name}: " + "; ".join(
            f"{c} {g:.3g} ({_caught(g, sc.ULYSSES_KERNEL_LIMIT)})" for c, g in r.items()),
              flush=True)
    # the layer: fused against xla, clean and with each fault planted
    lay, (cos, sin) = sc.ulysses_layer(mesh, gen)
    x_prev, xs = sc.ulysses_input(mesh, gen), sc.ulysses_input(mesh, gen)
    ref = lay.prefill(xs, cos, sin, mode="xla")
    res = {"ulysses clean": gap(lay.prefill(xs, cos, sin, mode="fused"), ref),
           "ulysses clean unfused": gap(lay.prefill(xs, cos, sin, mode="unfused"), ref)}
    real_g, real_o = sp_attention.gemm_all_to_all, sp_attn.o_a2a_gemm
    last = {}

    def record_g(*a_, **kw):
        last["g"] = real_g(*a_, **kw)
        return last["g"]

    def record_o(x_, w_, mesh):
        last["o"] = [sp_attention.o_chunks(t, n) for t in x_]
        return real_o(x_, w_, mesh=mesh)

    sp_attention.gemm_all_to_all, sp_attn.o_a2a_gemm = record_g, record_o
    try:
        lay.prefill(x_prev, cos, sin, mode="fused")     # the previous call's chunks
        prev_g, prev_o = last["g"], last["o"]
        for case in ULYSSES_CASES:
            def faulty_g(*a_, case=case, **kw):
                return _ulysses_edit(case, real_g(*a_, **kw), prev_g)

            def faulty_o(x_, w_, mesh, case=case):
                ch = [sp_attention.o_chunks(t, n) for t in x_]
                B, S, _ = x_[0].shape
                return [y.reshape(B, S // n, -1) for y in sp_attention.o_a2a_gemm_from_chunks(
                    _ulysses_chunks(case, ch, prev_o), w_)]

            for row, g_fn, o_fn in (("28", faulty_g, real_o), ("27", real_g, faulty_o)):
                sp_attention.gemm_all_to_all, sp_attn.o_a2a_gemm = g_fn, o_fn
                res[f"{case} (row {row})"] = gap(lay.prefill(xs, cos, sin, mode="fused"), ref)
    finally:
        sp_attention.gemm_all_to_all, sp_attn.o_a2a_gemm = real_g, real_o
    results["layer fused against xla"] = res
    for c, g in res.items():
        print(f"ulysses layer {c}: {g:.4g} ({_caught(g, sc.ULYSSES_GATE)})", flush=True)
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("fault_margin: needs an NVIDIA card", file=sys.stderr)
        return 2
    if "--ulysses" in sys.argv[1:]:
        from triton_dist_tpu_torch.runtime import make_mesh
        from triton_dist_tpu_torch.tools import sp_check as sc
        mesh = (make_mesh(4) if "--cards" in sys.argv[1:]
                else make_mesh(4, devices=["cuda:0"] * 4))
        print(json.dumps({"kernel limit": sc.ULYSSES_KERNEL_LIMIT, "layer limit": sc.ULYSSES_GATE,
                          "ulysses": ulysses_faults(mesh)}), flush=True)
        return 0
    if "--mega-tp" in sys.argv[1:]:
        import triton_dist_tpu_torch.models as m
        from triton_dist_tpu_torch.runtime import make_mesh
        from triton_dist_tpu_torch.tools import tp_check as tc
        mesh = (make_mesh(4) if "--cards" in sys.argv[1:]
                else make_mesh(4, devices=["cuda:0"] * 4))
        args = sys.argv[1:]
        n_layers = int(args[args.index("--layers") + 1]) if "--layers" in args else 28
        print(json.dumps({"kernel limit": tc.MEGA_TP_LIMIT, "engine limit": tc.GATE,
                          "mega tp": run_mega_tp(m, mesh, n_layers)}), flush=True)
        return 0
    if "--sp" in sys.argv[1:]:
        import triton_dist_tpu_torch.models as m
        from triton_dist_tpu_torch.runtime import make_mesh
        from triton_dist_tpu_torch.tools import sp_check as sc
        mesh = (make_mesh(4) if "--cards" in sys.argv[1:]
                else make_mesh(4, devices=["cuda:0"] * 4))
        args = sys.argv[1:]
        n_layers = int(args[args.index("--layers") + 1]) if "--layers" in args else 28
        print(json.dumps({"kernel limit": sc.SP_KERNEL_LIMIT, "engine limit": sc.SP_GATE,
                          "sp": run_sp(m, mesh, n_layers)}), flush=True)
        return 0
    if "--ep" in sys.argv[1:]:
        from triton_dist_tpu_torch.runtime import make_mesh
        from triton_dist_tpu_torch.tools import tp_check as tc
        mesh = (make_mesh(4) if "--cards" in sys.argv[1:]
                else make_mesh(4, devices=["cuda:0"] * 4))
        print(json.dumps({"limit": tc.EP_FUSED_LIMIT, "ep": ep_fused_faults(mesh)}),
              flush=True)
        return 0
    if "--tp-moe" in sys.argv[1:]:
        import triton_dist_tpu_torch.models as m
        from triton_dist_tpu_torch.runtime import make_mesh
        from triton_dist_tpu_torch.tools import tp_check as tc
        mesh = (make_mesh(4) if "--cards" in sys.argv[1:]
                else make_mesh(4, devices=["cuda:0"] * 4))
        args = sys.argv[1:]
        n_layers = int(args[args.index("--layers") + 1]) if "--layers" in args else 24
        print(json.dumps({"kernel limit": tc.TP_MOE_LIMIT, "engine limit": MOE_LIMIT,
                          "tp-moe": run_tp_moe(m, mesh, n_layers)}), flush=True)
        return 0
    if "--tp" in sys.argv[1:]:
        import triton_dist_tpu_torch.models as m
        from triton_dist_tpu_torch.runtime import make_mesh
        from triton_dist_tpu_torch.tools import tp_check as tc
        mesh = (make_mesh(4) if "--cards" in sys.argv[1:]
                else make_mesh(4, devices=["cuda:0"] * 4))
        print(json.dumps({"kernel limits": {"gemm_allreduce": tc.GEMM_AR_LIMIT,
                                            "ag_gemm": tc.AG_GEMM_LIMIT,
                                            "gemm_rs": tc.GEMM_RS_LIMIT},
                          "engine limit": tc.GATE, "tp": run_tp(m, mesh)}), flush=True)
        return 0
    if "--gdn" in sys.argv[1:]:
        print(json.dumps({"limit": GDN_LIMIT, "gdn": run_gdn()}), flush=True)
        return 0
    import triton_dist_tpu_torch.models as m
    from triton_dist_tpu_torch.layers import tp_attn
    if "--train" in sys.argv[1:]:
        out = {"loss limit": TRAIN_LOSS_LIMIT, "gradient limit": TRAIN_GRAD_LIMIT,
               "train bf16": run_train(m)}
        print(json.dumps(out), flush=True)
        return 0
    if "--moe" in sys.argv[1:]:
        model = m.AutoLLM.from_config(m.qwen3_30b_a3b(), device="cuda", seed=0)
        out = {"limit": MOE_LIMIT, "moe bf16 dropless": run_moe(m, model),
               "moe bf16 dropless serving": run_moe_serving(m, model)}
        print(json.dumps(out), flush=True)
        return 0
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
