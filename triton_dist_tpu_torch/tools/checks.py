"""What the card checks share (chip_smoke.py, tools/tp_check.py,
tools/fault_margin.py): the failing check, the launch-count rule, the
serving traffic, a MoE model's capacity switch, and the margin rule that
holds logits and served streams to the plain engine.

The margin rule: logits within `limit` of the plain engine's largest
logit, and the greedy token equal to the plain argmax wherever the plain
top-2 margin exceeds twice that (5e-2 for the dense engines; PERF.md
section 2 gives the clean gaps and the planted faults' gaps behind it).
"""

from __future__ import annotations

import numpy as np
import torch

GATE = 5e-2
# the serving traffic: N_SYS system prompts of SYS_LEN tokens, each
# shared by N_REQ / N_SYS requests
N_REQ, N_SYS, SYS_LEN = 128, 4, 96


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def only_launched(counts: dict, allowed, label: str) -> None:
    """Every kernel outside `allowed` launched no time (named keys)."""
    others = {n: c for n, c in counts.items() if n not in allowed and c}
    check(not others, f"{label}: kernels launched outside {sorted(allowed)}: {others}")


def set_capacity(model, cf) -> None:
    """Every MoE layer's capacity factor (a float or "dropless"), in place:
    one model serves the capacity and the dropless arms."""
    for ly in model.layers:
        ly.moe.capacity_factor = cf


def serving_requests(m, vocab: int, n: int = N_REQ):
    """The serving traffic, seeded, its first n requests: N_SYS system
    prompts of SYS_LEN tokens, each shared by N_REQ / N_SYS requests in a
    shuffled order, each request adding a distinct 16-48-token tail and
    asking for 32-64 tokens."""
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, vocab, SYS_LEN) for _ in range(N_SYS)]
    which = rng.permutation(np.arange(N_REQ) % N_SYS)
    return [m.Request(rid=i, ids=np.concatenate(
                [prompts[w], rng.randint(0, vocab, rng.randint(16, 49))]).astype(np.int32),
                gen_len=int(rng.randint(32, 65)))
            for i, w in enumerate(which)][:n]


def margin_gate(lf, lr, label: str, limit: float = GATE):
    """lf [B, V] within limit of lr's largest logit, and lf's argmax equal
    to lr's wherever lr's top-2 margin exceeds twice that. Returns
    (max|d|, the tolerance, the tokens so checked)."""
    tol = limit * lr.abs().max().item()
    err = (lf - lr).abs().max().item()
    check(err <= tol, f"{label}: logits max|d| {err} > tol {tol}")
    top2 = lr.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 2 * tol
    agree = torch.argmax(lf, -1) == torch.argmax(lr, -1)
    check(bool(agree[sure].all()), f"{label}: greedy token differs where the margin "
          "exceeds the tolerance")
    return err, tol, int(sure.sum())


def distinct(pairs):
    """The distinct (prompt, stream) pairs among `pairs`, as int arrays: a
    stream served by several runs (spec on and off, chunked and
    monolithic, two backends) is checked once."""
    out = {}
    for p, st in pairs:
        p, st = np.asarray(p, np.int32), np.asarray(st, np.int64)
        out.setdefault((p.tobytes(), st.tobytes()), (p, st))
    return list(out.values())


def tf_gate(m, model, kv_dtype, pairs, label, max_seq, limit=GATE):
    """The distinct served streams among `pairs` [(prompt, stream)] against
    the plain engine (backend "xla") on the model's device, teacher-forced
    along every stream at once: each prompt prefilled into a slot of its
    own, then one forward a step with every slot at its own position. Each
    token must be the plain argmax wherever the plain top-2 margin exceeds
    twice `limit` of that row's largest logit, and at least one token must
    be so checked. Returns (tokens checked, distinct streams)."""
    dev = model.device
    ref = m.Engine(model, max_seq=max_seq, backend="xla", kv_dtype=kv_dtype, device=dev)
    pairs = distinct(pairs)
    cache = ref.make_slot_cache(len(pairs))
    logits = torch.stack([ref.prefill_into_slot(cache, b, p)[0]
                          for b, (p, _) in enumerate(pairs)])
    lens = torch.tensor([len(st) for _, st in pairs], device=dev)
    gen = int(lens.max())
    toks = torch.zeros((len(pairs), gen), dtype=torch.int64, device=dev)
    for b, (_, st) in enumerate(pairs):
        toks[b, :len(st)] = torch.as_tensor(st, device=dev)
    pos = torch.tensor([len(p) for p, _ in pairs], dtype=torch.int32, device=dev)
    forced = 0
    for t in range(gen):
        tol = limit * logits.abs().amax(-1)
        top2 = logits.topk(2, dim=-1).values
        sure = ((top2[:, 0] - top2[:, 1]) > 2 * tol) & (t < lens)
        agree = torch.argmax(logits, -1) == toks[:, t]
        check(bool(agree[sure].all()), f"{label}: step {t} of {len(pairs)} streams: a token "
              "differs from the plain engine where the margin exceeds the tolerance")
        forced += int(sure.sum())
        if t + 1 < gen:
            # a row past its stream's end steps on, its logits unread
            logits, cache = model.forward_tokens_slots(toks[:, t:t + 1], cache, pos,
                                                       mode="xla")
            pos = torch.clamp(pos + 1, max=max_seq - 1)
    check(forced > 0, f"{label}: no token of {len(pairs)} streams passed the margin rule")
    del ref, cache
    return forced, len(pairs)
