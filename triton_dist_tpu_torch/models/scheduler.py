"""Continuous-batching decode scheduler: slot-based multi-request serving
over the contiguous slot cache or the paged KV pool with the radix
prefix cache.

Counterpart of triton_dist_tpu/models/scheduler.py (`ResumeState`,
`Request`, `_TokenLog`, `DecodeSlots`, `PagedDecodeSlots`,
`ContinuousScheduler` with its synchronous poll, speculative decoding
(`spec=K`) and chunked prefill (`prefill_budget`)) for greedy decode.
Up to `batch` requests occupy distinct decode slots; a freed slot is
refilled from the queue between chunks of `chunk` decode steps, and the
tick runs the same device code whatever the occupancy mix: admission
changes data (rows of the logits, positions, the active mask, the page
table), never the program.

Mechanics (models/engine.py slot entry points):
- a new request prefills into its slot's row (contiguous) or, on the
  paged pool, maps its longest cached prefix read-only, copy-on-writes
  the partly matched boundary page and prefills only the uncached
  suffix;
- a tick is `chunk` steps of Engine.slot_chunk / paged_slot_chunk: per
  row argmax, KV write at the row's own position and per-row attention
  lengths; the logits, positions and active mask stay on the device,
  and the host reads the chunk's tokens back once (`_fetch`), the one
  synchronisation per tick;
- between chunks the host trims each slot's tokens to its remaining
  budget, retires finished slots (paged: inserting prompt + generated
  into the radix tree and pointing the slot's table at the trash page)
  and admits queued requests into the freed rows.

Preemption: a paged admission that cannot get pages even after LRU
eviction preempts a victim slot (lowest emitted count, then the most
recently admitted) instead of rejecting: the victim's prompt + generated
tokens go into the radix tree through the retire path, and it re-queues
behind the admission that displaced it with the rest of its budget; on
re-admission the tree hands its pages back (the match caps at n-1, so
only the last token recomputes). Greedy streams are the same token for
token, preempted or not.

Speculative decoding (spec=K, models/spec_decode.py): a poll's decode
step is one draft-then-verify iteration. The drafter proposes up to K
continuations of each slot's history plus its pending seed token
(capped at remaining - 1), one window forward (Engine.slot_verify_chunk
/ paged_slot_verify_chunk) scores every slot's window, and each slot
keeps its seed plus the accepted draft prefix (1..K+1 tokens); the
corrected token becomes the next seed. Greedy streams are those of
spec=0. stats() reports spec_accept_rate and tokens_per_step.

Chunked prefill (prefill_budget=N, Sarathi-Serve): an admission runs no
forward; it parks the request in a PREFILLING slot (paged: after the
prefix lookup, page reservation, table install and boundary-page
copy-on-write). While any prefill is in flight, each poll runs ONE mixed
tick (Engine.slot_mixed_chunk, or slot_mixed_verify_chunk under spec)
fusing the live decode step (one token per decode slot, or its verify
window) with up to N prompt tokens of the in-flight prefills, split
first-admitted first; a prefill whose last chunk lands arms and decodes
from the next poll. So no live stream waits on more than N prompt tokens
between two of its tokens (stats()["max_prefill_tokens_per_poll"]).
Only slots that emitted a token since their admission may be preempted
(prefill progress lives in evictable pages; displacing a prefilling
slot could livelock two admissions).

Telemetry (runtime/telemetry.py): every counter lives in the
scheduler's metrics registry, so stats() is one deep snapshot, with the
live `ttft_ms`, `inter_token_ms`, `request_latency_ms` and `poll_ms`
histograms (host wall time).

Not ported yet, and refused at construction or at submit with
NotImplementedError: overlap scheduling, the host KV tier
(host_pool_pages > 0), the watchdog (watchdog_s), chaos faults (fault),
SLO classes (slo_classes, Request.slo), deadlines (Request.deadline_ms),
parallel sampling (Request.n > 1) and grammars (Request.grammar). The
engine refuses sampled decoding itself (and with it sampled
speculative acceptance).

MoE models: the tick's routing-load vector (the slot chunk's fifth
output) comes back in the tick's one readback, flattened with its tokens, and feeds
the `expert_tokens{expert=e}` counters, the `moe_capacity_drops` counter
and the `expert_load_imbalance` gauge (max / mean of the cumulative
per-expert load). Admissions are not counted, as in the JAX package.

Sequence parallelism (an engine over a model with sp_axis, `sp_size`
> 1): the paged pool's page ids split over the sp ranks, the prefix
cache's allocator rotates fresh groups across them (PrefixCache(...,
shards=cache.sp)), stats() carries per-shard residency
(`sp_pages_resident`) and the `sp_size` gauge, and the decode ticks'
device wait is attributed to the kind "sp_combine"
(`device_wait_s_by_kind`, with "verify", "mixed" and "mixed_verify").

backend="mega": the paged ticks run the fused megakernel program
(Engine.paged_slot_chunk routes them; admissions stay per-op on
"flash"), and the contiguous scheduler refuses a mega engine, as the JAX
scheduler does, and so does spec > 0; a mega engine's mixed ticks
(prefill_budget) run the per-op program. The `mega_enabled` gauge says
which program the decode ticks run.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from triton_dist_tpu_torch.models.prefix_cache import PoolExhausted, PrefixCache
from triton_dist_tpu_torch.models.spec_decode import NgramDrafter
from triton_dist_tpu_torch.runtime.telemetry import Telemetry


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: not yet ported")


@dataclasses.dataclass
class ResumeState:
    """Mid-stream snapshot carried by a preempted request, beyond the
    (prompt + generated) tokens already folded into Request.ids. The KV
    itself is not snapshotted: the radix tree holds the preempted pages
    until eviction recycles them, and re-admission maps them back or
    recomputes, with the same tokens either way."""
    emitted: int = 0               # tokens already streamed before preemption
    t0: Optional[int] = None       # spec mode: the pending (unemitted) seed token


@dataclasses.dataclass
class Request:
    """One generation request (the scheduler's admission unit). The
    fields after `seed` belong to features not ported yet and must keep
    their defaults; `resume` is set by preemption, never by callers."""
    rid: object                    # caller's id (any hashable)
    ids: np.ndarray                # prompt token ids [S]
    gen_len: int
    seed: int = 0
    deadline_ms: Optional[float] = None
    slo: Optional[str] = None
    resume: Optional[ResumeState] = None
    n: int = 1
    grammar: object = None


class _TokenLog:
    """Incrementally grown int32 token log (amortized-doubling numpy
    buffer) backing the per-slot token mirrors: appends are amortized
    O(1) and `view()` is a zero-copy slice for the radix-tree insert."""

    __slots__ = ("_buf", "_n")

    def __init__(self, init=None, cap: int = 64):
        self._buf = np.empty((max(int(cap), 8),), np.int32)
        self._n = 0
        if init is not None:
            self.extend(init)

    def __len__(self) -> int:
        return self._n

    def extend(self, toks) -> None:
        toks = np.asarray(toks, np.int32).reshape(-1)
        need = self._n + len(toks)
        if need > len(self._buf):
            buf = np.empty((max(need, 2 * len(self._buf)),), np.int32)
            buf[:self._n] = self._buf[:self._n]
            self._buf = buf
        self._buf[self._n:need] = toks
        self._n = need

    def append(self, t: int) -> None:
        self.extend((t,))

    def pop(self) -> None:
        """Drop the last token (the drafter's pending-seed lookup undoes
        its append this way)."""
        self._n -= 1

    def view(self) -> np.ndarray:
        """Zero-copy window over the valid extent (read-only; appends only
        ever write past it)."""
        return self._buf[:self._n]


class DecodeSlots:
    """Per-slot decode state: the device-side carry of the slot scan
    (last logits [B, V] f32, positions [B] int32, active mask [B] bool)
    plus host-side bookkeeping (remaining budget, occupant, the chunked
    prefills in flight and, under spec=K, each slot's token history and
    pending seed). Admission and retirement edit rows of the carry
    between chunks."""

    def __init__(self, engine, batch: int, *, spec: int = 0, drafter=None,
                 telemetry: Optional[Telemetry] = None):
        self.engine = engine
        self.batch = batch
        self.tele = telemetry if telemetry is not None else Telemetry()
        dev = engine.device
        self.cache = self._make_cache()
        self.logits = torch.zeros((batch, engine.model.config.vocab_size),
                                  dtype=torch.float32, device=dev)
        self.pos = torch.zeros((batch,), dtype=torch.int32, device=dev)
        self.active = torch.zeros((batch,), dtype=torch.bool, device=dev)
        # host mirrors (scheduling is host-side; the model never syncs)
        self.remaining = np.zeros((batch,), np.int64)
        self.rids: List[Optional[object]] = [None] * batch
        # the occupant's Request and admission order: the preemption
        # victim policy reads both
        self.reqs: List[Optional[Request]] = [None] * batch
        self.admit_tick = np.zeros((batch,), np.int64)
        self._admit_seq = 0
        # every prompt token pushed through a forward
        self.prefill_forwarded = 0
        # time blocked on the tick's token readback (_fetch), in all and by
        # the kind of the tick it waited on
        self.device_wait_s = 0.0
        self.device_wait_s_by_kind: Dict[str, float] = dict.fromkeys(
            ("chunk", "sp_combine", "verify", "mixed", "mixed_verify"), 0.0)
        self._kind = "chunk"
        # chunked prefill: per slot, the prompt still prefilling (None once
        # armed) and how many of its tokens have been forwarded
        self._pf_ids: List[Optional[np.ndarray]] = [None] * batch
        self._pf_off = np.zeros((batch,), np.int64)
        self._moe_family = bool(getattr(engine, "moe_family", False))
        if self._moe_family:
            reg = self.tele.registry
            E = engine.model.config.num_experts
            self._moe_tokens_cum = np.zeros((E,), np.int64)
            self._c_expert = [reg.counter("expert_tokens",
                                          "routed entries per expert (compute load)",
                                          labels={"expert": str(e)}) for e in range(E)]
            self._c_moe_drops = reg.counter(
                "moe_capacity_drops", "routed entries lost to expert capacity (0 under "
                                      "capacity_factor='dropless')")
            self._g_moe_imb = reg.gauge("expert_load_imbalance",
                                        "max/mean of cumulative per-expert routed load")
        self.spec = int(spec)
        if self.spec:
            if engine.backend == "mega":
                raise ValueError(
                    "backend='mega' does not fuse the spec-decode verify window yet (the "
                    "fused tick is the greedy S == 1 paged step); serve spec=K on the "
                    "per-op backends")
            self.drafter = drafter if drafter is not None else NgramDrafter()
            self._vocab = engine.model.config.vocab_size
            # per slot: the drafter's corpus (prompt + emitted) and the
            # pending seed token each verify window starts with
            self._hist: List[_TokenLog] = [_TokenLog() for _ in range(batch)]
            self._t0 = np.zeros((batch,), np.int64)
            reg = self.tele.registry
            self._spec_steps = reg.counter("spec_steps", "verify forwards run")
            self._spec_slot_steps = reg.counter("spec_slot_steps",
                                                "live (slot, forward) pairs")
            self._spec_emitted = reg.counter("spec_emitted", "tokens kept (incl. seeds)")
            self._spec_drafted_total = reg.counter("spec_drafted",
                                                   "drafter tokens proposed")
            self._spec_accepted_total = reg.counter("spec_accepted",
                                                    "drafter tokens accepted")
            self._spec_drafted = np.zeros((batch,), np.int64)
            self._spec_accepted = np.zeros((batch,), np.int64)
            # a drafter that raises (or proposes garbage) degrades to plain
            # decode for that window
            self._drafter_errors = reg.counter("drafter_errors")

    def _make_cache(self):
        """Cache-flavour hook (PagedDecodeSlots swaps in the paged pool)."""
        return self.engine.make_slot_cache(self.batch)

    @property
    def capacity(self) -> int:
        """Admittable prompt + gen budget per slot."""
        return self.cache.capacity

    @property
    def free(self) -> List[int]:
        return [b for b in range(self.batch) if self.rids[b] is None]

    @property
    def occupied(self) -> List[int]:
        return [b for b in range(self.batch) if self.rids[b] is not None]

    @property
    def prefill_slots(self) -> List[int]:
        """Slots mid-chunked-prefill (occupied, not yet armed)."""
        return [b for b in range(self.batch) if self._pf_ids[b] is not None]

    @property
    def decode_slots(self) -> List[int]:
        """Occupied slots that are armed (emitting tokens)."""
        return [b for b in self.occupied if self._pf_ids[b] is None]

    @property
    def stats(self) -> dict:
        """Speculative-decoding counters (empty when spec == 0): the
        lifetime accept rate (accepted / proposed drafts), the tokens
        emitted per slot per verify forward (1.0: no win, K+1: every draft
        accepted), and the per-slot arrays of the current occupants."""
        if not self.spec:
            return {}
        drafted = self._spec_drafted_total.value
        accepted = self._spec_accepted_total.value
        slot_steps = self._spec_slot_steps.value
        return {
            "spec": self.spec,
            "spec_steps": self._spec_steps.value,
            "spec_drafted": drafted,
            "spec_accepted": accepted,
            "spec_emitted": self._spec_emitted.value,
            "spec_accept_rate": (accepted / drafted) if drafted else 0.0,
            "tokens_per_step": (self._spec_emitted.value / slot_steps
                                if slot_steps else 0.0),
            "spec_accepted_per_slot": self._spec_accepted.tolist(),
            "spec_drafted_per_slot": self._spec_drafted.tolist(),
            "drafter_errors": self._drafter_errors.value,
        }

    def _arm_slot(self, slot: int, req: Request, row_logits, n: int) -> None:
        """Arm a freshly prefilled slot's rows of the decode carry (device
        writes of one row each). Under spec=K the slot's history starts as
        its prompt and its pending seed is a resumed request's snapshot or
        the argmax of row_logits (one readback: the seed's value is host
        state)."""
        self.logits[slot] = row_logits
        self.pos[slot] = n
        self.active[slot] = True
        self.remaining[slot] = req.gen_len
        self.rids[slot] = req.rid
        self.reqs[slot] = req
        self._admit_seq += 1
        self.admit_tick[slot] = self._admit_seq
        if self.spec:
            rs = req.resume
            self._hist[slot] = _TokenLog(req.ids)
            if rs is not None and rs.t0 is not None:
                self._t0[slot] = int(rs.t0)
            else:
                t0 = time.perf_counter()
                self._t0[slot] = int(torch.argmax(row_logits))
                self.device_wait_s += time.perf_counter() - t0
            self._spec_drafted[slot] = 0
            self._spec_accepted[slot] = 0

    def admit(self, slot: int, req: Request) -> None:
        """Prefill req into `slot` and arm its row of the carry; live
        slots decode on, unaware."""
        assert self.rids[slot] is None, f"slot {slot} is occupied"
        n = len(req.ids)
        if n == 0:
            raise ValueError(f"request {req.rid!r}: empty prompt")
        if n + req.gen_len > self.capacity:
            raise ValueError(f"request {req.rid!r}: prompt {n} + gen {req.gen_len} "
                             f"exceeds slot capacity {self.capacity}")
        row, self.cache = self.engine.prefill_into_slot(self.cache, slot, req.ids)
        self.prefill_forwarded += n
        self._arm_slot(slot, req, row, n)

    def admit_chunked(self, slot: int, req: Request) -> None:
        """Chunked admission (prefill_budget): validate and park the
        request in a PREFILLING slot; no forward runs here. The prompt
        prefills chunk by chunk inside the next mixed ticks, and the slot
        arms when its last chunk lands."""
        assert self.rids[slot] is None, f"slot {slot} is occupied"
        ids = np.asarray(req.ids, np.int32).reshape(-1)
        n = len(ids)
        if n == 0:
            raise ValueError(f"request {req.rid!r}: empty prompt")
        if n + req.gen_len > self.capacity:
            raise ValueError(f"request {req.rid!r}: prompt {n} + gen {req.gen_len} "
                             f"exceeds slot capacity {self.capacity}")
        self._park_prefilling(slot, req, ids, 0)

    def _park_prefilling(self, slot: int, req: Request, ids: np.ndarray,
                         start: int) -> None:
        """Register the PREFILLING state (pos at the first position to
        compute: `start` is the cached-prefix length on the paged path)."""
        self.pos[slot] = start
        self.active[slot] = False
        self.remaining[slot] = 0
        self.rids[slot] = req.rid
        self.reqs[slot] = req
        self._admit_seq += 1
        self.admit_tick[slot] = self._admit_seq
        self._pf_ids[slot] = ids
        self._pf_off[slot] = start

    def emitted(self, slot: int) -> int:
        """Tokens this slot's request has streamed since its ORIGINAL
        admission (a preempted request's earlier span included)."""
        req = self.reqs[slot]
        base = req.resume.emitted if req.resume is not None else 0
        return base + self.emitted_since_admit(slot)

    def emitted_since_admit(self, slot: int) -> int:
        """Tokens streamed since the CURRENT admission (0 while
        prefilling): only a slot that banked at least one token may be
        preempted."""
        if self._pf_ids[slot] is not None:
            return 0
        return self.reqs[slot].gen_len - int(self.remaining[slot])

    def retire(self, slot: int) -> None:
        """Free a slot: mask it out of the scan. Its cache row and carry
        rows stay as dead data until the next admission overwrites them."""
        self.active[slot] = False
        self.remaining[slot] = 0
        self.rids[slot] = None
        self.reqs[slot] = None
        self._pf_ids[slot] = None
        self._pf_off[slot] = 0
        if self.spec:
            self._hist[slot] = _TokenLog()

    def _fetch(self, toks: torch.Tensor, load=None) -> np.ndarray:
        """The one blocking readback of a tick, timed into device_wait_s. A
        MoE tick's routing-load vector rides in the same copy (both int32,
        flattened into one tensor)."""
        t0 = time.perf_counter()
        if load is None:
            out = toks.cpu().numpy()
        else:
            flat = torch.cat([toks.reshape(-1), load]).cpu().numpy()
            out, load = flat[:toks.numel()].reshape(tuple(toks.shape)), flat[toks.numel():]
        dt = time.perf_counter() - t0
        self.device_wait_s += dt
        self.device_wait_s_by_kind[self._kind] += dt
        self.tele.device_land()
        if load is not None:
            self._note_moe_load(load)
        return out

    def _dispatch(self, kind: str) -> None:
        """Stamp a tick's dispatch: its device span and the kind its
        readback's wait is charged to."""
        self._kind = kind
        self.tele.mark_dispatch(kind)

    def _note_moe_load(self, load: np.ndarray) -> None:
        """Fold one landed tick's routing-load vector into the MoE metrics."""
        load = load.astype(np.int64)
        counts, dropped = load[:-1], int(load[-1])
        for e in np.nonzero(counts)[0]:
            self._c_expert[int(e)].inc(int(counts[e]))
        if dropped:
            self._c_moe_drops.inc(dropped)
        self._moe_tokens_cum += counts
        mean = self._moe_tokens_cum.mean()
        self._g_moe_imb.set(float(self._moe_tokens_cum.max() / mean) if mean > 0 else 0.0)

    def _run_chunk(self, chunk: int):
        """Engine-call hook: dispatch one chunk of the slot scan (the paged
        subclass swaps in paged_slot_chunk). Returns the tick's tokens
        [B, chunk] and, for a MoE model, its routing-load vector (else
        None), still on the device."""
        return self._keep_carry(self.engine.slot_chunk(
            self.logits, self.cache, self.pos, self.active, chunk=chunk))

    def _keep_carry(self, out: tuple):
        """Keep a slot chunk's carry; return (tokens, load or None)."""
        toks, self.logits, self.cache, self.pos = out[:4]
        return toks, (out[4] if len(out) > 4 else None)

    def _record(self, slot: int, toks) -> None:
        """Hook: paged slots record kept tokens for the retire-time tree
        insert; contiguous slots keep nothing."""

    def step_chunk(self, chunk: int) -> Tuple[Dict[int, np.ndarray],
                                              List[Tuple[int, object]]]:
        """Run one `chunk`-step slot scan. Returns ({slot: kept tokens,
        trimmed to the slot's remaining budget}, [(slot, rid) of requests
        that just finished]). Finished slots are NOT retired here: the
        caller streams their tail first, then retires. Under spec=K one
        call is one draft-then-verify iteration instead (1..K+1 tokens per
        slot)."""
        if self.spec:
            return self._step_spec()
        self._dispatch("sp_combine" if getattr(self.engine, "sp_size", 1) > 1 else "chunk")
        toks = self._fetch(*self._run_chunk(chunk))
        out: Dict[int, np.ndarray] = {}
        finished: List[Tuple[int, object]] = []
        for b in self.decode_slots:
            keep = int(min(self.remaining[b], chunk))
            if keep:
                out[b] = toks[b, :keep]
                self._record(b, out[b])
                self.remaining[b] -= keep
            if self.remaining[b] == 0:
                finished.append((b, self.rids[b]))
        return out, finished

    # ------------------------------------------------------------------
    # speculative decoding (spec=K)
    # ------------------------------------------------------------------

    def _run_verify(self, tokens, q_lens):
        """Engine-call hook: one verify forward (the paged subclass swaps
        in paged_slot_verify_chunk). Returns the stacked [n_emit; t0_next]
        [2, B] and the routing load (or None), on the device."""
        out = self.engine.slot_verify_chunk(self.cache, self.pos, self.active, tokens,
                                            q_lens)
        return self._keep_verify(out)

    def _keep_verify(self, out: tuple):
        n_emit, t0n, self.cache, self.pos = out[:4]
        return torch.stack([n_emit, t0n]), (out[4] if len(out) > 4 else None)

    def _draft_into(self, tokens: np.ndarray, q_lens: np.ndarray, b: int) -> None:
        """Fill row b of a verify window: the slot's pending seed at
        column 0 plus up to `spec` drafter proposals (capped at remaining -
        1, so a slot never writes past its budget)."""
        tokens[b, 0] = self._t0[b]
        kmax = min(self.spec, int(self.remaining[b]) - 1)
        d: List[int] = []
        if kmax > 0:
            # the drafter sees the history plus the pending seed (appended,
            # then undone: a zero-copy view, no per-step rebuild)
            h = self._hist[b]
            h.append(int(self._t0[b]))
            try:
                d = [int(t) for t in self.drafter.propose(h.view(), kmax)][:kmax]
                if any(not 0 <= t < self._vocab for t in d):
                    raise ValueError(f"draft token out of vocab range [0, {self._vocab})")
            except Exception:
                # a broken drafter degrades to plain decode for this window
                self._drafter_errors.inc()
                d = []
            finally:
                h.pop()
        tokens[b, 1:1 + len(d)] = d
        q_lens[b] = 1 + len(d)

    def _account_spec(self, b: int, tokens, q_lens, n_emit, t0n,
                      out: Dict[int, np.ndarray],
                      finished: List[Tuple[int, object]]) -> None:
        """Post-verify bookkeeping of one decode slot: trim the accepted
        window to the remaining budget, thread the counters and the
        history, stage the next seed."""
        keep = int(min(self.remaining[b], n_emit[b]))
        if keep:
            kept = tokens[b, :keep].copy()
            out[b] = kept
            self.remaining[b] -= keep
            self._hist[b].extend(kept)
            self._record(b, kept)
            self._spec_slot_steps.inc()
            self._spec_emitted.inc(keep)
            self._spec_drafted[b] += int(q_lens[b]) - 1
            self._spec_accepted[b] += keep - 1
            self._spec_drafted_total.inc(int(q_lens[b]) - 1)
            self._spec_accepted_total.inc(keep - 1)
            self._t0[b] = int(t0n[b])
        if self.remaining[b] == 0:
            finished.append((b, self.rids[b]))

    def _step_spec(self) -> Tuple[Dict[int, np.ndarray], List[Tuple[int, object]]]:
        """One draft-then-verify iteration: draft every decode slot's
        window, run one verify forward, keep each slot's seed plus its
        accepted draft prefix."""
        S = self.spec + 1
        tokens = np.zeros((self.batch, S), np.int32)
        q_lens = np.ones((self.batch,), np.int32)
        with self.tele.phase("drafter"):
            for b in self.decode_slots:
                self._draft_into(tokens, q_lens, b)
        self._dispatch("verify")
        n_emit, t0n = self._fetch(*self._run_verify(tokens, q_lens))
        self._spec_steps.inc()
        out: Dict[int, np.ndarray] = {}
        finished: List[Tuple[int, object]] = []
        for b in self.decode_slots:
            self._account_spec(b, tokens, q_lens, n_emit, t0n, out, finished)
        return out, finished

    # ------------------------------------------------------------------
    # chunked prefill: the mixed prefill+decode tick
    # ------------------------------------------------------------------

    def _run_mixed(self, tokens, q_lens, pf):
        """Engine hook: one non-spec mixed tick (the paged subclass swaps
        in paged_slot_mixed_chunk). The carry logits become each row's
        last-valid-position logits (a decode row's next carry, a final
        chunk's arming logits). Returns the tokens [B] and the routing
        load (or None), on the device."""
        return self._keep_mixed(self.engine.slot_mixed_chunk(
            self.logits, self.cache, self.pos, self.active, pf, tokens, q_lens))

    def _keep_mixed(self, out: tuple):
        toks, self.logits, self.cache, self.pos = out[:4]
        return toks, (out[4] if len(out) > 4 else None)

    def _run_mixed_verify(self, tokens, q_lens, pf):
        """Engine hook: one spec-mode mixed tick; the arming logits
        replace the carry. Returns the stacked [n_emit; t0_next] and the
        routing load (or None), on the device."""
        return self._keep_mixed_verify(self.engine.slot_mixed_verify_chunk(
            self.cache, self.pos, self.active, pf, tokens, q_lens))

    def _keep_mixed_verify(self, out: tuple):
        n_emit, t0n, self.logits, self.cache, self.pos = out[:5]
        return torch.stack([n_emit, t0n]), (out[5] if len(out) > 5 else None)

    def _pf_record(self, slot: int, toks) -> None:
        """Hook: paged slots extend the valid-extent token mirror as
        prefill chunks land (a retire or preempt mid-prefill donates only
        tokens whose KV was computed)."""

    def _pf_armed(self, slot: int) -> None:
        """Hook: paged slots insert the fully prefilled prompt into the
        radix tree here (only now is its KV complete)."""

    def step_mixed(self, budget: int) -> Tuple[Dict[int, np.ndarray],
                                               List[Tuple[int, object]]]:
        """One mixed prefill+decode tick: one forward covers every armed
        decode slot (one token, or its verify window under spec) and up to
        `budget` prompt tokens of the in-flight prefills, first admitted
        first. A prefill whose last chunk lands arms, its last-position
        logits as its carry. Same return contract as step_chunk."""
        tokens, q_lens, pf, chunks = self._build_mixed_window(budget)
        decode = self.decode_slots
        out: Dict[int, np.ndarray] = {}
        finished: List[Tuple[int, object]] = []
        if self.spec:
            with self.tele.phase("drafter"):
                for b in decode:
                    self._draft_into(tokens, q_lens, b)
            self._dispatch("mixed_verify")
            n_emit, t0n = self._fetch(*self._run_mixed_verify(tokens, q_lens, pf))
            self._spec_steps.inc()
            for b in decode:
                self._account_spec(b, tokens, q_lens, n_emit, t0n, out, finished)
        else:
            self._dispatch("mixed")
            toks = self._fetch(*self._run_mixed(tokens, q_lens, pf))
            for b in decode:
                if self.remaining[b] > 0:
                    out[b] = toks[b:b + 1].copy()
                    self._record(b, out[b])
                    self.remaining[b] -= 1
                if self.remaining[b] == 0:
                    finished.append((b, self.rids[b]))
        self._advance_prefills(chunks)
        return out, finished

    def _build_mixed_window(self, budget: int):
        """One mixed tick's window: prefill chunks split first admitted
        first under the token budget (q_len 0 = starved this tick). Returns
        (tokens [B, S], q_lens [B], prefilling mask [B], {slot: chunk
        length})."""
        S = max(int(budget), (self.spec + 1) if self.spec else 1)
        tokens = np.zeros((self.batch, S), np.int32)
        q_lens = np.ones((self.batch,), np.int32)
        pf = np.zeros((self.batch,), bool)
        left = int(budget)
        chunks: Dict[int, int] = {}
        for b in sorted(self.prefill_slots, key=lambda b: self.admit_tick[b]):
            ids = self._pf_ids[b]
            off = int(self._pf_off[b])
            c = min(len(ids) - off, left, S)
            pf[b] = True
            q_lens[b] = c
            if c:
                tokens[b, :c] = ids[off:off + c]
                chunks[b] = c
            left -= c
        return tokens, q_lens, pf, chunks

    def _advance_prefills(self, chunks: Dict[int, int]) -> None:
        """Advance the landed chunks' offsets and mirrors; arm the slots
        whose last chunk landed."""
        for b, c in chunks.items():
            self.prefill_forwarded += c
            ids = self._pf_ids[b]
            off = int(self._pf_off[b])
            self._pf_record(b, ids[off:off + c])
            self._pf_off[b] = off + c
            self.tele.req_event(self.rids[b], "prefill_chunk", c)
            if self._pf_off[b] == len(ids):
                req = self.reqs[b]
                self._pf_ids[b] = None
                self._pf_off[b] = 0
                self._arm_slot(b, req, self.logits[b], len(ids))
                self._pf_armed(b)


class PagedDecodeSlots(DecodeSlots):
    """DecodeSlots over the PAGED pool with the shared-prefix radix cache
    (models/prefix_cache.py): admission maps the longest cached prefix
    read-only into the slot's table (refcount +1 each), copy-on-writes
    the partly matched boundary page and prefills only the uncached
    suffix; retirement inserts the finished sequence back into the tree,
    donating the slot's pages. With prefix_cache=False the same programs
    run with a never-matching tree (the cache-off reference).

    margin: the slot scan keeps stepping a finished slot to its chunk
    boundary; those surplus writes land in the slot's own reserved pages
    (or the trash page), so every admission reserves prompt + gen +
    margin - 1 positions. Pass the scheduler's chunk."""

    def __init__(self, engine, batch: int, *, page: int = 16,
                 num_pages: Optional[int] = None, prefix_cache: bool = True,
                 margin: int = 4, spec: int = 0, drafter=None,
                 telemetry: Optional[Telemetry] = None):
        self.page = page
        self.margin = margin
        self._num_pages = num_pages
        super().__init__(engine, batch, spec=spec, drafter=drafter, telemetry=telemetry)
        self.prefix = PrefixCache(self.cache.num_pages,
                                  engine.model.config.num_kv_heads, page,
                                  enabled=prefix_cache, telemetry=self.tele,
                                  shards=self.cache.sp)
        if self.prefix.pool.trash != self.cache.trash:
            raise RuntimeError("the allocator and the pool disagree on the trash page")
        # per slot: mapped page groups (absolute page order) and the token
        # stream (prompt + kept generated) whose KV those pages hold
        self._groups: List[List[np.ndarray]] = [[] for _ in range(batch)]
        self._tokens: List[_TokenLog] = [_TokenLog() for _ in range(batch)]

    def _make_cache(self):
        return self.engine.make_paged_slot_cache(self.batch, page=self.page,
                                                 num_pages=self._num_pages)

    @property
    def capacity(self) -> int:
        """Admittable prompt + gen budget (table capacity minus the
        chunk-surplus margin)."""
        return self.cache.capacity - self.margin + 1

    @property
    def stats(self) -> dict:
        out = self.prefix.stats()
        out.update(super().stats)
        return out

    def validate_admission(self, req: Request, tokens: np.ndarray) -> None:
        """The upfront refusals of a paged admission: an empty prompt,
        prompt + gen beyond the slot capacity, and a footprint beyond the
        whole pool (which no amount of preemption could fit)."""
        n = len(tokens)
        if n == 0:
            raise ValueError(f"request {req.rid!r}: empty prompt")
        if n + req.gen_len > self.capacity:
            raise ValueError(f"request {req.rid!r}: prompt {n} + gen {req.gen_len} "
                             f"exceeds slot capacity {self.capacity}")
        pool = self.prefix.pool
        total = -(-(n + req.gen_len + self.margin - 1) // self.page)
        usable = (pool.num_pages - 1) // pool.n_kv_heads
        if total > usable:
            raise ValueError(
                f"request {req.rid!r}: worst-case footprint {total} page groups "
                f"exceeds the whole pool ({usable} usable groups)")

    def _reserve_pages(self, req: Request, tokens: np.ndarray):
        """Validation + prefix lookup + page reservation. Returns
        (slot_groups, m, rows, cow_src, cow_dst, r, boundary) with every
        ref taken (release `boundary` once the device-side copy-on-write
        ran); raises with everything released."""
        n = len(tokens)
        self.validate_admission(req, tokens)
        pool = self.prefix.pool
        total = -(-(n + req.gen_len + self.margin - 1) // self.page)
        m, shared = self.prefix.lookup(tokens)
        full, r = m // self.page, m % self.page
        retained: List[np.ndarray] = []
        fresh: List[np.ndarray] = []
        try:
            # pin everything the admission will read BEFORE eviction runs
            for g in shared[:full]:
                pool.retain(g)
                retained.append(g)
            boundary = shared[full] if r else None
            if boundary is not None:
                pool.retain(boundary)
                retained.append(boundary)
            need = total - full
            if not self.prefix.ensure_pages(need * pool.n_kv_heads):
                raise PoolExhausted(
                    f"request {req.rid!r}: page pool exhausted ({need} fresh "
                    f"groups needed, {pool.available} pages free, nothing "
                    f"evictable)")
            fresh = [pool.alloc_group() for _ in range(need)]
        except ValueError:
            for g in fresh + retained:
                pool.release(g)
            raise
        slot_groups = list(shared[:full]) + fresh
        Hkv, maxp = pool.n_kv_heads, self.cache.max_pages
        rows = np.full((Hkv, maxp), self.cache.trash, np.int32)
        for j, g in enumerate(slot_groups):
            rows[:, j] = g
        trash_vec = np.full((Hkv,), self.cache.trash, np.int32)
        cow_src = boundary if r else trash_vec
        cow_dst = fresh[0] if r else trash_vec
        return slot_groups, m, rows, cow_src, cow_dst, r, boundary

    def admit(self, slot: int, req: Request) -> None:
        """Consult the radix tree, map the cached prefix read-only,
        allocate fresh writable pages for the rest (evicting LRU tree
        leaves under pressure), and prefill the uncached suffix."""
        assert self.rids[slot] is None, f"slot {slot} is occupied"
        tokens = np.asarray(req.ids, np.int32).reshape(-1)
        n = len(tokens)
        slot_groups, m, rows, cow_src, cow_dst, r, boundary = \
            self._reserve_pages(req, tokens)
        row, self.cache = self.engine.admit_slot_paged(
            self.cache, slot, tokens, rows, m, cow_src, cow_dst, r)
        if boundary is not None:
            # only the copy-on-write read it; the slot maps its own copy
            self.prefix.pool.release(boundary)
        self.prefill_forwarded += n - m
        self._arm_slot(slot, req, row, n)
        self._groups[slot] = slot_groups
        self._tokens[slot] = _TokenLog(tokens)
        self.prefix.record(n, m)
        # insert the PROMPT pages now, not only at retire: the next
        # admission, even in the same poll, can share them
        self.prefix.insert(tokens, slot_groups[:-(-n // self.page)])

    def admit_chunked(self, slot: int, req: Request) -> None:
        """Chunked paged admission: the prefix lookup, page reservation,
        table install and boundary-page copy-on-write
        (Engine.install_slot_paged) run now; the uncached suffix is left to
        the mixed ticks. The token mirror starts at the cached extent and
        grows as chunks land, so a retire, preempt or cancel mid-prefill
        donates only computed KV; the prompt joins the radix tree when the
        slot arms (_pf_armed), since until then its fresh pages hold
        garbage."""
        assert self.rids[slot] is None, f"slot {slot} is occupied"
        tokens = np.asarray(req.ids, np.int32).reshape(-1)
        n = len(tokens)
        slot_groups, m, rows, cow_src, cow_dst, r, boundary = \
            self._reserve_pages(req, tokens)
        self.cache = self.engine.install_slot_paged(self.cache, slot, rows, cow_src,
                                                    cow_dst, r)
        if boundary is not None:
            self.prefix.pool.release(boundary)
        self._groups[slot] = slot_groups
        self._tokens[slot] = _TokenLog(tokens[:m])
        self.prefix.record(n, m)
        self._park_prefilling(slot, req, tokens, m)

    def preempt(self, slot: int) -> Request:
        """Evict a LIVE slot under pool pressure and return the request to
        re-queue: prompt + kept generated tokens become its prompt (their
        KV goes into the radix tree through retire), gen_len drops to the
        remaining budget, and ResumeState keeps the emitted count and,
        under spec, the pending seed. A slot preempted mid-prefill
        re-queues its request unchanged (nothing was emitted); its computed
        extent still goes into the tree through retire."""
        req = self.reqs[slot]
        assert req is not None, f"slot {slot} is empty"
        if self._pf_ids[slot] is not None:
            self.retire(slot)
            return dataclasses.replace(req, resume=req.resume or ResumeState())
        toks = self._tokens[slot].view()   # retire() replaces the log
        remaining = int(self.remaining[slot])
        snap = ResumeState(emitted=self.emitted(slot),
                           t0=int(self._t0[slot]) if self.spec else None)
        self.retire(slot)
        return dataclasses.replace(req, ids=toks, gen_len=remaining, resume=snap)

    def retire(self, slot: int) -> None:
        """Insert the finished sequence into the tree (its pages already
        hold the KV), release the slot's page refs, and point its table
        rows at the trash page so the masked rows, which keep stepping,
        can never write into a page the allocator hands to someone
        else."""
        if len(self._tokens[slot]):
            npg = -(-len(self._tokens[slot]) // self.page)
            self.prefix.insert(self._tokens[slot].view(), self._groups[slot][:npg])
        for g in self._groups[slot]:
            self.prefix.pool.release(g)
        self.cache = self.engine.retire_slot_paged(self.cache, slot)
        self._groups[slot] = []
        self._tokens[slot] = _TokenLog()
        super().retire(slot)

    def _run_chunk(self, chunk: int):
        return self._keep_carry(self.engine.paged_slot_chunk(
            self.logits, self.cache, self.pos, self.active, chunk=chunk))

    def _run_verify(self, tokens, q_lens):
        return self._keep_verify(self.engine.paged_slot_verify_chunk(
            self.cache, self.pos, self.active, tokens, q_lens))

    def _run_mixed(self, tokens, q_lens, pf):
        return self._keep_mixed(self.engine.paged_slot_mixed_chunk(
            self.logits, self.cache, self.pos, self.active, pf, tokens, q_lens))

    def _run_mixed_verify(self, tokens, q_lens, pf):
        return self._keep_mixed_verify(self.engine.paged_slot_mixed_verify_chunk(
            self.cache, self.pos, self.active, pf, tokens, q_lens))

    def _record(self, slot: int, toks) -> None:
        self._tokens[slot].extend(toks)

    def _pf_record(self, slot: int, toks) -> None:
        # a landed chunk's KV is in the slot's pages: retire may donate it
        self._tokens[slot].extend(toks)

    def _pf_armed(self, slot: int) -> None:
        n = len(self._tokens[slot])
        self.prefix.insert(self._tokens[slot].view(), self._groups[slot][:-(-n // self.page)])


class ContinuousScheduler:
    """Admit-from-queue / step_chunk / retire loop over DecodeSlots
    (iteration-level scheduling). Callers may submit from any thread;
    one polling thread calls poll() (or run()) and owns every device
    dispatch."""

    def __init__(self, engine, *, batch: int, chunk: int = 4, paged: bool = False,
                 prefix_cache: bool = True, page: int = 16,
                 num_pages: Optional[int] = None, spec: int = 0, drafter=None,
                 max_queue: Optional[int] = None, watchdog_s: Optional[float] = None,
                 fault=None, prefill_budget: Optional[int] = None,
                 host_pool_pages: int = 0, overlap: bool = False, trace: bool = False,
                 slo_classes: Optional[dict] = None):
        """paged=True serves over the paged pool with the shared-prefix
        radix cache (prefix_cache=False: the same pool, never shared);
        num_pages sizes the pool (default: every slot full, no sharing
        needed). spec=K > 0: speculative decoding, each poll's decode step
        one draft-then-verify iteration of up to K drafts (`drafter`,
        default models/spec_decode.py NgramDrafter). prefill_budget=N:
        chunked prefill, at most N prompt tokens forwarded per poll, fused
        with the live decode step. max_queue bounds the waiting line
        (submit() returns False on overflow). trace=True records the
        poll-loop timeline (dump_trace). The other knobs belong to features
        not ported yet and raise NotImplementedError unless left at their
        defaults."""
        if prefill_budget is not None and prefill_budget < 1:
            raise ValueError(f"prefill_budget must be >= 1, got {prefill_budget}")
        for what, on in (("watchdog_s (the hang watchdog)", watchdog_s is not None),
                         ("fault (chaos injection)", fault is not None),
                         ("host_pool_pages > 0 (the host KV tier)", host_pool_pages),
                         ("overlap=True (overlap scheduling)", overlap),
                         ("slo_classes (SLO classes)", slo_classes is not None)):
            if on:
                raise _not_ported(what)
        if engine.backend == "mega" and not paged:
            raise ValueError(
                "backend='mega' fuses the PAGED decode tick only "
                "(engine.paged_slot_chunk); construct ContinuousScheduler(paged=True), "
                "or serve contiguous slots on a per-op backend such as 'flash'")
        self.tele = Telemetry(trace=trace)
        if paged:
            self.slots = PagedDecodeSlots(engine, batch, page=page,
                                          num_pages=num_pages,
                                          prefix_cache=prefix_cache, margin=chunk,
                                          spec=spec, drafter=drafter,
                                          telemetry=self.tele)
        else:
            self.slots = DecodeSlots(engine, batch, spec=spec, drafter=drafter,
                                     telemetry=self.tele)
        self.chunk = chunk
        self.prefill_budget = prefill_budget
        self.max_queue = max_queue
        # the most prefill tokens one poll pushed through a forward while
        # live streams waited on it (the longest prompt suffix admitted;
        # at most prefill_budget under chunked admissions)
        self.max_prefill_tokens_per_poll = 0
        self._queue: deque = deque()
        # guards _queue against cross-thread submit()/cancel() racing the
        # polling thread's poll()
        self._lock = threading.RLock()
        # rid -> reason for requests the slots refused
        self.rejected: Dict[object, str] = {}
        reg = self.tele.registry
        self._c_preemptions = reg.counter("preemptions", "KV-pressure slot preemptions")
        self._c_busy_rejections = reg.counter("busy_rejections",
                                              "submits refused at max_queue")
        self._g_host_ms = reg.gauge("host_ms_per_poll", "dispatch-to-dispatch host "
                                                        "time minus device wait (EMA)")
        # 1 when the paged decode ticks run the fused megakernel program
        reg.gauge("mega_enabled", "1 = decode ticks run the fused megakernel "
                                  "program").set(
            1.0 if engine.backend == "mega" else 0.0)
        # the sp mesh size the paged pool's page ids split over (1: none)
        self.sp_size = int(getattr(engine, "sp_size", 1))
        reg.gauge("sp_size", "sp mesh size the paged pool shards over").set(self.sp_size)
        self._c_tokens = reg.counter("tokens_emitted",
                                     "tokens delivered to client streams")
        self._host_ms_ema: Optional[float] = None
        self._last_mark: Optional[Tuple[float, float]] = None
        # dispatch-to-dispatch wall time while slots were occupied: the
        # time base of serving_tok_per_s_aggregate
        self._busy_s = 0.0

    @property
    def preemptions(self) -> int:
        return self._c_preemptions.value

    @property
    def busy_rejections(self) -> int:
        return self._c_busy_rejections.value

    def dump_trace(self, path: str) -> None:
        """Write the telemetry export (poll timeline, request traces,
        metrics) as perfetto-loadable JSON."""
        self.tele.dump(path)

    def submit(self, req: Request) -> bool:
        """Enqueue a request. Returns False, without queueing, when the
        waiting line is at max_queue. Thread-safe."""
        for what, on in (("Request.deadline_ms (deadlines)", req.deadline_ms is not None),
                         ("Request.slo (SLO classes)", req.slo is not None),
                         ("Request.n > 1 (parallel sampling)", req.n != 1),
                         ("Request.grammar (grammar-constrained decoding)",
                          req.grammar is not None)):
            if on:
                raise _not_ported(what)
        with self._lock:
            if self.max_queue is not None and len(self._queue) >= self.max_queue:
                self._c_busy_rejections.inc()
                return False
            self.tele.queued(req.rid)
            self._queue.append(req)
        return True

    def cancel(self, rid) -> bool:
        """Drop a request mid-flight: a queued one is removed; an
        in-flight one retires now (a paged retire still inserts its valid
        tokens into the prefix tree). An in-flight cancel mutates the
        decode carry, so it runs on the polling thread. Returns False for
        an unknown or finished rid."""
        with self._lock:
            for i, r in enumerate(self._queue):
                if r.rid == rid:
                    del self._queue[i]
                    self.tele.retire(rid, "cancelled")
                    return True
        for b in self.slots.occupied:
            if self.slots.rids[b] == rid:
                self.slots.retire(b)
                self.tele.retire(rid, "cancelled")
                return True
        return False

    def stats(self) -> dict:
        """Serving counters as one deep, single-point-in-time snapshot of
        the metrics registry (the live latency histograms as {count, sum,
        mean, p50, p95, p99} dicts), the prefix cache's hit and skip
        counters on the paged path, and derived rates."""
        reg = self.tele.registry
        with self._lock, reg.lock:
            reg.gauge("queue_depth").set(len(self._queue))
            reg.gauge("prefill_tokens_forwarded").set(self.slots.prefill_forwarded)
            reg.gauge("max_prefill_tokens_per_poll").set(
                self.max_prefill_tokens_per_poll)
            reg.gauge("prefills_in_progress").set(len(self.slots.prefill_slots))
            reg.gauge("device_wait_s").set(self.slots.device_wait_s)
            for kind, w in self.slots.device_wait_s_by_kind.items():
                reg.gauge("device_wait_kind_s", "device wait by tick kind",
                          labels={"kind": kind}).set(w)
            agg = self._c_tokens.value / self._busy_s if self._busy_s > 0 else 0.0
            reg.gauge("serving_tok_per_s_aggregate",
                      "tokens/s while serving").set(round(agg, 3))
            slots_stats = self.slots.stats
            out = reg.snapshot()
            out.update(slots_stats)
            out.update({
                "tokens_emitted": self._c_tokens.value,
                "serving_tok_per_s_aggregate": round(agg, 3),
                "queue_depth": len(self._queue),
                "preemptions": self._c_preemptions.value,
                "busy_rejections": self._c_busy_rejections.value,
                "prefill_budget": self.prefill_budget,
                "prefill_tokens_forwarded": self.slots.prefill_forwarded,
                "max_prefill_tokens_per_poll": self.max_prefill_tokens_per_poll,
                "prefills_in_progress": len(self.slots.prefill_slots),
                "host_ms_per_poll": (0.0 if self._host_ms_ema is None
                                     else round(self._host_ms_ema, 3)),
                "device_wait_s": round(self.slots.device_wait_s, 4),
                "device_wait_s_by_kind": dict(self.slots.device_wait_s_by_kind),
                "sp_size": self.sp_size,
            })
        return out

    def _mark_dispatch(self) -> None:
        """Stamp a tick dispatch: host_ms_per_poll is the time since the
        previous stamp minus the device wait accrued in between."""
        now = time.monotonic()
        wait = self.slots.device_wait_s
        if self._last_mark is not None:
            t0, w0 = self._last_mark
            host_ms = max(0.0, ((now - t0) - (wait - w0)) * 1e3)
            self._host_ms_ema = host_ms if self._host_ms_ema is None \
                else 0.8 * self._host_ms_ema + 0.2 * host_ms
            self._g_host_ms.set(self._host_ms_ema)
            self._busy_s += now - t0
        self._last_mark = (now, wait)

    @property
    def idle(self) -> bool:
        return not self._queue and not self.slots.occupied

    def _reject(self, rid, reason: str) -> None:
        print(f"[scheduler] rejected request {rid!r}: {reason}", file=sys.stderr)
        self.rejected[rid] = reason
        while len(self.rejected) > 1024:
            self.rejected.pop(next(iter(self.rejected)))   # oldest first
        self.tele.retire(rid, "rejected")

    def _eligible_victims(self) -> List[int]:
        """Slots that may be preempted: they emitted at least one token
        since their current admission, so displacement banks progress."""
        return [b for b in self.slots.occupied if self.slots.emitted_since_admit(b) > 0]

    def _pick_victim(self, candidates: List[int]) -> int:
        """Fewest generated tokens first (least recompute thrown away),
        ties to the most recently admitted."""
        slots = self.slots
        return min(candidates,
                   key=lambda b: (slots.emitted(b), -int(slots.admit_tick[b])))

    def _preempt_for(self, rid, preempted_now: set, reason: str, *, drop) -> bool:
        """The preempt-or-wait ladder of one PoolExhausted admission.
        False = stop admitting this poll; True = retry (a victim was
        freed, or no slot is occupied and the request was rejected
        through `drop(reason)`)."""
        if not self.slots.occupied:
            drop(reason)
            return True
        if rid in preempted_now:
            return False
        victims = self._eligible_victims()
        if not victims:
            # residents without banked progress: wait a poll
            return False
        victim = self.slots.preempt(self._pick_victim(victims))
        self._c_preemptions.inc()
        self.tele.req_event(victim.rid, "preempt")
        self.tele.instant("preempt", str(victim.rid))
        preempted_now.add(victim.rid)
        # behind the request it was evicted for, so the two do not
        # ping-pong the slot
        self._queue.insert(min(1, len(self._queue)), victim)
        return True

    def _admit(self, done: List[object]) -> None:
        """Refill free slots from the waiting line. A PoolExhausted
        admission preempts an eligible victim and retries; hard rejection
        remains only for requests that can never fit. A request preempted
        within this poll that fails re-admission waits for the next
        chunk instead of thrashing the slots it just lost."""
        preempted_now: set = set()
        while self._queue:
            free = self.slots.free
            if not free:
                return
            req = self._queue[0]
            try:
                if self.prefill_budget is not None:
                    self.slots.admit_chunked(free[0], req)
                else:
                    self.slots.admit(free[0], req)
                self._queue.popleft()
                self.tele.req_event(req.rid, "resume" if req.resume is not None
                                    else "admitted", free[0])
            except PoolExhausted as e:
                def _drop(reason, req=req):
                    self._queue.popleft()
                    self._reject(req.rid, reason)
                    done.append(req.rid)

                if not self._preempt_for(req.rid, preempted_now, str(e), drop=_drop):
                    return
            except ValueError as e:
                self._queue.popleft()
                self._reject(req.rid, str(e))
                done.append(req.rid)

    def poll(self) -> Tuple[Dict[object, np.ndarray], List[object]]:
        """One scheduling iteration: refill free slots from the queue
        (preempting under pool pressure), run one decode chunk (a verify
        iteration under spec; one mixed tick while chunked prefills are in
        flight), retire what finished. Returns ({rid: new tokens}, [rids done this poll:
        finished or rejected, the latter with a reason in
        self.rejected]). A preempted request is in neither: it re-queues
        and its rid keeps streaming on resume."""
        with self.tele.poll_span():
            return self._poll_sync()

    def _poll_sync(self) -> Tuple[Dict[object, np.ndarray], List[object]]:
        done: List[object] = []
        pf_before = self.slots.prefill_forwarded
        with self._lock, self.tele.phase("bookkeep"):
            self._admit(done)
        if not self.slots.occupied:
            # idle poll: drop the stamp so the gap is not charged as host
            # time at the next burst's first dispatch
            self._last_mark = None
            self.max_prefill_tokens_per_poll = max(
                self.max_prefill_tokens_per_poll, self.slots.prefill_forwarded - pf_before)
            return {}, done
        self._mark_dispatch()
        with self.tele.phase("step"):
            # prefills in flight: ONE mixed tick fusing the decode step with
            # budgeted prompt chunks; otherwise the plain slot scan
            if self.slots.prefill_slots:
                by_slot, finished = self.slots.step_mixed(self.prefill_budget)
            else:
                by_slot, finished = self.slots.step_chunk(self.chunk)
        self.max_prefill_tokens_per_poll = max(
            self.max_prefill_tokens_per_poll, self.slots.prefill_forwarded - pf_before)
        rid_of = self.slots.rids
        out = {rid_of[b]: t for b, t in by_slot.items()}
        for rid, toks in out.items():
            if len(toks):
                self.tele.emit(rid, len(toks))
                self._c_tokens.inc(len(toks))
        with self.tele.phase("retire"):
            for b, rid in finished:
                self.slots.retire(b)
                self.tele.retire(rid)
                done.append(rid)
        return out, done

    def run(self, requests) -> Dict[object, np.ndarray]:
        """Drive a batch of requests to completion (the test and bench
        loop; a server calls poll() itself). Returns {rid: tokens}."""
        for r in requests:
            if not self.submit(r):
                raise RuntimeError(f"queue full (max_queue={self.max_queue}); run() "
                                   "has no retry loop")
        acc: Dict[object, list] = {r.rid: [] for r in requests}
        while not self.idle:
            out, _ = self.poll()
            for rid, toks in out.items():
                acc[rid].extend(toks.tolist())
        return {rid: np.asarray(t, np.int64) for rid, t in acc.items()}
