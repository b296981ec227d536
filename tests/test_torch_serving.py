"""The port's continuous-batching serving (triton_dist_tpu_torch.models.
scheduler, prefix_cache, kernels.paged_kv.PageAllocator) against the JAX
package, plus the port's own invariances.

- Host policy: the allocator, refcounts and radix tree are driven by one
  seeded random admit/retire/evict sequence in both packages, which must
  give the same matches, the same page ids and the same evictions.
- ContinuousScheduler, contiguous and paged, on tiny_qwen3 with carried
  weights against the JAX scheduler on its plain ("xla") backend: the
  port's streams are held to the JAX streams under the teacher-forced
  margin rule (the port's model is fed the JAX tokens; wherever its
  top-2 margin exceeds twice the logit tolerance, the port's token must
  be the JAX token), and the prefix-cache counters must be equal.
- Invariances inside the port, bitwise: paged with the prefix cache ==
  paged without it == contiguous slots == Engine.serve per request, and
  preempted (a pool too small for every slot) == not preempted.

The port runs on the CPU (device="cpu"), where its kernel wrappers take
their plain PyTorch versions.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from triton_dist_tpu.models import AutoLLM as JaxAutoLLM
from triton_dist_tpu.models import ContinuousScheduler as JaxScheduler
from triton_dist_tpu.models import Engine as JaxEngine
from triton_dist_tpu.models import Request as JaxRequest
from triton_dist_tpu.models.config import tiny_qwen3 as jax_tiny_qwen3
from triton_dist_tpu.models.prefix_cache import PrefixCache as JaxPrefixCache
from triton_dist_tpu_torch.models import (AutoLLM, ContinuousScheduler, Engine,
                                          Request, tiny_qwen3)
from triton_dist_tpu_torch.models.convert import from_jax_arrays
from triton_dist_tpu_torch.models.prefix_cache import PrefixCache
from test_torch_engine import _jax_arrays

MAX_SEQ, BATCH, CHUNK, PAGE = 48, 3, 4, 8


def _policy_trace(cache_cls):
    """A seeded random admit/retire/evict sequence over the host policy
    (the one of the JAX package's test_refcount_random_admit_retire_evict),
    returning everything the policy decided: matches, page ids handed
    out, pool occupancy and evictions, step by step."""
    rng = np.random.RandomState(0)
    page, Hkv, num_pages, vocab = 4, 2, 40, 6
    pc = cache_cls(num_pages, Hkv, page)
    pool = pc.pool
    live, trace = {}, []
    for step in range(200):
        op = rng.rand()
        if op < 0.5 and len(live) < 4:
            n, gen = int(rng.randint(3, 20)), int(rng.randint(1, 8))
            toks = rng.randint(0, vocab, size=(n,)).astype(np.int32)
            m, shared = pc.lookup(toks)
            full, r = m // page, m % page
            retained = list(shared[:full])
            for g in retained:
                pool.retain(g)
            boundary = shared[full] if r else None
            if boundary is not None:
                pool.retain(boundary)
            need = -(-(n + gen + 3) // page) - full
            trace.append(("match", m, [g.tolist() for g in shared]))
            if not pc.ensure_pages(need * Hkv):
                for g in retained + ([boundary] if r else []):
                    pool.release(g)
                trace.append(("refused", pool.available))
                continue
            fresh = [pool.alloc_group() for _ in range(need)]
            if boundary is not None:
                pool.release(boundary)
            groups = retained + fresh
            toks_full = np.concatenate(
                [toks, rng.randint(0, vocab, size=(gen,))]).astype(np.int32)
            trace.append(("fresh", [g.tolist() for g in fresh],
                          pc.insert(toks, groups[:-(-n // page)])))
            live[step] = (toks_full, groups)
        elif op < 0.85 and live:
            toks_full, groups = live.pop(list(live)[int(rng.randint(len(live)))])
            trace.append(("retire", pc.insert(toks_full,
                                              groups[:-(-len(toks_full) // page)])))
            for g in groups:
                pool.release(g)
        else:
            pc.tree.evict_until(pool.available + int(rng.randint(1, 9)))
        trace.append((pool.available, pool.pages_in_use, pc.tree.evictions))
    return trace


def test_host_policy_matches_jax():
    """Same matches, page ids, occupancy and evictions as the JAX
    allocator, refcounts and radix tree on one seeded sequence (the
    sequence exercises mid-page matches, splits, pool refusals and LRU
    eviction)."""
    want, got = _policy_trace(JaxPrefixCache), _policy_trace(PrefixCache)
    assert got == want
    kinds = {t[0] for t in got if isinstance(t[0], str)}
    assert {"match", "fresh", "retire", "refused"} <= kinds
    assert got[-1][2] > 0                     # evictions happened


def _requests(cls, vocab):
    """Six requests: two share a 19-token system prompt, two a 12-token
    one (matches end mid-page), two stand alone; budgets vary. Prompts
    are 17-24 tokens and cached-prefix suffixes at most 8, so the JAX
    engine compiles one prefill bucket per form."""
    rng = np.random.RandomState(3)
    heads = [rng.randint(0, vocab, 19), rng.randint(0, vocab, 12)]
    out = []
    for i, (h, tail, gen) in enumerate([(0, 3, 7), (1, 6, 9), (0, 5, 5), (None, 20, 8),
                                        (1, 8, 10), (None, 18, 6)]):
        ids = rng.randint(0, vocab, tail)
        if h is not None:
            ids = np.concatenate([heads[h], ids])
        out.append(cls(rid=i, ids=ids.astype(np.int32), gen_len=gen))
    return out


@pytest.fixture(scope="module")
def jax_streams():
    """The JAX scheduler's greedy streams on its plain backend in f32,
    per form, with the prefix-cache counters of the paged run."""
    # Auto axes: on this JAX version make_mesh defaults to Explicit axes,
    # under which the JAX paged admission program fails its sharding
    # check (ROADMAP Queue 3)
    mesh = jax.make_mesh((1,), ("tp",), axis_types=(AxisType.Auto,))
    out = {}
    for dtype in ("float32",):
        jm = JaxAutoLLM.from_config(jax_tiny_qwen3(1, dtype=dtype), mesh, seed=0)
        eng = JaxEngine(jm, max_seq=MAX_SEQ, backend="xla")
        for paged in (False, True):
            sched = JaxScheduler(eng, batch=BATCH, chunk=CHUNK, paged=paged, page=PAGE)
            streams = sched.run(_requests(JaxRequest, 256))
            st = sched.stats()
            out[dtype, paged] = (streams, st.get("hits"), st.get("prefill_tokens_skipped"))
        out[dtype] = _jax_arrays(jm)
    return out


def _tol(logits):
    """f32 on both sides: the same math summed in another order."""
    return 1e-4 * (1 + float(np.abs(logits).max()))


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_scheduler_matches_jax(jax_streams, paged):
    dtype = "float32"
    model = from_jax_arrays(tiny_qwen3(1, dtype=dtype), jax_streams[dtype], device="cpu")
    eng = Engine(model, max_seq=MAX_SEQ, backend="flash", device="cpu")
    sched = ContinuousScheduler(eng, batch=BATCH, chunk=CHUNK, paged=paged, page=PAGE)
    got = sched.run(_requests(Request, 256))
    want, hits, skipped = jax_streams[dtype, paged]
    st = sched.stats()
    assert (st.get("hits"), st.get("prefill_tokens_skipped")) == (hits, skipped)
    if paged:
        assert hits >= 2
    checked = 0
    for r in _requests(Request, 256):
        w = np.asarray(want[r.rid])
        assert len(got[r.rid]) == len(w) == r.gen_len
        # teacher-forced: the port's plain model over prompt + JAX tokens
        logits, cache = model.forward_tokens(torch.from_numpy(r.ids).long()[None],
                                             model.make_cache(1, MAX_SEQ))
        for t in range(r.gen_len):
            lg = logits[0].numpy()
            top2 = np.sort(lg)[-2:]
            if top2[1] - top2[0] <= 2 * _tol(lg):
                break                     # the streams may part here
            assert got[r.rid][t] == w[t] == np.argmax(lg), (r.rid, t)
            checked += 1
            logits, cache = model.forward_tokens(torch.tensor([[int(w[t])]]), cache)
    assert checked >= 20


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_serving_invariances_bitwise(kv):
    """Paged + prefix cache == paged without it == contiguous slots ==
    Engine.serve per request, and a pool too small for every slot at
    once (preemption forced) == an ample pool, token for token."""
    model = AutoLLM.from_config(tiny_qwen3(1, dtype="bfloat16"), device="cpu", seed=0)
    if kv == "int8":
        model = model.quantize_int8()
    kv_dtype = torch.int8 if kv == "int8" else None
    eng = Engine(model, max_seq=MAX_SEQ, backend="flash", kv_dtype=kv_dtype, device="cpu")
    reqs = _requests(Request, 256)
    runs = {}
    for label, kw in (("contiguous", dict(paged=False)),
                      ("paged", dict(paged=True)),
                      ("paged_cache_off", dict(paged=True, prefix_cache=False)),
                      ("paged_small_pool", dict(paged=True, num_pages=1 + 9))):
        sched = ContinuousScheduler(eng, batch=BATCH, chunk=CHUNK, page=PAGE, **kw)
        runs[label] = sched.run(reqs)
        assert not sched.rejected, sched.rejected
        if label == "paged_small_pool":
            assert sched.preemptions > 0
        if kw.get("paged"):
            st = sched.stats()
            # every page back on the free list but the trash page and the
            # radix tree's own
            assert st["pages_outstanding"] == 1 + st["pages_in_use"]
    for r in reqs:
        want = eng.serve(r.ids[None], r.gen_len)[0].numpy()
        for label, streams in runs.items():
            np.testing.assert_array_equal(streams[r.rid], want,
                                          err_msg=f"{label}, rid={r.rid}")



def test_telemetry_histogram_matches_jax():
    """The latency histogram's buckets and quantiles are the JAX
    package's on the same samples (edge values included)."""
    from triton_dist_tpu.runtime.telemetry import Histogram as JaxHistogram
    from triton_dist_tpu_torch.runtime.telemetry import Histogram
    rng = np.random.RandomState(4)
    samples = np.concatenate([rng.lognormal(3, 2, 500), [0.0, -1.0, np.nan, np.inf, 1e9]])
    want, got = JaxHistogram("x"), Histogram("x")
    for v in samples:
        want.record(v)
        got.record(v)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.snapshot() == want.snapshot()


def test_scheduler_queue_cancel_and_trace():
    """max_queue refuses a submit past the bound; cancel drops a queued
    request and retires an in-flight one (its pages back to the pool);
    the other streams are those of an untraced run without cancels, and
    the trace holds the poll loop's spans and the requests' fates."""
    model = AutoLLM.from_config(tiny_qwen3(1), device="cpu", seed=0)
    eng = Engine(model, max_seq=MAX_SEQ, device="cpu")
    reqs = _requests(Request, 256)
    want = ContinuousScheduler(eng, batch=BATCH, chunk=CHUNK, paged=True,
                               page=PAGE).run(reqs)
    sched = ContinuousScheduler(eng, batch=BATCH, chunk=CHUNK, paged=True, page=PAGE,
                                max_queue=5, trace=True)
    assert all(sched.submit(r) for r in reqs[:5]) and not sched.submit(reqs[5])
    assert sched.busy_rejections == 1
    assert sched.cancel(4)                          # queued
    got = {}
    while not sched.idle:
        out, _ = sched.poll()
        for rid, toks in out.items():
            got.setdefault(rid, []).extend(toks.tolist())
        if 1 in got and sched.cancel(1):            # in flight
            cancelled = len(got[1])
    assert 4 not in got and cancelled == len(got[1]) < reqs[1].gen_len
    for rid in (0, 2, 3):
        assert got[rid] == want[rid].tolist()
    st = sched.stats()
    assert st["pages_outstanding"] == 1 + st["pages_in_use"]
    assert st["requests_cancelled"] == 2 and st["requests_retired"] == 3
    trace = sched.tele.export()
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"poll", "bookkeep", "step", "retire", "device:chunk"} <= names
    assert trace["requests"]["0"]["status"] == "retired"
    assert trace["requests"]["1"]["status"] == "cancelled"
