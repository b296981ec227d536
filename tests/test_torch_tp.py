"""The port's tensor-parallel decode and paged serving (a mesh of four CPU
ranks, triton_dist_tpu_torch.runtime.make_mesh) against the JAX package at
tp=4, on tiny_qwen3(4) in f32.

- Weights carried from a JAX model built over four devices: its w_qkv and
  w_gate_up are packed as four per-rank blocks, and the converter unpacks
  them (`jax_tp=4`); the JAX random_init draws the same values on any
  mesh, so they equal a one-device JAX model's, and the port's shards are
  the JAX blocks.
- Engine over the four-rank mesh on "xla", "flash", "ar", "gemm_ar" and
  "dist" against the JAX "xla" engine at tp=4: the prefill logits and
  every teacher-forced decode step's within the tolerance, and each token
  by the margin rule. The JAX "ar"/"gemm_ar"/"dist" engines run in Pallas
  interpret mode at 8-30x the "xla" time, so the JAX side is "xla" here
  and the slow arms run the JAX "gemm_ar" scheduler and "dist" engine.
- "dist" where B*S does not divide by 4 (its rows padded with zero rows
  to a multiple of 4): equal to the port's own "xla" engine at tp=4, the
  padding in no cache position.
- The port at tp=4 against the port at tp=1 from the same seed ("dist"
  with int8 weights too).
- The paged ContinuousScheduler at tp=4 ("gemm_ar", "ar", "dist")
  against the JAX "xla" scheduler at tp=4, by the margin rule, and
  comm_kernel_dispatches > 0 on the comm backends, 0 on the others.
- The card checks' stream gate (tools/checks.py `tf_gate`) passes the
  tp=4 served streams against the one-rank plain engine and fails a
  stream with one token changed where the margin is sure.
- Refusals: a kv-head count the mesh does not divide, and the backends,
  forms and models that stay at one rank ("mega"'s TP paged pool).
"""

import dataclasses

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
from triton_dist_tpu_torch.models import (AutoLLM, ContinuousScheduler, DenseLLM, Engine,
                                          KVCache, PagedSlotCache, Request, tiny_qwen3,
                                          tiny_qwen3_moe)
from triton_dist_tpu_torch.models.convert import from_jax_arrays
from triton_dist_tpu_torch.runtime import make_mesh
from test_torch_engine import _jax_arrays

N = 4
MAX_SEQ, BATCH, CHUNK, PAGE, STEPS = 48, 3, 4, 8, 4
IDS = np.random.RandomState(7).randint(0, 256, (2, 6)).astype(np.int32)


def _jmesh(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} JAX devices")
    return jax.make_mesh((n,), ("tp",), axis_types=(AxisType.Auto,), devices=jax.devices()[:n])


def _mesh():
    return make_mesh(N, devices=["cpu"] * N)


def _requests(cls):
    """Three requests, two sharing an 11-token prefix (the prefix cache
    maps it), budgets 5-7."""
    rng = np.random.RandomState(5)
    head = rng.randint(0, 256, 11)
    out = []
    for i, (shared, tail, gen) in enumerate([(True, 4, 6), (False, 9, 5), (True, 6, 7)]):
        ids = rng.randint(0, 256, tail)
        if shared:
            ids = np.concatenate([head, ids])
        out.append(cls(rid=i, ids=ids.astype(np.int32), gen_len=gen))
    return out


@pytest.fixture(scope="module")
def jax_tp4():
    """The JAX model at tp=4 (f32): its parameters, its "xla" engine's
    prefill and teacher-forced decode logits, and its paged scheduler's
    streams."""
    cfg = jax_tiny_qwen3(N, dtype="float32")
    jm = JaxAutoLLM.from_config(cfg, _jmesh(N), seed=0)
    eng = JaxEngine(jm, max_seq=MAX_SEQ, backend="xla")
    logits, cache = eng.prefill(IDS)
    steps = [np.asarray(logits)]
    toks = []
    # jitted: on a CPU the eager sharded forward takes about 25 s a step
    step = jax.jit(lambda m, tk, c: m.forward_tokens(tk, c, mode="xla"))
    for _ in range(STEPS):
        tok = np.asarray(logits).argmax(-1).astype(np.int32)
        toks.append(tok)
        logits, cache = step(jm, jax.numpy.asarray(tok)[:, None], cache)
        steps.append(np.asarray(logits))
    sched = JaxScheduler(eng, batch=BATCH, chunk=CHUNK, paged=True, page=PAGE)
    streams = sched.run(_requests(JaxRequest))
    return dict(arrays=_jax_arrays(jm), logits=steps, toks=toks, streams=streams)


def _tol(logits):
    """f32 on both sides: the same math summed in another order (and, at
    tp=4, the psum's partials in another order)."""
    return 1e-4 * (1 + float(np.abs(logits).max()))


def _port(jax_tp4, mesh=None):
    return from_jax_arrays(tiny_qwen3(N, dtype="float32"), jax_tp4["arrays"], device="cpu",
                           mesh=mesh, jax_tp=N)


def test_weights_carried_from_jax_tp4(jax_tp4):
    jm1 = JaxAutoLLM.from_config(jax_tiny_qwen3(N, dtype="float32"), _jmesh(1), seed=0)
    a1, a4 = _jax_arrays(jm1), jax_tp4["arrays"]
    assert sorted(a1) == sorted(a4)
    m1 = from_jax_arrays(tiny_qwen3(N, dtype="float32"), a1, device="cpu")
    m4 = _port(jax_tp4)                            # unpacked to the one-rank layout
    for l1, l4 in zip(m1.layers, m4.layers):
        assert torch.equal(l1.attn.w_qkv, l4.attn.w_qkv)
        assert torch.equal(l1.mlp.w_gate_up, l4.mlp.w_gate_up)
    split = _port(jax_tp4, _mesh())
    for li, ly in enumerate(split.layers):
        packed = a4[f"layers.{li}.attn.w_qkv"]
        blk = packed.shape[1] // N
        for r, s in enumerate(ly.attn.shards):      # rank r's shard is JAX's block r
            np.testing.assert_array_equal(s.w_qkv.numpy(), packed[:, r * blk:(r + 1) * blk])
            assert (s.n_heads, s.n_kv_heads) == (2 * N // N, N // N)
        gu = a4[f"layers.{li}.mlp.w_gate_up"]
        blk = gu.shape[1] // N
        np.testing.assert_array_equal(ly.mlp.shards[2].w_gate_up.numpy(),
                                      gu[:, 2 * blk:3 * blk])


@pytest.mark.parametrize("backend", ["xla", "flash", "ar", "gemm_ar", "dist"])
def test_engine_tp4_matches_jax_xla(jax_tp4, backend):
    model = _port(jax_tp4, _mesh())
    eng = Engine(model, max_seq=MAX_SEQ, backend=backend, device="cpu")
    logits, cache = eng.prefill(IDS)
    checked = 0
    for t, want in enumerate(jax_tp4["logits"]):
        got = logits.numpy()
        np.testing.assert_allclose(got, want, atol=_tol(want), rtol=0, err_msg=f"step {t}")
        top2 = np.sort(want, -1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 2 * _tol(want)
        assert (got.argmax(-1) == want.argmax(-1))[sure].all()
        checked += int(sure.sum())
        if t < STEPS:
            logits = eng.decode_step(torch.from_numpy(jax_tp4["toks"][t]).long(), cache)
    assert checked >= STEPS
    assert cache.offset == IDS.shape[1] + STEPS and len(cache.parts()) == N


def test_tp4_equals_tp1_same_seed():
    cfg = tiny_qwen3(N, dtype="float32")
    m1 = DenseLLM.random_init(cfg, device="cpu", seed=3)
    m4 = AutoLLM.from_config(cfg, device="cpu", seed=3).to_mesh(_mesh())
    assert torch.equal(torch.cat([s.w_o for s in m4.layers[1].attn.shards]),
                       m1.layers[1].attn.w_o)
    want = Engine(m1, max_seq=MAX_SEQ, backend="xla", device="cpu").serve(IDS, 6)
    for backend in ("flash", "gemm_ar"):
        got = Engine(m4, max_seq=MAX_SEQ, backend=backend, device="cpu").serve(IDS, 6)
        assert torch.equal(got, want), backend
    # int8 weights: the row shards keep the whole weight's column scales
    q1, q4 = m1.quantize_int8(), m4.quantize_int8()
    for s, rows in zip(q4.layers[0].mlp.shards, q1.layers[0].mlp.w_down.q.chunk(N)):
        assert torch.equal(s.w_down.q, rows) and torch.equal(s.w_down.s,
                                                             q1.layers[0].mlp.w_down.s)
    l1, _ = Engine(q1, max_seq=MAX_SEQ, backend="xla", device="cpu").prefill(IDS)
    l4, _ = Engine(q4, max_seq=MAX_SEQ, backend="ar", device="cpu").prefill(IDS)
    np.testing.assert_allclose(l4.numpy(), l1.numpy(), atol=_tol(l1.numpy()), rtol=0)


@pytest.mark.parametrize("backend", ["gemm_ar", "ar", "flash", "xla", "dist"])
def test_paged_scheduler_tp4_matches_jax(jax_tp4, backend):
    model = _port(jax_tp4, _mesh())
    ref = _port(jax_tp4)                           # one rank, teacher forcing
    eng = Engine(model, max_seq=MAX_SEQ, backend=backend, device="cpu")
    got = ContinuousScheduler(eng, batch=BATCH, chunk=CHUNK, paged=True, page=PAGE).run(
        _requests(Request))
    assert (eng.comm_kernel_dispatches > 0) == (backend in ("ar", "gemm_ar", "dist"))
    checked = 0
    for r in _requests(Request):
        w = np.asarray(jax_tp4["streams"][r.rid])
        assert len(got[r.rid]) == len(w) == r.gen_len
        logits, cache = ref.forward_tokens(torch.from_numpy(r.ids).long()[None],
                                           ref.make_cache(1, MAX_SEQ))
        for t in range(r.gen_len):
            lg = logits[0].numpy()
            top2 = np.sort(lg)[-2:]
            if top2[1] - top2[0] <= 2 * _tol(lg):
                break                              # the streams may part here
            assert got[r.rid][t] == w[t] == np.argmax(lg), (r.rid, t)
            checked += 1
            logits, cache = ref.forward_tokens(torch.tensor([[int(w[t])]]), cache)
    assert checked >= 10


def test_dist_padding_tp4_matches_xla():
    """"dist" over four ranks where B*S = 15 and then B = 3 rows do not
    divide by 4: the rows are padded with zero rows, which stay zero and
    reach neither the attention nor the KV cache, so prefill and every
    teacher-forced step equal the port's own "xla" engine at tp=4 within
    the f32 tolerance, and the caches agree (zero past the written
    positions on both)."""
    m4 = DenseLLM.random_init(tiny_qwen3(N, dtype="float32"), seed=5, mesh=_mesh())
    ids = np.random.RandomState(9).randint(0, 256, (3, 5)).astype(np.int32)
    dist = Engine(m4, max_seq=MAX_SEQ, backend="dist", device="cpu")
    xla = Engine(m4, max_seq=MAX_SEQ, backend="xla", device="cpu")
    (ld, cd), (lx, cx) = dist.prefill(ids), xla.prefill(ids)
    for t in range(STEPS + 1):
        np.testing.assert_allclose(ld.numpy(), lx.numpy(), atol=_tol(lx.numpy()), rtol=0,
                                   err_msg=f"step {t}")
        if t < STEPS:
            tok = lx.argmax(-1)
            ld, lx = dist.decode_step(tok, cd), xla.decode_step(tok, cx)
    written = ids.shape[1] + STEPS
    for pd, px in zip(cd.parts(), cx.parts()):
        for a, b in zip(pd.k + pd.v, px.k + px.v):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)
            assert not a[:, :, written:].any()


def test_dist_tp4_equals_tp1_same_seed():
    """"dist" at tp=4 (the rings' plain versions) gives the one-rank "xla"
    engine's tokens from the same seed, and with int8 weights its prefill
    logits within the tolerance (the row shards keep the whole weight's
    column scales)."""
    cfg = tiny_qwen3(N, dtype="float32")
    m1 = DenseLLM.random_init(cfg, device="cpu", seed=3)
    m4 = DenseLLM.random_init(cfg, seed=3, mesh=_mesh())
    want = Engine(m1, max_seq=MAX_SEQ, backend="xla", device="cpu").serve(IDS, 6)
    got = Engine(m4, max_seq=MAX_SEQ, backend="dist", device="cpu").serve(IDS, 6)
    assert torch.equal(got, want)
    q1, q4 = m1.quantize_int8(), m4.quantize_int8()
    l1, _ = Engine(q1, max_seq=MAX_SEQ, backend="xla", device="cpu").prefill(IDS)
    l4, _ = Engine(q4, max_seq=MAX_SEQ, backend="dist", device="cpu").prefill(IDS)
    np.testing.assert_allclose(l4.numpy(), l1.numpy(), atol=_tol(l1.numpy()), rtol=0)


def test_contiguous_scheduler_tp4_equals_serve():
    """Contiguous slots at tp=4 on the comm backends: each stream equals the
    engine's own serve() of that request."""
    m4 = DenseLLM.random_init(tiny_qwen3(N, dtype="float32"), seed=1, mesh=_mesh())
    for backend in ("ar", "gemm_ar"):
        eng = Engine(m4, max_seq=MAX_SEQ, backend=backend, device="cpu")
        got = ContinuousScheduler(eng, batch=2, chunk=CHUNK).run(_requests(Request))
        assert eng.comm_kernel_dispatches > 0
        for r in _requests(Request):
            want = eng.serve(r.ids[None], r.gen_len)[0].numpy()
            np.testing.assert_array_equal(np.asarray(got[r.rid]), want)


def test_tf_gate_holds_tp4_streams():
    from triton_dist_tpu_torch import models
    from triton_dist_tpu_torch.tools import checks
    cfg = tiny_qwen3(N, dtype="float32")
    m1 = DenseLLM.random_init(cfg, device="cpu", seed=2)
    m4 = DenseLLM.random_init(cfg, seed=2, mesh=_mesh())
    served = []
    for backend in ("gemm_ar", "ar"):
        eng = Engine(m4, max_seq=MAX_SEQ, backend=backend, device="cpu")
        got = ContinuousScheduler(eng, batch=BATCH, chunk=CHUNK, paged=True,
                                  page=PAGE).run(_requests(Request))
        served += [(r.ids, got[r.rid]) for r in _requests(Request)]
    forced, n = checks.tf_gate(models, m1, None, served, "tp4", MAX_SEQ)
    assert n == 3 and forced > 0            # both backends served the same streams
    # one token changed at the first step whose margin is sure
    ref = Engine(m1, max_seq=MAX_SEQ, backend="xla", device="cpu")
    p, st = served[0]
    logits, cache = ref.prefill(np.asarray(p)[None])
    for t in range(len(st)):
        top2 = logits.topk(2, dim=-1).values[0]
        if top2[0] - top2[1] > 2 * checks.GATE * logits.abs().max():
            break
        logits = ref.decode_step(torch.tensor([int(st[t])]), cache)
    bad = np.array(st)
    bad[t] = (bad[t] + 1) % cfg.vocab_size
    with pytest.raises(checks.CheckFailed, match=f"step {t} "):
        checks.tf_gate(models, m1, None, [(p, bad)], "tp4 changed", MAX_SEQ)


def test_kv_head_divisibility_refused():
    cfg = dataclasses.replace(tiny_qwen3(N), num_kv_heads=N + 2, num_heads=2 * (N + 2))
    mesh = _mesh()
    with pytest.raises(ValueError, match="divisible"):
        DenseLLM.random_init(cfg, seed=0, mesh=mesh)
    with pytest.raises(ValueError, match="GQA"):
        PagedSlotCache.create(1, 2, 64, N + 2, 32, page=16, num_pages=32, mesh=mesh)
    with pytest.raises(ValueError, match="divisible"):
        KVCache.create(1, 2, 64, N + 2, 32, mesh=mesh)


def test_unported_forms_raise_at_tp4():
    cfg = tiny_qwen3(N, dtype="float32")
    m4 = DenseLLM.random_init(cfg, seed=0, mesh=_mesh())
    # "mega" decodes at tp=4 (tests/test_torch_mega_tp.py); its TP paged
    # pool stays refused, as in the JAX engine
    with pytest.raises(ValueError, match="fuses the paged tick single-chip only"):
        Engine(m4, max_seq=MAX_SEQ, backend="mega", device="cpu").make_paged_slot_cache(2)
    # "ep" runs: a dense model has no experts to split (the JAX gate)
    with pytest.raises(ValueError, match="routed experts"):
        Engine(m4, max_seq=MAX_SEQ, backend="ep", device="cpu")
    for backend in ("gemm_ar", "dist"):
        eng = Engine(m4, max_seq=MAX_SEQ, backend=backend, device="cpu")
        for kw in (dict(spec=2), dict(prefill_budget=8)):
            sched = ContinuousScheduler(eng, batch=2, chunk=CHUNK, paged=True, page=PAGE,
                                        **kw)
            with pytest.raises(NotImplementedError, match="tensor-parallel"):
                sched.run(_requests(Request))
    with pytest.raises(NotImplementedError):
        m4.forward_train(torch.from_numpy(IDS).long())
    # a TP-MoE model splits over the mesh and serves the comm backends; its
    # training and an expert-parallel model on those backends wait
    moe4 = AutoLLM.from_config(tiny_qwen3_moe(N), device="cpu").to_mesh(_mesh())
    with pytest.raises(NotImplementedError):
        moe4.forward_train(torch.from_numpy(IDS).long())
    ep = AutoLLM.from_config(tiny_qwen3_moe(N), device="cpu", mesh=_mesh(), moe_impl="ep")
    for backend in ("gemm_ar", "dist"):
        with pytest.raises(NotImplementedError):
            Engine(ep, max_seq=MAX_SEQ, backend=backend, device="cpu")


@pytest.mark.slow
def test_jax_gemm_ar_scheduler_tp4_matches_port(jax_tp4):
    """The JAX "gemm_ar" paged scheduler at tp=4 (its comm kernels in
    interpret mode, over a minute on a CPU) gives the JAX "xla" streams, and
    the port's "gemm_ar" scheduler at tp=4 gives the same."""
    cfg = jax_tiny_qwen3(N, dtype="float32")
    jm = JaxAutoLLM.from_config(cfg, _jmesh(N), seed=0)
    jeng = JaxEngine(jm, max_seq=MAX_SEQ, backend="gemm_ar")
    want = JaxScheduler(jeng, batch=BATCH, chunk=CHUNK, paged=True, page=PAGE).run(
        _requests(JaxRequest))
    eng = Engine(_port(jax_tp4, _mesh()), max_seq=MAX_SEQ, backend="gemm_ar", device="cpu")
    got = ContinuousScheduler(eng, batch=BATCH, chunk=CHUNK, paged=True, page=PAGE).run(
        _requests(Request))
    for r in _requests(Request):
        np.testing.assert_array_equal(np.asarray(want[r.rid]),
                                      np.asarray(jax_tp4["streams"][r.rid]))
        np.testing.assert_array_equal(np.asarray(got[r.rid]), np.asarray(want[r.rid]))


@pytest.mark.slow
def test_jax_dist_engine_tp4_matches_port(jax_tp4):
    """The JAX "dist" engine at tp=4 (ag_gemm and gemm_rs in interpret mode,
    its prefill through them too; about 45 s on a CPU) serves the JAX "xla"
    engine's tokens, and the port's "dist" engine at tp=4 the same. Four
    rows: the JAX "dist" decode takes B divisible by 4."""
    ids = np.random.RandomState(8).randint(0, 256, (N, 6)).astype(np.int32)
    cfg = jax_tiny_qwen3(N, dtype="float32")
    jm = JaxAutoLLM.from_config(cfg, _jmesh(N), seed=0)
    want = np.asarray(JaxEngine(jm, max_seq=MAX_SEQ, backend="dist").serve(ids, STEPS))
    np.testing.assert_array_equal(
        want, np.asarray(JaxEngine(jm, max_seq=MAX_SEQ, backend="xla").serve(ids, STEPS)))
    got = Engine(_port(jax_tp4, _mesh()), max_seq=MAX_SEQ, backend="dist",
                 device="cpu").serve(ids, STEPS)
    np.testing.assert_array_equal(got.numpy(), want)
