"""The port's MoE slice (kernels.group_gemm, kernels.ep_a2a, layers.TP_MoE,
models.Qwen3MoE, the MoE engine and scheduler paths) against the JAX
package, plus the port's own invariances and capability gates.

Inputs are made with numpy from a seed; the JAX model's weights are
carried into the port by models/convert.py. The JAX functions run on a
one-device mesh with their Pallas kernels (flash-decode, grouped GEMM)
in interpret mode; the port runs on the CPU (device="cpu"), where its
kernel wrappers take their plain PyTorch versions. Everything is f32 but
the grouped GEMM's bf16 case, so both packages route every token to the
same experts, and the model-level tests run dropless
(capacity_factor="dropless"), where a token's output does not depend on
the other tokens of its batch.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from triton_dist_tpu.kernels.ep_a2a import expert_token_counts as jax_expert_token_counts
from triton_dist_tpu.kernels.ep_a2a import group_tokens_by_expert as jax_group_tokens
from triton_dist_tpu.kernels.ep_a2a import route as jax_route
from triton_dist_tpu.kernels.ep_a2a import scatter_weighted as jax_scatter_weighted
from triton_dist_tpu.kernels.group_gemm import grouped_gemm as jax_grouped_gemm
from triton_dist_tpu.layers import TP_MoE as JaxMoE
from triton_dist_tpu.models import AutoLLM as JaxAutoLLM
from triton_dist_tpu.models import ContinuousScheduler as JaxScheduler
from triton_dist_tpu.models import Engine as JaxEngine
from triton_dist_tpu.models import Request as JaxRequest
from triton_dist_tpu.models.config import tiny_qwen3_moe as jax_tiny_qwen3_moe
from triton_dist_tpu.models.kv_cache import PagedSlotCache as JaxPagedSlotCache
from triton_dist_tpu.runtime.telemetry import labeled_name as jax_labeled_name
from triton_dist_tpu_torch.kernels import grouped_gemm, grouped_gemm_ref
from triton_dist_tpu_torch.kernels.ep_a2a import (expert_token_counts,
                                                 group_tokens_by_expert, route,
                                                 scatter_weighted)
from triton_dist_tpu_torch.layers import TP_MoE
from triton_dist_tpu_torch.models import (AutoLLM, ContinuousScheduler, Engine, Qwen3MoE,
                                          Request, tiny_qwen3, tiny_qwen3_moe)
from triton_dist_tpu_torch.models.convert import from_jax_arrays, to_torch
from triton_dist_tpu_torch.models.kv_cache import KVCache, PagedSlotCache
from triton_dist_tpu_torch.runtime.telemetry import labeled_name

B, S, GEN, PAGE = 2, 8, 4, 8
MAX_SEQ = 32
E4 = dict(num_experts=4)          # tiny_qwen3_moe(1, **E4): E=4, k=2, Hq=2, Hkv=1


def _mesh():
    # Auto axes: on this JAX version make_mesh defaults to Explicit axes,
    # under which the JAX paged admission program fails its sharding
    # check (ROADMAP Queue 3)
    return jax.make_mesh((1,), ("tp",), axis_types=(AxisType.Auto,),
                         devices=jax.devices()[:1])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return to_torch(np.asarray(x))


def _close(got, want, rel=1e-5):
    """max|got - want| <= rel * (1 + max|want|): f32 on both sides, the
    same math summed in another order."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    err = np.abs(g - w).max() if g.size else 0.0
    assert err <= rel * (1 + np.abs(w).max()), f"max|d| {err}"


def _jax_moe_arrays(jm):
    """The JAX Qwen3MoE's parameters as the flat numpy dict of
    models/convert.py."""
    arrays = {name: np.asarray(getattr(jm, name))
              for name in ("embed", "final_norm", "lm_head")}
    for i, ly in enumerate(jm.layers):
        for name in ("w_qkv", "w_o", "q_norm", "k_norm"):
            if getattr(ly.attn, name) is not None:
                arrays[f"layers.{i}.attn.{name}"] = np.asarray(getattr(ly.attn, name))
        for name in ("w_router", "w_gate_up", "w_down"):
            arrays[f"layers.{i}.moe.{name}"] = np.asarray(getattr(ly.moe, name))
        arrays[f"layers.{i}.ln_attn"] = np.asarray(ly.ln_attn)
        arrays[f"layers.{i}.ln_mlp"] = np.asarray(ly.ln_mlp)
    return arrays


# ----------------------------------------------------------------------
# kernels: grouped GEMM and the routing helpers
# ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_gemm_ref_matches_jax(dtype):
    """grouped_gemm on the CPU (its plain version) against the JAX Pallas
    grouped_gemm in interpret mode: f32 at 1e-4 (another summation
    order); bf16 within one bf16 ulp of each element (both accumulate in
    f32 and round once, so only a sum that lands within f32 noise of a
    rounding boundary may differ, by one ulp)."""
    rng = np.random.RandomState(0)
    E, C, D, F = 3, 24, 64, 96
    x = jnp.asarray(rng.randn(E, C, D), dtype)
    w = jnp.asarray(rng.randn(E, D, F) * D ** -0.5, dtype)
    with jax.default_matmul_precision("highest"):
        want = _np(jax_grouped_gemm(x, w))
    got = grouped_gemm(_t(x), _t(w))
    assert got.dtype == _t(x).dtype and tuple(got.shape) == (E, C, F)
    assert torch.equal(got, grouped_gemm_ref(_t(x), _t(w)))
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), want, atol=1e-4, rtol=1e-5)
    else:
        mag = np.maximum(np.abs(_np(got)), np.abs(want))
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
        assert (np.abs(_np(got) - want) <= ulp).all()


@pytest.mark.parametrize("cap", [16, 3], ids=["fits", "overflow"])
def test_routing_helpers_match_jax(cap):
    """route, expert_token_counts, group_tokens_by_expert and
    scatter_weighted against JAX: indices and slots equal, grouped rows
    bitwise, weights and the combine at f32 noise (1e-6). cap=3 forces
    capacity overflow (24 entries over 4 experts), so the same entries
    must be dropped."""
    rng = np.random.RandomState(1)
    T, E, k, D = 12, 4, 2, 16
    logits = rng.randn(T, E).astype(np.float32)
    x = rng.randn(T, D).astype(np.float32)
    jw, jidx = jax_route(jnp.asarray(logits), k)
    w, idx = route(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(expert_token_counts(idx, E).numpy(),
                                  np.asarray(jax_expert_token_counts(jidx, E)))
    jx_e, jinv, jtok = jax_group_tokens(jnp.asarray(x), jidx, E, cap)
    x_e, inv, tok = group_tokens_by_expert(torch.from_numpy(x), idx, E, cap)
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(x_e.numpy(), np.asarray(jx_e))
    dropped = int((inv == E * cap).sum())
    assert dropped > 0 if cap == 3 else dropped == 0
    y_e = rng.randn(E, cap, D).astype(np.float32)
    want = jax_scatter_weighted(jnp.asarray(y_e), jinv, jtok, jw, T)
    got = scatter_weighted(torch.from_numpy(y_e), inv, tok, w, T)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cf", [2.0, 0.5, "dropless"])
def test_tp_moe_matches_jax(cf):
    """TP_MoE fwd_local ("flash", grouped GEMMs) and fwd_xla (the dense
    oracle) with their stats against the JAX layer on the same weights
    and tokens, f32 at 1e-5. cf=0.5 drops entries by capacity."""
    rng = np.random.RandomState(2)
    M, D, E, I, k = 48, 64, 8, 32, 2
    ws = [rng.randn(D, E).astype(np.float32),
          (rng.randn(E, D, I) * D ** -0.5).astype(np.float32),
          (rng.randn(E, D, I) * D ** -0.5).astype(np.float32),
          (rng.randn(E, I, D) * I ** -0.5).astype(np.float32)]
    x = rng.randn(M, D).astype(np.float32)
    jm = JaxMoE.init(*ws, mesh=_mesh(), top_k=k, capacity_factor=cf)
    pm = TP_MoE.init(*map(torch.from_numpy, ws), top_k=k, capacity_factor=cf)
    assert pm._cap(M) == jm._cap(M)
    np.testing.assert_array_equal(pm.w_gate_up.numpy(), np.asarray(jm.w_gate_up))
    for mode in ("flash", "xla"):
        jy, jst = jm(jnp.asarray(x), mode, return_stats=True)
        y, st = pm(torch.from_numpy(x), mode, return_stats=True)
        _close(y, jy)
        for key in ("expert_tokens", "dropped"):
            np.testing.assert_array_equal(st[key].numpy(), np.asarray(jst[key]))
        if mode == "flash":
            assert (int(st["dropped"]) > 0) == (cf == 0.5)
    # the plain composition of the port's own pieces equals fwd_local
    xt = torch.from_numpy(x)
    topk_w, topk_idx = route(xt @ pm.w_router, k)
    x_e, inv, tok = group_tokens_by_expert(xt, topk_idx, E, pm._cap(M))
    y_e = pm._expert_mlp_sharded(x_e, gemm=grouped_gemm_ref)[0]
    assert torch.equal(scatter_weighted(y_e, inv, tok, topk_w, M), pm.fwd_local(xt))


# ----------------------------------------------------------------------
# the model and the engine
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def moe_ref():
    """The JAX Qwen3MoE (tiny, E=4, k=2, dropless) on its plain ("xla")
    path, the Pallas kernels' reference (the kernels themselves are held
    to JAX in interpret mode above): Engine prefill, then forward_tokens
    steps fed its own argmax (what the JAX decode scan does), every
    step's logits kept; then one slot forward over the resulting
    contiguous cache and one over a seeded paged pool, with their
    routing loads."""
    mesh = _mesh()
    jm = JaxAutoLLM.from_config(jax_tiny_qwen3_moe(1, **E4), mesh, seed=0,
                                capacity_factor="dropless")
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 256, (B, S)).astype(np.int32)
    logits, cache = JaxEngine(jm, max_seq=MAX_SEQ, backend="xla").prefill(ids)
    step = jax.jit(lambda m, t, c: m.forward_tokens(t, c, mode="xla"))
    logs, toks = [np.asarray(logits)], []
    for _ in range(GEN):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        logits, cache = step(jm, tok[:, None], cache)
        toks.append(np.asarray(tok))
        logs.append(np.asarray(logits))
    out = dict(arrays=_jax_moe_arrays(jm), ids=ids, logits=logs, toks=np.stack(toks, 1),
               cache=[(np.asarray(k), np.asarray(v)) for k, v in zip(cache.k, cache.v)])
    # slot forward: row 0 appends at S + GEN, row 1 rewrites position 3
    tok = rng.randint(0, 256, (B, 1)).astype(np.int32)
    pos = np.array([S + GEN, 3], np.int32)
    lg, c2, load = jax.jit(lambda m, t, c, p: m.forward_tokens_slots(
        t, c, p, mode="xla", return_moe_stats=True))(jm, jnp.asarray(tok), cache,
                                                     jnp.asarray(pos))
    out["slots"] = dict(tok=tok, pos=pos, logits=np.asarray(lg), load=np.asarray(load),
                        cache=[(np.asarray(k), np.asarray(v)) for k, v in zip(c2.k, c2.v)])
    # paged forward: a seeded pool and table, rows at their own positions
    cfg = jm.config
    NP = 1 + B * (MAX_SEQ // PAGE)
    pc = JaxPagedSlotCache.create(cfg.num_layers, B, MAX_SEQ, cfg.num_kv_heads,
                                  cfg.head_dim, page=PAGE, num_pages=NP, mesh=mesh,
                                  dtype=jnp.float32)
    pools = [(rng.randn(NP, 1, PAGE, cfg.head_dim).astype(np.float32),
              rng.randn(NP, 1, PAGE, cfg.head_dim).astype(np.float32))
             for _ in range(cfg.num_layers)]
    table = (1 + rng.permutation(NP - 1)).reshape(B, -1).astype(np.int32)
    pc = JaxPagedSlotCache(pages_k=tuple(jnp.asarray(k) for k, _ in pools),
                           pages_v=tuple(jnp.asarray(v) for _, v in pools),
                           table=jnp.asarray(table))
    ppos = np.array([13, 22], np.int32)
    lg, pc2, load = jax.jit(lambda m, t, c, p: m.forward_tokens_slots_paged(
        t, c, p, mode="xla", return_moe_stats=True))(jm, jnp.asarray(tok), pc,
                                                     jnp.asarray(ppos))
    out["paged"] = dict(pools=pools, table=table, pos=ppos, logits=np.asarray(lg),
                        load=np.asarray(load),
                        out_pools=[(np.asarray(k), np.asarray(v))
                                   for k, v in zip(pc2.pages_k, pc2.pages_v)])
    return out


def _model(r):
    return from_jax_arrays(tiny_qwen3_moe(1, **E4), r["arrays"], device="cpu",
                           capacity_factor="dropless")


def test_forward_tokens_matches_jax(moe_ref):
    """Qwen3MoE.forward_tokens: logits after prefill and after each decode
    step fed the JAX tokens, and the filled cache, f32 at 1e-5."""
    r = moe_ref
    model = _model(r)
    assert isinstance(model, Qwen3MoE)
    cache = model.make_cache(B, MAX_SEQ)
    logits, cache = model.forward_tokens(torch.from_numpy(r["ids"]).long(), cache)
    for t in range(GEN + 1):
        _close(logits, r["logits"][t])
        if t < GEN:
            tok = torch.from_numpy(r["toks"][:, t]).long()[:, None]
            logits, cache = model.forward_tokens(tok, cache)
    assert cache.offset == S + GEN
    for li, (k, v) in enumerate(r["cache"]):
        _close(cache.k[li], k)
        _close(cache.v[li], v)


def test_forward_tokens_slots_matches_jax(moe_ref):
    """forward_tokens_slots (contiguous) and forward_tokens_slots_paged
    with return_moe_stats: logits and the written cache or pool at 1e-5,
    the routing-load vectors equal."""
    r = moe_ref
    model = _model(r)
    s = r["slots"]
    cache = KVCache(k=[_t(k) for k, _ in r["cache"]], v=[_t(v) for _, v in r["cache"]])
    logits, cache, load = model.forward_tokens_slots(
        torch.from_numpy(s["tok"]).long(), cache, torch.from_numpy(s["pos"]),
        return_moe_stats=True)
    _close(logits, s["logits"])
    np.testing.assert_array_equal(load.numpy(), s["load"])
    assert load.dtype == torch.int32 and int(load[:-1].sum()) == 2 * B * 2
    for li, (k, v) in enumerate(s["cache"]):
        _close(cache.k[li], k)
        _close(cache.v[li], v)
    p = r["paged"]
    pc = PagedSlotCache(pages_k=[_t(k) for k, _ in p["pools"]],
                        pages_v=[_t(v) for _, v in p["pools"]], table=_t(p["table"]))
    logits, pc, load = model.forward_tokens_slots_paged(
        torch.from_numpy(s["tok"]).long(), pc, torch.from_numpy(p["pos"]),
        return_moe_stats=True)
    _close(logits, p["logits"])
    np.testing.assert_array_equal(load.numpy(), p["load"])
    for li, (k, v) in enumerate(p["out_pools"]):
        _close(pc.pages_k[li], k)
        _close(pc.pages_v[li], v)
    # without stats the same logits come back, two outputs
    out = model.forward_tokens_slots_paged(torch.from_numpy(s["tok"]).long(), pc,
                                           torch.from_numpy(p["pos"]))
    assert len(out) == 2


def test_engine_serve_matches_jax(moe_ref):
    """Engine(backend="flash").serve: the port's free-running tokens equal
    JAX's wherever the JAX top-2 margin exceeds twice the logit
    tolerance (the streams may part legitimately after a near tie)."""
    r = moe_ref
    toks = Engine(_model(r), max_seq=MAX_SEQ, backend="flash", device="cpu").serve(
        r["ids"], GEN)
    assert toks.shape == (B, GEN) and toks.dtype == torch.int32
    checked = 0
    for b in range(B):
        for t in range(GEN):
            lg = r["logits"][t][b]
            top2 = np.sort(lg)[-2:]
            if top2[1] - top2[0] <= 2e-5 * (1 + np.abs(lg).max()):
                break
            assert toks[b, t].item() == r["toks"][b, t], (b, t)
            checked += 1
    assert checked > 0


def test_rep8_forward_matches_jax():
    """Eight query heads per kv head (the GQA ratio of Qwen3-30B-A3B):
    prefill logits and one decode step against the JAX engine's plain
    prefill and forward_tokens, f32 at 1e-5."""
    mesh = _mesh()
    jcfg = jax_tiny_qwen3_moe(1, num_heads=8, num_kv_heads=1)
    jm = JaxAutoLLM.from_config(jcfg, mesh, seed=3)
    ids = np.random.RandomState(6).randint(0, 256, (B, S)).astype(np.int32)
    jl, jc = JaxEngine(jm, max_seq=MAX_SEQ, backend="xla").prefill(ids)
    tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)[:, None]
    jl2, _ = jax.jit(lambda m, t, c: m.forward_tokens(t, c, mode="xla"))(jm, tok, jc)
    model = from_jax_arrays(tiny_qwen3_moe(1, num_heads=8, num_kv_heads=1),
                            _jax_moe_arrays(jm), device="cpu")
    cache = model.make_cache(B, MAX_SEQ)
    logits, cache = model.forward_tokens(torch.from_numpy(ids).long(), cache)
    _close(logits, jl)
    logits, _ = model.forward_tokens(torch.from_numpy(tok).long(), cache)
    _close(logits, jl2)


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------


def _shared_prefix_requests(cls):
    """Three requests sharing a 9-token prefix (the prefix cache hits),
    one standing alone."""
    rng = np.random.RandomState(11)
    prefix = rng.randint(0, 256, 9)
    out = [cls(rid=i, ids=np.concatenate([prefix, rng.randint(0, 256, 3 + i)]
                                         ).astype(np.int32), gen_len=5 + i)
           for i in range(3)]
    out.append(cls(rid=3, ids=rng.randint(0, 256, 6).astype(np.int32), gen_len=6))
    return out


def test_moe_paged_serving_bitwise_and_telemetry():
    """Dropless paged serving, prefix cache on and off, streams bitwise
    equal to the port's own Engine.serve per request (batch 2, the row
    duplicated, as the JAX test does); stats() carries the per-expert
    counts, no capacity drop and an imbalance >= 1. The per-expert counts
    equal the JAX scheduler's on the same requests and weights (its
    ticks route every slot, live or not, as the port's do)."""
    mesh = _mesh()
    jm = JaxAutoLLM.from_config(jax_tiny_qwen3_moe(1, **E4), mesh, seed=0,
                                capacity_factor="dropless")
    jsched = JaxScheduler(JaxEngine(jm, max_seq=MAX_SEQ, backend="xla"), batch=2,
                          chunk=4, paged=True, page=PAGE)
    jsched.run(_shared_prefix_requests(JaxRequest))
    jst = jsched.stats()
    model = from_jax_arrays(tiny_qwen3_moe(1, **E4), _jax_moe_arrays(jm), device="cpu",
                            capacity_factor="dropless")
    eng = Engine(model, max_seq=MAX_SEQ, backend="flash", device="cpu")
    reqs = _shared_prefix_requests(Request)
    runs = {}
    for cache_on in (True, False):
        sched = ContinuousScheduler(eng, batch=2, chunk=4, paged=True, page=PAGE,
                                    prefix_cache=cache_on)
        runs[cache_on] = sched.run(reqs)
        st = sched.stats()
        E = model.config.num_experts
        counts = [st[labeled_name("expert_tokens", {"expert": str(e)})] for e in range(E)]
        assert sum(counts) > 0 and st["moe_capacity_drops"] == 0
        assert st["expert_load_imbalance"] >= 1.0
        if cache_on:
            assert st["hits"] > 0
            assert counts == [jst.get(f"expert_tokens{{expert={e}}}", 0) for e in range(E)]
            assert st["moe_capacity_drops"] == jst["moe_capacity_drops"]
    for r in reqs:
        want = eng.serve(np.tile(r.ids[None], (2, 1)), r.gen_len)[0].numpy()
        for cache_on, streams in runs.items():
            np.testing.assert_array_equal(streams[r.rid], want,
                                          err_msg=f"cache {cache_on}, rid={r.rid}")
    # the contiguous scheduler serves the same streams
    got = ContinuousScheduler(eng, batch=2, chunk=4).run(reqs)
    for r in reqs:
        np.testing.assert_array_equal(got[r.rid], runs[True][r.rid])


# ----------------------------------------------------------------------
# gates, loading, telemetry
# ----------------------------------------------------------------------


def _moe_model():
    return AutoLLM.from_config(tiny_qwen3_moe(1, **E4), device="cpu")


@pytest.mark.parametrize("case", ["ep_backend", "ep_flash_backend", "moe_impl_ep",
                                  "forward_train", "mode_dist", "quantize_int8"])
def test_moe_not_ported_paths_raise(case):
    """What a MoE model does not run yet raises NotImplementedError("... not
    yet ported"); the expert-parallel backends, ported, refuse a TP_MoE
    model as the JAX engine does (ValueError naming moe_impl), and an EP
    model's two-tier mode is what stays unported of moe_impl="ep". The
    layer's "dist" mode runs since TP-MoE was ported: case mode_dist is now
    its training mode, which waits."""
    m = _moe_model()
    calls = {
        "ep_backend": lambda: Engine(m, backend="ep", device="cpu"),
        "ep_flash_backend": lambda: Engine(m, backend="ep_flash", device="cpu"),
        "moe_impl_ep": lambda: AutoLLM.from_config(tiny_qwen3_moe(1), device="cpu",
                                                   moe_impl="ep").layers[0].moe(
            torch.zeros(1, 64), "ep_2d"),
        "forward_train": lambda: m.forward_train(None),
        "mode_dist": lambda: m.layers[0].moe(torch.zeros(1, 64), "train"),
        "quantize_int8": m.quantize_int8,
    }
    if case in ("ep_backend", "ep_flash_backend"):
        with pytest.raises(ValueError, match="moe_impl"):
            calls[case]()
        return
    with pytest.raises(NotImplementedError, match="not yet ported"):
        calls[case]()


def test_moe_gates():
    """backend="mega" refuses a MoE model with the JAX engine's
    ValueError; a dense config refuses MoE-only keyword arguments."""
    with pytest.raises(ValueError, match="routed-expert FFN"):
        Engine(_moe_model(), backend="mega", device="cpu")
    with pytest.raises(ValueError, match="MoE-only"):
        AutoLLM.from_config(tiny_qwen3(1), device="cpu", capacity_factor=2.0)
    assert _moe_model().layers[0].moe.capacity_factor == 2.0       # the JAX default
    for labels in (None, {}, {"expert": "3"}, {"b": "1", "a": "x"}):
        assert labeled_name("m", labels) == jax_labeled_name("m", labels)


def test_from_hf_moe(tmp_path):
    """Qwen3MoE.from_hf (through AutoLLM.from_pretrained) on a tiny HF
    checkpoint written here: the same weights, packed the same way, as
    the JAX loader's on the same files, hence the same logits."""
    st = pytest.importorskip("safetensors.numpy")
    cfg = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
               num_key_value_heads=1, head_dim=32, vocab_size=256,
               max_position_embeddings=128, num_experts=4, num_experts_per_tok=2,
               moe_intermediate_size=32, model_type="qwen3_moe", torch_dtype="float32")
    rng = np.random.RandomState(8)

    def w(*shape):
        return (rng.randn(*shape) * 0.1).astype(np.float32)

    t = {"model.embed_tokens.weight": w(256, 64), "model.norm.weight": 1 + w(64),
         "lm_head.weight": w(256, 64)}
    for li in range(2):
        p = f"model.layers.{li}."
        t.update({p + "self_attn.q_proj.weight": w(64, 64),
                  p + "self_attn.k_proj.weight": w(32, 64),
                  p + "self_attn.v_proj.weight": w(32, 64),
                  p + "self_attn.o_proj.weight": w(64, 64),
                  p + "self_attn.q_norm.weight": 1 + w(32),
                  p + "self_attn.k_norm.weight": 1 + w(32),
                  p + "input_layernorm.weight": 1 + w(64),
                  p + "post_attention_layernorm.weight": 1 + w(64),
                  p + "mlp.gate.weight": w(4, 64)})
        for e in range(4):
            q = f"{p}mlp.experts.{e}."
            t.update({q + "gate_proj.weight": w(32, 64), q + "up_proj.weight": w(32, 64),
                      q + "down_proj.weight": w(64, 32)})
    st.save_file(t, str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    got = AutoLLM.from_pretrained(str(tmp_path), device="cpu", capacity_factor="dropless")
    jm = JaxAutoLLM.from_pretrained(str(tmp_path), _mesh())
    want = _jax_moe_arrays(jm)
    assert isinstance(got, Qwen3MoE) and got.config.is_moe
    ly = got.layers[1]
    for name, have in (("layers.1.moe.w_gate_up", ly.moe.w_gate_up),
                       ("layers.1.moe.w_down", ly.moe.w_down),
                       ("layers.1.moe.w_router", ly.moe.w_router),
                       ("layers.1.attn.w_qkv", ly.attn.w_qkv), ("lm_head", got.lm_head)):
        np.testing.assert_array_equal(_np(have), _np(want[name]), err_msg=name)
    ids = torch.from_numpy(np.random.RandomState(9).randint(0, 256, (1, 6)))
    ref = from_jax_arrays(got.config, want, device="cpu", capacity_factor="dropless")
    a, _ = got.forward_tokens(ids, got.make_cache(1, 16))
    b, _ = ref.forward_tokens(ids, ref.make_cache(1, 16))
    assert torch.equal(a, b)
    assert os.path.exists(tmp_path / "model.safetensors")
