"""The port's tensor-parallel MoE slice (kernels.ag_group_gemm,
kernels.moe_reduce_rs, kernels.moe_reduce_ar, the strided grouped GEMM,
layers.TP_MoE over a mesh, Qwen3MoE(moe_impl="tp") carried from a JAX
model built over four ranks, Engine "dist"/"ar"/"gemm_ar") against the
JAX package, on a mesh of four CPU ranks (runtime.make_mesh(4,
devices=["cpu"] * 4)) against a four-device JAX mesh with Auto axes.

The JAX TP-MoE kernels run in Pallas interpret mode, seconds a call, so
each JAX call runs once, jitted, in the module fixture `jax_tp`. The
layers are kept small (E=4, D=32, I=4n: the JAX fused kernels unroll n*E
blocks at trace time). The port runs on the CPU, where its kernel
wrappers take their plain versions. Tolerances: the plain kernels in f32
within 1e-5 of (1 + the largest JAX value) (the same products summed in
another order), in bf16 within 2e-2 (a bf16 rounding of each partial and
of each ring hop, in either order); the layer and the model in f32 within
1e-4 of (1 + the largest JAX value) (the JAX package's own model bound);
the routing loads and drop counts equal. The engine and the paged
scheduler at four ranks, dropless, against the port's one-rank engine:
streams equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, NamedSharding
from jax.sharding import PartitionSpec as P

from triton_dist_tpu.kernels import kernel_registry as jax_kernel_registry
from triton_dist_tpu.layers.tp_moe import TP_MoE as JaxTP_MoE
from triton_dist_tpu.models import AutoLLM as JaxAutoLLM
from triton_dist_tpu.models.config import tiny_qwen3_moe as jax_tiny_qwen3_moe
from triton_dist_tpu.models.kv_cache import KVCache as JaxKVCache
from triton_dist_tpu_torch import kernels as K
from triton_dist_tpu_torch.layers import TP_MoE
from triton_dist_tpu_torch.models import (AutoLLM, ContinuousScheduler, Engine, Qwen3MoE,
                                          Request, tiny_qwen3_moe)
from triton_dist_tpu_torch.models.convert import from_jax_arrays
from triton_dist_tpu_torch.runtime import make_mesh
from test_torch_moe import _jax_moe_arrays

N = 4
E, D, I = 4, 32, 4 * N
# the layer cases: capacity 2.0 with entries dropped (top-1, a router that
# crowds expert 0, 32 rows a rank so the fused form's shard capacity drops
# too), and dropless (top-2)
CASES = {"cap2": dict(k=1, cf=2.0, M=32 * N, skew=3.0),
         "dropless": dict(k=2, cf="dropless", M=8 * N, skew=0.0)}
JAX_MODES = ("xla", "flash", "dist", "fused", "fused_ar")
IDS = np.random.RandomState(7).randint(0, 256, (4, 4)).astype(np.int32)


def _jmesh():
    if len(jax.devices()) < N:
        pytest.skip(f"needs {N} JAX devices")
    return jax.make_mesh((N,), ("tp",), axis_types=(AxisType.Auto,),
                         devices=jax.devices()[:N])


def _mesh():
    return make_mesh(N, devices=["cpu"] * N)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rel=1e-4):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    err = np.abs(g - w).max()
    assert err <= rel * (1 + np.abs(w).max()), f"max|d| {err}"


def _layer_inputs(case):
    c = CASES[case]
    rng = np.random.RandomState(5)
    router = (rng.randn(D, E) * 0.5).astype(np.float32)
    router[:, 0] += c["skew"] / D ** 0.5
    gate = (rng.randn(E, D, I) * D ** -0.5).astype(np.float32)
    up = (rng.randn(E, D, I) * D ** -0.5).astype(np.float32)
    down = (rng.randn(E, I, D) * I ** -0.5).astype(np.float32)
    x = (np.abs(rng.randn(c["M"], D)) * 0.5).astype(np.float32)
    return router, gate, up, down, x


def _layer(case, mesh=None):
    router, gate, up, down, _ = _layer_inputs(case)
    c = CASES[case]
    return TP_MoE.init(*(torch.from_numpy(a) for a in (router, gate, up, down)), top_k=c["k"],
                       capacity_factor=c["cf"], mesh=mesh or _mesh())


def _stats_np(st):
    return int(np.asarray(st["dropped"])), np.asarray(st["expert_tokens"]).tolist()


@pytest.fixture(scope="module")
def jax_tp():
    """Every JAX call of this module, once: the registry's three TP-MoE
    kernels in f32 and in bf16, the TP-MoE layer in each form on both
    cases, and the TP-MoE model's "xla" logits."""
    mesh = _jmesh()
    out = {}
    reg = jax_kernel_registry()
    for name in ("ag_group_gemm", "moe_reduce_rs", "moe_reduce_ar"):
        fn, args = reg[name].build(mesh)
        out[name] = {}
        for dt in ("float32", "bfloat16"):
            a = [jnp.asarray(t, dt) for t in args]
            out[name][dt] = ([np.asarray(jnp.asarray(t, jnp.float32)) for t in a],
                             np.asarray(jnp.asarray(jax.jit(fn)(*a), jnp.float32)))
    out["layer"] = {}
    for case, c in CASES.items():
        router, gate, up, down, x = _layer_inputs(case)
        lay = JaxTP_MoE.init(*(jnp.asarray(a) for a in (router, gate, up, down)), mesh=mesh,
                             axis="tp", top_k=c["k"], capacity_factor=c["cf"])
        xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("tp", None)))
        res = {}
        for mode in JAX_MODES:
            sharded = mode in ("dist", "fused")
            if mode in ("fused", "fused_ar"):
                fn = jax.jit(lambda m, v, mode=mode: m(v, mode))
                res[mode] = (np.asarray(fn(lay, xs if sharded else jnp.asarray(x))), None)
            else:
                fn = jax.jit(lambda m, v, mode=mode: m(v, mode, return_stats=True))
                y, st = fn(lay, xs if sharded else jnp.asarray(x))
                res[mode] = (np.asarray(y), _stats_np(st))
        out["layer"][case] = res
    jm = JaxAutoLLM.from_config(jax_tiny_qwen3_moe(N), mesh, seed=0,
                                capacity_factor="dropless")
    cfg = jm.config
    cache = JaxKVCache.create(cfg.num_layers, 4, 16, cfg.num_kv_heads, cfg.head_dim,
                              mesh=mesh, axis="tp", dtype=jnp.float32)
    step = jax.jit(lambda m, tk, c: m.forward_tokens(tk, c, mode="xla"))
    logits, cache = step(jm, jnp.asarray(IDS), cache)
    toks = np.asarray(logits).argmax(-1).astype(np.int32)
    logits2, _ = step(jm, jnp.asarray(toks)[:, None], cache)
    out["model"] = dict(arrays=_jax_moe_arrays(jm), logits=[np.asarray(logits),
                                                            np.asarray(logits2)], toks=toks)
    return out


# ----------------------------------------------------------------------
# the kernels' plain versions
# ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["ag_group_gemm", "moe_reduce_rs", "moe_reduce_ar"])
def test_tp_moe_kernels_match_jax(jax_tp, name, dtype):
    """The registry's canonical call (E=2, capT=8n, D=N=F=128, seed 10 or
    11): the port's inputs equal JAX's, and the plain version's output on
    them (each rank's block placed as the JAX global output places it)
    equals the JAX kernel's in interpret mode, in f32 and with the same
    inputs in bf16."""
    ins, want = jax_tp[name][dtype]
    tdt = getattr(torch, dtype)
    fn, args = K.kernel_registry()[name].build(_mesh())
    n = N
    a, w = [t.to(tdt) for t in args[:n]], [t.to(tdt) for t in args[n:]]
    if dtype == "float32":
        dims = (1, 2) if name == "ag_group_gemm" else (2, 1)
        np.testing.assert_array_equal(torch.cat(args[:n], dims[0]).numpy(), ins[0])
        np.testing.assert_array_equal(torch.cat(args[n:], dims[1]).numpy(), ins[1])
        got = fn(*args)
    else:
        op = {"ag_group_gemm": K.ag_group_gemm, "moe_reduce_rs": K.moe_reduce_rs,
              "moe_reduce_ar": K.moe_reduce_ar}[name]
        got = op(a, w, mesh=_mesh())
    if name == "ag_group_gemm":          # N sharded: each rank's columns
        got = torch.cat(got, 2)
    elif name == "moe_reduce_rs":        # capT sharded: each rank's rows
        got = torch.cat(got, 1)
    else:                                # replicated: every copy equal
        assert all(torch.equal(g, got[0]) for g in got)
        got = got[0]
    _close(got, want, rel=1e-5 if dtype == "float32" else 2e-2)


def test_grouped_gemm_takes_strided_column_blocks():
    """grouped_gemm's plain version on a pair of column blocks equals the
    product with the blocks side by side; on views of one panel (a rank's
    gate and up columns, its w_down rows) it equals the contiguous copy."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(3, 8, 32).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 32, 64).astype(np.float32))
    g, u = w[:, :, 8:16], w[:, :, 40:48]
    want = K.grouped_gemm(x, torch.cat([g, u], 2).contiguous())
    assert torch.equal(K.grouped_gemm(x, (g, u)), want)
    down = w[:, 8:16]
    assert torch.equal(K.grouped_gemm(x[:, :, :8].contiguous(), down),
                       K.grouped_gemm(x[:, :, :8].contiguous(), down.contiguous()))


# ----------------------------------------------------------------------
# the layer
# ----------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["xla", "flash", "ar", "gemm_ar", "dist", "fused",
                                  "fused_ar"])
@pytest.mark.parametrize("case", list(CASES))
def test_tp_moe_layer_matches_jax(jax_tp, case, mode):
    """TP_MoE over four ranks on the same weights and rows as the JAX layer
    over four devices, in each mode ("ar" and "gemm_ar" are the JAX
    fwd_local, as "flash"): the outputs (f32, 1e-4) and, for the serving
    forms, the stats (drops, per-expert loads) equal; at capacity 2.0 the
    forms that route globally drop entries, on both sides alike."""
    want, wst = jax_tp["layer"][case][{"ar": "flash", "gemm_ar": "flash"}.get(mode, mode)]
    lay = _layer(case)
    x = torch.from_numpy(_layer_inputs(case)[4])
    if wst is None:
        y = lay(x, mode)
    else:
        y, st = lay(x, mode, return_stats=True)
        assert _stats_np(st) == wst
        if case == "cap2" and mode != "xla":
            assert wst[0] > 0, "the capacity should drop entries at this shape"
    _close(y, want)


def test_tp_moe_per_rank_lists_and_one_rank():
    """The forms take their per-rank lists as the model's stack holds them
    (row shards for "dist" and "fused", copies for the rest), equal to the
    tensor call; over one rank every form equals fwd_local's."""
    lay, one = _layer("cap2"), _layer("cap2", mesh=make_mesh(1, devices=["cpu"]))
    x = torch.from_numpy(_layer_inputs("cap2")[4])
    shards = list(x.chunk(N))
    for mode in ("dist", "fused"):
        np.testing.assert_array_equal(torch.cat(lay(shards, mode)).numpy(), lay(x, mode).numpy())
    for mode in ("flash", "fused_ar", "xla"):
        ys = lay([x] * N, mode)
        assert len(ys) == N and all(torch.equal(y, ys[0]) for y in ys)
        np.testing.assert_array_equal(ys[0].numpy(), lay(x, mode).numpy())
    ref = one(x, "flash")
    for mode in ("dist", "ar", "gemm_ar"):
        np.testing.assert_array_equal(one(x, mode).numpy(), ref.numpy())
    x8 = x[:32]                             # one rank: no drop at this size either way
    _close(one(x8, "fused"), one(x8, "fused_ar"), rel=1e-6)


def test_padding_rows_take_no_capacity_or_load():
    """A "dist" call's rows past `rows` (the zero padding of a row count n
    does not divide) are cut before the routing: the real rows' outputs and
    stats equal the unpadded call's at one rank (capacity _cap(rows)), and
    the padding comes back as zero rows."""
    lay, one = _layer("cap2"), _layer("cap2", mesh=make_mesh(1, devices=["cpu"]))
    x = torch.from_numpy(_layer_inputs("cap2")[4][:126])     # 32 a rank, 2 of padding
    y, st = lay(x, "dist", return_stats=True)
    want, wst = one(x, "flash", return_stats=True)
    _close(y, want, rel=1e-6)
    assert _stats_np(st) == _stats_np(wst) and int(st["expert_tokens"].sum()) == 126
    assert int(st["dropped"]) > 0
    ys = lay.fwd_dist(lay._sharded(x, None)[0], rows=126)
    assert ys[-1][-2:].abs().max() == 0


def test_carried_weights_unpack_the_jax_rank_blocks(jax_tp):
    """The repair of the weight carry: a JAX TP-MoE model built over four
    devices packs each expert's [gate | up] as four blocks [gate_r | up_r];
    from_jax_arrays(..., jax_tp=4) unpacks them, so the one-rank port model
    gives the JAX model's logits (the old copy, taken as [gate | up], does
    not)."""
    r = jax_tp["model"]
    one = from_jax_arrays(tiny_qwen3_moe(N), r["arrays"], device="cpu",
                          capacity_factor="dropless", jax_tp=N)
    I_ = one.config.moe_intermediate_size
    packed = torch.from_numpy(np.array(r["arrays"]["layers.0.moe.w_gate_up"]))
    i = I_ // N
    np.testing.assert_array_equal(one.layers[0].moe.w_gate_up[:, :, i:2 * i].numpy(),
                                  packed[:, :, 2 * i:3 * i].numpy())
    cache = one.make_cache(4, 16)
    logits, _ = one.forward_tokens(torch.from_numpy(IDS).long(), cache, mode="xla")
    _close(logits, r["logits"][0])


# ----------------------------------------------------------------------
# the model, the engine and the scheduler
# ----------------------------------------------------------------------


def _tp_model(jax_tp, mesh=None):
    return from_jax_arrays(tiny_qwen3_moe(N), jax_tp["model"]["arrays"], device="cpu",
                           capacity_factor="dropless", mesh=mesh or _mesh(), jax_tp=N)


@pytest.mark.parametrize("mode", ["dist", "ar", "gemm_ar", "xla"])
def test_forward_tokens_matches_jax(jax_tp, mode):
    """Qwen3MoE(moe_impl="tp") carried from the JAX TP-MoE model at tp=4
    and split over four ranks: forward_tokens logits after a [4, 4] prefill
    and one decode step against the JAX model's "xla" (1e-4)."""
    r = jax_tp["model"]
    model = _tp_model(jax_tp)
    assert model.moe_impl == "tp" and model.tp == N and model.layers[0].moe.n == N
    cache = model.make_cache(4, 16)
    logits, cache = model.forward_tokens(torch.from_numpy(IDS).long(), cache, mode=mode)
    _close(logits, r["logits"][0])
    logits, cache = model.forward_tokens(torch.from_numpy(r["toks"]).long()[:, None], cache,
                                         mode=mode)
    _close(logits, r["logits"][1])


def _requests(n_req=6):
    rng = np.random.RandomState(5)
    head = rng.randint(0, 256, 11)
    return [Request(rid=i, ids=np.concatenate([head, rng.randint(0, 256, 3 + i)]
                                              ).astype(np.int32), gen_len=4 + i % 3)
            for i in range(n_req)]


def test_dist_engine_and_paged_scheduler_equal_one_rank(jax_tp):
    """Engine "dist" at four ranks against the port's one-rank engine,
    dropless: serve() tokens over a prompt of 3 rows a sequence (12 rows,
    none of padding) and 5 (20) equal; the paged scheduler's streams equal,
    no drop, the same routed entries; "ar" and "gemm_ar" build and serve
    alike."""
    one = from_jax_arrays(tiny_qwen3_moe(N), jax_tp["model"]["arrays"], device="cpu",
                          capacity_factor="dropless", jax_tp=N)
    model = _tp_model(jax_tp)
    ref = Engine(one, max_seq=48, backend="flash", device="cpu")
    for backend in ("dist", "ar", "gemm_ar"):
        eng = Engine(model, max_seq=48, backend=backend, device="cpu")
        for ids in (IDS[:, :3], np.tile(IDS[:1, :4], (4, 2))[:, :5]):
            np.testing.assert_array_equal(eng.serve(ids, 4).numpy(), ref.serve(ids, 4).numpy())
    reqs = _requests()
    runs = []
    for e in (ref, Engine(model, max_seq=48, backend="dist", device="cpu")):
        sched = ContinuousScheduler(e, batch=4, chunk=4, paged=True, page=8)
        runs.append((sched.run(reqs), sched.stats()))
    (o1, s1), (o4, s4) = runs
    for r in reqs:
        np.testing.assert_array_equal(o4[r.rid], o1[r.rid], err_msg=f"rid {r.rid}")
    E_ = one.config.num_experts
    routed = [sum(s.get(f"expert_tokens{{expert={e}}}", 0) for e in range(E_)) for s in (s1, s4)]
    assert s4["moe_capacity_drops"] == 0 == s1["moe_capacity_drops"]
    assert routed[0] == routed[1] > 0


def test_random_init_over_a_mesh_splits_the_one_rank_model():
    """random_init(..., mesh=) is the one-rank model of the seed, split:
    rank r's panels are views of its gate, up and down columns and rows."""
    mesh = _mesh()
    one = Qwen3MoE.random_init(tiny_qwen3_moe(N), device="cpu", seed=3)
    m4 = AutoLLM.from_config(tiny_qwen3_moe(N), device="cpu", seed=3, mesh=mesh)
    lay1, lay4 = one.layers[1].moe, m4.layers[1].moe
    I_ = lay1.w_down.shape[1]
    i = I_ // N
    for r, p in enumerate(lay4.ranks):
        g, u = p.gate_up
        assert torch.equal(g, lay1.w_gate_up[:, :, r * i:(r + 1) * i])
        assert torch.equal(u, lay1.w_gate_up[:, :, I_ + r * i:I_ + (r + 1) * i])
        assert torch.equal(p.down, lay1.w_down[:, r * i:(r + 1) * i])
        assert g.data_ptr() == lay4.w_gate_up.data_ptr() + r * i * g.element_size()


@pytest.mark.parametrize("case", ["train", "int8_ag", "int8_rs", "int8_ar", "knob"])
def test_tp_moe_unported_forms_raise(case):
    """What stays unported of TP-MoE raises NotImplementedError("... not
    yet ported"): its training form, the kernels' int8 QuantW panels and
    their TPU tuning knobs."""
    mesh = _mesh()
    lay = _layer("dropless")
    x = torch.zeros(8 * N, D)
    q = K.quantize_int8(torch.ones(E, D, 8))
    h = [torch.zeros(E, 8, 8)] * N
    calls = {
        "train": lambda: lay(x, "train"),
        "int8_ag": lambda: K.ag_group_gemm([torch.zeros(E, 2, D)] * N, [q] * N, mesh=mesh),
        "int8_rs": lambda: K.moe_reduce_rs(h, [K.quantize_int8(torch.ones(E, 8, D))] * N,
                                           mesh=mesh),
        "int8_ar": lambda: K.moe_reduce_ar(h, [K.quantize_int8(torch.ones(E, 8, D))] * N,
                                           mesh=mesh),
        "knob": lambda: K.ag_group_gemm([torch.zeros(E, 2, D)] * N, [torch.ones(E, D, 8)] * N,
                                        mesh=mesh, resident_b=True),
    }
    with pytest.raises(NotImplementedError, match="not yet ported"):
        calls[case]()
