"""The port's expert-parallel slice (kernels.all_to_all, the EP plan and
exchanges of kernels.ep_a2a, kernels.ep_fused, layers.EP_MoE,
Qwen3MoE(moe_impl="ep") and Engine "ep"/"ep_flash") against the JAX
package, on a mesh of four CPU ranks (runtime.make_mesh(4, devices=["cpu"]
* 4)) against a four-device JAX mesh with Auto axes.

The JAX EP kernels run in Pallas interpret mode, seconds to tens of
seconds a call, so each JAX call runs once, in the module fixture
`jax_ep`. The port runs on the CPU, where its exchanges and the fused
kernel take their plain versions. Tolerances: the exchanges and the int8
wire bitwise (they move bytes; pack_rows_int8 rounds as JAX does); the
plan's slots, validity and drop counts equal; the layer and the model in
f32 within 1e-4 of (1 + the largest JAX value) (the same math summed in
another order; the JAX package's own model bound, tests/test_moe_e2e.py),
the int8 wire within 2e-2 (one int8 rounding each way, JAX's own 9.2e-3
gap at this shape); the routing loads equal. The engine and the paged
scheduler at four ranks against the port's one-rank engine: streams
equal, and the load telemetry equal wherever no masked slot steps (a
retired slot of the head-split paged pool reads its rank's own trash page,
so its throwaway rows route differently from one rank's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, NamedSharding
from jax.sharding import PartitionSpec as P

from triton_dist_tpu.kernels import kernel_registry as jax_kernel_registry
from triton_dist_tpu.kernels import ep_a2a as jax_a2a
from triton_dist_tpu.layers.ep_moe import EP_MoE as JaxEP_MoE
from triton_dist_tpu.models import AutoLLM as JaxAutoLLM
from triton_dist_tpu.models.config import tiny_qwen3_moe as jax_tiny_qwen3_moe
from triton_dist_tpu_torch import kernels as K
from triton_dist_tpu_torch.kernels import ep_a2a
from triton_dist_tpu_torch.layers import EP_MoE
from triton_dist_tpu_torch.models import (AutoLLM, ContinuousScheduler, Engine, Qwen3MoE,
                                          Request, tiny_qwen3, tiny_qwen3_moe)
from triton_dist_tpu_torch.models.convert import from_jax_arrays
from triton_dist_tpu_torch.runtime import make_mesh
from triton_dist_tpu_torch.tools.fault_margin import RouteTape
from test_torch_moe import _jax_moe_arrays

N = 4
T, D, I, E, K_TOP = 64, 64, 32, 8, 2
CF = 0.5                # a capacity at which entries drop on both paths
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


def _layer_inputs():
    rng = np.random.RandomState(3)
    # a router that prefers a few experts, so that capacity CF drops
    router = (rng.randn(D, E) * 0.5 + np.linspace(0, 1.5, E)[None] / D).astype(np.float32)
    gate = (rng.randn(E, D, I) * D ** -0.5).astype(np.float32)
    up = (rng.randn(E, D, I) * D ** -0.5).astype(np.float32)
    down = (rng.randn(E, I, D) * I ** -0.5).astype(np.float32)
    x = (rng.randn(T, D) * 0.5).astype(np.float32)
    return router, gate, up, down, x


def _stats_np(st):
    return int(np.asarray(st["dropped"])), np.asarray(st["expert_tokens"]).tolist()


@pytest.fixture(scope="module")
def jax_ep():
    """Every JAX EP call of this module, once: the registry's exchanges,
    the EP layer in each mode, and the EP model's "xla" logits."""
    mesh = _jmesh()
    out = {}
    reg = jax_kernel_registry()
    for name in ("all_to_all", "low_latency_all_to_all"):
        fn, args = reg[name].build(mesh)
        out[name] = (np.asarray(args[0]), np.asarray(fn(*args)))
    router, gate, up, down, x = _layer_inputs()
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("tp", None)))
    layers = {}
    for q8 in (False, True):
        layers[q8] = JaxEP_MoE.init(jnp.asarray(router), jnp.asarray(gate), jnp.asarray(up),
                                    jnp.asarray(down), mesh=mesh, axis="tp", top_k=K_TOP,
                                    capacity_factor=CF, payload_int8=q8)
    lay = layers[False]

    def run(layer, mode):
        # jitted: eager, every shard_map and interpreted kernel retraces
        # (about 20 s a call against 2 s)
        if mode == "xla":
            return jax.jit(lambda m, v: m.fwd_xla(v, return_stats=True))(layer, xs)
        return jax.jit(lambda m, v: m(v, mode, return_stats=True))(layer, xs)

    out["layer"] = {
        "ep": run(lay, "ep"),
        "ep_int8": run(layers[True], "ep"),
        "ep_fused": run(lay, "ep_fused"),
        "ep_fused_quant": run(lay.quantize_int8_experts(), "ep_fused"),
        "xla": run(lay, "xla"),
    }
    out["layer"] = {k: (np.asarray(y), _stats_np(st)) for k, (y, st) in out["layer"].items()}
    jm = JaxAutoLLM.from_config(jax_tiny_qwen3_moe(N), mesh, seed=0, moe_impl="ep",
                                capacity_factor="dropless")
    from triton_dist_tpu.models.kv_cache import KVCache as JaxKVCache
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
# the exchanges and the plan
# ----------------------------------------------------------------------


@pytest.mark.parametrize("name", ["all_to_all", "low_latency_all_to_all"])
def test_all_to_all_matches_jax(jax_ep, name):
    """The registry's canonical exchange ([n, n, 8, 128] f32, seed 1): the
    port's inputs equal JAX's, and its plain exchange (with the int8 wire
    for low_latency_all_to_all) equals JAX's output bitwise."""
    x, want = jax_ep[name]
    fn, args = K.kernel_registry()[name].build(_mesh())
    np.testing.assert_array_equal(np.stack([a.numpy() for a in args]), x)
    got = np.stack([o.numpy() for o in fn(*args)])
    np.testing.assert_array_equal(got, want)


def test_plan_pack_and_grouping_match_jax():
    """plan_dispatch, fill_send_buffers, group_by_expert, combine_from_slots
    and pack_rows_int8 / unpack_rows_int8 against the JAX functions, with
    capacities at which entries drop on both sides of the exchange."""
    rng = np.random.RandomState(11)
    n, epr, cap, e_cap = N, 2, 5, 6
    topk = np.stack([rng.choice(n * epr, K_TOP, replace=False) for _ in range(24)]
                    ).astype(np.int32)
    topk[:12] %= 3                                     # crowd experts 0-2
    x = rng.randn(24, 16).astype(np.float32)
    jp = jax_a2a.plan_dispatch(jnp.asarray(topk), n, epr, cap)
    tp = ep_a2a.plan_dispatch(torch.from_numpy(topk), n, epr, cap)
    np.testing.assert_array_equal(tp.slot.numpy(), np.asarray(jp.slot))
    np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))
    np.testing.assert_array_equal(tp.token.numpy(), np.asarray(jp.token))
    assert int(tp.dropped) == int(jp.dropped) > 0
    jx, jm = jax_a2a.fill_send_buffers(jnp.asarray(x), jnp.asarray(topk), jp, n, epr, cap)
    sx, sm = ep_a2a.fill_send_buffers(torch.from_numpy(x), torch.from_numpy(topk), tp, n,
                                      epr, cap)
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(sm.numpy(), np.asarray(jm))
    # the received layout: a rank's n chunks from four senders (here the
    # send buffer itself, shuffled by chunk), then the expert grouping
    recv_x, recv_m = sx.flip(0), sm.flip(0)
    jxe, jinv, jdrop = jax_a2a.group_by_expert(jnp.asarray(recv_x.numpy()),
                                               jnp.asarray(recv_m.numpy()), epr, e_cap)
    xe, inv, drop = ep_a2a.group_by_expert(recv_x, recv_m, epr, e_cap)
    np.testing.assert_array_equal(xe.numpy(), np.asarray(jxe))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
    assert int(drop) == int(jdrop) > 0
    w = rng.rand(24, K_TOP).astype(np.float32)
    _close(ep_a2a.combine_from_slots(sx, tp, torch.from_numpy(w), 24),
           jax_a2a.combine_from_slots(jx, jp, jnp.asarray(w), 24), rel=1e-6)
    # the int8 wire: bitwise the same bytes, zero rows to zero rows
    xr = np.concatenate([rng.randn(7, 16).astype(np.float32) * 3, np.zeros((1, 16), np.float32)])
    pj = np.asarray(jax_a2a.pack_rows_int8(jnp.asarray(xr)))
    pt = ep_a2a.pack_rows_int8(torch.from_numpy(xr))
    np.testing.assert_array_equal(pt.numpy(), pj)
    np.testing.assert_array_equal(ep_a2a.unpack_rows_int8(pt, 16, torch.float32).numpy(),
                                  np.asarray(jax_a2a.unpack_rows_int8(jnp.asarray(pj), 16,
                                                                      jnp.float32)))


def test_padding_rows_take_no_slot_and_no_load():
    """Rows past `rows` (the zero-row padding of a row count n does not
    divide) get no slot, count in no drop and no load, and come back as
    zero rows; the real rows equal the unpadded forward's."""
    router, gate, up, down, x = _layer_inputs()
    lay = EP_MoE.init(*(torch.from_numpy(a) for a in (router, gate, up, down)), mesh=_mesh(),
                      top_k=K_TOP, capacity_factor="dropless")
    live = torch.arange(8) < 5
    pl = ep_a2a.plan_dispatch(torch.zeros(8, K_TOP, dtype=torch.int32), N, 2, 16, live=live)
    assert pl.valid[:10].all() and not pl.valid[10:].any()
    assert (pl.slot[10:] == N * 16).all() and int(pl.dropped) == 0
    xt = torch.from_numpy(x[:62])                      # 62 rows: 16 a rank, 2 padding
    y, st = lay(xt, "ep", return_stats=True)
    want, wst = lay(torch.from_numpy(x[:60]), "ep", return_stats=True)
    _close(y[:60], want, rel=1e-6)
    one = lay(torch.from_numpy(x[60:62]), "ep")
    _close(y[60:], one, rel=1e-6)
    assert int(st["expert_tokens"].sum()) == 62 * K_TOP and int(st["dropped"]) == 0
    ys = lay.fwd_ep(lay._shard(xt), rows=62)
    assert ys[-1][-2:].abs().max() == 0


# ----------------------------------------------------------------------
# the layer and the fused kernel
# ----------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["ep", "ep_int8", "ep_fused", "ep_fused_quant", "xla"])
def test_ep_layer_matches_jax(jax_ep, mode):
    """EP_MoE at capacity CF (entries drop) on the same weights and rows as
    the JAX layer: the outputs (f32 1e-4; the int8 wire 2e-2) and the
    stats (drops, per-expert loads) equal."""
    router, gate, up, down, x = _layer_inputs()
    lay = EP_MoE.init(*(torch.from_numpy(a) for a in (router, gate, up, down)), mesh=_mesh(),
                      top_k=K_TOP, capacity_factor=CF, payload_int8=mode == "ep_int8")
    if mode == "ep_fused_quant":
        lay = lay.quantize_int8_experts()
    want, (jdrop, jload) = jax_ep["layer"][mode]
    call = {"ep_int8": "ep", "ep_fused_quant": "ep_fused"}.get(mode, mode)
    where = {"ep": "EP_MoE.fwd_ep", "ep_fused": "EP_MoE.fwd_ep_fused"}.get(call)
    before = ep_a2a.drop_counts().get(where, 0)
    y, st = lay(torch.from_numpy(x), call, return_stats=True)
    _close(y, want, rel=2e-2 if mode == "ep_int8" else 1e-4)
    assert int(st["dropped"]) == jdrop
    assert st["expert_tokens"].tolist() == jload
    if where:                     # the JAX warning on drops, as a count
        assert ep_a2a.drop_counts().get(where, 0) - before == jdrop
    if mode == "ep":
        assert jdrop > 0, "the capacity should drop entries at this shape"


@pytest.mark.parametrize("mode", ["ep", "ep_int8", "ep_fused"])
def test_ep_layer_per_device_equals_stacked(mode):
    """The EP forwards run their plain steps once a device over the stack
    of its ranks (four emulated ranks: one stack); with one rank a device
    (four cards) each rank runs alone. Both give the same rows and stats:
    here the mesh's device groups are made one rank each."""
    router, gate, up, down, x = _layer_inputs()
    lays = []
    for per_rank in (False, True):
        mesh = _mesh()
        if per_rank:
            mesh._groups = [(d, [r]) for r, d in enumerate(mesh.devices)]
        lay = EP_MoE.init(*(torch.from_numpy(a) for a in (router, gate, up, down)), mesh=mesh,
                          top_k=K_TOP, capacity_factor=CF, payload_int8=mode == "ep_int8")
        lays.append(lay(torch.from_numpy(x[:62]), mode.replace("_int8", ""),
                        return_stats=True))
    (y0, s0), (y1, s1) = lays
    np.testing.assert_array_equal(y1.numpy(), y0.numpy())
    assert int(s1["dropped"]) == int(s0["dropped"])
    assert s1["expert_tokens"].tolist() == s0["expert_tokens"].tolist()


def test_ep_fused_device_matches_jax_registry():
    """ep_moe_fused_device's plain version on the registry's canonical
    inputs (seed 9) against JAX's y_back, and ep_dispatch_combine's
    against JAX's (seed 8)."""
    mesh, jmesh = _mesh(), _jmesh()
    for name in ("ep_fused", "ep_dispatch_combine"):
        fn, args = K.kernel_registry()[name].build(mesh)
        jfn, jargs = jax_kernel_registry()[name].build(jmesh)
        got = np.concatenate([o.numpy() for o in fn(*args)])
        _close(got, np.asarray(jax.jit(jfn)(*jargs)))


# ----------------------------------------------------------------------
# the model, the engine and the scheduler
# ----------------------------------------------------------------------


def _ep_model(jax_ep, mesh=None):
    cfg = tiny_qwen3_moe(N)
    return from_jax_arrays(cfg, jax_ep["model"]["arrays"], device="cpu",
                           capacity_factor="dropless", mesh=mesh or _mesh(), jax_tp=N,
                           moe_impl="ep")


@pytest.mark.parametrize("mode", ["ep", "ep_flash", "xla"])
def test_forward_tokens_matches_jax(jax_ep, mode):
    """Qwen3MoE(moe_impl="ep") carried from the JAX EP model at tp=4:
    forward_tokens logits after a [4, 4] prefill and one decode step
    against the JAX model's "xla" (1e-4)."""
    r = jax_ep["model"]
    model = _ep_model(jax_ep)
    assert model.moe_impl == "ep" and model.ep_size == N
    cache = model.make_cache(4, 16)
    logits, cache = model.forward_tokens(torch.from_numpy(IDS).long(), cache, mode=mode)
    _close(logits, r["logits"][0])
    logits, cache = model.forward_tokens(torch.from_numpy(r["toks"]).long()[:, None], cache,
                                         mode=mode)
    _close(logits, r["logits"][1])


def _one_rank(jax_ep):
    # the JAX EP model keeps each expert's [gate | up] whole
    return from_jax_arrays(tiny_qwen3_moe(N), jax_ep["model"]["arrays"], device="cpu",
                           capacity_factor="dropless", jax_tp=N, jax_moe_impl="ep")


def _requests(n_req=6, gen=None):
    rng = np.random.RandomState(5)
    head = rng.randint(0, 256, 11)
    return [Request(rid=i, ids=np.concatenate([head, rng.randint(0, 256, 3 + i)]
                                              ).astype(np.int32),
                    gen_len=gen or 4 + i % 3) for i in range(n_req)]


def _experts(st, E_):
    return [st.get(f"expert_tokens{{expert={e}}}", 0) for e in range(E_)]


@pytest.mark.parametrize("backend", ["ep", "ep_flash"])
def test_ep_engine_and_scheduler_equal_one_rank(jax_ep, backend):
    """Engine(backend) at four ranks against the port's one-rank engine:
    serve() tokens, the paged and contiguous schedulers' streams equal;
    the load telemetry equal on the contiguous scheduler and on a paged
    wave with no masked slot, and on any run the same routed entries in
    total with no drop."""
    one, model = _one_rank(jax_ep), _ep_model(jax_ep)
    ref = Engine(one, max_seq=48, backend="flash", device="cpu")
    eng = Engine(model, max_seq=48, backend=backend, device="cpu")
    assert eng.prefill_backend == backend
    ids = IDS[:, :3]                                 # 12 rows: 3 a rank
    np.testing.assert_array_equal(eng.serve(ids, 4).numpy(), ref.serve(ids, 4).numpy())
    E_ = one.config.num_experts
    for paged, reqs in ((True, _requests()), (False, _requests()),
                        (True, _requests(4, gen=5))):
        runs = []
        for e in (ref, eng):
            sched = ContinuousScheduler(e, batch=4, chunk=4, paged=paged, page=8)
            runs.append((sched.run(reqs), sched.stats()))
        (o1, s1), (o4, s4) = runs
        for r in reqs:
            np.testing.assert_array_equal(o4[r.rid], o1[r.rid], err_msg=f"rid {r.rid}")
        assert s4["moe_capacity_drops"] == 0 == s1["moe_capacity_drops"]
        assert sum(_experts(s4, E_)) == sum(_experts(s1, E_)) > 0
        if not paged or len(reqs) == 4:
            assert _experts(s4, E_) == _experts(s1, E_)


def test_route_tape_pins_ep_onto_one_rank(jax_ep):
    """RouteTape records the EP forward's routing (its ranks' selections
    as one call of the real rows, padding cut) and replays it onto the
    one-rank plain engine, and back: the logits agree, every call used."""
    one, model = _one_rank(jax_ep), _ep_model(jax_ep)
    ids = torch.from_numpy(IDS[:3, :3]).long()      # 9 rows, 3 of padding
    tape = RouteTape()
    with tape.record():
        lf, _ = model.forward_tokens(ids, model.make_cache(3, 16), mode="ep")
    with tape.replay():
        lr, _ = one.forward_tokens(ids, one.make_cache(3, 16), mode="xla")
    assert tape.done() and len(tape.calls) == one.config.num_layers
    _close(lf, lr)
    with tape.record():
        one.forward_tokens(ids, one.make_cache(3, 16), mode="flash")
    with tape.replay():
        lf2, _ = model.forward_tokens(ids, model.make_cache(3, 16), mode="ep_flash")
    assert tape.done()
    _close(lf2, lr)


# ----------------------------------------------------------------------
# gates
# ----------------------------------------------------------------------


def test_ep_capability_and_mesh_errors():
    """The JAX engine's capability gates (tests/test_moe_serving.py): a
    dense model or a TP_MoE model on an EP backend; an expert count the
    mesh does not divide; a slot batch the mesh does not divide."""
    with pytest.raises(ValueError, match="expert"):
        Engine(AutoLLM.from_config(tiny_qwen3(1), device="cpu"), max_seq=32, backend="ep",
               device="cpu")
    with pytest.raises(ValueError, match="moe_impl"):
        Engine(AutoLLM.from_config(tiny_qwen3_moe(1), device="cpu"), max_seq=32,
               backend="ep_flash", device="cpu")
    mesh2 = make_mesh(2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="divisible"):
        AutoLLM.from_config(tiny_qwen3_moe(2, num_experts=5), device="cpu", mesh=mesh2,
                            moe_impl="ep")
    model = AutoLLM.from_config(tiny_qwen3_moe(2, num_experts=6), device="cpu", mesh=mesh2,
                                moe_impl="ep", capacity_factor="dropless")
    eng = Engine(model, max_seq=32, backend="ep_flash", device="cpu")
    with pytest.raises(ValueError, match="batch"):
        eng.make_paged_slot_cache(3, page=8)
    with pytest.raises(ValueError, match="batch"):
        eng.make_slot_cache(3)
    assert eng.make_slot_cache(2) is not None


@pytest.mark.parametrize("case", ["fwd_ep_2d", "fwd_train", "slice_axis", "tp_impl_mesh",
                                  "moe_axis", "fused_block_i"])
def test_ep_unported_forms_raise(case):
    mesh = _mesh()
    lay = EP_MoE.init(torch.zeros(8, 8), torch.zeros(8, 8, 4), torch.zeros(8, 8, 4),
                      torch.zeros(8, 4, 8), mesh=mesh, top_k=2)
    x = torch.zeros(8, 8)
    calls = {
        "fwd_ep_2d": lambda: lay(x, "ep_2d"),
        "fwd_train": lambda: lay(x, "train"),
        "slice_axis": lambda: EP_MoE.init(torch.zeros(8, 8), torch.zeros(8, 8, 4),
                                          torch.zeros(8, 8, 4), torch.zeros(8, 4, 8),
                                          mesh=mesh, top_k=2, slice_axis="dcn"),
        # TP-MoE runs over a mesh; its training form waits
        "tp_impl_mesh": lambda: Qwen3MoE.random_init(tiny_qwen3_moe(4), device="cpu",
                                                     mesh=mesh).layers[0].moe(x, "train"),
        "moe_axis": lambda: Qwen3MoE.random_init(tiny_qwen3_moe(4), device="cpu", mesh=mesh,
                                                 moe_impl="ep", moe_axis="expert"),
        "fused_block_i": lambda: lay(x, "ep_fused", fused_block_i=128),
    }
    with pytest.raises(NotImplementedError, match="not yet ported"):
        calls[case]()
