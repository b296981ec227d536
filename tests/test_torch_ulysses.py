"""The port's Ulysses sequence parallelism (kernels.ulysses_dispatch,
ulysses_combine, gemm_all_to_all, qkv_gemm_a2a, o_a2a_gemm and
layers.UlyssesAttn) against the JAX package, on a mesh of four CPU ranks
(runtime.make_mesh(4, devices=["cpu"] * 4)) against a JAX mesh of the first
four CPU devices.

The JAX functions run as the JAX package's own tests run them: jitted,
their Pallas kernels (the all-to-all, the fused GEMM kernels) in interpret
mode; the kernels on a mesh with Auto axes, the layer on the default
Explicit axes that its "xla" oracle's `jax.reshard` needs. Every JAX call
runs once, in the module fixture `jax_uly`. The port runs on the CPU,
where its wrappers take their plain versions. Tolerances: the reshards
bitwise (they move bytes); the fused GEMMs in f32 within 1e-5 of the JAX
kernels (the same products summed in another order); the layer at the
JAX test's bound (tests/test_sp_layers.py, atol 2e-4 under "highest"
precision); the port's own modes, its carried weights and its dispatch
then combine bitwise where they run the same arithmetic.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, NamedSharding
from jax.sharding import PartitionSpec as P

from triton_dist_tpu.kernels.sp_attention import gemm_all_to_all as jax_gemm_all_to_all
from triton_dist_tpu.kernels.sp_attention import o_a2a_gemm as jax_o_a2a_gemm
from triton_dist_tpu.kernels.sp_attention import qkv_gemm_a2a as jax_qkv_gemm_a2a
from triton_dist_tpu.kernels.sp_attention import ulysses_combine as jax_ulysses_combine
from triton_dist_tpu.kernels.sp_attention import ulysses_dispatch as jax_ulysses_dispatch
from triton_dist_tpu.layers.common import precompute_rope as jax_precompute_rope
from triton_dist_tpu.layers.sp_attn import UlyssesAttn as JaxUlyssesAttn
from triton_dist_tpu_torch import kernels as K
from triton_dist_tpu_torch.layers import UlyssesAttn
from triton_dist_tpu_torch.layers.common import shard_cols_packed
from triton_dist_tpu_torch.runtime import make_mesh

N = 4
# the reshards: B, S, H, d
RB, RS, RH, RD = 2, 4 * N, 2 * N, 16
# the fused GEMMs: B, S, D (the model width), Nw (the projection's columns)
GB, GS, GD, GN = 2, 8 * N, 32, 16 * N
# the layer: JAX tests/test_sp_layers.py's tiny shape (B, S, D, hd), and
# (Hq, Hkv) with one q and kv head a rank, and a GQA pair with QK-norms
LB, LS, LD, LHD = 1, 16 * N, 128, 64
LAYERS = {"mha": (N, N, False), "gqa": (2 * N, N, True)}


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _shards(a, dim):
    return [t.contiguous() for t in _t(a).chunk(N, dim)]


def _jmesh(auto: bool):
    if len(jax.devices()) < N:
        pytest.skip(f"needs {N} JAX devices")
    kw = dict(axis_types=(AxisType.Auto,)) if auto else {}
    return jax.make_mesh((N,), ("sp",), devices=jax.devices()[:N], **kw)


def _mesh():
    return make_mesh(N, devices=["cpu"] * N)


def _gemm_inputs():
    rng = np.random.RandomState(1)
    x = rng.randn(GB, GS, GD).astype(np.float32) * 0.5
    w = rng.randn(GD, GN).astype(np.float32) * GD ** -0.5
    o = rng.randn(GB, GS, GN).astype(np.float32) * 0.5
    wo = rng.randn(GN, GD).astype(np.float32) * GN ** -0.5
    return x, w, o, wo


def _layer_inputs(kind):
    hq, hkv, norms = LAYERS[kind]
    rng = np.random.RandomState(5)
    sc = 0.5 / np.sqrt(LD)
    w = [(rng.randn(*s) * sc).astype(np.float32)
         for s in ((LD, hq * LHD), (LD, hkv * LHD), (LD, hkv * LHD), (hq * LHD, LD))]
    qn = (rng.rand(LHD) + 0.5).astype(np.float32) if norms else None
    kn = (rng.rand(LHD) + 0.5).astype(np.float32) if norms else None
    x = (rng.randn(LB, LS, LD) * 0.3).astype(np.float32)
    return w, qn, kn, x


@pytest.fixture(scope="module")
def jax_uly():
    """Every JAX call of this module, once (see the module docstring)."""
    amesh, emesh = _jmesh(True), _jmesh(False)
    out = {}
    rng = np.random.RandomState(0)
    x = rng.randn(RB, RS, RH, RD).astype(np.float32)
    out["dispatch"] = (x, np.asarray(jax.jit(lambda v: jax_ulysses_dispatch(v, mesh=amesh))(
        jax.device_put(x, NamedSharding(amesh, P(None, "sp", None, None))))))
    out["combine"] = (x, np.asarray(jax.jit(lambda v: jax_ulysses_combine(v, mesh=amesh))(
        jax.device_put(x, NamedSharding(amesh, P(None, None, "sp", None))))))
    gx, gw, go, gwo = _gemm_inputs()
    a = gx.reshape(GB * GS, GD)
    out["gemm_all_to_all"] = np.asarray(jax.jit(
        lambda u, v: jax_gemm_all_to_all(u, v, mesh=amesh))(
            jax.device_put(a, NamedSharding(amesh, P("sp", None))), gw))
    out["qkv_gemm_a2a"] = np.asarray(jax.jit(lambda u, v: jax_qkv_gemm_a2a(u, v, mesh=amesh))(
        jax.device_put(gx, NamedSharding(amesh, P(None, "sp", None))), gw))
    out["o_a2a_gemm"] = np.asarray(jax.jit(lambda u, v: jax_o_a2a_gemm(u, v, mesh=amesh))(
        jax.device_put(go, NamedSharding(amesh, P(None, None, "sp"))), gwo))
    cos, sin = jax_precompute_rope(LHD, LS)
    out["rope"] = (np.asarray(cos), np.asarray(sin))
    for kind, (hq, hkv, _) in LAYERS.items():
        w, qn, kn, xl = _layer_inputs(kind)
        lay = JaxUlyssesAttn.init(*w, mesh=emesh, n_heads=hq, n_kv_heads=hkv, head_dim=LHD,
                                  q_norm=qn, k_norm=kn)
        xs = jax.device_put(jnp.asarray(xl), NamedSharding(emesh, P(None, "sp", None)))
        out[kind, "arrays"] = tuple(None if t is None else np.asarray(t)
                                    for t in (lay.w_qkv, lay.w_o, lay.q_norm, lay.k_norm))
        modes = ("xla", "unfused", "fused") if kind == "mha" else ("xla",)
        with jax.default_matmul_precision("highest"):
            for mode in modes:
                y = jax.jit(functools.partial(lay.prefill, mode=mode))(xs, cos, sin)
                out[kind, mode] = np.asarray(jax.block_until_ready(y))
    return out


def test_ulysses_dispatch_matches_jax(jax_uly):
    """Sequence-sharded -> head-sharded over the all-to-all: rank r's
    result is the JAX result's head group r, bitwise."""
    x, want = jax_uly["dispatch"]
    got = K.ulysses_dispatch(_shards(x, 1), mesh=_mesh())
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g.numpy(), np.split(want, N, axis=2)[r])


def test_ulysses_combine_matches_jax(jax_uly):
    x, want = jax_uly["combine"]
    got = K.ulysses_combine(_shards(x, 2), mesh=_mesh())
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g.numpy(), np.split(want, N, axis=1)[r])


def test_ulysses_dispatch_then_combine_is_the_input():
    x = np.random.RandomState(2).randn(RB, RS, RH, RD).astype(np.float32)
    xs = _shards(x, 1)
    back = K.ulysses_combine(K.ulysses_dispatch(xs, mesh=_mesh()), mesh=_mesh())
    for a, b in zip(back, xs):
        assert torch.equal(a, b)


def test_gemm_all_to_all_matches_jax(jax_uly):
    """Rank j's [n, m, Nc]: slot p = rank p's rows times column chunk j
    (the JAX out spec P("sp") over [n * n, m, Nc])."""
    gx, gw, _, _ = _gemm_inputs()
    got = K.gemm_all_to_all(_shards(gx.reshape(GB * GS, GD), 0), [_t(gw)] * N, mesh=_mesh())
    want = jax_uly["gemm_all_to_all"]
    for r, g in enumerate(got):
        np.testing.assert_allclose(g.numpy(), want[r * N:(r + 1) * N], atol=1e-5, rtol=0)


def test_qkv_gemm_a2a_matches_jax(jax_uly):
    gx, gw, _, _ = _gemm_inputs()
    got = K.qkv_gemm_a2a(_shards(gx, 1), [_t(gw)] * N, mesh=_mesh())
    for r, g in enumerate(got):
        np.testing.assert_allclose(g.numpy(), np.split(jax_uly["qkv_gemm_a2a"], N, axis=2)[r],
                                   atol=1e-5, rtol=0)


def test_o_a2a_gemm_matches_jax(jax_uly):
    _, _, go, gwo = _gemm_inputs()
    got = K.o_a2a_gemm(_shards(go, 2), [_t(gwo)] * N, mesh=_mesh())
    for r, g in enumerate(got):
        np.testing.assert_allclose(g.numpy(), np.split(jax_uly["o_a2a_gemm"], N, axis=1)[r],
                                   atol=1e-5, rtol=0)


def test_fused_gemms_equal_their_unfused_chains():
    """qkv_gemm_a2a is the local product then the dispatch, o_a2a_gemm the
    combine then the local product: bitwise on the CPU for the first (the
    same product, moved), within f32 summation order for the second."""
    gx, gw, go, gwo = _gemm_inputs()
    mesh = _mesh()
    xs = _shards(gx, 1)
    fused = K.qkv_gemm_a2a(xs, [_t(gw)] * N, mesh=mesh)
    chain = K.ulysses_dispatch([(x @ _t(gw)).reshape(GB, GS // N, N, GN // N) for x in xs],
                               mesh=mesh)
    for a, b in zip(fused, chain):
        assert torch.equal(a, b.reshape(a.shape))
    os_ = _shards(go, 2)
    fused = K.o_a2a_gemm(os_, [_t(gwo)] * N, mesh=mesh)
    comb = K.ulysses_combine([o.reshape(GB, GS, 1, GN // N) for o in os_], mesh=mesh)
    for a, c in zip(fused, comb):
        torch.testing.assert_close(a, c.reshape(GB, GS // N, GN) @ _t(gwo), atol=1e-5, rtol=0)


def _port_layer(kind, mesh):
    hq, hkv, _ = LAYERS[kind]
    w, qn, kn, x = _layer_inputs(kind)
    lay = UlyssesAttn.init(*(_t(a) for a in w), mesh=mesh, n_heads=hq, n_kv_heads=hkv,
                           head_dim=LHD, q_norm=None if qn is None else _t(qn),
                           k_norm=None if kn is None else _t(kn))
    return lay, _shards(x, 1)


@pytest.mark.parametrize("mode", ["fused", "unfused", "xla"])
@pytest.mark.parametrize("kind", ["mha", "gqa"])
def test_ulysses_attn_prefill_matches_jax(jax_uly, kind, mode):
    """Every mode of the port's layer against the JAX layer's same mode
    (the one-head-a-rank shape) or its "xla" oracle (GQA with QK-norms),
    from the same numpy weights, at the JAX test's atol 2e-4."""
    mesh = _mesh()
    lay, xs = _port_layer(kind, mesh)
    cos, sin = (_t(a) for a in jax_uly["rope"])
    got = lay.prefill(xs, cos, sin, mode=mode)
    want = jax_uly[kind, mode if (kind, mode) in jax_uly else "xla"]
    assert len(got) == N
    for r, g in enumerate(got):
        np.testing.assert_allclose(g.numpy(), np.split(want, N, axis=1)[r], atol=2e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("kind", ["mha", "gqa"])
def test_ulysses_attn_from_jax_arrays(jax_uly, kind):
    """The JAX layer's packed arrays carried as they are: the port's
    packing equals them bitwise, and the carried layer's prefill equals
    the one built from the numpy weights, bitwise, in every mode."""
    mesh = _mesh()
    hq, hkv, _ = LAYERS[kind]
    lay, xs = _port_layer(kind, mesh)
    w_qkv, w_o, qn, kn = jax_uly[kind, "arrays"]
    carried = UlyssesAttn.from_jax_arrays(w_qkv, w_o, qn, kn, mesh=mesh, n_heads=hq,
                                          n_kv_heads=hkv, head_dim=LHD)
    assert torch.equal(carried.w_qkv[0], lay.w_qkv[0]) and torch.equal(carried.w_o[2], lay.w_o[2])
    cos, sin = (_t(a) for a in jax_uly["rope"])
    for mode in ("fused", "unfused", "xla"):
        for a, b in zip(carried.prefill(xs, cos, sin, mode=mode),
                        lay.prefill(xs, cos, sin, mode=mode)):
            assert torch.equal(a, b)


def test_ulysses_attn_modes_agree():
    """fused and unfused run the same products and attention on the CPU:
    within f32 summation order of each other and of the oracle."""
    mesh = _mesh()
    lay, xs = _port_layer("gqa", mesh)
    cos, sin = (_t(a) for a in jax_precompute_rope(LHD, LS))
    outs = {m: lay.prefill(xs, cos, sin, mode=m) for m in ("fused", "unfused", "xla")}
    for m in ("fused", "unfused"):
        for a, b in zip(outs[m], outs["xla"]):
            torch.testing.assert_close(a, b, atol=2e-5, rtol=0)


def test_ulysses_pack_and_gates():
    """init packs [q | k | v] head-group-major (shard_cols_packed); heads
    that do not split over the ranks, an unknown mode and the training
    forms raise."""
    mesh = _mesh()
    w, _, _, _ = _layer_inputs("gqa")
    lay = UlyssesAttn.init(*(_t(a) for a in w), mesh=mesh, n_heads=2 * N, n_kv_heads=N,
                           head_dim=LHD)
    assert torch.equal(lay.w_qkv[1], shard_cols_packed([_t(a) for a in w[:3]], N))
    with pytest.raises(ValueError, match="split"):
        UlyssesAttn.init(*(_t(a) for a in w), mesh=make_mesh(3, devices=["cpu"] * 3),
                         n_heads=2 * N, n_kv_heads=N, head_dim=LHD)
    with pytest.raises(ValueError, match="mode"):
        lay.prefill([torch.zeros(1, 4, LD)] * N, None, None, mode="ring")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        lay.fwd_train(None, None, None)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        K.sp_attention.sp_ring_attention_train()
