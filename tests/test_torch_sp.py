"""The port's sequence-parallel slice (kernels.sp_combine_partials,
kv_cache_scatter, sp_flash_decode, sp_ring_attention in its three modes,
layers.SPAttn, PageAllocator(shards=), the sharded PagedSlotCache and the
paged SP attend, DenseLLM(sp_axis="sp") served by Engine and
ContinuousScheduler(paged=True)) against the JAX package, on a mesh of
four CPU ranks (runtime.make_mesh(4, devices=["cpu"] * 4)) against a
four-device JAX mesh with Auto axes, ("tp"=1, "sp"=4) or ("sp"=4).

Each JAX call of the tier-1 tests runs once, jitted, in the module
fixture `jax_sp`: the XLA modes and the plain references (ring attention
"ring" and sp_ring_attention_ref, the combine's lse_combine,
sp_flash_decode "xla" and its ref, the replicated SPAttn oracle of the
JAX layer tests, the registry specs' draws and refs), one layer's paged
SP attend (its partial kernel interpreted, no cross-device wait), and the
JAX scheduler's streams on its plain backend. The JAX Pallas comm kernels
(interpreted, their semaphore waits can abort a loaded host's
interpreter) run in the slow arm test_sp_jax_comm_kernels. The port runs on the CPU, where
its wrappers take their plain versions. Tolerances: f32 within 1e-5 of (1
+ the largest JAX value) (the same sums in another order); the layer and
the model within 1e-4 (the JAX package's own model bound); the scatter,
the allocator's ids and the streams of the port's topologies bitwise; the
port's streams against the JAX scheduler's by the teacher-forced margin
rule of tests/test_torch_serving.py. The JAX sp=4 scheduler itself (its
paged partial interpreted in every tick, about two minutes) is the other
slow arm.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, NamedSharding
from jax.sharding import PartitionSpec as P

from triton_dist_tpu.kernels import kernel_registry as jax_kernel_registry
from triton_dist_tpu.kernels.flash_attn import lse_combine as jax_lse_combine
from triton_dist_tpu.kernels.sp_attention import sp_ring_attention as jax_sp_ring_attention
from triton_dist_tpu.kernels.sp_attention import \
    sp_ring_attention_ref as jax_sp_ring_attention_ref
from triton_dist_tpu.kernels.sp_flash_decode import kv_cache_scatter as jax_kv_cache_scatter
from triton_dist_tpu.kernels.sp_flash_decode import sp_flash_decode as jax_sp_flash_decode
from triton_dist_tpu.kernels.sp_flash_decode import \
    sp_flash_decode_ref as jax_sp_flash_decode_ref
from triton_dist_tpu.layers.common import precompute_rope as jax_precompute_rope
from triton_dist_tpu.layers.sp_attn import SPAttn as JaxSPAttn
from triton_dist_tpu.models import AutoLLM as JaxAutoLLM
from triton_dist_tpu.models import ContinuousScheduler as JaxScheduler
from triton_dist_tpu.models import Engine as JaxEngine
from triton_dist_tpu.models import Request as JaxRequest
from triton_dist_tpu.models.config import tiny_qwen3 as jax_tiny_qwen3
from triton_dist_tpu.models.prefix_cache import RefcountedPages as JaxRefcountedPages
from triton_dist_tpu_torch import kernels as K
from triton_dist_tpu_torch.layers import SPAttn
from triton_dist_tpu_torch.layers.common import precompute_rope
from triton_dist_tpu_torch.layers.tp_attn import sp_paged_context
from triton_dist_tpu_torch.models import (AutoLLM, ContinuousScheduler, DenseLLM, Engine,
                                          PagedSlotCache, Request, tiny_qwen3)
from triton_dist_tpu_torch.models.convert import from_jax_arrays
from triton_dist_tpu_torch.models.prefix_cache import RefcountedPages
from triton_dist_tpu_torch.runtime import make_mesh
from triton_dist_tpu_torch.tools.sp_check import SP_SPECS
from test_torch_engine import _jax_arrays

N = 4
# ring attention: B, positions, query and kv heads (GQA rep 2), head dim
RB, RS, RHQ, RHKV, RD = 1, 8 * N, 4, 2, 64
# SPAttn: JAX tests/test_sp_layers.py:50-85's shapes
LB, LS, LD, LHQ, LHKV, LHD, LT = 1, 16 * N, 128, 8, 4, 64, 32 * N
# the paged SP attend: slots, page, pages per shard, table width
PB, PAGE, PPS, MAXP = 3, 4, 16, 6
# serving: the slot capacity, slots, chunk, page
MAX_SEQ, BATCH, CHUNK, SPAGE = 64, 2, 2, 8


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rel=1e-5):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    err = np.abs(g - w).max()
    assert err <= rel * (1 + np.abs(w).max()), f"max|d| {err}"


def _jmesh(two_axes: bool):
    if len(jax.devices()) < N:
        pytest.skip(f"needs {N} JAX devices")
    if two_axes:
        return jax.make_mesh((1, N), ("tp", "sp"), axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:N])
    return jax.make_mesh((N,), ("sp",), axis_types=(AxisType.Auto,), devices=jax.devices()[:N])


def _mesh():
    return make_mesh(N, devices=["cpu"] * N)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _shards(a, dim):
    return [t.contiguous() for t in _t(a).chunk(N, dim)]


def _ring_inputs():
    rng = np.random.RandomState(1)
    return (rng.randn(RB, RS, RHQ, RD).astype(np.float32) * 0.5,
            rng.randn(RB, RHKV, RS, RD).astype(np.float32) * 0.5,
            rng.randn(RB, RHKV, RS, RD).astype(np.float32) * 0.5)


def _layer_weights():
    rng = np.random.RandomState(0)
    sc = 0.5 / np.sqrt(LD)
    return [(rng.randn(*s) * sc).astype(np.float32)
            for s in ((LD, LHQ * LHD), (LD, LHKV * LHD), (LD, LHKV * LHD), (LHQ * LHD, LD))]


def _layer_inputs():
    rng = np.random.RandomState(3)
    return (rng.randn(LB, LS, LD).astype(np.float32) * 0.3,
            rng.randn(LB, 1, LD).astype(np.float32) * 0.3)


def _paged_inputs(cfg):
    """A shuffled pool of N * PPS pages, a table whose streams spread
    over the shards (slot 2 retired on the trash page 0), new rows at
    positions pos, x [PB, D]."""
    rng = np.random.RandomState(4)
    Hkv, hd = cfg.num_kv_heads, cfg.head_dim
    NP = N * PPS
    pk = (rng.randn(NP, 1, PAGE, hd) * 0.5).astype(np.float32)
    pv = (rng.randn(NP, 1, PAGE, hd) * 0.5).astype(np.float32)
    ids = rng.permutation(np.arange(1, NP))[:2 * Hkv * MAXP]
    table = np.zeros((PB * Hkv, MAXP), np.int32)
    table[:2 * Hkv] = ids.reshape(2 * Hkv, MAXP)
    pos = np.asarray([13, 22, 5], np.int32)
    x = (rng.randn(PB, cfg.hidden_size) * 0.5).astype(np.float32)
    return pk, pv, table, pos, x


def _scatter_inputs():
    """S = 8N new positions into a T = 32N cache: only rank 0's window fills."""
    rng = np.random.RandomState(6)
    return (rng.randn(1, 2, 32 * N, 128).astype(np.float32),
            rng.randn(1, 2, 8 * N, 128).astype(np.float32))


def _requests(cls, vocab):
    """Four requests, two sharing a 6-token prefix."""
    rng = np.random.RandomState(0)
    prefix = rng.randint(0, vocab, size=(6,)).astype(np.int32)
    out = []
    for i, (L, g) in enumerate([(5, 5), (9, 6), (3, 4), (12, 5)]):
        ids = rng.randint(0, vocab, size=(L,)).astype(np.int32)
        if i % 2:
            ids = np.concatenate([prefix, ids]).astype(np.int32)
        out.append(cls(rid=i, ids=ids, gen_len=g))
    return out


def _jax_layer_oracle(x):
    """The JAX package's replicated oracle of SPAttn (tests/test_sp_layers.py
    `_oracle_layer_out`) on the layer's weights: the output [B, S, D] and
    the cache rows K, V [B, Hkv, S, hd] it writes."""
    from triton_dist_tpu.layers.common import apply_rope as jax_apply_rope
    wq, wk, wv, wo = (jnp.asarray(w) for w in _layer_weights())
    cos, sin = jax_precompute_rope(LHD, LT)
    B, S, _ = x.shape
    x = jnp.asarray(x)
    q = (x @ wq).reshape(B, S, LHQ, LHD)
    k = (x @ wk).reshape(B, S, LHKV, LHD)
    v = (x @ wv).reshape(B, S, LHKV, LHD)
    pos = jnp.arange(S)
    q, k = jax_apply_rope(q, cos, sin, pos), jax_apply_rope(k, cos, sin, pos)
    kT, vT = k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)
    o = jax_sp_ring_attention_ref(q, kT, vT, causal=True)
    return np.asarray(o.reshape(B, S, LHQ * LHD) @ wo), np.asarray(kT), np.asarray(vT)


def _registry_mesh():
    return jax.make_mesh((N,), ("tp",), axis_types=(AxisType.Auto,), devices=jax.devices()[:N])


@pytest.fixture(scope="module")
def jax_sp():
    """Every JAX call of the tier-1 tests of this module, once: the XLA
    modes and the plain (jnp) references; no Pallas kernel that waits on a
    peer (those, interpreted, run in the slow test_sp_jax_comm_kernels)."""
    smesh, mesh2 = _jmesh(False), _jmesh(True)
    out = {}
    q, k, v = (jnp.asarray(a) for a in _ring_inputs())
    for causal in (True, False):
        out["ref", causal] = np.asarray(jax_sp_ring_attention_ref(q, k, v, causal=causal))
        out["ring", causal] = np.asarray(jax.jit(lambda a, b, c, cz=causal:
                                                 jax_sp_ring_attention(
                                                     a, b, c, mesh=smesh, mode="ring",
                                                     causal=cz))(q, k, v))
    # sp_flash_decode, combine "xla": B=2 decode at kv_len 100 of T=128
    rng = np.random.RandomState(2)
    dq = rng.randn(2, 1, 4, 64).astype(np.float32) * 0.5
    dk = rng.randn(2, 2, 128, 64).astype(np.float32) * 0.5
    dv = rng.randn(2, 2, 128, 64).astype(np.float32) * 0.5
    out["decode"] = (dq, dk, dv, np.asarray(jax.jit(lambda a, b, c: jax_sp_flash_decode(
        a, b, c, 100, mesh=smesh, combine="xla"))(dq, dk, dv)))
    out["decode per slot"] = np.asarray(jax_sp_flash_decode_ref(
        dq, dk, dv, jnp.asarray([7, 100], jnp.int32)))
    # the registry's SP specs: their draws, and each one's plain reference
    reg = jax_kernel_registry()
    for name in SP_SPECS:
        _, args = reg[name].build(_registry_mesh())
        a = [np.asarray(t) for t in args]
        if name == "sp_flash_decode_dist":
            want = jax_sp_flash_decode_ref(*args, a[1].shape[2])
        elif name == "kv_cache_scatter":
            want = np.concatenate([a[1], a[0][:, :, a[1].shape[2]:]], 2)
        else:
            want = jax_sp_ring_attention_ref(*args)
        out[name] = (a, np.asarray(want))
    # SPAttn: the replicated oracle over the prompt, then over prompt + one token
    x, xn = _layer_inputs()
    with jax.default_matmul_precision("highest"):
        out["layer"] = (_jax_layer_oracle(x), _jax_layer_oracle(np.concatenate([x, xn], 1)))
    # the paged SP attend: layer 0 of the sp=4 model, mode "flash", "xla" combine
    cfg = jax_tiny_qwen3(N)
    jm = JaxAutoLLM.from_config(cfg, mesh2, seed=0, sp_axis="sp")
    j1 = JaxAutoLLM.from_config(cfg, jax.make_mesh((1,), ("tp",), axis_types=(AxisType.Auto,),
                                                   devices=jax.devices()[:1]), seed=0)
    out["arrays"], out["arrays sp1"] = _jax_arrays(jm), _jax_arrays(j1)
    pk, pv, table, pos, xp = _paged_inputs(cfg)
    pool_spec = NamedSharding(mesh2, P("sp", None, None, None))
    with jax.default_matmul_precision("highest"):
        y, kv = jax.jit(lambda a, b, c, t, p: jm.layers[0].attn.fwd_cached_slots_paged_sp(
            a, jm.cos, jm.sin, PB, (b, c), t, p, "sp", "flash", "xla"))(
                jnp.asarray(xp), jax.device_put(pk, pool_spec), jax.device_put(pv, pool_spec),
                jnp.asarray(table), jnp.asarray(pos))
    out["attend"] = (np.asarray(y), np.asarray(kv[0]), np.asarray(kv[1]))
    # the JAX scheduler's streams, one rank, plain backend (the JAX package
    # holds its sp=4 scheduler to these bitwise, tests/test_sp_serving.py)
    eng = JaxEngine(j1, max_seq=MAX_SEQ, backend="xla")
    sched = JaxScheduler(eng, batch=BATCH, chunk=CHUNK, paged=True, page=SPAGE)
    out["streams"] = sched.run(_requests(JaxRequest, cfg.vocab_size))
    return out


@pytest.mark.parametrize("combine", ["xla", "dist"])
def test_sp_combine_partials(combine):
    """Both modes' plain versions against the JAX lse_combine of the
    gathered partials; a row that owns no key on one rank, and a row
    that owns none anywhere (it gives 0, not NaN)."""
    rng = np.random.RandomState(5)
    B, S, Hq, d = 2, 3, 4, 64
    acc = rng.randn(N, B, S, Hq, d).astype(np.float32)
    m = rng.randn(N, B, S, Hq).astype(np.float32)
    l = (np.abs(rng.randn(N, B, S, Hq)) + 0.1).astype(np.float32)
    acc[1, 0, 0], m[1, 0, 0], l[1, 0, 0] = 0.0, -1e30, 0.0
    acc[:, 1, 2], m[:, 1, 2], l[:, 1, 2] = 0.0, -1e30, 0.0
    want = np.asarray(jax_lse_combine(jnp.asarray(acc), jnp.asarray(m), jnp.asarray(l)))
    outs = K.sp_combine_partials([_t(a) for a in acc], [_t(a) for a in m], [_t(a) for a in l],
                                 mesh=_mesh(), combine=combine)
    assert len(outs) == N
    for o in outs:
        assert torch.isfinite(o).all()
        assert (o[1, 2] == 0).all()
        valid = np.ones((B, S, Hq), bool)
        valid[1, 2] = False
        _close(o.numpy()[valid], want[valid])


def test_kv_cache_scatter():
    """Bitwise: positions [0, S) overwritten with the new blocks, the rest
    (three windows receive nothing) as they were (the JAX kernel's
    contract, tests/test_sp_decode.py)."""
    old, new = _scatter_inputs()
    cache = _shards(old, 2)
    out = K.kv_cache_scatter(cache, _shards(new, 2), mesh=_mesh())
    assert all(o is c for o, c in zip(out, cache))       # in place
    got = torch.cat(out, 2).numpy()
    np.testing.assert_array_equal(got[:, :, :new.shape[2]], new)
    np.testing.assert_array_equal(got[:, :, new.shape[2]:], old[:, :, new.shape[2]:])


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("mode", ["ring", "ag", "ring_shmem"])
def test_sp_ring_attention(jax_sp, mode, causal):
    """Each mode over the four ranks against the JAX ring (XLA permutes)
    and the JAX full-tensor oracle, GQA rep 2 (the JAX "ag" mode, with its
    interpreted all-gather kernel, in test_sp_jax_comm_kernels)."""
    q, k, v = _ring_inputs()
    out = K.sp_ring_attention(_shards(q, 1), _shards(k, 2), _shards(v, 2), mesh=_mesh(),
                              mode=mode, causal=causal)
    got = torch.cat(out, 1)
    _close(got, jax_sp["ring", causal])
    _close(got, jax_sp["ref", causal])
    _close(got, K.sp_ring_attention_ref(_t(q), _t(k), _t(v), causal=causal))


@pytest.mark.parametrize("form", ["scalar", "per_slot"])
def test_sp_flash_decode(jax_sp, form):
    """Scalar kv_len against the JAX op (combine "xla"), per-slot lengths
    (one short slot on rank 0's window alone) against the JAX oracle; both
    combines, every rank's copy."""
    dq, dk, dv, want = jax_sp["decode"]
    lens = 100 if form == "scalar" else torch.tensor([7, 100], dtype=torch.int32)
    want = want if form == "scalar" else jax_sp["decode per slot"]
    for combine in ("xla", "dist"):
        outs = K.sp_flash_decode([_t(dq)] * N, _shards(dk, 2), _shards(dv, 2), lens,
                                 mesh=_mesh(), combine=combine)
        for o in outs:
            _close(o, want)


def _expect_args(name, jargs):
    """The JAX spec's draws as the port's per-rank args."""
    if name == "sp_flash_decode_dist":
        return [jargs[0]] * N + np.split(jargs[1], N, 2) + np.split(jargs[2], N, 2)
    if name == "kv_cache_scatter":
        return np.split(jargs[0], N, 2) + np.split(jargs[1], N, 2)
    return np.split(jargs[0], N, 1) + np.split(jargs[1], N, 2) + np.split(jargs[2], N, 2)


def _spec_out(name, outs):
    """The port's per-rank outputs as the JAX op's global one."""
    if name == "sp_flash_decode_dist":
        return outs
    return [torch.cat(outs, 1 if name == "sp_ring_shmem" else 2)]


@pytest.mark.parametrize("name", SP_SPECS)
def test_registry_sp_specs_match_jax(jax_sp, name):
    """The port's SP specs draw the JAX specs' inputs (rank r's tensors
    are JAX's shard r), and their calls equal the JAX op's plain reference
    (sp_flash_decode_ref, the scatter's contract, sp_ring_attention_ref);
    the JAX kernels themselves in test_sp_jax_comm_kernels."""
    spec = K.kernel_registry()[name]
    jspec = jax_kernel_registry()[name]
    assert (spec.module, spec.kind, spec.min_devices) == (jspec.module, jspec.kind, 2)
    assert bool(spec.inplace) == bool(jspec.inplace)
    fn, args = spec.build(_mesh())
    jargs, want = jax_sp[name]
    for a, e in zip(args, _expect_args(name, jargs)):
        np.testing.assert_array_equal(a.numpy(), e)
    for o in _spec_out(name, fn(*args)):
        _close(o, want)


def _port_layer(mesh):
    wq, wk, wv, wo = (_t(w) for w in _layer_weights())
    return SPAttn.init(wq, wk, wv, wo, mesh=mesh, n_heads=LHQ, n_kv_heads=LHKV, head_dim=LHD)


@pytest.mark.parametrize("mode", ["ring", "ag", "ring_shmem"])
def test_sp_attn_prefill_then_decode(jax_sp, mode):
    """SPAttn on the JAX layer test's weights and shapes: the prefill's
    output and cache windows, then one decode step of each combine,
    against the JAX package's replicated oracle (tests/test_sp_layers.py)
    over the prompt and over prompt + token; the JAX layer itself in
    test_sp_jax_comm_kernels."""
    (o1, k1, v1), (o2, k2, v2) = jax_sp["layer"]
    mesh = _mesh()
    lay = _port_layer(mesh)
    cos, sin = precompute_rope(LHD, LT)
    x, xn = _layer_inputs()
    ck, cv = lay.alloc_cache(LB, LT, dtype=torch.float32)
    out, ck, cv, L = lay.prefill(_shards(x, 1), cos, sin, ck, cv, mode=mode)
    assert L == LS
    _close(torch.cat(out, 1), o1, 1e-4)
    _close(torch.cat(ck, 2)[:, :, :LS], k1, 1e-4)
    _close(torch.cat(cv, 2)[:, :, :LS], v1, 1e-4)
    assert not torch.cat(ck, 2)[:, :, LS:].any()
    for combine in ("xla", "dist"):
        kk, vv = [c.clone() for c in ck], [c.clone() for c in cv]
        dec, kk, vv, L2 = lay.decode([_t(xn)] * N, cos, sin, kk, vv, L, combine=combine)
        assert L2 == LS + 1
        for o in dec:
            _close(o[:, 0], o2[:, -1], 1e-4)
        _close(torch.cat(kk, 2)[:, :, :LS + 1], k2, 1e-4)
        _close(torch.cat(vv, 2)[:, :, :LS + 1], v2, 1e-4)


def test_page_allocator_shards():
    """RefcountedPages(shards=4) hands out the JAX pool's page ids over a
    seeded alloc / retain / release sequence, rotating across the shards
    and conserving pages per shard."""
    rng = np.random.RandomState(6)
    pools = (RefcountedPages(N * 8, 2, shards=N), JaxRefcountedPages(N * 8, 2, shards=N))
    live = [[], []]
    for step in range(120):
        op = rng.rand()
        for pool, groups in zip(pools, live):
            if op < 0.5 and pool.available >= 2:
                groups.append(pool.alloc_group())
            elif op < 0.7 and groups:
                pool.retain(groups[step % len(groups)])
                pool.release(groups[step % len(groups)])
            elif groups:
                pool.release(groups.pop(int(op * 1000) % len(groups)))
        assert [g.tolist() for g in live[0]] == [g.tolist() for g in live[1]]
        assert pools[0].pages_in_use_by_shard == pools[1].pages_in_use_by_shard
        assert all(a + o == pools[0].pages_per_shard for a, o in
                   zip(pools[0].available_by_shard, pools[0].outstanding_by_shard))
    assert pools[0].trash == 0 and {int(p) // 8 for g in live[0] for p in g} != {0}
    with pytest.raises(ValueError, match="divide"):
        K.PageAllocator(31, shards=N)


def test_paged_sp_attend(jax_sp):
    """Layer 0's paged SP attend on the carried weights against the JAX
    layer's: the live slots' outputs and every page of the pool but the
    trash after the new rows' writes, each combine. Slot 2 is retired on
    the trash page, where its kv heads' rows collide (its output is
    discarded, as the scheduler discards it)."""
    cfg = tiny_qwen3(N)
    y_j, pk_j, pv_j = jax_sp["attend"]
    pk, pv, table, pos, x = _paged_inputs(cfg)
    mesh = _mesh()
    model = from_jax_arrays(cfg, jax_sp["arrays"], device="cpu")
    for combine in ("xla", "dist"):
        pc = PagedSlotCache.create(1, PB, MAXP * PAGE, cfg.num_kv_heads, cfg.head_dim,
                                   page=PAGE, num_pages=N * PPS, device="cpu",
                                   dtype=torch.float32, mesh=mesh, sp=True)
        assert (pc.sp, pc.pages_per_shard, pc.num_pages) == (N, PPS, N * PPS)
        for r, part in enumerate(pc.parts()):
            part.pages_k[0][:PPS] = _t(pk[r * PPS:(r + 1) * PPS])
            part.pages_v[0][:PPS] = _t(pv[r * PPS:(r + 1) * PPS])
        pc.device_tables()[0][:] = torch.from_numpy(table)
        ctx = sp_paged_context(mesh, pc, torch.from_numpy(pos))
        y, _ = model.layers[0].attn.fwd_cached_slots_paged_sp(
            [_t(x)], [model.cos], [model.sin], PB, pc.layer(0), ctx, mesh, "flash", combine)
        _close(y[0][:2], y_j[:2], 1e-4)
        for r, part in enumerate(pc.parts()):
            lo = int(r == 0)                                  # past the trash page
            _close(part.pages_k[0][lo:PPS], pk_j[r * PPS + lo:(r + 1) * PPS], 1e-4)
            _close(part.pages_v[0][lo:PPS], pv_j[r * PPS + lo:(r + 1) * PPS], 1e-4)


def test_convert_sp_model(jax_sp):
    """A JAX model built over ("tp"=1, "sp"=4) carries its weights whole:
    every array equals the one-rank JAX model's of the same seed, and the
    carried port model keeps one copy on the one device of its mesh."""
    a4, a1 = jax_sp["arrays"], jax_sp["arrays sp1"]
    assert sorted(a4) == sorted(a1)
    for name in a4:
        np.testing.assert_array_equal(a4[name], a1[name])
    cfg = tiny_qwen3(N)
    m4 = from_jax_arrays(cfg, a4, mesh=_mesh(), sp_axis="sp", sp_combine="dist")
    assert (m4.sp_size, m4.tp, m4.sp_combine) == (N, 1, "dist")
    assert len(m4.sp_layers) == 1 and m4.sp_layers[0] is m4.layers
    np.testing.assert_array_equal(m4.layers[0].attn.w_qkv.numpy(), a4["layers.0.attn.w_qkv"])


def _streams(model, reqs, **kw):
    ekw = {k: kw.pop(k) for k in ("kv_dtype",) if k in kw}
    eng = Engine(model, max_seq=MAX_SEQ, backend="flash", device="cpu", **ekw)
    sched = ContinuousScheduler(eng, batch=BATCH, chunk=CHUNK, paged=True, page=SPAGE, **kw)
    return sched.run([dataclasses.replace(r) for r in reqs]), sched


def _per_shard_conserved(sched):
    pool = sched.slots.prefix.pool
    return all(a + o == pool.pages_per_shard
               for a, o in zip(pool.available_by_shard, pool.outstanding_by_shard))


@pytest.mark.parametrize("arm", ["prefix", "dist", "int8", "preempt", "chunked", "spec"])
def test_sp_serving_equals_one_rank(jax_sp, arm):
    """Engine + ContinuousScheduler(paged=True) at sp=4 on the carried
    tiny model: every stream equal to the port's one-rank engine's
    (prefix sharing; sp_combine "dist" against "xla"; an int8 pool;
    preemption under a pool of about one worst-case slot; chunked
    prefill and speculative decoding, the window forms of the SP attend);
    the one-rank streams held to the JAX scheduler's."""
    cfg = tiny_qwen3(N)
    mesh = _mesh()
    one = from_jax_arrays(cfg, jax_sp["arrays"], device="cpu")
    sp = from_jax_arrays(cfg, jax_sp["arrays"], mesh=mesh, sp_axis="sp",
                         sp_combine="dist" if arm == "dist" else "xla")
    reqs = _requests(Request, cfg.vocab_size)
    kw = {"int8": dict(kv_dtype=torch.int8),
          # one worst-case slot (3 groups of 4 pages) and a spare group,
          # plus the trash, rounded to the shards: two slots preempt
          "preempt": dict(num_pages=20),
          "chunked": dict(prefill_budget=4),
          "spec": dict(spec=2)}.get(arm, {})
    base, _ = _streams(one, reqs, **dict(kw))
    got, sched = _streams(sp, reqs, **dict(kw))
    for r in reqs:
        assert len(got[r.rid]) == r.gen_len
        np.testing.assert_array_equal(got[r.rid], base[r.rid], err_msg=f"rid {r.rid}")
    st = sched.stats()
    assert st["sp_size"] == N and len(st["sp_pages_resident"]) == N
    assert _per_shard_conserved(sched)
    if arm == "prefix":
        assert st["hits"] > 0
        assert st["device_wait_s_by_kind"]["sp_combine"] > 0
    if arm == "preempt":
        assert st["preemptions"] > 0 and not sched.rejected
    if arm == "prefix":
        want = jax_sp["streams"]
        for r in reqs:
            # margin rule: the port's plain model fed the JAX tokens
            logits, cache = one.forward_tokens(torch.from_numpy(r.ids).long()[None],
                                               one.make_cache(1, MAX_SEQ))
            for t in range(r.gen_len):
                lg = logits[0].numpy()
                top2 = np.sort(lg)[-2:]
                if top2[1] - top2[0] <= 2e-4 * (1 + np.abs(lg).max()):
                    break
                assert got[r.rid][t] == want[r.rid][t] == np.argmax(lg), (r.rid, t)
                logits, cache = one.forward_tokens(torch.tensor([[int(want[r.rid][t])]]), cache)


def test_sp_idle_residency_and_capacity(jax_sp):
    """With the prefix cache off, every shard's residency is 0 at idle;
    and the capacity case of the JAX package (tests/test_sp_serving.py
    :127): a context whose footprint one rank's pool rejects up front is
    admitted at sp=4 on four such pools, its stream equal to one rank's
    on a pool of the same total size."""
    cfg = tiny_qwen3(N)
    one = from_jax_arrays(cfg, jax_sp["arrays"], device="cpu")
    sp = from_jax_arrays(cfg, jax_sp["arrays"], mesh=_mesh(), sp_axis="sp")
    _, sched = _streams(sp, _requests(Request, cfg.vocab_size), prefix_cache=False)
    assert sched.stats()["sp_pages_resident"] == [0] * N
    Hkv, page = cfg.num_kv_heads, 8
    chip_pages = 4 * Hkv + Hkv
    long_req = Request(rid="long", ids=(np.arange(40) % cfg.vocab_size).astype(np.int32),
                       gen_len=8)

    def run(model, num_pages):
        eng = Engine(model, max_seq=MAX_SEQ, backend="flash", device="cpu")
        s = ContinuousScheduler(eng, batch=1, paged=True, chunk=2, page=page,
                                num_pages=num_pages)
        return s.run([dataclasses.replace(long_req)]), s

    out1, s1 = run(one, chip_pages)
    assert len(out1["long"]) == 0 and "exceeds" in s1.rejected["long"]
    out4, s4 = run(sp, chip_pages * N)
    assert len(out4["long"]) == 8 and _per_shard_conserved(s4)
    outb, _ = run(one, chip_pages * N)
    np.testing.assert_array_equal(out4["long"], outb["long"])


def test_sp_construction_gates():
    """The JAX engine's refusals, by the capability they name."""
    cfg = tiny_qwen3(N)
    mesh = _mesh()
    sp = AutoLLM.from_config(cfg, device="cpu", mesh=mesh, sp_axis="sp")
    assert isinstance(sp, DenseLLM) and sp.sp_size == N
    with pytest.raises(ValueError, match="mega"):
        Engine(sp, max_seq=MAX_SEQ, backend="mega", device="cpu")
    with pytest.raises(ValueError, match="flash"):
        Engine(sp, max_seq=MAX_SEQ, backend="gemm_ar", device="cpu")
    eng = Engine(sp, max_seq=MAX_SEQ, backend="flash", device="cpu")
    with pytest.raises(ValueError, match="contiguous"):
        eng.make_slot_cache(2)
    with pytest.raises(ValueError, match="divisible by the sp"):
        eng.make_paged_slot_cache(1, page=8, num_pages=N * 7 + 1)
    with pytest.raises(ValueError, match="divisible by the sp"):
        PagedSlotCache.create(1, 1, MAX_SEQ, cfg.num_kv_heads, cfg.head_dim, page=8,
                              num_pages=N * 3 + 1, device="cpu", mesh=mesh, sp=True)
    assert eng.make_paged_slot_cache(2, page=8).num_pages % N == 0
    with pytest.raises(ValueError, match="already split"):
        sp.to_mesh(mesh, "sp")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        K.sp_attention.sp_ring_attention_train()


@pytest.mark.slow
def test_sp_serving_against_jax_sp4(jax_sp):
    """The JAX scheduler at sp=4 (its paged partial interpreted in every
    tick, about a minute) against the port's sp=4 streams: the
    streams equal, token for token."""
    cfg = jax_tiny_qwen3(N)
    jm = JaxAutoLLM.from_config(cfg, _jmesh(True), seed=0, sp_axis="sp")
    eng = JaxEngine(jm, max_seq=MAX_SEQ, backend="flash")
    want = JaxScheduler(eng, batch=BATCH, chunk=CHUNK, paged=True, page=SPAGE).run(
        _requests(JaxRequest, cfg.vocab_size))
    sp = from_jax_arrays(tiny_qwen3(N), jax_sp["arrays"], mesh=_mesh(), sp_axis="sp")
    got, _ = _streams(sp, _requests(Request, cfg.vocab_size))
    for rid, w in want.items():
        np.testing.assert_array_equal(got[rid], np.asarray(w))


@pytest.mark.slow
def test_sp_jax_comm_kernels():
    """The JAX package's Pallas SP comm kernels, interpreted (their
    semaphore waits can abort a loaded host's interpreter, so they run
    here, not in the tier-1 tests): the "ag" ring, kv_cache_scatter, the
    registry's three SP specs and SPAttn's prefill (ring) and decode (the
    "dist" combine), each against the port."""
    smesh = _jmesh(False)
    mesh = _mesh()
    q, k, v = _ring_inputs()
    for causal in (True, False):
        want = np.asarray(jax.jit(lambda a, b, c, cz=causal: jax_sp_ring_attention(
            a, b, c, mesh=smesh, mode="ag", causal=cz))(q, k, v))
        got = K.sp_ring_attention(_shards(q, 1), _shards(k, 2), _shards(v, 2), mesh=mesh,
                                  mode="ag", causal=causal)
        _close(torch.cat(got, 1), want)
    old, new = _scatter_inputs()
    spec = NamedSharding(smesh, P(None, None, "sp", None))
    want = np.asarray(jax.jit(lambda c, n_: jax_kv_cache_scatter(c, n_, mesh=smesh))(
        jax.device_put(old, spec), jax.device_put(new, spec)))
    got = K.kv_cache_scatter(_shards(old, 2), _shards(new, 2), mesh=mesh)
    np.testing.assert_array_equal(torch.cat(got, 2).numpy(), want)
    reg = jax_kernel_registry()
    for name in SP_SPECS:
        jfn, jargs = reg[name].build(_registry_mesh())
        want = np.asarray(jax.jit(jfn)(*jargs))
        fn, args = K.kernel_registry()[name].build(mesh)
        for o in _spec_out(name, fn(*args)):
            _close(o, want)
    wq, wk, wv, wo = _layer_weights()
    jl = JaxSPAttn.init(wq, wk, wv, wo, mesh=smesh, n_heads=LHQ, n_kv_heads=LHKV, head_dim=LHD)
    cos, sin = jax_precompute_rope(LHD, LT)
    x, xn = _layer_inputs()
    jck, jcv = jl.alloc_cache(LB, LT, dtype=jnp.float32)
    with jax.default_matmul_precision("highest"):
        o1, jck, jcv, jL = jax.jit(jl.prefill)(
            jax.device_put(x, NamedSharding(smesh, P(None, "sp", None))), cos, sin, jck, jcv)
        o2, jck, jcv, _ = jax.jit(lambda *a: jl.decode(*a, combine="dist"))(
            jnp.asarray(xn), cos, sin, jck, jcv, jL)
    lay = _port_layer(mesh)
    tcos, tsin = precompute_rope(LHD, LT)
    ck, cv = lay.alloc_cache(LB, LT, dtype=torch.float32)
    out, ck, cv, L = lay.prefill(_shards(x, 1), tcos, tsin, ck, cv)
    _close(torch.cat(out, 1), o1, 1e-4)
    dec, ck, cv, _ = lay.decode([_t(xn)] * N, tcos, tsin, ck, cv, L, combine="dist")
    _close(dec[0], o2, 1e-4)
    _close(torch.cat(ck, 2), jck, 1e-4)
    _close(torch.cat(cv, 2), jcv, 1e-4)
