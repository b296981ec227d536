"""The port's ring GEMMs (kernels.ag_gemm and kernels.gemm_rs over a mesh of
ranks) and Engine(backend="dist") at one rank against the JAX package.

- Each ring's plain version over a mesh of CPU ranks against the JAX
  Pallas kernel in interpret mode (Auto mesh axes) on the same numpy
  inputs: f32 at n=2 and 4, bf16 at n=4, bf16 with an int8 QuantW panel
  (the JAX quantize_int8) at n=4; rank r's shards are the JAX shards.
  Tolerance: one bf16 ulp of the largest output in bf16 (both sides
  round each tile once, gemm_rs each partial and each ring hop, the
  products summed in another order), 2e-6 of it in f32. The f32 cases at
  n=4 are the registry's two specs: the port's spec draws the JAX spec's
  inputs and its call gives the JAX spec's output.
- The wrappers' shape checks (ValueError) and the symmetric workspaces,
  which grow to the largest row count asked for and keep their memory
  for smaller ones.
- Engine(backend="dist") at one rank (every projection the one-rank
  ag_gemm/gemm_rs, the GEMM kernel's plain version here) against the JAX
  "xla" engine on tiny_qwen3(1) in bf16 and with int8 weights and KV:
  prefill and teacher-forced decode logits, and tokens by the margin
  rule; the window programs run on it, as on "ar"/"gemm_ar".

The engine over four ranks is held in tests/test_torch_tp.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from triton_dist_tpu.kernels.quant import quantize_int8 as jax_quantize_int8
from triton_dist_tpu.models import DenseLLM as JaxDenseLLM
from triton_dist_tpu.models.config import tiny_qwen3 as jax_tiny_qwen3
from triton_dist_tpu_torch import kernels as K
from triton_dist_tpu_torch.models import ContinuousScheduler, Engine, Request, tiny_qwen3
from triton_dist_tpu_torch.models.convert import from_jax_arrays, to_torch
from triton_dist_tpu_torch.runtime import make_mesh, symm_mem
from test_torch_engine import _jax_arrays

jag = importlib.import_module("triton_dist_tpu.kernels.allgather_gemm")
jrs = importlib.import_module("triton_dist_tpu.kernels.gemm_reduce_scatter")

CASES = [(2, "float32", False), (4, "float32", False), (4, "bfloat16", False),
         (4, "bfloat16", True)]


def _meshes(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} JAX devices")
    jmesh = jax.make_mesh((n,), ("tp",), axis_types=(AxisType.Auto,),
                          devices=jax.devices()[:n])
    return jmesh, make_mesh(n, devices=["cpu"] * n)


def _draw(seed, M, K_, N, dtype, quant):
    """A [M, K] and B [K, N] (a JAX QuantW when quant) in `dtype`."""
    rng = np.random.RandomState(seed)
    a = jnp.asarray(rng.randn(M, K_).astype(np.float32), dtype)
    b = jnp.asarray((rng.randn(K_, N) * K_ ** -0.5).astype(np.float32), dtype)
    return a, (jax_quantize_int8(b) if quant else b)


def _cols(b, lo, hi):
    """Columns [lo, hi) of a JAX weight as the port's weight."""
    if hasattr(b, "q"):
        return K.QuantW(q=to_torch(np.asarray(b.q[:, lo:hi])),
                        s=to_torch(np.asarray(b.s[lo:hi], np.float32)))
    return to_torch(np.asarray(b[:, lo:hi]))


def _rows(b, lo, hi):
    """Rows [lo, hi) of a JAX weight (a QuantW keeps its whole scale)."""
    if hasattr(b, "q"):
        return K.QuantW(q=to_torch(np.asarray(b.q[lo:hi])),
                        s=to_torch(np.asarray(b.s, np.float32)))
    return to_torch(np.asarray(b[lo:hi]))


def _close(outs, wants, dtype):
    for r, (o, w) in enumerate(zip(outs, wants)):
        w = np.asarray(w, np.float32)
        tol = np.abs(w).max() * (2.0 ** -7 if dtype == "bfloat16" else 2e-6)
        np.testing.assert_allclose(o.float().numpy(), w, atol=tol, rtol=0, err_msg=f"rank {r}")


def _registry(name, jmesh, mesh):
    """The JAX spec's inputs (A [8n, 128] and B) and the port spec's call,
    whose arguments are rank r's shards of them."""
    from triton_dist_tpu.kernels import kernel_registry as jax_kernel_registry
    spec, jspec = K.kernel_registry()[name], jax_kernel_registry()[name]
    assert (spec.module, spec.kind, spec.min_devices) == (jspec.module, jspec.kind, 2)
    fn, args = spec.build(mesh)
    a, b = jspec.build(jmesh)[1]
    n = mesh.size
    ax = (0, 1) if name == "ag_gemm" else (1, 0)
    for got, w in zip(args, np.split(np.asarray(a), n, axis=ax[0])
                      + np.split(np.asarray(b), n, axis=ax[1])):
        np.testing.assert_array_equal(got.numpy(), w)
    return a, b, lambda: fn(*args)


@pytest.mark.parametrize("n, dtype, quant", CASES)
def test_ag_gemm_matches_jax(n, dtype, quant):
    """C_r = allgather(A) @ B_r: rank r's A rows and B columns are the JAX
    shards; its C is the JAX result's column block r, its gathered A the
    JAX one."""
    jmesh, mesh = _meshes(n)
    registry = n == 4 and not quant and dtype == "float32"
    if registry:
        a, b, spec_call = _registry("ag_gemm", jmesh, mesh)
    else:
        a, b = _draw(11, 16 * n, 128, 64 * n, dtype, quant)
    (M, K_), N = a.shape, (b.q if quant else b).shape[1]
    want, ag = jag.ag_gemm(a, b, mesh=jmesh, return_ag=True)
    want = np.asarray(want.astype(jnp.float32))
    m, nl = M // n, N // n
    wants = [want[:, r * nl:(r + 1) * nl] for r in range(n)]
    got, got_ag = K.ag_gemm([to_torch(np.asarray(a[r * m:(r + 1) * m])) for r in range(n)],
                            [_cols(b, r * nl, (r + 1) * nl) for r in range(n)], mesh=mesh,
                            return_ag=True)
    _close(got, wants, dtype)
    for g in got_ag:
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(ag.astype(jnp.float32)))
    if registry:
        _close(spec_call(), wants, dtype)


@pytest.mark.parametrize("n, dtype, quant", CASES)
def test_gemm_rs_matches_jax(n, dtype, quant):
    """Rank r's rows of sum_r A_r @ B_r: its A columns and B rows are the
    JAX shards; the partials rounded, then the ring's order and roundings
    (chunk c from rank c+1 to rank c) on both sides."""
    jmesh, mesh = _meshes(n)
    registry = n == 4 and not quant and dtype == "float32"
    if registry:
        a, b, spec_call = _registry("gemm_rs", jmesh, mesh)
    else:
        a, b = _draw(12, 16 * n, 32 * n, 128, dtype, quant)
    (M, K_), N = a.shape, (b.q if quant else b).shape[1]
    want = np.asarray(jrs.gemm_rs(a, b, mesh=jmesh).astype(jnp.float32))
    k, m = K_ // n, M // n
    wants = [want[r * m:(r + 1) * m] for r in range(n)]
    got = K.gemm_rs([to_torch(np.asarray(a[:, r * k:(r + 1) * k])) for r in range(n)],
                    [_rows(b, r * k, (r + 1) * k) for r in range(n)], mesh=mesh)
    assert [tuple(o.shape) for o in got] == [(m, N)] * n
    _close(got, wants, dtype)
    if registry:
        _close(spec_call(), wants, dtype)


@pytest.mark.parametrize("name", ["ag_gemm", "gemm_rs"])
def test_registry_ring_specs_on_a_mesh_of_two(name):
    """The specs take any mesh: over two ranks they draw the JAX specs'
    inputs for two devices and their calls equal the plain f32 product
    of those inputs (the JAX kernels themselves are held above)."""
    jmesh, mesh = _meshes(2)
    a, b, spec_call = _registry(name, jmesh, mesh)
    full = np.asarray(a, np.float64) @ np.asarray(b, np.float64)
    wants = np.split(full, 2, axis=1 if name == "ag_gemm" else 0)
    _close(spec_call(), wants, "float32")


def test_ring_shape_checks():
    """What the kernels do not take raises ValueError, on the CPU too: K or
    N not a multiple of 8 in bf16, an M that n does not divide
    (gemm_rs), an A chunk of no whole number of 16-byte vectors; lists
    without a mesh; and the multi-rank training ops stay unported."""
    mesh = make_mesh(4, devices=["cpu"] * 4)
    bf = torch.bfloat16

    def parts(*shape, dtype=bf):
        return [torch.zeros(shape, dtype=dtype) for _ in range(4)]

    with pytest.raises(ValueError, match="multiples of 8"):
        K.ag_gemm(parts(4, 12), parts(12, 16), mesh=mesh)
    with pytest.raises(ValueError, match="multiples of 8"):
        K.gemm_rs(parts(8, 16), parts(16, 20), mesh=mesh)
    with pytest.raises(ValueError, match="divisible"):
        K.gemm_rs(parts(6, 16), parts(16, 16), mesh=mesh)
    with pytest.raises(ValueError, match="16-byte"):
        K.ag_gemm(parts(1, 3, dtype=torch.float32), parts(3, 4, dtype=torch.float32),
                  mesh=mesh)
    with pytest.raises(ValueError, match="mesh"):
        K.gemm_rs(parts(8, 16), parts(16, 16))
    for op in (K.ag_gemm_grad, K.gemm_rs_grad):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            op(4)


def test_workspaces_grow_to_the_largest_rows():
    """symm_workspace keys without the rows: a smaller M reuses the buffer,
    a larger one replaces it, other row shapes get their own."""
    mesh = make_mesh(2, devices=["cpu"] * 2)
    symm_mem.clear_registry()
    w64 = symm_mem.symm_workspace("ws", 64, (8,), torch.float32, mesh=mesh)
    assert w64.local_shape == (64, 8) and len(w64.tensors) == 2
    assert symm_mem.symm_workspace("ws", 16, (8,), torch.float32, mesh=mesh) is w64
    w100 = symm_mem.symm_workspace("ws", 100, (8,), torch.float32, mesh=mesh)
    assert w100.local_shape == (100, 8)
    assert symm_mem.symm_workspace("ws", 64, (8,), torch.float32, mesh=mesh) is w100
    assert symm_mem.symm_workspace("ws", 64, (16,), torch.float32, mesh=mesh) is not w100
    symm_mem.clear_registry()


@pytest.fixture(scope="module")
def jax_model():
    mesh = jax.make_mesh((1,), ("tp",), axis_types=(AxisType.Auto,),
                         devices=jax.devices()[:1])
    # jitted: the same draws, in one program instead of one per weight
    return jax.jit(lambda: JaxDenseLLM.random_init(jax_tiny_qwen3(1, dtype="bfloat16"),
                                                   mesh, seed=0))()


@pytest.fixture(scope="module", params=["bf16", "int8"])
def xla_ref(request, jax_model):
    """The JAX "xla" engine on tiny_qwen3(1): prefill, then forward_tokens
    steps fed the argmax, every step's logits; bf16, or int8 weights and
    KV."""
    kind = request.param
    jcfg = jax_model.config
    jm = jax_model
    kv = None
    if kind == "int8":
        jm, kv = jax.jit(lambda m: m.quantize_int8())(jm), jnp.int8
    ids = np.random.RandomState(5).randint(0, jcfg.vocab_size, (2, 7)).astype(np.int32)
    # the JAX engine's prefill is its forward_tokens on "xla" over a fresh
    # cache; one jitted program for it and the steps
    fwd = jax.jit(lambda m, t, c: m.forward_tokens(t, c, mode="xla"))
    logits, cache = fwd(jm, jnp.asarray(ids), jm.make_cache(2, 24, dtype=kv))
    logs, toks = [np.asarray(logits)], []
    for _ in range(3):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        logits, cache = fwd(jm, tok[:, None], cache)
        toks.append(np.asarray(tok))
        logs.append(np.asarray(logits))
    return dict(kind=kind, ids=ids, logits=logs, toks=toks, arrays=_jax_arrays(jm),
                kv=torch.int8 if kind == "int8" else None)


def test_dist_engine_tp1_matches_jax_xla(xla_ref):
    """Engine(backend="dist") at one rank: logits within 2e-2 (bf16) or
    3e-2 (int8) of the largest JAX logit at the prefill and every
    teacher-forced step (test_torch_engine.py's tolerances: bf16 rounding
    in another order, and an int8 level where a rounding straddles a
    quantizer step), tokens equal where the JAX margin is sure; prefill
    and decode both through the one-rank ag_gemm/gemm_rs."""
    r = xla_ref
    model = from_jax_arrays(tiny_qwen3(1, dtype="bfloat16"), r["arrays"], device="cpu")
    eng = Engine(model, max_seq=24, backend="dist", kv_dtype=r["kv"], device="cpu")
    assert eng.prefill_backend == "dist"
    logits, cache = eng.prefill(r["ids"])
    checked = 0
    for t, want in enumerate(r["logits"]):
        tol = (2e-2 if r["kind"] == "bf16" else 3e-2) * float(np.abs(want).max())
        got = logits.float().numpy()
        np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=f"step {t}")
        top2 = np.sort(want, -1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 2 * tol
        assert (got.argmax(-1) == want.argmax(-1))[sure].all()
        checked += int(sure.sum())
        if t < len(r["toks"]):
            logits = eng.decode_step(torch.from_numpy(r["toks"][t]).long(), cache)
    assert checked >= 2


def test_dist_tp1_window_programs_run():
    """At one rank "dist" runs every program "ar"/"gemm_ar" run there: the
    paged scheduler with spec=2 and with prefill_budget gives the streams
    of its own monolithic spec=0 run (f32, so the sums agree bitwise)."""
    from triton_dist_tpu_torch.models import DenseLLM
    model = DenseLLM.random_init(tiny_qwen3(1, dtype="float32"), device="cpu", seed=4)
    eng = Engine(model, max_seq=48, backend="dist", device="cpu")
    rng = np.random.RandomState(3)
    reqs = [Request(rid=i, ids=rng.randint(0, 256, n).astype(np.int32), gen_len=6)
            for i, n in enumerate([9, 13, 5])]

    def run(**kw):
        return ContinuousScheduler(eng, batch=2, chunk=4, paged=True, page=8, **kw).run(
            [Request(rid=q.rid, ids=q.ids, gen_len=q.gen_len) for q in reqs])

    want = run()
    for kw in (dict(spec=2), dict(prefill_budget=4)):
        got = run(**kw)
        for q in reqs:
            np.testing.assert_array_equal(np.asarray(got[q.rid]), np.asarray(want[q.rid]),
                                          err_msg=str(kw))
    assert eng.comm_kernel_dispatches > 0
