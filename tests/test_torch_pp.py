"""The port's pipeline parallelism (kernels.p2p_shift, p2p_push_pages, the
p2p_shift registry spec, layers.PPipeline) against the JAX package, on a
mesh of four CPU ranks (runtime.make_mesh(4, devices=["cpu"] * 4)) against
a JAX mesh of the first four CPU devices with Auto axes.

The JAX functions run as tests/test_pp.py runs them: jitted, the p2p
kernel in Pallas interpret mode. Every JAX call runs once, in the module
fixture `jax_pp`; the pipelines run with replicate_out=False (the banks),
and once with replicate_out=True, whose psum equals the last stage's bank
exactly (every other stage banks zeros). The port runs on the CPU, where
p2p_shift takes its plain version. Tolerances: the shifts and the pushes
bitwise (they move bytes); the pipelines, whose stages are f32 products
summed in another order than XLA's, within 1e-5; the port's pipeline
against its own stages applied in order on one rank, bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, NamedSharding
from jax.sharding import PartitionSpec as P

from triton_dist_tpu.kernels import kernel_registry as jax_kernel_registry
from triton_dist_tpu.kernels.p2p import p2p_push_pages as jax_p2p_push_pages
from triton_dist_tpu.kernels.p2p import p2p_shift as jax_p2p_shift
from triton_dist_tpu.layers.common import rms_norm as jax_rms_norm
from triton_dist_tpu.layers.pp import PPipeline as JaxPPipeline
from triton_dist_tpu_torch import kernels as K
from triton_dist_tpu_torch.kernels.quant import qmm
from triton_dist_tpu_torch.layers import PPipeline
from triton_dist_tpu_torch.layers.common import rms_norm
from triton_dist_tpu_torch.layers.pp import train_1f1b
from triton_dist_tpu_torch.runtime import make_mesh

N = 4
B, D, I = 4, 64, 96          # a microbatch's rows, the width, the MLP's inner width
MS = (1, 7, 8)               # microbatch counts
HOPS = (0, 1, 2)             # p2p_push_pages from rank 0 to rank h


def _jmesh():
    if len(jax.devices()) < N:
        pytest.skip(f"needs {N} JAX devices")
    return jax.make_mesh((N,), ("pp",), axis_types=(AxisType.Auto,), devices=jax.devices()[:N])


def _mesh():
    return make_mesh(N, devices=["cpu"] * N)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _params(stage):
    """Stacked [n, ...] numpy parameters of the tanh or the MLP-block stage."""
    rng = np.random.RandomState(1)
    if stage == "tanh":
        return {"w": (rng.randn(N, D, D) * 0.5 / np.sqrt(D)).astype(np.float32),
                "b": (rng.randn(N, D) * 0.1).astype(np.float32)}
    return {"ln": (rng.rand(N, D) + 0.5).astype(np.float32),
            "w_gu": (rng.randn(N, D, 2 * I) / np.sqrt(D)).astype(np.float32),
            "w_d": (rng.randn(N, I, D) / np.sqrt(I)).astype(np.float32)}


def _jax_stage(stage):
    if stage == "tanh":
        return lambda p, x: jnp.tanh(x @ p["w"] + p["b"])

    def mlp(p, x):
        g, u = jnp.split(jax_rms_norm(x, p["ln"]) @ p["w_gu"], 2, axis=-1)
        return x + (jax.nn.silu(g) * u) @ p["w_d"]
    return mlp


def _port_stage(stage):
    """The same stages in the port: the MLP block is the post-attention
    RMSNorm, the gate/up product, the SwiGLU kernel's wrapper, the down
    product and the residual (tools/pp_check.py's block)."""
    if stage == "tanh":
        return lambda p, x: torch.tanh(x @ p["w"] + p["b"])

    def mlp(p, x):
        return x + qmm(K.swiglu(qmm(rms_norm(x, p["ln"]), p["w_gu"])), p["w_d"])
    return mlp


def _x_mb(M):
    return np.random.RandomState(2 + M).randn(M, B, D).astype(np.float32)


@pytest.fixture(scope="module")
def jax_pp():
    """Every JAX call of this module, once (see the module docstring)."""
    mesh = _jmesh()
    out = {}
    x = np.random.RandomState(0).randn(N, 8, 128).astype(np.float32)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("pp", None, None)))
    for rev in (False, True):
        out["shift", rev] = (x, np.asarray(jax.jit(
            lambda v, r=rev: jax_p2p_shift(v, mesh=mesh, reverse=r))(xs)))
    page = np.random.RandomState(3).randn(2, 8, 16).astype(np.float32)
    for h in HOPS:
        out["push", h] = (page, np.asarray(jax_p2p_push_pages(page, mesh=mesh, axis="pp",
                                                              src=0, dst=h)))
    for stage in ("tanh", "mlp"):
        pipe = JaxPPipeline.init(_params(stage), _jax_stage(stage), mesh=mesh)
        for M in MS:
            out[stage, M] = np.asarray(jax.jit(lambda v, p=pipe: p(v, replicate_out=False))(
                jnp.asarray(_x_mb(M))))
    out["tanh", 8, "replicated"] = np.asarray(jax.jit(lambda v: JaxPPipeline.init(
        _params("tanh"), _jax_stage("tanh"), mesh=mesh)(v))(jnp.asarray(_x_mb(8))))
    _, args = jax_kernel_registry()["p2p_shift"].build(_registry_mesh())
    out["registry"] = np.asarray(args[0])
    return out


def _registry_mesh():
    return jax.make_mesh((N,), ("tp",), axis_types=(AxisType.Auto,), devices=jax.devices()[:N])


@pytest.mark.parametrize("reverse", [False, True])
def test_p2p_shift_matches_jax(jax_pp, reverse):
    """ys[(i + 1) % n] = xs[i] (reverse: (i - 1) % n), bitwise against the
    JAX kernel's result and np.roll."""
    x, want = jax_pp["shift", reverse]
    got = K.p2p_shift([_t(r) for r in x], mesh=_mesh(), reverse=reverse)
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), want)
    np.testing.assert_array_equal(want, np.roll(x, -1 if reverse else 1, axis=0))


@pytest.mark.parametrize("hops", HOPS)
def test_p2p_push_pages_matches_jax(jax_pp, hops):
    """The payload lands at rank `hops` bitwise, over `hops` shifts."""
    page, want = jax_pp["push", hops]
    got = K.p2p_push_pages(_t(page), mesh=_mesh(), src=0, dst=hops)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, page)


def test_p2p_shift_one_rank_and_gates():
    """One rank returns its tensor; ranks of unequal shapes raise; pushes
    wrap around the ring (src 3 to dst 1 is two hops)."""
    one = make_mesh(1, devices=["cpu"])
    x = torch.arange(6.0).reshape(2, 3)
    assert K.p2p_shift([x], mesh=one)[0] is x
    with pytest.raises(ValueError):
        K.p2p_shift([x] * 3 + [x[:1]], mesh=_mesh())
    got = K.p2p_push_pages(x, mesh=_mesh(), src=3, dst=1)
    assert torch.equal(got, x)


def _port_pipe(stage):
    p = _params(stage)
    return PPipeline.init([{k: _t(v[s]) for k, v in p.items()} for s in range(N)],
                          _port_stage(stage), mesh=_mesh())


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("stage", ["tanh", "mlp"])
def test_pipeline_matches_jax(jax_pp, stage, M):
    """Both output forms against the JAX pipeline's banks: replicate_out=
    False gives every stage's bank (the last holds the result, the others
    zeros), replicate_out=True the psum on every rank."""
    pipe = _port_pipe(stage)
    x = _t(_x_mb(M))
    want = jax_pp[stage, M]
    banks = pipe(x, replicate_out=False)
    assert len(banks) == N
    for r, b in enumerate(banks):
        np.testing.assert_allclose(b.numpy(), want[r], atol=1e-5, rtol=0)
    for r, o in enumerate(pipe(x)):
        np.testing.assert_allclose(o.numpy(), want[N - 1], atol=1e-5, rtol=0)
        assert torch.equal(o, banks[N - 1])


def test_pipeline_replicated_matches_jax(jax_pp):
    """JAX's replicated output (its psum) equals its last bank, and the
    port's replicated output equals it within 1e-5."""
    want = jax_pp["tanh", 8, "replicated"]
    np.testing.assert_array_equal(want, jax_pp["tanh", 8][N - 1])
    for o in _port_pipe("tanh")(_t(_x_mb(8))):
        np.testing.assert_allclose(o.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("stage", ["tanh", "mlp"])
def test_pipeline_equals_the_stages_in_order(stage):
    """The pipeline's output equals the n stages applied in order to each
    microbatch on one rank, bitwise: the handoff moves bytes and every
    stage runs the same arithmetic."""
    pipe = _port_pipe(stage)
    fn = _port_stage(stage)
    x = _t(_x_mb(7))
    want = []
    for m in range(7):
        y = x[m]
        for s in range(N):
            y = fn(pipe.stage_params[s], y)
        want.append(y)
    assert torch.equal(pipe(x)[0], torch.stack(want))


def test_pipeline_gates():
    """A stage count that is not the mesh's, and 1F1B training, raise."""
    with pytest.raises(ValueError, match="stages"):
        PPipeline.init([{}] * 3, _port_stage("tanh"), mesh=_mesh())
    with pytest.raises(NotImplementedError, match="not yet ported"):
        train_1f1b(_port_pipe("tanh"), None, None)


def test_registry_p2p_shift_matches_jax(jax_pp):
    """The p2p_shift spec draws the JAX spec's input (rank r's tensor is
    the JAX shard r) and shifts it on a CPU mesh."""
    spec = K.kernel_registry()["p2p_shift"]
    jspec = jax_kernel_registry()["p2p_shift"]
    assert (spec.module, spec.kind, spec.min_devices) == (jspec.module, jspec.kind, 2)
    fn, args = spec.build(_mesh())
    x = jax_pp["registry"]
    for r, a in enumerate(args):
        np.testing.assert_array_equal(a.numpy(), x[r])
    for r, o in enumerate(fn(*args)):
        np.testing.assert_array_equal(o.numpy(), x[(r - 1) % N])
