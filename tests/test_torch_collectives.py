"""The port's collectives (triton_dist_tpu_torch.kernels: all_gather,
reduce_scatter, all_reduce, gemm_allreduce) against the JAX package's.

On this CPU-only host the JAX kernels run in Pallas interpret mode over a
mesh of the virtual CPU devices (Auto axes), and the port's wrappers take
their plain versions over a mesh of CPU ranks: the same numpy inputs,
every method, bitwise for the three collectives (each rank's copy), and
within a stated tolerance for gemm_allreduce, whose product sums in
another order. chip_smoke.py holds the CUDA kernels to these plain
versions on the card.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from triton_dist_tpu.kernels.gemm_allreduce import gemm_allreduce as jax_gemm_allreduce
from triton_dist_tpu.kernels.quant import quantize_int8 as jax_quantize_int8
from triton_dist_tpu_torch import kernels as K
from triton_dist_tpu_torch.kernels.allreduce import resolve_method
from triton_dist_tpu_torch.models.convert import to_torch
from triton_dist_tpu_torch.runtime import make_mesh

# the modules (the package re-exports functions under some of their names)
jag = importlib.import_module("triton_dist_tpu.kernels.allgather")
jar = importlib.import_module("triton_dist_tpu.kernels.allreduce")
jrs = importlib.import_module("triton_dist_tpu.kernels.reduce_scatter")


def _meshes(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} JAX devices")
    jmesh = jax.make_mesh((n,), ("tp",), axis_types=(AxisType.Auto,),
                          devices=jax.devices()[:n])
    return jmesh, make_mesh(n, devices=["cpu"] * n)


def _f32(seed, *shape):
    return (np.random.RandomState(seed).randn(*shape) * 0.1).astype(np.float32)


def _assert_ranks(outs, want):
    """Every rank's tensor bitwise equal to the JAX result."""
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o.numpy(), want, err_msg=f"rank {r}")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("method", ["one_shot", "ring"])
def test_all_gather_matches_jax(n, method):
    jmesh, mesh = _meshes(n)
    x = _f32(0, 8 * n, 128)                     # the JAX registry's shape
    want = np.asarray(jag.all_gather(jnp.asarray(x), mesh=jmesh,
                                     method=jag.AllGatherMethod(method)))
    shards = [torch.from_numpy(x[r * 8:(r + 1) * 8]) for r in range(n)]
    _assert_ranks(K.all_gather(shards, mesh=mesh, method=K.AllGatherMethod(method)), want)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("method", ["one_shot", "ring"])
def test_reduce_scatter_matches_jax(n, method):
    jmesh, mesh = _meshes(n)
    x = _f32(1, n, 8 * n, 128)
    want = np.asarray(jrs.reduce_scatter(jnp.asarray(x), mesh=jmesh,
                                         method=jrs.ReduceScatterMethod(method)))
    outs = K.reduce_scatter([torch.from_numpy(x[r]) for r in range(n)], mesh=mesh,
                            method=K.ReduceScatterMethod(method))
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o.numpy(), want[r * 8:(r + 1) * 8], err_msg=f"rank {r}")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("method", ["one_shot", "two_shot"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_all_reduce_matches_jax(n, method, dtype):
    """Bitwise in each method's order and roundings: bf16 shows the
    two-shot's rounding at every ring hop."""
    jmesh, mesh = _meshes(n)
    x = _f32(2, n, 8 * n, 128) * 10
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jar.all_reduce(jx, mesh=jmesh, method=jar.AllReduceMethod(method))
                      .astype(jnp.float32))
    parts = [to_torch(np.asarray(jx[r])) for r in range(n)]
    outs = K.all_reduce(parts, mesh=mesh, method=K.AllReduceMethod(method))
    _assert_ranks([o.float() for o in outs], want)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("quant", [False, True])
def test_gemm_allreduce_matches_jax(n, quant):
    """A [M, K] sharded on columns and B [K, N] on rows (bf16 A; B bf16 or
    an int8 QuantW): within one bf16 ulp of the largest output, the
    partials rounded to bf16 before the sum on both sides and the products
    summed in another order."""
    jmesh, mesh = _meshes(n)
    M, K_, N = 8, 32 * n, 128
    a = jnp.asarray(_f32(3, M, K_) * 10, jnp.bfloat16)
    b = jnp.asarray(_f32(4, K_, N) * 10, jnp.bfloat16)
    jb = jax_quantize_int8(b) if quant else b
    want = np.asarray(jax_gemm_allreduce(a, jb, mesh=jmesh).astype(jnp.float32))
    k = K_ // n
    ta = [to_torch(np.asarray(a[:, r * k:(r + 1) * k])) for r in range(n)]
    if quant:
        tb = [K.QuantW(q=to_torch(np.asarray(jb.q[r * k:(r + 1) * k])),
                       s=to_torch(np.asarray(jb.s, np.float32))) for r in range(n)]
    else:
        tb = [to_torch(np.asarray(b[r * k:(r + 1) * k])) for r in range(n)]
    outs = K.gemm_allreduce(ta, tb, mesh=mesh)
    tol = np.abs(want).max() * 2.0 ** -7
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o.float().numpy(), want, atol=tol, rtol=0,
                                   err_msg=f"rank {r}")
        assert torch.equal(o, outs[0])


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_auto_methods_match_jax(n):
    for nbytes in [1, 4096, 1 << 17, (1 << 20) // 3, (1 << 20) // 3 + 1, 1 << 19, 1 << 20,
                   1 << 22]:
        assert (K.get_auto_allreduce_method(nbytes, n).value
                == jar.get_auto_allreduce_method(nbytes, n).value)
        assert (K.get_auto_all_gather_method(nbytes, n).value
                == jag.get_auto_all_gather_method(nbytes, n).value)
        assert (K.get_auto_reduce_scatter_method(nbytes, n).value
                == jrs.get_auto_reduce_scatter_method(nbytes, n).value)
    # the two-shot's ring needs n | M, else the one-shot (as JAX decides)
    two = K.AllReduceMethod.TWO_SHOT
    if n > 1:
        assert resolve_method(two, 4 * n + 1, 2048, 2, n) == K.AllReduceMethod.ONE_SHOT
        assert resolve_method(two, 4 * n, 2048, 2, n) == two


@pytest.mark.parametrize("M, method", [(128, "two_shot"), (64, "one_shot")])
def test_decode_shapes_pick_the_methods(M, method):
    """The engine's B=128 rows of [., 2048] bf16 at n=4 take the two-shot
    (3 x 512 KiB > 1 MiB), the 64 serving slots the one-shot: the methods
    the card checks require of the "ar" decode and serving ticks."""
    auto = K.AllReduceMethod.AUTO
    assert resolve_method(auto, M, 2048, 2, 4).value == method
    assert jar.get_auto_allreduce_method(M * 2048 * 2, 4).value == method


def test_method_counts_reset():
    from triton_dist_tpu_torch.kernels import _build
    K.reset_launch_counts()
    _build.count("all_reduce", "two_shot")
    _build.count("all_reduce", "two_shot")
    _build.count("all_gather", "ring")
    _build.count("gemm_allreduce")
    assert K.method_counts() == {"all_reduce two_shot": 2, "all_gather ring": 1}
    assert K.launch_counts()["all_reduce"] == 2
    K.reset_launch_counts()
    assert K.method_counts() == {} and not any(K.launch_counts().values())


@pytest.mark.parametrize("name", ["allgather_one_shot", "allgather_ring",
                                  "reduce_scatter_one_shot", "reduce_scatter_ring",
                                  "allreduce_one_shot", "allreduce_two_shot", "gemm_ar"])
def test_registry_comm_specs_match_jax(name):
    """The port's comm specs draw the JAX specs' inputs (rank r's tensors
    are JAX's shard r) and their calls on a CPU mesh equal the plain
    versions; the JAX kernels themselves are held above."""
    from triton_dist_tpu.kernels import kernel_registry as jax_kernel_registry
    jmesh, mesh = _meshes(4)
    spec = K.kernel_registry()[name]
    jspec = jax_kernel_registry()[name]
    assert (spec.module, spec.kind, spec.min_devices) == (jspec.module, jspec.kind, 2)
    fn, args = spec.build(mesh)
    _, jargs = jspec.build(jmesh)
    if name == "gemm_ar":
        a, b = (np.asarray(x) for x in jargs)
        want = np.split(a, 4, axis=1) + np.split(b, 4, axis=0)
    elif name.startswith("allgather"):
        want = np.split(np.asarray(jargs[0]), 4, axis=0)
    else:
        want = list(np.asarray(jargs[0]))
    assert len(args) == len(want)
    for got, w in zip(args, want):
        np.testing.assert_array_equal(got.numpy(), w)
    outs = fn(*args)
    assert len(outs) == 4 and all(torch.isfinite(o).all() for o in outs)
