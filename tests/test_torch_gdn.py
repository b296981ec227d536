"""The port's Gated DeltaNet forward (triton_dist_tpu_torch.kernels.gdn)
against the JAX package's, on the same inputs made with numpy.

The JAX side runs gdn_fwd(mode="ut") under the highest matmul precision,
its f64 recurrence gdn_fwd_ref and, for the kernel's shape, its Pallas
kernel in interpret mode; the port runs its plain versions (gdn_chunk_ref,
the kernel's arithmetic; mode "ut"; mode "scan") and mode "pallas", which
takes gdn_chunk_ref for CPU tensors. The CUDA kernel itself is held to
gdn_chunk_ref on the card by chip_smoke.py. Tolerances are those of the
JAX package's tests/test_gdn_ll.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.kernels.gdn import gdn_fwd as jax_gdn_fwd
from triton_dist_tpu.kernels.gdn import gdn_fwd_ref as jax_gdn_fwd_ref
from triton_dist_tpu_torch.kernels import gdn_chunk_ref, gdn_fwd, gdn_fwd_ref

# B, H, T, dk, dv, chunk, with S0: a ragged T (the padded last chunk), and
# one chunk of 64 with an initial state
SHAPES = {"ragged": (2, 3, 65, 16, 32, 16, False), "s0": (1, 2, 128, 32, 32, 64, True)}


def _inputs(B, H, T, dk, dv, s0, seed, g_lo=0.0, g_span=0.1):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, T, dk).astype(np.float32) * 0.3
    k = rng.randn(B, H, T, dk).astype(np.float32) * 0.3
    v = rng.randn(B, H, T, dv).astype(np.float32) * 0.3
    g = (g_lo - np.abs(rng.rand(B, H, T)) * g_span).astype(np.float32)
    beta = rng.rand(B, H, T).astype(np.float32)
    S0 = (rng.randn(B, H, dk, dv).astype(np.float32) * 0.05) if s0 else None
    return q, k, v, g, beta, S0


@functools.lru_cache(maxsize=None)
def _jax_results(shape: str):
    """JAX ut mode and the f64 recurrence on SHAPES[shape] (computed once)."""
    B, H, T, dk, dv, chunk, s0 = SHAPES[shape]
    q, k, v, g, beta, S0 = _inputs(B, H, T, dk, dv, s0, seed=T)
    kw = {} if S0 is None else {"S0": jnp.asarray(S0)}
    with jax.default_matmul_precision("highest"):
        o, S = jax_gdn_fwd(*map(jnp.asarray, (q, k, v, g, beta)), chunk=chunk, mode="ut",
                           **kw)
    ro, rS = jax_gdn_fwd_ref(q, k, v, g, beta, S0=S0)
    return (q, k, v, g, beta, S0), (np.asarray(o), np.asarray(S)), (ro, rS)


@pytest.mark.parametrize("mode", ["chunk_ref", "ut", "scan"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_gdn_matches_jax(shape, mode):
    inputs, (jo, jS), (ro, rS) = _jax_results(shape)
    chunk = SHAPES[shape][5]
    q, k, v, g, beta, S0 = (None if a is None else torch.from_numpy(a) for a in inputs)
    if mode == "chunk_ref":
        o, S = gdn_chunk_ref(q, k, v, g, beta, S0=S0, chunk=chunk)
    else:
        o, S = gdn_fwd(q, k, v, g, beta, S0=S0, chunk=chunk, mode=mode)
    assert o.dtype == torch.float32 and S.dtype == torch.float32
    for got, want in ((o, jo), (S, jS), (o, ro), (S, rS)):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    # and the port's own f64 recurrence is the JAX one
    po, pS = gdn_fwd_ref(q, k, v, g, beta, S0)
    np.testing.assert_allclose(po.numpy(), ro, atol=1e-12, rtol=1e-12)
    np.testing.assert_allclose(pS.numpy(), rS, atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("form", ["chunk_ref", "ut"])
def test_gdn_state_carry(form):
    """Chunk-carried state: one pass equals the pass split at a chunk
    boundary, the second half started from the first's final state."""
    B, H, T, d = 1, 2, 64, 16
    q, k, v, g, beta, _ = (None if a is None else torch.from_numpy(a)
                           for a in _inputs(B, H, T, d, d, False, seed=0))
    run = (lambda *a, S0=None: gdn_chunk_ref(*a, S0=S0, chunk=16)) if form == "chunk_ref" \
        else (lambda *a, S0=None: gdn_fwd(*a, S0=S0, chunk=16, mode="ut"))
    o_full, S_full = run(q, k, v, g, beta)
    h = T // 2
    first = [a[:, :, :h] for a in (q, k, v, g, beta)]
    second = [a[:, :, h:] for a in (q, k, v, g, beta)]
    _, S1 = run(*first)
    o2, S2 = run(*second, S0=S1)
    np.testing.assert_allclose(o_full[:, :, h:].numpy(), o2.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(S_full.numpy(), S2.numpy(), atol=1e-5, rtol=1e-5)


def test_gdn_deep_decay_span():
    """Per-token decay in [-3.5, -2.5): a chunk of 64 spans about 190 nats,
    far past f32's exp range; the decays masked before the exp stay exact
    (the JAX test_gdn_pallas_deep_decay_span case)."""
    B, H, T, d = 1, 2, 128, 128
    q, k, v, g, beta, _ = _inputs(B, H, T, d, d, False, seed=44, g_lo=-2.5, g_span=1.0)
    with jax.default_matmul_precision("highest"):
        jo, jS = jax_gdn_fwd(*map(jnp.asarray, (q, k, v, g, beta)), mode="ut")
    o, S = gdn_chunk_ref(*map(torch.from_numpy, (q, k, v, g, beta)))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), atol=2e-4, rtol=2e-3)


def test_gdn_pallas_interpret_case():
    """mode "pallas" at the kernel's shape (B=1, H=2, T=128, d=128, C=64,
    f32, unit-norm keys, S0): the JAX Pallas kernel in interpret mode and
    the port's plain version of the CUDA kernel, both against the f64
    recurrence."""
    B, H, T, d = 1, 2, 128, 128
    q, k, v, g, beta, S0 = _inputs(B, H, T, d, d, True, seed=T)
    k = k / np.linalg.norm(k, axis=-1, keepdims=True)
    with jax.default_matmul_precision("highest"):
        jo, jS = jax_gdn_fwd(*map(jnp.asarray, (q, k, v, g, beta)), S0=jnp.asarray(S0),
                             chunk=64, mode="pallas")
    o, S = gdn_fwd(*map(torch.from_numpy, (q, k, v, g, beta)), S0=torch.from_numpy(S0))
    ro, rS = jax_gdn_fwd_ref(q, k, v, g, beta, S0=S0)
    for got, want in ((o.numpy(), ro), (S.numpy(), rS), (np.asarray(jo), ro),
                      (np.asarray(jS), rS), (o.numpy(), np.asarray(jo))):
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("case", ["head_dim", "chunk", "dtype"])
def test_gdn_pallas_takes_the_kernel_shapes_only(case):
    """mode "pallas" raises on a shape the kernel does not take, where the
    JAX function falls back to "ut" silently."""
    d, chunk, dt = {"head_dim": (16, 64, torch.float32), "chunk": (64, 16, torch.float32),
                    "dtype": (64, 64, torch.float16)}[case]
    x = torch.zeros(1, 1, 8, d, dtype=dt)
    g = torch.zeros(1, 1, 8)
    with pytest.raises(ValueError, match="kernel takes|want bf16"):
        gdn_fwd(x, x, x, g, g, chunk=chunk)
