"""The port's kernels (triton_dist_tpu_torch.kernels) against the JAX
package's Pallas kernels, on the same inputs made with numpy.

On this CPU-only host the JAX kernels run in Pallas interpret mode, as
the JAX package's own tests run them, and the port's wrappers take
their plain PyTorch versions because the tensors lie on the CPU; the
CUDA kernels themselves are held against those plain versions on the
card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.kernels.flash_attn import flash_decode as jax_flash_decode
from triton_dist_tpu.kernels.flash_attn import kv_update as jax_kv_update
from triton_dist_tpu.kernels.paged_kv import flash_decode_paged as jax_flash_decode_paged
from triton_dist_tpu.kernels.quant import quantize_int8 as jax_quantize_int8
from triton_dist_tpu.kernels.quant import quantize_kv_int8 as jax_quantize_kv_int8
from triton_dist_tpu.kernels.swiglu import swiglu as jax_swiglu
from triton_dist_tpu_torch.kernels import (flash_decode, flash_decode_paged,
                                           flash_decode_paged_ref, kv_update,
                                           quantize_int8, quantize_kv_int8, swiglu)
from triton_dist_tpu_torch.models.convert import to_torch


def _np(x):
    """A jax array or torch tensor as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bits(x):
    """Raw bits of a jax array or tensor, for bitwise comparison."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _bf16_ulp(ref):
    """One bf16 ulp of each value (7 explicit mantissa bits)."""
    return np.spacing(np.abs(ref).astype(np.float32)) * 2.0 ** 16


@pytest.mark.parametrize("phase,S,kv_len", [("prefill", 8, 12), ("decode", 1, 20)])
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_flash_decode_matches_pallas(phase, S, kv_len, kind):
    B, Hq, Hkv, T, d = 2, 4, 2, 32, 32          # GQA rep=2
    rng = np.random.RandomState(S * 7 + len(kind))
    q = jnp.asarray(rng.randn(B, S, Hq, d) * 0.5, jnp.float32)
    k = jnp.asarray(rng.randn(B, Hkv, T, d) * 0.5, jnp.float32)
    v = jnp.asarray(rng.randn(B, Hkv, T, d) * 0.5, jnp.float32)
    kw_jax = {}
    if kind != "f32":
        q = q.astype(jnp.bfloat16)
    if kind == "bf16":
        k, v = k.astype(jnp.bfloat16), v.astype(jnp.bfloat16)
    if kind == "int8":
        (k, ks), (v, vs) = jax_quantize_kv_int8(k), jax_quantize_kv_int8(v)
        kw_jax = dict(k_scale=ks, v_scale=vs)
    with jax.default_matmul_precision("highest"):
        want = jax_flash_decode(q, k, v, kv_len, **kw_jax)
    t = lambda a: to_torch(np.asarray(a))
    got = flash_decode(t(q), t(k), t(v), kv_len,
                       **{n: t(a) for n, a in kw_jax.items()})
    assert got.dtype == (torch.float32 if kind == "f32" else torch.bfloat16)
    if kind == "f32":
        # the same f32 math summed in another order
        np.testing.assert_allclose(_np(got), _np(want), atol=5e-5, rtol=1e-5)
    else:
        # bf16 output rounding (1 ulp = 2^-7 relative at most) plus the
        # Pallas kernel's bf16 rounding of P, which the plain version
        # keeps in f32
        ref = _np(want)
        assert np.abs(_np(got) - ref).max() <= 2.0 ** -6 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("S,pos", [(8, 16), (3, 5)])
def test_kv_update_bitwise(dtype, S, pos):
    """An 8-aligned insert against the Pallas kv_update; any other row
    offset against the update-slice the JAX layer uses there."""
    B, H, T, d = 2, 2, 32, 32
    rng = np.random.RandomState(S + pos)
    cache = jnp.asarray(rng.randn(B, H, T, d) * 30).astype(dtype)
    new = jnp.asarray(rng.randn(B, H, S, d) * 30).astype(dtype)
    if S % 8 == 0 and pos % 8 == 0:
        want = jax_kv_update(cache, new, pos // 8)
    else:
        want = jax.lax.dynamic_update_slice(cache, new, (0, 0, pos, 0))
    got = to_torch(np.asarray(cache))
    out = kv_update(got, to_torch(np.asarray(new)), pos)
    assert out is got                           # updated in place
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_swiglu_matches_pallas(dtype):
    M, I = 16, 256
    x = jnp.asarray(np.random.RandomState(3).randn(M, 2 * I) * 3).astype(dtype)
    want = _np(jax_swiglu(x))
    got = swiglu(to_torch(np.asarray(x)))
    assert got.shape == (M, I)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-6)
    else:
        # same rounding order as the Pallas kernel; the f32 sigmoid may
        # differ in its last bits, which can move a result by one ulp
        assert (np.abs(_np(got) - want) <= _bf16_ulp(want)).all()


def test_quantizers_bitwise():
    rng = np.random.RandomState(4)
    w = rng.randn(64, 96).astype(np.float32)
    w[:, 0] = 0.0                                   # the 1e-8 scale floor
    w[0, 1], w[1, 1] = 127.0, 63.5                  # a half-way value
    jq = jax_quantize_int8(jnp.asarray(w))
    tq = quantize_int8(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_allclose(tq.s.numpy(), np.asarray(jq.s), rtol=1e-7, atol=0)
    x = rng.randn(2, 2, 8, 32).astype(np.float32)
    jk, js = jax_quantize_kv_int8(jnp.asarray(x))
    tk, ts = quantize_kv_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7, atol=0)


def _cast(kind, q, k, v):
    """f32 inputs as the kind's q and K/V: f32, bf16, or bf16 q with int8
    K/V quantized per position (scales returned)."""
    if kind == "f32":
        return q, k, v, {}
    q = q.astype(jnp.bfloat16)
    if kind == "bf16":
        return q, k.astype(jnp.bfloat16), v.astype(jnp.bfloat16), {}
    (k, ks), (v, vs) = jax_quantize_kv_int8(k), jax_quantize_kv_int8(v)
    return q, k, v, dict(k_scale=ks, v_scale=vs)


def _assert_attn_close(kind, got, want):
    assert got.dtype == (torch.float32 if kind == "f32" else torch.bfloat16)
    if kind == "f32":
        np.testing.assert_allclose(_np(got), _np(want), atol=5e-5, rtol=1e-5)
    else:
        # bf16 output rounding plus the Pallas kernel's bf16 rounding of
        # P, which the plain version keeps in f32 (as above)
        ref = _np(want)
        assert np.abs(_np(got) - ref).max() <= 2.0 ** -6 * np.abs(ref).max()


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_flash_decode_kv_lens_matches_pallas(kind):
    """Per-row lengths (the contiguous slot tick): row b attends exactly
    kv_lens[b] positions; the cache past each row's length holds 100x
    values, which a read one key too far would carry into the output."""
    B, Hq, Hkv, T, d = 3, 4, 2, 32, 32
    rng = np.random.RandomState(11 + len(kind))
    lens = np.asarray([5, 16, 29], np.int32)          # mid-tile, on a boundary
    q = jnp.asarray(rng.randn(B, 1, Hq, d) * 0.5, jnp.float32)
    kv = rng.randn(2, B, Hkv, T, d) * 0.5
    for b, n in enumerate(lens):
        kv[:, b, :, n:] *= 100
    q, k, v, kw = _cast(kind, q, jnp.asarray(kv[0], jnp.float32),
                        jnp.asarray(kv[1], jnp.float32))
    with jax.default_matmul_precision("highest"):
        want = jax_flash_decode(q, k, v, int(lens.max()), kv_lens=jnp.asarray(lens), **kw)
    t = lambda a: to_torch(np.asarray(a))
    got = flash_decode(t(q), t(k), t(v), kv_lens=torch.from_numpy(lens),
                       **{n: t(a) for n, a in kw.items()})
    _assert_attn_close(kind, got, want)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_flash_decode_paged_ref_matches_pallas(kind):
    """flash_decode_paged (its plain version on the CPU) against the
    Pallas paged kernel on a scattered table: pages are a random
    permutation of the pool, lengths end mid-page, on a page boundary
    and at one position, table entries past each stream's pages point at
    random pages, and every page the streams do not use (the trash page
    0 included) and every row past a stream's length holds 100x
    values, scales too."""
    B, Hq, Hkv, d, page, maxp = 3, 4, 2, 32, 8, 4
    X = B * Hkv
    NP = 1 + X * maxp + 3
    rng = np.random.RandomState(5 + len(kind))
    lens = np.asarray([13, 16, 1], np.int32)
    perm = 1 + rng.permutation(NP - 1)[:X * maxp]
    table = perm.reshape(X, maxp).astype(np.int32)
    pools = rng.randn(2, NP, page, d) * 0.5
    used = np.zeros((NP, page), bool)
    for x in range(X):
        n = int(lens[x // Hkv])
        npg = -(-n // page)
        for t in range(n):
            used[table[x, t // page], t % page] = True
        table[x, npg:] = rng.randint(0, NP, maxp - npg)
    pools[:, ~used] *= 100
    q = jnp.asarray(rng.randn(B, 1, Hq, d) * 0.5, jnp.float32)
    q, pk, pv, kw = _cast(kind, q, jnp.asarray(pools[0], jnp.float32),
                          jnp.asarray(pools[1], jnp.float32))
    with jax.default_matmul_precision("highest"):
        want = jax_flash_decode_paged(q, pk, pv, jnp.asarray(table), int(lens.max()),
                                      kv_lens=jnp.asarray(lens), **kw)
    t = lambda a: to_torch(np.asarray(a))
    args = (t(q), t(pk), t(pv), torch.from_numpy(table))
    tkw = {n: t(a) for n, a in kw.items()}
    got = flash_decode_paged(*args, kv_lens=torch.from_numpy(lens), **tkw)
    _assert_attn_close(kind, got, want)
    ref = flash_decode_paged_ref(*args, kv_lens=torch.from_numpy(lens), **tkw)
    assert torch.equal(got, ref)            # the CPU wrapper is the plain version
