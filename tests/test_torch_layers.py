"""The port's layers (triton_dist_tpu_torch.layers) against the JAX
package's, on weights and inputs made with numpy and carried across.

The JAX layers run on a one-device mesh (tensor-parallel size 1, the
port's only size so far) with their Pallas kernels in interpret mode;
the port runs on the CPU, where its kernel wrappers take their plain
PyTorch versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.kernels.quant import quantize_int8 as jax_quantize_int8
from triton_dist_tpu.layers import TP_Attn as JaxAttn
from triton_dist_tpu.layers import TP_MLP as JaxMLP
from triton_dist_tpu.layers.common import apply_rope as jax_apply_rope
from triton_dist_tpu.layers.common import precompute_rope as jax_precompute_rope
from triton_dist_tpu.layers.common import rms_norm as jax_rms_norm
from triton_dist_tpu.models.kv_cache import KVCache as JaxKVCache
from triton_dist_tpu_torch.kernels.quant import QuantW
from triton_dist_tpu_torch.layers import TP_Attn, TP_MLP, apply_rope, precompute_rope, rms_norm
from triton_dist_tpu_torch.models.convert import to_torch
from triton_dist_tpu_torch.models.kv_cache import KVCache

D, HQ, HKV, HD, I = 64, 4, 2, 32, 128


def _mesh():
    return jax.make_mesh((1,), ("tp",), devices=jax.devices()[:1])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return to_torch(np.asarray(x))


def _weight(w):
    """A JAX weight (array or QuantW) as the port's."""
    if hasattr(w, "q"):
        return QuantW(q=_t(w.q), s=_t(w.s))
    return _t(w)


def _close(got, want, rel):
    """max|got - want| <= rel * max|want|."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    err, scale = np.abs(g - w).max(), np.abs(w).max()
    assert err <= rel * scale, f"max|d| {err} > {rel} * {scale}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope_match_jax(dtype):
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(2, 8, HQ, HD)).astype(dtype)
    w = jnp.asarray(np.abs(rng.randn(HD)), jnp.float32)
    pos = np.arange(3, 11)
    jcos, jsin = jax_precompute_rope(HD, 32)
    cos, sin = precompute_rope(HD, 32)
    np.testing.assert_array_equal(cos.numpy(), np.asarray(jcos))
    want_n = jax_rms_norm(x, w)
    want_r = jax_apply_rope(x, jcos, jsin, jnp.asarray(pos))
    got_n = rms_norm(_t(x), _t(w))
    got_r = apply_rope(_t(x), cos, sin, torch.from_numpy(pos))
    assert got_n.dtype == got_r.dtype == _t(x).dtype
    # f32: the same f32 math; bf16: one final rounding of the same f32
    # value, so at most one ulp (2^-7 relative) apart
    rel = 1e-6 if dtype == "float32" else 2.0 ** -7
    for got, want in ((got_n, want_n), (got_r, want_r)):
        g, w_ = _np(got), _np(want)
        assert (np.abs(g - w_) <= rel * np.abs(w_) + 1e-6).all()


@pytest.mark.parametrize("mode", ["flash", "xla"])
@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_attn_fwd_cached_matches_jax(mode, cache):
    """Prefill (S=8 at offset 0) then one decode step (offset 8), bf16
    activations: the outputs and the updated caches."""
    B, S, T = 2, 8, 16
    rng = np.random.RandomState(1)
    ws = [jnp.asarray(rng.randn(*shape) * 0.1).astype(jnp.bfloat16)
          for shape in ((D, HQ * HD), (D, HKV * HD), (D, HKV * HD), (HQ * HD, D))]
    qn = np.abs(rng.randn(HD)).astype(np.float32)
    kn = np.abs(rng.randn(HD)).astype(np.float32)
    jattn = JaxAttn.init(*ws, mesh=_mesh(), n_heads=HQ, n_kv_heads=HKV, head_dim=HD,
                         q_norm=qn, k_norm=kn)
    attn = TP_Attn(w_qkv=_t(jattn.w_qkv), w_o=_t(jattn.w_o), q_norm=_t(qn),
                   k_norm=_t(kn), n_heads=HQ, n_kv_heads=HKV, head_dim=HD)
    jcos, jsin = jax_precompute_rope(HD, T)
    cos, sin = precompute_rope(HD, T)
    kv_dtype = jnp.int8 if cache == "int8" else jnp.bfloat16
    jkv = JaxKVCache.create(1, B, T, HKV, HD, mesh=_mesh(), dtype=kv_dtype).layer(0)
    kv = KVCache.create(1, B, T, HKV, HD, device="cpu",
                        dtype=torch.int8 if cache == "int8" else torch.bfloat16).layer(0)
    fwd = jax.jit(lambda a, x, c, s, b: a.fwd_cached(x, jcos, jsin, b, c, s, mode),
                  static_argnums=(4,))
    for start, n in ((0, S), (S, 1)):
        x = jnp.asarray(rng.randn(B * n, D)).astype(jnp.bfloat16)
        want, jkv = fwd(jattn, x, jkv, start, B)
        got, kv = attn.fwd_cached(_t(x), cos, sin, B, kv, start, mode)
        # bf16 projections and attention: a few ulps of bf16
        _close(got, want, 2e-2)
    if cache == "bf16":
        for g, w in zip(kv, jkv):
            _close(g, w, 2.0 ** -6)
    else:
        for g, w in zip(kv[:2], jkv[:2]):      # int8 values: off by one at most
            assert np.abs(g.numpy().astype(int) - np.asarray(w).astype(int)).max() <= 1
        for g, w in zip(kv[2:], jkv[2:]):      # per-position f32 scales
            _close(g, w, 2.0 ** -6)


@pytest.mark.parametrize("weights", ["bf16", "int8"])
def test_mlp_fwd_flash_matches_jax(weights):
    rng = np.random.RandomState(2)
    wg, wu, wd = (jnp.asarray(rng.randn(*s) * 0.1).astype(jnp.bfloat16)
                  for s in ((D, I), (D, I), (I, D)))
    jmlp = JaxMLP.init(wg, wu, wd, mesh=_mesh())
    if weights == "int8":
        jmlp = dataclasses.replace(jmlp, w_gate_up=jax_quantize_int8(jmlp.w_gate_up),
                                   w_down=jax_quantize_int8(jmlp.w_down))
    mlp = TP_MLP(w_gate_up=_weight(jmlp.w_gate_up), w_down=_weight(jmlp.w_down))
    x = jnp.asarray(rng.randn(16, D)).astype(jnp.bfloat16)
    want = jax.jit(lambda m, x: m.fwd_flash(x))(jmlp, x)
    got = mlp(_t(x), "flash")
    assert got.dtype == torch.bfloat16
    # bf16 products and activation: a few ulps of bf16
    _close(got, want, 2e-2)


def _slot_attn(rng):
    """Carried bf16 attention weights (JAX layer, port layer) and RoPE
    tables, for the slot forms."""
    ws = [jnp.asarray(rng.randn(*shape) * 0.1).astype(jnp.bfloat16)
          for shape in ((D, HQ * HD), (D, HKV * HD), (D, HKV * HD), (HQ * HD, D))]
    qn = np.abs(rng.randn(HD)).astype(np.float32)
    kn = np.abs(rng.randn(HD)).astype(np.float32)
    jattn = JaxAttn.init(*ws, mesh=_mesh(), n_heads=HQ, n_kv_heads=HKV, head_dim=HD,
                         q_norm=qn, k_norm=kn)
    attn = TP_Attn(w_qkv=_t(jattn.w_qkv), w_o=_t(jattn.w_o), q_norm=_t(qn),
                   k_norm=_t(kn), n_heads=HQ, n_kv_heads=HKV, head_dim=HD)
    return jattn, attn


def _random_kv(rng, cache, shape):
    """A filled cache or pool tuple as numpy: bf16 K/V, or int8 K/V with
    per-position f32 scales over shape[:-1]."""
    if cache == "bf16":
        return [np.asarray(jnp.asarray(rng.randn(*shape)).astype(jnp.bfloat16))
                for _ in range(2)]
    return ([rng.randint(-127, 128, shape).astype(np.int8) for _ in range(2)]
            + [np.abs(rng.randn(*shape[:-1])).astype(np.float32) * 0.02
               for _ in range(2)])


def _check_kv(cache, got, want):
    if cache == "bf16":
        for g, w in zip(got, want):
            _close(g, w, 2.0 ** -6)
    else:
        for g, w in zip(got[:2], want[:2]):     # int8 values: off by one at most
            assert np.abs(g.numpy().astype(int) - np.asarray(w).astype(int)).max() <= 1
        for g, w in zip(got[2:], want[2:]):     # per-position f32 scales
            _close(g, w, 2.0 ** -6)


@pytest.mark.parametrize("mode", ["flash", "xla"])
@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_attn_fwd_cached_slots_matches_jax(mode, cache):
    """Two continuous-batching steps, each row at its own position (one
    row reaching the cache's last column), on a filled contiguous cache:
    the outputs and the updated caches."""
    B, T = 3, 16
    rng = np.random.RandomState(6)
    jattn, attn = _slot_attn(rng)
    jcos, jsin = jax_precompute_rope(HD, T)
    cos, sin = precompute_rope(HD, T)
    kv0 = _random_kv(rng, cache, (B, HKV, T, HD))
    jkv = tuple(jnp.asarray(a) for a in kv0)
    kv = tuple(_t(a) for a in kv0)
    fwd = jax.jit(lambda a, x, c, p, b: a.fwd_cached_slots(x, jcos, jsin, b, c, p, mode),
                  static_argnums=(4,))
    for pos in (np.asarray([3, 9, 14], np.int32), np.asarray([4, 10, 15], np.int32)):
        x = jnp.asarray(rng.randn(B, D)).astype(jnp.bfloat16)
        want, jkv = fwd(jattn, x, jkv, jnp.asarray(pos), B)
        got, kv = attn.fwd_cached_slots(_t(x), cos, sin, B, kv, torch.from_numpy(pos),
                                        mode)
        _close(got, want, 2e-2)                 # bf16 projections and attention
    _check_kv(cache, kv, jkv)


@pytest.mark.parametrize("mode", ["flash", "xla"])
@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_attn_fwd_cached_slots_paged_matches_jax(mode, cache):
    """The same two steps over a filled page pool behind a scattered
    table (rows' positions end mid-page and on a page's last row): the
    outputs and the updated pools and scale pools."""
    B, page, maxp = 3, 8, 2
    X = B * HKV
    NP = 1 + X * maxp + 2
    rng = np.random.RandomState(7)
    jattn, attn = _slot_attn(rng)
    jcos, jsin = jax_precompute_rope(HD, maxp * page)
    cos, sin = precompute_rope(HD, maxp * page)
    table = (1 + rng.permutation(NP - 1)[:X * maxp]).reshape(X, maxp).astype(np.int32)
    kv0 = _random_kv(rng, cache, (NP, 1, page, HD))
    jkv = tuple(jnp.asarray(a) for a in kv0)
    kv = tuple(_t(a) for a in kv0)
    fwd = jax.jit(lambda a, x, c, tb, p, b: a.fwd_cached_slots_paged(
        x, jcos, jsin, b, c, tb, p, mode), static_argnums=(5,))
    for pos in (np.asarray([3, 6, 14], np.int32), np.asarray([4, 7, 15], np.int32)):
        x = jnp.asarray(rng.randn(B, D)).astype(jnp.bfloat16)
        want, jkv = fwd(jattn, x, jkv, jnp.asarray(table), jnp.asarray(pos), B)
        got, kv = attn.fwd_cached_slots_paged(_t(x), cos, sin, B, kv,
                                              torch.from_numpy(table),
                                              torch.from_numpy(pos), mode)
        _close(got, want, 2e-2)
    _check_kv(cache, kv, jkv)
