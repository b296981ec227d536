"""The port's kernel registry (triton_dist_tpu_torch.kernels.kernel_registry)
against the JAX package's, and the sequence-parallel paged partial
(flash_decode_paged_partial) against the JAX kernel.

On this CPU-only host the JAX kernels run in Pallas interpret mode and the
port's wrappers take their plain PyTorch versions; chip_smoke.py runs the
same registry on the card and holds each call to its CPU run.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.kernels import kernel_registry as jax_kernel_registry
from triton_dist_tpu.kernels.flash_attn import lse_combine as jax_lse_combine
from triton_dist_tpu.kernels.paged_kv import flash_decode_paged as jax_flash_decode_paged
from triton_dist_tpu.kernels.paged_kv import \
    flash_decode_paged_partial as jax_flash_decode_paged_partial
from triton_dist_tpu_torch.kernels import (flash_decode_paged, flash_decode_paged_partial,
                                           flash_decode_paged_partial_ref, kernel_registry,
                                           lse_combine, quantize_kv_int8)
from triton_dist_tpu_torch.tools import perf_model, perf_report

NAMES = sorted(n for n, s in kernel_registry().items() if s.min_devices == 1)
# per spec: the tolerance of the port's plain version against the JAX
# kernel; grouped_gemm's inputs and output are bf16 (its kernel's type),
# gdn_fwd sums a 64-token chunk's products in another order
TOL = {"grouped_gemm": 2e-3, "gdn_fwd": 2e-4}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _leaves(out):
    return list(out) if isinstance(out, tuple) else [out]


def test_registry_names_match_the_single_card_jax_specs():
    jax_specs = {n: s for n, s in jax_kernel_registry().items() if s.min_devices == 1}
    assert NAMES == sorted(jax_specs)
    for name in NAMES:
        spec = kernel_registry()[name]
        assert (spec.module, spec.kind) == (jax_specs[name].module, jax_specs[name].kind)
        assert bool(spec.inplace) == bool(jax_specs[name].inplace)


@pytest.mark.parametrize("name", NAMES)
def test_registry_canonical_call_matches_jax(name):
    fn, args = kernel_registry()[name].build("cpu")
    jfn, jargs = jax_kernel_registry()[name].build(None)
    assert len(args) == len(jargs)
    for a, ja in zip(args, jargs):
        want = _np(ja)
        if a.dtype == torch.bfloat16:   # the values drawn, in the kernel's type
            want = torch.tensor(want).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(_np(a), want)
    out = _leaves(fn(*[a.clone() for a in args]))
    jout = _leaves(jfn(*jargs))
    assert len(out) == len(jout)
    tol = TOL.get(name, 1e-5)
    for o, jo in zip(out, jout):
        assert tuple(o.shape) == tuple(jo.shape)
        np.testing.assert_allclose(_np(o), _np(jo), atol=tol, rtol=tol)


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_paged_partial_combine_vs_full_walk(kind):
    """The JAX test_sp_decode.py::test_paged_partial_combine_vs_oracle case:
    a pool's logical pages split between two owners by parity, one
    flash_decode_paged_partial per owner, lse_combine equal to the full
    walk; here also with stream 0 wholly owned by owner 0, so that owner
    1's rows of it are bitwise (0, -1e30, 0), and with an int8 pool."""
    B, Hq, Hkv, d, page, maxp, NP = 2, 4, 2, 32, 8, 4, 33
    X = B * Hkv
    rng = np.random.RandomState(7)
    pk = rng.randn(NP, page, d).astype(np.float32) * 0.5
    pv = rng.randn(NP, page, d).astype(np.float32) * 0.5
    tbl = (rng.permutation(NP - 1)[:X * maxp].reshape(X, maxp) + 1).astype(np.int32)
    q = rng.randn(B, 1, Hq, d).astype(np.float32) * 0.5
    kv_lens = np.asarray([13, 27], np.int32)
    tk, tv = torch.from_numpy(pk), torch.from_numpy(pv)
    kw, jkw = {}, {}
    if kind == "int8":
        tk, ks = quantize_kv_int8(tk)
        tv, vs = quantize_kv_int8(tv)
        kw = dict(k_scale=ks, v_scale=vs)
        jkw = dict(k_scale=jnp.asarray(ks.numpy()), v_scale=jnp.asarray(vs.numpy()))
    jk, jv = jnp.asarray(tk.numpy()), jnp.asarray(tv.numpy())
    tq, ttbl, tlens = torch.from_numpy(q), torch.from_numpy(tbl), torch.from_numpy(kv_lens)
    full = flash_decode_paged(tq, tk, tv, ttbl, kv_lens=tlens, **kw)
    jfull = jax_flash_decode_paged(jnp.asarray(q), jk, jv, jnp.asarray(tbl),
                                   jnp.max(jnp.asarray(kv_lens)),
                                   kv_lens=jnp.asarray(kv_lens), **jkw)
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), atol=5e-5, rtol=5e-5)
    parts, jparts = [], []
    for s in range(2):
        own = (np.arange(maxp)[None, :] % 2 == s).repeat(X, 0).astype(np.int32)
        own[:Hkv] = s == 0                  # stream 0's kv heads: owner 0 alone
        part = flash_decode_paged_partial(tq, tk, tv, ttbl, kv_lens=tlens,
                                          tile_owned=torch.from_numpy(own), **kw)
        jpart = jax_flash_decode_paged_partial(
            jnp.asarray(q), jk, jv, jnp.asarray(tbl), kv_lens=jnp.asarray(kv_lens),
            tile_owned=jnp.asarray(own), **jkw)
        for a, ja in zip(part, jpart):
            np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=5e-5, rtol=5e-5)
        parts.append(part)
        jparts.append(jpart)
    acc, m, l = parts[1]
    assert (acc[0] == 0).all() and (m[0] == -1e30).all() and (l[0] == 0).all()
    out = lse_combine(*(torch.stack([p[i] for p in parts]) for i in range(3)))
    jout = jax_lse_combine(*(jnp.stack([p[i] for p in jparts]) for i in range(3)),
                           dtype=jnp.float32)
    np.testing.assert_allclose(out.numpy(), full.numpy(), atol=5e-5, rtol=5e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=5e-5, rtol=5e-5)


def test_paged_partial_windows_match_jax():
    """The q_lens window form of the partial (S=4, windows of 0, 1 and 4
    positions) against the JAX kernel, and its plain version's rows that
    own no key bitwise (0, -1e30, 0)."""
    B, Hq, Hkv, d, page, maxp, NP, S = 3, 4, 2, 32, 8, 4, 25, 4
    X = B * Hkv
    rng = np.random.RandomState(11)
    pk = rng.randn(NP, page, d).astype(np.float32) * 0.5
    pv = rng.randn(NP, page, d).astype(np.float32) * 0.5
    tbl = (rng.permutation(NP - 1)[:X * maxp].reshape(X, maxp) + 1).astype(np.int32)
    q = rng.randn(B, S, Hq, d).astype(np.float32) * 0.5
    kv_lens = np.asarray([9, 30, 17], np.int32)
    q_lens = np.asarray([0, 1, 4], np.int32)
    own = (rng.rand(X, maxp) < 0.5).astype(np.int32)
    own[0] = 0                              # stream (0, 0) owns nothing here
    got = flash_decode_paged_partial(
        torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv),
        torch.from_numpy(tbl), kv_lens=torch.from_numpy(kv_lens),
        q_lens=torch.from_numpy(q_lens), tile_owned=torch.from_numpy(own))
    want = jax_flash_decode_paged_partial(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(tbl),
        kv_lens=jnp.asarray(kv_lens), q_lens=jnp.asarray(q_lens),
        tile_owned=jnp.asarray(own))
    rows = np.arange(S)[None, :] < q_lens[:, None]     # valid window positions
    for a, ja in zip(got, want):
        np.testing.assert_allclose(a.numpy()[rows], np.asarray(ja)[rows], atol=5e-5,
                                   rtol=5e-5)
    acc, m, l = flash_decode_paged_partial_ref(
        torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv),
        torch.from_numpy(tbl), kv_lens=torch.from_numpy(kv_lens),
        q_lens=torch.from_numpy(q_lens), tile_owned=torch.from_numpy(own))
    head0 = slice(0, Hq // Hkv)             # stream (0, 0): batch row 0's first group
    assert (acc[0, :, head0] == 0).all() and (m[0, :, head0] == -1e30).all() \
        and (l[0, :, head0] == 0).all()


def test_perf_report_tools_without_a_card(monkeypatch):
    """The roofline tools' pure parts: the H100/H200 data-sheet specs (an
    unknown or PCIe card gets the fallback), the GEMM and collective SOL
    (0 at one card), registry coverage against the port's registry, the
    flattened rows; and run_report refuses to time anything without a
    card."""
    h100 = perf_model.chip_specs("NVIDIA H100 80GB HBM3")
    assert (h100.bf16_tflops, h100.hbm_gbps, h100.link_gbps) == (989.0, 3350.0, 450.0)
    assert perf_model.chip_specs("NVIDIA H200").hbm_gbps == 4800.0
    assert perf_model.chip_specs("NVIDIA H100 PCIe").name == "unknown"
    assert perf_model.chip_specs("Tesla T4").name == "unknown"
    # M=256, K=N=4096 bf16: 37.7 MB at 3.35 TB/s outweighs 8.6 GFLOP at 989 TFLOP/s
    assert perf_model.gemm_sol_us(256, 4096, 4096, spec=h100) == pytest.approx(
        2 * (256 * 4096 * 2 + 4096 * 4096) / 3350e9 * 1e6)
    assert perf_model.collective_sol_us("ar", 1 << 20, 1, spec=h100) == 0.0
    assert perf_model.collective_sol_us("ag", 4 << 20, 4, spec=h100) == pytest.approx(
        0.75 * (4 << 20) / 450e9 * 1e6)
    cov = perf_report.registry_coverage(["flash_decode", "flash_decode_paged",
                                         "gdn_fwd(pallas)"])
    assert cov["kernels_registered"] == len(kernel_registry())
    assert cov["uncovered"] == sorted(set(kernel_registry()) - {"flash_decode",
                                                                "flash_decode_paged",
                                                                "gdn_fwd"})
    cov = perf_report.registry_coverage(["all_reduce(two_shot)", "reduce_scatter"])
    assert {"allreduce_two_shot", "reduce_scatter_one_shot",
            "reduce_scatter_ring"}.isdisjoint(cov["uncovered"])
    rows = perf_report.sol_frac_rows({"env": {"device": "d"}, "ops": [
        {"op": "gemm_rs", "achieved_us": 2.0, "sol_us": 1.0, "sol_frac": 0.5}]})
    assert rows == [{"metric": "gemm_rs_sol_frac", "value": 0.5, "unit": "frac of SOL",
                     "achieved_us": 2.0, "sol_us": 1.0, "device": "d"}]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs an NVIDIA card"):
        perf_report.run_report()
