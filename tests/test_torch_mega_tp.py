"""The port's tensor-parallel megakernel (MegaDecodeLayer(tp=4),
Engine(backend="mega") over a mesh of four CPU ranks) against the JAX
package.

On the CPU the layer runs its plain version: the TP task program's
PyTorch emitters in lockstep over the ranks, the partial o_proj and
down_proj in f32 with no residual, each all-reduce section folding the
four partials in rank order onto the residual. Inputs are made with
numpy from a seed and handed to both packages; the JAX TP megakernel
itself (interpret mode) is left to the JAX suite, which marks it slow.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from triton_dist_tpu.mega import mega_decode_layer_ref as jax_mega_ref
from triton_dist_tpu.models import AutoLLM as JaxAutoLLM
from triton_dist_tpu.models import Engine as JaxEngine
from triton_dist_tpu.models.config import tiny_qwen3 as jax_tiny_qwen3
from triton_dist_tpu_torch.mega import MegaDecodeLayer, mega_decode_layer_ref
from triton_dist_tpu_torch.models import ContinuousScheduler, Engine, tiny_qwen3
from triton_dist_tpu_torch.models import engine as engine_mod
from triton_dist_tpu_torch.models.convert import from_jax_arrays
from triton_dist_tpu_torch.runtime import make_mesh
from test_torch_engine import _jax_arrays

N = 4
# the JAX TP layer test's geometry (tests/test_mega.py::test_mega_decode_layer_tp_vs_oracle)
B, D, HQ, HKV, HD, F, T, POS = 4, 256, 8, 4, 64, 512, 256, 37
# the JAX TP mega engine test's model (tests/test_mega.py::test_mega_engine_tp_decode_matches_dist)
TINY = dict(hidden_size=128, intermediate_size=512, num_heads=8, num_kv_heads=4, head_dim=64,
            dtype="bfloat16", max_position_embeddings=256)
IDS = np.random.RandomState(0).randint(0, 256, (4, 8)).astype(np.int32)
GEN, MAX_SEQ = 5, 64


def _mesh():
    return make_mesh(N, devices=["cpu"] * N)


def _jmesh():
    if len(jax.devices()) < N:
        pytest.skip(f"needs {N} JAX devices")
    return jax.make_mesh((N,), ("tp",), axis_types=(AxisType.Auto,), devices=jax.devices()[:N])


def _layer_inputs(seed=3):
    """tests/test_mega.py's _mk_layer draws (x, weights, caches [Hkv, B, T,
    hd] bf16) and the rope rows at POS, as numpy."""
    rng = np.random.RandomState(seed)
    sc = 0.3 / np.sqrt(D)
    w = {
        "w_ln1": (1 + 0.1 * rng.randn(1, D)).astype(np.float32),
        "w_qkv": (rng.randn(D, (HQ + 2 * HKV) * HD) * sc).astype(np.float32),
        "q_norm": (1 + 0.1 * rng.randn(1, HD)).astype(np.float32),
        "k_norm": (1 + 0.1 * rng.randn(1, HD)).astype(np.float32),
        "w_o": (rng.randn(HQ * HD, D) * sc).astype(np.float32),
        "w_ln2": (1 + 0.1 * rng.randn(1, D)).astype(np.float32),
        "w_gu": (rng.randn(D, 2 * F) * sc).astype(np.float32),
        "w_d": (rng.randn(F, D) * (0.3 / np.sqrt(F))).astype(np.float32),
    }
    x = (rng.randn(B, D) * 0.3).astype(np.float32)
    ck = np.asarray(jnp.asarray(rng.randn(HKV, B, T, HD), jnp.bfloat16) * 0.3)
    cv = np.asarray(jnp.asarray(rng.randn(HKV, B, T, HD), jnp.bfloat16) * 0.3)
    inv = 1.0 / (1e6 ** (np.arange(0, HD, 2) / HD))
    w["cos_row"] = np.cos(POS * inv)[None].astype(np.float32)
    w["sin_row"] = np.sin(POS * inv)[None].astype(np.float32)
    return x, w, ck, cv


def _rank_weights(w, r):
    """Rank r's shard of the full-weight dict: [q_r | k_r | v_r] and
    [gate_r | up_r] column blocks, w_o's and w_d's row blocks, the norms
    and rope rows whole."""
    hq, hkv, f = HQ // N * HD, HKV // N * HD, F // N
    qkv = w["w_qkv"]
    q, k, v = qkv[:, :HQ * HD], qkv[:, HQ * HD:(HQ + HKV) * HD], qkv[:, (HQ + HKV) * HD:]
    gu = w["w_gu"]
    out = dict(w)
    out["w_qkv"] = np.concatenate([q[:, r * hq:(r + 1) * hq], k[:, r * hkv:(r + 1) * hkv],
                                   v[:, r * hkv:(r + 1) * hkv]], 1)
    out["w_o"] = w["w_o"][r * hq:(r + 1) * hq]
    out["w_gu"] = np.concatenate([gu[:, r * f:(r + 1) * f], gu[:, F + r * f:F + (r + 1) * f]], 1)
    out["w_d"] = w["w_d"][r * f:(r + 1) * f]
    return {k_: torch.from_numpy(np.ascontiguousarray(a)) for k_, a in out.items()}


def test_mega_tp_layer_matches_jax_oracle():
    """MegaDecodeLayer(tp=4) on the ranks' shards against the JAX
    full-weight oracle mega_decode_layer_ref (f32, highest precision), at
    the JAX TP test's tolerances: y to 5e-2, the caches to 1e-2. Then
    against the port's tp=1 plain layer on the whole weights: y within
    1e-5 (1 + max|y|) (the same bf16 roundings, f32 sums grouped by rank),
    the new cache rows within one bf16 ulp of the row's largest value (a
    K/V column block summed apart may round the other way), every other
    cache row bitwise; and every rank's y bitwise equal (each rank folds
    the same partials in the same order)."""
    x, w, ck, cv = _layer_inputs()
    with jax.default_matmul_precision("highest"):
        ry, rck, rcv = jax_mega_ref(jnp.asarray(x), POS, {k: jnp.asarray(v) for k, v in w.items()},
                                    jnp.asarray(ck, jnp.bfloat16), jnp.asarray(cv, jnp.bfloat16),
                                    n_heads=HQ, n_kv_heads=HKV, head_dim=HD)
    ry = np.asarray(ry)
    rck = np.asarray(rck.astype(jnp.float32)).transpose(1, 0, 2, 3)
    rcv = np.asarray(rcv.astype(jnp.float32)).transpose(1, 0, 2, 3)

    kt = torch.from_numpy(ck.astype(np.float32).transpose(1, 0, 2, 3)).bfloat16().contiguous()
    vt = torch.from_numpy(cv.astype(np.float32).transpose(1, 0, 2, 3)).bfloat16().contiguous()
    hkv = HKV // N
    cks = [kt[:, r * hkv:(r + 1) * hkv].clone() for r in range(N)]
    cvs = [vt[:, r * hkv:(r + 1) * hkv].clone() for r in range(N)]
    xt = torch.from_numpy(x)
    layer = MegaDecodeLayer(d_model=D, n_heads=HQ // N, n_kv_heads=hkv, head_dim=HD,
                            ffn=F // N, T=T, tp=N)
    assert [t.name for t in layer.program.tasks] == [
        "ln1", "qkv_mm", "attend", "o_proj", "o_allreduce", "ln2", "gate_up_swiglu",
        "down_proj", "d_allreduce"]
    ys, k2, v2 = layer([xt] * N, POS, [_rank_weights(w, r) for r in range(N)], cks, cvs)
    assert all(a is b for a, b in zip(k2 + v2, cks + cvs))          # updated in place
    for y in ys[1:]:
        assert torch.equal(y, ys[0])
    np.testing.assert_allclose(ys[0].numpy(), ry, atol=0.05, rtol=0.05)
    got_k, got_v = torch.cat(cks, 1).float().numpy(), torch.cat(cvs, 1).float().numpy()
    np.testing.assert_allclose(got_k, rck, atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(got_v, rcv, atol=1e-2, rtol=1e-2)

    # the port's tp=1 plain layer, and the TP plain version by name
    k1, v1 = kt.clone(), vt.clone()
    wt = {k_: torch.from_numpy(a) for k_, a in w.items()}
    y1, _, _ = mega_decode_layer_ref(xt, POS, wt, k1, v1, n_heads=HQ, n_kv_heads=HKV,
                                     head_dim=HD)
    err = (ys[0] - y1).abs().max().item()
    assert err <= 1e-5 * (1 + y1.abs().max().item()), err
    for got, want in ((torch.cat(cks, 1), k1), (torch.cat(cvs, 1), v1)):
        new = (got[:, :, POS].float() - want[:, :, POS].float()).abs().max().item()
        assert new <= 2 ** -7 * want[:, :, POS].float().abs().max().item(), new
        other = torch.arange(T) != POS
        assert torch.equal(got[:, :, other], want[:, :, other])
    cks3 = [kt[:, r * hkv:(r + 1) * hkv].clone() for r in range(N)]
    cvs3 = [vt[:, r * hkv:(r + 1) * hkv].clone() for r in range(N)]
    ys3, _, _ = mega_decode_layer_ref([xt] * N, POS, [_rank_weights(w, r) for r in range(N)],
                                      cks3, cvs3, n_heads=HQ // N, n_kv_heads=hkv, head_dim=HD,
                                      tp=N)
    for a, b in zip(ys3, ys):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def jax_tiny_tp4():
    """The JAX tiny bf16 model over four devices: its parameters and its
    "xla" engine (the oracle of the JAX TP mega engine test)."""
    jm = JaxAutoLLM.from_config(jax_tiny_qwen3(N, **TINY), _jmesh())
    return jm, _jax_arrays(jm)


def _port(arrays, mesh=None):
    return from_jax_arrays(tiny_qwen3(N, **TINY), arrays, device="cpu", mesh=mesh,
                           jax_tp=N)


def test_mega_tp_weights_are_the_jax_split(jax_tiny_tp4):
    """A model carried from JAX at tp=4 and split over the port's mesh:
    each rank's megakernel weight dict is the JAX engine's contiguous
    column split of the packed w_qkv and w_gate_up and row split of w_o
    and w_down (`_mega_scan_decode_fn`'s shard specs), bitwise."""
    _, arrays = jax_tiny_tp4
    eng = Engine(_port(arrays, _mesh()), max_seq=MAX_SEQ, backend="mega", device="cpu")
    weights = engine_mod._mega_setup(eng)
    assert len(weights) == N and len(weights[0]) == tiny_qwen3(N, **TINY).num_layers
    for li in range(len(weights[0])):
        for name, key, axis in (("w_qkv", "attn.w_qkv", 1), ("w_o", "attn.w_o", 0),
                                ("w_gu", "mlp.w_gate_up", 1), ("w_d", "mlp.w_down", 0)):
            whole = np.asarray(jnp.asarray(arrays[f"layers.{li}.{key}"]).astype(jnp.float32))
            blocks = np.split(whole, N, axis=axis)
            for r in range(N):
                got = weights[r][li][name]
                assert got.dtype == torch.bfloat16
                np.testing.assert_array_equal(got.float().numpy(), blocks[r])
        for r in range(N):
            np.testing.assert_array_equal(
                weights[r][li]["w_ln1"].numpy()[0],
                np.asarray(jnp.asarray(arrays[f"layers.{li}.ln_attn"]).astype(jnp.float32)))


def _jax_forced(jm, toks):
    """The JAX tp=4 "xla" logits at prefill and along toks, teacher-forced."""
    eng = JaxEngine(jm, max_seq=MAX_SEQ, backend="xla")
    logits, cache = eng.prefill(IDS)
    out = [np.asarray(logits)]
    step = jax.jit(lambda m, t, c: m.forward_tokens(t, c, mode="xla"))
    for t in range(toks.shape[1] - 1):
        logits, cache = step(jm, jnp.asarray(toks[:, t:t + 1]), cache)
        out.append(np.asarray(logits))
    return out


def test_mega_tp_engine_matches_jax_xla(jax_tiny_tp4):
    """Engine(backend="mega") at tp=4 serves, and every token it chose
    sits within 0.05 of the JAX tp=4 "xla" engine's top logit, the
    teacher-forced margin rule of tests/test_mega.py (bf16 dots and a
    deterministic f32 fold: a near tie may part the streams, a drift
    shows as a large gap). Then its teacher-forced logits against the
    port's mega engine at tp=1 on the same weights: within 2e-2 of the
    largest logit (the two prefill on "flash", whose tp=4 form sums the
    ranks' bf16 projections apart; the decode layers differ only in how
    the f32 sums group by rank)."""
    jm, arrays = jax_tiny_tp4
    mesh = _mesh()
    eng = Engine(_port(arrays, mesh), max_seq=MAX_SEQ, backend="mega", device="cpu")
    toks = eng.serve(IDS, GEN).numpy()
    assert toks.shape == (IDS.shape[0], GEN)
    want = _jax_forced(jm, toks)
    for i in range(GEN):
        chosen = np.take_along_axis(want[i], toks[:, i][:, None], axis=1)[:, 0]
        gap = want[i].max(-1) - chosen
        assert (gap <= 0.05).all(), (i, gap, toks)

    one = Engine(_port(arrays), max_seq=MAX_SEQ, backend="mega", device="cpu")
    l4, c4 = eng.prefill(IDS)
    l1, c1 = one.prefill(IDS)
    assert c4.ranks is not None and len(c4.ranks) == N
    for t in range(GEN):
        err = (l4 - l1).abs().max().item()
        assert err <= 2e-2 * l1.abs().max().item(), (t, err)
        if t + 1 < GEN:
            tok = torch.from_numpy(toks[:, t])
            l4, l1 = eng.decode_step(tok, c4), one.decode_step(tok, c1)
    assert c4.offset == IDS.shape[1] + GEN - 1


def test_mega_tp_refusals():
    """As the JAX engine: heads, kv heads or intermediate_size that the
    mesh does not divide refuse "mega" (a split model always divides, so
    the config is edited), and the TP paged pool refuses the fused tick."""
    m4 = _port_random()
    cfg = m4.config
    for field in ("num_heads", "num_kv_heads", "intermediate_size"):
        bad = dataclasses.replace(m4, config=dataclasses.replace(
            cfg, **{field: getattr(cfg, field) + 2}))
        with pytest.raises(ValueError, match="divisible"):
            Engine(bad, max_seq=MAX_SEQ, backend="mega", device="cpu")
    eng = Engine(m4, max_seq=MAX_SEQ, backend="mega", device="cpu")
    with pytest.raises(ValueError, match="fuses the paged tick single-chip only"):
        eng.make_paged_slot_cache(2)
    with pytest.raises(ValueError, match="fuses the paged tick single-chip only"):
        ContinuousScheduler(eng, batch=2, chunk=4, paged=True, page=8)


def _port_random():
    from triton_dist_tpu_torch.models import DenseLLM
    return DenseLLM.random_init(tiny_qwen3(N, **TINY), seed=0, mesh=_mesh())
