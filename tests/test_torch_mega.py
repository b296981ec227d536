"""The port's megakernel decode path (triton_dist_tpu_torch.mega,
Engine(backend="mega"), the paged scheduler on it) against the JAX
package, plus its refusals.

The port runs on the CPU (device="cpu"), where each megakernel layer
runs its plain version: the task program's PyTorch emitters, which round
where the CUDA kernel rounds (bf16 activations and weights into every
product with f32 sums, q and P in bf16, an f32 SwiGLU epilogue, an f32
residual stream). The JAX layers run their Pallas kernels in interpret
mode or their jnp oracles. Inputs are made with numpy from a seed and
handed to both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.mega import MegaDecodeLayer as JaxMegaDecodeLayer
from triton_dist_tpu.mega import MegaPagedDecodeLayer as JaxMegaPagedDecodeLayer
from triton_dist_tpu.mega import mega_paged_decode_layer_ref as jax_paged_ref
from triton_dist_tpu.models import AutoLLM as JaxAutoLLM
from triton_dist_tpu.models import Engine as JaxEngine
from triton_dist_tpu.models.config import tiny_qwen3 as jax_tiny_qwen3
from triton_dist_tpu_torch.mega import (MegaDecodeLayer, MegaKernelBuilder,
                                        MegaPagedDecodeLayer, mega_paged_decode_layer_ref)
from triton_dist_tpu_torch.models import (AutoLLM, ContinuousScheduler, Engine, Request,
                                          tiny_qwen3)
from triton_dist_tpu_torch.models.convert import from_jax_arrays
from test_torch_engine import _jax_arrays
from test_torch_serving import _requests

# the JAX test's geometry (tests/test_mega.py, tests/test_mega_paged.py)
D, Hq, Hkv, HD, F = 256, 4, 2, 64, 512
PAGED_GEO = dict(B=3, page=8, maxp=6, NP=40)
# the tiny model of tests/test_mega.py::test_mega_engine_backend_matches_flash
TINY = dict(hidden_size=128, intermediate_size=256, num_heads=2, num_kv_heads=1,
            head_dim=64, dtype="bfloat16", max_position_embeddings=256)


def _weights(rng):
    sc = 0.3 / np.sqrt(D)
    return {
        "w_ln1": (1 + 0.1 * rng.randn(1, D)).astype(np.float32),
        "w_qkv": (rng.randn(D, (Hq + 2 * Hkv) * HD) * sc).astype(np.float32),
        "q_norm": (1 + 0.1 * rng.randn(1, HD)).astype(np.float32),
        "k_norm": (1 + 0.1 * rng.randn(1, HD)).astype(np.float32),
        "w_o": (rng.randn(Hq * HD, D) * sc).astype(np.float32),
        "w_ln2": (1 + 0.1 * rng.randn(1, D)).astype(np.float32),
        "w_gu": (rng.randn(D, 2 * F) * sc).astype(np.float32),
        "w_d": (rng.randn(F, D) * (0.3 / np.sqrt(F))).astype(np.float32),
    }


def _rope_rows(pos):
    """cos/sin rows [len(pos), HD/2] at the given positions (f32)."""
    inv = 1.0 / (1e6 ** (np.arange(0, HD, 2) / HD))
    f = np.asarray(pos, np.float64)[:, None] * inv[None]
    return np.cos(f).astype(np.float32), np.sin(f).astype(np.float32)


def _bf16(a):
    """numpy f32 -> (jax bf16 array, torch bf16 tensor) of the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


def _t(w):
    return {k: torch.from_numpy(np.array(v)) for k, v in w.items()}


def test_builder_rejects_misordered_program():
    """As the JAX builder: a task reading a buffer no task wrote, or
    naming an undeclared buffer, fails when it is added."""
    b = MegaKernelBuilder()
    b.inputs("x", "y")
    b.buffer("tmp", (4, 4), torch.float32)
    with pytest.raises(ValueError, match="before any task wrote"):
        b.add_task("use_tmp", lambda env: None, reads=("tmp",), writes=("y",))
    with pytest.raises(ValueError, match="undeclared"):
        b.add_task("typo", lambda env: None, reads=("x",), writes=("tmpp",))
    b.add_task("make_tmp", lambda env: None, reads=("x",), writes=("tmp",))
    b.add_task("use_tmp", lambda env: None, reads=("tmp",), writes=("y",))
    assert [t.name for t in b.tasks] == ["make_tmp", "use_tmp"]
    # the port's layers record the kernel's phases in this order
    layer = MegaDecodeLayer(d_model=D, n_heads=Hq, n_kv_heads=Hkv, head_dim=HD, ffn=F,
                            T=16)
    assert [t.name for t in layer.program.tasks] == [
        "ln1", "qkv_mm", "attend", "o_proj", "ln2", "gate_up_swiglu", "down_proj"]


@pytest.mark.parametrize("pos", [0, 7, 130])
def test_mega_decode_layer_matches_pallas(pos):
    """MegaDecodeLayer on the CPU against the JAX MegaDecodeLayer in
    interpret mode (B=4, D=256, Hq=4, Hkv=2, hd=64, F=512, T=256).
    Tolerances: y to 2e-2 (1 + max|y|): both keep the residual in f32 and
    round the same intermediates to bf16, but sum in other orders and
    the JAX kernel's online softmax rounds P against a running max over
    128-key tiles, so a bf16 rounding of an intermediate can land one ulp
    apart; the new cache rows to one bf16 ulp of the row's largest value
    (the f32 row rounds once); every other cache row bitwise."""
    B, T = 4, 256
    rng = np.random.RandomState(pos)
    w = _weights(rng)
    x = (rng.randn(B, D) * 0.3).astype(np.float32)
    ck = (rng.randn(Hkv, B, T, HD) * 0.3).astype(np.float32)
    cv = (rng.randn(Hkv, B, T, HD) * 0.3).astype(np.float32)
    c, s = _rope_rows([pos])
    jck, tck = _bf16(ck)
    jcv, tcv = _bf16(cv)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    jw.update(cos_row=jnp.asarray(c), sin_row=jnp.asarray(s))
    jlayer = JaxMegaDecodeLayer(d_model=D, n_heads=Hq, n_kv_heads=Hkv, head_dim=HD, ffn=F,
                                T=T)
    with jax.default_matmul_precision("highest"):
        jy, jk, jv = jax.jit(lambda *a: jlayer(*a))(jnp.asarray(x), jnp.int32(pos), jw,
                                                    jck, jcv)
    layer = MegaDecodeLayer(d_model=D, n_heads=Hq, n_kv_heads=Hkv, head_dim=HD, ffn=F, T=T)
    tw = _t(w)
    tw.update(cos_row=torch.from_numpy(c), sin_row=torch.from_numpy(s))
    k, v = tck.transpose(0, 1).contiguous(), tcv.transpose(0, 1).contiguous()
    y, k2, v2 = layer(torch.from_numpy(x), pos, tw, k, v)
    assert k2 is k and v2 is v                       # updated in place
    jy = np.asarray(jy)
    assert y.dtype == torch.float32
    err = np.abs(y.numpy() - jy).max()
    assert err <= 2e-2 * (1 + np.abs(jy).max()), err
    for got, want in ((k, jk), (v, jv)):
        got = got.float().numpy().transpose(1, 0, 2, 3)
        want = np.asarray(want.astype(jnp.float32))
        new = np.abs(got[:, :, pos] - want[:, :, pos])
        assert new.max() <= 2 ** -7 * np.abs(want[:, :, pos]).max(), new.max()
        other = np.arange(T) != pos
        np.testing.assert_array_equal(got[:, :, other], want[:, :, other])


def _paged_case(kind, seed):
    """A paged layer case in the JAX test's geometry: slots at positions
    5, 13 (crossing into the second page) and 7, slot 2 retired (its table
    rows all the trash page 0), two mapped pages per live stream."""
    B, page, maxp, NP = (PAGED_GEO[k] for k in ("B", "page", "maxp", "NP"))
    rng = np.random.RandomState(seed)
    w = _weights(rng)
    pos = np.array([5, 13, 7], np.int32)
    c, s = _rope_rows(pos)
    x = (rng.randn(B, D) * 0.3).astype(np.float32)
    table = np.zeros((B * Hkv, maxp), np.int32)
    table[:2 * Hkv, :2] = 1 + np.arange(2 * Hkv * 2).reshape(2 * Hkv, 2)
    if kind == "int8":
        pools = [rng.randint(-127, 128, (NP, 1, page, HD)).astype(np.int8),
                 rng.randint(-127, 128, (NP, 1, page, HD)).astype(np.int8),
                 (0.01 + 0.01 * rng.rand(NP, 1, page)).astype(np.float32),
                 (0.01 + 0.01 * rng.rand(NP, 1, page)).astype(np.float32)]
        jpools = [jnp.asarray(p) for p in pools]
        tpools = [torch.from_numpy(p.copy()) for p in pools]
    else:
        jpools, tpools = [], []
        for _ in range(2):
            j, t = _bf16((rng.randn(NP, 1, page, HD) * 0.3).astype(np.float32))
            jpools.append(j)
            tpools.append(t)
    return w, x, pos, c, s, table, jpools, tpools


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_mega_paged_ref_matches_jax_oracle(kind):
    """The paged plain version against JAX mega_paged_decode_layer_ref
    (all-f32 jnp). Live rows of y to 5e-2 (the JAX package's own bound
    between its bf16 kernel and this f32 oracle); the written rows: bf16
    to 2e-2 absolute (the row comes out of bf16 products here, f32 ones
    there), int8 payload within 2 levels and scales to 5% (as the JAX
    test holds its kernel); every other page bitwise, the trash page
    (slot 2's write sink) excepted."""
    w, x, pos, c, s, table, jpools, tpools = _paged_case(kind, seed=4)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    jw.update(cos_row=jnp.asarray(c), sin_row=jnp.asarray(s))
    with jax.default_matmul_precision("highest"):
        ref = jax_paged_ref(jnp.asarray(x), jnp.asarray(pos), jw, *jpools[:2],
                            jnp.asarray(table), *jpools[2:], n_heads=Hq, n_kv_heads=Hkv,
                            head_dim=HD)
    tw = _t(w)
    tw.update(cos_row=torch.from_numpy(c), sin_row=torch.from_numpy(s))
    before = [t.clone() for t in tpools]
    got = mega_paged_decode_layer_ref(torch.from_numpy(x), torch.from_numpy(pos), tw,
                                      *tpools[:2], torch.from_numpy(table), *tpools[2:],
                                      n_heads=Hq, n_kv_heads=Hkv, head_dim=HD)
    assert len(got) == len(ref) == 1 + len(tpools)
    np.testing.assert_allclose(got[0][:2].numpy(), np.asarray(ref[0])[:2], atol=5e-2,
                               rtol=5e-2)
    page = PAGED_GEO["page"]
    pidx = table[np.arange(2 * Hkv), np.repeat(pos[:2], Hkv) // page]
    r = np.repeat(pos[:2], Hkv) % page
    written = np.zeros((PAGED_GEO["NP"], page), bool)
    written[pidx, r] = True
    untouched = ~written
    untouched[0] = False
    for i, (g, want, b) in enumerate(zip(got[1:], ref[1:], before)):
        g = g.float().numpy()[:, 0]
        want = np.asarray(want.astype(jnp.float32))[:, 0]
        np.testing.assert_array_equal(g[untouched], b.float().numpy()[:, 0][untouched])
        if kind == "bf16":
            np.testing.assert_allclose(g[written], want[written], atol=2e-2)
        elif i < 2:
            np.testing.assert_allclose(g[written], want[written], atol=2.0)
        else:
            np.testing.assert_allclose(g[written], want[written], rtol=0.05)


@pytest.mark.slow   # the JAX paged megakernel in interpret mode is slow-marked there too
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_mega_paged_layer_matches_pallas(kind):
    """MegaPagedDecodeLayer on the CPU against the JAX MegaPagedDecodeLayer
    in interpret mode: live rows of y to 2e-2 (1 + max|y|), the reasons
    of test_mega_decode_layer_matches_pallas."""
    w, x, pos, c, s, table, jpools, tpools = _paged_case(kind, seed=5)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    jw.update(cos_row=jnp.asarray(c), sin_row=jnp.asarray(s))
    jl = JaxMegaPagedDecodeLayer(d_model=D, n_heads=Hq, n_kv_heads=Hkv, head_dim=HD, ffn=F,
                                 page=PAGED_GEO["page"], maxp=PAGED_GEO["maxp"],
                                 block_n=128)
    with jax.default_matmul_precision("highest"):
        jy = np.asarray(jax.jit(lambda *a: jl(*a))(
            jnp.asarray(x), jnp.asarray(pos), jw, *jpools[:2], jnp.asarray(table),
            *jpools[2:])[0])
    layer = MegaPagedDecodeLayer(d_model=D, n_heads=Hq, n_kv_heads=Hkv, head_dim=HD,
                                 ffn=F, page=PAGED_GEO["page"], maxp=PAGED_GEO["maxp"])
    tw = _t(w)
    tw.update(cos_row=torch.from_numpy(c), sin_row=torch.from_numpy(s))
    y = layer(torch.from_numpy(x), torch.from_numpy(pos), tw, *tpools[:2],
              torch.from_numpy(table), *tpools[2:])[0].numpy()
    err = np.abs(y[:2] - jy[:2]).max()
    assert err <= 2e-2 * (1 + np.abs(jy[:2]).max()), err


def test_mega_engine_serve_matches_jax():
    """Engine(backend="mega").serve on the port against the JAX
    Engine(backend="mega").serve on the tiny model of the JAX mega engine
    test (bf16, 2 layers, hd=64), carried weights. The JAX mega scan
    returns tokens only, so the logits are held teacher-forced against
    the JAX model's forward_tokens (its flash backend, which the JAX mega
    engine matches token for token in its own test) to 2e-2 of the
    largest logit (bf16 through two layers: the JAX package's own flash
    and xla backends differ by 1.5% of it on such inputs); the port's
    free-running tokens must equal the JAX mega tokens wherever the JAX
    top-2 margin exceeds twice that."""
    B, S, GEN, MAX_SEQ = 2, 8, 5, 64
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("tp",))
    jm = JaxAutoLLM.from_config(jax_tiny_qwen3(1, **TINY), mesh)
    ids = np.random.RandomState(0).randint(0, 256, (B, S)).astype(np.int32)
    jtoks = np.asarray(JaxEngine(jm, max_seq=MAX_SEQ, backend="mega").serve(ids, GEN))
    logits, cache = JaxEngine(jm, max_seq=MAX_SEQ, backend="flash").prefill(ids)
    step = jax.jit(lambda m, t, c: m.forward_tokens(t, c, mode="flash"))
    want = [np.asarray(logits)]
    for t in range(GEN - 1):
        logits, cache = step(jm, jnp.asarray(jtoks[:, t:t + 1]), cache)
        want.append(np.asarray(logits))

    model = from_jax_arrays(tiny_qwen3(1, **TINY), _jax_arrays(jm), device="cpu")
    eng = Engine(model, max_seq=MAX_SEQ, backend="mega", device="cpu")
    got, cache = eng.prefill(ids)
    checked = 0
    for t in range(GEN):
        tol = 2e-2 * np.abs(want[t]).max()
        err = np.abs(got.numpy() - want[t]).max()
        assert err <= tol, f"step {t}: max|d logits| {err} > {tol}"
        if t + 1 < GEN:
            got = eng.decode_step(torch.from_numpy(jtoks[:, t]), cache)
    assert cache.offset == S + GEN - 1
    toks = eng.serve(ids, GEN).numpy()
    for b in range(B):
        for t in range(GEN):
            top2 = np.sort(want[t][b])[-2:]
            if top2[1] - top2[0] <= 2 * 2e-2 * np.abs(want[t]).max():
                break               # the streams may part here legitimately
            assert toks[b, t] == jtoks[b, t], (b, t)
            checked += 1
    assert checked > 0


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_mega_paged_scheduler_streams(kv):
    """Paged ContinuousScheduler streams on an Engine(backend="mega")
    (tiny bf16 model; int8: the int8 KV pool with bf16 weights, as the
    megakernel takes them), held teacher-forced to the plain contiguous
    engine: each emitted token must be its argmax wherever its top-2
    margin exceeds twice 5e-2 of the largest logit (chip_smoke.py's rule;
    the flash streams are held so in tests/test_torch_serving.py). The
    prefix cache hits, and the mega_enabled gauge reads 1 on mega, 0 on
    flash."""
    model = AutoLLM.from_config(tiny_qwen3(1, **TINY), device="cpu", seed=0)
    kv_dtype = torch.int8 if kv == "int8" else None
    reqs = _requests(Request, 256)
    eng = Engine(model, max_seq=48, backend="mega", kv_dtype=kv_dtype, device="cpu")
    sched = ContinuousScheduler(eng, batch=3, chunk=4, paged=True, page=8)
    streams = sched.run(reqs)
    st = sched.stats()
    assert not sched.rejected and st["hits"] > 0 and st["mega_enabled"] == 1.0
    flash = Engine(model, max_seq=48, backend="flash", kv_dtype=kv_dtype, device="cpu")
    assert ContinuousScheduler(flash, batch=3, chunk=4, paged=True,
                               page=8).stats()["mega_enabled"] == 0.0
    ref = Engine(model, max_seq=48, backend="xla", kv_dtype=kv_dtype, device="cpu")
    checked = 0
    for r in reqs:
        toks = streams[r.rid]
        assert len(toks) == r.gen_len
        logits, cache = ref.prefill(r.ids[None])
        for t in range(r.gen_len):
            tol = 5e-2 * logits.abs().max().item()
            top2 = logits[0].topk(2).values
            if (top2[0] - top2[1]).item() > 2 * tol:
                assert int(logits[0].argmax()) == int(toks[t]), (r.rid, t)
                checked += 1
            logits = ref.decode_step(torch.tensor([int(toks[t])]), cache)
    assert checked > 0


def test_mega_refusals():
    """Every capability the mega path lacks refuses, as in the JAX engine
    and scheduler, and the tensor-parallel layer refuses a call that does
    not give one tensor a rank."""
    model = AutoLLM.from_config(tiny_qwen3(1, **TINY), device="cpu", seed=0)

    def eng(m=model, **kw):
        return Engine(m, max_seq=32, backend="mega", device="cpu", **kw)

    moe = dataclasses.replace(model, config=dataclasses.replace(model.config,
                                                                num_experts=4))
    for m, kw, match in ((moe, {}, "dense"), (model.quantize_int8(), {}, "bf16 weight"),
                         (model, dict(kv_dtype=torch.bfloat16), "kv_dtype"),
                         (model, dict(sampling="top_k"), "GREEDY")):
        with pytest.raises(ValueError, match=match):
            eng(m, **kw)
    ids = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError, match="PAGED pool"):
        eng(kv_dtype=torch.int8).serve(ids, 2)
    e = eng()
    cache = e.make_slot_cache(1)
    with pytest.raises(ValueError, match="PAGED decode tick"):
        e.slot_chunk(torch.zeros(1, 256), cache, torch.zeros(1, dtype=torch.int32),
                     torch.ones(1, dtype=torch.bool), chunk=2)
    with pytest.raises(ValueError, match="PAGED decode tick"):
        ContinuousScheduler(e, batch=2, paged=False)
    tp2 = MegaDecodeLayer(d_model=D, n_heads=Hq, n_kv_heads=Hkv, head_dim=HD, ffn=F, T=16,
                          tp=2)
    with pytest.raises(ValueError, match="lists of 2"):
        tp2(torch.zeros(1, D), 0, {}, torch.zeros(1, Hkv, 16, HD), torch.zeros(1, Hkv, 16, HD))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Engine(model, backend="mega")
