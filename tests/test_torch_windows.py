"""The port's window path (speculative decoding, spec=K, and chunked
prefill, prefill_budget) against the JAX package, plus the port's own
invariances.

- Kernels: flash_decode and flash_decode_paged in their q_lens window
  forms (on the CPU: their plain versions) against the JAX Pallas
  kernels in interpret mode and attention_cached_ref, f32, bf16 and
  int8, q_lens 0, 1 and S with padding positions; the cache past each
  row's length holds 100x values. Valid positions are compared; padding
  positions must be finite.
- NgramDrafter.propose and accept_greedy against JAX on seeded inputs.
- The dense window forwards (contiguous and paged) and the engine's
  slot_mixed_chunk and paged_slot_verify_chunk against the JAX ones on
  carried tiny_qwen3 weights: logits, emitted tokens, positions and the
  written cache rows, with a trailing cache column and pool pages (the
  trash page included) poisoned, which must come out as the JAX ones
  (untouched).
- ContinuousScheduler(spec=2, prefill_budget=4), contiguous and paged,
  against the JAX scheduler by the teacher-forced margin rule.
- Inside the port, bitwise: chunked == monolithic == Engine.serve, spec
  on == off (n-gram, always-right and always-wrong drafters), with
  preemption under a tiny pool (mid-prefill included) and int8 KV; one
  dropless tiny_qwen3_moe mixed tick.

The port runs on the CPU (device="cpu"), where its kernel wrappers take
their plain PyTorch versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from triton_dist_tpu.kernels.flash_attn import attention_cached_ref as jax_attention_ref
from triton_dist_tpu.kernels.flash_attn import flash_decode as jax_flash_decode
from triton_dist_tpu.kernels.paged_kv import flash_decode_paged as jax_flash_decode_paged
from triton_dist_tpu.kernels.quant import quantize_kv_int8 as jax_quantize_kv_int8
from triton_dist_tpu.models import AutoLLM as JaxAutoLLM
from triton_dist_tpu.models import ContinuousScheduler as JaxScheduler
from triton_dist_tpu.models import Engine as JaxEngine
from triton_dist_tpu.models import Request as JaxRequest
from triton_dist_tpu.models.config import tiny_qwen3 as jax_tiny_qwen3
from triton_dist_tpu.models.config import tiny_qwen3_moe as jax_tiny_qwen3_moe
from triton_dist_tpu.models.kv_cache import KVCache as JaxKVCache
from triton_dist_tpu.models.kv_cache import PagedSlotCache as JaxPagedSlotCache
from triton_dist_tpu.models.spec_decode import NgramDrafter as JaxNgramDrafter
from triton_dist_tpu.models.spec_decode import accept_greedy as jax_accept_greedy
from triton_dist_tpu_torch.kernels import flash_decode, flash_decode_paged
from triton_dist_tpu_torch.models import (AutoLLM, ContinuousScheduler, Engine, Request,
                                          tiny_qwen3, tiny_qwen3_moe)
from triton_dist_tpu_torch.models.convert import from_jax_arrays, to_torch
from triton_dist_tpu_torch.models.kv_cache import KVCache, PagedSlotCache
from triton_dist_tpu_torch.models.spec_decode import NgramDrafter, accept_greedy
from test_torch_engine import _jax_arrays
from test_torch_moe import _jax_moe_arrays
from test_torch_serving import _requests

MAX_SEQ, BATCH, CHUNK, PAGE = 48, 3, 4, 8


def _mesh():
    # Auto axes: the JAX paged programs fail their sharding checks under
    # the Explicit default of this JAX version (ROADMAP Queue 3)
    return jax.make_mesh((1,), ("tp",), axis_types=(AxisType.Auto,))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a):
    return to_torch(np.asarray(a))


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


def _assert_valid_close(kind, got, want, q_lens, atol_f32=5e-5):
    """Valid window positions of got (torch) against want: f32 the same
    math summed in another order; bf16 and int8 within 2^-6 of the
    largest output (bf16 output rounding plus the Pallas kernel's bf16
    rounding of P, which the plain version keeps in f32). Every position,
    padding included, must be finite."""
    S = got.shape[1]
    valid = np.arange(S)[None] < np.asarray(q_lens)[:, None]
    g, w = _np(got)[valid], _np(want)[valid]
    assert np.isfinite(_np(got)).all()
    if kind == "f32":
        np.testing.assert_allclose(g, w, atol=atol_f32, rtol=1e-5)
    else:
        assert np.abs(g - w).max() <= 2.0 ** -6 * np.abs(w).max()


# windows: q_lens 0 (a starved prefill row, no key at all in row 4), 1
# (a decode row), S and in between; lengths end mid-tile and at T
Q_LENS = np.asarray([0, 1, 5, 3, 0], np.int32)
KV_LENS = np.asarray([4, 9, 21, 32, 0], np.int32)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_flash_decode_window_matches_jax(kind):
    """flash_decode(q_lens=) against the Pallas kernel in interpret mode
    and attention_cached_ref on the valid positions; the cache past each
    row's length holds 100x values."""
    B, S, Hq, Hkv, T, d = 5, 5, 4, 2, 32, 32
    rng = np.random.RandomState(21 + len(kind))
    q = jnp.asarray(rng.randn(B, S, Hq, d) * 0.5, jnp.float32)
    kv = rng.randn(2, B, Hkv, T, d) * 0.5
    for b, n in enumerate(KV_LENS):
        kv[:, b, :, n:] *= 100
    q, k, v, kw = _cast(kind, q, jnp.asarray(kv[0], jnp.float32),
                        jnp.asarray(kv[1], jnp.float32))
    lens, qls = jnp.asarray(KV_LENS), jnp.asarray(Q_LENS)
    with jax.default_matmul_precision("highest"):
        want = jax_flash_decode(q, k, v, int(KV_LENS.max()), kv_lens=lens, q_lens=qls, **kw)
        kf, vf = k.astype(jnp.float32), v.astype(jnp.float32)
        if kw:
            kf, vf = kf * kw["k_scale"][..., None], vf * kw["v_scale"][..., None]
        oracle = jax_attention_ref(q.astype(jnp.float32), kf, vf, lens, q_lens=qls)
    got = flash_decode(_t(q), _t(k), _t(v), kv_lens=torch.from_numpy(KV_LENS),
                       q_lens=torch.from_numpy(Q_LENS), **{n: _t(a) for n, a in kw.items()})
    assert got.dtype == (torch.float32 if kind == "f32" else torch.bfloat16)
    _assert_valid_close(kind, got, want, Q_LENS)
    # the oracle in f32 on the same (dequantized) inputs: f32 at 1e-5;
    # bf16/int8 within the port's output rounding
    _assert_valid_close(kind, got, oracle, Q_LENS, atol_f32=1e-5)
    # a row with q_len 0 and no key gives zeros, as the kernel does
    assert float(got[4].abs().max()) == 0.0


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_flash_decode_paged_window_matches_jax(kind):
    """flash_decode_paged(q_lens=) against the Pallas paged kernel through
    a shuffled table: pages a random permutation of the pool, entries
    past each stream's pages random pages, every pool row no stream reads
    (the trash page 0 included) at 100x."""
    B, S, Hq, Hkv, d, page, maxp = 5, 5, 4, 2, 32, 8, 4
    X = B * Hkv
    NP = 1 + X * maxp + 3
    rng = np.random.RandomState(31 + len(kind))
    table = (1 + rng.permutation(NP - 1)[:X * maxp]).reshape(X, maxp).astype(np.int32)
    pools = rng.randn(2, NP, page, d) * 0.5
    used = np.zeros((NP, page), bool)
    for x in range(X):
        n = int(KV_LENS[x // Hkv])
        npg = -(-n // page)
        for t in range(n):
            used[table[x, t // page], t % page] = True
        table[x, npg:] = rng.randint(0, NP, maxp - npg)
    pools[:, ~used] *= 100
    q = jnp.asarray(rng.randn(B, S, Hq, d) * 0.5, jnp.float32)
    q, pk, pv, kw = _cast(kind, q, jnp.asarray(pools[0], jnp.float32),
                          jnp.asarray(pools[1], jnp.float32))
    with jax.default_matmul_precision("highest"):
        want = jax_flash_decode_paged(q, pk, pv, jnp.asarray(table), int(KV_LENS.max()),
                                      kv_lens=jnp.asarray(KV_LENS),
                                      q_lens=jnp.asarray(Q_LENS), **kw)
    got = flash_decode_paged(_t(q), _t(pk), _t(pv), torch.from_numpy(table),
                             kv_lens=torch.from_numpy(KV_LENS),
                             q_lens=torch.from_numpy(Q_LENS),
                             **{n: _t(a) for n, a in kw.items()})
    assert got.shape == (B, S, Hq, d)
    _assert_valid_close(kind, got, want, Q_LENS)


def test_drafter_and_accept_greedy_match_jax():
    """NgramDrafter.propose on seeded periodic and random histories (all
    k, window cuts, n-gram lengths) and accept_greedy on seeded windows
    with planted matching prefixes: the JAX functions' outputs."""
    rng = np.random.RandomState(8)
    for trial in range(40):
        L = int(rng.randint(1, 40))
        vocab = int(rng.choice([3, 5, 50]))
        hist = rng.randint(0, vocab, L).astype(np.int32)
        kw = dict(max_n=int(rng.randint(1, 4)), window=int(rng.choice([8, 1024])))
        for k in range(0, 5):
            assert (NgramDrafter(**kw).propose(hist, k)
                    == JaxNgramDrafter(**kw).propose(hist, k)), (trial, k)
    B, S = 16, 5
    tokens = rng.randint(0, 4, (B, S)).astype(np.int32)
    nxt = rng.randint(0, 4, (B, S)).astype(np.int32)
    nxt[:8, :-1] = tokens[:8, 1:]                       # accept everything offered
    q_lens = rng.randint(1, S + 1, B).astype(np.int32)
    want = jax_accept_greedy(jnp.asarray(tokens), jnp.asarray(nxt), jnp.asarray(q_lens))
    got = accept_greedy(torch.from_numpy(tokens), torch.from_numpy(nxt),
                        torch.from_numpy(q_lens))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0].numpy()[:8] == q_lens[:8]).all()


# ----------------------------------------------------------------------
# the window forwards and the engine's window programs, on carried
# weights and one seeded cache state
# ----------------------------------------------------------------------

T_CACHE, PG, MAXP = 16, 4, 4            # contiguous capacity; paged page and table width
W_POS = np.asarray([2, 9, 13], np.int32)
W_QL = np.asarray([4, 1, 3], np.int32)  # row 2: positions 13-15 valid, its padding past T


@pytest.fixture(scope="module", params=["f32", "int8"])
def window_ref(request):
    """JAX tiny_qwen3 (f32, or int8 weights + int8 KV) on a one-device
    mesh, its window forwards and engine window programs on the plain
    ("xla") backend over seeded caches: the contiguous cache's columns
    past each window hold 100x values (K/V; int8: 100x scales), and so
    does every pool page outside the windows, the trash page 0
    included."""
    kind = request.param
    mesh = _mesh()
    jm = JaxAutoLLM.from_config(jax_tiny_qwen3(1, dtype="float32"), mesh, seed=0)
    kvd = None
    if kind == "int8":
        jm, kvd = jm.quantize_int8(), jnp.int8
    cfg = jm.config
    L, Hkv, hd, V = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, cfg.vocab_size
    rng = np.random.RandomState(17)
    B, S = len(W_POS), 4
    ids = rng.randint(0, V, (B, S)).astype(np.int32)
    quant = kind == "int8"

    def layer_state(shape):
        """One layer's (k, v[, ks, vs]) as numpy, poisoned past `poison`."""
        if quant:
            return [rng.randint(-127, 128, shape).astype(np.int8) for _ in range(2)] + \
                   [np.abs(rng.randn(*shape[:-1])).astype(np.float32) * 0.02 for _ in range(2)]
        return [rng.randn(*shape).astype(np.float32) for _ in range(2)]

    # contiguous: every column past pos + q_len (the trailing ones) poisoned
    cache = [layer_state((B, Hkv, T_CACHE, hd)) for _ in range(L)]
    for lay in cache:
        for b in range(B):
            tail = slice(int(W_POS[b] + W_QL[b]), None)
            lay[-1 if quant else 1][b, ..., tail] *= 100       # V (or its scale)
            lay[-2 if quant else 0][b, ..., tail] *= 100       # K (or its scale)
    jcache = JaxKVCache(k=tuple(jnp.asarray(c[0]) for c in cache),
                        v=tuple(jnp.asarray(c[1]) for c in cache), offset=jnp.int32(0),
                        ks=tuple(jnp.asarray(c[2]) for c in cache) if quant else (),
                        vs=tuple(jnp.asarray(c[3]) for c in cache) if quant else ())
    # paged: a shuffled table, pages past each slot's window and the
    # trash page poisoned
    NP = 1 + B * Hkv * MAXP + 2
    table = (1 + rng.permutation(NP - 1)[:B * Hkv * MAXP]).reshape(B * Hkv, MAXP)
    table = table.astype(np.int32)
    pools = [layer_state((NP, 1, PG, hd)) for _ in range(L)]
    live = np.zeros((NP, PG), bool)
    for x in range(B * Hkv):
        for t in range(int(W_POS[x // Hkv] + W_QL[x // Hkv])):
            if t < MAXP * PG:
                live[table[x, t // PG], t % PG] = True
    for lay in pools:
        for a in lay[2:] if quant else lay:      # int8 pools: their scales
            a[~live[:, None]] *= 100
    jp = JaxPagedSlotCache(
        pages_k=tuple(jnp.asarray(p[0]) for p in pools),
        pages_v=tuple(jnp.asarray(p[1]) for p in pools), table=jnp.asarray(table),
        scales_k=tuple(jnp.asarray(p[2]) for p in pools) if quant else (),
        scales_v=tuple(jnp.asarray(p[3]) for p in pools) if quant else ())
    pos, ql = jnp.asarray(W_POS), jnp.asarray(W_QL)
    fwd = jax.jit(lambda m, i, c, p, q: m.forward_tokens_slots_verify(i, c, p, q,
                                                                      mode="xla"))
    pfwd = jax.jit(lambda m, i, c, p, q: m.forward_tokens_slots_paged_verify(
        i, c, p, q, mode="xla"))
    lg, jc2 = fwd(jm, jnp.asarray(ids), jcache, pos, ql)
    plg, jp2 = pfwd(jm, jnp.asarray(ids), jp, pos, ql)
    out = dict(kind=kind, arrays=_jax_arrays(jm), ids=ids, cache=cache, pools=pools,
               table=table, logits=np.asarray(lg), plogits=np.asarray(plg),
               cache_out=_state(jc2.k, jc2.v, jc2.ks, jc2.vs),
               pools_out=_state(jp2.pages_k, jp2.pages_v, jp2.scales_k, jp2.scales_v))
    # engine programs: a mixed tick (row 0 prefilling a 4-token chunk, row
    # 1 decoding, row 2 idle) over the contiguous cache, and a verify step
    # (rows 0 and 2 with drafts) over the pool
    eng = JaxEngine(jm, max_seq=T_CACHE, backend="xla", kv_dtype=kvd)
    logits0 = rng.randn(B, V).astype(np.float32)
    pf = np.asarray([True, False, False])
    active = np.asarray([False, True, False])
    mq = np.asarray([4, 1, 1], np.int32)
    tok, sel, jc3, pos3, _ = eng.slot_mixed_chunk(
        jnp.asarray(logits0), jcache, pos, jnp.asarray(active), pf, ids, mq)
    out["mixed"] = dict(logits0=logits0, pf=pf, active=active, q_lens=mq,
                        tok=np.asarray(tok), sel=np.asarray(sel), pos=np.asarray(pos3),
                        cache_out=_state(jc3.k, jc3.v, jc3.ks, jc3.vs))
    vact = np.asarray([True, True, False])
    n_emit, t0n, jp3, vpos, _ = eng.paged_slot_verify_chunk(jp, pos, jnp.asarray(vact),
                                                            ids, ql)
    out["verify"] = dict(active=vact, n_emit=np.asarray(n_emit), t0n=np.asarray(t0n),
                         pos=np.asarray(vpos),
                         pools_out=_state(jp3.pages_k, jp3.pages_v, jp3.scales_k,
                                          jp3.scales_v))
    return out


def _state(k, v, ks, vs):
    return [[np.asarray(a) for a in t] for t in zip(k, v, *((ks, vs) if ks else ()))]


def _port(r):
    """The port's model, contiguous cache and paged pool on the same
    weights and state (fresh copies)."""
    cfg = tiny_qwen3(1, dtype="float32")
    model = from_jax_arrays(cfg, r["arrays"], device="cpu")
    quant = r["kind"] == "int8"
    cache = KVCache(k=[_t(c[0]).clone() for c in r["cache"]],
                    v=[_t(c[1]).clone() for c in r["cache"]],
                    ks=[_t(c[2]).clone() for c in r["cache"]] if quant else [],
                    vs=[_t(c[3]).clone() for c in r["cache"]] if quant else [])
    pc = PagedSlotCache(pages_k=[_t(p[0]).clone() for p in r["pools"]],
                        pages_v=[_t(p[1]).clone() for p in r["pools"]],
                        table=torch.from_numpy(r["table"]),
                        scales_k=[_t(p[2]).clone() for p in r["pools"]] if quant else [],
                        scales_v=[_t(p[3]).clone() for p in r["pools"]] if quant else [])
    return model, cache, pc


def _written(r, q_lens, paged):
    """[B, T] (contiguous) or [NP, page] (paged) mask of the positions a
    window with these q_lens writes at W_POS."""
    if not paged:
        cols = np.arange(T_CACHE)[None]
        return (cols >= W_POS[:, None]) & (cols < (W_POS + q_lens)[:, None])
    np_ = r["pools"][0][0].shape[0]
    mask = np.zeros((np_, PG), bool)
    Hkv = r["table"].shape[0] // len(W_POS)
    for x, row in enumerate(r["table"]):
        b = x // Hkv
        for p in range(int(W_POS[b]), min(int(W_POS[b] + q_lens[b]), MAXP * PG)):
            mask[row[p // PG], p % PG] = True
    return mask


def _assert_state(r, got, want, before, written):
    """Every layer's cache or pool tensors: the written window rows as JAX
    wrote them (f32 within 1e-5; int8 values off by one level at most and
    their f32 scales within 2^-6, as upstream f32 noise can move a
    per-position quantizer), and every other row, the poisoned trailing
    columns and pages among them, bit for bit as before the call."""
    int8 = r["kind"] == "int8"
    for g_layer, w_layer, b_layer in zip(got, want, before):
        for g, w, b0 in zip(g_layer, w_layer, b_layer):
            g = g.numpy()
            m = np.broadcast_to(_align(written, g.shape), g.shape)
            np.testing.assert_array_equal(g[~m], b0[~m])
            if g.dtype == np.int8:
                assert np.abs(g[m].astype(int) - w[m].astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(g[m], w[m], rtol=2.0 ** -6 if int8 else 1e-5,
                                           atol=0 if int8 else 1e-5)


def _align(mask, shape):
    """The [B, T] or [NP, page] mask reshaped to broadcast over a cache
    tensor [B, Hkv, T(, d)] or a pool [NP, 1, page(, d)]."""
    return mask.reshape((mask.shape[0], 1, mask.shape[1]) + (1,) * (len(shape) - 3))


def _torch_state(k, v, ks, vs):
    return [list(t) for t in zip(k, v, *((ks, vs) if ks else ()))]


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_window_forwards_match_jax(window_ref, paged):
    """forward_tokens_slots_verify and its paged form: per-position logits
    on the valid window positions (f32 at 1e-4 of the largest; int8 at
    1e-2: where the two sides' f32 sums straddle a half-way point, the
    per-position KV quantizer moves a value by one int8 level, 1/127 of
    the position's maximum), and the
    whole cache or pool afterwards: the window rows written as JAX wrote
    them, every poisoned column and page (a clamped padding write would
    land on the last column of row 2, a live write) untouched."""
    r = window_ref
    model, cache, pc = _port(r)
    pos, ql = torch.from_numpy(W_POS), torch.from_numpy(W_QL)
    ids = torch.from_numpy(r["ids"]).long()
    if paged:
        got, _ = model.forward_tokens_slots_paged_verify(ids, pc, pos, ql)
        want, state = r["plogits"], _torch_state(pc.pages_k, pc.pages_v, pc.scales_k,
                                                 pc.scales_v)
        want_state = r["pools_out"]
    else:
        got, _ = model.forward_tokens_slots_verify(ids, cache, pos, ql)
        want, state = r["logits"], _torch_state(cache.k, cache.v, cache.ks, cache.vs)
        want_state = r["cache_out"]
    valid = np.arange(4)[None] < W_QL[:, None]
    rel = 1e-4 if r["kind"] == "f32" else 1e-2
    g, w = got.numpy()[valid], want[valid]
    assert np.abs(g - w).max() <= rel * np.abs(w).max()
    _assert_state(r, state, want_state, r["pools"] if paged else r["cache"],
                  _written(r, W_QL, paged))


def test_engine_window_programs_match_jax(window_ref):
    """Engine.slot_mixed_chunk (a prefill chunk, a decode row and an idle
    row over the contiguous cache) and paged_slot_verify_chunk (draft
    windows over the pool): emitted tokens, next seeds, kept counts and
    positions equal, selected logits within 1e-4 (int8: 1e-2, as above)
    of the largest, caches and pools as JAX left them."""
    r = window_ref
    model, cache, pc = _port(r)
    eng = Engine(model, max_seq=T_CACHE, device="cpu",
                 kv_dtype=torch.int8 if r["kind"] == "int8" else None)
    rel = 1e-4 if r["kind"] == "f32" else 1e-2
    mx = r["mixed"]
    tok, sel, _, pos = eng.slot_mixed_chunk(
        torch.from_numpy(mx["logits0"]), cache, torch.from_numpy(W_POS),
        torch.from_numpy(mx["active"]), mx["pf"], r["ids"], mx["q_lens"])
    np.testing.assert_array_equal(tok.numpy(), mx["tok"])
    np.testing.assert_array_equal(pos.numpy(), mx["pos"])
    assert np.abs(sel.numpy() - mx["sel"]).max() <= rel * np.abs(mx["sel"]).max()
    _assert_state(r, _torch_state(cache.k, cache.v, cache.ks, cache.vs), mx["cache_out"],
                  r["cache"], _written(r, mx["q_lens"], False))
    vf = r["verify"]
    n_emit, t0n, _, vpos = eng.paged_slot_verify_chunk(
        pc, torch.from_numpy(W_POS), torch.from_numpy(vf["active"]), r["ids"], W_QL)
    np.testing.assert_array_equal(n_emit.numpy(), vf["n_emit"])
    np.testing.assert_array_equal(t0n.numpy(), vf["t0n"])
    np.testing.assert_array_equal(vpos.numpy(), vf["pos"])
    _assert_state(r, _torch_state(pc.pages_k, pc.pages_v, pc.scales_k, pc.scales_v),
                  vf["pools_out"], r["pools"], _written(r, W_QL, True))


# ----------------------------------------------------------------------
# the scheduler
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_window_streams():
    """The JAX scheduler's greedy streams with spec=2 and prefill_budget=4
    (mixed verify ticks while prompts prefill, verify ticks after), f32 on
    its plain backend, per form, with its accept counters."""
    jm = JaxAutoLLM.from_config(jax_tiny_qwen3(1, dtype="float32"), _mesh(), seed=0)
    eng = JaxEngine(jm, max_seq=MAX_SEQ, backend="xla")
    out = {"arrays": _jax_arrays(jm)}
    for paged in (False, True):
        sched = JaxScheduler(eng, batch=BATCH, chunk=CHUNK, paged=paged, page=PAGE, spec=2,
                             prefill_budget=4)
        streams = sched.run(_requests(JaxRequest, 256))
        st = sched.stats()
        out[paged] = (streams, st["spec_drafted"], st["max_prefill_tokens_per_poll"])
    return out


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_scheduler_spec_chunked_matches_jax(jax_window_streams, paged):
    """The port's streams against the JAX scheduler's by the teacher-forced
    margin rule (f32 on both sides: 1e-4 of the largest logit; wherever the
    port's top-2 margin exceeds twice that, the tokens must be equal), the
    same number of drafts proposed, and the stall bound held."""
    model = from_jax_arrays(tiny_qwen3(1, dtype="float32"), jax_window_streams["arrays"],
                            device="cpu")
    eng = Engine(model, max_seq=MAX_SEQ, device="cpu")
    sched = ContinuousScheduler(eng, batch=BATCH, chunk=CHUNK, paged=paged, page=PAGE,
                                spec=2, prefill_budget=4)
    got = sched.run(_requests(Request, 256))
    want, drafted, max_pf = jax_window_streams[paged]
    st = sched.stats()
    assert st["max_prefill_tokens_per_poll"] <= 4 and max_pf <= 4
    checked = 0
    for r in _requests(Request, 256):
        w = np.asarray(want[r.rid])
        assert len(got[r.rid]) == len(w) == r.gen_len
        logits, cache = model.forward_tokens(torch.from_numpy(r.ids).long()[None],
                                             model.make_cache(1, MAX_SEQ))
        for t in range(r.gen_len):
            lg = logits[0].numpy()
            top2 = np.sort(lg)[-2:]
            if top2[1] - top2[0] <= 2 * 1e-4 * (1 + np.abs(lg).max()):
                break                         # the streams may part here
            assert got[r.rid][t] == w[t] == np.argmax(lg), (r.rid, t)
            checked += 1
            logits, cache = model.forward_tokens(torch.tensor([[int(w[t])]]), cache)
    assert checked >= 20
    assert st["spec_drafted"] == drafted


class _Oracle:
    """Proposes the spec=0 stream's next tokens (every draft accepted)."""

    def __init__(self, reqs, streams):
        self.by_prompt = {tuple(r.ids.tolist()): np.asarray(streams[r.rid]) for r in reqs}

    def propose(self, h, k):
        h = np.asarray(h).tolist()
        for p, s in self.by_prompt.items():
            if tuple(h[:len(p)]) == p:
                done = len(h) - len(p)
                return [int(t) for t in s[done:done + k]]
        return []


class _Wrong:
    """Always wrong: every window rolls back."""

    def propose(self, h, k):
        return [(int(h[-1]) + 1) % 256] * k


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_windows_bitwise_in_port(kv):
    """Inside the port, bitwise against Engine.serve per request: spec
    on (n-gram, always-right, always-wrong drafters) == off, chunked
    (budgets 3 and 5) == monolithic, together, contiguous and paged with
    the prefix cache, and under a pool of one worst-case slot plus a spare
    group (preemption, mid-prefill included); the stall bound holds and
    every page comes back."""
    model = AutoLLM.from_config(tiny_qwen3(1, dtype="bfloat16"), device="cpu", seed=0)
    if kv == "int8":
        model = model.quantize_int8()
    eng = Engine(model, max_seq=MAX_SEQ, device="cpu",
                 kv_dtype=torch.int8 if kv == "int8" else None)
    reqs = _requests(Request, 256)
    want = {r.rid: eng.serve(r.ids[None], r.gen_len)[0].numpy() for r in reqs}
    runs = [(dict(paged=False, spec=3, drafter=_Oracle(reqs, want)), 3.0),
            (dict(paged=True, spec=2, drafter=_Wrong()), 1.0),
            (dict(paged=True, spec=2), None),
            (dict(paged=False, prefill_budget=3), None),
            (dict(paged=True, prefill_budget=5, spec=2, drafter=_Oracle(reqs, want)), 2.0),
            (dict(paged=True, num_pages=10, prefill_budget=3), None),
            (dict(paged=True, num_pages=10, prefix_cache=False, spec=2,
                  drafter=_Wrong()), 1.0)]
    for kw, min_tps in runs:
        sched = ContinuousScheduler(eng, batch=BATCH, chunk=CHUNK, page=PAGE, **kw)
        got = sched.run(reqs)
        assert not sched.rejected, sched.rejected
        st = sched.stats()
        label = {n: v for n, v in kw.items() if n != "drafter"}
        for r in reqs:
            np.testing.assert_array_equal(got[r.rid], want[r.rid],
                                          err_msg=f"{label}, rid={r.rid}")
        if "prefill_budget" in kw:
            assert st["max_prefill_tokens_per_poll"] <= kw["prefill_budget"]
        if min_tps is not None:
            assert st["tokens_per_step"] >= min_tps, (label, st["tokens_per_step"])
        if kw.get("num_pages"):
            assert st["preemptions"] > 0, label
        if kw["paged"]:
            pool = sched.slots.prefix.pool
            assert pool.available + pool.outstanding == pool.num_pages
            assert st["pages_outstanding"] == 1 + st["pages_in_use"]


def test_preempt_prefilling_slot_resumes_exactly():
    """A slot preempted mid-prefill (PagedDecodeSlots.preempt on a slot
    still prefilling) re-queues its request unchanged; it resumes through
    the prefix cache and every stream is Engine.serve's."""
    model = AutoLLM.from_config(tiny_qwen3(1, dtype="bfloat16"), device="cpu", seed=0)
    eng = Engine(model, max_seq=MAX_SEQ, device="cpu")
    reqs = _requests(Request, 256)
    want = {r.rid: eng.serve(r.ids[None], r.gen_len)[0].numpy() for r in reqs}
    sched = ContinuousScheduler(eng, batch=BATCH, chunk=CHUNK, paged=True, page=PAGE,
                                prefill_budget=4)
    for r in reqs:
        sched.submit(r)
    acc = {r.rid: [] for r in reqs}
    preempted = 0
    while not sched.idle:
        out, _ = sched.poll()
        for rid, t in out.items():
            acc[rid].extend(t.tolist())
        pf = sched.slots.prefill_slots
        if pf and sched.slots._pf_off[pf[0]] > 0 and preempted < 2:
            victim = sched.slots.preempt(pf[0])
            assert victim.gen_len == next(r for r in reqs if r.rid == victim.rid).gen_len
            sched._queue.append(victim)
            preempted += 1
    assert preempted == 2
    for r in reqs:
        np.testing.assert_array_equal(np.asarray(acc[r.rid]), want[r.rid])
    assert sched.stats()["hits"] > 0


def test_moe_dropless_mixed_tick_matches_jax():
    """One dropless tiny_qwen3_moe mixed tick (paged): a prefill chunk,
    a decode row and an idle row on carried weights, against the JAX
    engine's: tokens and positions equal, selected logits within 1e-4 of
    the largest (f32), the routing load equal (padding rows route too)."""
    jm = JaxAutoLLM.from_config(jax_tiny_qwen3_moe(1, num_experts=4), _mesh(), seed=0,
                                capacity_factor="dropless")
    cfg = jm.config
    B, S, page, maxp = 3, 4, 8, 4
    rng = np.random.RandomState(23)
    NP = 1 + B * cfg.num_kv_heads * maxp
    table = (1 + rng.permutation(NP - 1)).reshape(B * cfg.num_kv_heads, maxp)
    table = table.astype(np.int32)
    pools = [[rng.randn(NP, 1, page, cfg.head_dim).astype(np.float32) for _ in range(2)]
             for _ in range(cfg.num_layers)]
    jp = JaxPagedSlotCache(pages_k=tuple(jnp.asarray(p[0]) for p in pools),
                           pages_v=tuple(jnp.asarray(p[1]) for p in pools),
                           table=jnp.asarray(table))
    logits0 = rng.randn(B, cfg.vocab_size).astype(np.float32)
    ids = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pos = np.asarray([5, 11, 2], np.int32)
    pf, active = np.asarray([True, False, False]), np.asarray([False, True, False])
    q_lens = np.asarray([4, 1, 1], np.int32)
    jeng = JaxEngine(jm, max_seq=maxp * page, backend="xla")
    jeng._moe_pending.clear()
    tok, sel, jp2, jpos, _ = jeng.paged_slot_mixed_chunk(
        jnp.asarray(logits0), jp, jnp.asarray(pos), jnp.asarray(active), pf, ids, q_lens)
    jload = np.asarray(jeng.pop_moe_load())
    model = from_jax_arrays(tiny_qwen3_moe(1, num_experts=4), _jax_moe_arrays(jm),
                            device="cpu", capacity_factor="dropless")
    eng = Engine(model, max_seq=maxp * page, device="cpu")
    pc = PagedSlotCache(pages_k=[_t(p[0]).clone() for p in pools],
                        pages_v=[_t(p[1]).clone() for p in pools],
                        table=torch.from_numpy(table))
    gtok, gsel, _, gpos, load = eng.paged_slot_mixed_chunk(
        torch.from_numpy(logits0), pc, torch.from_numpy(pos), torch.from_numpy(active),
        pf, ids, q_lens)
    np.testing.assert_array_equal(gtok.numpy(), np.asarray(tok))
    np.testing.assert_array_equal(gpos.numpy(), np.asarray(jpos))
    want = np.asarray(sel)
    assert np.abs(gsel.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    np.testing.assert_array_equal(load.numpy(), jload)
    assert int(load[-1]) == 0 and int(load[:-1].sum()) == B * S * 2 * cfg.num_layers


def test_window_gates():
    """The JAX refusals: spec with backend "mega" at scheduler construction,
    the verify programs and the contiguous mixed tick on a mega engine,
    prefill_budget < 1; a window wider than the slot; q_lens without
    per-row lengths."""
    model = AutoLLM.from_config(tiny_qwen3(1, dtype="bfloat16"), device="cpu", seed=0)
    mega = Engine(model, max_seq=32, backend="mega", device="cpu")
    with pytest.raises(ValueError, match="verify window"):
        ContinuousScheduler(mega, batch=2, paged=True, spec=2)
    pos = torch.zeros(2, dtype=torch.int32)
    act = torch.ones(2, dtype=torch.bool)
    win = np.zeros((2, 3), np.int32), np.ones(2, np.int32)
    with pytest.raises(ValueError, match="verify window"):
        mega.slot_verify_chunk(mega.make_slot_cache(2), pos, act, *win)
    with pytest.raises(ValueError, match="verify window"):
        mega.paged_slot_verify_chunk(mega.make_paged_slot_cache(2, page=8), pos, act, *win)
    with pytest.raises(ValueError, match="PAGED decode tick"):
        mega.slot_mixed_chunk(torch.zeros(2, 256), mega.make_slot_cache(2), pos, act,
                              np.zeros(2, bool), *win)
    with pytest.raises(ValueError, match="prefill_budget"):
        ContinuousScheduler(Engine(model, max_seq=32, device="cpu"), batch=2,
                            prefill_budget=0)
    eng = Engine(model, max_seq=4, device="cpu")
    with pytest.raises(ValueError, match="exceeds the slot"):
        eng.slot_verify_chunk(eng.make_slot_cache(2), pos, act, np.zeros((2, 5), np.int32),
                              np.ones(2, np.int32))
    q = torch.zeros(1, 2, 2, 32)
    kv = torch.zeros(1, 1, 8, 32)
    with pytest.raises(ValueError, match="q_lens"):
        flash_decode(q, kv, kv, 2, q_lens=torch.ones(1, dtype=torch.int32))
