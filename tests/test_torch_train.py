"""The port's training path (DenseLLM.forward_train under torch.autograd)
against the JAX package's (forward_train under jax.value_and_grad), on
the same numpy inputs and carried weights.

The JAX side runs on a one-device mesh with Auto axes and its Pallas
kernels (the flash forward's partial form, the dq and dk/dv backward
kernels, ag_gemm and gemm_rs at one rank) in interpret mode; the port
runs on the CPU, where its kernel wrappers take their plain versions
(flash_decode_partial_ref, flash_attention_bwd_ref, gemm_ref). The CUDA
kernels themselves are held against those plain versions on the card by
chip_smoke.py.

Tolerances: f32 cases use the JAX package's own (tests/test_flash_train.py
5e-4 on attention gradients, tests/test_train_e2e.py 1e-5 on the loss and
5e-4 on every gradient leaf). bf16 cases compare the same bf16 inputs
through two frameworks that round at different places (the Pallas
kernels round P and dS to bf16 before their products, the port's plain
attention forward keeps P in f32; XLA and PyTorch round products and
activations in their own order), so they are held at a share of each
array's largest value, stated at each check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from triton_dist_tpu.kernels.flash_attn import flash_decode_partial as jax_partial
from triton_dist_tpu.kernels.flash_attn import lse_combine as jax_lse_combine
from triton_dist_tpu.kernels.flash_attn_train import flash_attention as jax_flash_attention
from triton_dist_tpu.kernels.flash_attn_train import query_chunk as jax_query_chunk
from triton_dist_tpu.kernels.grad import ag_gemm_grad as jax_ag_gemm_grad
from triton_dist_tpu.kernels.grad import gemm_rs_grad as jax_gemm_rs_grad
from triton_dist_tpu.models import DenseLLM as JaxDenseLLM
from triton_dist_tpu.models.config import tiny_qwen3 as jax_tiny_qwen3
from triton_dist_tpu_torch.kernels import (ag_gemm_grad, flash_attention,
                                           flash_attention_bwd_ref, flash_attention_ref,
                                           flash_decode_partial, flash_decode_ref,
                                           gemm_rs_grad, lse_combine, reset_launch_counts,
                                           launch_counts)
from triton_dist_tpu_torch.kernels.flash_attn_train import _fold_q, query_chunk
from triton_dist_tpu_torch.models import AutoLLM, tiny_qwen3
from triton_dist_tpu_torch.models.convert import from_jax_arrays, to_arrays, to_torch
from test_torch_engine import _jax_arrays


def _mesh():
    return jax.make_mesh((1,), ("tp",), axis_types=(AxisType.Auto,),
                         devices=jax.devices()[:1])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(a, ref):
    """max |a - ref| as a share of max |ref|."""
    a, ref = _np(a), _np(ref)
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))


def _qkv(B, S, Hq, Hkv, T, d, seed):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, S, Hq, d) * 0.5).astype(np.float32)
    k = (rng.randn(B, Hkv, T, d) * 0.5).astype(np.float32)
    v = (rng.randn(B, Hkv, T, d) * 0.5).astype(np.float32)
    ct = rng.randn(B, S, Hq, d).astype(np.float32)
    return q, k, v, ct


# shapes of tests/test_flash_train.py: GQA rep 2; rep 3 with T > S; T not
# a multiple of 32 (MQA)
SHAPES = [(1, 16, 4, 2, 16, 32), (1, 8, 6, 2, 24, 32), (1, 12, 4, 1, 20, 32)]


@pytest.mark.parametrize("shape,dtype", [(s, "f32") for s in SHAPES] + [(SHAPES[0], "bf16")],
                         ids=["rep2-f32", "rep3_T>S-f32", "T20-f32", "rep2-bf16"])
def test_flash_attention_matches_jax(shape, dtype):
    """Output and (dq, dk, dv) of the port's flash_attention under autograd
    against JAX flash_attention under jax.grad, loss sum(o * ct)."""
    q, k, v, ct = _qkv(*shape, seed=sum(shape))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16,
                                                                     torch.bfloat16)

    @jax.jit
    def out_and_grads(q, k, v):
        o, vjp = jax.vjp(jax_flash_attention, q, k, v)
        return o, vjp(jnp.asarray(ct, jdt))

    with jax.default_matmul_precision("highest"):
        jo, jg = out_and_grads(*(jnp.asarray(a, jdt) for a in (q, k, v)))
    tq, tk, tv = (to_torch(a).to(tdt).requires_grad_() for a in (q, k, v))
    o = flash_attention(tq, tk, tv)
    (o.float() * torch.from_numpy(ct)).sum().backward()
    if dtype == "f32":
        np.testing.assert_allclose(_np(o), _np(jo), atol=5e-5, rtol=1e-5)
        for name, a, b in zip("qkv", (tq.grad, tk.grad, tv.grad), jg):
            np.testing.assert_allclose(_np(a), _np(b), atol=5e-4, rtol=1e-4,
                                       err_msg=f"d{name}")
    else:
        # bf16: 2% of the largest value (a few bf16 ulps of the largest
        # value; the two kernels round P in different places)
        assert _rel(o, jo) < 2e-2
        for name, a, b in zip("qkv", (tq.grad, tk.grad, tv.grad), jg):
            assert _rel(a, b) < 2e-2, f"d{name}: {_rel(a, b)}"


def test_flash_attention_bwd_ref_matches_autograd():
    """The explicit recompute formula (the backward kernels' plain version)
    against autograd of the plain oracle, in f32, on rep 3 with T > S."""
    B, S, Hq, Hkv, T, d = SHAPES[1]
    q, k, v, ct = (torch.from_numpy(a) for a in _qkv(B, S, Hq, Hkv, T, d, seed=3))
    q, k, v = (a.requires_grad_() for a in (q, k, v))
    o = flash_attention_ref(q, k, v)
    (o * ct).sum().backward()
    rep, X = Hq // Hkv, B * Hkv
    with torch.no_grad():
        s = torch.einsum("xrd,xtd->xrt", _fold_q(q, Hkv),
                         k.reshape(X, T, d)) * d ** -0.5
        row = torch.arange(S * rep)[:, None] // rep
        s = s.masked_fill(torch.arange(T)[None] > row + T - S, float("-inf"))
        lse = torch.logsumexp(s, -1)
        dox = _fold_q(ct, Hkv)
        dvec = (dox * _fold_q(o, Hkv)).sum(-1)
        dq, dk, dv = flash_attention_bwd_ref(
            _fold_q(q, Hkv), k.reshape(X, T, d), v.reshape(X, T, d), dox, lse,
            dvec, T, T - S, scale=d ** -0.5, rep=rep)
    np.testing.assert_allclose(_np(dq.reshape(B, Hkv, S, rep, d).transpose(1, 2)
                                   .reshape(B, S, Hq, d)), _np(q.grad), atol=5e-5)
    np.testing.assert_allclose(_np(dk.reshape(k.shape)), _np(k.grad), atol=5e-5)
    np.testing.assert_allclose(_np(dv.reshape(v.shape)), _np(v.grad), atol=5e-5)


@pytest.mark.parametrize("kv_len,q_offset", [(24, 16), (20, -3), (0, 5)])
def test_flash_decode_partial_matches_jax(kv_len, q_offset):
    """(acc, m, l) against JAX flash_decode_partial (f32): the full buffer
    with the training frontier, a short buffer with a negative offset (rows
    that see no key keep m = -1e30, l = 0, acc = 0), an empty buffer."""
    B, S, Hq, Hkv, T, d = 1, 8, 6, 2, 24, 32
    q, k, v, _ = _qkv(B, S, Hq, Hkv, T, d, seed=kv_len)
    want = jax_partial(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len, q_offset)
    got = flash_decode_partial(*(torch.from_numpy(a) for a in (q, k, v)), kv_len, q_offset)
    for name, a, b in zip(("acc", "m", "l"), got, want):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(_np(a), _np(b), atol=2e-5, rtol=1e-5, err_msg=name)


def test_lse_combine_matches_jax_and_whole():
    """Partials of two halves of the keys, combined, equal the attention
    over all of them (flash_decode_ref), and JAX lse_combine's result."""
    B, S, Hq, Hkv, T, d = 1, 4, 4, 2, 32, 32
    q, k, v, _ = _qkv(B, S, Hq, Hkv, T, d, seed=11)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    h = T // 2
    parts = [flash_decode_partial(tq, tk[:, :, :h], tv[:, :, :h], h, T - S),
             flash_decode_partial(tq, tk[:, :, h:], tv[:, :, h:], h, T - S - h)]
    accs, ms, ls = (torch.stack([p[i] for p in parts]) for i in range(3))
    got = lse_combine(accs, ms, ls)
    np.testing.assert_allclose(_np(got), _np(flash_decode_ref(tq, tk, tv, T)), atol=2e-5)
    want = jax_lse_combine(*(jnp.asarray(_np(a)) for a in (accs, ms, ls)))
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-6)


@pytest.mark.parametrize("S,rep,block_r", [(1024, 2, 256), (12, 3, 256), (13, 2, 8),
                                           (97, 1, 2)])
def test_query_chunk_matches_jax(S, rep, block_r):
    assert query_chunk(S, rep, block_r) == jax_query_chunk(S, rep, block_r)


@pytest.mark.parametrize("op", ["ag_gemm", "gemm_rs"])
def test_grad_ops_match_jax(op):
    """Value and both gradients of ag_gemm_grad / gemm_rs_grad at one rank
    against the JAX custom VJPs on a one-device mesh (tests/test_grad.py's
    shapes at n = 1)."""
    rng = np.random.RandomState(0 if op == "ag_gemm" else 1)
    M, K, N = 4, 128, 128
    a = (rng.randn(M, K) * 0.2).astype(np.float32)
    b = (rng.randn(K, N) * 0.2).astype(np.float32)
    w = rng.randn(M, N).astype(np.float32)
    jop = (jax_ag_gemm_grad if op == "ag_gemm" else jax_gemm_rs_grad)(_mesh())

    def loss(a, b):
        return jnp.sum(jop(a, b) * w)

    with jax.default_matmul_precision("highest"):
        jy = jop(jnp.asarray(a), jnp.asarray(b))
        jda, jdb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta, tb = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    y = (ag_gemm_grad if op == "ag_gemm" else gemm_rs_grad)()(ta, tb)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(_np(y), _np(jy), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(ta.grad), _np(jda), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(tb.grad), _np(jdb), atol=2e-4, rtol=1e-4)


def _jax_loss(mode):
    def loss(m, ids, labels):
        logp = jax.nn.log_softmax(m.forward_train(ids, mode=mode), axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, labels[..., None], axis=-1))
    return loss


def _torch_loss(model, ids, labels, mode):
    logits = model.forward_train(torch.from_numpy(ids).long(), mode)
    return torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                             torch.from_numpy(labels).long().reshape(-1))


def _jax_grads(jg):
    """The JAX gradient pytree as the flat dict of models/convert.py, with
    the rope tables' gradients under cos/sin."""
    out = _jax_arrays(jg)
    out["cos"], out["sin"] = np.asarray(jg.cos), np.asarray(jg.sin)
    return {n: np.asarray(a, np.float32) for n, a in out.items()}


def _batch(vocab, B=2, S=8, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, vocab, (B, S)).astype(np.int32),
            rng.randint(0, vocab, (B, S)).astype(np.int32))


_JAX_REF = {}


def _jax_ref(kind: str, mode: str):
    """tiny_qwen3(1) in f32 or bf16 with seed-0 weights: the carried
    weights, one batch, and JAX's loss and gradients in `mode` (each
    computed once per module)."""
    dtype = "float32" if kind == "f32" else "bfloat16"
    if kind not in _JAX_REF:
        jcfg = jax_tiny_qwen3(1, dtype=dtype)
        jm = JaxDenseLLM.random_init(jcfg, _mesh(), seed=0)
        ids, labels = _batch(jcfg.vocab_size)
        _JAX_REF[kind] = dict(jm=jm, cfg=tiny_qwen3(1, dtype=dtype), arrays=_jax_arrays(jm),
                              ids=ids, labels=labels)
    r = _JAX_REF[kind]
    if mode not in r:
        with jax.default_matmul_precision("highest"):
            loss, g = jax.jit(jax.value_and_grad(_jax_loss(mode)))(
                r["jm"], jnp.asarray(r["ids"]), jnp.asarray(r["labels"]))
        r[mode] = (float(loss), _jax_grads(g))
    return r


@pytest.mark.parametrize("kind,mode", [("f32", "train"), ("f32", "xla"), ("bf16", "train")])
def test_train_slice_matches_jax(kind, mode):
    """Loss and every gradient leaf of the port's forward_train (carried
    weights) against JAX's in the same mode; the rope tables' gradients
    too, read by marking them trainable. f32 at tests/test_train_e2e.py's
    tolerances; bf16 at 1e-2 of the loss and 5e-2 of each leaf's largest
    gradient (the frameworks round bf16 activations in different places,
    and 2 layers of that reach a few bf16 ulps of the largest value)."""
    r = _jax_ref(kind, mode)
    model = from_jax_arrays(r["cfg"], r["arrays"], device="cpu").requires_grad_()
    model.cos.requires_grad_()
    model.sin.requires_grad_()
    reset_launch_counts()
    loss = _torch_loss(model, r["ids"], r["labels"], mode)
    loss.backward()
    assert not any(launch_counts().values()), "the CPU path launched a kernel"
    got = to_arrays(model, grads=True)
    got["cos"], got["sin"] = _np(model.cos.grad), _np(model.sin.grad)
    want_loss, want = r[mode]
    assert set(got) == set(want)
    if kind == "f32":
        np.testing.assert_allclose(loss.item(), want_loss, atol=1e-5, rtol=1e-5)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], atol=5e-4, rtol=5e-4,
                                       err_msg=name)
    else:
        assert abs(loss.item() - want_loss) < 1e-2 * abs(want_loss)
        for name in want:
            assert _rel(got[name], want[name]) < 5e-2, f"{name}: {_rel(got[name], want[name])}"


def test_sgd_step_lowers_loss():
    """One SGD step through mode "train" lowers the loss on its batch."""
    cfg = tiny_qwen3(1)
    model = AutoLLM.from_config(cfg, device="cpu").requires_grad_()
    ids, labels = _batch(cfg.vocab_size, seed=1)
    losses = []
    for _ in range(2):
        loss = _torch_loss(model, ids, labels, "train")
        loss.backward()
        losses.append(loss.item())
        with torch.no_grad():
            for _, p in model.named_parameters():
                p -= 5e-2 * p.grad
                p.grad = None
    assert losses[1] < losses[0]


def test_tied_head_gets_its_own_gradient():
    """A tied config: the JAX pytree holds lm_head = embed.T as a leaf of
    its own. The port's head starts as a view of the embedding;
    requires_grad_ gives it storage of its own, and both gradients match
    JAX's (mode "xla"), so the two drift apart after a step as in JAX."""
    jcfg = jax_tiny_qwen3(1, tie_word_embeddings=True)
    jm = JaxDenseLLM.random_init(jcfg, _mesh(), seed=0)
    ids, labels = _batch(jcfg.vocab_size, seed=2)
    with jax.default_matmul_precision("highest"):
        _, jg = jax.jit(jax.value_and_grad(_jax_loss("xla")))(jm, jnp.asarray(ids),
                                                               jnp.asarray(labels))
    want = _jax_grads(jg)
    model = from_jax_arrays(tiny_qwen3(1, tie_word_embeddings=True), _jax_arrays(jm),
                            device="cpu")
    model.lm_head = model.embed.T           # tied, as random_init and from_hf build it
    model.requires_grad_()
    assert model.lm_head.untyped_storage().data_ptr() != model.embed.untyped_storage().data_ptr()
    _torch_loss(model, ids, labels, "xla").backward()
    got = to_arrays(model, grads=True)
    for name in ("embed", "lm_head"):
        np.testing.assert_allclose(got[name], want[name], atol=5e-4, rtol=5e-4, err_msg=name)
    assert not np.allclose(got["lm_head"], got["embed"].T, atol=1e-3)


@pytest.mark.parametrize("call", ["ag_gemm", "gemm_rs", "ag_gemm_grad", "gemm_rs_grad"])
def test_multi_rank_not_ported(call):
    """Training over more than one rank is not ported: the training ops
    above one rank, and the layers' training forms over a mesh, whose
    products would be ag_gemm (the MLP's first) and gemm_rs (the
    attention's last) under autograd. Their forward rings serve on
    "dist" (tests/test_torch_dist.py)."""
    from triton_dist_tpu_torch.models import DenseLLM
    from triton_dist_tpu_torch.runtime import make_mesh
    m4 = DenseLLM.random_init(tiny_qwen3(4), seed=0, mesh=make_mesh(4, devices=["cpu"] * 4))
    ly, x = m4.layers[0], [torch.zeros(4, 64) for _ in range(4)]
    fns = {"ag_gemm": lambda: ly.mlp.fwd_train(x),
           "gemm_rs": lambda: ly.attn.fwd_train(x, m4.cos, m4.sin, 1),
           "ag_gemm_grad": lambda: ag_gemm_grad(2),
           "gemm_rs_grad": lambda: gemm_rs_grad(4)}
    with pytest.raises(NotImplementedError, match="not yet ported"):
        fns[call]()
