"""The port's slice as a whole (DenseLLM.forward_tokens, Engine.serve)
against the JAX package on tiny_qwen3(1) with carried weights, plus the
port's isolation from JAX and its device and capability gates (every
path not ported yet raises NotImplementedError).

The JAX model runs on a one-device mesh with its Pallas kernels in
interpret mode; the port runs on the CPU (device="cpu"), where its
kernel wrappers take their plain PyTorch versions. Greedy streams are
compared teacher-forced: both models are fed the JAX tokens and their
logits compared at every step, and the port's free-running tokens must
equal JAX's wherever the JAX top-2 margin exceeds the logit tolerance.
"""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.models import DenseLLM as JaxDenseLLM
from triton_dist_tpu.models import Engine as JaxEngine
from triton_dist_tpu.models.config import tiny_qwen3 as jax_tiny_qwen3
from triton_dist_tpu_torch.kernels import gdn_fwd
from triton_dist_tpu_torch.models import (AutoLLM, ContinuousScheduler, DenseLLM, Engine,
                                          ModelConfig, Request, tiny_qwen3, tiny_qwen3_moe)
from triton_dist_tpu_torch.models.convert import from_jax_arrays
from triton_dist_tpu_torch.models.spec_decode import accept_sampled, target_probs

B, S, GEN = 2, 8, 4
MAX_SEQ = S + GEN + 8
PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "triton_dist_tpu_torch")


def _jax_arrays(jm):
    """The JAX DenseLLM's parameters as the flat numpy dict of
    models/convert.py (QuantW leaves as {name}.q / {name}.s)."""
    arrays = {}

    def put(name, w):
        if w is None:
            return
        if hasattr(w, "q"):
            arrays[name + ".q"], arrays[name + ".s"] = np.asarray(w.q), np.asarray(w.s)
        else:
            arrays[name] = np.asarray(w)

    for name in ("embed", "final_norm", "lm_head"):
        put(name, getattr(jm, name))
    for i, ly in enumerate(jm.layers):
        for name in ("w_qkv", "w_o", "q_norm", "k_norm"):
            put(f"layers.{i}.attn.{name}", getattr(ly.attn, name))
        for name in ("w_gate_up", "w_down"):
            put(f"layers.{i}.mlp.{name}", getattr(ly.mlp, name))
        put(f"layers.{i}.ln_attn", ly.ln_attn)
        put(f"layers.{i}.ln_mlp", ly.ln_mlp)
    return arrays


@pytest.fixture(scope="module", params=["f32", "bf16", "int8"])
def slice_ref(request):
    """JAX greedy reference per configuration: prefill through the JAX
    Engine, then forward_tokens steps fed with the argmax (what the JAX
    decode scan does), keeping every step's logits."""
    kind = request.param
    dtype = "float32" if kind == "f32" else "bfloat16"
    jcfg = jax_tiny_qwen3(1, dtype=dtype)
    mesh = jax.make_mesh((1,), ("tp",), devices=jax.devices()[:1])
    jm = JaxDenseLLM.random_init(jcfg, mesh, seed=0)
    kv_dtype = None
    if kind == "int8":
        jm, kv_dtype = jm.quantize_int8(), jnp.int8
    ids = np.random.RandomState(5).randint(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    logits, cache = JaxEngine(jm, max_seq=MAX_SEQ, backend="flash",
                              kv_dtype=kv_dtype).prefill(ids)
    step = jax.jit(lambda m, t, c: m.forward_tokens(t, c, mode="flash"))
    logs, toks = [np.asarray(logits)], []
    for _ in range(GEN):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        logits, cache = step(jm, tok[:, None], cache)
        toks.append(np.asarray(tok))
        logs.append(np.asarray(logits))
    cfg = tiny_qwen3(1, dtype=dtype)
    return dict(kind=kind, cfg=cfg, ids=ids, logits=logs, toks=np.stack(toks, 1),
                arrays=_jax_arrays(jm),
                kv_dtype=torch.int8 if kind == "int8" else None)


def _tol(kind, ref):
    """f32: the same math in another summation order. bf16: bf16 rounding
    compounded over two layers and the head; the JAX package's own flash
    and xla backends differ by 1.5% of the largest logit on this input.
    int8: on top of that, a one-ulp bf16 difference before an int8
    quantizer (weights per column, KV per position) can move a value by
    a whole int8 level, 1/127 of its column's or position's maximum."""
    m = float(np.abs(ref).max())
    return {"f32": 1e-4 * (1 + m), "bf16": 2e-2 * m, "int8": 3e-2 * m}[kind]


def test_forward_tokens_matches_jax(slice_ref):
    """Logits after prefill and after each of the GEN decode steps, fed
    the JAX tokens."""
    r = slice_ref
    model = from_jax_arrays(r["cfg"], r["arrays"], device="cpu")
    cache = model.make_cache(B, MAX_SEQ, dtype=r["kv_dtype"])
    logits, cache = model.forward_tokens(torch.from_numpy(r["ids"]).long(), cache)
    for t in range(GEN + 1):
        want = r["logits"][t]
        assert logits.dtype == torch.float32 and logits.shape == want.shape
        err = np.abs(logits.numpy() - want).max()
        assert err <= _tol(r["kind"], want), f"step {t}: max|d| {err}"
        if t < GEN:
            tok = torch.from_numpy(r["toks"][:, t]).long()[:, None]
            logits, cache = model.forward_tokens(tok, cache)
    assert cache.offset == S + GEN


def test_engine_serve_matches_jax(slice_ref):
    r = slice_ref
    model = from_jax_arrays(r["cfg"], r["arrays"], device="cpu")
    toks = Engine(model, max_seq=MAX_SEQ, backend="flash", kv_dtype=r["kv_dtype"],
                  device="cpu").serve(r["ids"], GEN)
    assert toks.shape == (B, GEN) and toks.dtype == torch.int32
    checked = 0
    for b in range(B):
        for t in range(GEN):
            lg = r["logits"][t][b]
            top2 = np.sort(lg)[-2:]
            if top2[1] - top2[0] <= 2 * _tol(r["kind"], r["logits"][t]):
                break               # the streams may part here legitimately
            assert toks[b, t].item() == r["toks"][b, t], (b, t)
            checked += 1
    assert checked > 0


def test_quantize_int8_matches_jax():
    """DenseLLM.quantize_int8 on the carried bf16 weights gives JAX's
    int8 weights bitwise."""
    mesh = jax.make_mesh((1,), ("tp",), devices=jax.devices()[:1])
    jm = JaxDenseLLM.random_init(jax_tiny_qwen3(1, dtype="bfloat16"), mesh, seed=1)
    want = _jax_arrays(jm.quantize_int8())
    q = from_jax_arrays(tiny_qwen3(1, dtype="bfloat16"), _jax_arrays(jm),
                        device="cpu").quantize_int8()
    ly = q.layers[1]
    for got, name in ((ly.attn.w_qkv, "layers.1.attn.w_qkv"),
                      (ly.mlp.w_down, "layers.1.mlp.w_down"), (q.lm_head, "lm_head")):
        np.testing.assert_array_equal(got.q.numpy(), want[name + ".q"])
        np.testing.assert_allclose(got.s.numpy(), want[name + ".s"], rtol=1e-7, atol=0)


def test_package_imports_no_jax():
    """Importing every module of the port leaves jax and the JAX package
    out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import triton_dist_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'triton_dist_tpu' or m.startswith('triton_dist_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    root = os.path.dirname(PKG)
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=root))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_package_source_imports_no_jax():
    """No module of the port names jax or triton_dist_tpu in an import."""
    bad = []
    for dirpath, _, files in os.walk(PKG):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            for node in ast.walk(ast.parse(open(path).read(), path)):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    names = [node.module or ""]
                else:
                    continue
                bad += [(path, n) for n in names
                        if n.split(".")[0] in ("jax", "jaxlib", "triton_dist_tpu")]
    assert not bad, bad


def test_entry_points_default_to_cuda():
    """Without device=, the entry points ask for CUDA and raise on this
    host instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is satisfied")
    cfg = tiny_qwen3(1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AutoLLM.from_config(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DenseLLM.random_init(cfg)
    model = AutoLLM.from_config(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(model)


@pytest.mark.parametrize("kw,exc", [
    # the expert-parallel backends refuse a dense model (the JAX gate)
    (dict(backend="ep_flash"), ValueError),
    (dict(backend="ep"), ValueError),
    (dict(backend="nonesuch"), ValueError),
    (dict(sampling="top_k"), NotImplementedError),
], # the ids the cases had before EP was ported, when the ep cases raised
   # NotImplementedError
    ids=["kw0-NotImplementedError", "kw1-NotImplementedError", "kw2-ValueError",
         "kw3-NotImplementedError"])
def test_engine_gates(kw, exc):
    model = AutoLLM.from_config(tiny_qwen3(1), device="cpu")
    with pytest.raises(exc):
        Engine(model, device="cpu", **kw)


def _gate_cases():
    """What the port does not run yet, each as a call that must raise
    NotImplementedError("... not yet ported")."""
    def model():
        return AutoLLM.from_config(tiny_qwen3(1), device="cpu")

    def moe():
        return AutoLLM.from_config(tiny_qwen3_moe(1), device="cpu")

    def sched(**kw):
        return ContinuousScheduler(Engine(model(), max_seq=32, device="cpu"), batch=2,
                                   **kw)

    def submit(**kw):
        sched().submit(Request(rid=0, ids=np.zeros(4, np.int32), gen_len=2, **kw))

    x = torch.zeros(1, 1, 4, 64)
    g = torch.zeros(1, 1, 4)
    return {
        # expert parallelism runs on one mesh axis; the hybrid EP + TP mesh
        # (moe_axis) waits
        "moe": lambda: AutoLLM.from_config(tiny_qwen3_moe(1), device="cpu", moe_impl="ep",
                                           moe_axis="expert"),
        # a MoE model runs "dist" since TP-MoE was ported; its training
        # forward (on "dist" too) waits
        "mode_dist": lambda: moe().forward_train(torch.zeros(1, 2, dtype=torch.long),
                                                 mode="dist"),
        "train_mode_dist": lambda: model().forward_train(torch.zeros(1, 2, dtype=torch.long),
                                                         mode="dist"),
        "train_int8": lambda: model().quantize_int8().requires_grad_(),
        "overlap": lambda: sched(overlap=True),
        "host_pool_pages": lambda: sched(paged=True, host_pool_pages=4),
        "watchdog_s": lambda: sched(watchdog_s=1.0),
        "fault": lambda: sched(fault=object()),
        "slo_classes": lambda: sched(slo_classes={}),
        "request_slo": lambda: submit(slo="interactive"),
        "request_deadline_ms": lambda: submit(deadline_ms=100.0),
        "request_n": lambda: submit(n=2),
        "request_grammar": lambda: submit(grammar=object()),
        "gdn_ablate": lambda: gdn_fwd(x, x, x, g, g, ablate=frozenset({"exps"})),
        "spec_accept_sampled": lambda: accept_sampled(None, None, None, None),
        "spec_target_probs": lambda: target_probs(None, "top_k", {}),
    }


@pytest.mark.parametrize("case", list(_gate_cases()))
def test_not_ported_paths_raise(case):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        _gate_cases()[case]()
