"""One transformer decode layer as ONE kernel launch, over the contiguous
KV cache (`MegaDecodeLayer`) or the paged serving pool
(`MegaPagedDecodeLayer`).

Counterpart of triton_dist_tpu/mega/decode_layer.py. The layer step is
recorded as a task program (MegaKernelBuilder, validated at
construction):

  ln1 -> qkv_mm -> attend (per-head QK-norm + RoPE, the append of the new
  K/V row at pos, attention over the cache) -> o_proj (+ residual) ->
  ln2 -> gate_up_swiglu -> down_proj (+ residual)

At tensor-parallel size n > 1 (the contiguous layer only, as in JAX) the
geometry is the rank's LOCAL shard (Hq/n query heads, Hkv/n kv heads,
F/n FFN columns), the activations stay replicated, and the two
projections that end in a sum over the ranks lose their residual and
gain an all-reduce section (the JAX task names and order):

  ... -> o_proj (partial) -> o_allreduce (+ x) -> ln2 -> gate_up_swiglu
  -> down_proj (partial) -> d_allreduce (+ ores)

Each section folds the n partials in f32 in rank order onto the
residual, acc = residual; acc = acc + partial_r for r = 0..n-1, so every
rank's y is bitwise the same. A call takes per-rank lists (x, weights,
caches; tensor r on rank r's device) and returns each rank's y.

For CUDA tensors each call launches one persistent cooperative CUDA
kernel (kernels/csrc/mega_decode.cu, mega_paged_decode.cu over
mega_layer.cuh; at n > 1 one launch per distinct device of the mesh,
covering the ranks it holds) that runs those tasks as
grid-barrier-separated phases, in the recorded order. For CPU tensors it
runs the plain version: the tasks' PyTorch emitters in the same order
(`mega_decode_layer_ref`, `mega_paged_decode_layer_ref`; at n > 1 in
lockstep over the ranks). There is no other path.

The plain versions round where the kernel rounds, not where the JAX
package's all-f32 oracles do: the activations enter every product in
bf16 (xn, attn, on and h are stored bf16) with the weights in bf16 and
f32 sums; q is rounded to bf16 (the query dtype of a bf16 or int8
cache) before QK^T and P before PV, as in the TPU kernel; the SwiGLU
epilogue is f32. The residual stream x -> ores -> y stays f32.

Differences from the JAX layers:
- the contiguous cache is the port's KVCache layout [B, Hkv, T, hd]
  (the JAX kernel took [Hkv, B, T, hd]); `pos` is a host int;
- caches and pools are updated in place (JAX aliased them) and returned;
- there is no `block_n`/`block_t`: those were Pallas tile sizes (weight
  tiles through VMEM, 128-aligned DMA slices), and the CUDA kernel tiles
  its own way;
- at n > 1 the layer takes the port's mesh (runtime/bootstrap.py) where
  JAX took a mesh axis name: its epochs, signal pads and the symmetric
  landing buffer of the all-reduce sections.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from triton_dist_tpu_torch.kernels import _build, _comm
from triton_dist_tpu_torch.kernels.quant import quantize_kv_int8
from triton_dist_tpu_torch.mega.builder import MegaKernelBuilder
from triton_dist_tpu_torch.runtime.symm_mem import create_symm_buffer

# task name -> phase code of the CUDA kernel (tdt_mega::Phase)
PHASES = {"ln1": 0, "qkv_mm": 1, "attend": 2, "o_proj": 3, "ln2": 4,
          "gate_up_swiglu": 5, "down_proj": 6, "o_allreduce": 7, "d_allreduce": 8}
_KERNEL_HEAD_DIM = 128   # head dim the kernels are instantiated for
_TILE = 64               # the kernel's product tile (rows, columns, depth)
_MAX_REP = 4             # query heads per kv head the kernel takes
# csrc/binding.cpp's order of a layer's weight pointers (the rope rows
# follow them), scratch pointers and cache ints
_WEIGHT_KEYS = ("w_ln1", "w_qkv", "q_norm", "k_norm", "w_o", "w_ln2", "w_gu", "w_d")
_SCRATCH_KEYS = ("xn", "qkv", "attn", "ores", "on", "h", "barrier", "part")
_INT_KEYS = ("pos", "T", "maxp", "page", "kv_sb", "kv_sh", "kv_st", "pg_st", "row_st",
             "spg_st")
_MAX_PLANS = 256         # TP launch plans a layer object keeps (one a weight set)
# A fault the kernel plants when nonzero, for tools/fault_margin.py only:
# 1 drops the newest key from the attention walk, 2 leaves out the
# attention block's residual (tp=1); in both all-reduce sections of the
# TP form, 3 folds without rank me+1's partial, 4 folds before its pushes
# and its arrival wait (its own slot still holds the previous launch's
# partial), 5 folds rank me+1's partial twice. The plain versions ignore
# it.
FAULT = 0


def _bf(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 and widened back to f32."""
    return t.to(torch.bfloat16).float()


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 a @ bf16 w with f32 sums (exact products on the CPU too,
    where a bf16 x bf16 mm would return bf16)."""
    return _bf(a) @ _bf(w)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.reshape(-1).float()


def _heads(env, Hq: int, Hkv: int, hd: int, eps: float, qk_norm: bool):
    """Split qkv into heads; QK-norm and RoPE q and k in f32 (cos/sin
    rows [1 or B, hd/2]). Returns q [B, Hq, hd], k and v [B, Hkv, hd]."""
    qkv = env["qkv"]
    B = qkv.shape[0]
    q = qkv[:, :Hq * hd].reshape(B, Hq, hd)
    k = qkv[:, Hq * hd:(Hq + Hkv) * hd].reshape(B, Hkv, hd)
    v = qkv[:, (Hq + Hkv) * hd:].reshape(B, Hkv, hd)
    if qk_norm:
        q = _rms(q, env["q_norm"], eps)
        k = _rms(k, env["k_norm"], eps)
    c = env["cos"].float()[:, None, :]
    s = env["sin"].float()[:, None, :]

    def rope(t):
        x1, x2 = t[..., :hd // 2], t[..., hd // 2:]
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)

    return rope(q), rope(k), v


def _attention(q, kf, vf, valid, qdt, ks=None, vs=None):
    """Softmax attention of q [B, Hq, hd] over kf/vf [B, Hkv, T, hd] (int8
    payloads widened, their scales ks/vs [B, Hkv, T]) at keys where valid
    [B, T]: the kernel's rounding (q and P in qdt, K scale on the logits,
    V scale folded into P, f32 sums, out / max(l, 1e-30)). Returns
    [B, Hq*hd] bf16."""
    B, Hq, hd = q.shape
    Hkv = kf.shape[1]
    qg = q.to(qdt).float().reshape(B, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bgrd,bgtd->bgrt", qg, kf) * hd ** -0.5
    if ks is not None:
        s = s * ks[:, :, None, :]
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    if vs is not None:
        p = p * vs[:, :, None, :]
    out = torch.einsum("bgrt,bgtd->bgrd", p.to(qdt).float(), vf) / l.clamp_min(1e-30)
    return out.reshape(B, Hq * hd).to(torch.bfloat16)


def _attend_contig(env, Hq, Hkv, hd, eps, qk_norm):
    q, k, v = _heads(env, Hq, Hkv, hd, eps, qk_norm)
    ck, cv, pos = env["ck"], env["cv"], int(env["pos"])
    ck[:, :, pos] = k.to(ck.dtype)
    cv[:, :, pos] = v.to(cv.dtype)
    valid = torch.ones((q.shape[0], pos + 1), dtype=torch.bool, device=q.device)
    qdt = torch.bfloat16 if ck.dtype == torch.bfloat16 else ck.dtype
    env["attn"] = _attention(q, ck[:, :, :pos + 1].float(), cv[:, :, :pos + 1].float(),
                             valid, qdt)


def _attend_paged(env, Hq, Hkv, hd, eps, qk_norm):
    q, k, v = _heads(env, Hq, Hkv, hd, eps, qk_norm)
    B = q.shape[0]
    pk, pv = env["pk"][:, 0], env["pv"][:, 0]           # [NP, page, hd] views
    table, pos = env["table"], env["pos"].long()
    X, maxp = table.shape
    page = pk.shape[1]
    pos_x = pos.repeat_interleave(Hkv)
    pidx = table[torch.arange(X, device=q.device),
                 (pos_x // page).clamp(max=maxp - 1)].long()
    r = pos_x % page
    quant = "ks" in env
    if quant:
        sk, sv = env["ks"][:, 0], env["vs"][:, 0]
        for pool, spool, new in ((pk, sk, k), (pv, sv, v)):
            q8, s8 = quantize_kv_int8(new.reshape(X, hd))
            pool[pidx, r] = q8
            spool[pidx, r] = s8
    else:
        pk[pidx, r] = k.reshape(X, hd).to(pk.dtype)
        pv[pidx, r] = v.reshape(X, hd).to(pv.dtype)
    tbl = table.long()
    T = maxp * page

    def gather(pool):
        return pool[tbl].reshape((B, Hkv, T) + pool.shape[2:]).float()

    valid = torch.arange(T, device=q.device)[None, :] <= pos[:, None]
    qdt = torch.bfloat16 if quant else pk.dtype
    env["attn"] = _attention(q, gather(pk), gather(pv), valid, qdt,
                             gather(sk) if quant else None, gather(sv) if quant else None)


def _program(paged: bool, quant: bool, *, n_heads: int, n_kv_heads: int, head_dim: int,
             d_model: int, ffn: int, eps: float, qk_norm: bool,
             tp: int = 1) -> MegaKernelBuilder:
    """The layer's task program with its plain emitters. Buffers are
    declared with the batch as "B" (it is known per call). At tp > 1 the
    geometry is the rank's shard, and each all-reduce section reads the
    partial of every rank's env (env["ranks"]; emitted in lockstep)."""
    Hq, Hkv, hd, D, F = n_heads, n_kv_heads, head_dim, d_model, ffn
    cache = (("pk", "pv") + (("ks", "vs") if quant else ()) + ("table",)
             if paged else ("ck", "cv"))
    b = MegaKernelBuilder()
    b.inputs("xv", "pos", "w_ln1", "w_qkv", "q_norm", "k_norm", "w_o", "w_ln2",
             "w_gu", "w_d", "cos", "sin", *cache)
    b.buffer("xn", ("B", D), torch.bfloat16)
    b.buffer("qkv", ("B", (Hq + 2 * Hkv) * hd), torch.float32)
    b.buffer("attn", ("B", Hq * hd), torch.bfloat16)
    b.buffer("ores", ("B", D), torch.float32)
    b.buffer("on", ("B", D), torch.bfloat16)
    b.buffer("h", ("B", F), torch.bfloat16)
    b.buffer("y", ("B", D), torch.float32)

    def ln1(env):
        env["xn"] = _rms(env["xv"], env["w_ln1"], eps).to(torch.bfloat16)

    def qkv_mm(env):
        env["qkv"] = _mm(env["xn"], env["w_qkv"])

    def o_proj(env):
        env["ores"] = _mm(env["attn"], env["w_o"]) + env["xv"].float()

    def partial(src, w, dst):
        def emit(env):
            env[dst] = _mm(env[src], env[w])
        return emit

    def allreduce(src, add, dst):
        def emit(env):
            acc = env[add].float()
            for peer in env["ranks"]:
                acc = acc + peer[src].to(acc.device)
            env[dst] = acc
        return emit

    def ln2(env):
        env["on"] = _rms(env["ores"], env["w_ln2"], eps).to(torch.bfloat16)

    def gate_up_swiglu(env):
        gu = _mm(env["on"], env["w_gu"])
        g, u = gu[:, :F], gu[:, F:]
        env["h"] = (g * torch.sigmoid(g) * u).to(torch.bfloat16)

    def down_proj(env):
        env["y"] = _mm(env["h"], env["w_d"]) + env["ores"]

    attend = _attend_paged if paged else _attend_contig
    b.add_task("ln1", ln1, reads=("xv", "w_ln1"), writes=("xn",))
    b.add_task("qkv_mm", qkv_mm, reads=("xn", "w_qkv"), writes=("qkv",))
    b.add_task("attend", lambda env: attend(env, Hq, Hkv, hd, eps, qk_norm),
               reads=("qkv", "pos", "cos", "sin", "q_norm", "k_norm") + cache,
               writes=("attn",) + cache[:4 if quant else 2])
    if tp > 1:
        # partial o_proj (no residual: the sum over the ranks comes first),
        # then the in-kernel all-reduce adds the residual
        b.buffer("ores_p", ("B", D), torch.float32)
        b.buffer("y_p", ("B", D), torch.float32)
        b.add_task("o_proj", partial("attn", "w_o", "ores_p"), reads=("attn", "w_o"),
                   writes=("ores_p",))
        b.add_task("o_allreduce", allreduce("ores_p", "xv", "ores"), reads=("ores_p", "xv"),
                   writes=("ores",))
    else:
        b.add_task("o_proj", o_proj, reads=("attn", "w_o", "xv"), writes=("ores",))
    b.add_task("ln2", ln2, reads=("ores", "w_ln2"), writes=("on",))
    b.add_task("gate_up_swiglu", gate_up_swiglu, reads=("on", "w_gu"), writes=("h",))
    if tp > 1:
        b.add_task("down_proj", partial("h", "w_d", "y_p"), reads=("h", "w_d"),
                   writes=("y_p",))
        b.add_task("d_allreduce", allreduce("y_p", "ores", "y"), reads=("y_p", "ores"),
                   writes=("y",))
    else:
        b.add_task("down_proj", down_proj, reads=("h", "w_d", "ores"), writes=("y",))
    return b


def _env(x, pos, weights: Dict[str, torch.Tensor], **cache) -> dict:
    env = dict(xv=x.float(), pos=pos, cos=weights["cos_row"], sin=weights["sin_row"],
               **cache)
    for name in ("w_ln1", "w_qkv", "q_norm", "k_norm", "w_o", "w_ln2", "w_gu", "w_d"):
        env[name] = weights[name]
    return env


def mega_decode_layer_ref(x, pos, weights, cache_k, cache_v, *, n_heads, n_kv_heads,
                          head_dim, eps=1e-6, qk_norm=True, tp=1):
    """Plain version of MegaDecodeLayer: its task program's PyTorch
    emitters in order. Updates cache_k/v [B, Hkv, T, hd] in place at
    column pos and returns (y [B, D] f32, cache_k, cache_v). At tp > 1
    x, weights, cache_k and cache_v are per-rank lists (the geometry the
    rank's shard) and each of the three results is a list too."""
    if tp > 1:
        D = x[0].shape[1]
        prog = _program(False, False, n_heads=n_heads, n_kv_heads=n_kv_heads,
                        head_dim=head_dim, d_model=D, ffn=weights[0]["w_d"].shape[0],
                        eps=eps, qk_norm=qk_norm, tp=tp)
        return _emit_tp(prog, x, int(pos), weights, cache_k, cache_v)
    D = x.shape[1]
    prog = _program(False, False, n_heads=n_heads, n_kv_heads=n_kv_heads,
                    head_dim=head_dim, d_model=D, ffn=weights["w_d"].shape[0], eps=eps,
                    qk_norm=qk_norm)
    env = _env(x, int(pos), weights, ck=cache_k, cv=cache_v)
    prog.emit_all(env)
    return env["y"], cache_k, cache_v


def _emit_tp(prog, xs, pos: int, weights, cks, cvs):
    """The TP program's emitters in lockstep over the ranks' envs."""
    envs = [_env(x, pos, w, ck=k, cv=v) for x, w, k, v in zip(xs, weights, cks, cvs)]
    for env in envs:
        env["ranks"] = envs
    prog.emit_lockstep(envs)
    return [env["y"] for env in envs], list(cks), list(cvs)


def mega_paged_decode_layer_ref(x, pos, weights, pages_k, pages_v, table, scales_k=None,
                                scales_v=None, *, n_heads, n_kv_heads, head_dim,
                                eps=1e-6, qk_norm=True):
    """Plain version of MegaPagedDecodeLayer: its task program's PyTorch
    emitters in order. Writes each slot's new row through the table in
    place (pools [NP, 1, page, hd], int8 scale pools [NP, 1, page]) and
    returns (y [B, D] f32, pages_k, pages_v[, scales_k, scales_v])."""
    quant = scales_k is not None
    D = x.shape[1]
    prog = _program(True, quant, n_heads=n_heads, n_kv_heads=n_kv_heads,
                    head_dim=head_dim, d_model=D, ffn=weights["w_d"].shape[0], eps=eps,
                    qk_norm=qk_norm)
    cache = dict(pk=pages_k, pv=pages_v, table=table)
    if quant:
        cache.update(ks=scales_k, vs=scales_v)
    env = _env(x, pos, weights, **cache)
    prog.emit_all(env)
    return (env["y"], pages_k, pages_v) + ((scales_k, scales_v) if quant else ())


@dataclasses.dataclass
class _Layer:
    """Geometry, the validated task program and, on the card, the
    scratch its launches share (allocated once per batch size and
    rank)."""

    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    ffn: int
    eps: float = 1e-6
    qk_norm: bool = True
    _scratch: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                       compare=False)

    def _scratch_for(self, B: int, device, rank: int = 0) -> dict:
        """Rank `rank`'s scratch (each rank's CTAs count on their own grid
        barrier); `part` f32 [B, D] stages the partials of the TP form."""
        s = self._scratch.get(rank)
        if s is None or s["B"] != B or s["xn"].device != device:
            D, F = self.d_model, self.ffn
            Hq, Hkv, hd = self.n_heads, self.n_kv_heads, self.head_dim

            def e(shape, dt):
                return torch.empty(shape, dtype=dt, device=device)

            s = self._scratch[rank] = dict(
                B=B, xn=e((B, D), torch.bfloat16),
                qkv=e((B, (Hq + 2 * Hkv) * hd), torch.float32),
                attn=e((B, Hq * hd), torch.bfloat16), ores=e((B, D), torch.float32),
                on=e((B, D), torch.bfloat16), h=e((B, F), torch.bfloat16),
                part=e((B, D), torch.float32),
                barrier=torch.zeros(2, dtype=torch.int32, device=device))
        return s

    def _check(self, x, weights, cache_tensors) -> None:
        """What the kernel takes, checked before a launch."""
        self._check_weights(weights, x.device)
        self._check_step(x, weights, cache_tensors)

    def _check_weights(self, weights, device) -> None:
        """The geometry, the panels and the norms (what stays from step to
        step), on `device`."""
        name = type(self).__name__
        D, F = self.d_model, self.ffn
        Hq, Hkv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        if hd != _KERNEL_HEAD_DIM or Hq % Hkv or Hq // Hkv > _MAX_REP:
            raise ValueError(f"{name}: the kernel takes head_dim {_KERNEL_HEAD_DIM} and "
                             f"up to {_MAX_REP} query heads per kv head, got hd={hd}, "
                             f"Hq={Hq}, Hkv={Hkv}")
        if D % _TILE or F % _TILE:
            raise ValueError(f"{name}: d_model {D} and ffn {F} must be multiples of "
                             f"{_TILE}")
        want = {"w_qkv": (D, (Hq + 2 * Hkv) * hd), "w_o": (Hq * hd, D),
                "w_gu": (D, 2 * F), "w_d": (F, D)}
        for k, shape in want.items():
            w = weights[k]
            if w.dtype != torch.bfloat16 or tuple(w.shape) != shape \
                    or not w.is_contiguous():
                raise ValueError(f"{name}: {k} must be contiguous bf16 {shape}, got "
                                 f"{w.dtype} {tuple(w.shape)}")
        for k, n in (("w_ln1", D), ("w_ln2", D), ("q_norm", hd), ("k_norm", hd)):
            w = weights[k]
            if w.dtype != torch.float32 or w.numel() != n or not w.is_contiguous():
                raise ValueError(f"{name}: {k} must be contiguous f32 with {n} values")
        _check_placed(name, [weights[k] for k in _WEIGHT_KEYS], device)

    def _check_step(self, x, weights, cache_tensors) -> None:
        """x, the rope rows and the cache tensors (what changes from step
        to step), on x's device."""
        name = type(self).__name__
        D, hd = self.d_model, self.head_dim
        B = x.shape[0]
        if x.dtype != torch.float32 or x.shape != (B, D) or not x.is_contiguous():
            raise ValueError(f"{name}: x must be contiguous f32 [B, {D}], got "
                             f"{x.dtype} {tuple(x.shape)}")
        for k in ("cos_row", "sin_row"):
            w = weights[k]
            if (w.dtype != torch.float32 or w.dim() != 2 or w.shape[0] not in (1, B)
                    or w.shape[1] != hd // 2 or not w.is_contiguous()):
                raise ValueError(f"{name}: {k} must be contiguous f32 [1 or B, {hd // 2}]")
        _check_placed(name, [x, weights["cos_row"], weights["sin_row"]] + cache_tensors,
                      x.device)

    def _static_args(self, weights, s, kv_dtype: int):
        """The parts of one rank's MegaLayerArgs that stay from call to
        call: the panels' and norms' pointers, the scratch's, and the
        geometry ints."""
        return ([weights[k].data_ptr() for k in _WEIGHT_KEYS],
                [s[k].data_ptr() for k in _SCRATCH_KEYS],
                [s["B"], self.d_model, self.ffn, self.n_heads, self.n_kv_heads,
                 self.head_dim, int(self.qk_norm), kv_dtype])

    @staticmethod
    def _compose(x, y, weights, cache_ptrs, ints, static, pos_dev=0, table=0):
        """The pointer and int lists of one rank's csrc/launchers.h
        MegaLayerArgs, in csrc/binding.cpp's order, from _static_args' parts;
        ints = {pos, T, maxp, page, kv_sb, kv_sh, kv_st, pg_st, row_st,
        spg_st}."""
        wp, sp, geom = static
        cos, sin = weights["cos_row"], weights["sin_row"]
        ptrs = [x.data_ptr(), y.data_ptr(), *wp, cos.data_ptr(), sin.data_ptr(),
                *cache_ptrs, table, pos_dev, *sp]
        n = [0 if cos.shape[0] == 1 else cos.stride(0)] + [ints[k] for k in _INT_KEYS]
        return ptrs, n + geom + [FAULT]

    def _launch(self, fn: str, program, x, weights, cache_ptrs, ints, pos_dev=0, table=0):
        """One launch of kernel `fn` running `program`'s tasks as phases, in
        recorded order, under x's device."""
        s = self._scratch_for(x.shape[0], x.device)
        y = torch.empty_like(x)
        ptrs, n = self._compose(x, y, weights, cache_ptrs, ints,
                                self._static_args(weights, s, ints["kv_dtype"]), pos_dev,
                                table)
        with torch.cuda.device(x.device):
            getattr(_build.ext(), fn)(ptrs, n, float(self.eps), float(self.head_dim ** -0.5),
                                      [PHASES[t.name] for t in program.tasks],
                                      _build.stream_ptr(x.device))
        _build.count(fn)
        return y


def _check_placed(name: str, tensors, device) -> None:
    if any(t.device != device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one device")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: every tensor must start 16-byte aligned "
                         "(the kernel loads 16-byte vectors)")


def _check_contig_cache(name: str, cache_k, cache_v, shape) -> None:
    if (cache_k.dtype != torch.bfloat16 or cache_v.dtype != torch.bfloat16
            or tuple(cache_k.shape) != shape or tuple(cache_v.shape) != shape
            or cache_k.stride() != cache_v.stride() or cache_k.stride(3) != 1
            or any(st % 8 for st in cache_k.stride()[:3])):
        raise ValueError(f"{name}: caches must be bf16 {shape} with equal "
                         "strides, head_dim contiguous and 16-byte rows")


def _contig_ints(T: int, pos: int, cache_k) -> dict:
    st = cache_k.stride()
    return dict(pos=pos, T=T, maxp=0, page=0, kv_sb=st[0], kv_sh=st[1], kv_st=st[2],
                pg_st=0, row_st=0, spg_st=0, kv_dtype=_build.DTYPE_CODES[torch.bfloat16])


@dataclasses.dataclass
class MegaDecodeLayer(_Layer):
    """One decode layer over the contiguous cache. T is the cache
    capacity. tp > 1: the tensor-parallel form over `mesh` (its size tp;
    needed on the card only), the geometry being one rank's shard."""

    T: int = 0
    tp: int = 1
    axis: str = "tp"
    mesh: Optional[object] = dataclasses.field(default=None, repr=False, compare=False)
    _plans: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                     compare=False)

    def __post_init__(self):
        self.program = _program(False, False, n_heads=self.n_heads,
                                n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
                                d_model=self.d_model, ffn=self.ffn, eps=self.eps,
                                qk_norm=self.qk_norm, tp=self.tp)

    def __call__(self, x, pos, weights, cache_k, cache_v):
        """x [B, D]; pos: host int, tokens already cached (the new token
        lands at column pos); weights: w_ln1 [1, D], w_qkv [D, (Hq+2Hkv)hd],
        q_norm/k_norm [1, hd], w_o [Hq*hd, D], w_ln2 [1, D], w_gu [D, 2F]
        (gate | up), w_d [F, D], cos_row/sin_row [1, hd/2] at pos; the
        kernel takes bf16 panels and f32 norms and rope rows. cache_k/v
        [B, Hkv, T, hd], updated in place. Returns (y [B, D] f32,
        cache_k, cache_v). At tp > 1 each argument but pos is a list of
        the ranks' (x replicated, the rank's weight shards [q_r | k_r |
        v_r] and [gate_r | up_r] and cache heads), and so is each
        result."""
        pos = int(pos)
        if self.tp > 1:
            return self._call_tp(x, pos, weights, cache_k, cache_v)
        if x.device.type == "cpu":
            env = _env(x, pos, weights, ck=cache_k, cv=cache_v)
            self.program.emit_all(env)
            return env["y"], cache_k, cache_v
        B = x.shape[0]
        self._check(x, weights, [cache_k, cache_v])
        _check_contig_cache("MegaDecodeLayer", cache_k, cache_v,
                            (B, self.n_kv_heads, self.T, self.head_dim))
        if not 0 <= pos < self.T:
            raise ValueError(f"MegaDecodeLayer: pos {pos} outside [0, T={self.T})")
        y = self._launch("mega_decode", self.program, x, weights,
                         [cache_k.data_ptr(), cache_v.data_ptr(), 0, 0],
                         _contig_ints(self.T, pos, cache_k))
        return y, cache_k, cache_v

    def _call_tp(self, xs, pos: int, weights, cks, cvs):
        n = self.tp
        if not all(isinstance(a, (list, tuple)) and len(a) == n
                   for a in (xs, weights, cks, cvs)):
            raise ValueError(f"MegaDecodeLayer tp={n}: x, weights, cache_k and cache_v "
                             f"must be lists of {n} (one a rank)")
        if xs[0].device.type == "cpu":
            return _emit_tp(self.program, xs, pos, weights, cks, cvs)
        mesh = self.mesh
        if mesh is None or mesh.size != n:
            raise ValueError(f"MegaDecodeLayer tp={n}: the card needs the mesh of {n} "
                             "ranks the layer runs over (mesh=)")
        if not 0 <= pos < self.T:
            raise ValueError(f"MegaDecodeLayer: pos {pos} outside [0, T={self.T})")
        B = xs[0].shape[0]
        plan = self._tp_plan(B, weights)
        shape = (B, self.n_kv_heads, self.T, self.head_dim)
        for r, (x, w, k, v, d) in enumerate(zip(xs, weights, cks, cvs, mesh.devices)):
            if x.device != d or x.shape != xs[0].shape:
                raise ValueError(f"MegaDecodeLayer tp={n}: rank {r}'s x {tuple(x.shape)} "
                                 f"lies on {x.device}, its rank on {d}")
            self._check_step(x, w, [k, v])
            _check_contig_cache("MegaDecodeLayer", k, v, shape)
        ys = [torch.empty_like(x) for x in xs]
        args = [self._compose(x, y, w, [k.data_ptr(), v.data_ptr(), 0, 0],
                              _contig_ints(self.T, pos, k), st)
                for x, y, w, k, v, st in zip(xs, ys, weights, cks, cvs, plan["static"])]

        def call(lib, first, n_local, epoch, sig, st):
            mine = args[first:first + n_local]
            lib.mega_decode_tp([a[0] for a in mine], [a[1] for a in mine], float(self.eps),
                               float(self.head_dim ** -0.5), plan["phases"], plan["land"],
                               sig, first, n_local, epoch, plan["ctas"], st)

        _comm.launch("mega_decode", mesh, call, method="tp")
        return ys, list(cks), list(cvs)

    def _tp_plan(self, B: int, weights) -> dict:
        """What a TP launch over these weight tensors at batch B takes that
        stays from step to step: the weights checked once, each rank's
        pointers and geometry, the landing buffer, the grid. Keyed on the
        weight tensors themselves (the plan holds them, and the scratch
        and landing buffer its pointers name)."""
        key = (B,) + tuple(id(w[k]) for w in weights for k in _WEIGHT_KEYS)
        plan = self._plans.get(key)
        if plan is None:
            mesh = self.mesh
            for w, d in zip(weights, mesh.devices):
                self._check_weights(w, d)
            scratch = [self._scratch_for(B, d, r) for r, d in enumerate(mesh.devices)]
            land = create_symm_buffer("mega_tp", (2, self.tp, B, self.d_model),
                                      torch.float32, mesh=mesh)
            kv = _build.DTYPE_CODES[torch.bfloat16]
            if len(self._plans) >= _MAX_PLANS:
                self._plans.clear()
            plan = self._plans[key] = dict(
                held=([w[k] for w in weights for k in _WEIGHT_KEYS], scratch, land),
                static=[self._static_args(w, s, kv) for w, s in zip(weights, scratch)],
                land=land.ptrs, ctas=_comm.ctas(mesh, 1 << 30),
                phases=[PHASES[t.name] for t in self.program.tasks])
        return plan


@dataclasses.dataclass
class MegaPagedDecodeLayer(_Layer):
    """One decode layer over the paged pool (one head-group plane):
    per-slot positions, the page-table walk, the trash-page write sink of
    retired slots and, for an int8 pool, the scale planes."""

    page: int = 16
    maxp: int = 1

    def __post_init__(self):
        # one program per pool type: the int8 append also writes the scales
        self.programs = {quant: _program(
            True, quant, n_heads=self.n_heads, n_kv_heads=self.n_kv_heads,
            head_dim=self.head_dim, d_model=self.d_model, ffn=self.ffn, eps=self.eps,
            qk_norm=self.qk_norm) for quant in (False, True)}

    def __call__(self, x, pos, weights: Dict[str, torch.Tensor], pages_k, pages_v, table,
                 scales_k=None, scales_v=None):
        """x [B, D]; pos [B] int32 (tokens already cached per slot; the new
        token lands at pos[b]); weights: the contiguous layer's dict with
        per-slot rope rows cos_row/sin_row [B, hd/2]; pages_k/v
        [NP, 1, page, hd] (bf16, or int8 with scales_k/v [NP, 1, page]
        f32); table [B*Hkv, maxp] int32, every entry a valid page (unmapped
        ones the trash page). The pools are updated in place. Returns
        (y [B, D] f32, pages_k, pages_v[, scales_k, scales_v])."""
        quant = scales_k is not None
        if (scales_v is None) == quant:
            raise ValueError("MegaPagedDecodeLayer: give both scale pools or neither")
        pools = (pages_k, pages_v) + ((scales_k, scales_v) if quant else ())
        if x.device.type == "cpu":
            cache = dict(pk=pages_k, pv=pages_v, table=table)
            if quant:
                cache.update(ks=scales_k, vs=scales_v)
            env = _env(x, pos, weights, **cache)
            self.programs[quant].emit_all(env)
            return (env["y"],) + pools
        B = x.shape[0]
        Hkv, hd = self.n_kv_heads, self.head_dim
        self._check(x, weights, list(pools) + [table, pos])
        want = torch.int8 if quant else torch.bfloat16
        if (pages_k.dtype != want or pages_v.dtype != want or pages_k.dim() != 4
                or pages_k.shape[1:] != (1, self.page, hd)
                or pages_v.shape != pages_k.shape
                or pages_k.stride() != pages_v.stride() or pages_k.stride(3) != 1
                or any(st * pages_k.element_size() % 16 for st in pages_k.stride()[:3])):
            raise ValueError(f"MegaPagedDecodeLayer: pools must be {want} [NP, 1, "
                             f"{self.page}, {hd}] with equal strides, head_dim "
                             "contiguous and 16-byte rows")
        if quant and (scales_k.dtype != torch.float32 or scales_v.dtype != torch.float32
                      or tuple(scales_k.shape) != tuple(pages_k.shape[:3])
                      or scales_k.stride() != scales_v.stride()
                      or scales_k.stride(2) != 1):
            raise ValueError("MegaPagedDecodeLayer: scales must be f32 [NP, 1, page] "
                             "with equal strides")
        if (table.dtype != torch.int32 or tuple(table.shape) != (B * Hkv, self.maxp)
                or not table.is_contiguous()):
            raise ValueError(f"MegaPagedDecodeLayer: table must be contiguous int32 "
                             f"[{B * Hkv}, {self.maxp}]")
        if pos.dtype != torch.int32 or tuple(pos.shape) != (B,) or not pos.is_contiguous():
            raise ValueError(f"MegaPagedDecodeLayer: pos must be contiguous int32 [{B}]")
        ints = dict(pos=0, T=0, maxp=self.maxp, page=self.page, kv_sb=0, kv_sh=0, kv_st=0,
                    pg_st=pages_k.stride(0), row_st=pages_k.stride(2),
                    spg_st=scales_k.stride(0) if quant else 0,
                    kv_dtype=_build.DTYPE_CODES[want])
        ptrs = [t.data_ptr() for t in pools] + ([] if quant else [0, 0])
        y = self._launch("mega_paged_decode", self.programs[quant], x, weights, ptrs, ints,
                         pos_dev=pos.data_ptr(), table=table.data_ptr())
        return (y,) + pools
