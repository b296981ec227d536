"""Sequence-parallel attention for long-context prefill: counterpart of
triton_dist_tpu/kernels/sp_attention.py (`sp_ring_attention` in its three
modes, `sp_ring_attention_ref`).

Q, K and V are sequence-sharded over a mesh of n ranks
(runtime/bootstrap.py): rank r holds positions [r * s_loc, (r + 1) *
s_loc), q as [B, s_loc, Hq, d] and k, v as [B, Hkv, s_loc, d], one tensor
per rank in a list. Every position is valid (prefill); the causal mask is
by global position.

- mode="ring": the JAX permute ring as torch ops over the rank list: at
  step r rank me folds the block of rank (me - r) mod n into its running
  (acc, m, l) with flash_attn.flash_decode_partial (row 1's partial form)
  and the pairwise LSE merge;
- mode="ag": PR 8's all_gather kernel (row 11) gathers K and V, then one
  flash_decode (row 1) per rank over the whole sequence (its partial form
  where the window is not causal);
- mode="ring_shmem": the one-kernel ring csrc/ring_attn.cu (row 26,
  counted as `ring_attn`), `ring_attn_ref` its plain version, taken only
  for CPU tensors.

The Ulysses functions (ulysses_dispatch, ulysses_combine, gemm_all_to_all,
qkv_gemm_a2a, o_a2a_gemm: rows 27-28) and the training ring
(sp_ring_attention_train) are not ported yet and raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from triton_dist_tpu_torch.kernels import _comm
from triton_dist_tpu_torch.kernels._build import DTYPE_CODES
from triton_dist_tpu_torch.kernels.flash_attn import (_HEAD_DIMS, _fold_q, _partial_ref,
                                                      _unfold_q, flash_decode,
                                                      flash_decode_partial, flash_decode_ref)
from triton_dist_tpu_torch.runtime.symm_mem import symm_workspace

MODES = ("ring", "ag", "ring_shmem")


def _lse_accumulate(carry, part):
    """Fold one split-KV partial into the running (acc, m, l): the
    pairwise form of the LSE combine."""
    acc, m, l = carry
    acc_i, m_i, l_i = part
    m_new = torch.maximum(m, m_i)
    a = torch.exp(m - m_new)
    b = torch.exp(m_i - m_new)
    return acc * a[..., None] + acc_i * b[..., None], m_new, l * a + l_i * b


def _step(me: int, src: int, s_loc: int, causal: bool):
    """(valid keys, query 0's frontier) of rank me's queries against rank
    src's block: a block from the future contributes nothing."""
    if causal:
        return (s_loc if src <= me else 0), (me - src) * s_loc
    return s_loc, s_loc - 1


def sp_ring_attention(q, k, v, *, mesh, scale: Optional[float] = None, causal: bool = True,
                      mode: str = "ring", out_dtype=None) -> list:
    """Self-attention prefill over sequence shards (see the module
    docstring). Returns every rank's [B, s_loc, Hq, d] in out_dtype
    (default q's)."""
    if mode not in MODES:
        raise ValueError(f"sp_ring_attention: mode {mode!r}, want one of {MODES}")
    n = mesh.size
    _comm.check_parts(q, mesh, "sp_ring_attention q", ndim=4)
    _comm.check_parts(k, mesh, "sp_ring_attention k", ndim=4)
    _comm.check_parts(v, mesh, "sp_ring_attention v", ndim=4)
    B, s_loc, Hq, d = q[0].shape
    Hkv = k[0].shape[1]
    if tuple(k[0].shape) != (B, Hkv, s_loc, d) or Hq % Hkv:
        raise ValueError(f"sp_ring_attention: q {tuple(q[0].shape)}, k {tuple(k[0].shape)}")
    scale = d ** -0.5 if scale is None else scale
    out_dtype = out_dtype or q[0].dtype
    if mode == "ag":
        return _ag(q, k, v, mesh, causal, scale, out_dtype)
    if mode == "ring_shmem":
        if q[0].device.type == "cpu":
            acc, m, l = ring_attn_ref(q, k, v, scale=scale, causal=causal)
        else:
            acc, m, l = _ring_attn_launch(q, k, v, mesh, scale, causal)
    else:
        acc, m, l = [], [], []
        for me in range(n):
            dev = q[me].device
            state = None
            for r in range(n):
                src = (me - r) % n
                valid, q_off = _step(me, src, s_loc, causal)
                part = flash_decode_partial(q[me], k[src].to(dev), v[src].to(dev), valid,
                                            q_off, scale=scale)
                state = part if state is None else _lse_accumulate(state, part)
            acc.append(state[0])
            m.append(state[1])
            l.append(state[2])
    return [(a / lr.clamp_min(1e-30)[..., None]).to(out_dtype) for a, lr in zip(acc, l)]


def _ag(q, k, v, mesh, causal: bool, scale: float, out_dtype) -> list:
    """mode "ag": the whole K and V gathered with all_gather (sequence
    first, so that each rank's shard is contiguous rows), then each rank's
    queries attend them in one flash_decode call."""
    from triton_dist_tpu_torch.kernels.allgather import AllGatherMethod, all_gather
    n = mesh.size
    B, s_loc, Hq, d = q[0].shape
    Hkv = k[0].shape[1]
    S = n * s_loc

    def gather(x):
        flat = [t.permute(2, 0, 1, 3).reshape(s_loc, B * Hkv * d).contiguous() for t in x]
        full = all_gather(flat, mesh=mesh, method=AllGatherMethod.ONE_SHOT)
        return [f.reshape(S, B, Hkv, d).permute(1, 2, 0, 3).contiguous() for f in full]

    kf, vf = gather(k), gather(v)
    out = []
    for me in range(n):
        if causal:
            o = flash_decode(q[me], kf[me], vf[me], (me + 1) * s_loc, scale=scale)
        else:
            acc, _, l = flash_decode_partial(q[me], kf[me], vf[me], S, S, scale=scale)
            o = acc / l.clamp_min(1e-30)[..., None]
        out.append(o.to(out_dtype))
    return out


def ring_attn_ref(q, k, v, *, scale: float, causal: bool = True):
    """Plain version of the ring kernel: per rank, the n steps' masked f32
    partials (flash_attn._partial_ref) merged pairwise in step order.
    Returns per rank (acc [B, s_loc, Hq, d] unnormalised, m, l [B, s_loc,
    Hq]), f32."""
    n = len(q)
    B, s_loc, Hq, d = q[0].shape
    Hkv = k[0].shape[1]
    acc, m, l = [], [], []
    for me in range(n):
        dev = q[me].device
        state = None
        for r in range(n):
            src = (me - r) % n
            valid, q_off = _step(me, src, s_loc, causal)
            part = _partial_ref(q[me], k[src].to(dev), v[src].to(dev), valid, q_off, scale)
            state = part if state is None else _lse_accumulate(state, part)
        acc.append(_unfold_q(state[0], B, s_loc, Hkv))
        m.append(_unfold_q(state[1], B, s_loc, Hkv))
        l.append(_unfold_q(state[2], B, s_loc, Hkv))
    return acc, m, l


def _ring_attn_launch(q, k, v, mesh, scale: float, causal: bool):
    B, s_loc, Hq, d = q[0].shape
    Hkv = k[0].shape[1]
    dt = q[0].dtype
    if dt not in (torch.bfloat16, torch.float32) or k[0].dtype != dt or v[0].dtype != dt \
            or d not in _HEAD_DIMS:
        raise ValueError(f"sp_ring_attention ring_shmem: q {dt}, k {k[0].dtype}, v "
                         f"{v[0].dtype}, head dim {d}: the kernel takes bf16 or f32 "
                         f"throughout and head dims {_HEAD_DIMS}")
    rep = Hq // Hkv
    X, rows = B * Hkv, s_loc * rep
    qx = [_fold_q(t, Hkv).contiguous() for t in q]
    kx = [t.reshape(X, s_loc, d).contiguous() for t in k]
    vx = [t.reshape(X, s_loc, d).contiguous() for t in v]
    land_k = symm_workspace("sp_ring_k", 2 * X * s_loc, (d,), dt, mesh=mesh)
    land_v = symm_workspace("sp_ring_v", 2 * X * s_loc, (d,), dt, mesh=mesh)
    acc = _comm.empty_like_parts(qx, (X, rows, d), torch.float32)
    m = _comm.empty_like_parts(qx, (X, rows), torch.float32)
    l = _comm.empty_like_parts(qx, (X, rows), torch.float32)
    G = _comm.ctas(mesh, X * -(-rows // 16))

    def ptrs(ts):
        return [t.data_ptr() for t in ts]

    def call(lib, first, n_local, epoch, sig, st):
        lib.ring_attn(DTYPE_CODES[dt], d, ptrs(qx), ptrs(kx), ptrs(vx), ptrs(acc), ptrs(m),
                      ptrs(l), land_k.ptrs, land_v.ptrs, sig, first, n_local, epoch, X, rows,
                      s_loc, rep, int(causal), float(scale), G, st)

    _comm.launch("ring_attn", mesh, call)
    return ([_unfold_q(a, B, s_loc, Hkv) for a in acc], [_unfold_q(a, B, s_loc, Hkv) for a in m],
            [_unfold_q(a, B, s_loc, Hkv) for a in l])


def sp_ring_attention_ref(q, k, v, *, scale: Optional[float] = None, causal: bool = True):
    """Full-tensor plain oracle: q [B, S, Hq, d], k, v [B, Hkv, S, d];
    flash_decode_ref with the prefill frontier (kv_len S causal, shifted
    past the last key otherwise)."""
    S = q.shape[1]
    return flash_decode_ref(q, k, v, S if causal else 2 * S - 1, scale=scale)


def _not_ported(name: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(f"{name} (Ulysses sequence parallelism and the SP training "
                                  "ring): not yet ported")
    fn.__name__ = name
    return fn


sp_ring_attention_train = _not_ported("sp_ring_attention_train")
ulysses_dispatch = _not_ported("ulysses_dispatch")
ulysses_combine = _not_ported("ulysses_combine")
gemm_all_to_all = _not_ported("gemm_all_to_all")
qkv_gemm_a2a = _not_ported("qkv_gemm_a2a")
o_a2a_gemm = _not_ported("o_a2a_gemm")
