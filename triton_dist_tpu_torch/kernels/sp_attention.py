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

The Ulysses functions reshard between sequence and heads. The plain
reshards `ulysses_dispatch` (sequence-sharded [B, s_loc, H, d] -> the
whole sequence of a head group, [B, S, H/n, d]) and `ulysses_combine`
(the inverse) run over kernels/all_to_all.py (csrc/a2a.cu, row 18) in the
JAX chunk order, so they are bitwise the exchange. `gemm_all_to_all` and
`qkv_gemm_a2a` fuse the QKV projection with the dispatch (csrc/
gemm_a2a.cu, row 28, counted as `gemm_a2a`), `o_a2a_gemm` the combine with
the O projection (csrc/a2a_gemm.cu, row 27); their plain versions
(`gemm_all_to_all_ref`, `o_a2a_gemm_ref`) are taken only for CPU
tensors. The weights are per-rank lists (one copy per rank, a replicated
JAX weight). The training ring (sp_ring_attention_train) is not ported yet
and raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from triton_dist_tpu_torch.kernels import _comm
from triton_dist_tpu_torch.kernels._build import DTYPE_CODES
from triton_dist_tpu_torch.kernels.all_to_all import all_to_all
from triton_dist_tpu_torch.kernels.flash_attn import (_HEAD_DIMS, _fold_q, _partial_ref,
                                                      _unfold_q, flash_decode,
                                                      flash_decode_partial, flash_decode_ref)
from triton_dist_tpu_torch.kernels.quant import _mm_f32
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


def sp_ring_attention_train(*args, **kwargs):
    raise NotImplementedError("sp_ring_attention_train (the SP training ring): not yet ported")


# ---------------------------------------------------------------- Ulysses

def _per_rank(what: str, total: int, n: int) -> int:
    if total % n:
        raise ValueError(f"{what}: {total} heads, positions or columns do not split over "
                         f"{n} ranks")
    return total // n


def ulysses_dispatch(x, *, mesh) -> list:
    """x: per rank its sequence block [B, s_loc, H, d] -> per rank the
    whole sequence of its head group, [B, n * s_loc, H / n, d] (rank r
    holds heads [r * H / n, (r + 1) * H / n)): chunk p of a rank's send
    buffer is head group p of its block, flattened to [B * s_loc, H / n *
    d] rows, and all_to_all moves the chunks (the JAX function's order)."""
    _comm.check_parts(x, mesh, "ulysses_dispatch", ndim=4)
    n = mesh.size
    if n == 1:
        return list(x)
    B, s_loc, H, d = x[0].shape
    h = _per_rank("ulysses_dispatch", H, n)
    send = [t.reshape(B, s_loc, n, h, d).permute(2, 0, 1, 3, 4).reshape(n * B * s_loc, h * d)
            for t in x]
    return [y.reshape(n, B, s_loc, h, d).transpose(0, 1).reshape(B, n * s_loc, h, d)
            for y in all_to_all(send, mesh=mesh)]


def ulysses_combine(x, *, mesh) -> list:
    """The inverse of ulysses_dispatch: x per rank [B, S, H / n, d] (its
    head group over the whole sequence) -> per rank its sequence block
    [B, S / n, H, d] of every head."""
    _comm.check_parts(x, mesh, "ulysses_combine", ndim=4)
    n = mesh.size
    if n == 1:
        return list(x)
    B, S, h, d = x[0].shape
    s_loc = _per_rank("ulysses_combine", S, n)
    send = [t.reshape(B, n, s_loc, h, d).transpose(0, 1).reshape(n * B * s_loc, h * d)
            for t in x]
    return [y.reshape(n, B, s_loc, h, d).permute(1, 2, 0, 3, 4).reshape(B, s_loc, n * h, d)
            for y in all_to_all(send, mesh=mesh)]


def _ulysses_operands(what: str, a, w, mesh, k_dim: int):
    """One contiguous a and w per rank (check_parts), w in a's dtype with
    k_dim rows. Returns w's columns."""
    _comm.check_parts(a, mesh, f"{what} A", ndim=a[0].dim())
    _comm.check_parts(w, mesh, f"{what} W", ndim=2)
    if w[0].dtype != a[0].dtype or w[0].shape[0] != k_dim:
        raise ValueError(f"{what}: A {tuple(a[0].shape)} {a[0].dtype} against W "
                         f"{tuple(w[0].shape)} {w[0].dtype}")
    return w[0].shape[1]


def _check_cuda(what: str, dt, dims) -> None:
    vec = 16 // (2 if dt == torch.bfloat16 else 4)
    if dt not in (torch.bfloat16, torch.float32) or any(x % vec for x in dims):
        raise ValueError(f"{what}: {dt} with widths {dims}; the kernel takes bf16 or f32 with "
                         f"these widths multiples of {vec}")


def gemm_all_to_all_ref(a, w) -> list:
    """Plain version of gemm_all_to_all: each rank's product in f32,
    rounded once to a's dtype; rank j's slot p is column chunk j of rank
    p's product."""
    n = len(a)
    Nc = w[0].shape[1] // n
    prods = [_mm_f32(ar, wr).to(ar.dtype) for ar, wr in zip(a, w)]
    return [torch.stack([prods[p][:, j * Nc:(j + 1) * Nc].to(a[j].device) for p in range(n)])
            for j in range(n)]


def gemm_all_to_all(a, w, *, mesh) -> list:
    """a: per rank its rows [m, K]; w: per rank the whole [K, N] (N = n *
    Nc, columns head-group-major: chunk j is owner j's). Returns per rank
    [n, m, Nc], slot p = rank p's rows times the rank's column chunk: the
    kernel on CUDA tensors (csrc/gemm_a2a.cu), gemm_all_to_all_ref on CPU
    tensors."""
    n = mesh.size
    m, K = a[0].shape
    N = _ulysses_operands("gemm_all_to_all", a, w, mesh, K)
    Nc = _per_rank("gemm_all_to_all", N, n)
    if a[0].device.type == "cpu":
        return gemm_all_to_all_ref(a, w)
    dt = a[0].dtype
    _check_cuda("gemm_all_to_all", dt, (K, Nc) if dt == torch.bfloat16 else (Nc,))
    out = _comm.empty_like_parts(a, (n, m, Nc))
    bt = 128 if dt == torch.bfloat16 else 64          # gemm_tile.cuh's RowTile
    G = _comm.ctas(mesh, n * -(-m // bt) * -(-Nc // bt))

    def call(lib, first, n_local, epoch, sig, st):
        lib.gemm_all_to_all(DTYPE_CODES[dt], [t.data_ptr() for t in a],
                            [t.data_ptr() for t in w], [t.data_ptr() for t in out], sig, first,
                            n_local, epoch, m, Nc, K, G, st)

    _comm.launch("gemm_a2a", mesh, call)
    return out


def qkv_gemm_a2a(x, w, *, mesh) -> list:
    """The QKV projection fused with the Ulysses dispatch: x per rank its
    sequence block [B, s_loc, D], w per rank [D, N] (columns
    head-group-major). Returns per rank [B, n * s_loc, N / n]: its head
    group's projection over the whole sequence."""
    _comm.check_parts(x, mesh, "qkv_gemm_a2a", ndim=3)
    n = mesh.size
    B, s_loc, D = x[0].shape
    out = gemm_all_to_all([t.reshape(B * s_loc, D) for t in x], w, mesh=mesh)
    Nc = out[0].shape[2]
    return [o.reshape(n, B, s_loc, Nc).transpose(0, 1).reshape(B, n * s_loc, Nc) for o in out]


def o_chunks(x: torch.Tensor, n: int) -> torch.Tensor:
    """One rank's [B, S, Nc] head-group output as its n send chunks [n, B *
    S / n, Nc], chunk p = sequence block p (contiguous)."""
    B, S, Nc = x.shape
    return x.reshape(B, n, S // n, Nc).transpose(0, 1).reshape(n, B * S // n, Nc).contiguous()


def o_a2a_gemm_from_chunks(chunks, w) -> list:
    """Rank me's [m, D]: the sum over q in the order me, me + 1, ... of
    chunk me of rank q times rows [q * Nc, (q + 1) * Nc) of w[me], in f32,
    rounded once to the chunks' dtype."""
    n = len(chunks)
    Nc = chunks[0].shape[2]
    out = []
    for me in range(n):
        dev = chunks[me].device
        acc = None
        for s in range(n):
            q = (me + s) % n
            part = _mm_f32(chunks[q][me].to(dev), w[me][q * Nc:(q + 1) * Nc])
            acc = part if acc is None else acc + part
        out.append(acc.to(chunks[me].dtype))
    return out


def o_a2a_gemm_ref(x, w) -> list:
    """Plain version of o_a2a_gemm, on its arguments: each rank's chunks
    (o_chunks) through o_a2a_gemm_from_chunks."""
    n = len(x)
    B, S, _ = x[0].shape
    out = o_a2a_gemm_from_chunks([o_chunks(t, n) for t in x], w)
    return [y.reshape(B, S // n, -1) for y in out]


def o_a2a_gemm(x, w, *, mesh) -> list:
    """The Ulysses combine fused with the O projection: x per rank its head
    group over the whole sequence, [B, S, Nc] (N = n * Nc), w per rank the
    whole [N, D] (rows head-group-major). Returns per rank its sequence
    block [B, S / n, D] of combine(x) @ w: the kernel on CUDA tensors
    (csrc/a2a_gemm.cu), o_a2a_gemm_ref on CPU tensors."""
    _comm.check_parts(x, mesh, "o_a2a_gemm", ndim=3)
    n = mesh.size
    B, S, Nc = x[0].shape
    s_loc = _per_rank("o_a2a_gemm", S, n)
    D = _ulysses_operands("o_a2a_gemm", x, w, mesh, n * Nc)
    if x[0].device.type == "cpu":
        return o_a2a_gemm_ref(x, w)
    m = B * s_loc
    chunks = [o_chunks(t, n) for t in x]
    dt = x[0].dtype
    _check_cuda("o_a2a_gemm", dt, (Nc, D) if dt == torch.bfloat16 else (Nc,))
    land = symm_workspace("ulysses_o_land", n * m, (Nc,), dt, mesh=mesh)
    out = _comm.empty_like_parts(x, (m, D))
    bt = 128 if dt == torch.bfloat16 else 64
    G = _comm.ctas(mesh, -(-m // bt) * -(-D // bt))

    def call(lib, first, n_local, epoch, sig, st):
        lib.o_a2a_gemm(DTYPE_CODES[dt], [t.data_ptr() for t in chunks],
                       [t.data_ptr() for t in w], [t.data_ptr() for t in out], land.ptrs, sig,
                       first, n_local, epoch, m, Nc, D, G, st)

    _comm.launch("o_a2a_gemm", mesh, call)
    return [y.reshape(B, s_loc, D) for y in out]
