"""Gated DeltaNet (GDN) linear attention: the chunked gated delta-rule
forward of Qwen3-Next-style hybrid models.

Counterpart of triton_dist_tpu/kernels/gdn.py (`gdn_fwd`, `gdn_fwd_ref`),
same layouts and recurrence. Per head, state S [dk, dv]:

    S_t = exp(g_t) S_{t-1} + beta_t k_t (v_t - exp(g_t) S_{t-1}^T k_t)^T
    o_t = S_t^T q_t

q, k [B, H, T, dk]; v [B, H, T, dv]; g (log decay, <= 0) and beta (write
strength, in [0, 1]) [B, H, T]; an optional initial state S0
[B, H, dk, dv]. Within a chunk of C tokens the corrections solve the
unit-lower system (I + diag(beta) L) U = diag(beta)(V - diag(A) K S0)
with L_ij = exp(cum_i - cum_j) k_i.k_j (j < i) and A = exp(cum), cum the
inclusive cumulative log decay; O = A Q S + (idec * Q K^T) U and
S' = exp(cum_C) S + (exp(cum_C - cum) K)^T U.

mode="pallas" (the JAX name, kept as the port keeps backend "xla")
launches the hand-written CUDA kernel (csrc/gdn.cu) for CUDA tensors and
takes its plain version, `gdn_chunk_ref` (the kernel's arithmetic in the
kernel's order: f32, a forward substitution, one rounding of o), only
for CPU tensors. It takes dk and dv in {64, 128} and chunks of 32 or 64
tokens, and raises on other shapes where the JAX function falls back to
"ut" silently. mode="ut" (the closed form with
torch.linalg.solve_triangular) and mode="scan" (the per-token recurrence)
are plain PyTorch in f32, for any shape. `gdn_fwd_ref` is the per-token
recurrence in f64.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from triton_dist_tpu_torch.kernels import _build

_DIMS = (64, 128)      # dk and dv csrc/gdn.cu is instantiated for
_CHUNKS = (32, 64)     # and its chunk sizes


def _chunks(q, k, v, g, beta, chunk: int):
    """Pad T to a multiple of `chunk` (beta = 0 on the padding leaves the
    state untouched) and yield each chunk's (q, k, v, g, beta) in f32,
    folded to [B*H, C, ...]."""
    B, H, T = q.shape[:3]
    pad = (-T) % chunk

    def fold(a):
        widths = (0, 0) * (a.dim() - 3) + (0, pad)
        return torch.nn.functional.pad(a.float(), widths).reshape(B * H, T + pad,
                                                                  *a.shape[3:])
    q, k, v, g, beta = (fold(a) for a in (q, k, v, g, beta))
    for t0 in range(0, T + pad, chunk):
        sl = slice(t0, t0 + chunk)
        yield q[:, sl], k[:, sl], v[:, sl], g[:, sl], beta[:, sl]


def _decays(cum):
    """exp(cum_i - cum_j) where j < i (strict) and where j <= i
    (inclusive), zero elsewhere: the exponent is masked before the exp,
    as above the diagonal it is positive and overflows."""
    C = cum.shape[-1]
    diff = cum[..., :, None] - cum[..., None, :]
    low = torch.ones(C, C, dtype=torch.bool, device=cum.device).tril()
    incl = torch.where(low, diff, float("-inf")).exp()
    strict = torch.where(low.tril(-1), diff, float("-inf")).exp()
    return strict, incl


def _run(q, k, v, g, beta, S0, chunk: int, step) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk loop shared by the plain forms: step(S, chunk arrays) -> (S,
    O [B*H, C, dv]); returns o [B, H, T, dv] in q's dtype and S_T f32."""
    B, H, T, dk = q.shape
    dv = v.shape[-1]
    S = (torch.zeros(B * H, dk, dv, dtype=torch.float32, device=q.device) if S0 is None
         else S0.float().reshape(B * H, dk, dv))
    outs = []
    for c in _chunks(q, k, v, g, beta, chunk):
        S, O = step(S, *c)
        outs.append(O)
    o = (torch.cat(outs, 1) if outs else q.new_zeros(B * H, 0, dv, dtype=torch.float32))
    return o[:, :T].reshape(B, H, T, dv).to(q.dtype), S.reshape(B, H, dk, dv)


def _chunk_ut(S, q, k, v, g, b):
    """One chunk in the closed form, the solve by solve_triangular (the
    JAX chunk_ut)."""
    cum = torch.cumsum(g, -1)
    A = cum.exp()
    strict, incl = _decays(cum)
    L = strict * (k @ k.transpose(1, 2))
    rhs = b[..., None] * (v - A[..., None] * (k @ S))
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    U = torch.linalg.solve_triangular(eye + b[..., None] * L, rhs, upper=False,
                                      unitriangular=True)
    O = A[..., None] * (q @ S) + (incl * (q @ k.transpose(1, 2))) @ U
    w = (cum[:, -1:] - cum).exp()[..., None] * k
    return cum[:, -1].exp()[:, None, None] * S + w.transpose(1, 2) @ U, O


def _chunk_scan(S, q, k, v, g, b):
    """One chunk by the per-token recurrence (the JAX chunk_step)."""
    outs = []
    for t in range(q.shape[1]):
        Sd = g[:, t].exp()[:, None, None] * S
        pred = torch.einsum("xkv,xk->xv", Sd, k[:, t])
        delta = (v[:, t] - pred) * b[:, t, None]
        S = Sd + k[:, t, :, None] * delta[:, None, :]
        outs.append(torch.einsum("xkv,xk->xv", S, q[:, t]))
    return S, torch.stack(outs, 1)


def _chunk_kernel_order(S, q, k, v, g, b):
    """One chunk as csrc/gdn.cu computes it: the same products and
    roundings (f32), the unit-lower system solved by forward substitution
    row by row, the state update as K^T (wdec * U)."""
    cum = torch.cumsum(g, -1)
    A = cum.exp()
    strict, incl = _decays(cum)
    L = b[..., None] * (strict * (k @ k.transpose(1, 2)))
    N = incl * (q @ k.transpose(1, 2))
    U = b[..., None] * (v - A[..., None] * (k @ S))
    for i in range(1, U.shape[1]):
        U[:, i] -= (L[:, i:i + 1, :i] @ U[:, :i])[:, 0]
    O = A[..., None] * (q @ S) + N @ U
    wd = (cum[:, -1:] - cum).exp()
    return cum[:, -1].exp()[:, None, None] * S + k.transpose(1, 2) @ (wd[..., None] * U), O


def gdn_chunk_ref(q, k, v, g, beta, *, S0=None, chunk: int = 64):
    """Plain version of the kernel (any shape): o [B, H, T, dv] in q's
    dtype and S_T [B, H, dk, dv] f32, computed in the kernel's order."""
    return _run(q, k, v, g, beta, S0, chunk, _chunk_kernel_order)


def _check_kernel_args(q, k, v, g, beta, S0, chunk: int) -> None:
    """The shapes and types csrc/gdn.cu takes (ValueError otherwise)."""
    B, H, T, dk = q.shape
    dv = v.shape[-1]
    if (k.shape != q.shape or v.shape[:3] != (B, H, T) or g.shape != (B, H, T)
            or beta.shape != (B, H, T)
            or (S0 is not None and S0.shape != (B, H, dk, dv))):
        raise ValueError(f"gdn_fwd: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, g {tuple(g.shape)}, beta {tuple(beta.shape)}"
                         f"{'' if S0 is None else f', S0 {tuple(S0.shape)}'} do not match")
    if dk not in _DIMS or dv not in _DIMS or chunk not in _CHUNKS:
        raise ValueError(f"gdn_fwd(mode='pallas'): the kernel takes dk, dv in {_DIMS} and "
                         f"chunk in {_CHUNKS}, got dk={dk} dv={dv} chunk={chunk}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"gdn_fwd(mode='pallas'): q, k, v {q.dtype}, {k.dtype}, {v.dtype}: "
                         "want bf16 or f32 alike")
    f32 = [g, beta] + ([] if S0 is None else [S0])
    if any(t.dtype != torch.float32 for t in f32):
        raise ValueError("gdn_fwd(mode='pallas'): g, beta and S0 must be f32")
    tensors = [q, k, v] + f32
    if any(t.device != q.device for t in tensors):
        raise ValueError("gdn_fwd: all tensors must be on one device")
    if any(not t.is_contiguous() for t in tensors) or any(t.data_ptr() % 16
                                                          for t in (q, k, v)):
        raise ValueError("gdn_fwd(mode='pallas'): the kernel takes contiguous tensors, "
                         "q, k and v 16-byte aligned")


def gdn_fwd(q, k, v, g, beta, *, S0: Optional[torch.Tensor] = None, chunk: int = 64,
            mode: str = "pallas", ablate: frozenset = frozenset()
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked gated delta-rule forward. q, k: [B, H, T, dk]; v:
    [B, H, T, dv]; g (log decay, <= 0) and beta (in [0, 1]): [B, H, T];
    S0: [B, H, dk, dv] or None (zeros). Returns (o [B, H, T, dv] in q's
    dtype, S_T [B, H, dk, dv] f32).

    mode="pallas" (default): the CUDA kernel for CUDA tensors (dk, dv in
    {64, 128}, chunk in {32, 64}, q/k/v bf16 or f32 alike, g/beta/S0 f32,
    contiguous; ValueError otherwise), gdn_chunk_ref for CPU tensors (the
    same checks). mode="ut": the closed form, plain. mode="scan": the
    per-token recurrence, plain. ablate (the JAX kprof ablation phases)
    is not ported."""
    if ablate:
        raise NotImplementedError("gdn_fwd(ablate=...): the kprof ablation phases are not "
                                  "yet ported")
    if mode == "ut":
        return _run(q, k, v, g, beta, S0, chunk, _chunk_ut)
    if mode == "scan":
        return _run(q, k, v, g, beta, S0, chunk, _chunk_scan)
    if mode != "pallas":
        raise ValueError(f"gdn_fwd: unknown mode {mode!r} (expected 'pallas', 'ut' or "
                         "'scan')")
    _check_kernel_args(q, k, v, g, beta, S0, chunk)
    if q.device.type == "cpu":
        return gdn_chunk_ref(q, k, v, g, beta, S0=S0, chunk=chunk)
    B, H, T, dk = q.shape
    dv = v.shape[-1]
    o = torch.empty((B, H, T, dv), dtype=q.dtype, device=q.device)
    S_T = torch.empty((B, H, dk, dv), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _build.ext().gdn_fwd(_build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                             v.data_ptr(), g.data_ptr(), beta.data_ptr(),
                             0 if S0 is None else S0.data_ptr(), o.data_ptr(), S_T.data_ptr(),
                             B * H, T, dk, dv, chunk, _build.stream_ptr(q.device))
    _build.count("gdn_fwd")
    return o, S_T


def gdn_fwd_ref(q, k, v, g, beta, S0=None):
    """The per-token recurrence in f64 (the JAX numpy oracle), on the
    inputs' device. Returns (o [B, H, T, dv], S_T [B, H, dk, dv]), f64."""
    q, k, v, g, beta = (t.double() for t in (q, k, v, g, beta))
    B, H, T, dk = q.shape
    dv = v.shape[-1]
    S = (torch.zeros(B, H, dk, dv, dtype=torch.float64, device=q.device) if S0 is None
         else S0.double())
    o = torch.zeros(B, H, T, dv, dtype=torch.float64, device=q.device)
    for t in range(T):
        Sd = g[:, :, t].exp()[..., None, None] * S
        pred = torch.einsum("bhkv,bhk->bhv", Sd, k[:, :, t])
        delta = (v[:, :, t] - pred) * beta[:, :, t, None]
        S = Sd + k[:, :, t, :, None] * delta[..., None, :]
        o[:, :, t] = torch.einsum("bhkv,bhk->bhv", S, q[:, :, t])
    return o, S
