"""Differentiable causal GQA flash attention: the training path.

Counterpart of triton_dist_tpu/kernels/flash_attn_train.py
(`flash_attention`, `flash_attention_ref`, `_flash_bwd_call`,
`_fold_q`/`_unfold_q`, `query_chunk`), same layouts and causal
convention: q [B, S, Hq, d], k and v [B, Hkv, T, d] with T >= S, query s
attends keys <= T - S + s.

The forward is one launch of flash_decode's partial form over the whole
query (kernels/flash_attn.py `_partial`), normalised here into the
output and the log-sum-exp the backward needs. (The JAX forward splits
the query into `query_chunk` pieces only to fit VMEM; a CUDA block walks
its own causal frontier, so the port makes one call.) The backward is two
kernels in the folded GQA layout [B*Hkv, S*rep, d] (csrc/flash_attn_bwd.cu):
dq, and dk with dv, from the recompute formula

    P = exp(scale * Q K^T - LSE),  dS = P * (dO V^T - D),  D = rowsum(dO * O),
    dQ = scale * dS K,  dK = scale * dS^T Q,  dV = P^T dO.

`flash_attention_bwd` (`flash_attention_bwd_dq` and
`flash_attention_bwd_dkdv`, one kernel each) launches the kernels for
CUDA tensors and takes the plain versions of that formula
(`flash_attention_bwd_ref`, `flash_attention_bwd_dq_ref`,
`flash_attention_bwd_dkdv_ref`) only for CPU tensors.
`flash_attention_ref` is the differentiable plain oracle.
"""

from __future__ import annotations

from typing import Optional

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels.flash_attn import _fold_q, _partial, _unfold_q

_HEAD_DIMS = (64, 128)   # head dims csrc/flash_attn_bwd.cu is instantiated for
# a planted fault of the backward kernels (tools/fault_margin.py --train; 1:
# dq stops one KV tile short, 2: dk/dv skips the first query block of its
# walk); leave it 0
FAULT = 0


def query_chunk(S: int, rep: int, block_r: int) -> int:
    """The JAX forward's query chunk: the largest divisor Sc of S with
    Sc*rep <= block_r, or S itself where that would take more than 32
    chunks. The port's forward is one call over the whole query and does
    not chunk; this gives the chunking the JAX forward would use."""
    for sc in range(min(S, max(block_r // max(rep, 1), 1)), 0, -1):
        if S % sc == 0:
            return S if S // sc > 32 else sc
    return 1


def _recompute(qx, kx, vx, dox, lse, dvec, valid_len: int, q_off: int, scale: float,
               rep: int):
    """The backward's recomputed operands in f32: q, k, do, and P and dS
    rounded to the input dtype, as the kernels round them."""
    R, T = qx.shape[1], kx.shape[1]
    q, k, v, do = qx.float(), kx.float(), vx.float(), dox.float()
    s = torch.bmm(q, k.transpose(1, 2)) * scale                     # [X, R, T]
    row = torch.arange(R, device=qx.device)[:, None] // rep
    col = torch.arange(T, device=qx.device)[None, :]
    mask = (col <= row + q_off) & (col < min(valid_len, T))
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    ds = p * (torch.bmm(do, v.transpose(1, 2)) - dvec[..., None])
    return q, k, do, p.to(qx.dtype).float(), ds.to(qx.dtype).float()


def flash_attention_bwd_dq_ref(qx, kx, vx, dox, lse, dvec, valid_len: int, q_off: int, *,
                               scale: float, rep: int):
    """Plain version of the dq kernel: dq = scale * dS K."""
    _, k, _, _, ds = _recompute(qx, kx, vx, dox, lse, dvec, valid_len, q_off, scale, rep)
    return (torch.bmm(ds, k) * scale).to(qx.dtype)


def flash_attention_bwd_dkdv_ref(qx, kx, vx, dox, lse, dvec, valid_len: int, q_off: int, *,
                                 scale: float, rep: int):
    """Plain version of the dk/dv kernel: dk = scale * dS^T Q, dv = P^T dO."""
    q, _, do, p, ds = _recompute(qx, kx, vx, dox, lse, dvec, valid_len, q_off, scale, rep)
    return ((torch.bmm(ds.transpose(1, 2), q) * scale).to(qx.dtype),
            torch.bmm(p.transpose(1, 2), do).to(qx.dtype))


def flash_attention_bwd_ref(qx, kx, vx, dox, lse, dvec, valid_len: int, q_off: int, *,
                            scale: float, rep: int):
    """Plain version of the backward kernels: (dq, dk, dv) in the folded
    layout by the explicit recompute formula, with the kernels' roundings
    (P and dS rounded to the input dtype before their products, f32
    sums, one rounding of each output)."""
    args = (qx, kx, vx, dox, lse, dvec, valid_len, q_off)
    return (flash_attention_bwd_dq_ref(*args, scale=scale, rep=rep),
            *flash_attention_bwd_dkdv_ref(*args, scale=scale, rep=rep))


def _validate_bwd(qx, kx, vx, dox, lse, dvec, rep: int) -> None:
    X, R, d = qx.shape
    if (kx.shape != vx.shape or kx.dim() != 3 or kx.shape[0] != X or kx.shape[2] != d
            or dox.shape != qx.shape or lse.shape != (X, R) or dvec.shape != (X, R)):
        raise ValueError(f"flash_attention_bwd: shapes q {tuple(qx.shape)}, k "
                         f"{tuple(kx.shape)}, v {tuple(vx.shape)}, do {tuple(dox.shape)}, "
                         f"lse {tuple(lse.shape)}, D {tuple(dvec.shape)} do not match")
    if R % rep:
        raise ValueError(f"flash_attention_bwd: R={R} rows is not a multiple of rep={rep}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head_dim {d} not in {_HEAD_DIMS}")
    if qx.dtype not in (torch.bfloat16, torch.float32) or any(
            t.dtype != qx.dtype for t in (kx, vx, dox)):
        raise ValueError("flash_attention_bwd: q, k, v, do must share one dtype, bf16 or "
                         "f32")
    if lse.dtype != torch.float32 or dvec.dtype != torch.float32:
        raise ValueError("flash_attention_bwd: lse and D must be f32")
    tensors = (qx, kx, vx, dox, lse, dvec)
    if any(t.device != qx.device for t in tensors):
        raise ValueError("flash_attention_bwd: all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors) or any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("flash_attention_bwd: all tensors must be contiguous and 16-byte "
                         "aligned")


def _launch_args(qx, kx, vx, dox, lse, dvec, valid_len: int, q_off: int, scale: float,
                 rep: int):
    """The arguments both backward launchers share, after validation."""
    _validate_bwd(qx, kx, vx, dox, lse, dvec, rep)
    X, R, d = qx.shape
    return ((_build.DTYPE_CODES[qx.dtype], qx.data_ptr(), kx.data_ptr(), vx.data_ptr(),
             dox.data_ptr(), lse.data_ptr(), dvec.data_ptr()),
            (X, R, kx.shape[1], d, rep, valid_len, q_off, float(scale), FAULT,
             _build.stream_ptr(qx.device)))


def flash_attention_bwd_dq(qx, kx, vx, dox, lse, dvec, valid_len: int, q_off: int, *,
                           scale: float, rep: int):
    """dq [X, R, d] of the flash backward (the dq kernel; its plain version
    on the CPU)."""
    if qx.device.type == "cpu":
        return flash_attention_bwd_dq_ref(qx, kx, vx, dox, lse, dvec, valid_len, q_off,
                                          scale=scale, rep=rep)
    head, tail = _launch_args(qx, kx, vx, dox, lse, dvec, valid_len, q_off, scale, rep)
    dq = torch.empty_like(qx)
    _build.ext().flash_attn_bwd_dq(*head, dq.data_ptr(), *tail)
    _build.count("flash_attn_bwd_dq")
    return dq


def flash_attention_bwd_dkdv(qx, kx, vx, dox, lse, dvec, valid_len: int, q_off: int, *,
                             scale: float, rep: int):
    """(dk, dv) [X, T, d] of the flash backward (the dk/dv kernel; its
    plain version on the CPU)."""
    if qx.device.type == "cpu":
        return flash_attention_bwd_dkdv_ref(qx, kx, vx, dox, lse, dvec, valid_len, q_off,
                                            scale=scale, rep=rep)
    head, tail = _launch_args(qx, kx, vx, dox, lse, dvec, valid_len, q_off, scale, rep)
    dk = torch.empty_like(kx)
    dv = torch.empty_like(vx)
    _build.ext().flash_attn_bwd_dkdv(*head, dk.data_ptr(), dv.data_ptr(), *tail)
    _build.count("flash_attn_bwd_dkdv")
    return dk, dv


def flash_attention_bwd(qx, kx, vx, dox, lse, dvec, valid_len: int, q_off: int, *,
                        scale: float, rep: int):
    """The flash backward in the folded layout: qx, dox [X, R, d]; kx, vx
    [X, T, d]; lse, dvec [X, R] f32. Row r attends keys <= q_off + r //
    rep below min(valid_len, T). Returns (dq [X, R, d], dk [X, T, d], dv
    [X, T, d]) in q's dtype: the dq kernel and the dk/dv kernel on the
    card, their plain versions on the CPU."""
    args = (qx, kx, vx, dox, lse, dvec, valid_len, q_off)
    return (flash_attention_bwd_dq(*args, scale=scale, rep=rep),
            *flash_attention_bwd_dkdv(*args, scale=scale, rep=rep))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        B, S, Hq, d = q.shape
        _, Hkv, T, _ = k.shape
        X = B * Hkv
        # the backward kernels take contiguous folded operands; k and v
        # arrive as head-major views of the projection's rows
        kx = k.reshape(X, T, d).contiguous()
        vx = v.reshape(X, T, d).contiguous()
        acc, m, l = _partial(q, kx.view(B, Hkv, T, d), vx.view(B, Hkv, T, d), T, T - S,
                             scale)
        l_safe = l.clamp_min(1e-30)
        of32 = acc / l_safe[..., None]
        lse = m + torch.log(l_safe)
        rep = Hq // Hkv
        ctx.save_for_backward(_fold_q(q, Hkv).contiguous(), kx, vx, of32, lse)
        ctx.scale = scale
        ctx.shape = (B, S, Hkv, rep, d)
        return _unfold_q(of32.to(q.dtype), B, S, Hkv)

    @staticmethod
    def backward(ctx, do):
        qx, kx, vx, of32, lse = ctx.saved_tensors
        B, S, Hkv, rep, d = ctx.shape
        T = kx.shape[1]
        dox = _fold_q(do, Hkv).contiguous()
        dvec = (dox.float() * of32).sum(-1)
        dq, dk, dv = flash_attention_bwd(qx, kx, vx, dox, lse, dvec, T, T - S,
                                         scale=ctx.scale, rep=rep)
        return (_unfold_q(dq, B, S, Hkv), dk.view(B, Hkv, T, d),
                dv.view(B, Hkv, T, d), None)


def flash_attention(q, k, v, *, scale: Optional[float] = None):
    """Causal GQA flash attention, differentiable (torch.autograd).

    q: [B, S, Hq, d]; k, v: [B, Hkv, T, d] with T >= S, bf16 or f32,
    suffix-aligned causal (query s attends keys <= T - S + s). Returns
    [B, S, Hq, d] in q's dtype. On the card the forward is one
    flash_decode_partial launch and the backward the dq and dk/dv
    kernels; on the CPU their plain versions."""
    if k.shape[2] < q.shape[1]:
        raise ValueError(f"flash_attention: T={k.shape[2]} keys < S={q.shape[1]} queries")
    d = q.shape[-1]
    return _FlashAttention.apply(q, k, v, float(d ** -0.5 if scale is None else scale))


def flash_attention_ref(q, k, v, *, scale: Optional[float] = None):
    """Differentiable plain oracle with the same contract: masked f32
    softmax, autograd through plain tensor ops."""
    B, S, Hq, d = q.shape
    _, Hkv, T, _ = k.shape
    rep = Hq // Hkv
    if scale is None:
        scale = d ** -0.5
    qg = q.reshape(B, S, Hkv, rep, d).float()
    logits = torch.einsum("bsgrd,bgtd->bgsrt", qg, k.float()) * scale
    si = torch.arange(S, device=q.device)[:, None]
    ti = torch.arange(T, device=q.device)[None, :]
    mask = ti <= si + (T - S)
    logits = logits.masked_fill(~mask[None, None, :, None, :], float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgsrt,bgtd->bsgrd", p, v.float())
    return out.reshape(B, S, Hq, d).to(q.dtype)
