"""Cached GQA attention and the in-place KV-cache row insert.

Counterpart of triton_dist_tpu/kernels/flash_attn.py (`flash_decode`,
`kv_update`, `attention_cached_ref`), same layouts:
    q [B, S, Hq, d]; cache k, v [B, Hkv, T, d] (T = static capacity);
    int8 caches carry per-position f32 scales [B, Hkv, T].
`kv_len` counts the valid cache positions INCLUDING the S query
positions: query s sits at kv_len - S + s and attends causally; the
continuous-batching tick passes per-row lengths `kv_lens` [B] instead,
and the speculative-verify and chunked-prefill windows add per-row
query windows `q_lens` [B] (row b's first q_lens[b] positions end at
kv_lens[b] - 1, causal within the window; the rest is padding).

`flash_decode_partial` (with `lse_combine`) is the split-KV partial
form: unnormalised f32 accumulators and the (m, l) softmax statistics,
the training forward's building block (kernels/flash_attn_train.py).

`flash_decode`, `flash_decode_partial` and `kv_update` launch the
hand-written CUDA kernels (csrc/flash_decode.cu, csrc/kv_update.cu) for
CUDA tensors and take the plain PyTorch versions (`flash_decode_ref`,
`flash_decode_partial_ref`, `kv_update_ref`) only for CPU tensors. The
cache is updated in place where the JAX package aliased (donated) the
buffer.
"""

from __future__ import annotations

from typing import Optional

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels.quant import dequantize_kv_int8

_HEAD_DIMS = (64, 128)   # head dims csrc/flash_decode.cu is instantiated for


def flash_decode_ref(q, k, v, kv_len=None, *, scale: Optional[float] = None,
                     k_scale=None, v_scale=None, kv_lens=None, q_lens=None):
    """Plain version of flash_decode: masked f32 softmax over the whole
    static T (the math of the JAX `attention_cached_ref`); an int8 cache
    is dequantized with its per-position scales first. kv_lens [B]
    gives each batch row its own length in place of kv_len; q_lens [B]
    (with kv_lens) makes row b's first q_lens[b] positions a window
    ending at kv_lens[b] - 1, causal within it, the padding positions
    repeating the last valid one. A position that sees no key (q_lens[b]
    == kv_lens[b] == 0) gives zeros where the JAX oracle gives NaN, as
    the kernel does. Returns q's dtype."""
    B, S, Hq, d = q.shape
    _, Hkv, T, _ = k.shape
    rep = Hq // Hkv
    if scale is None:
        scale = d ** -0.5
    if k_scale is not None:
        kf, vf = dequantize_kv_int8(k, k_scale), dequantize_kv_int8(v, v_scale)
    else:
        kf, vf = k.float(), v.float()
    qg = q.reshape(B, S, Hkv, rep, d).float()
    logits = torch.einsum("bsgrd,bgtd->bgsrt", qg, kf) * scale
    si = torch.arange(S, device=q.device)[:, None]
    ti = torch.arange(T, device=q.device)[None, :]
    if kv_lens is None:
        mask = (ti <= si + (kv_len - S))[None]                 # [1, S, T]
    elif q_lens is None:
        lens = kv_lens.to(q.device, torch.long)[:, None, None]
        mask = ti[None] <= si[None] + (lens - S)                # [B, S, T]
    else:
        lens = kv_lens.to(q.device, torch.long)[:, None, None]
        ql = q_lens.to(q.device, torch.long)[:, None, None]
        mask = ti[None] <= lens - ql + torch.minimum(si[None], ql - 1)
    logits = logits.masked_fill(~mask[:, None, :, None, :], float("-inf"))
    p = torch.softmax(logits, dim=-1)
    if q_lens is not None:
        p = p.nan_to_num(0.0)             # a position with no key
    out = torch.einsum("bgsrt,bgtd->bsgrd", p, vf)
    return out.reshape(B, S, Hq, d).to(q.dtype)


def _check_kv_len(kv_len: int, S: int, T: int) -> None:
    if not S <= kv_len <= T:
        raise ValueError(f"flash_decode: kv_len={kv_len} outside [S={S}, T={T}]")


def flash_decode(q, k, v, kv_len: Optional[int] = None, *,
                 scale: Optional[float] = None, k_scale=None, v_scale=None,
                 kv_lens=None, q_lens=None):
    """Cached GQA attention (decode and prefill-into-cache).

    q: [B, S, Hq, d] (last dim contiguous); k, v: [B, Hkv, T, d] of q's
    dtype, or int8 with k_scale/v_scale [B, Hkv, T] f32 (then q is bf16).
    kv_len: valid positions including the S new ones. kv_lens: per-row
    lengths [B] int32 on q's device in place of kv_len (S == 1, the
    continuous-batching tick): row b attends exactly kv_lens[b]
    positions. q_lens: per-row query windows [B] int32 on q's device
    (with kv_lens, any S: the verify and chunked-prefill windows): row
    b's first q_lens[b] positions sit at kv_lens[b] - q_lens[b] ..
    kv_lens[b] - 1 and attend causally within the window; the outputs
    of its padding positions repeat the last valid one, and a row with
    q_lens[b] == 0 attends kv_lens[b] - 1 positions (its output is
    discarded by the caller, and finite). The per-row values stay on
    the device (the kernel reads them), so they are not range-checked
    here. Returns [B, S, Hq, d] in q's dtype."""
    B, S, Hq, d = q.shape
    _, Hkv, T, _ = k.shape
    if kv_lens is None:
        if q_lens is not None:
            raise ValueError("flash_decode: q_lens rides on per-row kv_lens")
        _check_kv_len(kv_len, S, T)
    elif (kv_lens.shape != (B,) or kv_lens.dtype != torch.int32
          or (S != 1 and q_lens is None)):
        raise ValueError(f"flash_decode: kv_lens must be int32 [B={B}], with S == 1 "
                         f"unless q_lens is given (got {tuple(kv_lens.shape)} "
                         f"{kv_lens.dtype}, S={S})")
    _check_windows(q_lens, kv_lens, B, "flash_decode")
    if q.device.type == "cpu":
        return flash_decode_ref(q, k, v, kv_len, scale=scale, k_scale=k_scale,
                                v_scale=v_scale, kv_lens=kv_lens, q_lens=q_lens)
    if scale is None:
        scale = d ** -0.5
    quant = k_scale is not None
    _validate_flash(q, k, v, k_scale, v_scale, quant)
    if kv_lens is not None and (kv_lens.device != q.device
                                or not kv_lens.is_contiguous()):
        raise ValueError("flash_decode: kv_lens must be contiguous on q's device")
    out = torch.empty((B, S, Hq, d), dtype=q.dtype, device=q.device)
    ks_ptr = k_scale.data_ptr() if quant else 0
    vs_ptr = v_scale.data_ptr() if quant else 0
    sc_strides = (k_scale.stride(0), k_scale.stride(1)) if quant else (0, 0)
    with torch.cuda.device(q.device):
        _build.ext().flash_decode(
            _build.DTYPE_CODES[q.dtype], _build.DTYPE_CODES[k.dtype],
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ks_ptr, vs_ptr,
            0 if kv_lens is None else kv_lens.data_ptr(),
            0 if q_lens is None else q_lens.data_ptr(), out.data_ptr(),
            0 if kv_len is None else kv_len, B, S, Hq, Hkv, T, d,
            float(scale), q.stride(0), q.stride(1), q.stride(2), k.stride(0),
            k.stride(1), k.stride(2), *sc_strides, _build.stream_ptr(q.device))
    _build.count("flash_decode")
    return out


def _check_windows(q_lens, kv_lens, B: int, who: str) -> None:
    """q_lens: None, or int32 [B], contiguous on kv_lens' device."""
    if q_lens is None:
        return
    if (q_lens.shape != (B,) or q_lens.dtype != torch.int32
            or q_lens.device != kv_lens.device or not q_lens.is_contiguous()):
        raise ValueError(f"{who}: q_lens must be contiguous int32 [B={B}] on kv_lens' "
                         f"device (got {tuple(q_lens.shape)} {q_lens.dtype} on "
                         f"{q_lens.device})")


def _validate_flash(q, k, v, k_scale, v_scale, quant: bool) -> None:
    B, S, Hq, d = q.shape
    tensors = [q, k, v] + ([k_scale, v_scale] if quant else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_decode: all tensors must be on one device")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != d:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} does not match "
                         f"k {tuple(k.shape)} / v {tuple(v.shape)}")
    Hkv = k.shape[1]
    if Hq % Hkv:
        raise ValueError(f"flash_decode: Hq={Hq} is not a multiple of Hkv={Hkv}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_decode: head_dim {d} not in {_HEAD_DIMS}")
    if quant:
        if q.dtype != torch.bfloat16 or k.dtype != torch.int8 or v.dtype != torch.int8:
            raise ValueError("flash_decode: an int8 cache takes a bf16 query")
        if v_scale is None or k_scale.shape != k.shape[:3] or v_scale.shape != k.shape[:3]:
            raise ValueError("flash_decode: k_scale/v_scale must be [B, Hkv, T]")
        if (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
                or k_scale.stride() != v_scale.stride() or k_scale.stride(2) != 1):
            raise ValueError("flash_decode: scales must be f32 with equal "
                             "strides and contiguous positions")
    else:
        if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
                or v.dtype != q.dtype:
            raise ValueError(f"flash_decode: q {q.dtype}, k {k.dtype}, v {v.dtype}: "
                             "want bf16 or f32 throughout")
    if q.stride(3) != 1 or k.stride(3) != 1 or k.stride() != v.stride():
        raise ValueError("flash_decode: head_dim must be contiguous and k, v "
                         "must share strides")
    size = k.element_size()
    if (any(s * size % 16 for s in k.stride()[:3])
            or k.data_ptr() % 16 or v.data_ptr() % 16):
        raise ValueError("flash_decode: every K/V row must be 16-byte aligned")


def _fold_q(a, Hkv: int):
    """[B, S, Hq, ...] -> [B*Hkv, S*rep, ...], grouped by kv head (the
    folded GQA layout of the flash kernels)."""
    B, S, Hq = a.shape[:3]
    rep = Hq // Hkv
    tail = a.shape[3:]
    return (a.reshape(B, S, Hkv, rep, *tail).transpose(1, 2)
            .reshape(B * Hkv, S * rep, *tail))


def _unfold_q(a, B: int, S: int, Hkv: int):
    """[B*Hkv, S*rep, ...] -> [B, S, Hq, ...]: the inverse of _fold_q."""
    rep = a.shape[1] // S
    tail = a.shape[2:]
    return (a.reshape(B, Hkv, S, rep, *tail).transpose(1, 2)
            .reshape(B, S, Hkv * rep, *tail))


def _partial_ref(q, k, v, kv_len: int, q_offset: int, scale: float):
    """Plain version of the partial kernel in the folded layout: query s
    attends keys t <= q_offset + s with t < min(kv_len, T). Returns acc
    [B*Hkv, S*rep, d] (unnormalised) and m, l [B*Hkv, S*rep], all f32;
    a row with no key keeps m = -1e30, l = 0, acc = 0, as the kernel."""
    B, S, Hq, d = q.shape
    _, Hkv, T, _ = k.shape
    rep = Hq // Hkv
    X = B * Hkv
    qx = _fold_q(q, Hkv).float()
    kx = k.reshape(X, T, d).float()
    vx = v.reshape(X, T, d).float()
    s = torch.bmm(qx, kx.transpose(1, 2)) * scale                 # [X, R, T]
    row = torch.arange(S * rep, device=q.device)[:, None] // rep
    col = torch.arange(T, device=q.device)[None, :]
    mask = (col <= row + q_offset) & (col < min(kv_len, T))
    m = torch.where(mask, s, torch.full_like(s, -1e30)).amax(-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    return torch.bmm(p, vx), m, p.sum(-1)


def _partial(q, k, v, kv_len: int, q_offset: int, scale: float):
    """flash_decode_partial in the folded layout: (acc, m, l) as
    _partial_ref, from the kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return _partial_ref(q, k, v, kv_len, q_offset, scale)
    _validate_flash(q, k, v, None, None, False)
    B, S, Hq, d = q.shape
    _, Hkv, T, _ = k.shape
    X, R = B * Hkv, S * (Hq // Hkv)
    acc = torch.empty((X, R, d), dtype=torch.float32, device=q.device)
    m = torch.empty((X, R), dtype=torch.float32, device=q.device)
    l = torch.empty((X, R), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _build.ext().flash_decode_partial(
            _build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            acc.data_ptr(), m.data_ptr(), l.data_ptr(), kv_len, q_offset, B, S, Hq, Hkv, T, d,
            float(scale), q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1),
            k.stride(2), _build.stream_ptr(q.device))
    _build.count("flash_decode_partial")
    return acc, m, l


def flash_decode_partial_ref(q, k, v, kv_len: int, q_offset: int, *,
                             scale: Optional[float] = None):
    """Plain version of flash_decode_partial (same contract): masked f32
    products, unnormalised."""
    B, S, _, d = q.shape
    Hkv = k.shape[1]
    acc, m, l = _partial_ref(q, k, v, kv_len, q_offset, d ** -0.5 if scale is None else scale)
    return _unfold_q(acc, B, S, Hkv), _unfold_q(m, B, S, Hkv), _unfold_q(l, B, S, Hkv)


def flash_decode_partial(q, k, v, kv_len: int, q_offset: int, *,
                         scale: Optional[float] = None):
    """Split-KV partial attention: the unnormalised f32 accumulator and
    the softmax statistics of each query against one KV buffer, for an
    LSE combine (`lse_combine`) across buffers or the training forward.

    q: [B, S, Hq, d] (last dim contiguous); k, v: [B, Hkv, T, d] of q's
    dtype, bf16 or f32. kv_len: valid keys in the buffer (may be 0);
    q_offset: position of query 0 relative to key 0 (query s attends keys
    <= q_offset + s; may be negative or past T). Returns (acc [B, S, Hq,
    d], m [B, S, Hq], l [B, S, Hq]), all f32."""
    B, S, _, d = q.shape
    Hkv = k.shape[1]
    acc, m, l = _partial(q, k, v, kv_len, q_offset, d ** -0.5 if scale is None else scale)
    return _unfold_q(acc, B, S, Hkv), _unfold_q(m, B, S, Hkv), _unfold_q(l, B, S, Hkv)


def lse_combine(accs, ms, ls, dtype=None):
    """Merge split-KV partials: accs [n, ..., d] f32 unnormalised, ms/ls
    [n, ...]. Returns the normalised [..., d] (in dtype when given)."""
    m_star = ms.amax(0)
    w = torch.exp(ms - m_star[None])
    acc = (accs * w[..., None]).sum(0)
    out = acc / (ls * w).sum(0).clamp_min(1e-30)[..., None]
    return out if dtype is None else out.to(dtype)


def kv_update_ref(cache: torch.Tensor, new: torch.Tensor, pos: int) -> torch.Tensor:
    """Plain version of kv_update: cache[:, :, pos:pos+S] = new, in place."""
    cache[:, :, pos:pos + new.shape[2]] = new
    return cache


def kv_update(cache: torch.Tensor, new: torch.Tensor, pos: int) -> torch.Tensor:
    """In-place insert of new rows [B, H, S, d] into cache [B, H, T, d]
    at row `pos` (any row: the 8-row alignment of the TPU kernel was a
    Mosaic constraint). Returns the cache, updated in place."""
    B, H, S, d = new.shape
    T = cache.shape[2]
    if cache.shape != (B, H, T, d) or cache.dtype != new.dtype:
        raise ValueError(f"kv_update: new {tuple(new.shape)} {new.dtype} does not "
                         f"fit cache {tuple(cache.shape)} {cache.dtype}")
    if not 0 <= pos <= T - S:
        raise ValueError(f"kv_update: rows [{pos}, {pos + S}) outside the "
                         f"cache's {T}")
    if cache.device != new.device:
        raise ValueError("kv_update: cache and new must be on one device")
    if cache.device.type == "cpu":
        return kv_update_ref(cache, new, pos)
    size = new.element_size()
    row_bytes = d * size
    if (not cache.is_contiguous() or new.stride(3) != 1 or row_bytes % 16
            or any(s * size % 16 for s in new.stride()[:3])
            or cache.data_ptr() % 16 or new.data_ptr() % 16):
        raise ValueError("kv_update: the cache must be contiguous and every row "
                         "16-byte aligned")
    with torch.cuda.device(cache.device):
        _build.ext().kv_update(cache.data_ptr(), new.data_ptr(), pos, B, H, T, S,
                               row_bytes, new.stride(0) * size, new.stride(1) * size,
                               new.stride(2) * size, _build.stream_ptr(cache.device))
    _build.count("kv_update")
    return cache
