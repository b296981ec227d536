"""Sequence-parallel flash decode: counterpart of
triton_dist_tpu/kernels/sp_flash_decode.py (`sp_combine_partials`,
`kv_cache_scatter`, `sp_flash_decode`, `sp_flash_decode_ref`).

The KV cache is sharded on the sequence over a mesh of n ranks
(runtime/bootstrap.py): rank r holds the contiguous window [r * t_loc,
(r + 1) * t_loc) of every (batch, kv-head) stream, as one tensor [B, Hkv,
t_loc, d] in a list of n. Each rank computes the split-KV partial (acc, m,
l) of its window (flash_attn.flash_decode_partial, or the paged partial
of the serving path) and the partials merge with the log-sum-exp combine,
replicated:

- combine="xla": the gather of every rank's partial and
  flash_attn.lse_combine as torch ops (the JAX package's all_gather
  mode; it is that mode, not a fallback of the other);
- combine="dist": the one-shot kernel csrc/lse_combine.cu (row 24,
  counted as `lse_combine`): every rank pushes its partial into its slot
  of every peer's landing buffer and merges the n landed partials;
  `lse_combine_dist_ref` is its plain version, taken only for CPU
  tensors.

`kv_cache_scatter` fills the sharded cache from sequence-sharded new K
or V: csrc/kv_scatter.cu (row 25, counted as `kv_scatter`) on the card,
`kv_cache_scatter_ref` on the CPU; the cache is updated in place where
the JAX kernel aliased it.
"""

from __future__ import annotations

from typing import Optional

import torch

from triton_dist_tpu_torch.kernels import _comm
from triton_dist_tpu_torch.kernels.flash_attn import (flash_decode_partial, flash_decode_ref,
                                                      lse_combine)
from triton_dist_tpu_torch.runtime.symm_mem import symm_workspace

COMBINES = ("xla", "dist")


def _per_device(parts, fn) -> list:
    """fn(device) once per distinct device of parts, shared by the ranks
    that live on it."""
    done = {}
    return [done[p.device] if p.device in done else done.setdefault(p.device, fn(p.device))
            for p in parts]


def lse_combine_dist_ref(accs, sts) -> list:
    """Plain version of the combine kernel: accs, one [R, d] f32 per rank,
    sts one [2, R] f32 (m, l) per rank. Every rank's output [R, d] f32,
    in the kernel's order: m* the max of the n m, the first slot's
    acc * exp(m - m*), the others added in rank order, times 1 / max(l*,
    1e-30)."""
    def merge(dev):
        A = [a.to(dev).float() for a in accs]
        M = [s[0].to(dev).float() for s in sts]
        L = [s[1].to(dev).float() for s in sts]
        m_star = torch.stack(M).amax(0)
        sc = [torch.exp(m - m_star) for m in M]
        l_star = L[0] * sc[0]
        acc = A[0] * sc[0][:, None]
        for p in range(1, len(A)):
            l_star = l_star + L[p] * sc[p]
            acc = acc + A[p] * sc[p][:, None]
        return acc * (1.0 / l_star.clamp_min(1e-30))[:, None]
    return _per_device(accs, merge)


def sp_combine_partials(acc, m, l, *, mesh, combine: str = "xla", out_dtype=None) -> list:
    """Cross-rank LSE merge of split-KV partials. acc: per rank [B, S, Hq,
    d] f32 unnormalised; m, l: per rank [B, S, Hq] (a row that owns no key
    is (0, -1e30, 0)). Returns every rank's normalised [B, S, Hq, d] (in
    out_dtype, default acc's), one tensor per distinct device."""
    if combine not in COMBINES:
        raise ValueError(f"sp_combine_partials: combine {combine!r}, want one of {COMBINES}")
    n = mesh.size
    if len(acc) != n or len(m) != n or len(l) != n:
        raise ValueError(f"sp_combine_partials: {len(acc)} partials for a mesh of {n} ranks")
    B, S, Hq, d = acc[0].shape
    out_dtype = out_dtype or acc[0].dtype
    if combine == "xla":
        return _per_device(acc, lambda dev: lse_combine(
            torch.stack([a.to(dev) for a in acc]), torch.stack([x.to(dev) for x in m]),
            torch.stack([x.to(dev) for x in l]), dtype=out_dtype))
    R = B * S * Hq
    accs = [a.reshape(R, d).float().contiguous() for a in acc]
    sts = [torch.stack([mr.reshape(R), lr.reshape(R)]).float().contiguous()
           for mr, lr in zip(m, l)]
    _comm.check_parts(accs, mesh, "sp_combine_partials acc")
    if accs[0].device.type == "cpu":
        outs = lse_combine_dist_ref(accs, sts)
    else:
        outs = _lse_combine_launch(accs, sts, mesh, R, d)
    return [o.reshape(B, S, Hq, d).to(out_dtype) for o in outs]


def _lse_combine_launch(accs, sts, mesh, R: int, d: int) -> list:
    n = mesh.size
    if d % 4:
        raise ValueError(f"sp_combine_partials: head dim {d} is not a multiple of 4 (the "
                         "kernel moves 16-byte vectors)")
    _comm.nvec16(accs[0], "sp_combine_partials")
    land = symm_workspace("sp_lse_land", n * R, (d,), torch.float32, mesh=mesh)
    land_st = symm_workspace("sp_lse_stats", n * 2 * R, (), torch.float32, mesh=mesh)
    outs = _comm.empty_like_parts(accs, (R, d))
    G = _comm.ctas(mesh, -(-R * d // 4 // 512))

    def call(lib, first, n_local, epoch, sig, st):
        lib.lse_combine([a.data_ptr() for a in accs], [s.data_ptr() for s in sts],
                        [o.data_ptr() for o in outs], land.ptrs, land_st.ptrs, sig, first,
                        n_local, epoch, R, d, G, st)

    _comm.launch("lse_combine", mesh, call)
    return outs


def kv_cache_scatter_ref(cache, kv_new) -> list:
    """Plain version of the scatter: rank p's block lands in its owner's
    window at (p * s_loc) % t_loc, in place."""
    s_loc, t_loc = kv_new[0].shape[2], cache[0].shape[2]
    for p, blk in enumerate(kv_new):
        owner, off = divmod(p * s_loc, t_loc)
        cache[owner][:, :, off:off + s_loc] = blk.to(cache[owner].device, cache[owner].dtype)
    return cache


def kv_cache_scatter(cache, kv_new, *, mesh) -> list:
    """Fill a sequence-sharded KV cache from sequence-sharded new K or V,
    in place. cache: per rank its window [B, Hkv, t_loc, d]; kv_new: per
    rank its block [B, Hkv, s_loc, d] of global positions [r * s_loc, (r +
    1) * s_loc), cast to the cache's dtype; t_loc % s_loc == 0. Positions
    [0, n * s_loc) are overwritten, the rest keep their contents. Returns
    the cache list."""
    n = mesh.size
    _comm.check_parts(cache, mesh, "kv_cache_scatter cache", ndim=4)
    _comm.check_parts(kv_new, mesh, "kv_cache_scatter kv_new", ndim=4)
    B, Hkv, t_loc, d = cache[0].shape
    s_loc = kv_new[0].shape[2]
    if tuple(kv_new[0].shape) != (B, Hkv, s_loc, d) or s_loc < 1 or t_loc % s_loc:
        raise ValueError(f"kv_cache_scatter: blocks {tuple(kv_new[0].shape)} into windows "
                         f"{tuple(cache[0].shape)}: want t_loc a multiple of s_loc")
    if cache[0].device.type == "cpu":
        return kv_cache_scatter_ref(cache, kv_new)
    src = [k.to(cache[0].dtype).contiguous() for k in kv_new]
    row_bytes = d * cache[0].element_size()
    if row_bytes % 16 or any(t.data_ptr() % 16 for t in src + list(cache)):
        raise ValueError("kv_cache_scatter: every row must be a whole number of 16-byte "
                         "vectors at a 16-byte aligned address")
    G = _comm.ctas(mesh, -(-B * Hkv * s_loc * row_bytes // 16 // 512))

    def call(lib, first, n_local, epoch, sig, st):
        lib.kv_scatter([s.data_ptr() for s in src], [c.data_ptr() for c in cache], sig, first,
                       n_local, epoch, B * Hkv, s_loc, t_loc, row_bytes // 16, G, st)

    _comm.launch("kv_scatter", mesh, call)
    return cache


def sp_flash_decode(q, k, v, kv_len, *, mesh, scale: Optional[float] = None,
                    combine: str = "dist", out_dtype=None) -> list:
    """Cached GQA attention with the KV cache sequence-sharded over the
    mesh. q: per rank [B, S, Hq, d] (replicated); k, v: per rank its
    window [B, Hkv, t_loc, d] of global positions [r * t_loc, (r + 1) *
    t_loc). kv_len: the count of valid positions including the S query
    positions, an int or per-slot lengths [B] (ints or a tensor; then
    each batch row runs its own partial). Returns every rank's [B, S, Hq,
    d] (out_dtype, default q's)."""
    n = mesh.size
    B, S, Hq, d = q[0].shape
    t_loc = k[0].shape[2]
    out_dtype = out_dtype or q[0].dtype
    lens = kv_len.tolist() if isinstance(kv_len, torch.Tensor) else kv_len
    per_row = not isinstance(lens, int)
    accs, ms, ls = [], [], []
    for me in range(n):
        if per_row:
            parts = [_partial(q[me][b:b + 1], k[me][b:b + 1], v[me][b:b + 1], int(L), S, me,
                              t_loc, scale) for b, L in enumerate(lens)]
            a, m_, l_ = (torch.cat(t) for t in zip(*parts))
        else:
            a, m_, l_ = _partial(q[me], k[me], v[me], lens, S, me, t_loc, scale)
        accs.append(a)
        ms.append(m_)
        ls.append(l_)
    return sp_combine_partials(accs, ms, ls, mesh=mesh, combine=combine, out_dtype=out_dtype)


def _partial(q, k, v, L: int, S: int, me: int, t_loc: int, scale):
    """Rank me's partial over its window: the keys of [me * t_loc, L) in
    it, query 0 at global position L - S."""
    local = min(max(L - me * t_loc, 0), t_loc)
    return flash_decode_partial(q, k, v, local, (L - S) - me * t_loc, scale=scale)


def sp_flash_decode_ref(q, k, v, kv_len, *, scale: Optional[float] = None, q_lens=None):
    """Full-KV plain oracle on the unsharded cache ([B, Hkv, T, d]): the
    math of flash_attn.flash_decode_ref, kv_len an int or per-slot
    lengths [B], q_lens [B] the verify windows (with per-slot kv_len)."""
    if isinstance(kv_len, int):
        return flash_decode_ref(q, k, v, kv_len, scale=scale)
    return flash_decode_ref(q, k, v, scale=scale, kv_lens=torch.as_tensor(kv_len),
                            q_lens=None if q_lens is None else torch.as_tensor(q_lens))
