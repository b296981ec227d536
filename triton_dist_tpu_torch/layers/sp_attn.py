"""Sequence-parallel attention layer: counterpart of
triton_dist_tpu/layers/sp_attn.py (`SPAttn`: `init`, `alloc_cache`,
`prefill`, `decode`, and its helpers `_write_token`, `_local_proj`).

SPAttn keeps its weights replicated (one copy per distinct device of the
mesh, runtime/bootstrap.py Mesh.replicate: ranks on one card share it) and
its activations and KV cache sharded on the sequence: rank r holds
positions [r * s_loc, (r + 1) * s_loc) of a prefill's x and the window
[r * t_loc, (r + 1) * t_loc) of the cache, one tensor per rank in a list.

- prefill: each rank's local QKV projection (the reduction dim is whole:
  no collective), QK-norm and RoPE at its global positions; the new K/V
  blocks go into their owners' cache windows with kv_cache_scatter (row
  25); ring attention (kernels/sp_attention.py, mode "ring", "ag" or
  "ring_shmem": row 26) over the shards; the local O projection;
- decode: the replicated one-token projection, the token's K/V written
  into its owner's window (`_write_token`), sp_flash_decode (each rank's
  partial over its window, merged by sp_combine_partials "xla" or
  "dist": row 24), the O projection.

`UlyssesAttn` (the JAX `UlyssesAttn`: `init`, `prefill` in its three
modes, and `from_jax_arrays`, the JAX layer's packed arrays as they are)
reshards between sequence and heads instead: each rank's QKV projection
of its sequence block goes all-to-all to the owners of the head groups,
each rank attends its head group over the whole sequence with one
flash_decode (row 1), and the outputs go back to the sequence owners
through the O projection:

- "fused": qkv_gemm_a2a (row 28), flash_decode, o_a2a_gemm (row 27);
- "unfused": the local QKV product, ulysses_dispatch, flash_decode,
  ulysses_combine (both over the all_to_all kernel), the local O product;
- "xla": the replicated plain oracle.

The training forms (`SPAttn.fwd_train`, the JAX `sp_ring_attention_train`,
and `UlyssesAttn.fwd_train`) are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from triton_dist_tpu_torch.kernels.flash_attn import flash_decode, flash_decode_ref
from triton_dist_tpu_torch.kernels.quant import qmm
from triton_dist_tpu_torch.kernels.sp_attention import (o_a2a_gemm, qkv_gemm_a2a,
                                                        sp_ring_attention, ulysses_combine,
                                                        ulysses_dispatch)
from triton_dist_tpu_torch.kernels.sp_flash_decode import kv_cache_scatter, sp_flash_decode
from triton_dist_tpu_torch.layers.common import apply_rope, rms_norm, shard_cols_packed


@dataclasses.dataclass
class SPAttn:
    """Sequence-parallel GQA attention with a sequence-sharded KV cache.
    w_qkv: per rank the [D, (Hq + 2*Hkv) * hd] packed [q | k | v]; w_o:
    per rank [Hq * hd, D]; the norms per rank (copies of one tensor on
    each device)."""

    w_qkv: list
    w_o: list
    q_norm: Optional[list]
    k_norm: Optional[list]
    mesh: object
    n_heads: int
    n_kv_heads: int
    head_dim: int
    axis: str = "sp"

    @staticmethod
    def init(w_q, w_k, w_v, w_o, *, mesh, axis: str = "sp", n_heads: int, n_kv_heads: int,
             head_dim: int, q_norm=None, k_norm=None) -> "SPAttn":
        """Replicate the weights over `mesh` (tensors on any device)."""
        w_qkv = torch.cat([w_q, w_k, w_v], dim=1)
        rep = mesh.replicate
        return SPAttn(w_qkv=rep(w_qkv), w_o=rep(w_o),
                      q_norm=None if q_norm is None else rep(q_norm),
                      k_norm=None if k_norm is None else rep(k_norm),
                      mesh=mesh, n_heads=n_heads, n_kv_heads=n_kv_heads,
                      head_dim=head_dim, axis=axis)

    def _split_qkv(self, qkv, B: int, S: int, r: int):
        """Rank r's packed rows [B*S, .] -> q [B, S, Hq, hd], k, v [B, S,
        Hkv, hd], QK-normed."""
        hq, hkv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        q = qkv[..., :hq * hd].reshape(B, S, hq, hd)
        k = qkv[..., hq * hd:(hq + hkv) * hd].reshape(B, S, hkv, hd)
        v = qkv[..., (hq + hkv) * hd:].reshape(B, S, hkv, hd)
        if self.q_norm is not None:
            q = rms_norm(q, self.q_norm[r])
        if self.k_norm is not None:
            k = rms_norm(k, self.k_norm[r])
        return q, k, v

    def alloc_cache(self, B: int, T: int, dtype=torch.bfloat16):
        """The sequence-sharded cache: per rank its window [B, Hkv, T/n,
        hd] of zeros, for K and for V."""
        n = self.mesh.size
        if T % n:
            raise ValueError(f"cache T={T} must divide over the {n} ranks")
        shape = (B, self.n_kv_heads, T // n, self.head_dim)

        def zeros():
            return [torch.zeros(shape, dtype=dtype, device=d) for d in self.mesh.devices]

        return zeros(), zeros()

    def prefill(self, x, cos, sin, cache_k, cache_v, *, mode: str = "ring"):
        """x: per rank its [B, s_loc, D] shard. Runs ring attention and
        writes K/V into the cache's owner windows (in place). Returns (out
        per rank [B, s_loc, D], cache_k, cache_v, kv_len = S)."""
        n = self.mesh.size
        B, s_loc, D = x[0].shape
        qs, ks, vs = [], [], []
        for r, xr in enumerate(x):
            dev = xr.device
            q, k, v = self._split_qkv(qmm(xr.reshape(B * s_loc, D), self.w_qkv[r]), B, s_loc, r)
            pos = torch.arange(r * s_loc, (r + 1) * s_loc, device=dev)
            q = apply_rope(q, cos.to(dev), sin.to(dev), pos)
            k = apply_rope(k, cos.to(dev), sin.to(dev), pos)
            qs.append(q.contiguous())
            ks.append(k.transpose(1, 2).contiguous())       # [B, Hkv, s_loc, hd]
            vs.append(v.transpose(1, 2).contiguous())
        cache_k = kv_cache_scatter(cache_k, ks, mesh=self.mesh)
        cache_v = kv_cache_scatter(cache_v, vs, mesh=self.mesh)
        out = sp_ring_attention(qs, ks, vs, mesh=self.mesh, causal=True, mode=mode,
                                out_dtype=x[0].dtype)
        out = [o.reshape(B, s_loc, self.n_heads * self.head_dim) for o in out]
        return _local_proj(out, self.w_o), cache_k, cache_v, n * s_loc

    def decode(self, x, cos, sin, cache_k, cache_v, kv_len: int, *, combine: str = "dist"):
        """One decode step. x: per rank [B, 1, D] (replicated); kv_len: the
        tokens already in the cache. Returns (out per rank [B, 1, D],
        cache_k, cache_v, kv_len + 1)."""
        B, _, D = x[0].shape
        qs = []
        for r, xr in enumerate(x):
            dev = xr.device
            q, k, v = self._split_qkv(qmm(xr.reshape(B, D), self.w_qkv[r]), B, 1, r)
            pos = torch.tensor([kv_len], device=dev)
            qs.append(apply_rope(q, cos.to(dev), sin.to(dev), pos))
            if r == 0:
                k = apply_rope(k, cos.to(dev), sin.to(dev), pos)
                _write_token(cache_k, k.transpose(1, 2), kv_len)
                _write_token(cache_v, v.transpose(1, 2), kv_len)
        out = sp_flash_decode(qs, cache_k, cache_v, kv_len + 1, mesh=self.mesh,
                              combine=combine, out_dtype=x[0].dtype)
        out = [o.reshape(B, 1, self.n_heads * self.head_dim) for o in out]
        return _local_proj(out, self.w_o), cache_k, cache_v, kv_len + 1

    def fwd_train(self, x, cos, sin):
        raise NotImplementedError("SPAttn.fwd_train (the SP training ring): not yet ported")


def _write_token(cache, kv_new, pos: int) -> None:
    """Write one token's K or V [B, Hkv, 1, hd] at global position `pos`
    into its owner's window (in place)."""
    t_loc = cache[0].shape[2]
    owner, local = divmod(pos, t_loc)
    if not 0 <= owner < len(cache):
        raise ValueError(f"position {pos} is past the cache's {t_loc * len(cache)}")
    c = cache[owner]
    c[:, :, local:local + 1] = kv_new.to(c.device, c.dtype)


def _local_proj(x, w) -> list:
    """Each rank's local product x[r] @ w[r] (a replicated weight, the
    reduction dim whole: no collective)."""
    return [qmm(xr.reshape(-1, xr.shape[-1]), wr).reshape(xr.shape[:-1] + (wr.shape[-1],))
            for xr, wr in zip(x, w)]


# the "xla" oracle's attention runs over blocks of this many query rows,
# so that its f32 scores stay a few GB at a 16384-token prefill
ORACLE_ROWS = 2048


@dataclasses.dataclass
class UlyssesAttn:
    """Ulysses sequence-parallel prefill attention. w_qkv: per rank the
    [D, n * C] packed head-group-major, C = (Hq/n + 2 Hkv/n) * hd (chunk j
    = [q group j | k group j | v group j], layers/common.py
    shard_cols_packed), so that the fused GEMM sends chunk j straight to
    rank j; w_o: per rank [Hq * hd, D]; the norms per rank. Every rank
    holds the whole weights (one copy per rank, on its device)."""

    w_qkv: list
    w_o: list
    q_norm: Optional[list]
    k_norm: Optional[list]
    mesh: object
    n_heads: int
    n_kv_heads: int
    head_dim: int

    @staticmethod
    def init(w_q, w_k, w_v, w_o, *, mesh, n_heads: int, n_kv_heads: int, head_dim: int,
             q_norm=None, k_norm=None) -> "UlyssesAttn":
        """Pack [w_q | w_k | w_v] head-group-major and replicate the
        weights over `mesh` (tensors on any device)."""
        return UlyssesAttn.from_jax_arrays(
            shard_cols_packed([w_q, w_k, w_v], mesh.size), w_o, q_norm, k_norm, mesh=mesh,
            n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim)

    @staticmethod
    def from_jax_arrays(w_qkv, w_o, q_norm=None, k_norm=None, *, mesh, n_heads: int,
                        n_kv_heads: int, head_dim: int) -> "UlyssesAttn":
        """The JAX layer's arrays as they are (numpy arrays or tensors):
        w_qkv already packed head-group-major for `mesh`'s size."""
        from triton_dist_tpu_torch.models.convert import to_torch
        n = mesh.size
        if n_heads % n or n_kv_heads % n:
            raise ValueError(f"UlyssesAttn: {n_heads} query and {n_kv_heads} kv heads do not "
                             f"split over {n} ranks")

        def rep(a):
            if a is None:
                return None
            return mesh.replicate(a if isinstance(a, torch.Tensor) else to_torch(a))

        return UlyssesAttn(w_qkv=rep(w_qkv), w_o=rep(w_o), q_norm=rep(q_norm),
                           k_norm=rep(k_norm), mesh=mesh, n_heads=n_heads,
                           n_kv_heads=n_kv_heads, head_dim=head_dim)

    def _unpack_norm_rope(self, qkv, r: int, cos, sin):
        """Rank r's [B, S, C] head-group projection -> q [B, S, Hq/n, hd],
        k, v [B, Hkv/n, S, hd], QK-normed and rotated at positions 0..S-1."""
        n = self.mesh.size
        hq, hkv, hd = self.n_heads // n, self.n_kv_heads // n, self.head_dim
        B, S, _ = qkv.shape
        dev = qkv.device
        q = qkv[..., :hq * hd].reshape(B, S, hq, hd)
        k = qkv[..., hq * hd:(hq + hkv) * hd].reshape(B, S, hkv, hd)
        v = qkv[..., (hq + hkv) * hd:].reshape(B, S, hkv, hd)
        if self.q_norm is not None:
            q = rms_norm(q, self.q_norm[r])
        if self.k_norm is not None:
            k = rms_norm(k, self.k_norm[r])
        pos = torch.arange(S, device=dev)
        q = apply_rope(q, cos.to(dev), sin.to(dev), pos)
        k = apply_rope(k, cos.to(dev), sin.to(dev), pos)
        return q.contiguous(), k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()

    def prefill(self, x, cos, sin, *, mode: str = "fused") -> list:
        """x: per rank its sequence block [B, s_loc, D]. Returns per rank
        [B, s_loc, D] (see the module docstring for the modes)."""
        if mode not in ("fused", "unfused", "xla"):
            raise ValueError(f"UlyssesAttn.prefill: mode {mode!r}, want fused, unfused or xla")
        if mode == "xla":
            return self._oracle(x, cos, sin)
        n = self.mesh.size
        B, s_loc, D = x[0].shape
        S, hd = n * s_loc, self.head_dim
        C = (self.n_heads + 2 * self.n_kv_heads) // n * hd
        if mode == "fused":
            qkv = qkv_gemm_a2a(x, self.w_qkv, mesh=self.mesh)          # [B, S, C]
        else:
            seq = _local_proj(x, self.w_qkv)                             # [B, s_loc, n C]
            qkv = [t.reshape(B, S, C) for t in ulysses_dispatch(
                [t.reshape(B, s_loc, n, C) for t in seq], mesh=self.mesh)]
        o = [flash_decode(*self._unpack_norm_rope(t, r, cos, sin), S)   # [B, S, Hq/n, hd]
             for r, t in enumerate(qkv)]
        if mode == "fused":
            return o_a2a_gemm([t.reshape(B, S, -1) for t in o], self.w_o, mesh=self.mesh)
        o = ulysses_combine(o, mesh=self.mesh)                           # [B, s_loc, Hq, hd]
        return _local_proj([t.reshape(B, s_loc, self.n_heads * hd) for t in o], self.w_o)

    def _oracle(self, x, cos, sin) -> list:
        """The replicated plain oracle on rank 0's device with the same
        weight unpacking (the JAX `_oracle`); its attention is
        flash_decode_ref (sp_ring_attention_ref's math) over blocks of
        ORACLE_ROWS query rows, each against the keys up to its last row."""
        n = self.mesh.size
        dev = self.mesh.devices[0]
        B, s_loc, D = x[0].shape
        S, hq, hkv, hd = n * s_loc, self.n_heads // n, self.n_kv_heads // n, self.head_dim
        w = self.w_qkv[0].reshape(D, n, (hq + 2 * hkv) * hd)
        wq = w[:, :, :hq * hd].reshape(D, -1)
        wk = w[:, :, hq * hd:(hq + hkv) * hd].reshape(D, -1)
        wv = w[:, :, (hq + hkv) * hd:].reshape(D, -1)
        xr = torch.cat([t.to(dev) for t in x], 1).reshape(B * S, D)
        q = qmm(xr, wq).reshape(B, S, self.n_heads, hd)
        k = qmm(xr, wk).reshape(B, S, self.n_kv_heads, hd)
        v = qmm(xr, wv).reshape(B, S, self.n_kv_heads, hd)
        if self.q_norm is not None:
            q = rms_norm(q, self.q_norm[0])
        if self.k_norm is not None:
            k = rms_norm(k, self.k_norm[0])
        pos = torch.arange(S, device=dev)
        q = apply_rope(q, cos.to(dev), sin.to(dev), pos)
        k = apply_rope(k, cos.to(dev), sin.to(dev), pos).transpose(1, 2)
        v = v.transpose(1, 2)
        o = torch.cat([flash_decode_ref(q[:, s0:s0 + ORACLE_ROWS], k[:, :, :s1], v[:, :, :s1], s1)
                       for s0 in range(0, S, ORACLE_ROWS)
                       for s1 in [min(S, s0 + ORACLE_ROWS)]], 1)
        o = qmm(o.reshape(B * S, self.n_heads * hd), self.w_o[0]).reshape(B, S, D)
        return [t.contiguous().to(d) for t, d in zip(o.chunk(n, 1), self.mesh.devices)]

    def fwd_train(self, x, cos, sin):
        raise NotImplementedError("UlyssesAttn.fwd_train (Ulysses training and its VJPs): not "
                                  "yet ported")
