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

The training form (`fwd_train`, the JAX `sp_ring_attention_train`) and
the Ulysses layer (`UlyssesAttn`) are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from triton_dist_tpu_torch.kernels.quant import qmm
from triton_dist_tpu_torch.kernels.sp_attention import sp_ring_attention
from triton_dist_tpu_torch.kernels.sp_flash_decode import kv_cache_scatter, sp_flash_decode
from triton_dist_tpu_torch.layers.common import apply_rope, rms_norm


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


class UlyssesAttn:
    """The Ulysses layer (head-resharding all-to-alls fused with the QKV
    and O projections, rows 27-28): not yet ported."""

    @staticmethod
    def init(*args, **kwargs):
        raise NotImplementedError("UlyssesAttn (Ulysses sequence parallelism): not yet ported")
