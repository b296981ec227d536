"""Attention block (GQA, Qwen3 QK-norm) with the KV cache.

Counterpart of triton_dist_tpu/layers/tp_attn.py (`TP_Attn.init`,
`_qkv_proj`, `_attend_cached`, `_o_proj`, `fwd_cached`) at tensor-
parallel size 1, for the modes "flash" (the CUDA kernels) and "xla"
(the plain PyTorch versions, the JAX package's oracle mode). The packed
weight layout is kept: w_qkv is [D, (Hq + 2*Hkv) * hd] = [q | k | v].
The KV cache tensors are updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from triton_dist_tpu_torch.kernels.flash_attn import (flash_decode,
                                                      flash_decode_ref,
                                                      kv_update, kv_update_ref)
from triton_dist_tpu_torch.kernels.quant import Weight, qmm, quantize_kv_int8
from triton_dist_tpu_torch.layers.common import (apply_rope, rms_norm,
                                                 shard_cols_packed)

MODES = ("flash", "xla")


def check_mode(mode: str) -> None:
    if mode not in MODES:
        raise NotImplementedError(
            f"forward mode {mode!r}: not yet ported (the port runs {MODES})")


@dataclasses.dataclass
class TP_Attn:
    """w_qkv: [D, (Hq + 2*Hkv) * hd] packed [q | k | v]; w_o: [Hq*hd, D];
    q_norm/k_norm: per-head-dim RMSNorm weights (Qwen3 QK-norm)."""

    w_qkv: Weight
    w_o: Weight
    q_norm: Optional[torch.Tensor]
    k_norm: Optional[torch.Tensor]
    n_heads: int
    n_kv_heads: int
    head_dim: int

    @staticmethod
    def init(w_q, w_k, w_v, w_o, *, n_heads: int, n_kv_heads: int,
             head_dim: int, q_norm=None, k_norm=None) -> "TP_Attn":
        return TP_Attn(w_qkv=shard_cols_packed([w_q, w_k, w_v], 1), w_o=w_o,
                       q_norm=q_norm, k_norm=k_norm, n_heads=n_heads,
                       n_kv_heads=n_kv_heads, head_dim=head_dim)

    def _qkv_proj(self, x):
        return qmm(x, self.w_qkv)

    def _o_proj(self, o):
        return qmm(o, self.w_o)

    def _attend_cached(self, qkv, cos, sin, batch: int, kv, kv_start: int,
                       impl: str = "flash"):
        """Split the packed [q|k|v] rows, QK-norm and RoPE, write K/V into
        the cache at kv_start (in place), attend against the cache.

        qkv: [B*S, qkv_cols]; kv: (ck, cv) [B, Hkv, T, hd] or, for an int8
        cache, (ck, cv, ks, vs) with f32 scales [B, Hkv, T]; impl "flash"
        (kernels) or "ref" (plain versions). Returns (o [B*S, Hq*hd], kv).
        """
        hq, hkv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        scale = hd ** -0.5
        M = qkv.shape[0]
        S = M // batch
        q = qkv[:, :hq * hd].reshape(batch, S, hq, hd)
        k = qkv[:, hq * hd:(hq + hkv) * hd].reshape(batch, S, hkv, hd)
        v = qkv[:, (hq + hkv) * hd:].reshape(batch, S, hkv, hd)
        # QK-norm runs at the default eps whatever the config says, as in
        # the JAX layer
        if self.q_norm is not None:
            q = rms_norm(q, self.q_norm)
        if self.k_norm is not None:
            k = rms_norm(k, self.k_norm)
        positions = torch.arange(kv_start, kv_start + S, device=qkv.device)
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
        # the cache is head-major [B, Hkv, T, hd]: strided views, no copy
        kT = k.transpose(1, 2)
        vT = v.transpose(1, 2)
        insert = kv_update if impl == "flash" else kv_update_ref
        if len(kv) == 4:
            ck, cv, ks, vs = kv
            k8, k_s = quantize_kv_int8(kT)
            v8, v_s = quantize_kv_int8(vT)
            insert(ck, k8, kv_start)
            insert(cv, v8, kv_start)
            # the scale planes were a plain update-slice in the JAX layer
            ks[:, :, kv_start:kv_start + S] = k_s
            vs[:, :, kv_start:kv_start + S] = v_s
            if impl == "flash":
                o = flash_decode(q.to(torch.bfloat16), ck, cv, kv_start + S,
                                 scale=scale, k_scale=ks, v_scale=vs)
            else:
                o = flash_decode_ref(q.float(), ck, cv, kv_start + S,
                                     scale=scale, k_scale=ks, v_scale=vs)
            return o.reshape(M, hq * hd).to(qkv.dtype), kv
        ck, cv = kv
        insert(ck, kT.to(ck.dtype), kv_start)
        insert(cv, vT.to(cv.dtype), kv_start)
        attend = flash_decode if impl == "flash" else flash_decode_ref
        # the [S]-sized query goes to the cache dtype, never the cache to
        # the query's
        o = attend(q.to(ck.dtype), ck, cv, kv_start + S, scale=scale)
        return o.reshape(M, hq * hd), kv

    def fwd_cached(self, x, cos, sin, batch: int, kv, kv_start: int,
                   mode: str = "flash"):
        """QKV projection -> cached attention -> O projection.
        x: [B*S, D]; kv: the layer's cache tuple (KVCache.layer).
        Returns (y [B*S, D], kv)."""
        check_mode(mode)
        impl = "ref" if mode == "xla" else "flash"
        o, kv = self._attend_cached(self._qkv_proj(x), cos, sin, batch, kv,
                                    kv_start, impl)
        return self._o_proj(o), kv
