"""Contiguous KV cache: counterpart of triton_dist_tpu/models/kv_cache.py
`KVCache` (bf16 and int8).

Per-layer lists of head-major [B, Hkv, T, hd] tensors (the flash
kernel's read order), plus per-position f32 scales [B, Hkv, T] for an
int8 cache. Where the JAX cache was donated and rebuilt functionally,
these tensors are updated in place and `offset` (a host int: the number
of valid positions) advances in place.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class KVCache:
    k: list                 # L x [B, Hkv, T, hd]
    v: list
    offset: int = 0
    # int8 cache only: L x [B, Hkv, T] f32 scales (empty lists otherwise)
    ks: list = dataclasses.field(default_factory=list)
    vs: list = dataclasses.field(default_factory=list)

    @staticmethod
    def create(num_layers: int, batch: int, max_seq: int, n_kv_heads: int,
               head_dim: int, *, device, dtype=torch.bfloat16) -> "KVCache":
        """dtype=torch.int8 stores K/V quantized per position, with the
        scales the flash kernel folds into the logits and P."""
        shape = (batch, n_kv_heads, max_seq, head_dim)

        def zeros(shp, dt):
            return [torch.zeros(shp, dtype=dt, device=device)
                    for _ in range(num_layers)]

        ks = vs = []
        if dtype == torch.int8:
            ks, vs = zeros(shape[:3], torch.float32), zeros(shape[:3], torch.float32)
        return KVCache(k=zeros(shape, dtype), v=zeros(shape, dtype), ks=ks, vs=vs)

    @property
    def quantized(self) -> bool:
        return bool(self.ks)

    def layer(self, idx: int):
        """The layer's cache tuple for TP_Attn.fwd_cached: (k, v), or
        (k, v, ks, vs) when int8."""
        if self.quantized:
            return self.k[idx], self.v[idx], self.ks[idx], self.vs[idx]
        return self.k[idx], self.v[idx]

    def advance(self, n: int) -> None:
        self.offset += n
