"""KV caches: counterparts of triton_dist_tpu/models/kv_cache.py
`KVCache` (contiguous, bf16 and int8) and `PagedSlotCache` (the paged
pool of continuous-batching serving) at tensor-parallel size 1.

Per-layer lists of head-major [B, Hkv, T, hd] tensors (the flash
kernel's read order), plus per-position f32 scales [B, Hkv, T] for an
int8 cache. Where the JAX cache was donated and rebuilt functionally,
these tensors are updated in place and `offset` (a host int: the number
of valid positions) advances in place.

Tensor parallelism (`create(..., mesh=)`): the caches are head-sharded
as in JAX, rank r holding kv heads [r*Hkv/n, (r+1)*Hkv/n) on its device,
as one cache of Hkv/n heads per rank in `ranks` (the top-level lists are
then empty). A paged pool's page ids mean the same on every rank: the
allocator, the radix tree and the host's table are one, and each rank
keeps its own pools (NP pages of its heads' streams; a page of another
rank's head holds garbage there, never read) and its own device copy of
its streams' rows of the table, [B*Hkv/n, max_pages] (row b*Hkv/n + h is
slot b's local kv head h).

Sequence parallelism (`PagedSlotCache.create(..., mesh=, sp=True)`, the
JAX SP SHARDING): the page-id space splits over the n ranks instead, rank
s holding the physical pages [s * pps, (s + 1) * pps) of every layer
(pps = num_pages / n), so a slot's context is bounded by the whole
mesh's pools, not one card's. Each rank keeps every kv head's pages of
its block, plus one sink page past them (local page pps) where the rows
of pages it does not own are written: the JAX scatter dropped them out
of bounds, and torch has no dropping scatter. The table holds global ids
and is the same on every rank (one device copy per distinct device);
the allocator (kernels/paged_kv.py PageAllocator(shards=n)) rotates
fresh groups across the ranks. sp with the head split and int8 pools:
the scale planes shard with the payload.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def _check_heads(n_kv_heads: int, mesh) -> int:
    n = mesh.size
    if n_kv_heads % n:
        raise ValueError(
            f"a head-sharded cache needs n_kv_heads ({n_kv_heads}) divisible by the "
            f"tensor-parallel size ({n}): each rank holds whole kv heads, and GQA "
            "replication of the query heads does not relax that")
    return n_kv_heads // n


@dataclasses.dataclass
class KVCache:
    k: list                 # L x [B, Hkv, T, hd]
    v: list
    offset: int = 0
    # int8 cache only: L x [B, Hkv, T] f32 scales (empty lists otherwise)
    ks: list = dataclasses.field(default_factory=list)
    vs: list = dataclasses.field(default_factory=list)
    # tensor parallelism: one KVCache per rank (its kv heads, its device)
    ranks: Optional[list] = None

    @staticmethod
    def create(num_layers: int, batch: int, max_seq: int, n_kv_heads: int,
               head_dim: int, *, device=None, dtype=torch.bfloat16,
               mesh=None) -> "KVCache":
        """dtype=torch.int8 stores K/V quantized per position, with the
        scales the flash kernel folds into the logits and P. With a mesh
        of n > 1 ranks, head-sharded over it (device unused)."""
        if mesh is not None and mesh.size > 1:
            hkv = _check_heads(n_kv_heads, mesh)
            return KVCache(k=[], v=[], ranks=[
                KVCache.create(num_layers, batch, max_seq, hkv, head_dim, device=d,
                               dtype=dtype) for d in mesh.devices])
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
        return self.ranks[0].quantized if self.ranks else bool(self.ks)

    @property
    def capacity(self) -> int:
        """Positions per batch row (T)."""
        return self.ranks[0].capacity if self.ranks else self.k[0].shape[2]

    def parts(self) -> list:
        """The per-rank caches (this cache itself at one rank)."""
        return self.ranks if self.ranks else [self]

    def rows(self, lo: int, hi: int) -> "KVCache":
        """Views of batch rows [lo, hi) at offset 0 (every rank's)."""
        if self.ranks:
            return KVCache(k=[], v=[], ranks=[c.rows(lo, hi) for c in self.ranks])
        return KVCache(k=[t[lo:hi] for t in self.k], v=[t[lo:hi] for t in self.v],
                       ks=[t[lo:hi] for t in self.ks], vs=[t[lo:hi] for t in self.vs])

    def layer(self, idx: int):
        """The layer's cache tuple for TP_Attn.fwd_cached: (k, v), or
        (k, v, ks, vs) when int8; with ranks, a list of each rank's."""
        if self.ranks:
            return [c.layer(idx) for c in self.ranks]
        if self.quantized:
            return self.k[idx], self.v[idx], self.ks[idx], self.vs[idx]
        return self.k[idx], self.v[idx]

    def advance(self, n: int) -> None:
        self.offset += n


@dataclasses.dataclass
class PagedSlotCache:
    """Multi-layer paged KV pool behind ONE page table shared by all
    layers (a physical page id means the same row in every layer's
    pool, so one [Hkv] page group per logical tile covers all layers and
    mapping a cached prefix into a slot is a table edit, not a copy).

    pages_k/v: L x [NP, G, page, d] with G = 1 (the JAX head-group axis
    at tensor-parallel size 1); int8 pools add per-position f32 scale
    pools scales_k/v: L x [NP, G, page], addressed by the same page ids.
    table: [B*Hkv, max_pages] int32 on the device (row b*Hkv + h is
    slot b's kv head h). Page `trash` (0) is the write sink: every
    unmapped table entry points at it, so the rows of retired slots,
    which keep stepping, can never write into a page someone else
    holds. Updated in place."""

    pages_k: list
    pages_v: list
    table: torch.Tensor
    scales_k: list = dataclasses.field(default_factory=list)
    scales_v: list = dataclasses.field(default_factory=list)
    trash: int = 0
    # tensor parallelism: one pool set per rank (its kv heads' streams, its
    # rows of the table, its device); table is then None
    ranks: Optional[list] = None
    # sequence parallelism: the mesh size the page-id space splits over
    # (1: no split); `ranks` then holds each rank's block of pages
    sp: int = 1

    @staticmethod
    def create(num_layers: int, batch: int, max_seq: int, n_kv_heads: int,
               head_dim: int, *, page: int, num_pages: int, device=None,
               dtype=torch.bfloat16, mesh=None, sp: bool = False) -> "PagedSlotCache":
        """mesh of n > 1 ranks: head-sharded (tensor parallelism), or with
        sp=True the page ids split over the ranks (num_pages a multiple of
        n)."""
        if sp and mesh is not None and mesh.size > 1:
            n = mesh.size
            if num_pages % n:
                raise ValueError(
                    f"sequence-parallel pool needs num_pages ({num_pages}) divisible by the "
                    f"sp mesh size ({n}): each rank owns a contiguous block of the page-id "
                    "space; round num_pages up or shrink the axis")
            tables = {}
            ranks = []
            for d in mesh.devices:
                rc = PagedSlotCache.create(num_layers, batch, max_seq, n_kv_heads, head_dim,
                                           page=page, num_pages=num_pages // n + 1, device=d,
                                           dtype=dtype)
                rc.table = tables.setdefault(d, rc.table)
                ranks.append(rc)
            return PagedSlotCache(pages_k=[], pages_v=[], table=None, ranks=ranks, sp=n)
        if mesh is not None and mesh.size > 1:
            hkv = _check_heads(n_kv_heads, mesh)
            return PagedSlotCache(pages_k=[], pages_v=[], table=None, ranks=[
                PagedSlotCache.create(num_layers, batch, max_seq, hkv, head_dim, page=page,
                                      num_pages=num_pages, device=d, dtype=dtype)
                for d in mesh.devices])
        maxp = -(-max_seq // page)

        def zeros(shape, dt):
            return [torch.zeros(shape, dtype=dt, device=device)
                    for _ in range(num_layers)]

        sk = sv = []
        if dtype == torch.int8:
            sk = zeros((num_pages, 1, page), torch.float32)
            sv = zeros((num_pages, 1, page), torch.float32)
        shape = (num_pages, 1, page, head_dim)
        table = torch.zeros((batch * n_kv_heads, maxp), dtype=torch.int32,
                            device=device)            # every entry the trash page
        return PagedSlotCache(pages_k=zeros(shape, dtype), pages_v=zeros(shape, dtype),
                              table=table, scales_k=sk, scales_v=sv)

    def parts(self) -> list:
        """The per-rank pools (this cache itself at one rank)."""
        return self.ranks if self.ranks else [self]

    @property
    def quantized(self) -> bool:
        return bool(self.parts()[0].scales_k)

    @property
    def page(self) -> int:
        return self.parts()[0].pages_k[0].shape[2]

    @property
    def pages_per_shard(self) -> int:
        """Physical pages of one rank's block (num_pages at sp == 1; the
        local sink page past them is not counted)."""
        local = self.parts()[0].pages_k[0].shape[0]
        return local - 1 if self.sp > 1 else local

    @property
    def num_pages(self) -> int:
        return self.pages_per_shard * self.sp

    @property
    def max_pages(self) -> int:
        """Table width: pages addressable per (slot, kv head) stream."""
        return self.parts()[0].table.shape[1]

    @property
    def capacity(self) -> int:
        """Logical positions addressable per slot (table width x page)."""
        return self.max_pages * self.page

    @property
    def tables(self) -> list:
        """Each rank's table (its streams' rows; at sp every stream's, one
        tensor shared by the ranks of a device)."""
        return [c.table for c in self.parts()]

    def device_tables(self) -> list:
        """The distinct table tensors (one per device at sp, one per rank
        otherwise)."""
        out = []
        for t in self.tables:
            if not any(t is u for u in out):
                out.append(t)
        return out

    def layer(self, idx: int):
        """The layer's pool tuple for TP_Attn.fwd_cached_slots_paged:
        (pages_k, pages_v), or with the scale pools when int8; with
        ranks, a list of each rank's."""
        if self.ranks:
            return [c.layer(idx) for c in self.ranks]
        if self.quantized:
            return (self.pages_k[idx], self.pages_v[idx], self.scales_k[idx],
                    self.scales_v[idx])
        return self.pages_k[idx], self.pages_v[idx]
