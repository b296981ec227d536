"""Decode attention through a page table, and the host page allocator.

Counterpart of triton_dist_tpu/kernels/paged_kv.py (`flash_decode_paged`
in its per-slot `kv_lens` decode form and its `q_lens` window form,
`flash_decode_paged_partial`, `PageAllocator`), same layouts:
    q [B, S, Hq, d]; page pools k, v [NP, page, d] (one page = `page`
    consecutive positions of ONE (slot, kv-head) stream); page table
    [B*Hkv, max_pages] int32 (row b*Hkv + h is stream (b, h)); int8
    pools carry per-position f32 scale pages [NP, page].
The serving cache keeps its pools as [NP, 1, page, d] (models/kv_cache.py
`PagedSlotCache`, the JAX head-group layout at tensor-parallel size 1);
the layer hands plane 0 (`pool[:, 0]`, a strided view) to this function.

`flash_decode_paged_partial` is the split-KV partial of the
sequence-parallel paged attend: one rank's walk over its shard of the
pool, through its local table, over the logical pages it owns; the
ranks' (acc, m, l) merge with `flash_attn.lse_combine` into the whole
pool's attention.

`flash_decode_paged` and `flash_decode_paged_partial` launch the
hand-written CUDA kernel (csrc/flash_decode_paged.cu) for CUDA tensors
and take the plain PyTorch versions, `flash_decode_paged_ref` and
`flash_decode_paged_partial_ref`, only for CPU tensors.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels.flash_attn import (_HEAD_DIMS, _check_windows, _fold_q,
                                                      _unfold_q, flash_decode_ref)
from triton_dist_tpu_torch.kernels.quant import dequantize_kv_int8


def flash_decode_paged_ref(q, pages_k, pages_v, page_table, *, kv_lens,
                           scale: Optional[float] = None, q_lens=None, k_scale=None,
                           v_scale=None):
    """Plain version of flash_decode_paged: gather every stream's pages
    through the table into a contiguous [B, Hkv, max_pages*page, d]
    cache (scales too) and run the plain contiguous attention
    (flash_decode_ref) with per-row lengths and windows — the JAX
    layer's "xla" oracle. Rows of the table past a stream's length are
    gathered but masked, so they must only hold in-range page ids."""
    B, S, Hq, d = q.shape
    X, maxp = page_table.shape
    Hkv = X // B
    page = pages_k.shape[1]
    tbl = page_table.long()

    def gather(pool):
        return pool[tbl].reshape((B, Hkv, maxp * page) + pool.shape[2:])

    ks = vs = None
    if k_scale is not None:
        ks, vs = gather(k_scale), gather(v_scale)
    return flash_decode_ref(q, gather(pages_k), gather(pages_v), scale=scale,
                            k_scale=ks, v_scale=vs, kv_lens=kv_lens, q_lens=q_lens)


def _check_args(q, page_table, kv_lens, q_lens, who: str) -> None:
    B, S = q.shape[:2]
    X = page_table.shape[0]
    if (S != 1 and q_lens is None) or X % B:
        raise ValueError(f"{who}: q {tuple(q.shape)} and table {tuple(page_table.shape)}: "
                         "want S == 1 (or q_lens) and B*Hkv rows")
    if kv_lens.shape != (B,) or kv_lens.dtype != torch.int32:
        raise ValueError(f"{who}: kv_lens must be int32 [B={B}], got "
                         f"{tuple(kv_lens.shape)} {kv_lens.dtype}")
    _check_windows(q_lens, kv_lens, B, who)


def flash_decode_paged(q, pages_k, pages_v, page_table, *, kv_lens,
                       scale: Optional[float] = None, q_lens=None,
                       k_scale=None, v_scale=None):
    """Cached GQA decode attention through a page table.

    q: [B, S, Hq, d] (last dim contiguous); pages_k/v: [NP, page, d] of
    q's dtype, or int8 with k_scale/v_scale [NP, page] f32 (then q is
    bf16); page_table: [B*Hkv, max_pages] int32; kv_lens: per-row
    lengths [B] int32 on q's device: row b attends positions
    [0, kv_lens[b]) of its own streams,
    whose table entries must be valid page ids for those positions
    (entries past them are never read). S == 1 without q_lens; q_lens
    [B] int32 on q's device (any S, the verify and chunked-prefill
    windows) makes row b's first q_lens[b] positions a window ending at
    kv_lens[b] - 1, causal within it (flash_decode's contract). Returns
    [B, S, Hq, d] in q's dtype."""
    _check_args(q, page_table, kv_lens, q_lens, "flash_decode_paged")
    if q.device.type == "cpu":
        return flash_decode_paged_ref(q, pages_k, pages_v, page_table, scale=scale,
                                      kv_lens=kv_lens, q_lens=q_lens, k_scale=k_scale,
                                      v_scale=v_scale)
    B, S, Hq, d = q.shape
    X, maxp = page_table.shape
    Hkv = X // B
    page = pages_k.shape[1]
    if scale is None:
        scale = d ** -0.5
    quant = k_scale is not None
    _validate_paged(q, pages_k, pages_v, page_table, kv_lens, k_scale, v_scale, quant)
    out = torch.empty((B, S, Hq, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        _build.ext().flash_decode_paged(
            _build.DTYPE_CODES[q.dtype], _build.DTYPE_CODES[pages_k.dtype],
            q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(),
            k_scale.data_ptr() if quant else 0, v_scale.data_ptr() if quant else 0,
            page_table.data_ptr(), kv_lens.data_ptr(),
            0 if q_lens is None else q_lens.data_ptr(), out.data_ptr(), B, S, Hq, Hkv, maxp,
            page, d, float(scale), q.stride(0), q.stride(1), q.stride(2), pages_k.stride(0),
            pages_k.stride(1), k_scale.stride(0) if quant else 0,
            _build.stream_ptr(q.device))
    _build.count("flash_decode_paged")
    return out


def flash_decode_paged_partial_ref(q, pages_k, pages_v, page_table, *, kv_lens, tile_owned,
                                   scale: Optional[float] = None, q_lens=None,
                                   k_scale=None, v_scale=None):
    """Plain version of flash_decode_paged_partial: gather every stream's
    pages through the (local) table, drop the keys of logical pages the
    rank does not own, then the partial math of flash_attn._partial_ref
    with each row's own frontier (kv_lens, q_lens) in f32. Returns (acc
    [B, S, Hq, d], m [B, S, Hq], l [B, S, Hq]); a row with no owned key
    gives (0, -1e30, 0)."""
    B, S, Hq, d = q.shape
    X, maxp = page_table.shape
    Hkv = X // B
    rep = Hq // Hkv
    page = pages_k.shape[1]
    if scale is None:
        scale = d ** -0.5
    tbl = page_table.long()

    def gather(pool):
        return pool[tbl].reshape((X, maxp * page) + pool.shape[2:])

    if k_scale is not None:
        kf = dequantize_kv_int8(gather(pages_k), gather(k_scale))
        vf = dequantize_kv_int8(gather(pages_v), gather(v_scale))
    else:
        kf, vf = gather(pages_k).float(), gather(pages_v).float()
    s = torch.bmm(_fold_q(q, Hkv).float(), kf.transpose(1, 2)) * scale    # [X, R, T]
    row = torch.arange(S * rep, device=q.device)[None, :, None] // rep
    col = torch.arange(maxp * page, device=q.device)[None, None, :]
    kvl = kv_lens.to(q.device, torch.long).repeat_interleave(Hkv)[:, None, None]
    ql = (torch.ones_like(kvl) if q_lens is None
          else q_lens.to(q.device, torch.long).repeat_interleave(Hkv)[:, None, None])
    own = tile_owned.to(q.device).bool().repeat_interleave(page, dim=1)[:, None, :]
    mask = (col <= kvl - ql + torch.minimum(row, ql - 1)) & (col < kvl) & own
    m = torch.where(mask, s, torch.full_like(s, -1e30)).amax(-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    acc, l = torch.bmm(p, vf), p.sum(-1)
    return _unfold_q(acc, B, S, Hkv), _unfold_q(m, B, S, Hkv), _unfold_q(l, B, S, Hkv)


def flash_decode_paged_partial(q, pages_k, pages_v, page_table, *, kv_lens, tile_owned,
                               scale: Optional[float] = None, q_lens=None, k_scale=None,
                               v_scale=None):
    """Split-KV partial of the paged walk: the sequence-parallel paged
    attend's per-rank kernel.

    Same per-stream contract as flash_decode_paged(kv_lens=..,
    q_lens=..), with two changes for a pool sharded over ranks: pages_k/v
    (and the int8 scale planes) are this rank's shard of the pool and
    page_table is the rank's LOCAL table, whose entries for logical pages
    the rank does not own point at some page of the shard (they are never
    read); tile_owned [B*Hkv, max_pages] int32 on q's device marks the
    logical pages this rank owns (non-zero). Keys on pages not owned
    contribute nothing. Returns (acc [B, S, Hq, d] unnormalised, m
    [B, S, Hq], l [B, S, Hq]), all f32, which flash_attn.lse_combine
    merges across ranks into the whole pool's attention; a row that owns
    no key returns (0, -1e30, 0), the combine's neutral element."""
    who = "flash_decode_paged_partial"
    _check_args(q, page_table, kv_lens, q_lens, who)
    if (tile_owned.shape != page_table.shape or tile_owned.dtype != torch.int32
            or tile_owned.device != q.device or not tile_owned.is_contiguous()):
        raise ValueError(f"{who}: tile_owned must be contiguous int32 "
                         f"{tuple(page_table.shape)} on q's device, got "
                         f"{tuple(tile_owned.shape)} {tile_owned.dtype} on {tile_owned.device}")
    if q.device.type == "cpu":
        return flash_decode_paged_partial_ref(q, pages_k, pages_v, page_table,
                                              kv_lens=kv_lens, tile_owned=tile_owned,
                                              scale=scale, q_lens=q_lens, k_scale=k_scale,
                                              v_scale=v_scale)
    B, S, Hq, d = q.shape
    X, maxp = page_table.shape
    Hkv = X // B
    R = S * (Hq // Hkv)
    page = pages_k.shape[1]
    if scale is None:
        scale = d ** -0.5
    quant = k_scale is not None
    _validate_paged(q, pages_k, pages_v, page_table, kv_lens, k_scale, v_scale, quant)
    acc = torch.empty((X, R, d), dtype=torch.float32, device=q.device)
    m = torch.empty((X, R), dtype=torch.float32, device=q.device)
    l = torch.empty((X, R), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _build.ext().flash_decode_paged_partial(
            _build.DTYPE_CODES[q.dtype], _build.DTYPE_CODES[pages_k.dtype],
            q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(),
            k_scale.data_ptr() if quant else 0, v_scale.data_ptr() if quant else 0,
            page_table.data_ptr(), kv_lens.data_ptr(),
            0 if q_lens is None else q_lens.data_ptr(), tile_owned.data_ptr(), acc.data_ptr(),
            m.data_ptr(), l.data_ptr(), B, S, Hq, Hkv, maxp, page, d, float(scale),
            q.stride(0), q.stride(1), q.stride(2), pages_k.stride(0), pages_k.stride(1),
            k_scale.stride(0) if quant else 0, _build.stream_ptr(q.device))
    _build.count("flash_decode_paged_partial")
    return _unfold_q(acc, B, S, Hkv), _unfold_q(m, B, S, Hkv), _unfold_q(l, B, S, Hkv)


def _validate_paged(q, pk, pv, table, lens, k_scale, v_scale, quant: bool) -> None:
    B, _, Hq, d = q.shape
    X = table.shape[0]
    tensors = [q, pk, pv, table, lens] + ([k_scale, v_scale] if quant else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_decode_paged: all tensors must be on one device")
    if pk.dim() != 3 or pk.shape != pv.shape or pk.shape[2] != d:
        raise ValueError(f"flash_decode_paged: q {tuple(q.shape)} does not match "
                         f"pools {tuple(pk.shape)} / {tuple(pv.shape)}")
    if Hq % (X // B):
        raise ValueError(f"flash_decode_paged: Hq={Hq} is not a multiple of "
                         f"Hkv={X // B}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_decode_paged: head_dim {d} not in {_HEAD_DIMS}")
    if table.dtype != torch.int32 or not table.is_contiguous() \
            or not lens.is_contiguous():
        raise ValueError("flash_decode_paged: table and kv_lens must be "
                         "contiguous int32")
    if quant:
        if q.dtype != torch.bfloat16 or pk.dtype != torch.int8 or pv.dtype != torch.int8:
            raise ValueError("flash_decode_paged: an int8 pool takes a bf16 query")
        if (v_scale is None or k_scale.shape != pk.shape[:2]
                or v_scale.shape != pk.shape[:2]
                or k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
                or k_scale.stride() != v_scale.stride() or k_scale.stride(1) != 1):
            raise ValueError("flash_decode_paged: scales must be f32 [NP, page] with "
                             "equal strides and contiguous rows")
    elif q.dtype not in (torch.bfloat16, torch.float32) or pk.dtype != q.dtype \
            or pv.dtype != q.dtype:
        raise ValueError(f"flash_decode_paged: q {q.dtype}, pools {pk.dtype} / "
                         f"{pv.dtype}: want bf16 or f32 throughout")
    if q.stride(3) != 1 or pk.stride(2) != 1 or pk.stride() != pv.stride():
        raise ValueError("flash_decode_paged: head_dim must be contiguous and the "
                         "pools must share strides")
    size = pk.element_size()
    if (any(s * size % 16 for s in pk.stride()[:2])
            or pk.data_ptr() % 16 or pv.data_ptr() % 16):
        raise ValueError("flash_decode_paged: every K/V row must be 16-byte aligned")


class PageAllocator:
    """Host-side free lists over the physical page pool (copied from the
    JAX package's allocator, so that page ids are handed out in the same
    order: lowest id first, freed ids reused last in, first out). Page 0
    is the first handed out; the serving layer reserves it as the trash
    page. Pure host bookkeeping: allocation changes the page TABLE
    (data), never the kernel.

    shards > 1 (sequence-parallel serving, models/kv_cache.py
    PagedSlotCache with sp): the page-id space splits into contiguous
    blocks, shard s owning ids [s * pps, (s + 1) * pps) (pps =
    pages_per_shard, the device split of the pool); allocation rotates
    across shards, so a slot's consecutive logical pages land on
    different ranks, and a free returns a page to its own shard, so
    `available_by_shard[s] + outstanding_by_shard[s] == pps` holds per
    shard after any sequence of operations. shards == 1 is the
    single-list allocator."""

    def __init__(self, num_pages: int, shards: int = 1):
        if num_pages < 1 or shards < 1 or num_pages % shards:
            raise ValueError(
                f"page pool of {num_pages} pages cannot split over {shards} shards: the sp "
                "mesh size must divide the page count (pass num_pages as a multiple of the "
                "sp axis, or shrink the axis)")
        self.num_pages = num_pages
        self.shards = shards
        self.pages_per_shard = pps = num_pages // shards
        # per shard, descending: pop() hands out each shard's lowest id first
        self._free_by_shard = [list(range((s + 1) * pps - 1, s * pps - 1, -1))
                               for s in range(shards)]
        self._rr = 0
        self._in_use = set()

    def shard_of(self, page: int) -> int:
        return int(page) // self.pages_per_shard

    @property
    def available(self) -> int:
        return sum(len(f) for f in self._free_by_shard)

    @property
    def available_by_shard(self) -> List[int]:
        return [len(f) for f in self._free_by_shard]

    @property
    def outstanding(self) -> int:
        return len(self._in_use)

    @property
    def outstanding_by_shard(self) -> List[int]:
        out = [0] * self.shards
        for p in self._in_use:
            out[p // self.pages_per_shard] += 1
        return out

    def _check(self) -> None:
        """Pool conservation: every page is on a free list XOR outstanding
        (a violation means the bookkeeping handed one page to two
        holders)."""
        if self.available + len(self._in_use) != self.num_pages:
            raise RuntimeError(
                f"page pool corrupted: {self.available} free + "
                f"{len(self._in_use)} in use != {self.num_pages}")

    def _pick_shard(self) -> int:
        """The next shard in rotation with a free page."""
        for i in range(self.shards):
            s = (self._rr + i) % self.shards
            if self._free_by_shard[s]:
                self._rr = (s + 1) % self.shards
                return s
        raise ValueError("page pool exhausted: no shard has a free page")

    def alloc(self, n: int) -> List[int]:
        """Take n pages off the free lists, rotating across shards (raises
        when the pool is exhausted: the scheduler's admission check)."""
        if n > self.available:
            raise ValueError(f"page pool exhausted: want {n}, have {self.available}")
        out = [self._free_by_shard[self._pick_shard()].pop() for _ in range(n)]
        self._in_use.update(out)
        self._check()
        return out

    def free(self, pages) -> None:
        """Return pages to their own shard's free list. Rejects
        out-of-range ids and double frees BEFORE touching the pool."""
        pages = [int(p) for p in pages]
        seen = set()
        for p in pages:
            if not 0 <= p < self.num_pages:
                raise ValueError(f"free of out-of-range page {p} "
                                 f"(pool has {self.num_pages})")
            if p not in self._in_use or p in seen:
                raise ValueError(f"double free of page {p}")
            seen.add(p)
        for p in pages:
            self._in_use.remove(p)
            self._free_by_shard[p // self.pages_per_shard].append(p)
        self._check()
