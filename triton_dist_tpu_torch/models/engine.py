"""Inference engine: counterpart of triton_dist_tpu/models/engine.py
(`Engine.__init__` gates, `prefill`, `decode`, `serve`, the contiguous
slot entry points `make_slot_cache`, `prefill_into_slot`, `slot_chunk`,
the paged ones `make_paged_slot_cache`, `admit_slot_paged`,
`paged_slot_chunk`, `retire_slot_paged`, and the window programs of
speculative decoding and chunked prefill: `slot_verify_chunk`,
`paged_slot_verify_chunk`, `slot_mixed_chunk`, `paged_slot_mixed_chunk`,
`slot_mixed_verify_chunk`, `paged_slot_mixed_verify_chunk` and
`install_slot_paged`) for greedy decode, on one device or over a
tensor-parallel mesh (runtime/bootstrap.py; the model's `to_mesh`).

Backends: "flash" runs the CUDA kernels (flash-decode, the paged
flash-decode, kv_update, SwiGLU, and for a Qwen3MoE model the grouped
GEMM of its expert FFNs); "xla" runs their plain PyTorch versions (the
JAX package's oracle backend); "ar" and "gemm_ar" (dense and TP-MoE
models, any tensor-parallel size) end each layer's O and down
projections in the all_reduce kernel or the gemm_allreduce kernel, and
prefill and admit on "xla" (or `prefill_backend`), as in the JAX engine,
so the hand collectives run in the decode ticks; "dist" (dense and
TP-MoE models, any tensor-parallel size) runs the
QKV and gate/up projections through the ag_gemm ring and the O and down
projections through the gemm_rs ring on a row-sharded residual stream,
and prefills and admits through itself (the JAX engine's
prefill_backend), so the rings run in the prefill, the admissions and
the ticks; at one rank both are the GEMM kernel. "ep" and "ep_flash" (a Qwen3MoE built
with moe_impl="ep", its experts split over the mesh) run every MoE layer
through the EP dispatch_a2a and all_to_all kernels and the grouped GEMM
on each rank's experts, the attention on "dist" ("ep") or "flash"
("ep_flash"), and prefill and admit through themselves; a slot batch the
mesh does not divide is refused (`make_slot_cache`,
`make_paged_slot_cache`), as in the JAX engine. `comm_kernel_dispatches`
counts the slot programs a comm backend dispatched (the JAX engine's
counter). Over a mesh of n > 1 ranks, "flash" and "xla" end the
projections in the psum's plain version, the caches are head-sharded
(models/kv_cache.py), the page table's host side, allocator and radix
tree stay one, and the logits, tokens and positions live on rank 0's
device; the window programs stay at one rank. A Qwen3MoE
built with moe_impl="tp" serves "ar", "gemm_ar" and "dist" at any size:
its FFN runs TP_MoE's form of the mode (layers/tp_moe.py), the grouped GEMM
on each rank's columns; `prefill_backend="flash"` keeps an "ar"/"gemm_ar"
prefill of many rows off the dense all-experts oracle. The JAX engine
rounds an EP model's max_seq and prefill buckets up to lcm(8, ep), since
its EP forwards take row counts the mesh divides; the port runs exact
row counts, padded with rows that route nowhere (layers/ep_moe.py), so
max_seq stays as given. "mega" (dense models) prefills
and admits on "flash" and decodes each layer as ONE megakernel launch
(mega/decode_layer.py): `decode` over the contiguous cache
(`_mega_scan_decode_fn`) and `paged_slot_chunk` over the paged pool
(`_paged_slot_mega_scan_fn`), greedy only. Over a mesh of n > 1 ranks
(a dense model split by `to_mesh`; heads, kv heads and
intermediate_size divisible by n, else a ValueError as in JAX) "mega"
decodes the contiguous cache through the tensor-parallel megakernel: one
launch per layer per device, each rank on its own shards and cache
heads, with the two all-reduces inside the kernel; the embedding and
the head stay on rank 0, and the TP paged pool refuses
(`make_paged_slot_cache`), as the JAX engine does. Each JAX `lax.scan` is a
Python loop over steps here, and every buffer the JAX programs donated
(caches, page pools, the page table) is updated in place. The slot
programs return device tensors and never synchronise; host arrays
(page-table rows, admission indices) go to the card as asynchronous
copies from pinned memory.

Sequence parallelism (a dense model built with sp_axis="sp" over a mesh
of n ranks; `sp_size`): the paged pool's page ids split over the ranks
(models/kv_cache.py), and the paged ticks and window programs run the SP
attend (models/dense.py `_sp_forward`). Construction refuses what the
JAX engine refuses: a TP hybrid, backend "mega", any backend but
"flash"; contiguous slots refuse too (`make_slot_cache`), and the
pool's default size rounds up to a multiple of n. The admissions run the
suffix forward on rank 0's device over a contiguous scratch (the JAX
replicated scratch): the prefix pages are gathered from their owners
(`_pool_gather_sp`), the suffix rows scattered to theirs
(`_pool_scatter_sp`), and a boundary page's copy-on-write crosses ranks
as one gather and one scatter (`_cow_pages_sp`); the page ownership is
computed on the host from the table rows, so each rank moves only the
rows of its own pages.

The window programs run one forward over a [B, S] window per tick
(models/dense.py forward_tokens_slots_verify and its paged form, through
the q_lens forms of flash_decode and flash_decode_paged); their greedy
acceptance (models/spec_decode.py accept_greedy) runs on the device, and
the host's window arrays (tokens, q_lens, the prefilling mask) go to the
card as asynchronous copies. On "mega" the verify programs and the
contiguous mixed ticks refuse with a ValueError, as in the JAX engine;
the paged mixed ticks run the per-op "flash" program.

On "mega" the per-layer weight dicts (norms in f32, absent QK-norms as
ones, the bf16 panels as they are) are built once per Engine, where the
JAX engine rebuilt them in every decode call. The JAX engine rounded
max_seq up to the megakernel's block_t, a Pallas tile constraint; the
CUDA kernel walks any length, so max_seq stays as given. The residual
stream between mega layers is f32 (the per-op path keeps the model
dtype); the embedding lookup, the RoPE rows, the final RMSNorm, the
lm_head product (a plain product, as JAX left it to jnp.dot) and the argmax
stay outside the kernels, as in the JAX engine.

MoE models (Qwen3MoE, `moe_family`): every slot chunk also sums the
routing-load vector [expert_tokens[0..E-1], capacity_dropped] (int32
[E+1]) over its layers and steps on the device and returns it as a fifth
output; the scheduler reads it back with the tick's tokens. (The JAX
engine queues it FIFO for its overlapped ticks; overlap is not ported,
so every chunk is read back before the next one is dispatched.)
"""

from __future__ import annotations

import numpy as np
import torch

from triton_dist_tpu_torch.kernels.quant import QuantW, qmm
from triton_dist_tpu_torch.layers.common import rms_norm
from triton_dist_tpu_torch.mega import MegaDecodeLayer, MegaPagedDecodeLayer
from triton_dist_tpu_torch.models.kv_cache import KVCache, PagedSlotCache
from triton_dist_tpu_torch.models.spec_decode import accept_greedy
from triton_dist_tpu_torch.models.utils import sample_greedy
from triton_dist_tpu_torch.runtime.device import resolve_device

BACKENDS = ("flash", "xla", "mega", "ar", "gemm_ar", "dist", "ep", "ep_flash")
# the backends whose decode ticks run the TP comm kernels
COMM_BACKENDS = ("ar", "gemm_ar", "dist")
# the expert-parallel backends (a Qwen3MoE built with moe_impl="ep")
EP_BACKENDS = ("ep", "ep_flash")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: not yet ported")


class Engine:
    def __init__(self, model, *, max_seq: int = 256, backend: str = "flash",
                 prefill_backend=None, kv_dtype=None, sampling: str = "greedy", device=None):
        """Serve `model` on `device` (default "cuda"; the model must live
        there). kv_dtype=torch.int8 stores the KV cache quantized per
        position; pair it with model.quantize_int8(). prefill_backend: the
        mode of prefill and the admissions (the JAX engine's; by default
        the backend itself for "flash", "dist", "ep" and "ep_flash", "flash"
        for "mega", "xla" for the rest); "flash", "xla" or the backend.
        Unsupported combinations raise here, at construction."""
        dev = resolve_device(device)
        if model.device != dev:
            raise ValueError(f"the model lives on {model.device}, the engine "
                             f"was asked for {dev}")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; this engine serves "
                             f"{BACKENDS}")
        tp = getattr(model, "tp", 1)
        self.sp_size = int(getattr(model, "sp_size", 1))
        if self.sp_size > 1:
            _check_sp(model, backend, tp, self.sp_size)
        if backend == "mega":
            _check_mega(model, kv_dtype, sampling, tp)
        if backend in COMM_BACKENDS and getattr(model, "moe_impl", None) == "ep":
            raise _not_ported(f"backend={backend!r} for an expert-parallel model (its FFN "
                              "as the dense oracle beside the comm-kernel attention)")
        if backend in EP_BACKENDS:
            _check_ep(model, backend)
        if sampling != "greedy":
            raise _not_ported(f"sampling={sampling!r}")
        if kv_dtype not in (None, torch.int8, model.config.torch_dtype):
            raise ValueError(f"kv_dtype {kv_dtype}: want None (the model "
                             "dtype) or torch.int8")
        self.model = model
        self.max_seq = max_seq
        self.backend = backend
        self.kv_dtype = kv_dtype
        self.device = dev
        self.tp = tp
        # admissions and prefill: mega fuses decode only; "ar"/"gemm_ar"
        # prefill on "xla", "dist", "ep" and "ep_flash" through themselves,
        # as the JAX engine's default prefill_backend
        if prefill_backend not in (None, "flash", "xla", backend) or prefill_backend == "mega":
            raise ValueError(f"prefill_backend {prefill_backend!r}: want None, 'flash', "
                             f"'xla' or the backend ({backend!r})")
        self.prefill_backend = prefill_backend or (
            "flash" if backend == "mega" else "xla" if backend in ("ar", "gemm_ar") else backend)
        # slot programs dispatched through a comm backend
        self.comm_kernel_dispatches = 0
        self._paged_scratch = None      # admit_slot_paged's 1-row cache
        # backend "mega": the layer weight dicts and the two layer objects
        # (their scratch is allocated once), built at first use
        self._mega = None
        self._mega_layer = self._mega_paged_layer = None
        # MoE: the slot chunks also return their routing-load vector
        self.moe_family = bool(model.config.is_moe)

    def prefill(self, input_ids):
        """Run the prefill pass on a fresh cache; returns (logits, cache)."""
        ids = torch.as_tensor(input_ids, device=self.device).long()
        cache = self.model.make_cache(ids.shape[0], self.max_seq,
                                      dtype=self.kv_dtype)
        return _prefill_fn(self.model, ids, cache, mode=self.prefill_backend)

    def decode(self, logits, cache, gen_len: int):
        """Greedy decode from prefill state, gen_len steps, updating the
        cache in place. Returns tokens [B, gen_len] int32."""
        if self.backend == "mega" and self.kv_dtype is not None:
            raise ValueError(
                "backend='mega' dequantizes int8 KV only on the PAGED pool; the "
                "contiguous decode reads the cache directly — serve int8 through "
                "ContinuousScheduler(paged=True), or use kv_dtype=None here")
        if cache.offset + gen_len > self.max_seq:
            raise ValueError(f"{gen_len} steps from position {cache.offset} "
                             f"overrun max_seq={self.max_seq}")
        if self.backend == "mega":
            toks, _, _ = _mega_scan_decode_fn(self, logits, cache, gen_len=gen_len)
        else:
            toks, _, _ = _scan_decode_fn(self.backend, self.model, logits, cache,
                                         gen_len=gen_len)
        return toks

    def decode_step(self, tok, cache):
        """One step of the engine's decode path fed tokens tok [B] (teacher
        forcing): the megakernel layers on "mega", forward_tokens on the
        others. Updates the cache in place; returns logits [B, V] f32."""
        if self.backend == "mega":
            return _mega_step(self, tok, cache)
        return self.model.forward_tokens(tok.long()[:, None], cache, mode=self.backend)[0]

    def serve(self, input_ids, gen_len: int):
        """Generate: prefill then decode. input_ids [B, S]; returns
        tokens [B, gen_len]."""
        logits, cache = self.prefill(input_ids)
        return self.decode(logits, cache, gen_len)

    def _h2d(self, a, dtype=torch.long, device=None) -> torch.Tensor:
        """A host array as a tensor on `device` (default the engine's): an
        asynchronous copy from pinned memory on the card (no stream
        synchronisation), the array itself on the CPU."""
        dev = self.device if device is None else torch.device(device)
        t = torch.as_tensor(np.asarray(a), dtype=dtype)
        if dev.type == "cpu":
            return t
        return t.pin_memory().to(dev, non_blocking=True)

    def _count_dispatch(self) -> None:
        if self.backend in COMM_BACKENDS:
            self.comm_kernel_dispatches += 1

    def _one_rank(self, what: str) -> None:
        if self.tp > 1:
            raise _not_ported(f"{what} at tensor-parallel size > 1")

    # ------------------------------------------------------------------
    # contiguous slots (continuous batching; models/scheduler.py): each
    # batch row of the cache is an independent request
    # ------------------------------------------------------------------

    def _load0(self):
        """A fresh routing-load accumulator for a MoE slot chunk, else None."""
        return self.model._zero_load() if self.moe_family else None

    def _ep_batch_check(self, batch: int) -> None:
        """An expert-parallel model's tick feeds its slot batch to the
        row-sharded expert dispatch: refuse a batch the mesh does not
        divide (the JAX engine's `_moe_batch_check`), at cache
        construction."""
        ep = getattr(self.model, "ep_size", 1)
        if ep > 1 and batch % ep:
            raise ValueError(
                f"EP serving needs the slot batch ({batch}) divisible by the "
                f"expert-parallel axis size ({ep}): each tick row-shards its token batch "
                f"over the ep mesh axis {self.model.ep_axis!r}; pad the batch or shrink "
                "the ep axis")

    def make_slot_cache(self, batch: int) -> KVCache:
        """Fresh cache whose batch rows are independent decode slots."""
        if self.sp_size > 1:
            raise ValueError(
                "sequence-parallel serving shards the PAGE-ID space; contiguous slot caches "
                "have no pages to shard (missing capability: sp contiguous slots); construct "
                "ContinuousScheduler(paged=True) so the sp pool serves through the "
                "partial + LSE-combine attends")
        self._ep_batch_check(batch)
        return self.model.make_cache(batch, self.max_seq, dtype=self.kv_dtype)

    def prefill_into_slot(self, cache: KVCache, slot: int, ids):
        """Prefill ONE request and write its KV into batch row `slot` of
        the slot cache without touching the other rows. The JAX engine
        prefilled a 1-row scratch cache and copied it over the row; here
        the batch-1 forward runs on a view of the row itself, so there is
        no copy (positions past the prompt keep stale KV, masked by the
        row's length as the JAX scratch's were). Returns (next-token
        logits [V], cache)."""
        ids = np.asarray(ids, np.int32).reshape(-1)
        if len(ids) > self.max_seq:
            raise ValueError(f"prompt length {len(ids)} exceeds slot capacity "
                             f"{self.max_seq}")
        row = cache.rows(slot, slot + 1)
        logits, _ = _prefill_fn(self.model, self._h2d(ids)[None], row,
                                mode=self.prefill_backend)
        return logits[0], cache

    def slot_chunk(self, logits, cache: KVCache, pos, active, *, chunk: int):
        """One chunk of slot-masked greedy decode: `chunk` steps where row
        b takes the argmax of its own logits, appends KV at its own
        pos[b] and advances only if active[b] (inactive rows write into
        their own dead rows, overwritten on admit). logits [B, V] f32,
        pos [B] int32 and active [B] bool stay on the device. Returns
        (toks [B, chunk] int32, logits, cache, pos), all on the device, and
        for a MoE model the chunk's routing-load vector fifth."""
        if self.backend == "mega":
            raise ValueError(
                "backend='mega' fuses the PAGED decode tick only (paged_slot_chunk); "
                "contiguous slot serving runs the per-op backends — use "
                "ContinuousScheduler(paged=True) or backend='flash'")
        self._count_dispatch()
        return _slot_scan_decode_fn(
            self.model.forward_tokens_slots, self.backend, logits, cache, pos, active,
            cap=cache.capacity, gen_len=chunk, load=self._load0())

    # ------------------------------------------------------------------
    # paged slots (shared-prefix serving; models/prefix_cache.py owns the
    # policy and drives these through the scheduler)
    # ------------------------------------------------------------------

    def make_paged_slot_cache(self, batch: int, *, page: int = 16,
                              num_pages=None) -> PagedSlotCache:
        """Paged slot cache: per-layer page pools behind one shared page
        table (an int8 pool when kv_dtype is int8). num_pages defaults to
        the no-sharing worst case (every slot full) plus the trash
        page, rounded up to a multiple of the sp mesh size at sp > 1 (where a
        given num_pages must be one)."""
        self._ep_batch_check(batch)
        if self.backend == "mega" and self.tp > 1:
            raise ValueError(
                "backend='mega' fuses the paged tick single-chip only (the TP pool's "
                "head-group plane split stays on the per-op path); serve TP meshes with "
                "backend='flash'/'dist'/'ar'/'gemm_ar'")
        cfg = self.model.config
        maxp = -(-self.max_seq // page)
        sp = self.sp_size
        if num_pages is None:
            num_pages = batch * cfg.num_kv_heads * maxp + 1
            num_pages = -(-num_pages // sp) * sp
        elif num_pages % sp:
            raise ValueError(
                f"sequence-parallel pool needs num_pages ({num_pages}) divisible by the sp "
                f"mesh size ({sp}): the page-id space partitions into equal per-rank blocks; "
                f"round num_pages up to a multiple of {sp} or shrink the sp axis")
        return PagedSlotCache.create(
            cfg.num_layers, batch, self.max_seq, cfg.num_kv_heads, cfg.head_dim,
            page=page, num_pages=num_pages, device=self.device,
            dtype=self.kv_dtype or cfg.torch_dtype, mesh=self.model.mesh, sp=sp > 1)

    def admit_slot_paged(self, pcache: PagedSlotCache, slot: int, ids, rows,
                         kv_start: int, cow_src, cow_dst, cow_rows: int):
        """Admit one request into paged slot `slot`, reusing a cached
        prefix of `kv_start` tokens: only the n - kv_start uncached suffix
        tokens are computed.

        rows: [Hkv, max_pages] int32, the slot's whole table block
        (shared prefix pages + fresh writable pages, trash-padded).
        cow_src/cow_dst: [Hkv] page groups for the copy-on-write of a
        partially matched boundary page, whose first cow_rows rows are
        copied src -> dst before anything reads the slot's table.

        In order (the JAX `_paged_admit_fn`): install the table block,
        copy-on-write the boundary page (payload and scales), gather the
        prefix pages into a contiguous 1-row scratch cache, run
        forward_tokens over the suffix from offset kv_start, and scatter
        the suffix rows back into the slot's pages. The JAX program
        padded the suffix to a bucket so that its compiled programs
        could be reused (and sent the pad rows to the trash page); the
        port runs the exact suffix, so nothing is padded. Returns
        (next-token logits [V], pcache)."""
        ids = np.asarray(ids, np.int32).reshape(-1)
        n, m = len(ids), int(kv_start)
        if not 0 <= m < n:
            raise ValueError(f"kv_start {m} out of range for prompt {n} (the last "
                             "token is always recomputed)")
        if n > pcache.capacity:
            raise ValueError(f"prompt length {n} exceeds slot capacity "
                             f"{pcache.capacity}")
        rows = np.asarray(rows, np.int32)
        page = pcache.page
        self._install(pcache, slot, rows, cow_src, cow_dst, cow_rows)
        scratch = self._paged_scratch
        if scratch is None or scratch.capacity != pcache.capacity:
            scratch = self._paged_scratch = self.model.make_cache(
                1, pcache.capacity, dtype=self.kv_dtype)
        span = -(-m // page) * page               # the prefix's whole pages
        if pcache.sp > 1:
            return self._admit_sp(pcache, scratch, ids, rows, m, span)[0], pcache
        ranks = list(zip(pcache.parts(), scratch.parts()))
        hkv = rows.shape[0] // len(ranks)         # each rank's kv heads
        for r, (pc, sc) in enumerate(ranks):
            pre = self._h2d(rows[r * hkv:(r + 1) * hkv, :span // page], device=pc.table.device)
            bufs = list(zip(sc.k + sc.ks, sc.v + sc.vs))
            for (pk, pv), (sk, sv) in zip(_pools(pc), bufs if span else []):
                sk[0, :, :span] = pk[pre, 0].reshape((hkv, span) + sk.shape[3:])
                sv[0, :, :span] = pv[pre, 0].reshape((hkv, span) + sv.shape[3:])
        scratch.offset = m
        logits, _ = self.model.forward_tokens(self._h2d(ids[m:])[None], scratch,
                                              mode=self.prefill_backend,
                                              last_pos=(n - 1) - m)
        p = np.arange(m, n)
        for r, (pc, sc) in enumerate(ranks):
            dev = pc.table.device
            dest = self._h2d(rows[r * hkv:(r + 1) * hkv][:, p // page], device=dev)
            ri = self._h2d(p % page, device=dev)[None]
            for (pk, pv), (sk, sv) in zip(_pools(pc), zip(sc.k + sc.ks, sc.v + sc.vs)):
                pk[:, 0][dest, ri] = sk[0, :, m:n]
                pv[:, 0][dest, ri] = sv[0, :, m:n]
        return logits[0], pcache

    def install_slot_paged(self, pcache: PagedSlotCache, slot: int, rows, cow_src,
                           cow_dst, cow_rows: int) -> PagedSlotCache:
        """Chunk 0 of a chunked paged admission: install the slot's table
        block and copy-on-write the partly matched boundary page (payload
        and scales), the half of admit_slot_paged that runs before any
        forward; the suffix prefill is left to the mixed ticks, which write
        their KV through the table just installed. Same rows and cow
        contract as admit_slot_paged."""
        self._install(pcache, slot, np.asarray(rows, np.int32), cow_src, cow_dst, cow_rows)
        return pcache

    def _admit_sp(self, pcache: PagedSlotCache, scratch: KVCache, ids, rows, m: int,
                  span: int):
        """admit_slot_paged's gather, suffix forward and scatter on a
        sequence-parallel pool; returns the next-token logits [1, V]."""
        page = pcache.page
        n = len(ids)
        bufs = list(zip(scratch.k + scratch.ks, scratch.v + scratch.vs))
        if span:
            plan = self._sp_plan(pcache, rows[:, :span // page])
            for li, (sk, sv) in enumerate(bufs):
                gk, gv = self._pool_gather_sp(pcache, li, plan)
                sk[0, :, :span] = gk.reshape((gk.shape[0], span) + sk.shape[3:])
                sv[0, :, :span] = gv.reshape((gv.shape[0], span) + sv.shape[3:])
        scratch.offset = m
        logits, _ = self.model.forward_tokens(self._h2d(ids[m:])[None], scratch,
                                              mode=self.prefill_backend,
                                              last_pos=(n - 1) - m)
        p = np.arange(m, n)
        plan = self._sp_plan(pcache, rows[:, p // page], p % page)
        for li, (sk, sv) in enumerate(bufs):
            self._pool_scatter_sp(pcache, li, plan, sk[0, :, m:n], sv[0, :, m:n])
        return logits

    def _sp_plan(self, pcache: PagedSlotCache, ids, ri=None):
        """Which rank moves which entries of `ids` (global page ids, a host
        array [H, P]), planned once for every layer: (the shape of ids,
        [(rank, the entries' (h, p) indices on rank 0's device, their local
        page ids on the rank's device, and with ri [P] their in-page rows
        there)] for the ranks that own any)."""
        pps = pcache.pages_per_shard
        ids = np.asarray(ids)
        out = []
        for s in np.unique(ids // pps):
            dev = pcache.parts()[int(s)].table.device
            hit = np.nonzero(ids // pps == s)
            rows = (None if ri is None else
                    self._h2d(np.broadcast_to(np.asarray(ri)[None], ids.shape)[hit], device=dev))
            out.append((int(s), tuple(self._h2d(h) for h in hit),
                        self._h2d(ids[hit] - s * pps, device=dev), rows))
        return ids.shape, out

    def _pool_gather_sp(self, pcache: PagedSlotCache, li: int, plan):
        """The pages of `plan` (_sp_plan) of layer li's pools, assembled
        from their owners on rank 0's device: (k, v) [H, P, page(, d)] (the
        scale pools when li counts past the payload's layers)."""
        parts = pcache.parts()
        shape, moves = plan
        out = [torch.empty(shape + t.shape[2:], dtype=t.dtype, device=self.device)
               for t in _pools(parts[0])[li]]
        for s, at, loc, _ in moves:
            for o, pool in zip(out, _pools(parts[s])[li]):
                o[at] = pool[loc, 0].to(self.device)
        return out

    def _pool_scatter_sp(self, pcache: PagedSlotCache, li: int, plan, k, v) -> None:
        """Rows k, v [H, S(, d)] (on rank 0's device) into layer li's pools
        at the pages and in-page rows of `plan` (_sp_plan with ri), each
        row by the rank that owns its page."""
        parts = pcache.parts()
        for s, at, loc, rows in plan[1]:
            dev = parts[s].table.device
            for pool, new in zip(_pools(parts[s])[li], (k, v)):
                pool[:, 0][loc, rows] = new[at].to(dev)

    def _cow_pages_sp(self, pcache: PagedSlotCache, cow_src, cow_dst, cow_rows: int) -> None:
        """The boundary-page copy-on-write on a sequence-parallel pool:
        rows [0, cow_rows) of the pages cow_src into cow_dst ([Hkv] global
        ids), every layer; source and destination may live on different
        ranks (one gather, one scatter)."""
        src = self._sp_plan(pcache, np.asarray(cow_src)[:, None])
        dest = self._sp_plan(pcache, np.repeat(np.asarray(cow_dst)[:, None], cow_rows, axis=1),
                             np.arange(cow_rows))
        for li in range(len(_pools(pcache.parts()[0]))):
            gk, gv = self._pool_gather_sp(pcache, li, src)
            self._pool_scatter_sp(pcache, li, dest, gk[:, 0, :cow_rows], gv[:, 0, :cow_rows])

    def _install(self, pcache: PagedSlotCache, slot: int, rows, cow_src, cow_dst,
                 cow_rows: int) -> None:
        """Write the slot's table block and run the boundary-page
        copy-on-write, on every rank: rank r's table rows and pools take
        its kv heads' share of rows, cow_src and cow_dst (at sp, every
        rank's table takes the whole block)."""
        if pcache.sp > 1:
            hkv = rows.shape[0]
            for t in pcache.device_tables():
                t[slot * hkv:(slot + 1) * hkv] = self._h2d(rows, torch.int32, t.device)
            if cow_rows:
                self._cow_pages_sp(pcache, cow_src, cow_dst, cow_rows)
            return
        parts = pcache.parts()
        hkv = rows.shape[0] // len(parts)
        for r, pc in enumerate(parts):
            dev = pc.table.device
            pc.table[slot * hkv:(slot + 1) * hkv] = self._h2d(
                rows[r * hkv:(r + 1) * hkv], torch.int32, dev)
            if cow_rows:
                heads = slice(r * hkv, (r + 1) * hkv)
                src = self._h2d(np.asarray(cow_src)[heads], device=dev)
                dst = self._h2d(np.asarray(cow_dst)[heads], device=dev)
                for pk, pv in _pools(pc):
                    pk[dst, :, :cow_rows] = pk[src, :, :cow_rows]
                    pv[dst, :, :cow_rows] = pv[src, :, :cow_rows]

    def paged_slot_chunk(self, logits, pcache: PagedSlotCache, pos, active, *,
                         chunk: int):
        """slot_chunk over the paged pool: the same contract, with each
        row's KV write and attention resolved through the page table (a
        retired row's table maps the trash page, so its masked-out writes
        can never touch a live or cached page). On backend "mega" each
        step runs one MegaPagedDecodeLayer launch per layer."""
        if self.backend == "mega":
            return _paged_slot_mega_scan_fn(self, logits, pcache, pos, active,
                                            gen_len=chunk)
        self._count_dispatch()
        return _slot_scan_decode_fn(
            self.model.forward_tokens_slots_paged, self.backend, logits, pcache, pos,
            active, cap=pcache.capacity, gen_len=chunk, load=self._load0())

    # ------------------------------------------------------------------
    # window programs: speculative verify and the chunked-prefill mixed
    # ticks, one [B, S] window forward each (the JAX engine's slot_verify,
    # slot_mixed and their paged and _verify twins)
    # ------------------------------------------------------------------

    def _window(self, tokens, q_lens, prefilling=None):
        """The host window arrays on the device: tokens [B, S] long, q_lens
        [B] int32 (and the prefilling mask [B] bool). Counts the window
        program's dispatch."""
        self._one_rank("the window programs (spec, prefill_budget)")
        self._count_dispatch()
        out = (self._h2d(tokens), self._h2d(q_lens, torch.int32))
        return out if prefilling is None else out + (self._h2d(prefilling, torch.bool),)

    def _refuse_mega(self, what: str) -> None:
        if self.backend == "mega":
            raise ValueError(
                f"backend='mega' does not fuse {what} (the fused tick is the greedy "
                "S == 1 paged step); serve it on the per-op backends")

    def _forwards(self, paged: bool):
        """(the window forward, its capacity getter) of the slot cache or
        the paged pool."""
        if paged:
            return self.model.forward_tokens_slots_paged_verify, lambda c: c.capacity
        return self.model.forward_tokens_slots_verify, lambda c: c.capacity

    def slot_verify_chunk(self, cache: KVCache, pos, active, tokens, q_lens):
        """One speculative verify step over the contiguous slot cache:
        score every slot's window (tokens [B, S]: the pending seed at column
        0, up to S - 1 drafts after, padded; q_lens [B] valid lengths; host
        arrays) in one forward at per-slot positions pos, keep each slot's
        longest argmax-matching prefix, and advance each slot by its kept
        count (the rejected suffix stays as dead rows past the rewound
        length). Returns (n_emit [B], t0_next [B] the next seed, cache, pos)
        on the device, and a MoE model's routing load fifth."""
        self._refuse_mega("the spec-decode verify window")
        return self._verify(False, cache, pos, active, *self._window(tokens, q_lens))

    def paged_slot_verify_chunk(self, pcache: PagedSlotCache, pos, active, tokens, q_lens):
        """slot_verify_chunk over the paged pool (window KV and attention
        through the page table; padding rows write nothing)."""
        self._refuse_mega("the spec-decode verify window")
        return self._verify(True, pcache, pos, active, *self._window(tokens, q_lens))

    def _verify(self, paged: bool, cache, pos, active, tokens, q_lens):
        forward, cap = self._forwards(paged)
        logits_all, cache, load = _verify_forward(forward, self.prefill_backend, cache, pos,
                                                  tokens, q_lens, self.moe_family)
        n_emit, t0n, pos = _verify_accept(logits_all, tokens, q_lens, active, pos, cap(cache))
        out = (n_emit, t0n, cache, pos)
        return out if load is None else out + (load,)

    def slot_mixed_chunk(self, logits, cache: KVCache, pos, active, prefilling, tokens,
                         q_lens):
        """One mixed prefill+decode tick over the contiguous slot cache
        (chunked prefill). tokens [B, S] / q_lens [B] (host arrays): a
        prefilling row (prefilling [B] bool) holds its next q_lens[b] prompt
        tokens at positions pos[b] .. (q_lens[b] == 0: starved this tick);
        a decode row's column 0 is its carry logits' argmax, filled here
        (one step of the plain slot scan), with q_lens[b] == 1. Returns
        (tok [B] int32, each decode row's token; sel_logits [B, V], the
        logits at each row's last valid window position: a decode row's
        next carry, a final-chunk prefill row's arming logits; cache; pos,
        advanced by q_lens for prefill rows and 1 for active decode rows),
        and a MoE model's routing load fifth."""
        if self.backend == "mega":
            raise ValueError(
                "backend='mega' fuses the PAGED decode tick only; contiguous mixed ticks "
                "run the per-op backends (the paged mixed tick runs the per-op program)")
        return self._mixed(False, logits, cache, pos, active,
                           *self._window(tokens, q_lens, prefilling))

    def paged_slot_mixed_chunk(self, logits, pcache: PagedSlotCache, pos, active,
                               prefilling, tokens, q_lens):
        """slot_mixed_chunk over the paged pool; on "mega" it runs the
        per-op "flash" program."""
        return self._mixed(True, logits, pcache, pos, active,
                           *self._window(tokens, q_lens, prefilling))

    def _mixed(self, paged: bool, logits0, cache, pos, active, tokens, q_lens, prefilling):
        forward, cap = self._forwards(paged)
        tok = torch.where(active, sample_greedy(logits0), 0)
        tokens = tokens.clone()
        tokens[:, 0] = torch.where(active, tok, tokens[:, 0])
        logits_all, cache, load = _verify_forward(forward, self.prefill_backend, cache, pos,
                                                  tokens, q_lens, self.moe_family)
        adv = torch.where(prefilling, q_lens, active.to(torch.int32))
        pos = torch.clamp(pos + adv, max=cap(cache) - 1)
        out = (tok.to(torch.int32), _last_valid(logits_all, q_lens), cache, pos)
        return out if load is None else out + (load,)

    def slot_mixed_verify_chunk(self, cache: KVCache, pos, active, prefilling, tokens,
                                q_lens):
        """Spec-mode mixed tick over the contiguous slot cache: decode rows
        carry their draft windows (slot_verify_chunk's contract), prefill
        rows their prompt chunks, in one forward; acceptance applies to the
        decode rows, prefill rows advance by their whole chunk. Returns
        (n_emit [B], t0_next [B], sel_logits [B, V] the arming logits at each
        row's last valid position, cache, pos), and a MoE model's routing
        load sixth."""
        self._refuse_mega("the spec-decode verify window")
        return self._mixed_verify(False, cache, pos, active,
                                  *self._window(tokens, q_lens, prefilling))

    def paged_slot_mixed_verify_chunk(self, pcache: PagedSlotCache, pos, active,
                                      prefilling, tokens, q_lens):
        """slot_mixed_verify_chunk over the paged pool."""
        return self._mixed_verify(True, pcache, pos, active,
                                  *self._window(tokens, q_lens, prefilling))

    def _mixed_verify(self, paged: bool, cache, pos, active, tokens, q_lens, prefilling):
        forward, cap = self._forwards(paged)
        logits_all, cache, load = _verify_forward(forward, self.prefill_backend, cache, pos,
                                                  tokens, q_lens, self.moe_family)
        n_emit, t0n, pos = _verify_accept(logits_all, tokens, q_lens, active, pos, cap(cache))
        pos = torch.clamp(pos + torch.where(prefilling, q_lens, 0), max=cap(cache) - 1)
        out = (n_emit, t0n, _last_valid(logits_all, q_lens), cache, pos)
        return out if load is None else out + (load,)

    def retire_slot_paged(self, pcache: PagedSlotCache, slot: int) -> PagedSlotCache:
        """Point the whole table block of a retired slot at the trash page
        (the write sink): the slot scan keeps stepping masked rows, and
        their writes must never land on a page the allocator may hand to
        someone else. A fill on the device, no host copy."""
        if pcache.sp > 1:
            hkv = self.model.config.num_kv_heads
            for t in pcache.device_tables():
                t[slot * hkv:(slot + 1) * hkv] = pcache.trash
            return pcache
        hkv = self.model.config.num_kv_heads // len(pcache.parts())
        for pc in pcache.parts():
            pc.table[slot * hkv:(slot + 1) * hkv] = pcache.trash
        return pcache


def _pools(pcache: PagedSlotCache) -> list:
    """(k, v) pairs of every layer's payload pools, then the int8 scale
    pools."""
    return list(zip(pcache.pages_k + pcache.scales_k, pcache.pages_v + pcache.scales_v))


def _verify_forward(forward, backend, cache, pos, tokens, q_lens, moe: bool):
    """The window forward of the verify and mixed programs: (per-position
    logits [B, S, V], cache, the routing load of a MoE model or None)."""
    if moe:
        return forward(tokens, cache, pos, q_lens, mode=backend, return_moe_stats=True)
    logits_all, cache = forward(tokens, cache, pos, q_lens, mode=backend)
    return logits_all, cache, None


def _verify_accept(logits_all, tokens, q_lens, active, pos, cap: int):
    """The greedy acceptance epilogue (the JAX `_verify_accept`): the
    longest argmax-matching prefix and the corrected next seed; inactive
    slots report n_emit == 0; pos advances by the kept count, clamped to
    the capacity. Returns (n_emit, t0_next, pos)."""
    n_emit, t0n = accept_greedy(tokens, sample_greedy(logits_all), q_lens)
    n_emit = n_emit * active.to(torch.int32)
    return n_emit, t0n, torch.clamp(pos + n_emit, max=cap - 1)


def _last_valid(logits_all, q_lens):
    """Each row's logits [B, V] at its last valid window position (position
    0 for a row with q_len 0)."""
    sel = torch.clamp(q_lens - 1, min=0).long()
    return logits_all[torch.arange(sel.shape[0], device=sel.device), sel]


def _check_ep(model, backend: str) -> None:
    """The construction refusals of the expert-parallel backends (the JAX
    engine's)."""
    if not model.config.is_moe:
        raise ValueError(
            f"backend={backend!r} routes the FFN through the EP dispatch/combine kernels; "
            f"{type(model).__name__} has no routed experts (missing capability: "
            "expert-parallel FFN); dense models serve on 'flash'/'dist'/'ar'/'gemm_ar'")
    if getattr(model, "moe_impl", None) != "ep":
        raise ValueError(
            f"backend={backend!r} needs an expert-SHARDED model (moe_impl='ep'); this "
            f"Qwen3MoE was built moe_impl={model.moe_impl!r}; TP-MoE serves its "
            "grouped-GEMM dispatch on 'flash'")


def _check_sp(model, backend: str, tp: int, sp: int) -> None:
    """The construction refusals of sequence-parallel serving (the JAX
    engine's)."""
    if tp > 1:
        raise ValueError(
            f"sequence-parallel serving (sp size {sp}) cannot combine with a TP head-group "
            f"split (size {tp}) yet (missing capability: sp + TP hybrid paged pool); size "
            "one of the axes to 1")
    if backend == "mega":
        raise ValueError(
            "backend='mega' fuses the paged tick single-chip only; the sp-sharded pool's "
            "split-KV partial + cross-chip LSE combine stay on the per-op path (missing "
            "capability: megakernel sp combine); serve sp meshes with backend='flash'")
    if backend != "flash":
        raise ValueError(
            f"backend={backend!r} routes projections through the TP comm kernels; "
            "sequence-parallel serving replicates weights over the sp axis and serves on "
            "backend='flash' (missing capability: sp + comm-kernel hybrid projections)")


def _check_mega(model, kv_dtype, sampling: str, tp: int) -> None:
    """The construction refusals of backend "mega" (the JAX engine's)."""
    if sampling != "greedy":
        raise ValueError(
            "backend='mega' serves GREEDY streams only (the fused tick and the "
            "decode loop carry the argmax token)")
    if model.config.is_moe:
        raise ValueError(
            "backend='mega' fuses dense (attention + MLP) decode layers only "
            "(missing capability: megakernel routed-expert FFN) - MoE models serve "
            "their grouped-GEMM tick on backend='flash'")
    if model.layers and isinstance(_rank_layers(model, 0)[0][0].w_qkv, QuantW):
        raise ValueError(
            "backend='mega' takes raw bf16 weight panels and has no weight "
            "dequant path; int8-weight models run on the other backends (int8 "
            "paged KV is fine: the fused tick dequantizes the pool in-kernel)")
    if kv_dtype is not None and kv_dtype != torch.int8:
        raise ValueError(
            f"backend='mega' supports kv_dtype=None (pool dtype) or torch.int8 "
            f"(in-kernel scale-plane dequant), not {kv_dtype}")
    cfg = model.config
    if tp > 1 and (cfg.num_heads % tp or cfg.num_kv_heads % tp
                   or cfg.intermediate_size % tp):
        raise ValueError(
            "backend='mega' TP needs heads/kv-heads/ffn divisible by the mesh size "
            f"(heads {cfg.num_heads}, kv heads {cfg.num_kv_heads}, intermediate_size "
            f"{cfg.intermediate_size} over {tp} ranks; single-chip decode has no such "
            "constraint)")


def _rank_layers(model, r: int) -> list:
    """Rank r's (attention, MLP, ln_attn, ln_mlp) of every layer: the
    layers themselves at one rank, else their rank-r shards (to_mesh's
    [q_r | k_r | v_r] and [gate_r | up_r] column blocks, w_o's and
    w_down's row blocks) and norm copies."""
    if getattr(model, "tp", 1) == 1:
        return [(ly.attn, ly.mlp, ly.ln_attn, ly.ln_mlp) for ly in model.layers]
    return [(ly.attn.shards[r], ly.mlp.shards[r], ly.ln_attn[r], ly.ln_mlp[r])
            for ly in model.layers]


def _mega_setup(eng: Engine):
    """The per-layer weight dicts of the megakernel, built once per
    Engine: norms in f32 ([1, n]), absent QK-norms as ones, the packed
    bf16 panels as they are (a model of another dtype is cast once). At
    tp > 1 one list of them a rank, from the rank's shards on its device:
    to_mesh's shards are already the JAX engine's contiguous column and
    row split of the packed weights (`_mega_scan_decode_fn`), so nothing
    is repacked."""
    if eng._mega is None:
        model = eng.model
        hd = model.config.head_dim
        bf = torch.bfloat16
        devices = model.mesh.devices if eng.tp > 1 else [eng.device]

        def norm(w, ones):
            return ones if w is None else w.reshape(1, -1).float().contiguous()

        def rank(r, dev):
            ones = torch.ones((1, hd), dtype=torch.float32, device=dev)
            return [dict(
                w_ln1=norm(ln1, ones), w_qkv=attn.w_qkv.to(bf).contiguous(),
                q_norm=norm(attn.q_norm, ones), k_norm=norm(attn.k_norm, ones),
                w_o=attn.w_o.to(bf).contiguous(), w_ln2=norm(ln2, ones),
                w_gu=mlp.w_gate_up.to(bf).contiguous(),
                w_d=mlp.w_down.to(bf).contiguous())
                for attn, mlp, ln1, ln2 in _rank_layers(model, r)]

        eng._mega = [rank(r, d) for r, d in enumerate(devices)]
    return eng._mega


def _mega_geometry(model, tp: int = 1) -> dict:
    """The layer geometry: at tp > 1 one rank's shard (as the JAX
    engine builds its TP MegaDecodeLayer)."""
    cfg = model.config
    return dict(d_model=cfg.hidden_size, n_heads=cfg.num_heads // tp,
                n_kv_heads=cfg.num_kv_heads // tp, head_dim=cfg.head_dim,
                ffn=cfg.intermediate_size // tp, eps=cfg.rms_norm_eps,
                qk_norm=_rank_layers(model, 0)[0][0].q_norm is not None)


def _mega_logits(model, x):
    """Final RMSNorm of the f32 residual stream and the lm_head product
    (f32 logits), outside the kernels."""
    cfg = model.config
    xf = rms_norm(x, model.final_norm.float(), cfg.rms_norm_eps)
    head = model.lm_head
    return qmm(xf.to(head.dtype), head, out_dtype=torch.float32)


def _mega_scan_decode_fn(eng: Engine, logits0, cache: KVCache, *, gen_len: int):
    """Megakernel decode loop (the JAX `_mega_scan_decode_fn`): per step
    the argmax of the previous logits, the f32 embedding row, the RoPE
    rows of the shared position, one MegaDecodeLayer launch per layer
    (per device at tp > 1) over the cache in its own [B, Hkv, T, hd]
    layout (in place; the cache stays valid and its offset advances),
    then the head."""
    logits, toks = logits0, []
    for _ in range(gen_len):
        tok = sample_greedy(logits)
        logits = _mega_step(eng, tok, cache)
        toks.append(tok)
    return torch.stack(toks, dim=1).to(torch.int32), logits, cache


def _mega_step(eng: Engine, tok, cache: KVCache):
    """One step of _mega_scan_decode_fn fed tokens tok [B]. At tp > 1 the
    embedding row is taken on rank 0 and replicated to every rank, each
    layer is one TP launch over every rank's weights and cache heads
    (cache.ranks), and the head runs on rank 0's y (every rank's is the
    same)."""
    model = eng.model
    weights = _mega_setup(eng)
    T = cache.capacity
    layer = eng._mega_layer
    if layer is None or layer.T != T:
        layer = eng._mega_layer = MegaDecodeLayer(
            T=T, tp=eng.tp, mesh=model.mesh if eng.tp > 1 else None,
            **_mega_geometry(model, eng.tp))
    x = model.embed[tok].float()
    pos = cache.offset
    if eng.tp > 1:
        xs = model.mesh.replicate(x)
        ropes = [dict(cos_row=c[pos:pos + 1], sin_row=s_[pos:pos + 1])
                 for c, s_ in model.rope]
        parts = cache.ranks
        for li in range(len(model.layers)):
            xs, _, _ = layer(xs, pos, [dict(w[li], **rp) for w, rp in zip(weights, ropes)],
                             [c.k[li] for c in parts], [c.v[li] for c in parts])
        x = xs[0]
    else:
        rope = dict(cos_row=model.cos[pos:pos + 1], sin_row=model.sin[pos:pos + 1])
        for li, w in enumerate(weights[0]):
            x, _, _ = layer(x, pos, dict(w, **rope), cache.k[li], cache.v[li])
    cache.advance(1)
    return _mega_logits(model, x)


def _paged_slot_mega_scan_fn(eng: Engine, logits0, pcache: PagedSlotCache, pos, active,
                             *, gen_len: int):
    """The fused paged greedy tick (the JAX `_paged_slot_mega_scan_fn`):
    paged_slot_chunk's contract and masking (inactive rows feed token 0,
    positions clamp at min(pos + active, cap - 1)) with one
    MegaPagedDecodeLayer launch per layer per step; the RoPE rows are
    gathered at each slot's own position."""
    model = eng.model
    weights = _mega_setup(eng)
    maxp = pcache.table.shape[1]
    layer = eng._mega_paged_layer
    if layer is None or (layer.page, layer.maxp) != (pcache.page, maxp):
        layer = eng._mega_paged_layer = MegaPagedDecodeLayer(
            page=pcache.page, maxp=maxp, **_mega_geometry(model))
    act = active.to(torch.int32)
    cap = pcache.capacity
    logits, toks = logits0, []
    for _ in range(gen_len):
        tok = torch.where(active, sample_greedy(logits), 0)
        x = model.embed[tok].float()
        p = pos.long()
        rope = dict(cos_row=model.cos[p], sin_row=model.sin[p])
        for li, w in enumerate(weights[0]):
            x = layer(x, pos, dict(w, **rope), *pcache.layer(li)[:2], pcache.table,
                      *pcache.layer(li)[2:])[0]
        logits = _mega_logits(model, x)
        pos = torch.clamp(pos + act, max=cap - 1)
        toks.append(tok)
    return torch.stack(toks, dim=1).to(torch.int32), logits, pcache, pos


def _prefill_fn(model, ids, cache, *, mode):
    return model.forward_tokens(ids, cache, mode=mode)


def _slot_scan_decode_fn(forward, backend, logits0, cache, pos, active, *,
                         cap: int, gen_len: int, load=None):
    """Slot-masked greedy decode chunk over a slot cache or the paged pool
    (the JAX `_slot_scan_decode_fn` and `_paged_slot_scan_decode_fn`,
    which differ only in the forward): inactive rows still step (feeding
    token 0), and positions clamp at min(pos + active, cap - 1) so a slot
    that finished mid-chunk keeps its surplus writes inside its own row
    or reserved pages. A MoE model passes its zeroed routing-load vector
    as `load`: each step adds its load, and the sum comes back last."""
    act = active.to(torch.int32)
    toks = []
    logits = logits0
    for _ in range(gen_len):
        tok = torch.where(active, sample_greedy(logits), 0)
        if load is None:
            logits, cache = forward(tok[:, None], cache, pos, mode=backend)
        else:
            logits, cache, st = forward(tok[:, None], cache, pos, mode=backend,
                                        return_moe_stats=True)
            load = load + st
        pos = torch.clamp(pos + act, max=cap - 1)
        toks.append(tok)
    out = (torch.stack(toks, dim=1).to(torch.int32), logits, cache, pos)
    return out if load is None else out + (load,)


def _scan_decode_fn(backend, model, logits0, cache, *, gen_len: int):
    """Step t takes the argmax of the previous logits (the first from the
    prefill's) and feeds it through forward_tokens."""
    logits, toks = logits0, []
    for _ in range(gen_len):
        tok = sample_greedy(logits)
        logits, cache = model.forward_tokens(tok[:, None], cache, mode=backend)
        toks.append(tok)
    return torch.stack(toks, dim=1).to(torch.int32), logits, cache
