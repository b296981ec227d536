"""Attention block (GQA, Qwen3 QK-norm) with the KV cache.

Counterpart of triton_dist_tpu/layers/tp_attn.py (`TP_Attn.init`,
`_qkv_proj`, `_attend_cached`, `_o_proj`, `fwd_cached`, the
continuous-batching forms `_attend_cached_slots`/`fwd_cached_slots`
and `_attend_paged_slots`/`fwd_cached_slots_paged`, their window forms
`_attend_cached_slots_verify`/`fwd_cached_slots_verify` and
`_attend_paged_slots_verify`/`fwd_cached_slots_paged_verify`
(speculative verify and chunked prefill), and the training
forms `_local_attn_train`/`fwd_train`), for the modes "flash" (the CUDA
kernels), "xla" (the plain PyTorch versions, the JAX package's oracle
mode), "ar" (the partial O projection, then the all_reduce kernel),
"gemm_ar" (the gemm_allreduce kernel) and "dist" (the JAX `fwd_dist`
projections: QKV through ag_gemm, O through gemm_rs). The
packed weight layout is kept: w_qkv is [D, (Hq + 2*Hkv) * hd] = [q | k |
v].

Tensor parallelism (`to_mesh`, or `init(..., mesh=)`): over a mesh of n
ranks (runtime/bootstrap.py) the layer holds `shards`, one TP_Attn per
rank with its Hq/n query and Hkv/n kv heads (its block of the packed
[q_r | k_r | v_r] columns, its rows of w_o) on the rank's device, and
the forwards take and return lists, one tensor per rank: x replicated
(row-sharded on "dist"), the caches, rope tables and positions per rank.
Each rank's projection and attention run between the collectives; the
O projection ends in the mode's epilogue (`tp_down`): "ar" all_reduce,
"gemm_ar" gemm_allreduce, "flash"/"xla" a psum whose counterpart is
`all_reduce_ref` (XLA's psum is no Pallas kernel). On "dist" the QKV
projection is one ag_gemm over the ranks' row shards (`tp_up`), so every
rank attends its heads over all rows, and the O projection one gemm_rs
back to row shards. The JAX "dist" forward takes B*S divisible by n; the
model pads its rows to a multiple of n with zero rows instead
(models/dense.py `_tp_stack`): the attention and the KV writes take only
the first `rows` rows of ag_gemm's output, and the O projection pads its
input back with zero rows before gemm_rs. Only the loop over the ranks'
collective launches is inside one call, so every rank's launch of a
collective is enqueued back to back. The window and training forms stay
at one rank. The KV
cache tensors and page pools are updated in place; the per-row writes
of the slot forms are plain torch indexing, as the JAX `.at[].set`
was plain jnp. The JAX window forms scatter their padding rows out of
bounds, where XLA drops them; torch has no dropping scatter, so a
padding row writes back the value already held at a position no valid
row of its slot writes in that call (`_window_positions`), never at a
clamped index, which could race a valid write to the last position.

Sequence parallelism (`_attend_paged_slots_sp`, `fwd_cached_slots_paged_sp`,
`fwd_cached_slots_paged_verify_sp`; the JAX layer's SP attend): the model
runs the one-rank layer once per distinct device of its sp mesh (on one
card once for all four ranks, the weights shared), and only the paged
attention is split. Each rank writes the new rows of the pages it owns
into its block of the pool (the others into its sink page,
models/kv_cache.py), walks the logical pages it owns through its local
table with flash_decode_paged_partial (row 4's partial form), and the
ranks' partials merge in kernels/sp_flash_decode.py sp_combine_partials
("xla", or "dist": the lse_combine kernel). The per-rank table, ownership
mask and write destinations depend only on the table and the positions,
so `sp_paged_context` builds them once per forward for every layer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from triton_dist_tpu_torch.kernels.allgather_gemm import ag_gemm
from triton_dist_tpu_torch.kernels.allreduce import all_reduce, all_reduce_ref
from triton_dist_tpu_torch.kernels.flash_attn import (flash_decode,
                                                      flash_decode_ref,
                                                      kv_update, kv_update_ref)
from triton_dist_tpu_torch.kernels.flash_attn_train import (flash_attention,
                                                            flash_attention_ref)
from triton_dist_tpu_torch.kernels.gemm_allreduce import gemm_allreduce
from triton_dist_tpu_torch.kernels.gemm_reduce_scatter import gemm_rs
from triton_dist_tpu_torch.kernels.grad import ag_gemm_grad, gemm_rs_grad
from triton_dist_tpu_torch.kernels.paged_kv import (flash_decode_paged,
                                                   flash_decode_paged_partial,
                                                   flash_decode_paged_partial_ref,
                                                   flash_decode_paged_ref)
from triton_dist_tpu_torch.kernels.quant import Weight, qmm, quantize_kv_int8
from triton_dist_tpu_torch.layers.common import (apply_rope, apply_rope_slots,
                                                 rms_norm, shard_cols_packed, split_packed,
                                                 split_rows, weight_to)
from triton_dist_tpu_torch.runtime.bootstrap import mesh_of

MODES = ("flash", "xla", "ar", "gemm_ar", "dist")


def check_mode(mode: str) -> None:
    if mode not in MODES:
        raise NotImplementedError(
            f"forward mode {mode!r}: not yet ported (the port runs {MODES})")


def tp_up(mode: str, xs, ws, mesh) -> list:
    """The column-parallel up projection of every rank: "dist" one ag_gemm
    of the row shards xs (each rank's result has every rank's rows),
    every other mode each rank's xs[r] @ ws[r] on its replicated rows."""
    if mode == "dist":
        return ag_gemm(xs, ws, mesh=mesh)
    return [qmm(x, w) for x, w in zip(xs, ws)]


def tp_down(mode: str, hs, ws, mesh) -> list:
    """The row-parallel down projection of every rank (hs[r] @ ws[r]) and
    its epilogue: the JAX `_o_proj`/`_down_psum` and the MLPs'
    fwd_dist/fwd_ar/fwd_gemm_ar/psum. "dist": one gemm_rs, each rank
    keeping its row shard of the sum; replicated otherwise: "gemm_ar" one
    gemm_allreduce; "ar" the partials, then all_reduce; "flash"/"xla" the
    partials, then the psum's plain version (all_reduce_ref, the
    one-shot order)."""
    if mode == "dist":
        return gemm_rs(hs, ws, mesh=mesh)
    if mode == "gemm_ar":
        return gemm_allreduce(hs, ws, mesh=mesh)
    parts = [qmm(h, w) for h, w in zip(hs, ws)]
    if mode == "ar":
        return all_reduce(parts, mesh=mesh)
    return all_reduce_ref(parts) if len(parts) > 1 else parts


def _one_rank(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} at tensor-parallel size > 1: not yet ported")


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
    # tensor parallelism: the mesh and one TP_Attn per rank (its heads, on
    # its device); the weight fields above are then None
    mesh: Optional[object] = None
    shards: Optional[list] = None

    @staticmethod
    def init(w_q, w_k, w_v, w_o, *, n_heads: int, n_kv_heads: int,
             head_dim: int, q_norm=None, k_norm=None, mesh=None) -> "TP_Attn":
        attn = TP_Attn(w_qkv=shard_cols_packed([w_q, w_k, w_v], 1), w_o=w_o,
                       q_norm=q_norm, k_norm=k_norm, n_heads=n_heads,
                       n_kv_heads=n_kv_heads, head_dim=head_dim)
        return attn if mesh is None or mesh.size == 1 else attn.to_mesh(mesh)

    @property
    def tp(self) -> int:
        return 1 if self.shards is None else len(self.shards)

    def to_mesh(self, mesh) -> "TP_Attn":
        """This one-rank layer split over `mesh`: rank r keeps query heads
        [r*Hq/n, (r+1)*Hq/n) and kv heads [r*Hkv/n, (r+1)*Hkv/n) (the
        JAX shard_cols_packed blocks of w_qkv, the matching rows of
        w_o), on its device."""
        n = mesh.size
        hq, hkv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        if hq % n or hkv % n:
            raise ValueError(
                f"tensor parallelism over {n} ranks needs n_heads ({hq}) and n_kv_heads "
                f"({hkv}) divisible by it: each rank holds whole kv heads (GQA "
                f"replication factor {hq // max(hkv, 1)})")
        qkv = split_packed(self.w_qkv, (hq * hd, hkv * hd, hkv * hd), n)
        wo = split_rows(self.w_o, n)
        shards = [TP_Attn(w_qkv=weight_to(qkv[r], d), w_o=weight_to(wo[r], d),
                          q_norm=None if self.q_norm is None else self.q_norm.to(d),
                          k_norm=None if self.k_norm is None else self.k_norm.to(d),
                          n_heads=hq // n, n_kv_heads=hkv // n, head_dim=hd)
                  for r, d in enumerate(mesh.devices)]
        return TP_Attn(w_qkv=None, w_o=None, q_norm=None, k_norm=None, n_heads=hq,
                       n_kv_heads=hkv, head_dim=hd, mesh=mesh, shards=shards)

    def _qkv_proj(self, x, mode: str = "flash", rows: Optional[int] = None):
        """The column-parallel QKV projection (tp_up): each rank's own
        heads. At one rank "dist" is ag_gemm's one-rank form (the GEMM
        kernel). At n > 1 on "dist", x holds the row shards and each rank
        keeps the first `rows` rows of the gathered product (the real
        ones; the rest pad to a multiple of n)."""
        if self.shards is None:
            return ag_gemm(x, self.w_qkv) if mode == "dist" else qmm(x, self.w_qkv)
        qkv = tp_up(mode, x, [s.w_qkv for s in self.shards], self.mesh)
        return [q[:rows] for q in qkv] if mode == "dist" else qkv

    def _o_proj(self, o, mode: str = "flash"):
        """The O projection and the mode's epilogue (tp_down); at one rank
        "flash"/"xla" are the plain product, "dist" gemm_rs's one-rank
        form (the GEMM kernel) and "ar"/"gemm_ar" run their collective
        over the one-rank mesh. At n > 1 on "dist" each rank's o is padded
        with zero rows to a multiple of n first (its row shards then match
        the residual stream's)."""
        if self.shards is None:
            if mode in ("ar", "gemm_ar"):
                return tp_down(mode, [o], [self.w_o], mesh_of(o.device))[0]
            return gemm_rs(o, self.w_o) if mode == "dist" else qmm(o, self.w_o)
        if mode == "dist":
            o = [F.pad(t, (0, 0, 0, -t.shape[0] % len(o))) for t in o]
        return tp_down(mode, o, [s.w_o for s in self.shards], self.mesh)

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
                   mode: str = "flash", rows: Optional[int] = None):
        """QKV projection -> cached attention -> O projection.
        x: [B*S, D] (on "dist" at n > 1 the row shards of B*S = `rows`
        rows padded to a multiple of n); kv: the layer's cache tuple
        (KVCache.layer). Returns (y [B*S, D], kv)."""
        check_mode(mode)
        impl = "ref" if mode == "xla" else "flash"
        qkv = self._qkv_proj(x, mode, rows)
        if self.shards is None:
            o, kv = self._attend_cached(qkv, cos, sin, batch, kv, kv_start, impl)
        else:
            o = [s._attend_cached(q, c, sn, batch, k, kv_start, impl)[0]
                 for s, q, c, sn, k in zip(self.shards, qkv, cos, sin, kv)]
        return self._o_proj(o, mode), kv

    def _window_qkv(self, qkv, cos, sin, batch: int, pos):
        """A window of S tokens per slot: split the packed rows, QK-norm,
        and RoPE slot b's rows at positions pos[b] .. pos[b] + S - 1.
        qkv: [B*S, qkv_cols]. Returns q [B, S, Hq, hd], k and v
        [B, S, Hkv, hd]."""
        hq, hkv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        S = qkv.shape[0] // batch
        q = qkv[:, :hq * hd].reshape(batch, S, hq, hd)
        k = qkv[:, hq * hd:(hq + hkv) * hd].reshape(batch, S, hkv, hd)
        v = qkv[:, (hq + hkv) * hd:].reshape(batch, S, hkv, hd)
        if self.q_norm is not None:
            q = rms_norm(q, self.q_norm)
        if self.k_norm is not None:
            k = rms_norm(k, self.k_norm)
        q = apply_rope_slots(q, cos, sin, pos)
        k = apply_rope_slots(k, cos, sin, pos)
        return q, k, v

    def _slot_qkv(self, qkv, cos, sin, pos):
        """One token per slot (_window_qkv at S = 1). qkv: [B, qkv_cols].
        Returns q [B, 1, Hq, hd], k and v [B, Hkv, hd]."""
        q, k, v = self._window_qkv(qkv, cos, sin, qkv.shape[0], pos)
        return q, k[:, 0], v[:, 0]

    def _attend_cached_slots(self, qkv, cos, sin, batch: int, kv, pos,
                             impl: str = "flash"):
        """Slot form of _attend_cached (continuous-batching decode, one
        token per row): row b writes its K/V at column pos[b] of ITS
        cache row (in place) and attends its own columns [0, pos[b]]
        through per-row lengths (flash_decode kv_lens). pos: [B] int32 on
        the cache's device. Returns (o [B, Hq*hd], kv)."""
        hq, hd = self.n_heads, self.head_dim
        scale = hd ** -0.5
        q, k, v = self._slot_qkv(qkv, cos, sin, pos)
        rows = torch.arange(batch, device=qkv.device)
        col = pos.long()
        lens = pos + 1
        if len(kv) == 4:
            ck, cv, ks, vs = kv
            k8, k_s = quantize_kv_int8(k)
            v8, v_s = quantize_kv_int8(v)
            ck[rows, :, col] = k8
            cv[rows, :, col] = v8
            ks[rows, :, col] = k_s
            vs[rows, :, col] = v_s
            if impl == "flash":
                o = flash_decode(q.to(torch.bfloat16), ck, cv, scale=scale,
                                 k_scale=ks, v_scale=vs, kv_lens=lens)
            else:
                o = flash_decode_ref(q.float(), ck, cv, scale=scale, k_scale=ks,
                                     v_scale=vs, kv_lens=lens)
            return o.reshape(batch, hq * hd).to(qkv.dtype), kv
        ck, cv = kv
        ck[rows, :, col] = k.to(ck.dtype)
        cv[rows, :, col] = v.to(cv.dtype)
        attend = flash_decode if impl == "flash" else flash_decode_ref
        o = attend(q.to(ck.dtype), ck, cv, scale=scale, kv_lens=lens)
        return o.reshape(batch, hq * hd), kv

    def _attend_paged_slots(self, qkv, cos, sin, batch: int, kv, table, pos,
                            impl: str = "flash"):
        """Paged form of _attend_cached_slots: row b's new K/V lands in
        the physical page its table rows map for position pos[b] (row
        pos[b] % page), and attention walks the pool through the table
        (flash_decode_paged; under impl "ref" its plain version, which
        gathers the pages and runs the contiguous plain attention, as the
        JAX oracle does). kv: one layer's pools (pages_k, pages_v)
        [NP, 1, page, hd], or with the int8 scale pools (.., scales_k,
        scales_v) [NP, 1, page]; table: [B*Hkv, max_pages] int32, shared
        by all layers. Retired rows map the trash page, so their writes
        land there. Returns (o [B, Hq*hd], kv)."""
        hq, hkv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        scale = hd ** -0.5
        quant = len(kv) == 4
        q, k, v = self._slot_qkv(qkv, cos, sin, pos)
        ck, cv = kv[0][:, 0], kv[1][:, 0]                    # plane 0 views
        page = ck.shape[1]
        X = batch * hkv
        pos_x = pos.long()[:, None].expand(batch, hkv).reshape(X)    # [X]
        pidx = table[torch.arange(X, device=qkv.device), pos_x // page].long()
        r = pos_x % page
        sk = sv = None
        if quant:
            sk, sv = kv[2][:, 0], kv[3][:, 0]
            k8, k_s = quantize_kv_int8(k.reshape(X, hd))
            v8, v_s = quantize_kv_int8(v.reshape(X, hd))
            ck[pidx, r] = k8
            cv[pidx, r] = v8
            sk[pidx, r] = k_s
            sv[pidx, r] = v_s
        else:
            ck[pidx, r] = k.reshape(X, hd).to(ck.dtype)
            cv[pidx, r] = v.reshape(X, hd).to(cv.dtype)
        lens = pos + 1
        if impl == "flash":
            o = flash_decode_paged(q.to(torch.bfloat16 if quant else ck.dtype), ck, cv,
                                   table, scale=scale, kv_lens=lens, k_scale=sk,
                                   v_scale=sv)
        else:
            o = flash_decode_paged_ref(q.float() if quant else q.to(ck.dtype), ck, cv,
                                       table, scale=scale, kv_lens=lens, k_scale=sk,
                                       v_scale=sv)
        return o.reshape(batch, hq * hd).to(qkv.dtype), kv

    def _attend_cached_slots_verify(self, qkv, cos, sin, batch: int, kv, pos, q_lens,
                                    impl: str = "flash"):
        """Window form of _attend_cached_slots (speculative verify and
        chunked prefill): slot b's q_lens[b] valid window rows sit at
        positions pos[b] .. pos[b] + q_lens[b] - 1 (RoPE-rotated there),
        write their K/V at those columns of the slot's cache row (in place;
        padding rows and rows past the capacity write nothing) and attend
        causally within the window (flash_decode q_lens). qkv: [B*S,
        qkv_cols]; pos, q_lens: [B] int32 on the cache's device. Returns
        (o [B*S, Hq*hd], kv)."""
        hq, hd = self.n_heads, self.head_dim
        q, k, v = self._window_qkv(qkv, cos, sin, batch, pos)
        S = q.shape[1]
        cols, valid = _window_positions(pos, q_lens, S, kv[0].shape[2])
        _write_window(kv, (torch.arange(batch, device=qkv.device)[:, None], slice(None),
                           cols), k, v, valid)
        attend = flash_decode if impl == "flash" else flash_decode_ref
        o = attend(_window_q(q, kv, impl), kv[0], kv[1], scale=hd ** -0.5,
                   kv_lens=pos + q_lens, q_lens=q_lens, **_scales(kv))
        return o.reshape(batch * S, hq * hd).to(qkv.dtype), kv

    def _attend_paged_slots_verify(self, qkv, cos, sin, batch: int, kv, table, pos,
                                   q_lens, impl: str = "flash"):
        """Paged form of _attend_cached_slots_verify: slot b's valid window
        rows land in the pages its table rows map for their positions
        (row p % page; int8 scales at the same (page, row)); padding rows
        and rows past the table write nothing, so they never touch a live
        or cached page. Attention walks the pool with per-slot kv_lens and
        q_lens (flash_decode_paged). kv: one layer's pools (plane 0 is
        used); table [B*Hkv, max_pages] int32. Returns (o [B*S, Hq*hd],
        kv)."""
        hq, hkv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        q, k, v = self._window_qkv(qkv, cos, sin, batch, pos)
        S = q.shape[1]
        planes = tuple(t[:, 0] for t in kv)                  # plane 0 views
        page = planes[0].shape[1]
        wpos, valid = _window_positions(pos, q_lens, S, table.shape[1] * page)
        streams = (torch.arange(batch, device=qkv.device) * hkv)[:, None, None] \
            + torch.arange(hkv, device=qkv.device)[None, None, :]        # [B, 1, Hkv]
        pidx = table[streams, (wpos // page)[:, :, None]].long()         # [B, S, Hkv]
        _write_window(planes, (pidx, (wpos % page)[:, :, None]), k, v, valid)
        attend = flash_decode_paged if impl == "flash" else flash_decode_paged_ref
        o = attend(_window_q(q, planes, impl), planes[0], planes[1], table,
                   scale=hd ** -0.5, kv_lens=pos + q_lens, q_lens=q_lens, **_scales(planes))
        return o.reshape(batch * S, hq * hd).to(qkv.dtype), kv

    def fwd_cached_slots(self, x, cos, sin, batch: int, kv, pos,
                         mode: str = "flash"):
        """Slot-masked decode attention block (continuous batching): one
        token per row, row b at its own position pos[b]. x: [B, D];
        kv: the layer's cache tuple. Returns (y [B, D], kv)."""
        check_mode(mode)
        impl = "ref" if mode == "xla" else "flash"
        qkv = self._qkv_proj(x, mode, batch)
        if self.shards is None:
            o, kv = self._attend_cached_slots(qkv, cos, sin, batch, kv, pos, impl)
        else:
            o = [s._attend_cached_slots(q, c, sn, batch, k, p, impl)[0]
                 for s, q, c, sn, k, p in zip(self.shards, qkv, cos, sin, kv, pos)]
        return self._o_proj(o, mode), kv

    def fwd_cached_slots_paged(self, x, cos, sin, batch: int, kv, table, pos,
                               mode: str = "flash"):
        """fwd_cached_slots over the paged pool: row b's cache is whatever
        pages its table rows map, possibly pages shared read-only with
        other slots' prefixes (decode only writes at pos[b], past any
        shared prefix). Returns (y [B, D], kv)."""
        check_mode(mode)
        impl = "ref" if mode == "xla" else "flash"
        qkv = self._qkv_proj(x, mode, batch)
        if self.shards is None:
            o, kv = self._attend_paged_slots(qkv, cos, sin, batch, kv, table, pos, impl)
        else:
            o = [s._attend_paged_slots(q, c, sn, batch, k, t, p, impl)[0]
                 for s, q, c, sn, k, t, p in zip(self.shards, qkv, cos, sin, kv, table, pos)]
        return self._o_proj(o, mode), kv

    def fwd_cached_slots_verify(self, x, cos, sin, batch: int, kv, pos, q_lens,
                                mode: str = "flash"):
        """Window attention block (speculative verify, chunked prefill): B
        slots x S window positions in one forward. x: [B*S, D]; pos,
        q_lens: [B] int32. Returns (y [B*S, D], kv)."""
        check_mode(mode)
        if self.shards is not None:
            raise _one_rank("the verify window attention")
        impl = "ref" if mode == "xla" else "flash"
        o, kv = self._attend_cached_slots_verify(self._qkv_proj(x, mode), cos, sin, batch,
                                                 kv, pos, q_lens, impl)
        return self._o_proj(o, mode), kv

    def fwd_cached_slots_paged_verify(self, x, cos, sin, batch: int, kv, table, pos,
                                      q_lens, mode: str = "flash"):
        """fwd_cached_slots_verify over the paged pool. Returns (y [B*S, D],
        kv)."""
        check_mode(mode)
        if self.shards is not None:
            raise _one_rank("the paged verify window attention")
        impl = "ref" if mode == "xla" else "flash"
        o, kv = self._attend_paged_slots_verify(self._qkv_proj(x, mode), cos, sin, batch,
                                                kv, table, pos, q_lens, impl)
        return self._o_proj(o, mode), kv

    def _attend_paged_slots_sp(self, qkv, cos, sin, batch: int, kv, ctx, mesh,
                               combine: str = "xla", impl: str = "flash", layers=None):
        """The sequence-parallel paged attend (the JAX
        `_attend_paged_slots_sp`). qkv, cos, sin: one per distinct device
        of `mesh` (its device groups, in order); kv: the layer's pools, one
        tuple per rank (its block, (pages_k, pages_v[, scales_k,
        scales_v])); ctx: sp_paged_context of this forward; layers: this
        layer's copy on each distinct device (default [self]). Returns (o per
        distinct device, [B*S, Hq*hd]), the pools updated in place."""
        from triton_dist_tpu_torch.kernels.sp_flash_decode import sp_combine_partials
        hq, hd = self.n_heads, self.head_dim
        quant = len(kv[0]) == 4
        M = qkv[0].shape[0]
        S = M // batch
        groups = mesh.device_groups()
        accs, ms, ls = [], [], []
        layers = layers or [self]
        for gi, (_, ranks) in enumerate(groups):
            q, k, v = layers[gi]._window_qkv(qkv[gi], cos[gi], sin[gi], batch,
                                             ctx[ranks[0]]["pos"])
            for rk in ranks:
                c = ctx[rk]
                planes = tuple(t[:, 0] for t in kv[rk])              # plane 0 views
                idx = (c["dest"], c["row"])
                if quant:
                    (k8, ks), (v8, vs) = quantize_kv_int8(k), quantize_kv_int8(v)
                    news = (k8, v8, ks, vs)
                else:
                    news = (k, v)
                for buf, new in zip(planes, news):
                    buf[idx] = new.reshape(c["dest"].shape + new.shape[3:]).to(buf.dtype)
                qd = (torch.bfloat16 if impl == "flash" else torch.float32) if quant \
                    else planes[0].dtype
                attend = (flash_decode_paged_partial if impl == "flash"
                          else flash_decode_paged_partial_ref)
                a, m_, l_ = attend(q.to(qd), planes[0], planes[1], c["table"],
                                   kv_lens=c["lens"], q_lens=c["q_lens"], tile_owned=c["owned"],
                                   scale=hd ** -0.5, **_scales(planes))
                accs.append(a)
                ms.append(m_)
                ls.append(l_)
        outs = sp_combine_partials(accs, ms, ls, mesh=mesh, combine=combine,
                                   out_dtype=torch.float32)
        return [outs[ranks[0]].reshape(M, hq * hd).to(qkv[gi].dtype)
                for gi, (_, ranks) in enumerate(groups)]

    def fwd_cached_slots_paged_sp(self, x, cos, sin, batch: int, kv, ctx, mesh,
                                  mode: str = "flash", combine: str = "xla", layers=None):
        """Slot-masked attention block over the sequence-parallel paged
        pool: fwd_cached_slots_paged's contract (with ctx's q_lens, its
        window form's: speculative verify, chunked prefill) with each rank
        walking only its pages and the partials merged across the mesh.
        x: one [B*S, D] per distinct device of `mesh`; layers: this layer's
        copy on each distinct device (default [self], one card). Returns
        (y per distinct device, kv)."""
        check_mode(mode)
        layers = layers or [self]
        impl = "ref" if mode == "xla" else "flash"
        qkv = [ly._qkv_proj(xd, mode) for ly, xd in zip(layers, x)]
        o = self._attend_paged_slots_sp(qkv, cos, sin, batch, kv, ctx, mesh, combine, impl,
                                        layers)
        return [ly._o_proj(od, mode) for ly, od in zip(layers, o)], kv

    # the window form is the same block: the windows ride in ctx
    fwd_cached_slots_paged_verify_sp = fwd_cached_slots_paged_sp

    def _local_attn_train(self, qkv, cos, sin, batch: int, impl: str = "flash"):
        """Full-causal attention for training: each of `batch` sequences of
        M // batch rows attends within itself, from position 0. qkv: [M,
        qkv_cols]; impl "flash" (the differentiable kernels) or "ref" (the
        plain oracle, flash_attention_ref). Returns o [M, Hq*hd]."""
        hq, hkv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        M = qkv.shape[0]
        S = M // batch
        q = qkv[:, :hq * hd].reshape(batch, S, hq, hd)
        k = qkv[:, hq * hd:(hq + hkv) * hd].reshape(batch, S, hkv, hd)
        v = qkv[:, (hq + hkv) * hd:].reshape(batch, S, hkv, hd)
        if self.q_norm is not None:
            q = rms_norm(q, self.q_norm)
        if self.k_norm is not None:
            k = rms_norm(k, self.k_norm)
        positions = torch.arange(S, device=qkv.device)
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
        attend = flash_attention if impl == "flash" else flash_attention_ref
        o = attend(q, k.transpose(1, 2), v.transpose(1, 2), scale=hd ** -0.5)
        return o.reshape(M, hq * hd)

    def fwd_train(self, x, cos, sin, batch: int, impl: str = "flash"):
        """Differentiable attention block for training (no KV cache).
        impl "flash": ag_gemm -> flash attention -> gemm_rs, each with its
        kernel backward (kernels/grad.py, flash_attn_train.py); "ref": the
        plain oracle (plain products and flash_attention_ref). x: [B*S,
        D]; returns [B*S, D]."""
        if self.shards is not None:
            raise _one_rank("the training attention")
        if impl == "flash":
            qkv = ag_gemm_grad()(x, self.w_qkv)
            return gemm_rs_grad()(self._local_attn_train(qkv, cos, sin, batch, "flash"),
                                  self.w_o)
        return self._local_attn_train(x @ self.w_qkv, cos, sin, batch, "ref") @ self.w_o


def sp_paged_context(mesh, pcache, pos, q_lens=None, S: int = 1) -> list:
    """Per rank of a sequence-parallel pool (models/kv_cache.py, sp > 1),
    what every layer's attend of one forward needs: its local table
    (global ids minus its block's first where it owns the page, else 0;
    never read there), its ownership mask `owned` [B*Hkv, max_pages]
    int32, the write destinations (`dest`, `row`) [B, S, Hkv] of the
    window's K/V rows (its local page where it owns the target, else its
    sink page pps; a padding row or a row past the table always the sink),
    and the slot positions, lengths and windows on its device. pos, q_lens:
    [B] int32 (q_lens None: the decode tick, S == 1)."""
    pps = pcache.pages_per_shard
    page, maxp = pcache.page, pcache.max_pages
    B = pos.shape[0]
    per_dev = {}
    out = []
    for me, (pc, dev) in enumerate(zip(pcache.parts(), mesh.devices)):
        if dev not in per_dev:
            p0 = pos.to(dev)
            ql = None if q_lens is None else q_lens.to(dev)
            wpos = p0.long()[:, None] + torch.arange(S, device=dev)[None]       # [B, S]
            valid = wpos < maxp * page
            if ql is not None:
                valid &= torch.arange(S, device=dev)[None] < ql.long()[:, None]
            Hkv = pc.table.shape[0] // B
            streams = (torch.arange(B, device=dev) * Hkv)[:, None, None] \
                + torch.arange(Hkv, device=dev)[None, None, :]
            pidx = pc.table[streams, (wpos.clamp(max=maxp * page - 1) // page)[:, :, None]]
            per_dev[dev] = dict(pos=p0, q_lens=ql, lens=p0 + (1 if ql is None else ql),
                                pidx=pidx.long(), valid=valid[:, :, None],
                                row=(wpos % page)[:, :, None].expand_as(pidx))
        d = per_dev[dev]
        owned = pc.table // pps == me
        mine = d["valid"] & (d["pidx"] // pps == me)
        out.append(dict(d, table=torch.where(owned, pc.table - me * pps, 0).to(torch.int32),
                        owned=owned.to(torch.int32),
                        dest=torch.where(mine, d["pidx"] - me * pps, pps)))
    return out


def _window_positions(pos, q_lens, S: int, cap: int):
    """Where a window's K/V rows write in a slot's `cap` positions:
    (positions [B, S] long, valid [B, S] bool). Row (b, s) is valid when
    s < q_lens[b] and p = pos[b] + s < cap, and writes at p. Any other row
    is given a position that no valid row of its slot writes in this call
    (one past the window, or the one before it when the window reaches
    cap; with S <= cap one of the two exists whenever a row is invalid),
    where _put_valid writes back what is already there."""
    if S > cap:
        raise ValueError(f"a window of {S} positions exceeds the slot's {cap}")
    p0, ql = pos.long()[:, None], q_lens.long()[:, None]
    p = p0 + torch.arange(S, device=pos.device)[None]
    valid = (p - p0 < ql) & (p < cap)
    hi = torch.clamp(p0 + ql, max=cap)
    spare = torch.where(hi < cap, hi, p0 - 1).clamp(min=0)
    return torch.where(valid, p, spare), valid


def _write_window(bufs, idx, k, v, valid) -> None:
    """Write a window's K/V rows [B, S, Hkv, hd] into (k, v) or, quantized
    per position, into (k, v, k scales, v scales) at idx where valid."""
    if len(bufs) == 4:
        (k8, ks), (v8, vs) = quantize_kv_int8(k), quantize_kv_int8(v)
        news = (k8, v8, ks, vs)
    else:
        news = (k, v)
    for buf, new in zip(bufs, news):
        _put_valid(buf, idx, new, valid)


def _window_q(q, bufs, impl: str):
    """The query in the attention's dtype: bf16 for the int8 kernel, f32
    for its plain version, else the cache's dtype."""
    if len(bufs) == 4:
        return q.to(torch.bfloat16) if impl == "flash" else q.float()
    return q.to(bufs[0].dtype)


def _scales(bufs) -> dict:
    return dict(k_scale=bufs[2], v_scale=bufs[3]) if len(bufs) == 4 else {}


def _put_valid(buf, idx, new, valid) -> None:
    """buf[idx] = new where valid[b, s], in place; elsewhere buf[idx] keeps
    its value (gathered before the write). new: [B, S, ...] matching
    buf[idx]."""
    keep = valid.reshape(valid.shape + (1,) * (new.dim() - 2))
    buf[idx] = torch.where(keep, new.to(buf.dtype), buf[idx])
