"""Tensor-parallel routed-expert MoE FFN (experts replicated, the
intermediate dimension split over the ranks).

Counterpart of triton_dist_tpu/layers/tp_moe.py (`TP_MoE.init`, `_cap`,
`_expert_mlp_sharded`, `_stats`, `fwd_xla`, `fwd_dist`, `fwd_fused`,
`fwd_fused_ar`, `fwd_local`, `__call__`). At one rank the layer holds the
router [D, E], the packed [E, D, 2I] = [gate | up] panel and [E, I, D];
over a mesh of n ranks (`to_mesh`, or `init(..., mesh=)`) rank r holds
the router, columns [r I/n, (r+1) I/n) of gate and up (the JAX per-rank
block [gate_r | up_r], here the pair of column blocks that
kernels/group_gemm.py takes) and those rows of w_down, as views of the
one-rank panels where the rank's device is theirs (four ranks emulated on
one card share one copy of the experts) and copies on the other devices.

Data flow of the kernel path at one rank, `fwd_local`:

    route (router product, f32 softmax, top-k, renormalise)
    group_tokens_by_expert -> x_e [E, cap, D]   (capacity-padded)
    grouped_gemm(x_e, w_gate_up)                (CUDA kernel)
    silu(gate) * up                             (plain, as in JAX)
    grouped_gemm(., w_down)                     (CUDA kernel)
    scatter_weighted -> [M, D]                  (top-k weighted combine)

Over n ranks each rank runs the two grouped GEMMs on its own columns and
rows (`_expert_mlp_sharded`, one partial [E, cap, D] a rank), and the
forms differ in where the rows live and how the partials meet:
- "flash", "ar", "gemm_ar" (`fwd_local`): the rows replicated, routed
  once, the partials summed in f32 in rank order and rounded (the JAX
  jnp.sum over the stacked partials), combined, replicated;
- "dist" (`fwd_dist`): row shards; all_gather, route and group the
  gathered rows, each rank's partial combined to token order and rounded,
  reduce_scatter back to row shards;
- "fused" (`fwd_fused`): row shards routed rank-locally at the capacity of
  a shard, ag_group_gemm (the ring gather of every rank's capacity chunk
  and the gate/up products in one kernel), the activation, moe_reduce_rs
  (the down products and the ring reduce-scatter of every expert's rows),
  the rank-local combine;
- "fused_ar" (`fwd_fused_ar`): the rows replicated and routed once, the
  gate/up grouped GEMM on each rank's columns, moe_reduce_ar (the down
  products and their all-reduce in one kernel), the combine;
- "xla" (`fwd_xla`): the dense all-experts oracle, the partials summed as
  the plain psum.
Every forward takes a [T, D] tensor (split into row shards, padded with
zero rows to a multiple of n, or replicated, as its form wants, and
gathered back) or the per-rank list of its form. A "dist" forward's rows
past `rows` are padding: they are cut before the routing, so they take no
capacity and count in no load, and the capacity is `_cap(rows)`, the JAX
one wherever n divides the rows. `fwd_train` raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.nn.functional as F

from triton_dist_tpu_torch.kernels.ag_group_gemm import ag_group_gemm
from triton_dist_tpu_torch.kernels.allgather import all_gather
from triton_dist_tpu_torch.kernels.ep_a2a import (expert_token_counts,
                                                 group_tokens_by_expert, route,
                                                 scatter_weighted)
from triton_dist_tpu_torch.kernels.group_gemm import grouped_gemm
from triton_dist_tpu_torch.kernels.moe_reduce_ar import moe_reduce_ar
from triton_dist_tpu_torch.kernels.moe_reduce_rs import moe_reduce_rs
from triton_dist_tpu_torch.kernels.reduce_scatter import ordered_sum, reduce_scatter
from triton_dist_tpu_torch.runtime.bootstrap import mesh_of


def _silu_mul(h: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up over packed [gate | up] in h's dtype: the JAX
    layer's activation (kernels/swiglu.py `swiglu_ref`, a plain jnp op in
    the MoE path, not the Pallas swiglu kernel)."""
    g, u = h.chunk(2, dim=-1)
    return F.silu(g) * u


def _to(w, dtype):
    """A panel, or a pair of column blocks, in `dtype`."""
    return tuple(b.to(dtype) for b in w) if isinstance(w, tuple) else w.to(dtype)


@dataclasses.dataclass
class RankPanels:
    """One rank's share of the layer, on its device: the router [D, E],
    gate_up (a [E, D, 2I] panel at one rank; over n ranks the pair of
    column blocks (gate_r, up_r), each [E, D, I/n]) and down [E, I/n, D]."""

    router: torch.Tensor
    gate_up: Union[torch.Tensor, tuple]
    down: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.down.device


@dataclasses.dataclass
class TP_MoE:
    """Router + per-expert SwiGLU MLPs.

    w_router:  [D, E].
    w_gate_up: [E, D, 2I], per expert packed [gate | up] (the one-rank
               layout; a JAX model built over n ranks packs n blocks
               [gate_r | up_r], which models/convert.py unpacks).
    w_down:    [E, I, D].
    capacity_factor: a float, or "dropless" (see `_cap`).
    mesh, ranks: over a mesh of n > 1 ranks, the mesh and each rank's
    RankPanels (views of the panels above where the device is theirs).
    """

    w_router: torch.Tensor
    w_gate_up: torch.Tensor
    w_down: torch.Tensor
    top_k: int
    capacity_factor: Union[float, str] = 2.0
    mesh: Optional[object] = None
    ranks: Optional[list] = None

    @staticmethod
    def init(w_router, w_gate, w_up, w_down, *, top_k: int,
             capacity_factor: Union[float, str] = 2.0, mesh=None) -> "TP_MoE":
        moe = TP_MoE(w_router=w_router, w_gate_up=torch.cat([w_gate, w_up], dim=2),
                     w_down=w_down, top_k=top_k, capacity_factor=capacity_factor)
        return moe if mesh is None or mesh.size == 1 else moe.to_mesh(mesh)

    def to_mesh(self, mesh) -> "TP_MoE":
        """This one-rank layer over `mesh`: rank r keeps columns [r I/n,
        (r+1) I/n) of gate and of up and those rows of w_down, views of
        this layer's panels on their device, copies elsewhere; the router
        on every rank. A mesh of one rank returns the layer itself."""
        if self.mesh is not None:
            raise ValueError("the layer is already split over a mesh")
        n = mesh.size
        if n == 1:
            return self
        I = self.w_down.shape[1]
        if I % n:
            raise ValueError(f"the expert width {I} is not divisible by {n} ranks")
        i = I // n
        gu = self.w_gate_up
        ranks = [RankPanels(router=self.w_router.to(d),
                            gate_up=(gu[:, :, r * i:(r + 1) * i].to(d),
                                     gu[:, :, I + r * i:I + (r + 1) * i].to(d)),
                            down=self.w_down[:, r * i:(r + 1) * i].to(d))
                 for r, d in enumerate(mesh.devices)]
        return dataclasses.replace(self, mesh=mesh, ranks=ranks)

    @property
    def num_experts(self) -> int:
        return self.w_router.shape[1]

    @property
    def n(self) -> int:
        return 1 if self.mesh is None else self.mesh.size

    def _panels(self) -> list:
        if self.ranks is None:
            return [RankPanels(router=self.w_router, gate_up=self.w_gate_up, down=self.w_down)]
        return self.ranks

    def _mesh(self, device):
        return self.mesh if self.mesh is not None else mesh_of(device)

    def _cap(self, M: int) -> int:
        """Static per-expert capacity for M tokens: capacity_factor *
        top_k * M / E, plus one, rounded up to whole 8-row tiles, at least
        8 and at most M * top_k. "dropless" is the worst case, every
        routed entry on one expert (M * top_k rounded up to 8 rows): it
        never drops, at the cost of E times that many rows."""
        if self.capacity_factor == "dropless":
            return -(-M * self.top_k // 8) * 8
        c = int(self.capacity_factor * self.top_k * M / self.num_experts) + 1
        return min(max(8, -(-c // 8) * 8), M * self.top_k)

    def _expert_mlp_sharded(self, x_e, gemm=None) -> list:
        """Each rank's partial [E, cap, D] of the expert MLPs over the
        grouped tokens x_e (a list, rank r's on its device): the grouped
        GEMMs over its gate/up columns and its w_down rows. `gemm` swaps the
        grouped-GEMM callable (grouped_gemm_ref gives the plain
        composition)."""
        gemm = gemm or grouped_gemm
        out = []
        for p in self._panels():
            xe = x_e.to(p.device)
            h = _silu_mul(gemm(xe, _to(p.gate_up, xe.dtype)))
            out.append(gemm(h, p.down.to(xe.dtype)))
        return out

    def _stats(self, topk_idx, inv_slot=None, cap: int = 0) -> dict:
        """Per-expert routed-entry counts and the capacity drop count
        (entries with inv_slot == E*cap); the dense oracle never drops."""
        E = self.num_experts
        dropped = ((inv_slot >= E * cap).sum().to(torch.int32) if inv_slot is not None
                   else torch.zeros((), dtype=torch.int32, device=topk_idx.device))
        return {"expert_tokens": expert_token_counts(topk_idx, E), "dropped": dropped}

    def _route(self, x, p: Optional[RankPanels] = None):
        p = p or self._panels()[0]
        return route(x @ p.router.to(x.device, x.dtype), self.top_k)

    # ------------------------------------------------------------------
    # the forms' inputs and outputs: a tensor, or the per-rank list
    # ------------------------------------------------------------------

    def _replicated(self, x):
        """(each rank's copy of the rows, whether x came as a tensor)."""
        if isinstance(x, torch.Tensor):
            return (self.mesh.replicate(x) if self.mesh is not None else [x]), True
        return list(x), False

    def _sharded(self, x, rows: Optional[int]):
        """(each rank's row shard, the real rows, the tensor's rows or None)."""
        if not isinstance(x, torch.Tensor):
            xs = list(x)
            return xs, rows if rows is not None else self.n * xs[0].shape[0], None
        T, n = x.shape[0], self.n
        m = -(-T // n)
        xp = F.pad(x, (0, 0, 0, n * m - T))
        devs = self.mesh.devices if self.mesh is not None else [x.device]
        return [xp[r * m:(r + 1) * m].to(d) for r, d in enumerate(devs)], \
            (T if rows is None else rows), T

    @staticmethod
    def _out(ys, as_tensor, st, return_stats):
        y = ys[0] if as_tensor else ys
        return (y, st) if return_stats else y

    @staticmethod
    def _gather(ys, T: Optional[int]):
        return ys if T is None else torch.cat([y.to(ys[0].device) for y in ys])[:T]

    # ------------------------------------------------------------------
    # forwards
    # ------------------------------------------------------------------

    def fwd_xla(self, x, return_stats: bool = False):
        """Oracle: every token through every expert ([E, M, D] per rank, so
        keep M small), the ranks' outputs summed in f32 in rank order and
        rounded (the psum's plain version), top-k weighted in f32."""
        xs, as_tensor = self._replicated(x)
        x0 = xs[0]
        E = self.num_experts
        topk_w, topk_idx = self._route(x0)
        parts = []
        for p, xr in zip(self._panels(), xs):
            gu = p.gate_up
            w = torch.cat(gu, dim=2) if isinstance(gu, tuple) else gu
            h = _silu_mul(torch.einsum("md,edf->emf", xr, w.to(xr.dtype)))
            parts.append(torch.einsum("emf,efd->emd", h, p.down.to(xr.dtype)))
        y_all = parts[0] if len(parts) == 1 else ordered_sum(parts, list(range(len(parts))),
                                                             False)
        onehot = F.one_hot(topk_idx.long(), E).float()
        w_e = torch.einsum("tk,tke->te", topk_w, onehot)
        y = torch.einsum("te,etd->td", w_e, y_all.float()).to(x0.dtype)
        return self._out(self._rep(y, xs), as_tensor, self._stats(topk_idx), return_stats)

    def _rep(self, y, xs) -> list:
        return [y.to(xr.device) for xr in xs]

    def fwd_local(self, x, return_stats: bool = False):
        """Kernel path on replicated rows: route, group by expert, each
        rank's two grouped GEMMs, the partials summed in f32 in rank order
        (one rank: the partial itself), the weighted combine."""
        xs, as_tensor = self._replicated(x)
        x0 = xs[0]
        M = x0.shape[0]
        cap = self._cap(M)
        topk_w, topk_idx = self._route(x0)
        x_e, inv_slot, token = group_tokens_by_expert(x0, topk_idx, self.num_experts, cap)
        parts = self._expert_mlp_sharded(x_e)
        y_e = parts[0] if len(parts) == 1 else ordered_sum(parts, list(range(len(parts))),
                                                           False)
        y = scatter_weighted(y_e, inv_slot, token, topk_w, M).to(x0.dtype)
        return self._out(self._rep(y, xs), as_tensor, self._stats(topk_idx, inv_slot, cap),
                         return_stats)

    def fwd_dist(self, x, rows: Optional[int] = None, return_stats: bool = False):
        """Row shards in, row shards out: all_gather, route and group the
        gathered rows (cut to the `rows` real ones: padding takes no
        capacity and no load), each rank's partial combined to token order
        and rounded, reduce_scatter."""
        xs, rows, T = self._sharded(x, rows)
        n = len(xs)
        m = xs[0].shape[0]
        mesh = self._mesh(xs[0].device)
        xg = all_gather(xs, mesh=mesh)[0] if n > 1 else xs[0]
        cap = self._cap(rows)
        xr = xg[:rows]
        topk_w, topk_idx = self._route(xr)
        x_e, inv_slot, token = group_tokens_by_expert(xr, topk_idx, self.num_experts, cap)
        parts = []
        for y_e in self._expert_mlp_sharded(x_e):
            d = y_e.device
            y = scatter_weighted(y_e, inv_slot.to(d), token.to(d), topk_w.to(d), rows)
            parts.append(F.pad(y.to(xr.dtype), (0, 0, 0, n * m - rows)))
        ys = reduce_scatter(parts, mesh=mesh) if n > 1 else parts
        st = self._stats(topk_idx, inv_slot, cap)
        return (self._gather(ys, T), st) if return_stats else self._gather(ys, T)

    def fwd_fused(self, x):
        """Row shards (n of them dividing the rows) in and out: each rank
        routes and groups its own rows at the capacity of a shard, then
        ag_group_gemm (the capacity chunks gathered over the ring and the
        gate/up products), the activation, moe_reduce_rs (the down products
        and the ring reduce-scatter, which hands each rank its own chunk
        back), the rank-local combine."""
        xs, _, T = self._sharded(x, None)
        if T is not None and T % self.n:
            raise ValueError(f"TP_MoE.fwd_fused: {T} rows, not divisible by the axis size "
                             f"{self.n} (each rank routes its own shard)")
        m = xs[0].shape[0]
        cap_loc = self._cap(m)
        mesh = self._mesh(xs[0].device)
        panels = self._panels()
        plans = []
        for xr, p in zip(xs, panels):
            topk_w, topk_idx = self._route(xr, p)
            x_e, inv, tok = group_tokens_by_expert(xr, topk_idx, self.num_experts, cap_loc)
            plans.append((x_e, inv, tok, topk_w))
        h = ag_group_gemm([pl[0] for pl in plans], [_to(p.gate_up, xs[0].dtype) for p in panels],
                          mesh=mesh)
        y_e = moe_reduce_rs([_silu_mul(t) for t in h], [p.down.to(xs[0].dtype) for p in panels],
                            mesh=mesh)
        ys = [scatter_weighted(y, inv, tok, w, m).to(xr.dtype)
              for y, (_, inv, tok, w), xr in zip(y_e, plans, xs)]
        return self._gather(ys, T)

    def fwd_fused_ar(self, x):
        """Replicated rows (the decode path): routing and grouping once, the
        gate/up grouped GEMM on each rank's columns, moe_reduce_ar (the down
        products and their all-reduce in one kernel), the combine."""
        xs, as_tensor = self._replicated(x)
        x0 = xs[0]
        M = x0.shape[0]
        cap = self._cap(M)
        topk_w, topk_idx = self._route(x0)
        x_e, inv_slot, token = group_tokens_by_expert(x0, topk_idx, self.num_experts, cap)
        panels = self._panels()
        h = [_silu_mul(grouped_gemm(x_e.to(p.device), _to(p.gate_up, x0.dtype)))
             for p in panels]
        y_e = moe_reduce_ar(h, [p.down.to(x0.dtype) for p in panels],
                            mesh=self._mesh(x0.device))
        y = scatter_weighted(y_e[0], inv_slot, token, topk_w, M).to(x0.dtype)
        ys = self._rep(y, xs)
        return ys[0] if as_tensor else ys

    def fwd_train(self, x):
        raise NotImplementedError("TP_MoE.fwd_train (TP-MoE training): not yet ported")

    def __call__(self, x, mode: str = "flash", rows: Optional[int] = None, **kw):
        """The JAX mode table: "dist" fwd_dist, "flash"/"ar"/"gemm_ar"
        fwd_local, "fused", "fused_ar", "xla" the oracle; "train" raises.
        kw: return_stats (the serving forms; "fused" and "fused_ar" take
        none). x: a [T, D] tensor or the form's per-rank list; rows: a
        "dist" call's real rows."""
        if mode == "train":
            return self.fwd_train(x)
        if mode in ("fused", "fused_ar"):
            if kw or rows is not None:
                raise ValueError(f"mode={mode!r} takes no extra arguments: {sorted(kw)}")
            return self.fwd_fused(x) if mode == "fused" else self.fwd_fused_ar(x)
        if mode == "dist":
            return self.fwd_dist(x, rows=rows, **kw)
        if mode in ("flash", "ar", "gemm_ar"):
            return self.fwd_local(x, **kw)
        if mode == "xla":
            return self.fwd_xla(x, **kw)
        raise ValueError(f"TP_MoE mode {mode!r}: want 'flash', 'ar', 'gemm_ar', 'dist', "
                         "'fused', 'fused_ar', 'xla' or 'train'")
