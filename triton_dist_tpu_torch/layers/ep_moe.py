"""Expert-parallel MoE layer: counterpart of triton_dist_tpu/layers/ep_moe.py
(`EP_MoE.init`, `quantize_int8_experts`, `_caps`, `_cap_e`, `fwd_ep`,
`fwd_ep_fused`, `fwd_xla`, `__call__`).

The experts are split over the ranks of a mesh (runtime/bootstrap.py):
rank r holds experts [r * E/n, (r+1) * E/n) as [E/n, D, 2I] packed
[gate | up] and [E/n, I, D] panels, the router [D, E] on every rank. The
forwards take and return row shards, one [t_loc, D] tensor per rank
(the JAX x row-sharded over the ep axis); a tensor [T, D] is also taken,
split into n row shards and gathered back. Inside, the ranks of one
device are stacked ([g, t_loc, D]) and each plain step and each grouped
GEMM runs once a device over the stack: four ranks emulated on one card
take one launch where they would take four, and on four cards each rank
runs alone. Data flow of `fwd_ep`, per rank, with the two exchanges
over all ranks:

    route (router product, f32 softmax, top-k, renormalise)
    plan_dispatch -> fill_send_buffers [n*pair, D] + [n*pair, 2] int32
    dispatch_a2a                                  (CUDA kernel, a2a.cu)
    group_by_expert -> x_e [E/n, e_cap, D]
    grouped_gemm, silu(gate) * up, grouped_gemm   (CUDA kernel, the
                                                   device's ranks' experts)
    back to the slot layout, combine_a2a          (CUDA kernel, a2a.cu)
    combine_from_slots -> [t_loc, D]

With payload_int8 both exchanges carry pack_rows_int8 rows. `fwd_ep_fused`
plans one destination per global expert and runs the whole MoE as one
kernel (kernels/ep_fused.py); `fwd_xla` is the dense all-experts oracle.

Row counts the mesh does not divide: the port's engine admits exact
prompt suffixes, so a forward's M rows are padded with zero rows to a
multiple of n (models/dense.py `_tp_stack`, or `_shard` here) and
`rows=M` marks the rest as padding: a padding row's entries take no slot
and count in no load, and its output rows are zero. The capacities come
from the padded shard's row count (`_caps(ceil(M / n))`), which is the
JAX one wherever n divides M, so the same entries drop there.

`fwd_ep_2d` (two-tier EP) and `fwd_train` raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.nn.functional as F

from triton_dist_tpu_torch.kernels.ep_a2a import (combine_a2a, combine_from_slots,
                                                 dispatch_a2a, dispatch_a2a_int8,
                                                 expert_token_counts, fill_send_buffers,
                                                 group_by_expert, pack_rows_int8,
                                                 plan_dispatch, route, slot_rows,
                                                 unpack_rows_int8, warn_on_drops)
from triton_dist_tpu_torch.kernels.ep_fused import ep_moe_fused_device
from triton_dist_tpu_torch.kernels.group_gemm import grouped_gemm
from triton_dist_tpu_torch.kernels.quant import QuantW, quantize_int8
from triton_dist_tpu_torch.layers.tp_moe import _silu_mul


def route_ranks(logits, k: int, rows: Optional[int] = None) -> list:
    """route() of each entry of `logits` (the router logits of the ranks of
    one device, stacked [g, t, E], or of one rank, [t, E]): [(weights,
    expert ids)] per entry, whose rows, flattened in order, are the
    forward's rows in rank order. The EP forwards' one routing call, so
    that a tool can pin it (tools/fault_margin.py RouteTape); rows: the
    real rows of the forward (the rest are padding)."""
    return [route(lg, k) for lg in logits]


def _panel_to(w, dtype):
    return w if isinstance(w, QuantW) else w.to(dtype)


@dataclasses.dataclass
class EP_MoE:
    """w_router: [D, E], one copy per rank; w_gate_up: each rank's [E/n, D,
    2I] (packed [gate | up]); w_down: each rank's [E/n, I, D]; either
    panel list may hold QuantW (quantize_int8_experts, for ep_fused)."""

    w_router: list
    w_gate_up: list
    w_down: list
    mesh: object
    top_k: int
    capacity_factor: Union[float, str] = 2.0
    payload_int8: bool = False

    @staticmethod
    def init(w_router, w_gate, w_up, w_down, *, mesh, top_k: int,
             capacity_factor: Union[float, str] = 2.0, payload_int8: bool = False,
             slice_axis=None) -> "EP_MoE":
        """From the whole [E, D, I] gate and up panels and [E, I, D] down
        panel (on one device): pack [gate | up], split by rank."""
        if slice_axis is not None:
            raise NotImplementedError("EP_MoE slice_axis (two-tier EP): not yet ported")
        return EP_MoE.from_packed(w_router, torch.cat([w_gate, w_up], dim=2), w_down,
                                  mesh=mesh, top_k=top_k, capacity_factor=capacity_factor,
                                  payload_int8=payload_int8)

    @staticmethod
    def from_packed(w_router, w_gate_up, w_down, *, mesh, top_k: int,
                    capacity_factor: Union[float, str] = 2.0,
                    payload_int8: bool = False) -> "EP_MoE":
        """From the packed [E, D, 2I] and [E, I, D] panels: rank r takes
        experts [r*E/n, (r+1)*E/n), views of the same storage where its
        device is the panels' (a split along E is contiguous)."""
        E, n = w_gate_up.shape[0], mesh.size
        if E % n:
            raise ValueError(
                f"EP_MoE needs the expert count ({E}) divisible by the expert-parallel "
                f"axis size ({n}): each rank owns a whole group of expert panels; pad the "
                "expert set or shrink the mesh")
        epr = E // n
        return EP_MoE(
            w_router=mesh.replicate(w_router),
            w_gate_up=[w_gate_up[r * epr:(r + 1) * epr].to(d) for r, d in enumerate(mesh.devices)],
            w_down=[w_down[r * epr:(r + 1) * epr].to(d) for r, d in enumerate(mesh.devices)],
            mesh=mesh, top_k=top_k, capacity_factor=capacity_factor, payload_int8=payload_int8)

    @property
    def num_experts(self) -> int:
        return self.w_router[0].shape[1]

    @property
    def n(self) -> int:
        return self.mesh.size

    def quantize_int8_experts(self) -> "EP_MoE":
        """Expert panels as QuantW (int8, per-expert per-column scales), for
        mode "ep_fused" (the chain paths take plain panels)."""
        return dataclasses.replace(self, w_gate_up=[quantize_int8(w) for w in self.w_gate_up],
                                   w_down=[quantize_int8(w) for w in self.w_down])

    def _caps(self, t_loc: int):
        """(pair capacity, per-expert capacity) for t_loc rows a rank, the
        JAX rule: "dropless" is the provable worst case (every entry of a
        rank to one destination, every arrival to one expert), a float
        factor the capacity trade, rounded to 8-row tiles (32 for the int8
        wire)."""
        n, k = self.n, self.top_k
        epr = self.num_experts // n
        r = 32 if self.payload_int8 else 8
        if self.capacity_factor == "dropless":
            pair = -(-t_loc * k // r) * r
            return pair, n * pair
        pair = int(self.capacity_factor * k * t_loc / n) + 1
        pair = min(max(r, -(-pair // r) * r), -(-t_loc * k // r) * r)
        e_cap = int(self.capacity_factor * n * pair / epr) + 1
        e_cap = min(max(8, -(-e_cap // 8) * 8), n * pair)
        return pair, e_cap

    def _cap_e(self, t_loc: int) -> int:
        """Per-(source, global expert) capacity of the fused layout."""
        E, k = self.num_experts, self.top_k
        if self.capacity_factor == "dropless":
            cap = t_loc * k
        else:
            cap = min(int(self.capacity_factor * k * t_loc / E) + 1, t_loc * k)
        return max(8, -(-cap // 8) * 8)

    # ------------------------------------------------------------------
    # shards
    # ------------------------------------------------------------------

    def _stacks(self, xs, rows: Optional[int]) -> list:
        """Per device of the mesh, in rank order: (its ranks, their row
        shards stacked [g, t_loc, D], the mask of real rows [g, t_loc] or
        None). The plain steps of a forward run once a device over the
        stack (four emulated ranks: one op where there would be four)."""
        t_loc = xs[0].shape[0]
        out = []
        for dev, ranks in self.mesh.device_groups():
            X = torch.stack([xs[r] for r in ranks]) if len(ranks) > 1 else xs[ranks[0]][None]
            live = None
            if rows is not None and rows < self.n * t_loc:
                live = (torch.arange(ranks[0] * t_loc, (ranks[-1] + 1) * t_loc, device=dev)
                        < rows).reshape(len(ranks), t_loc)
            out.append((ranks, X, live))
        return out

    @staticmethod
    def _panel(panels, ranks):
        """The ranks' panels as one [g * E/n, ...] tensor: a view where they
        are consecutive slices of one storage (as from_packed leaves the
        ranks of one device), else a copy."""
        ps = [panels[r] for r in ranks]
        p0 = ps[0]
        if isinstance(p0, QuantW):
            raise TypeError("EP_MoE.fwd_ep takes plain expert panels; QuantW panels "
                            "(quantize_int8_experts) run mode 'ep_fused'")
        if len(ps) == 1:
            return p0
        step = p0.numel() * p0.element_size()
        if all(p.is_contiguous() and p.dtype == p0.dtype and p.shape == p0.shape
               and p.data_ptr() == p0.data_ptr() + i * step for i, p in enumerate(ps)):
            return p0.as_strided((len(ps) * p0.shape[0],) + tuple(p0.shape[1:]), p0.stride())
        return torch.cat(ps)

    def _shard(self, x: torch.Tensor):
        """[T, D] -> (n row shards, padded with zero rows, one per rank)."""
        T, n = x.shape[0], self.n
        m = -(-T // n)
        xp = F.pad(x, (0, 0, 0, n * m - T))
        return [xp[r * m:(r + 1) * m].to(d) for r, d in enumerate(self.mesh.devices)]

    def _route(self, stacks, rows):
        return route_ranks([X @ self.w_router[ranks[0]].to(X.dtype) for ranks, X, _ in stacks],
                           self.top_k, rows)

    def _finish(self, stacks, routes, drops, return_stats, warn_drops, where, ys):
        """The per-rank outputs, the drop warning count and the stats
        (summed over ranks, on rank 0's device)."""
        dev0 = self.mesh.devices[0]
        if warn_drops and self.capacity_factor != "dropless":
            warn_on_drops(sum(d.to(dev0) for d in drops), where)
        out = [y for Y, (_, X, _) in zip(ys, stacks) for y in Y.to(X.dtype).unbind(0)]
        if not return_stats:
            return out
        counts = sum(expert_token_counts(idx, self.num_experts, lv).to(dev0)
                     for (_, idx), (_, _, lv) in zip(routes, stacks))
        return out, {"dropped": sum(d.to(dev0) for d in drops), "expert_tokens": counts}

    # ------------------------------------------------------------------
    # forwards, each on row shards
    # ------------------------------------------------------------------

    def fwd_ep(self, xs, rows: Optional[int] = None, return_stats: bool = False,
               warn_drops: bool = True):
        """Route, dispatch_a2a, the grouped GEMMs on each rank's experts (one
        launch a device over its ranks' experts), combine_a2a, the
        weighted combine. With return_stats also {"dropped": the real
        entries lost to capacity, summed over ranks, "expert_tokens": [E]
        routed entries of real rows, summed over ranks} on rank 0's device;
        warn_drops counts the drops (ep_a2a.warn_on_drops) unless
        dropless."""
        n, mesh = self.n, self.mesh
        epr = self.num_experts // n
        t_loc, D = xs[0].shape
        cap, e_cap = self._caps(t_loc)
        stacks = self._stacks(xs, rows)
        routes = self._route(stacks, rows)
        plans = [plan_dispatch(idx, n, epr, cap, live=lv)
                 for (_, idx), (_, _, lv) in zip(routes, stacks)]
        sends = [fill_send_buffers(X, idx, pl, n, epr, cap)
                 for (_, X, _), (_, idx), pl in zip(stacks, routes, plans)]
        q8 = self.payload_int8 and n > 1

        def ranks_of(stacked):                   # per device [g, ...] -> per rank
            return [t for T_ in stacked for t in T_.unbind(0)]

        def stacked(per_rank):                   # per rank -> per device [g, ...]
            return [torch.stack([per_rank[r] for r in ranks]) for ranks, _, _ in stacks]

        if q8:
            recv_p, recv_m = dispatch_a2a_int8(ranks_of(pack_rows_int8(sx) for sx, _ in sends),
                                               ranks_of(m for _, m in sends), mesh=mesh)
            recv_x = [unpack_rows_int8(p, D, xs[0].dtype) for p in stacked(recv_p)]
        else:
            recv_x, recv_m = dispatch_a2a(ranks_of(sx for sx, _ in sends),
                                          ranks_of(m for _, m in sends), mesh=mesh)
            recv_x = stacked(recv_x)
        y_slots, drops = [], []
        for (ranks, _, _), rx, rm, pl in zip(stacks, recv_x, stacked(recv_m), plans):
            x_e, inv, r_drop = group_by_expert(rx, rm, epr, e_cap)
            g = len(ranks)
            xg = x_e.reshape((g * epr,) + x_e.shape[2:])
            h = _silu_mul(grouped_gemm(xg, self._panel(self.w_gate_up, ranks).to(xg.dtype)))
            y_e = grouped_gemm(h, self._panel(self.w_down, ranks).to(xg.dtype))
            y_slots.append(slot_rows(y_e.reshape(x_e.shape), inv))
            drops.append(pl.dropped + r_drop)
        if q8:
            y_back = [unpack_rows_int8(p, D, xs[0].dtype) for p in stacked(combine_a2a(
                ranks_of(pack_rows_int8(y) for y in y_slots), mesh=mesh))]
        else:
            y_back = stacked(combine_a2a(ranks_of(y_slots), mesh=mesh))
        ys = [combine_from_slots(yb, pl, w, t_loc)
              for yb, pl, (w, _) in zip(y_back, plans, routes)]
        return self._finish(stacks, routes, drops, return_stats, warn_drops, "EP_MoE.fwd_ep",
                            ys)

    def fwd_ep_fused(self, xs, rows: Optional[int] = None, return_stats: bool = False,
                     warn_drops: bool = True, **fused_kw):
        """The whole MoE as one kernel a rank (kernels/ep_fused.py): the plan
        gives each global expert its own destination, so the slot layout is
        the expert grouping; then the weighted combine. fused_kw: the JAX
        fused_* knobs, each raising unless at its default."""
        E = self.num_experts
        t_loc, D = xs[0].shape
        cap_e = self._cap_e(t_loc)
        stacks = self._stacks(xs, rows)
        routes = self._route(stacks, rows)
        plans = [plan_dispatch(idx, E, 1, cap_e, live=lv)
                 for (_, idx), (_, _, lv) in zip(routes, stacks)]
        sends = [fill_send_buffers(X, idx, pl, E, 1, cap_e)[0]
                 for (_, X, _), (_, idx), pl in zip(stacks, routes, plans)]
        knobs = {kk[len("fused_"):] if kk.startswith("fused_") else kk: v
                 for kk, v in fused_kw.items()}
        yback = ep_moe_fused_device(
            [t for S in sends for t in S.unbind(0)],
            [_panel_to(w, xs[0].dtype) for w in self.w_gate_up],
            [_panel_to(w, xs[0].dtype) for w in self.w_down], mesh=self.mesh, cap_e=cap_e,
            **knobs)
        ys = [combine_from_slots(torch.stack([yback[r] for r in ranks]).reshape(
                  len(ranks), E * cap_e, D), pl, w, t_loc)
              for (ranks, _, _), pl, (w, _) in zip(stacks, plans, routes)]
        return self._finish(stacks, routes, [pl.dropped for pl in plans], return_stats,
                            warn_drops, "EP_MoE.fwd_ep_fused", ys)

    def fwd_xla(self, xs, rows: Optional[int] = None, return_stats: bool = False):
        """Oracle: all the rows routed once (each rank would route the same
        gathered rows), every rank's experts run densely on them, weighted
        by the routing restricted to its experts; the ranks' f32 sums added
        in rank order; never drops. Its stats count the routed load of the
        real rows."""
        n, k = self.n, self.top_k
        epr = self.num_experts // n
        t_loc = xs[0].shape[0]
        dev0 = self.mesh.devices[0]
        xg = torch.cat([x.to(dev0) for x in xs])
        (topk_w, topk_idx), = route_ranks([xg @ self.w_router[0].to(dev0).to(xg.dtype)], k,
                                          rows)
        total = None
        for r, (wgu, wd) in enumerate(zip(self.w_gate_up, self.w_down)):
            d = wgu.device
            x = xg.to(d)
            h = _silu_mul(torch.einsum("md,edf->emf", x, wgu.to(x.dtype)))
            y_all = torch.einsum("emf,efd->emd", h, wd.to(x.dtype))
            # the routing restricted to this rank's experts (JAX one_hot of
            # the local id: zero outside [0, E/n))
            local = topk_idx.to(d).long() - r * epr
            onehot = (F.one_hot(local.clamp(0, epr - 1), epr).float()
                      * ((local >= 0) & (local < epr))[..., None])
            w_e = torch.einsum("tk,tke->te", topk_w.to(d), onehot)
            y = torch.einsum("te,etd->td", w_e, y_all.float()).to(dev0)
            total = y if total is None else total + y
        y = total.to(xs[0].dtype)
        ys = [y[r * t_loc:(r + 1) * t_loc].to(x.device) for r, x in enumerate(xs)]
        if not return_stats:
            return ys
        live = None if rows is None else torch.arange(xg.shape[0], device=dev0) < rows
        return ys, {"dropped": torch.zeros((), dtype=torch.int32, device=dev0),
                    "expert_tokens": expert_token_counts(topk_idx, self.num_experts, live)}

    def fwd_ep_2d(self, *args, **kw):
        raise NotImplementedError("EP_MoE.fwd_ep_2d (two-tier EP): not yet ported")

    def fwd_train(self, *args, **kw):
        raise NotImplementedError("EP_MoE.fwd_train (EP training): not yet ported")

    def __call__(self, x, mode: str = "ep", rows: Optional[int] = None, **kw):
        """mode "ep" (fwd_ep), "ep_fused", "xla" (the oracle); "train" and
        "ep_2d" raise. x: the row shards, one per rank (returned likewise),
        or a [T, D] tensor (split into shards and gathered back, T rows)."""
        if mode == "train":
            return self.fwd_train(x, **kw)
        if mode == "ep_2d":
            return self.fwd_ep_2d(x, **kw)
        fwd = {"ep": self.fwd_ep, "ep_fused": self.fwd_ep_fused, "xla": self.fwd_xla}.get(mode)
        if fwd is None:
            raise ValueError(f"EP_MoE mode {mode!r}: want 'ep', 'ep_fused' or 'xla'")
        if not isinstance(x, torch.Tensor):
            return fwd(list(x), rows=rows, **kw)
        T = x.shape[0]
        out = fwd(self._shard(x), rows=T if rows is None else rows, **kw)
        ys, st = out if kw.get("return_stats") else (out, None)
        y = torch.cat([t.to(x.device) for t in ys])[:T]
        return y if st is None else (y, st)
