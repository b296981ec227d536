"""MoE routing, the token grouping around the grouped GEMM, and the
expert-parallel dispatch and combine.

Counterpart of triton_dist_tpu/kernels/ep_a2a.py: the single-device
helpers (`route`, `expert_token_counts`, `group_tokens_by_expert`,
`scatter_weighted`), the capacity plan of the EP path (`DispatchPlan`,
`plan_dispatch`, `fill_send_buffers`, `group_by_expert`,
`combine_from_slots`, `warn_on_drops`), its int8 wire (`pack_rows_int8`,
`unpack_rows_int8`), and its exchanges: `dispatch_a2a` (the token payload
and its metadata in one launch of csrc/a2a.cu), `dispatch_a2a_int8`,
`combine_a2a` (the one-shot all_to_all of kernels/all_to_all.py), with
the test surface `create_ep_a2a_context` / `ep_dispatch_combine`. The JAX
two-tier planners (`plan_dispatch_valid`, `plan_dispatch_host`) belong to
the two-tier EP path, not ported yet.

The exchanges take one tensor per rank of a mesh (runtime/bootstrap.py)
and take their plain versions on CPU tensors. Every other function is
plain PyTorch and runs on the card without a host synchronisation (static
capacity shapes, no data-dependent sizes, no sort): an entry's place
within its destination or expert is the number of earlier entries bound
there, the rank under the JAX package's stable argsort, computed as a
running sum over a one-hot matrix; scatters that JAX drops out of bounds
write into a sink row past the end, which is cut. So the same entries
fill each destination and expert, and the same ones drop.

Padding rows: the port's EP forwards take row counts that the mesh does
not divide and pad them with zero rows (models/dense.py `_tp_stack`);
`plan_dispatch(..., live=)` gives such a row's entries no slot and no
load, where the JAX forwards, which take only divisible row counts, have
none.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def route(router_logits: torch.Tensor, k: int, *, norm_topk: bool = True):
    """Softmax in f32 -> top-k -> (optionally) renormalise (Qwen3-MoE
    routing). Returns (weights [T, k] f32, expert_idx [T, k] int32), each
    row's experts in descending weight."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)
    if norm_topk:
        w = w / w.sum(dim=-1, keepdim=True)
    return w, idx.to(torch.int32)


def expert_token_counts(topk_idx: torch.Tensor, num_experts: int,
                        live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Routed entries per expert for one forward ([E] int32), counting
    entries dropped by capacity too: the expert compute load that the
    serving telemetry surfaces as `expert_tokens{expert=e}`. An integer
    scatter-add (the bincount of the JAX package, without bincount's
    host synchronisation on CUDA). topk_idx [..., T, k]; live [..., T]
    bool: count only those rows' entries (the EP forwards' padding rows
    count nowhere)."""
    flat = topk_idx.reshape(-1).long()
    ones = (torch.ones_like(flat, dtype=torch.int32) if live is None
            else live.to(flat.device)[..., None].expand(topk_idx.shape).reshape(-1).int())
    return torch.zeros(num_experts, dtype=torch.int32, device=flat.device).scatter_add_(
        0, flat, ones)


def group_tokens_by_expert(x: torch.Tensor, topk_idx: torch.Tensor, num_experts: int,
                           cap: int):
    """Arrange each routed (token, k) entry into capacity-padded
    per-expert batches. Returns (x_e [E, cap, D], inv_slot [T*k], token
    [T*k]): entry i = t*k + j (token t's j-th expert) sits in row
    inv_slot[i] of the flattened [E*cap] expert layout, or inv_slot[i] ==
    E*cap when its expert was full (dropped); token[i] = i // k.

    An entry's row within its expert is the number of earlier entries
    routed to the same expert, which is its rank under the JAX package's
    stable sort by expert, so the same entries fill each expert and the
    same ones are dropped. The rank is a running sum along each row of a
    one-hot [E, T*k] matrix instead of a sort (a scan along the last,
    contiguous axis: one long row per expert). Rows of x_e that hold no
    entry are zeros; dropped entries write into a sink row past the end,
    cut off."""
    T, k = topk_idx.shape
    E = num_experts
    dev = topk_idx.device
    flat_e = topk_idx.reshape(-1).long()
    token = torch.arange(T * k, device=dev) // k
    onehot = torch.zeros((E, T * k), dtype=torch.int32, device=dev).scatter_(
        0, flat_e[None], 1)
    rank = onehot.cumsum(1, dtype=torch.int32).gather(0, flat_e[None])[0] - 1
    inv_slot = torch.where(rank < cap, flat_e * cap + rank, E * cap)
    x_e = torch.zeros((E * cap + 1, x.shape[1]), dtype=x.dtype, device=x.device)
    x_e[inv_slot] = x[token]
    return x_e[:-1].reshape(E, cap, -1), inv_slot, token


def scatter_weighted(y_e: torch.Tensor, inv_slot: torch.Tensor, token: torch.Tensor,
                     topk_w: torch.Tensor, T: int) -> torch.Tensor:
    """Top-k weighted combine of the expert outputs y_e [E, cap, D] back
    to token order: [T, D] f32, each token the sum over its k entries of
    weight * expert row (0 for a dropped entry).

    `token` is group_tokens_by_expert's (token[i] = i // k: a token's k
    entries are contiguous), so the sum is a gather to [T, k, D] and a
    sum over k in f32: the JAX segment sum, without the atomics (and the
    run-to-run order) of a scatter-add of floats on the card."""
    E, cap, D = y_e.shape
    if token.shape != inv_slot.shape or inv_slot.numel() % T:
        raise ValueError(f"scatter_weighted: {inv_slot.numel()} entries for {T} tokens")
    y_flat = y_e.reshape(E * cap, D)
    w = torch.where(inv_slot < E * cap, topk_w.reshape(-1).float(), 0.0)
    contrib = y_flat[inv_slot.clamp(max=E * cap - 1)].float() * w[:, None]
    return contrib.reshape(T, -1, D).sum(dim=1)


def _rank_within(keys: torch.Tensor, groups: int) -> torch.Tensor:
    """For keys [..., R] in [0, groups] (groups: none), the number of
    earlier positions along the last axis with the same key: each
    position's rank within its group under a stable sort by key
    (meaningless for key == groups)."""
    onehot = torch.zeros(keys.shape[:-1] + (groups + 1, keys.shape[-1]), dtype=torch.int32,
                         device=keys.device).scatter_(-2, keys.unsqueeze(-2), 1)
    return onehot.cumsum(-1, dtype=torch.int32).gather(-2, keys.unsqueeze(-2)).squeeze(-2) - 1


def _lead(t: torch.Tensor, ndim: int):
    """(t with one leading batch axis, whether it was added): the EP
    helpers take one rank's tensors ([T, ...], the JAX shapes) or a stack
    of the ranks of one device ([G, T, ...])."""
    return (t, False) if t.dim() > ndim else (t.unsqueeze(0), True)


def _batch_index(t: torch.Tensor) -> torch.Tensor:
    """[G, 1] row indices, to index a stack along its batch axis."""
    return torch.arange(t.shape[0], device=t.device)[:, None]


@dataclasses.dataclass
class DispatchPlan:
    """Where each routed (token, k) entry i = t*k + j went in the
    per-destination capacity layout [n*cap]: slot[..., i] (n*cap: no
    slot), valid[..., i] (False: dropped by capacity, or a padding row's
    entry), token[i] = i // k; live[..., i] False marks a padding row's
    entry (None: every row is real). A leading axis, where the routing
    had one, is the rank within a stack."""
    slot: torch.Tensor
    valid: torch.Tensor
    token: torch.Tensor
    live: Optional[torch.Tensor] = None

    @property
    def dropped(self) -> torch.Tensor:
        """Real entries dropped by capacity, over the stack ([] int32, on
        the device)."""
        lost = ~self.valid if self.live is None else self.live & ~self.valid
        return lost.sum().to(torch.int32)


def plan_dispatch(topk_idx: torch.Tensor, n: int, experts_per_rank: int, cap: int,
                  live: Optional[torch.Tensor] = None) -> DispatchPlan:
    """Give each routed entry of topk_idx [..., T, k] a slot dest * cap +
    rank, dest = its expert's rank, rank = the number of earlier entries
    bound to dest; entries past a destination's capacity drop. live
    [..., T] bool: rows that are real (False: a padding row, whose
    entries take no slot)."""
    T, k = topk_idx.shape[-2:]
    dev = topk_idx.device
    dest = topk_idx.reshape(topk_idx.shape[:-2] + (T * k,)).long() // experts_per_rank
    token = torch.arange(T * k, device=dev) // k
    ent_live = None if live is None else live.to(dev)[..., token]
    if ent_live is not None:
        dest = torch.where(ent_live, dest, n)
    pos = _rank_within(dest, n)
    valid = (dest < n) & (pos < cap)
    slot = torch.where(valid, dest * cap + pos, n * cap)
    return DispatchPlan(slot=slot, valid=valid, token=token, live=ent_live)


def pack_rows_int8(x: torch.Tensor) -> torch.Tensor:
    """[..., R, D] -> [..., R, D+4] int8: each row quantized to int8 by its
    own scale max|x| / 127 (floored at 1e-12 / 127, rounded half to even,
    clipped to +-127), the f32 scale stored as its 4 bytes (little-endian)
    after the payload: one message carries both. A zero row packs to a
    zero payload."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 127.0
    q8 = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return torch.cat([q8, scale.contiguous().view(torch.int8)], dim=-1)


def unpack_rows_int8(p: torch.Tensor, D: int, dtype) -> torch.Tensor:
    """Inverse of pack_rows_int8: [..., R, >= D+4] int8 -> [..., R, D]
    dtype."""
    scale = p[..., D:D + 4].contiguous().view(torch.float32)
    return (p[..., :D].float() * scale).to(dtype)


def fill_send_buffers(x: torch.Tensor, topk_idx: torch.Tensor, plan: DispatchPlan, n: int,
                      experts_per_rank: int, cap: int):
    """Scatter the tokens x [..., T, D] and their metadata into the send
    layout: (send_x [..., n*cap, D], send_meta [..., n*cap, 2] int32: the
    entry's local expert id on its destination, and 1 for a valid slot);
    empty slots are zeros."""
    x, one = _lead(x, 2)
    slot, valid = plan.slot.reshape(x.shape[0], -1), plan.valid.reshape(x.shape[0], -1)
    G, _, D = x.shape
    bi = _batch_index(x)
    local_e = (topk_idx.reshape(G, -1) % experts_per_rank).to(torch.int32)
    send_x = torch.zeros((G, n * cap + 1, D), dtype=x.dtype, device=x.device)
    send_x[bi, slot] = x[:, plan.token]
    meta = torch.stack([local_e, valid.to(torch.int32)], dim=-1)
    send_meta = torch.zeros((G, n * cap + 1, 2), dtype=torch.int32, device=x.device)
    send_meta[bi, slot] = meta
    send_x, send_meta = send_x[:, :-1], send_meta[:, :-1]
    return (send_x[0], send_meta[0]) if one else (send_x, send_meta)


def group_by_expert(recv_x: torch.Tensor, recv_meta: torch.Tensor, experts_per_rank: int,
                    expert_cap: int):
    """Arrange the received slots recv_x [..., R, D] into capacity-padded
    per-expert batches: (x_e [..., E_loc, expert_cap, D]; inv_slot [...,
    R], the row of each received slot in the flattened [E_loc *
    expert_cap] layout, E_loc * expert_cap for an empty or dropped slot;
    dropped, the valid arrivals past their expert's capacity, summed over
    the stack, [] int32)."""
    E = experts_per_rank
    recv_x, one = _lead(recv_x, 2)
    recv_meta = recv_meta.reshape(recv_x.shape[:2] + (2,))
    ok_in = recv_meta[..., 1] > 0
    e = torch.where(ok_in, recv_meta[..., 0].long(), E)
    pos = _rank_within(e, E)
    ok = ok_in & (pos < expert_cap)
    eslot = torch.where(ok, e * expert_cap + pos, E * expert_cap)
    G, _, D = recv_x.shape
    x_e = torch.zeros((G, E * expert_cap + 1, D), dtype=recv_x.dtype, device=recv_x.device)
    x_e[_batch_index(recv_x), eslot] = recv_x
    dropped = (ok_in & ~ok).sum().to(torch.int32)
    x_e = x_e[:, :-1].reshape(G, E, expert_cap, D)
    return (x_e[0], eslot[0], dropped) if one else (x_e, eslot, dropped)


def combine_from_slots(y_back: torch.Tensor, plan: DispatchPlan, topk_w: torch.Tensor,
                       T: int) -> torch.Tensor:
    """Each token's weighted sum of its returned expert outputs: y_back
    [..., n*cap, D] in the send layout -> [..., T, D] f32 (a gather to [T,
    k, D] and a sum over k; an entry without a slot weighs 0)."""
    y_back, one = _lead(y_back, 2)
    G, R, D = y_back.shape
    slot, valid = plan.slot.reshape(G, -1), plan.valid.reshape(G, -1)
    w = torch.where(valid, topk_w.reshape(G, -1).float(), 0.0)
    contrib = y_back[_batch_index(y_back), slot.clamp(max=R - 1)].float() * w[..., None]
    out = contrib.reshape(G, T, -1, D).sum(dim=2)
    return out[0] if one else out


_DROPS: dict = {}


def warn_on_drops(dropped: torch.Tensor, where: str) -> None:
    """The JAX in-program warning on capacity drops, as a count: `dropped`
    is added to a running total per `where`, on its device (no host
    synchronisation); `drop_counts` reads the totals."""
    prev = _DROPS.get(where)
    d = dropped.detach().to(torch.int64)
    _DROPS[where] = d if prev is None else prev + d.to(prev.device)


def drop_counts() -> dict:
    """Routed entries dropped by capacity in this process, by caller (a
    host read of the device totals)."""
    return {w: int(t) for w, t in _DROPS.items()}


def dispatch_a2a(send_x, send_meta, *, mesh):
    """Exchange the ranks' send buffers ([n*cap, D] payload and [n*cap, 2]
    int32 metadata, one pair per rank) so that each rank ends with every
    peer's chunk addressed to it: one launch of csrc/a2a.cu on CUDA tensors
    (counted as dispatch_a2a), all_to_all_ref on CPU tensors. Returns
    (recv_x, recv_meta), lists."""
    from triton_dist_tpu_torch.kernels.all_to_all import _check, all_to_all_ref, exchange
    _check(send_x, mesh, "dispatch_a2a payload")
    _check(send_meta, mesh, "dispatch_a2a metadata")
    if mesh.size == 1:
        return list(send_x), list(send_meta)
    if send_x[0].device.type == "cpu":
        return all_to_all_ref(send_x), all_to_all_ref(send_meta)
    return exchange("dispatch_a2a", send_x, mesh, send_meta)


def dispatch_a2a_int8(send_p, send_meta, *, mesh):
    """dispatch_a2a of pack_rows_int8 payloads ([n*cap, D+4] int8). The
    JAX form pads the lanes to 128 for Mosaic's sliced copies; the CUDA
    kernel moves any row width, so this is dispatch_a2a itself."""
    return dispatch_a2a(send_p, send_meta, mesh=mesh)


def combine_a2a(y_slots, *, mesh) -> list:
    """The reverse exchange: each rank's expert outputs in the received
    slot layout back to the token owners (the one-shot all_to_all)."""
    from triton_dist_tpu_torch.kernels.all_to_all import all_to_all
    return all_to_all(y_slots, mesh=mesh)


@dataclasses.dataclass
class EPAll2AllContext:
    """The static configuration of ep_dispatch_combine."""
    mesh: object
    n: int
    num_experts: int
    experts_per_rank: int
    capacity: int          # slots per (source, destination) pair


def create_ep_a2a_context(mesh, *, num_experts: int, capacity: int) -> EPAll2AllContext:
    n = mesh.size
    if num_experts % n:
        raise ValueError(f"{num_experts} experts over {n} ranks")
    return EPAll2AllContext(mesh=mesh, n=n, num_experts=num_experts,
                            experts_per_rank=num_experts // n, capacity=capacity)


def ep_dispatch_combine(x, router_logits, k: int, ctx: EPAll2AllContext, expert_fn=None,
                        expert_cap: Optional[int] = None) -> list:
    """Route, dispatch, expert_fn on each rank's grouped tokens (x_e
    [E_loc, C_e, D] -> the same shape; the identity if None), combine: x
    and router_logits are each rank's rows ([T_loc, D], [T_loc, E]), one
    per rank; returns each rank's [T_loc, D] top-k weighted combination."""
    n, epr, cap, mesh = ctx.n, ctx.experts_per_rank, ctx.capacity, ctx.mesh
    e_cap = expert_cap or n * cap
    routes = [route(lg, k) for lg in router_logits]
    plans = [plan_dispatch(idx, n, epr, cap) for _, idx in routes]
    sends = [fill_send_buffers(xr, idx, pl, n, epr, cap)
             for xr, (_, idx), pl in zip(x, routes, plans)]
    recv_x, recv_m = dispatch_a2a([s[0] for s in sends], [s[1] for s in sends], mesh=mesh)
    y_slots = []
    for rx, rm in zip(recv_x, recv_m):
        x_e, inv, _ = group_by_expert(rx, rm, epr, e_cap)
        if expert_fn is not None:
            x_e = expert_fn(x_e)
        y_slots.append(slot_rows(x_e, inv))
    y_back = combine_a2a(y_slots, mesh=mesh)
    return [combine_from_slots(yb, pl, w, xr.shape[0]).to(xr.dtype)
            for yb, pl, (w, _), xr in zip(y_back, plans, routes, x)]


def slot_rows(y_e: torch.Tensor, inv_slot: torch.Tensor) -> torch.Tensor:
    """The expert outputs y_e [..., E_loc, C_e, D] back in the received
    slot layout: row i is y_e's row inv_slot[..., i], zeros where it has
    none."""
    y_e, one = _lead(y_e, 3)
    G, E, C, D = y_e.shape
    flat = torch.cat([y_e.reshape(G, E * C, D), y_e.new_zeros((G, 1, D))], dim=1)
    out = flat[_batch_index(y_e), inv_slot.reshape(G, -1).clamp(max=E * C)]
    return out[0] if one else out
