"""MoE routing and the local token grouping around the grouped GEMM.

Counterpart of the single-device helpers of
triton_dist_tpu/kernels/ep_a2a.py (`route`, `expert_token_counts`,
`group_tokens_by_expert`, `scatter_weighted`), as plain PyTorch ops. The
expert-parallel dispatch/combine kernels of that module are not ported
yet. Every function here runs on the card without a host
synchronisation (static capacity shapes, no data-dependent sizes), so a
serving tick that calls them never waits on the device.
"""

from __future__ import annotations

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


def expert_token_counts(topk_idx: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Routed entries per expert for one forward ([E] int32), counting
    entries dropped by capacity too: the expert compute load that the
    serving telemetry surfaces as `expert_tokens{expert=e}`. An integer
    scatter-add (the bincount of the JAX package, without bincount's
    host synchronisation on CUDA)."""
    flat = topk_idx.reshape(-1).long()
    return torch.zeros(num_experts, dtype=torch.int32, device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))


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
