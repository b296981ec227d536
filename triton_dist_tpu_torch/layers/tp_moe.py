"""Routed-expert MoE FFN at tensor-parallel size 1.

Counterpart of triton_dist_tpu/layers/tp_moe.py (`TP_MoE.init`, `_cap`,
`_expert_mlp_sharded`, `_stats`, `fwd_xla`, `fwd_local`, `__call__`) on
one device. Data flow of the kernel path, `fwd_local`:

    route (router product, f32 softmax, top-k, renormalise)
    group_tokens_by_expert -> x_e [E, cap, D]   (capacity-padded)
    grouped_gemm(x_e, w_gate_up)                (CUDA kernel)
    silu(gate) * up                             (plain, as in JAX)
    grouped_gemm(., w_down)                     (CUDA kernel)
    scatter_weighted -> [M, D]                  (top-k weighted combine)

The multi-chip forms of the JAX layer (`fwd_dist`, `fwd_fused`,
`fwd_fused_ar`, `fwd_train`) raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch
import torch.nn.functional as F

from triton_dist_tpu_torch.kernels.ep_a2a import (expert_token_counts,
                                                 group_tokens_by_expert, route,
                                                 scatter_weighted)
from triton_dist_tpu_torch.kernels.group_gemm import grouped_gemm


def _silu_mul(h: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up over packed [gate | up] in h's dtype: the JAX
    layer's activation (kernels/swiglu.py `swiglu_ref`, a plain jnp op in
    the MoE path, not the Pallas swiglu kernel)."""
    g, u = h.chunk(2, dim=-1)
    return F.silu(g) * u


@dataclasses.dataclass
class TP_MoE:
    """Router + per-expert SwiGLU MLPs.

    w_router:  [D, E].
    w_gate_up: [E, D, 2I], per expert packed [gate | up].
    w_down:    [E, I, D].
    capacity_factor: a float, or "dropless" (see `_cap`).
    """

    w_router: torch.Tensor
    w_gate_up: torch.Tensor
    w_down: torch.Tensor
    top_k: int
    capacity_factor: Union[float, str] = 2.0

    @staticmethod
    def init(w_router, w_gate, w_up, w_down, *, top_k: int,
             capacity_factor: Union[float, str] = 2.0) -> "TP_MoE":
        return TP_MoE(w_router=w_router, w_gate_up=torch.cat([w_gate, w_up], dim=2),
                      w_down=w_down, top_k=top_k, capacity_factor=capacity_factor)

    @property
    def num_experts(self) -> int:
        return self.w_router.shape[1]

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

    def _expert_mlp_sharded(self, x_e, gemm=None):
        """The expert MLPs over the grouped tokens: [1, E, cap, D], the
        JAX layer's per-rank stack at mesh size 1. `gemm` swaps the
        grouped-GEMM callable (grouped_gemm_ref gives the plain
        composition)."""
        gemm = gemm or grouped_gemm
        h = _silu_mul(gemm(x_e, self.w_gate_up.to(x_e.dtype)))
        return gemm(h, self.w_down.to(x_e.dtype))[None]

    def _stats(self, topk_idx, inv_slot=None, cap: int = 0) -> dict:
        """Per-expert routed-entry counts and the capacity drop count
        (entries with inv_slot == E*cap); the dense oracle never drops."""
        E = self.num_experts
        dropped = ((inv_slot >= E * cap).sum().to(torch.int32) if inv_slot is not None
                   else torch.zeros((), dtype=torch.int32, device=topk_idx.device))
        return {"expert_tokens": expert_token_counts(topk_idx, E), "dropped": dropped}

    def fwd_xla(self, x, return_stats: bool = False):
        """Oracle: every token through every expert ([E, M, D] in f32 for
        the combine, so keep M small), top-k weighted."""
        E, k = self.num_experts, self.top_k
        topk_w, topk_idx = route(x @ self.w_router, k)
        h = _silu_mul(torch.einsum("md,edf->emf", x, self.w_gate_up.to(x.dtype)))
        y_all = torch.einsum("emf,efd->emd", h, self.w_down.to(x.dtype))
        onehot = F.one_hot(topk_idx.long(), E).float()
        w_e = torch.einsum("tk,tke->te", topk_w, onehot)
        y = torch.einsum("te,etd->td", w_e, y_all.float()).to(x.dtype)
        return (y, self._stats(topk_idx)) if return_stats else y

    def fwd_local(self, x, return_stats: bool = False):
        """Kernel path: route, group by expert, the two grouped GEMMs,
        the weighted combine."""
        M = x.shape[0]
        cap = self._cap(M)
        topk_w, topk_idx = route(x @ self.w_router, self.top_k)
        x_e, inv_slot, token = group_tokens_by_expert(x, topk_idx, self.num_experts, cap)
        y_e = self._expert_mlp_sharded(x_e)[0]      # the sum over one rank
        y = scatter_weighted(y_e, inv_slot, token, topk_w, M).to(x.dtype)
        return (y, self._stats(topk_idx, inv_slot, cap)) if return_stats else y

    def __call__(self, x, mode: str = "flash", **kw):
        """mode "flash": fwd_local (the grouped-GEMM kernel); "xla": the
        oracle. kw: return_stats."""
        if mode == "flash":
            return self.fwd_local(x, **kw)
        if mode == "xla":
            return self.fwd_xla(x, **kw)
        raise NotImplementedError(f"TP_MoE mode {mode!r}: not yet ported (the port "
                                  "runs 'flash' and 'xla')")
