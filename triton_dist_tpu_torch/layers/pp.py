"""The pipeline-parallel forward: counterpart of
triton_dist_tpu/layers/pp.py (`PPipeline.init`, `PPipeline.__call__`;
`train_1f1b` raises).

The stages are the ranks of a mesh (runtime/bootstrap.py): rank s holds
stage s's parameters on its device, and the handoff between stages is
kernels/p2p.py's p2p_shift (row 17). The schedule is the JAX one, GPipe
in the SPMD-uniform form: with M microbatches and n stages the loop runs
M + n - 1 ticks; at tick t every stage runs its stage function once
(stage 0 on microbatch min(t, M - 1), every other stage on what its left
neighbour handed it, the bubble ticks on garbage as in JAX), the last
stage banks its output as microbatch t - (n - 1) once t >= n - 1, and
the tick ends with one p2p_shift of every stage's output. The JAX psum
that replicates the banks is XLA's, not a Pallas kernel's, so it stays
plain torch here: the n ranks' banks summed in f32 in rank order and
rounded once (all but the last stage's are zeros, so the sum is exact).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from triton_dist_tpu_torch.kernels.p2p import p2p_shift


def _tree_to(tree, device):
    """A parameter tree (tensors in dicts, lists and tuples) on `device`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree


def _psum(parts, mesh) -> list:
    """The banks summed over the ranks in f32 in rank order, rounded once
    to their dtype: one sum per distinct device, shared by its ranks."""
    out = []
    for dev, ranks in mesh.device_groups():
        acc = parts[0].to(dev, torch.float32)
        for p in parts[1:]:
            acc = acc + p.to(dev, torch.float32)
        out += [acc.to(parts[0].dtype)] * len(ranks)
    return out


@dataclasses.dataclass
class PPipeline:
    """A pipeline of n stages over a mesh of n ranks. stage_params: one
    parameter tree per stage, stage s's on rank s's device; stage_fn(params,
    x [B, D]) -> [B, D] is every stage's compute."""

    stage_params: list
    stage_fn: Callable
    mesh: object

    @staticmethod
    def init(stage_params, stage_fn, *, mesh) -> "PPipeline":
        """stage_params: one tree per stage (the JAX leaves' [n, ...] stacks
        cut along their first dimension), moved to its rank's device."""
        if len(stage_params) != mesh.size:
            raise ValueError(f"PPipeline: {len(stage_params)} stages' parameters for a mesh "
                             f"of {mesh.size} ranks")
        return PPipeline(stage_params=[_tree_to(p, d) for p, d in
                                       zip(stage_params, mesh.devices)],
                         stage_fn=stage_fn, mesh=mesh)

    def __call__(self, x_mb: torch.Tensor, replicate_out: bool = True) -> list:
        """x_mb: [M, B, D] microbatches (replicated: read on rank 0's
        device). Returns per rank [M, B, D], each microbatch through the n
        stages in order: with replicate_out every rank's copy of the
        banks' psum, else the per-stage banks themselves (the last
        stage's holds the result, the others zeros)."""
        n = self.mesh.size
        devs = self.mesh.devices
        M, B, D = x_mb.shape
        mb = x_mb.to(devs[0])
        reg = [torch.zeros((B, D), dtype=x_mb.dtype, device=d) for d in devs]
        outs = [torch.zeros((M, B, D), dtype=x_mb.dtype, device=d) for d in devs]
        for t in range(M + n - 1):
            ys = [self.stage_fn(self.stage_params[s], mb[min(t, M - 1)] if s == 0 else reg[s])
                  .contiguous() for s in range(n)]
            if t >= n - 1:
                outs[n - 1][t - (n - 1)] += ys[n - 1]
            reg = p2p_shift(ys, mesh=self.mesh)
        return _psum(outs, self.mesh) if replicate_out else outs


def train_1f1b(pipe: PPipeline, x_mb, g_mb):
    raise NotImplementedError("train_1f1b (pipeline training, the 1F1B schedule): not yet "
                              "ported")
