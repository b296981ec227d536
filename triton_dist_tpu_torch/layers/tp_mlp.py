"""SwiGLU MLP block.

Counterpart of triton_dist_tpu/layers/tp_mlp.py (`TP_MLP.init`,
`fwd_xla`, `fwd_flash`, `fwd_ar`, `fwd_gemm_ar`, `__call__` (whose mode
"dist" is the JAX `fwd_dist`), and the training forms
`_local_swiglu`/`fwd_train`). The packed layout is kept:
w_gate_up is [D, 2I] = [gate | up].

Tensor parallelism (`to_mesh`, or `init(..., mesh=)`): over a mesh of n
ranks the layer holds `shards`, one TP_MLP per rank with its I/n columns
of gate and up (the JAX per-rank block [gate_r | up_r]) and its rows of
w_down on the rank's device; the forward takes and returns lists, one
tensor per rank, and ends in the mode's epilogue (layers/tp_attn.py
`tp_down`); on "dist" it takes and returns row shards (ag_gemm ->
SwiGLU -> gemm_rs, `tp_up` then `tp_down`). "dist", "ar" and "gemm_ar"
run the SwiGLU kernel between the projections, where the JAX modes run
the plain jnp SwiGLU: the kernel is the port's, and its plain version is
what "xla" runs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch.nn.functional as F

from triton_dist_tpu_torch.kernels.allgather_gemm import ag_gemm
from triton_dist_tpu_torch.kernels.gemm_reduce_scatter import gemm_rs
from triton_dist_tpu_torch.kernels.grad import ag_gemm_grad, gemm_rs_grad
from triton_dist_tpu_torch.kernels.quant import Weight, qmm
from triton_dist_tpu_torch.kernels.swiglu import swiglu, swiglu_ref
from triton_dist_tpu_torch.layers.common import (shard_cols_packed, split_packed, split_rows,
                                                 weight_to)
from triton_dist_tpu_torch.layers.tp_attn import check_mode, tp_down, tp_up
from triton_dist_tpu_torch.runtime.bootstrap import mesh_of


@dataclasses.dataclass
class TP_MLP:
    """w_gate_up: [D, 2I] packed [gate | up]; w_down: [I, D]."""

    w_gate_up: Weight
    w_down: Weight
    # tensor parallelism: the mesh and one TP_MLP per rank; the weight
    # fields above are then None
    mesh: Optional[object] = None
    shards: Optional[list] = None

    @staticmethod
    def init(w_gate, w_up, w_down, mesh=None) -> "TP_MLP":
        mlp = TP_MLP(w_gate_up=shard_cols_packed([w_gate, w_up], 1), w_down=w_down)
        return mlp if mesh is None or mesh.size == 1 else mlp.to_mesh(mesh)

    def to_mesh(self, mesh) -> "TP_MLP":
        """This one-rank block split over `mesh`: rank r keeps columns
        [r*I/n, (r+1)*I/n) of gate and up and those rows of w_down."""
        n = mesh.size
        I2 = (self.w_gate_up.q if hasattr(self.w_gate_up, "q") else self.w_gate_up).shape[1]
        if (I2 // 2) % n:
            raise ValueError(f"the MLP width {I2 // 2} is not divisible by {n} ranks")
        gu = split_packed(self.w_gate_up, (I2 // 2, I2 // 2), n)
        wd = split_rows(self.w_down, n)
        return TP_MLP(w_gate_up=None, w_down=None, mesh=mesh,
                      shards=[TP_MLP(w_gate_up=weight_to(gu[r], d), w_down=weight_to(wd[r], d))
                              for r, d in enumerate(mesh.devices)])

    def fwd_xla(self, x):
        """Plain path: the SwiGLU's plain PyTorch version between the
        projections (at n > 1, then the psum's plain version)."""
        return self._tp("xla", x)

    def fwd_flash(self, x):
        """Kernel path: the CUDA SwiGLU kernel between the projections (at
        n > 1, then the psum's plain version)."""
        return self._tp("flash", x)

    def fwd_ar(self, x):
        """Local products, then the all_reduce kernel."""
        return self._tp("ar", x)

    def fwd_gemm_ar(self, x):
        """The up projection and SwiGLU, then gemm_allreduce for the down
        projection."""
        return self._tp("gemm_ar", x)

    def _tp(self, mode: str, x):
        act = swiglu_ref if mode == "xla" else swiglu
        if self.shards is None:
            if mode == "dist":
                return gemm_rs(act(ag_gemm(x, self.w_gate_up)), self.w_down)
            h = act(qmm(x, self.w_gate_up))
            if mode in ("flash", "xla"):
                return qmm(h, self.w_down)
            return tp_down(mode, [h], [self.w_down], mesh_of(x.device))[0]
        hs = [act(c) for c in tp_up(mode, x, [s.w_gate_up for s in self.shards], self.mesh)]
        return tp_down(mode, hs, [s.w_down for s in self.shards], self.mesh)

    @staticmethod
    def _local_swiglu(c):
        """silu(gate) * up of c = [..., 2I] packed [gate | up], the JAX
        swiglu_ref math under autograd (not kernels/swiglu.py's
        swiglu_ref, which follows the serving kernel's roundings)."""
        g, u = c.chunk(2, dim=-1)
        return F.silu(g) * u

    def fwd_train(self, x, impl: str = "dist"):
        """Differentiable MLP for training. impl "dist": ag_gemm -> SwiGLU
        -> gemm_rs, each product with its kernel backward
        (kernels/grad.py); any other impl: the plain oracle, the JAX
        fwd_xla math (plain products around _local_swiglu). x: [M, D]."""
        if self.shards is not None:
            raise NotImplementedError("the training MLP at tensor-parallel size > 1: not "
                                      "yet ported")
        if impl == "dist":
            c = ag_gemm_grad()(x, self.w_gate_up)
            return gemm_rs_grad()(self._local_swiglu(c), self.w_down)
        return self._local_swiglu(x @ self.w_gate_up) @ self.w_down

    def __call__(self, x, mode: str = "flash"):
        check_mode(mode)
        return self._tp(mode, x)
