"""SwiGLU MLP block.

Counterpart of triton_dist_tpu/layers/tp_mlp.py (`TP_MLP.init`,
`fwd_xla`, `fwd_flash`, `__call__`, and the training forms
`_local_swiglu`/`fwd_train`) at tensor-parallel size 1. The packed
layout is kept: w_gate_up is [D, 2I] = [gate | up].
"""

from __future__ import annotations

import dataclasses

import torch.nn.functional as F

from triton_dist_tpu_torch.kernels.grad import ag_gemm_grad, gemm_rs_grad
from triton_dist_tpu_torch.kernels.quant import Weight, qmm
from triton_dist_tpu_torch.kernels.swiglu import swiglu, swiglu_ref
from triton_dist_tpu_torch.layers.common import shard_cols_packed
from triton_dist_tpu_torch.layers.tp_attn import check_mode


@dataclasses.dataclass
class TP_MLP:
    """w_gate_up: [D, 2I] packed [gate | up]; w_down: [I, D]."""

    w_gate_up: Weight
    w_down: Weight

    @staticmethod
    def init(w_gate, w_up, w_down) -> "TP_MLP":
        return TP_MLP(w_gate_up=shard_cols_packed([w_gate, w_up], 1),
                      w_down=w_down)

    def fwd_xla(self, x):
        """Plain path: the SwiGLU's plain PyTorch version between the
        projections."""
        return qmm(swiglu_ref(qmm(x, self.w_gate_up)), self.w_down)

    def fwd_flash(self, x):
        """Kernel path: the CUDA SwiGLU kernel between the projections."""
        return qmm(swiglu(qmm(x, self.w_gate_up)), self.w_down)

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
        if impl == "dist":
            c = ag_gemm_grad()(x, self.w_gate_up)
            return gemm_rs_grad()(self._local_swiglu(c), self.w_down)
        return self._local_swiglu(x @ self.w_gate_up) @ self.w_down

    def __call__(self, x, mode: str = "flash"):
        check_mode(mode)
        return self.fwd_flash(x) if mode == "flash" else self.fwd_xla(x)
