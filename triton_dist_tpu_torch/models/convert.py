"""Build the port's DenseLLM or Qwen3MoE from the JAX model's parameters
as numpy.

`from_jax_arrays(cfg, arrays, device)` takes a flat dict of numpy
arrays named after the JAX model's attributes:
    embed, final_norm, lm_head,
    layers.{i}.attn.w_qkv / w_o / q_norm / k_norm,
    layers.{i}.mlp.w_gate_up / w_down (dense) or
    layers.{i}.moe.w_router / w_gate_up / w_down (MoE),
    layers.{i}.ln_attn / ln_mlp,
where a weight quantized to int8 (QuantW) comes as `{name}.q` and
`{name}.s`. `to_arrays(model, grads=)` goes the other way for a dense
model's parameters or their gradients, under the same names. The packed layouts ([q | k | v], [gate | up], per expert
[gate | up]) are the JAX package's at tensor-parallel size 1, so they
are copied as they are. A JAX model built over a mesh of n > 1 ranks
packs w_qkv and w_gate_up as n per-rank blocks (shard_cols_packed), and
its TP-MoE layers each expert's w_gate_up likewise (the JAX
`_pack_expert_cols`): give its size as `jax_tp`, and they are unpacked to
the one-rank layout first (a QuantW's scales with its columns). With
`mesh`, the port's model is then split over it (DenseLLM.to_mesh, or
Qwen3MoE.to_mesh for a MoE config), whatever the JAX model's size; a MoE
config with moe_impl="ep" is split by experts over `mesh` or the device's
one-rank mesh. The JAX EP model keeps each expert's [gate | up] whole
along 2I (its panels split along E), so its expert panels need no
unpacking. A JAX model built over ("tp"=1, "sp"=n) for sequence-parallel
serving keeps every weight whole and replicated (its tp axis has size 1):
its arrays carry as a one-rank model's, and sp_axis="sp" with a mesh
splits the port's model sequence-parallel (DenseLLM.to_mesh(mesh, "sp")).
This module sees numpy arrays only, never a jax object.
"""

from __future__ import annotations

import numpy as np
import torch

from triton_dist_tpu_torch.kernels.quant import QuantW
from triton_dist_tpu_torch.layers import TP_Attn, TP_MLP, TP_MoE, precompute_rope
from triton_dist_tpu_torch.layers.common import unpack_cols_packed
from triton_dist_tpu_torch.models.config import ModelConfig
from triton_dist_tpu_torch.models.dense import DenseLayer, DenseLLM
from triton_dist_tpu_torch.models.qwen_moe import MoELayer, Qwen3MoE
from triton_dist_tpu_torch.runtime.bootstrap import mesh_of
from triton_dist_tpu_torch.runtime.device import resolve_device


def to_torch(a: np.ndarray, device=None) -> torch.Tensor:
    """A copy of a numpy array as a tensor on `device`. bfloat16 arrays
    (numpy's ml_dtypes extension type, which torch.from_numpy rejects)
    travel as their uint16 bits."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def from_jax_arrays(cfg: ModelConfig, arrays: dict, device=None,
                    capacity_factor=2.0, *, mesh=None, jax_tp: int = 1,
                    moe_impl: str = "tp", jax_moe_impl=None, sp_axis=None,
                    sp_combine: str = "xla") -> DenseLLM:
    """The port's DenseLLM, or Qwen3MoE for a MoE config (with
    capacity_factor and moe_impl), holding the given parameters on
    `device` (with a mesh, on its rank 0's device, then split over it).
    jax_moe_impl: the JAX MoE model's own moe_impl, which lays out its
    expert panels ("tp" packs them per rank at jax_tp > 1, "ep" keeps them
    whole); by default the port model's. sp_axis="sp" (a dense config
    with a mesh): split sequence-parallel, merging by sp_combine."""
    dev = resolve_device(mesh.devices[0] if mesh is not None else device)

    def get(name):
        if f"{name}.q" in arrays:
            return QuantW(q=to_torch(arrays[f"{name}.q"], dev),
                          s=to_torch(arrays[f"{name}.s"], dev))
        return to_torch(arrays[name], dev)

    def opt(name):
        return get(name) if name in arrays else None

    hd = cfg.head_dim

    def packed(name, widths):
        w = get(name)
        return w if jax_tp == 1 else unpack_cols_packed(w, widths, jax_tp)

    layers = []
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        qkv = (cfg.num_heads * hd, cfg.num_kv_heads * hd, cfg.num_kv_heads * hd)
        attn = TP_Attn(w_qkv=packed(p + "attn.w_qkv", qkv), w_o=get(p + "attn.w_o"),
                       q_norm=opt(p + "attn.q_norm"), k_norm=opt(p + "attn.k_norm"),
                       n_heads=cfg.num_heads, n_kv_heads=cfg.num_kv_heads,
                       head_dim=cfg.head_dim)
        norms = dict(ln_attn=get(p + "ln_attn"), ln_mlp=get(p + "ln_mlp"))
        if cfg.is_moe:
            gu = get(p + "moe.w_gate_up")
            if jax_tp > 1 and (jax_moe_impl or moe_impl) == "tp":
                I = cfg.moe_intermediate_size
                gu = torch.stack([unpack_cols_packed(g, (I, I), jax_tp) for g in gu])
            moe = TP_MoE(w_router=get(p + "moe.w_router"), w_gate_up=gu,
                         w_down=get(p + "moe.w_down"), top_k=cfg.num_experts_per_tok,
                         capacity_factor=capacity_factor)
            layers.append(MoELayer(attn=attn, moe=moe, **norms))
        else:
            I = cfg.intermediate_size
            mlp = TP_MLP(w_gate_up=packed(p + "mlp.w_gate_up", (I, I)),
                         w_down=get(p + "mlp.w_down"))
            layers.append(DenseLayer(attn=attn, mlp=mlp, **norms))
    cos, sin = precompute_rope(cfg.head_dim, cfg.max_position_embeddings,
                               cfg.rope_theta, device=dev)
    cls = Qwen3MoE if cfg.is_moe else DenseLLM
    model = cls(embed=get("embed"), layers=layers, final_norm=get("final_norm"),
                lm_head=get("lm_head"), cos=cos, sin=sin, config=cfg)
    if cfg.is_moe and (moe_impl == "ep" or mesh is not None):
        return model.to_mesh(mesh if mesh is not None else mesh_of(dev), moe_impl)
    if mesh is None:
        return model
    return model.to_mesh(mesh, "sp" if sp_axis else "tp", sp_combine=sp_combine)


def to_arrays(model: DenseLLM, grads: bool = False) -> dict:
    """The model's parameters (DenseLLM.named_parameters), or with grads
    their .grad, as a flat dict of numpy arrays under the names of
    from_jax_arrays; bf16 is widened to f32 (exactly). A parameter with
    no gradient is left out."""
    out = {}
    for name, t in model.named_parameters():
        t = t.grad if grads else t
        if t is not None:
            out[name] = t.detach().float().cpu().numpy()
    return out
