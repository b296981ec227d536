"""Layers of the port: attention and MLP at any tensor-parallel size
(`to_mesh`), the MoE layer at one rank (TP_MoE), and the expert-parallel
MoE layer over a mesh (EP_MoE), and the sequence-parallel attention
layer (SPAttn) and its Ulysses form (UlyssesAttn), and the
pipeline-parallel forward (PPipeline)."""

from triton_dist_tpu_torch.layers.common import (  # noqa: F401
    apply_rope, apply_rope_slots, precompute_rope, rms_norm, shard_cols_packed)
from triton_dist_tpu_torch.layers.tp_attn import TP_Attn  # noqa: F401
from triton_dist_tpu_torch.layers.tp_mlp import TP_MLP  # noqa: F401
from triton_dist_tpu_torch.layers.tp_moe import TP_MoE  # noqa: F401
from triton_dist_tpu_torch.layers.ep_moe import EP_MoE  # noqa: F401
from triton_dist_tpu_torch.layers.sp_attn import SPAttn, UlyssesAttn  # noqa: F401
from triton_dist_tpu_torch.layers.pp import PPipeline  # noqa: F401
