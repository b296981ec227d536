"""Model configuration: counterpart of triton_dist_tpu/models/config.py,
with `torch_dtype` in place of `jax_dtype`."""

from __future__ import annotations

import dataclasses
import json
import os

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    hidden_size: int = 1024
    intermediate_size: int = 3072
    num_layers: int = 28
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 128
    vocab_size: int = 151936
    max_position_embeddings: int = 40960
    rope_theta: float = 1e6
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = False
    model_type: str = "qwen3"
    # MoE (Qwen3-MoE family; 0 experts => dense)
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    dtype: str = "bfloat16"

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @staticmethod
    def from_hf_config(path_or_dict) -> "ModelConfig":
        """Build from a HF config.json (a dict, the file, or its local
        directory)."""
        if isinstance(path_or_dict, dict):
            d = path_or_dict
        else:
            p = path_or_dict
            if os.path.isdir(p):
                p = os.path.join(p, "config.json")
            with open(p) as f:
                d = json.load(f)
        return ModelConfig(
            hidden_size=d["hidden_size"],
            intermediate_size=d.get("intermediate_size", 0),
            num_layers=d["num_hidden_layers"],
            num_heads=d["num_attention_heads"],
            num_kv_heads=d.get("num_key_value_heads", d["num_attention_heads"]),
            head_dim=d.get("head_dim",
                           d["hidden_size"] // d["num_attention_heads"]),
            vocab_size=d["vocab_size"],
            max_position_embeddings=d.get("max_position_embeddings", 40960),
            rope_theta=d.get("rope_theta", 1e6),
            rms_norm_eps=d.get("rms_norm_eps", 1e-6),
            tie_word_embeddings=d.get("tie_word_embeddings", False),
            model_type=d.get("model_type", "qwen3"),
            num_experts=d.get("num_experts", 0),
            num_experts_per_tok=d.get("num_experts_per_tok", 0),
            moe_intermediate_size=d.get("moe_intermediate_size", 0),
        )


def tiny_qwen3(n: int = 8, **overrides) -> ModelConfig:
    """A tiny Qwen3-shaped config (the test model); n sets the head
    counts as in the JAX package."""
    base = dict(hidden_size=64, intermediate_size=128, num_layers=2,
                num_heads=2 * n, num_kv_heads=n, head_dim=32,
                vocab_size=256, max_position_embeddings=128,
                dtype="float32")
    base.update(overrides)
    return ModelConfig(**base)


def tiny_qwen3_moe(n: int = 8, **overrides) -> ModelConfig:
    """A tiny Qwen3-MoE-shaped config (the MoE test model); n sets the
    head and expert counts as in the JAX package."""
    base = dict(hidden_size=64, intermediate_size=0, num_layers=2,
                num_heads=2 * n, num_kv_heads=n, head_dim=32,
                vocab_size=256, max_position_embeddings=128,
                num_experts=2 * n, num_experts_per_tok=2,
                moe_intermediate_size=32, dtype="float32")
    base.update(overrides)
    return ModelConfig(**base)


def qwen3_30b_a3b() -> ModelConfig:
    """Qwen3-30B-A3B shapes (the public Qwen/Qwen3-30B-A3B config.json):
    48 layers, 128 experts, top-8, expert width 768, untied head."""
    return ModelConfig(hidden_size=2048, intermediate_size=6144,
                       num_layers=48, num_heads=32, num_kv_heads=4,
                       head_dim=128, vocab_size=151936,
                       num_experts=128, num_experts_per_tok=8,
                       moe_intermediate_size=768)


def qwen3_1p7b() -> ModelConfig:
    """Qwen3-1.7B shapes."""
    return ModelConfig(hidden_size=2048, intermediate_size=6144,
                       num_layers=28, num_heads=16, num_kv_heads=8,
                       head_dim=128, vocab_size=151936,
                       tie_word_embeddings=True)
