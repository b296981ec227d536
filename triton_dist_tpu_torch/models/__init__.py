"""Models and the inference engine of the port. `AutoLLM` dispatches by
config as the JAX package does: dense Qwen3 to DenseLLM, Qwen3-MoE to
Qwen3MoE."""

from triton_dist_tpu_torch.models.config import (ModelConfig,  # noqa: F401
                                                 qwen3_1p7b, qwen3_30b_a3b,
                                                 tiny_qwen3, tiny_qwen3_moe)
from triton_dist_tpu_torch.models.dense import DenseLLM  # noqa: F401
from triton_dist_tpu_torch.models.engine import Engine  # noqa: F401
from triton_dist_tpu_torch.models.kv_cache import KVCache, PagedSlotCache  # noqa: F401
from triton_dist_tpu_torch.models.qwen_moe import Qwen3MoE  # noqa: F401
from triton_dist_tpu_torch.models.scheduler import (  # noqa: F401
    ContinuousScheduler, Request)


class AutoLLM:
    """Config-based dispatch. MoE configs go to Qwen3MoE and take its
    keyword arguments (moe_impl, capacity_factor); dense configs refuse
    them."""

    @staticmethod
    def from_pretrained(path: str, device=None, **kw):
        cfg = ModelConfig.from_hf_config(path)
        if cfg.is_moe:
            return Qwen3MoE.from_hf(path, device=device, **kw)
        _dense_kw_check(kw)
        return DenseLLM.from_hf(path, device=device)

    @staticmethod
    def from_config(cfg: ModelConfig, device=None, seed: int = 0, **kw):
        if cfg.is_moe:
            return Qwen3MoE.random_init(cfg, device=device, seed=seed, **kw)
        _dense_kw_check(kw)
        return DenseLLM.random_init(cfg, device=device, seed=seed)


def _dense_kw_check(kw) -> None:
    """Dense models take no extra keyword arguments: the JAX package's
    sequence-parallel ones are not ported, the rest are MoE-only."""
    sp = set(kw) & {"sp_axis", "sp_combine"}
    if sp:
        raise NotImplementedError(f"{sorted(sp)} (sequence-parallel serving): not yet "
                                  "ported")
    if kw:
        raise ValueError(f"MoE-only kwargs {sorted(kw)} on a dense config")
