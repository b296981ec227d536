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
    keyword arguments (moe_impl, capacity_factor); dense configs take a
    mesh and the sequence-parallel ones (sp_axis, sp_combine) and refuse
    the MoE ones."""

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
        _dense_kw_check(kw, {"mesh", "sp_axis", "sp_combine"})
        return DenseLLM.random_init(cfg, device=device, seed=seed, **kw)


def _dense_kw_check(kw, allowed=frozenset()) -> None:
    """Dense models take no keyword arguments beyond `allowed` (a
    checkpoint loads on one device; a random model also takes a mesh and
    the sequence-parallel sp_axis and sp_combine); the rest are
    MoE-only."""
    sp = set(kw) & {"sp_axis", "sp_combine"} - set(allowed)
    if sp:
        raise NotImplementedError(f"{sorted(sp)} on a checkpoint load: not yet ported "
                                  "(build it with from_config, or DenseLLM.to_mesh)")
    extra = set(kw) - set(allowed)
    if extra:
        raise ValueError(f"MoE-only kwargs {sorted(extra)} on a dense config")
