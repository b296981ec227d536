"""Models and the inference engine of the port. `AutoLLM` dispatches by
config as the JAX package does (dense Qwen3 only so far)."""

from triton_dist_tpu_torch.models.config import (ModelConfig,  # noqa: F401
                                                 qwen3_1p7b, tiny_qwen3)
from triton_dist_tpu_torch.models.dense import DenseLLM  # noqa: F401
from triton_dist_tpu_torch.models.engine import Engine  # noqa: F401
from triton_dist_tpu_torch.models.kv_cache import KVCache, PagedSlotCache  # noqa: F401
from triton_dist_tpu_torch.models.scheduler import (  # noqa: F401
    ContinuousScheduler, Request)


class AutoLLM:
    """Config-based dispatch (dense Qwen3; MoE is not yet ported)."""

    @staticmethod
    def from_pretrained(path: str, device=None):
        cfg = ModelConfig.from_hf_config(path)
        if cfg.is_moe:
            raise NotImplementedError("MoE models: not yet ported")
        return DenseLLM.from_hf(path, device=device)

    @staticmethod
    def from_config(cfg: ModelConfig, device=None, seed: int = 0):
        if cfg.is_moe:
            raise NotImplementedError("MoE models: not yet ported")
        return DenseLLM.random_init(cfg, device=device, seed=seed)
