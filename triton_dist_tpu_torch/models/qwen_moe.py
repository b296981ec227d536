"""Qwen3-MoE: counterpart of triton_dist_tpu/models/qwen_moe.py
(`MoELayer`, `Qwen3MoE` with moe_impl="tp": `random_init`, `from_hf`,
`_zero_load`, `forward_tokens`, `forward_tokens_slots`,
`forward_tokens_slots_paged`, the window forms
`forward_tokens_slots_verify` and `forward_tokens_slots_paged_verify`,
`make_cache`) on one device. The JAX
`_moe_modes` / `_moe_ffn` split exists for the expert-parallel modes;
with those not ported, the FFN hook `_ffn` is one call.

Qwen3 attention blocks (layers/tp_attn.py) with a routed-expert FFN
(layers/tp_moe.py) in place of the dense MLP. The attention, the cache
and the slot layer loops are DenseLLM's (models/dense.py): Qwen3MoE
overrides its FFN hook. Modes: "flash" (the flash-decode kernels and the
grouped-GEMM expert dispatch, TP_MoE.fwd_local) and "xla" (the plain
versions and the dense all-experts oracle, TP_MoE.fwd_xla).

With return_moe_stats=True the slot forwards also return the routing-load
vector [expert_tokens[0..E-1], capacity_dropped] (int32 [E+1], summed
over layers, on the device) that the engine and the scheduler surface as
`expert_tokens{expert=e}`, `moe_capacity_drops` and
`expert_load_imbalance`.

The window forms route every row of the window, padding included, as
the JAX forwards do: padding rows take expert capacity and count in the
routing load (compute load, not emitted tokens).

Not ported yet, and raising NotImplementedError: expert parallelism
(moe_impl="ep", the "ep"/"ep_flash" modes), the multi-chip modes and
`forward_train`. The JAX Qwen3MoE has no int8-weight form, so neither
has this one.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from triton_dist_tpu_torch.layers import TP_Attn, TP_MoE, precompute_rope
from triton_dist_tpu_torch.models.config import ModelConfig
from triton_dist_tpu_torch.models.dense import DenseLLM
from triton_dist_tpu_torch.runtime.device import resolve_device


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: not yet ported")


def _check_impl(moe_impl: str) -> None:
    if moe_impl != "tp":
        raise _not_ported(f"moe_impl={moe_impl!r} (expert parallelism)")


@dataclasses.dataclass
class MoELayer:
    attn: TP_Attn
    moe: TP_MoE
    ln_attn: torch.Tensor
    ln_mlp: torch.Tensor


@dataclasses.dataclass
class Qwen3MoE(DenseLLM):
    moe_impl: str = "tp"

    @staticmethod
    def random_init(cfg: ModelConfig, device=None, seed: int = 0, moe_impl: str = "tp",
                    capacity_factor=2.0) -> "Qwen3MoE":
        """Random weights with Qwen3-MoE shapes, drawn layer by layer in the
        model dtype on `device` (default "cuda") from a torch.Generator
        seeded with `seed`; scales as the JAX package's (1/sqrt of the
        input width, 0.02 for the router, embedding and head)."""
        _check_impl(moe_impl)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        D, I = cfg.hidden_size, cfg.moe_intermediate_size
        E, k = cfg.num_experts, cfg.num_experts_per_tok
        Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        dt = cfg.torch_dtype

        def w(*shape, scale=None):
            s = scale if scale is not None else shape[-2] ** -0.5
            return (torch.randn(shape, generator=gen, device=dev, dtype=dt)
                    * torch.tensor(s, dtype=dt, device=dev))

        def ones(n, dtype=dt):
            return torch.ones(n, dtype=dtype, device=dev)

        layers = []
        for _ in range(cfg.num_layers):
            attn = TP_Attn.init(
                w(D, Hq * hd), w(D, Hkv * hd), w(D, Hkv * hd), w(Hq * hd, D),
                n_heads=Hq, n_kv_heads=Hkv, head_dim=hd,
                q_norm=ones(hd, torch.float32), k_norm=ones(hd, torch.float32))
            moe = TP_MoE.init(w(D, E, scale=0.02), w(E, D, I), w(E, D, I), w(E, I, D),
                              top_k=k, capacity_factor=capacity_factor)
            layers.append(MoELayer(attn=attn, moe=moe, ln_attn=ones(D), ln_mlp=ones(D)))
        cos, sin = precompute_rope(hd, cfg.max_position_embeddings, cfg.rope_theta,
                                   device=dev)
        embed = w(cfg.vocab_size, D, scale=0.02)
        lm_head = (embed.T if cfg.tie_word_embeddings
                   else w(D, cfg.vocab_size, scale=0.02))
        return Qwen3MoE(embed=embed, layers=layers, final_norm=ones(D), lm_head=lm_head,
                        cos=cos, sin=sin, config=cfg, moe_impl=moe_impl)

    @staticmethod
    def from_hf(path: str, device=None, moe_impl: str = "tp",
                capacity_factor=2.0) -> "Qwen3MoE":
        """Load a HF Qwen3-MoE safetensors checkpoint from a local
        directory, stacking the per-expert projections."""
        from safetensors.torch import load_file

        _check_impl(moe_impl)
        dev = resolve_device(device)
        cfg = ModelConfig.from_hf_config(path)
        dt = cfg.torch_dtype
        tensors = {}
        for fn in sorted(os.listdir(path)):
            if fn.endswith(".safetensors"):
                tensors.update(load_file(os.path.join(path, fn)))

        def t(name, dtype=dt):
            return tensors[name].to(device=dev, dtype=dtype)

        def opt(name):
            return t(name, tensors[name].dtype) if name in tensors else None

        def proj(name):
            # HF stores projections transposed ([out, in]); kept [in, out]
            # and contiguous, the JAX layout
            return t(name).T.contiguous()

        def experts(p, which):
            return torch.stack([proj(f"{p}mlp.experts.{e}.{which}.weight")
                                for e in range(cfg.num_experts)])

        layers = []
        for li in range(cfg.num_layers):
            p = f"model.layers.{li}."
            attn = TP_Attn.init(
                proj(p + "self_attn.q_proj.weight"), proj(p + "self_attn.k_proj.weight"),
                proj(p + "self_attn.v_proj.weight"), proj(p + "self_attn.o_proj.weight"),
                n_heads=cfg.num_heads, n_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.head_dim, q_norm=opt(p + "self_attn.q_norm.weight"),
                k_norm=opt(p + "self_attn.k_norm.weight"))
            moe = TP_MoE.init(proj(p + "mlp.gate.weight"), experts(p, "gate_proj"),
                              experts(p, "up_proj"), experts(p, "down_proj"),
                              top_k=cfg.num_experts_per_tok,
                              capacity_factor=capacity_factor)
            layers.append(MoELayer(attn=attn, moe=moe,
                                   ln_attn=t(p + "input_layernorm.weight"),
                                   ln_mlp=t(p + "post_attention_layernorm.weight")))
        cos, sin = precompute_rope(cfg.head_dim, cfg.max_position_embeddings,
                                   cfg.rope_theta, device=dev)
        embed = t("model.embed_tokens.weight")
        lm_head = embed.T if cfg.tie_word_embeddings else proj("lm_head.weight")
        return Qwen3MoE(embed=embed, layers=layers, final_norm=t("model.norm.weight"),
                        lm_head=lm_head, cos=cos, sin=sin, config=cfg, moe_impl=moe_impl)

    def quantize_int8(self):
        raise _not_ported("int8 weights of a MoE model (the JAX Qwen3MoE has none)")

    def _zero_load(self) -> torch.Tensor:
        """Fresh routing-load accumulator [expert_tokens[0..E-1],
        capacity_dropped] (int32, on the model's device)."""
        return torch.zeros(self.config.num_experts + 1, dtype=torch.int32,
                           device=self.device)

    def _ffn(self, layer, h, mode: str, load):
        """The routed FFN on the normed rows h ("flash": TP_MoE.fwd_local,
        "xla": the dense oracle; the EP and multi-chip modes raise in
        TP_MoE). Adds the call's routing load to `load` when the caller
        asked for stats (load is None otherwise)."""
        if load is None:
            return layer.moe(h, mode).to(h.dtype), None
        y, st = layer.moe(h, mode, return_stats=True)
        return y.to(h.dtype), load + torch.cat([st["expert_tokens"], st["dropped"].reshape(1)])

    def forward_tokens_slots(self, ids, cache, pos, mode: str = "flash",
                             return_moe_stats: bool = False):
        """DenseLLM.forward_tokens_slots with the routed FFN; with
        return_moe_stats the tick's routing-load vector comes third."""
        load = self._zero_load() if return_moe_stats else None
        logits, load = self._slots_forward(ids, self._slot_attend(cache, pos, mode), mode,
                                           load)
        return (logits, cache, load) if return_moe_stats else (logits, cache)

    def forward_tokens_slots_paged(self, ids, pcache, pos, mode: str = "flash",
                                   return_moe_stats: bool = False):
        """forward_tokens_slots over the paged pool (PagedSlotCache)."""
        load = self._zero_load() if return_moe_stats else None
        logits, load = self._slots_forward(ids, self._paged_attend(pcache, pos, mode), mode,
                                           load)
        return (logits, pcache, load) if return_moe_stats else (logits, pcache)

    def forward_tokens_slots_verify(self, ids, cache, pos, q_lens, mode: str = "flash",
                                    return_moe_stats: bool = False):
        """DenseLLM.forward_tokens_slots_verify with the routed FFN over
        the whole window; with return_moe_stats the routing-load vector
        comes third."""
        load = self._zero_load() if return_moe_stats else None
        logits, load = self._slots_forward(ids, self._slot_attend(cache, pos, mode, q_lens),
                                           mode, load, window=True)
        return (logits, cache, load) if return_moe_stats else (logits, cache)

    def forward_tokens_slots_paged_verify(self, ids, pcache, pos, q_lens,
                                          mode: str = "flash",
                                          return_moe_stats: bool = False):
        """forward_tokens_slots_verify over the paged pool (also the
        chunked-prefill mixed tick's forward)."""
        load = self._zero_load() if return_moe_stats else None
        logits, load = self._slots_forward(
            ids, self._paged_attend(pcache, pos, mode, q_lens), mode, load, window=True)
        return (logits, pcache, load) if return_moe_stats else (logits, pcache)

    def forward_train(self, *args, **kw):
        raise _not_ported("Qwen3MoE.forward_train (training)")

    def named_parameters(self):
        raise _not_ported("Qwen3MoE.named_parameters (training)")
