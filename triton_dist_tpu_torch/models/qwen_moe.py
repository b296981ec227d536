"""Qwen3-MoE: counterpart of triton_dist_tpu/models/qwen_moe.py
(`MoELayer`, `Qwen3MoE` with `random_init`, `from_hf`, `ep_axis`,
`ep_size`, `_moe_modes`, `_zero_load`, `_moe_ffn`, `forward_tokens`,
`forward_tokens_slots`, `forward_tokens_slots_paged`, the window forms
`forward_tokens_slots_verify` and `forward_tokens_slots_paged_verify`,
`make_cache`).

Qwen3 attention blocks (layers/tp_attn.py) with a routed-expert FFN in
place of the dense MLP. The attention, the cache and the slot layer
loops are DenseLLM's (models/dense.py): Qwen3MoE overrides its FFN hooks
and its attention mode. Two FFN forms, chosen at construction
(`moe_impl`), as in the JAX package:
- "tp": TP_MoE (layers/tp_moe.py), at one rank or over a mesh of n ranks
  (`to_mesh(mesh, "tp")`, or `random_init(..., mesh=)`): the attention
  split by heads as DenseLLM.to_mesh splits it, each expert's
  intermediate columns split by rank (views of the one-rank model's
  panels), the router on every rank. The FFN runs the model's mode (the
  JAX `_moe_modes`): "flash", "ar" and "gemm_ar" TP_MoE.fwd_local on the
  replicated stream (the grouped-GEMM kernel on each rank's columns, the
  partials summed), "dist" TP_MoE.fwd_dist on the row-sharded stream
  (all_gather, the grouped GEMMs, reduce_scatter; padding rows cut before
  the routing), "xla" the dense all-experts oracle.
- "ep": EP_MoE (layers/ep_moe.py), the experts split over a mesh of n
  ranks (`to_mesh`, or `random_init(..., mesh=)`): the attention split by
  heads as DenseLLM.to_mesh splits it, the expert panels by rank (views
  of the one-rank model's storage), the router on every rank. Modes (the
  JAX `_moe_modes`): "ep" runs the attention on "dist" (the ag_gemm and
  gemm_rs rings on a row-sharded residual stream) and the FFN through
  EP_MoE.fwd_ep (dispatch_a2a, the grouped GEMMs, the all_to_all
  combine) on the same row shards; "ep_flash" runs the attention on
  "flash" (head groups split over the mesh, the stream replicated) and
  the same EP FFN on each rank's row shard of it, the outputs gathered
  back; any other mode runs the FFN as the dense oracle (fwd_xla). A
  forward's rows that the mesh does not divide are padded with zero rows
  that route nowhere and count in no load (layers/ep_moe.py).

With return_moe_stats=True the slot forwards also return the routing-load
vector [expert_tokens[0..E-1], capacity_dropped] (int32 [E+1], summed
over layers and, on "ep", over ranks, the JAX psum; on rank 0's device)
that the engine and the scheduler surface as `expert_tokens{expert=e}`,
`moe_capacity_drops` and `expert_load_imbalance`.

The window forms route every row of the window, padding included, as
the JAX forwards do: padding rows take expert capacity and count in the
routing load (compute load, not emitted tokens); they run at one rank.

Not ported yet, and raising NotImplementedError: the hybrid EP + TP mesh
(`moe_axis`) and `forward_train`. The JAX Qwen3MoE has no int8-weight
form, so neither has this one.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from triton_dist_tpu_torch.layers import EP_MoE, TP_Attn, TP_MoE, precompute_rope
from triton_dist_tpu_torch.models.config import ModelConfig
from triton_dist_tpu_torch.models.dense import DenseLLM
from triton_dist_tpu_torch.runtime.bootstrap import mesh_of
from triton_dist_tpu_torch.runtime.device import resolve_device


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: not yet ported")


def _check_impl(moe_impl: str, moe_axis=None) -> None:
    if moe_impl not in ("tp", "ep"):
        raise ValueError(f"moe_impl {moe_impl!r}: want 'tp' or 'ep'")
    if moe_axis is not None:
        raise _not_ported("moe_axis (the hybrid EP + TP mesh)")


@dataclasses.dataclass
class MoELayer:
    attn: TP_Attn
    moe: object                  # TP_MoE or EP_MoE
    ln_attn: object
    ln_mlp: object


@dataclasses.dataclass
class Qwen3MoE(DenseLLM):
    moe_impl: str = "tp"

    @staticmethod
    def random_init(cfg: ModelConfig, device=None, seed: int = 0, moe_impl: str = "tp",
                    capacity_factor=2.0, mesh=None, moe_axis=None) -> "Qwen3MoE":
        """Random weights with Qwen3-MoE shapes, drawn layer by layer in the
        model dtype on `device` (default "cuda") from a torch.Generator
        seeded with `seed`; scales as the JAX package's (1/sqrt of the
        input width, 0.02 for the router, embedding and head). moe_impl
        "ep", or a mesh of n > 1 ranks: the one-rank model of the seed drawn
        on the mesh's rank 0 (or on `device`, a one-rank mesh), then split
        (`to_mesh`)."""
        _check_impl(moe_impl, moe_axis)
        if moe_impl == "ep" or (mesh is not None and mesh.size > 1):
            dev = mesh.devices[0] if mesh is not None else device
            one = Qwen3MoE.random_init(cfg, dev, seed, capacity_factor=capacity_factor)
            return one.to_mesh(mesh if mesh is not None else mesh_of(one.device), moe_impl)
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
                capacity_factor=2.0, mesh=None, moe_axis=None) -> "Qwen3MoE":
        """Load a HF Qwen3-MoE safetensors checkpoint from a local
        directory, stacking the per-expert projections (moe_impl "ep":
        then split over `mesh`, as random_init)."""
        from safetensors.torch import load_file

        _check_impl(moe_impl, moe_axis)
        if moe_impl == "ep" or (mesh is not None and mesh.size > 1):
            one = Qwen3MoE.from_hf(path, mesh.devices[0] if mesh is not None else device,
                                   capacity_factor=capacity_factor)
            return one.to_mesh(mesh if mesh is not None else mesh_of(one.device), moe_impl)
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

    def to_mesh(self, mesh, moe_impl: Optional[str] = None) -> "Qwen3MoE":
        """This one-rank TP_MoE model over `mesh`: each layer's attention
        split by heads (TP_Attn.to_mesh; a mesh of one rank keeps it whole),
        norms and the router on every rank, and the experts split by
        moe_impl (None: the model's own): "tp" each expert's intermediate
        columns by rank (TP_MoE.to_mesh), "ep" the experts by rank, rank r
        taking experts [r*E/n, (r+1)*E/n) (EP_MoE.from_packed); either way
        rank r's panels are views of the model's where its device is the
        same. The embedding, the head and the rope tables stay as they are,
        on rank 0. A "tp" split over one rank returns the model itself."""
        moe_impl = moe_impl or self.moe_impl
        _check_impl(moe_impl)
        if self.moe_impl != "tp" or self.mesh is not None:
            raise ValueError("to_mesh takes the one-rank TP_MoE model")
        split = mesh.size > 1
        if moe_impl == "tp" and not split:
            return self
        layers = []
        for ly in self.layers:
            tp = ly.moe
            moe = (tp.to_mesh(mesh) if moe_impl == "tp" else
                   EP_MoE.from_packed(tp.w_router, tp.w_gate_up, tp.w_down, mesh=mesh,
                                      top_k=tp.top_k, capacity_factor=tp.capacity_factor))
            layers.append(MoELayer(
                attn=ly.attn.to_mesh(mesh) if split else ly.attn, moe=moe,
                ln_attn=mesh.replicate(ly.ln_attn) if split else ly.ln_attn,
                ln_mlp=mesh.replicate(ly.ln_mlp) if split else ly.ln_mlp))
        d0 = mesh.devices[0]
        rope = [(self.cos.to(d), self.sin.to(d)) for d in mesh.devices] if split else None
        return Qwen3MoE(embed=self.embed.to(d0), layers=layers,
                        final_norm=self.final_norm.to(d0), lm_head=self.lm_head.to(d0),
                        cos=self.cos.to(d0), sin=self.sin.to(d0), config=self.config,
                        mesh=mesh if split else None, rope=rope, moe_impl=moe_impl)

    @property
    def ep_axis(self) -> str:
        """The mesh axis the expert panels split over (the port's one
        axis)."""
        return "tp"

    @property
    def ep_size(self) -> int:
        """Expert-parallel degree: the rows of a serving tick (its slot
        batch) must divide by it (Engine.make_slot_cache checks)."""
        return self.layers[0].moe.n if self.moe_impl == "ep" else 1

    def quantize_int8(self):
        raise _not_ported("int8 weights of a MoE model (the JAX Qwen3MoE has none)")

    def _zero_load(self) -> torch.Tensor:
        """Fresh routing-load accumulator [expert_tokens[0..E-1],
        capacity_dropped] (int32, on the model's device)."""
        return torch.zeros(self.config.num_experts + 1, dtype=torch.int32,
                           device=self.device)

    def _moe_modes(self, mode: str):
        """(attention mode, FFN mode) of a model-level mode: "ep" pairs the
        "dist" attention with the EP dispatch, "ep_flash" the "flash"
        attention with the same dispatch; an EP model runs every other mode's
        FFN as the dense oracle ("xla"), a TP_MoE model its own mode."""
        attn = "dist" if mode == "ep" else "flash" if mode == "ep_flash" else mode
        if self.moe_impl == "ep":
            return attn, "ep" if mode in ("ep", "ep_flash") else "xla"
        return attn, mode

    def _attn_mode(self, mode: str) -> str:
        return self._moe_modes(mode)[0]

    @staticmethod
    def _add_load(load, st):
        """The routing-load accumulator plus one call's stats."""
        return load + torch.cat([st["expert_tokens"].to(load.device),
                                 st["dropped"].reshape(1).to(load.device)])

    def _ffn(self, layer, h, mode: str, load):
        """The routed FFN on the normed rows h at one rank (TP_MoE: "flash"
        fwd_local, "xla" the dense oracle; EP_MoE over its one-rank mesh:
        the `_moe_modes` FFN mode). Adds the call's routing load to `load`
        when the caller asked for stats (load is None otherwise)."""
        ffn_mode = self._moe_modes(mode)[1]
        if load is None:
            return layer.moe(h, ffn_mode).to(h.dtype), None
        y, st = layer.moe(h, ffn_mode, return_stats=True)
        return y.to(h.dtype), self._add_load(load, st)

    def _ffn_ranks(self, layer, hs, mode: str, load, rows: int):
        """The FFN at n > 1 ranks on the stack's lists. TP_MoE: the mode's
        form on the ranks' rows as the stack holds them (row shards on
        "dist", with the `rows` real ones; copies otherwise). EP_MoE: on the
        row shards of a "dist" stack directly; on a replicated stack
        ("ep_flash", "flash", "xla") rank r takes its row shard of its own
        copy (rows padded to a multiple of n), and the output shards are
        gathered to rank 0 and copied back to every rank (the plain
        all-gather, as those modes' psum is the plain one)."""
        attn_mode, ffn_mode = self._moe_modes(mode)
        moe, n = layer.moe, self.mesh.size
        if self.moe_impl == "tp":
            kw = {"rows": rows} if ffn_mode == "dist" else {}
            out = moe(hs, ffn_mode, return_stats=load is not None, **kw)
            ys, st = out if load is not None else (out, None)
            if st is not None:
                load = self._add_load(load, st)
            return [y.to(h.dtype) for y, h in zip(ys, hs)], load
        if attn_mode == "dist":
            shards = hs
        else:
            m = -(-rows // n)
            shards = [torch.nn.functional.pad(h, (0, 0, 0, n * m - rows))[r * m:(r + 1) * m]
                      for r, h in enumerate(hs)]
        out = moe(shards, ffn_mode, rows=rows, return_stats=load is not None)
        ys, st = out if load is not None else (out, None)
        if st is not None:
            load = self._add_load(load, st)
        if attn_mode != "dist":
            dev0 = self.mesh.devices[0]
            ys = self.mesh.replicate(torch.cat([y.to(dev0) for y in ys])[:rows])
        return [y.to(h.dtype) for y, h in zip(ys, hs)], load

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
