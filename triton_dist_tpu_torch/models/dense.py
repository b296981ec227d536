"""Dense Qwen3-family LLM: counterpart of triton_dist_tpu/models/dense.py
(`random_init`, `from_hf`, `quantize_int8`, `forward_tokens`,
`forward_tokens_slots`, `forward_tokens_slots_paged`, their window forms
`forward_tokens_slots_verify` and `forward_tokens_slots_paged_verify`,
`forward_train`, `make_cache`).

The model is a dataclass of tensors (the JAX pytree's leaves);
`forward_tokens` fills the cache in place. `forward_train` runs under
torch.autograd on the parameters that `named_parameters` lists and
`requires_grad_` marks.

Tensor parallelism (`to_mesh`, `random_init(..., mesh=)`): over a mesh of
n > 1 ranks each layer's attention and MLP hold per-rank shards
(layers/tp_attn.py, tp_mlp.py) and its norms one copy per rank. The
residual stream is replicated, one copy per rank: the embedding lookup
runs on rank 0 and its rows are copied to every rank's device; each
layer's epilogue (the mode's all-reduce) leaves every rank the same sum;
the final RMSNorm and the LM head run on rank 0's copy, so the logits,
the argmax and the next tokens live on rank 0 (the JAX global-view ops
put them on the replicated array; here rank 0 holds them). On "dist"
the residual stream is row-sharded instead (`_tp_stack`): the M rows are
padded with zero rows to a multiple of n and rank r holds rows [r * m,
(r + 1) * m), each layer runs RMSNorm on its shard, ag_gemm before and
gemm_rs after the attention and the MLP; then the shards are copied to
rank 0 (the counterpart of the JAX `_gather_rows` all_gather, as the
psum of "flash"/"xla" is all_reduce_ref) and the padding dropped before
the final norm. Zero rows stay zero through RMSNorm, both rings, the
SwiGLU and the residual adds, and no padding row reaches the attention,
the KV cache or the logits. The JAX
random_init draws every weight from one key stream whatever the mesh;
here the one-rank model is drawn from the seed and then split, so a
model of n ranks equals the one-rank model of the same seed. Only the
decode forwards (`forward_tokens`, `forward_tokens_slots`,
`forward_tokens_slots_paged`) run at n > 1; the window forms and training
stay at one rank. A MoE model (models/qwen_moe.py) runs the same stack
with its own FFN hook (`_ffn_ranks`) and attention mode (`_attn_mode`).

Sequence parallelism (`to_mesh(mesh, "sp", sp_combine=)`,
`random_init(..., mesh=, sp_axis="sp")`; the JAX model's `sp_axis` and
`sp_combine` over a ("tp"=1, "sp"=n) mesh): the model stays one rank
(tp = 1) and its mesh is the sp axis. The weights are replicated, one
copy per distinct device (ranks on one card share it: `sp_layers`), and
every layer runs once per distinct device; only the paged pool's page
ids split over the ranks (models/kv_cache.py), so the paged slot
forwards (`forward_tokens_slots_paged` and its window form) run each
layer's attention as the SP attend (layers/tp_attn.py
`fwd_cached_slots_paged_sp`: per-rank partials, then sp_combine
"xla" or "dist"). `forward_tokens` (prefill, the paged admissions'
suffix forward) runs on rank 0's device over a contiguous cache, as the
JAX model runs it replicated.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from triton_dist_tpu_torch.kernels.quant import (QuantW, Weight, _mm_f32, qmm, quantize_int8,
                                                 quantize_int8_rows)
from triton_dist_tpu_torch.layers import TP_Attn, TP_MLP, precompute_rope, rms_norm
from triton_dist_tpu_torch.layers.common import weight_to
from triton_dist_tpu_torch.models.config import ModelConfig
from triton_dist_tpu_torch.models.kv_cache import KVCache
from triton_dist_tpu_torch.runtime.device import resolve_device


class _HeadF32(torch.autograd.Function):
    """logits = x @ w with an f32 result and f32 accumulation, the weight
    not widened on the card (kernels/quant.py _mm_f32); the gradients come
    in the operands' dtype, from the f32 cotangent rounded to it."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return (g @ w.T if ctx.needs_input_grad[0] else None,
                x.T @ g if ctx.needs_input_grad[1] else None)


@dataclasses.dataclass
class DenseLayer:
    attn: TP_Attn
    mlp: TP_MLP
    ln_attn: torch.Tensor
    ln_mlp: torch.Tensor


@dataclasses.dataclass
class DenseLLM:
    embed: torch.Tensor          # [V, D]
    layers: list                 # of DenseLayer
    final_norm: torch.Tensor     # [D]
    lm_head: Weight              # [D, V]
    cos: torch.Tensor
    sin: torch.Tensor
    config: ModelConfig
    # tensor parallelism: the mesh (None: one rank) and each rank's (cos,
    # sin) on its device
    mesh: Optional[object] = None
    rope: Optional[list] = None
    # sequence parallelism: the mesh is the sp axis ("sp"); sp_combine
    # merges the ranks' partials ("xla" | "dist"); sp_layers holds the
    # layers on each distinct device of the mesh (the first: `layers`),
    # rope then (cos, sin) per distinct device
    sp_axis: Optional[str] = None
    sp_combine: str = "xla"
    sp_layers: Optional[list] = None

    @property
    def device(self) -> torch.device:
        """Rank 0's device: the embedding, the head and the logits'."""
        return self.embed.device

    @property
    def tp(self) -> int:
        return 1 if self.mesh is None or self.sp_axis else self.mesh.size

    @property
    def sp_size(self) -> int:
        """The sp mesh size the paged pool's page ids split over (1: no
        sequence parallelism)."""
        return self.mesh.size if self.sp_axis else 1

    @staticmethod
    def random_init(cfg: ModelConfig, device=None, seed: int = 0, mesh=None,
                    sp_axis: Optional[str] = None, sp_combine: str = "xla") -> "DenseLLM":
        """Random weights with Qwen3 shapes, drawn on `device` (default
        "cuda"; with a mesh, its rank 0's) from a torch.Generator seeded
        with `seed`. A tied head is a view of the embedding. With a mesh
        of n > 1 ranks the one-rank model is drawn, then split over it
        (`to_mesh`): by heads, or with sp_axis="sp" sequence-parallel
        (sp_combine "xla" or "dist")."""
        if sp_axis is not None and sp_axis != "sp":
            raise ValueError(f"sp_axis {sp_axis!r}: the port's meshes have one axis; pass "
                             "sp_axis='sp' to split the paged pool over the mesh")
        if mesh is not None and mesh.size > 1:
            return DenseLLM.random_init(cfg, mesh.devices[0], seed).to_mesh(
                mesh, "sp" if sp_axis else "tp", sp_combine=sp_combine)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        D, I = cfg.hidden_size, cfg.intermediate_size
        Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        dt = cfg.torch_dtype

        def w(*shape, scale=None):
            s = scale if scale is not None else shape[0] ** -0.5
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
            mlp = TP_MLP.init(w(D, I), w(D, I), w(I, D))
            layers.append(DenseLayer(attn=attn, mlp=mlp, ln_attn=ones(D),
                                     ln_mlp=ones(D)))
        cos, sin = precompute_rope(hd, cfg.max_position_embeddings,
                                   cfg.rope_theta, device=dev)
        embed = w(cfg.vocab_size, D, scale=0.02)
        lm_head = (embed.T if cfg.tie_word_embeddings
                   else w(D, cfg.vocab_size, scale=0.02))
        return DenseLLM(embed=embed, layers=layers, final_norm=ones(D),
                        lm_head=lm_head, cos=cos, sin=sin, config=cfg)

    @staticmethod
    def from_hf(path: str, device=None) -> "DenseLLM":
        """Load a HF Qwen3 safetensors checkpoint from a local directory."""
        from safetensors.torch import load_file

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

        layers = []
        for li in range(cfg.num_layers):
            p = f"model.layers.{li}."
            # HF stores projections transposed ([out, in])
            attn = TP_Attn.init(
                t(p + "self_attn.q_proj.weight").T, t(p + "self_attn.k_proj.weight").T,
                t(p + "self_attn.v_proj.weight").T, t(p + "self_attn.o_proj.weight").T,
                n_heads=cfg.num_heads, n_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.head_dim, q_norm=opt(p + "self_attn.q_norm.weight"),
                k_norm=opt(p + "self_attn.k_norm.weight"))
            mlp = TP_MLP.init(t(p + "mlp.gate_proj.weight").T,
                              t(p + "mlp.up_proj.weight").T,
                              t(p + "mlp.down_proj.weight").T)
            layers.append(DenseLayer(
                attn=attn, mlp=mlp, ln_attn=t(p + "input_layernorm.weight"),
                ln_mlp=t(p + "post_attention_layernorm.weight")))
        cos, sin = precompute_rope(cfg.head_dim, cfg.max_position_embeddings,
                                   cfg.rope_theta, device=dev)
        embed = t("model.embed_tokens.weight")
        lm_head = (embed.T if cfg.tie_word_embeddings
                   else t("lm_head.weight").T)
        return DenseLLM(embed=embed, layers=layers,
                        final_norm=t("model.norm.weight"), lm_head=lm_head,
                        cos=cos, sin=sin, config=cfg)

    def to_mesh(self, mesh, axis: str = "tp", sp_combine: str = "xla") -> "DenseLLM":
        """This one-rank model split over `mesh` (layers/tp_attn.py and
        tp_mlp.py `to_mesh`; norms, rope tables, embedding and head as
        the module docstring says); rank 0's device holds the embedding
        and the head. axis="sp": sequence-parallel instead (the module
        docstring), the partials merged by sp_combine ("xla" or "dist").
        A mesh of one rank returns the model itself. A MoE model splits
        through its own `to_mesh` (models/qwen_moe.py)."""
        if self.mesh is not None:
            raise ValueError("the model is already split over a mesh")
        if axis not in ("tp", "sp"):
            raise ValueError(f"axis {axis!r}: want 'tp' or 'sp'")
        if sp_combine not in ("xla", "dist"):
            raise ValueError(f"sp_combine {sp_combine!r}: want 'xla' or 'dist'")
        if mesh.size == 1:
            return self
        if axis == "sp":
            return self._to_sp_mesh(mesh, sp_combine)
        d0 = mesh.devices[0]
        layers = [DenseLayer(attn=ly.attn.to_mesh(mesh), mlp=ly.mlp.to_mesh(mesh),
                             ln_attn=mesh.replicate(ly.ln_attn),
                             ln_mlp=mesh.replicate(ly.ln_mlp)) for ly in self.layers]
        lm_head = self.lm_head
        if (lm_head.q if isinstance(lm_head, QuantW) else lm_head).device != d0:
            lm_head = weight_to(lm_head, d0)
        return DenseLLM(embed=self.embed.to(d0), layers=layers,
                        final_norm=self.final_norm.to(d0), lm_head=lm_head,
                        cos=self.cos.to(d0), sin=self.sin.to(d0), config=self.config,
                        mesh=mesh, rope=[(self.cos.to(d), self.sin.to(d))
                                         for d in mesh.devices])

    def _to_sp_mesh(self, mesh, sp_combine: str) -> "DenseLLM":
        """The sequence-parallel form over `mesh`: the layers on rank 0's
        device (this model's, when it lives there) and one copy on each
        other distinct device."""
        d0 = mesh.devices[0]
        base = self if self.device == d0 else self._layers_on(d0)
        stacks = [base.layers] + [self._layers_on(d).layers
                                  for d, _ in mesh.device_groups()[1:]]
        return dataclasses.replace(base, mesh=mesh, sp_axis="sp", sp_combine=sp_combine,
                                   sp_layers=stacks,
                                   rope=[(base.cos.to(d), base.sin.to(d))
                                         for d, _ in mesh.device_groups()])

    def _layers_on(self, device) -> "DenseLLM":
        """A copy of this one-rank model on `device`."""
        def attn(a):
            return dataclasses.replace(
                a, w_qkv=weight_to(a.w_qkv, device), w_o=weight_to(a.w_o, device),
                q_norm=None if a.q_norm is None else a.q_norm.to(device),
                k_norm=None if a.k_norm is None else a.k_norm.to(device))

        layers = [DenseLayer(attn=attn(ly.attn),
                             mlp=dataclasses.replace(
                                 ly.mlp, w_gate_up=weight_to(ly.mlp.w_gate_up, device),
                                 w_down=weight_to(ly.mlp.w_down, device)),
                             ln_attn=ly.ln_attn.to(device), ln_mlp=ly.ln_mlp.to(device))
                  for ly in self.layers]
        return dataclasses.replace(self, embed=self.embed.to(device), layers=layers,
                                   final_norm=self.final_norm.to(device),
                                   lm_head=weight_to(self.lm_head, device),
                                   cos=self.cos.to(device), sin=self.sin.to(device))

    def quantize_int8(self) -> "DenseLLM":
        """Weight-only int8 copy: the projection weights and the lm_head
        become QuantW (int8 + per-column f32 scale); the embedding stays
        in the model dtype (it is a gather, not a product). Split over a
        mesh, the row shards of w_o and w_down share the whole weight's
        column scales (quantize_int8_rows), as the JAX package quantizes
        the global array."""
        if self.sp_size > 1:
            one = dataclasses.replace(self, mesh=None, rope=None, sp_axis=None, sp_layers=None)
            return one.quantize_int8().to_mesh(self.mesh, "sp", sp_combine=self.sp_combine)
        if self.tp > 1:
            return dataclasses.replace(self, lm_head=quantize_int8(self.lm_head), layers=[
                dataclasses.replace(ly, attn=_quantized_shards(ly.attn, "w_qkv", "w_o"),
                                    mlp=_quantized_shards(ly.mlp, "w_gate_up", "w_down"))
                for ly in self.layers])
        layers = [
            dataclasses.replace(
                ly,
                attn=dataclasses.replace(ly.attn, w_qkv=quantize_int8(ly.attn.w_qkv),
                                         w_o=quantize_int8(ly.attn.w_o)),
                mlp=dataclasses.replace(ly.mlp, w_gate_up=quantize_int8(ly.mlp.w_gate_up),
                                        w_down=quantize_int8(ly.mlp.w_down)))
            for ly in self.layers]
        return dataclasses.replace(self, layers=layers,
                                   lm_head=quantize_int8(self.lm_head))

    def named_parameters(self) -> list:
        """The trainable tensors as (name, tensor) pairs under the JAX
        pytree's leaf names, those of models/convert.py: embed,
        layers.{i}.attn.w_qkv / w_o / q_norm / k_norm,
        layers.{i}.mlp.w_gate_up / w_down, layers.{i}.ln_attn / ln_mlp,
        final_norm, lm_head. The rope tables (cos, sin), leaves of the JAX
        pytree too, are constants here."""
        if self.tp > 1:
            raise NotImplementedError("training at tensor-parallel size > 1: not yet ported")
        out = [("embed", self.embed)]
        for i, ly in enumerate(self.layers):
            p = f"layers.{i}."
            out += [(f"{p}attn.{n}", getattr(ly.attn, n))
                    for n in ("w_qkv", "w_o", "q_norm", "k_norm")]
            out += [(f"{p}mlp.{n}", getattr(ly.mlp, n)) for n in ("w_gate_up", "w_down")]
            out += [(p + "ln_attn", ly.ln_attn), (p + "ln_mlp", ly.ln_mlp)]
        out += [("final_norm", self.final_norm), ("lm_head", self.lm_head)]
        out = [(n, t) for n, t in out if t is not None]
        if any(isinstance(t, QuantW) for _, t in out):
            raise NotImplementedError("training int8 (QuantW) weights: not yet ported")
        return out

    def requires_grad_(self, flag: bool = True) -> "DenseLLM":
        """Mark every parameter as trainable (or not); returns the model. A
        tied head, a view of the embedding, first becomes a tensor of its
        own: in the JAX pytree lm_head is a separate leaf with its own
        gradient, and the two drift apart from the first step on."""
        self.named_parameters()              # raises for what cannot train
        if flag and (self.lm_head.untyped_storage().data_ptr()
                     == self.embed.untyped_storage().data_ptr()):
            self.lm_head = self.lm_head.clone()
        for _, t in self.named_parameters():
            t.requires_grad_(flag)
        return self

    def forward_train(self, ids: torch.Tensor, mode: str = "train") -> torch.Tensor:
        """Training forward (no KV cache): full-causal attention within each
        of the B sequences of ids [B, S]; returns the logits of every
        position, [B, S, V] f32, to differentiate with torch.autograd.

        mode "train": every projection through ag_gemm/gemm_rs (the GEMM
        kernel, kernels/grad.py) and the attention through the flash
        forward and backward kernels (kernels/flash_attn_train.py); "xla":
        the plain oracle (plain products, flash_attention_ref, the SwiGLU
        as plain ops). Embedding gather, final norm and LM head are plain
        in both, as in the JAX package."""
        if mode not in ("train", "xla"):
            raise NotImplementedError(f"forward_train mode {mode!r}: not yet ported (the "
                                      "port runs 'train' and 'xla')")
        if self.tp > 1:
            raise NotImplementedError("training at tensor-parallel size > 1: not yet ported")
        B, S = ids.shape
        cfg = self.config
        attn_impl, mlp_impl = ("flash", "dist") if mode == "train" else ("ref", "xla")
        x = self.embed[ids].reshape(B * S, cfg.hidden_size)
        for layer in self.layers:
            h = rms_norm(x, layer.ln_attn, cfg.rms_norm_eps)
            x = x + layer.attn.fwd_train(h, self.cos, self.sin, B, attn_impl)
            h = rms_norm(x, layer.ln_mlp, cfg.rms_norm_eps)
            x = x + layer.mlp.fwd_train(h, mlp_impl)
        x = rms_norm(x, self.final_norm, cfg.rms_norm_eps)
        return _HeadF32.apply(x, self.lm_head).reshape(B, S, -1)

    def forward_tokens(self, ids: torch.Tensor, cache: KVCache,
                       mode: str = "flash", last_pos=None):
        """One forward pass over ids [B, S] starting at cache.offset; fills
        the cache in place and returns (logits [B, V] f32, cache): those
        of position S-1, or of position last_pos of the S when given.
        mode: "flash" (kernels), "xla" (plain versions), or a comm mode
        ("ar", "gemm_ar", "dist"; layers/tp_attn.py)."""
        B, S = ids.shape
        cfg = self.config
        x = self.embed[ids].reshape(B * S, cfg.hidden_size)
        kv_start = cache.offset
        am = self._attn_mode(mode)
        if self.tp > 1:
            cos, sin = self._ropes()
            x, _ = self._tp_stack(x, lambda attn, hs, li: attn.fwd_cached(
                hs, cos, sin, B, cache.layer(li), kv_start, am, rows=B * S), mode)
        else:
            for li, layer in enumerate(self.layers):
                h = rms_norm(x, layer.ln_attn, cfg.rms_norm_eps)
                a, _ = layer.attn.fwd_cached(h, self.cos, self.sin, B,
                                             cache.layer(li), kv_start, am)
                x = x + a
                x = x + self._ffn(layer, rms_norm(x, layer.ln_mlp, cfg.rms_norm_eps), mode,
                                  None)[0]
        cache.advance(S)
        x = rms_norm(x, self.final_norm, cfg.rms_norm_eps)
        last = x.reshape(B, S, -1)[:, S - 1 if last_pos is None else last_pos]
        return qmm(last, self.lm_head, out_dtype=torch.float32), cache

    def forward_tokens_slots(self, ids: torch.Tensor, cache: KVCache, pos,
                             mode: str = "flash"):
        """Slot-masked decode forward (continuous batching): one token per
        row, row b at its own position pos[b] ([B] int32 on the device).
        ids: [B, 1]. Writes each row's K/V at its own column and attends
        per-row lengths; cache.offset is not used. Returns (logits [B, V]
        f32, cache)."""
        return self._slots_forward(ids, self._slot_attend(cache, pos, mode), mode)[0], cache

    def forward_tokens_slots_paged(self, ids: torch.Tensor, pcache, pos,
                                   mode: str = "flash"):
        """forward_tokens_slots over the paged pool (PagedSlotCache):
        each row's KV lives in the pages its table rows map, possibly
        shared read-only with other slots' cached prefixes. Returns
        (logits [B, V] f32, pcache)."""
        if self.sp_size > 1:
            return self._sp_forward(ids, pcache, pos, mode), pcache
        return self._slots_forward(ids, self._paged_attend(pcache, pos, mode),
                                   mode)[0], pcache

    def forward_tokens_slots_verify(self, ids: torch.Tensor, cache: KVCache, pos, q_lens,
                                    mode: str = "flash"):
        """Window forward (speculative verify, chunked prefill): row b's
        first q_lens[b] tokens of ids [B, S] sit at positions pos[b] ..
        pos[b] + q_lens[b] - 1 (pos, q_lens: [B] int32 on the device); their
        K/V is written at those columns of the slot's cache row and they
        attend causally within the window. Padding tokens are computed and
        discarded. Returns (per-position logits [B, S, V] f32, cache)."""
        return self._slots_forward(ids, self._slot_attend(cache, pos, mode, q_lens), mode,
                                   window=True)[0], cache

    def forward_tokens_slots_paged_verify(self, ids: torch.Tensor, pcache, pos, q_lens,
                                          mode: str = "flash"):
        """forward_tokens_slots_verify over the paged pool: the window's
        K/V goes through the page table. Returns (per-position logits
        [B, S, V] f32, pcache)."""
        if self.sp_size > 1:
            return self._sp_forward(ids, pcache, pos, mode, q_lens), pcache
        return self._slots_forward(ids, self._paged_attend(pcache, pos, mode, q_lens), mode,
                                   window=True)[0], pcache

    def _sp_forward(self, ids, pcache, pos, mode: str, q_lens=None):
        """The paged slot forward of a sequence-parallel model (the JAX
        SP branches of forward_tokens_slots_paged and its _verify form):
        every layer once per distinct device of the mesh, the attention as
        the SP attend over the ranks' pool blocks. Returns the logits
        [B, V] (a window: [B, S, V]) f32 on rank 0's device."""
        from triton_dist_tpu_torch.layers.tp_attn import sp_paged_context
        B, S = ids.shape
        if S != 1 and q_lens is None:
            raise ValueError(f"slot decode feeds one token per slot, got S={S}")
        cfg = self.config
        eps = cfg.rms_norm_eps
        ctx = sp_paged_context(self.mesh, pcache, pos, q_lens, S)
        cos, sin = [c for c, _ in self.rope], [s_ for _, s_ in self.rope]
        x = self.embed[ids].reshape(B * S, cfg.hidden_size)
        xs = [x.to(d) for d, _ in self.mesh.device_groups()]
        for li in range(cfg.num_layers):
            lys = [stack[li] for stack in self.sp_layers]
            hs = [rms_norm(xd, ly.ln_attn, eps) for xd, ly in zip(xs, lys)]
            a, _ = lys[0].attn.fwd_cached_slots_paged_sp(
                hs, cos, sin, B, pcache.layer(li), ctx, self.mesh, mode, self.sp_combine,
                layers=[ly.attn for ly in lys])
            xs = [xd + ad for xd, ad in zip(xs, a)]
            xs = [xd + self._ffn(ly, rms_norm(xd, ly.ln_mlp, eps), mode, None)[0]
                  for xd, ly in zip(xs, lys)]
        x = rms_norm(xs[0], self.final_norm, eps)
        logits = qmm(x, self.lm_head, out_dtype=torch.float32)
        return logits.reshape(B, S, -1) if q_lens is not None else logits

    def _ropes(self):
        """The rope tables as the layers take them: (cos, sin), or at n > 1
        ([each rank's cos], [each rank's sin])."""
        if self.tp == 1:
            return self.cos, self.sin
        return [c for c, _ in self.rope], [s for _, s in self.rope]

    def _slot_args(self, pos):
        """(cos, sin, pos) for the slot attention blocks: per rank at n > 1
        (pos copied to every rank's device)."""
        cos, sin = self._ropes()
        return cos, sin, (pos if self.tp == 1 else self.mesh.replicate(pos))

    def _attn_mode(self, mode: str) -> str:
        """The attention blocks' mode for a model-level mode (the mode
        itself; a MoE model maps its expert-parallel modes)."""
        return mode

    def _slot_attend(self, cache: KVCache, pos, mode: str, q_lens=None):
        """The slot attention block of forward_tokens_slots (with q_lens:
        of its window form), as attend(attn, h, layer index, batch)."""
        cos, sin, pos = self._slot_args(pos)
        mode = self._attn_mode(mode)
        if q_lens is None:
            return lambda attn, h, li, b: attn.fwd_cached_slots(
                h, cos, sin, b, cache.layer(li), pos, mode)
        return lambda attn, h, li, b: attn.fwd_cached_slots_verify(
            h, cos, sin, b, cache.layer(li), pos, q_lens, mode)

    def _paged_attend(self, pcache, pos, mode: str, q_lens=None):
        """The paged slot attention block of forward_tokens_slots_paged
        (with q_lens: of its window form)."""
        cos, sin, pos = self._slot_args(pos)
        mode = self._attn_mode(mode)
        table = pcache.table if self.tp == 1 else pcache.tables
        if q_lens is None:
            return lambda attn, h, li, b: attn.fwd_cached_slots_paged(
                h, cos, sin, b, pcache.layer(li), table, pos, mode)
        return lambda attn, h, li, b: attn.fwd_cached_slots_paged_verify(
            h, cos, sin, b, pcache.layer(li), table, pos, q_lens, mode)

    def _tp_stack(self, x, attend, mode: str, load=None):
        """The layer stack at n > 1 ranks: x [M, D] (rank 0's embedding
        rows) copied to every rank (when the attention runs on "dist",
        rank r's row shard of the rows padded to a multiple of n), each
        layer's attention block attend(attn, [h per rank], layer index) and
        FFN (`_ffn_ranks`) over the ranks' lists; returns (rank 0's copy of
        the residual stream [M, D], load)."""
        eps = self.config.rms_norm_eps
        M = x.shape[0]
        sharded = self._attn_mode(mode) == "dist"
        if sharded:
            n = self.mesh.size
            m = -(-M // n)
            xp = torch.nn.functional.pad(x, (0, 0, 0, n * m - M))
            xs = [xp[r * m:(r + 1) * m].to(d) for r, d in enumerate(self.mesh.devices)]
        else:
            xs = self.mesh.replicate(x)
        for li, ly in enumerate(self.layers):
            a, _ = attend(ly.attn, [rms_norm(xr, w, eps) for xr, w in zip(xs, ly.ln_attn)], li)
            xs = [xr + ar for xr, ar in zip(xs, a)]
            y, load = self._ffn_ranks(ly, [rms_norm(xr, w, eps) for xr, w in zip(xs, ly.ln_mlp)],
                                      mode, load, M)
            xs = [xr + yr for xr, yr in zip(xs, y)]
        if sharded:
            return torch.cat([xr.to(x.device) for xr in xs])[:M], load
        return xs[0], load

    def _ffn(self, layer, h, mode: str, load):
        """The layer's FFN on the normed rows h: (output, load). `load` is
        the routing-load accumulator of MoE models (models/qwen_moe.py),
        passed through here."""
        return layer.mlp(h, mode), load

    def _ffn_ranks(self, layer, hs, mode: str, load, rows: int):
        """The layer's FFN at n > 1 ranks on the ranks' normed rows hs (row
        shards or copies, as the stack holds them; `rows` real rows):
        (outputs, load)."""
        return layer.mlp(hs, mode), load

    def _slots_forward(self, ids, attend, mode: str, load=None, window: bool = False):
        """The layer loop of the slot forwards; attend(attn, h, layer
        index, batch) runs the layer's slot attention block on the cache.
        Returns (logits [B, V] f32, or [B, S, V] for a window, load)."""
        B, S = ids.shape
        if S != 1 and not window:
            raise ValueError(f"slot decode feeds one token per slot, got S={S}")
        cfg = self.config
        x = self.embed[ids].reshape(B * S, cfg.hidden_size)
        if self.tp > 1:
            x, load = self._tp_stack(x, lambda attn, hs, li: attend(attn, hs, li, B), mode, load)
        else:
            for li, layer in enumerate(self.layers):
                a, _ = attend(layer.attn, rms_norm(x, layer.ln_attn, cfg.rms_norm_eps), li, B)
                x = x + a
                y, load = self._ffn(layer, rms_norm(x, layer.ln_mlp, cfg.rms_norm_eps), mode,
                                    load)
                x = x + y
        x = rms_norm(x, self.final_norm, cfg.rms_norm_eps)
        logits = qmm(x, self.lm_head, out_dtype=torch.float32)
        return (logits.reshape(B, S, -1) if window else logits), load

    def make_cache(self, batch: int, max_seq: int, dtype=None) -> KVCache:
        cfg = self.config
        return KVCache.create(cfg.num_layers, batch, max_seq, cfg.num_kv_heads,
                              cfg.head_dim, device=self.device,
                              dtype=dtype or cfg.torch_dtype,
                              mesh=self.mesh if self.tp > 1 else None)


def _quantized_shards(layer, col_name: str, row_name: str):
    """A split layer (TP_Attn or TP_MLP) with its shards' column-parallel
    weight quantized each on its own (a column's scale lies within one
    rank) and its row-parallel one through quantize_int8_rows."""
    rows = quantize_int8_rows([getattr(s, row_name) for s in layer.shards])
    return dataclasses.replace(layer, shards=[
        dataclasses.replace(s, **{col_name: quantize_int8(getattr(s, col_name)),
                                  row_name: r}) for s, r in zip(layer.shards, rows)])
