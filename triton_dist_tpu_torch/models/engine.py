"""Inference engine: counterpart of triton_dist_tpu/models/engine.py
(`Engine.__init__` gates, `prefill`, `decode`, `serve`, `_prefill_fn`,
`_scan_decode_fn`) for greedy decode on one device.

Backends: "flash" runs the CUDA kernels (flash-decode, kv_update,
SwiGLU) for prefill and decode; "xla" runs their plain PyTorch
versions (the JAX package's oracle backend). The JAX decode `lax.scan`
is a Python loop over steps here; the cache is updated in place.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.models.utils import sample_greedy
from triton_dist_tpu_torch.runtime.device import resolve_device

BACKENDS = ("flash", "xla")
# backends of the JAX engine that the port does not run yet
_JAX_BACKENDS = ("dist", "ar", "gemm_ar", "ep", "ep_flash", "mega")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: not yet ported")


class Engine:
    def __init__(self, model, *, max_seq: int = 256, backend: str = "flash",
                 kv_dtype=None, sampling: str = "greedy", device=None):
        """Serve `model` on `device` (default "cuda"; the model must live
        there). kv_dtype=torch.int8 stores the KV cache quantized per
        position; pair it with model.quantize_int8(). Unsupported
        combinations raise here, at construction."""
        dev = resolve_device(device)
        if model.device != dev:
            raise ValueError(f"the model lives on {model.device}, the engine "
                             f"was asked for {dev}")
        if backend in _JAX_BACKENDS:
            raise _not_ported(f"backend={backend!r}")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; this engine serves "
                             f"{BACKENDS}")
        if sampling != "greedy":
            raise _not_ported(f"sampling={sampling!r}")
        if getattr(model.config, "is_moe", False):
            raise _not_ported("MoE models")
        if kv_dtype not in (None, torch.int8, model.config.torch_dtype):
            raise ValueError(f"kv_dtype {kv_dtype}: want None (the model "
                             "dtype) or torch.int8")
        self.model = model
        self.max_seq = max_seq
        self.backend = backend
        self.kv_dtype = kv_dtype
        self.device = dev

    def prefill(self, input_ids):
        """Run the prefill pass on a fresh cache; returns (logits, cache)."""
        ids = torch.as_tensor(input_ids, device=self.device).long()
        cache = self.model.make_cache(ids.shape[0], self.max_seq,
                                      dtype=self.kv_dtype)
        return _prefill_fn(self.model, ids, cache, mode=self.backend)

    def decode(self, logits, cache, gen_len: int):
        """Greedy decode from prefill state, gen_len steps, updating the
        cache in place. Returns tokens [B, gen_len] int32."""
        if cache.offset + gen_len > self.max_seq:
            raise ValueError(f"{gen_len} steps from position {cache.offset} "
                             f"overrun max_seq={self.max_seq}")
        toks, _, _ = _scan_decode_fn(self.backend, self.model, logits, cache,
                                     gen_len=gen_len)
        return toks

    def serve(self, input_ids, gen_len: int):
        """Generate: prefill then decode. input_ids [B, S]; returns
        tokens [B, gen_len]."""
        logits, cache = self.prefill(input_ids)
        return self.decode(logits, cache, gen_len)

    def make_slot_cache(self, batch: int):
        raise _not_ported("slot caches (continuous batching)")

    def make_paged_slot_cache(self, batch: int, **kw):
        raise _not_ported("paged slot caches")


def _prefill_fn(model, ids, cache, *, mode):
    return model.forward_tokens(ids, cache, mode=mode)


def _scan_decode_fn(backend, model, logits0, cache, *, gen_len: int):
    """Step t takes the argmax of the previous logits (the first from the
    prefill's) and feeds it through forward_tokens."""
    logits, toks = logits0, []
    for _ in range(gen_len):
        tok = sample_greedy(logits)
        logits, cache = model.forward_tokens(tok[:, None], cache, mode=backend)
        toks.append(tok)
    return torch.stack(toks, dim=1).to(torch.int32), logits, cache
