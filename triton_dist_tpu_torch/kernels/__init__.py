"""Kernels of the port: each hand-written CUDA kernel (csrc/) beside its
plain PyTorch version, plus the int8 quantizers, `qmm` and the MoE
routing helpers (ep_a2a.py)."""

from triton_dist_tpu_torch.kernels._build import (  # noqa: F401
    launch_counts, reset_launch_counts)
from triton_dist_tpu_torch.kernels.flash_attn import (  # noqa: F401
    flash_decode, flash_decode_ref, kv_update, kv_update_ref)
from triton_dist_tpu_torch.kernels.group_gemm import (  # noqa: F401
    grouped_gemm, grouped_gemm_ref)
from triton_dist_tpu_torch.kernels.paged_kv import (  # noqa: F401
    PageAllocator, flash_decode_paged, flash_decode_paged_ref)
from triton_dist_tpu_torch.kernels.quant import (  # noqa: F401
    QuantW, dequantize_kv_int8, qmm, quantize_int8, quantize_kv_int8)
from triton_dist_tpu_torch.kernels.swiglu import swiglu, swiglu_ref  # noqa: F401
