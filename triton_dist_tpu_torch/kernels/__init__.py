"""Kernels of the port: each hand-written CUDA kernel (csrc/) beside its
plain PyTorch version (the collectives all_gather, reduce_scatter,
all_reduce, gemm_allreduce and all_to_all over a mesh of ranks among
them, the EP dispatch, the fused EP-MoE and the tensor-parallel MoE's
ag_group_gemm, moe_reduce_rs and moe_reduce_ar, and the sequence-parallel
LSE combine, KV scatter and ring attention, the Ulysses GEMMs fused with
their all-to-alls, and the pipeline's neighbour put), the differentiable training
ops built on them (flash_attn_train.py, grad.py), plus the int8
quantizers, `qmm`, the MoE routing and EP planning helpers (ep_a2a.py)
and the kernel registry (registry.py)."""

from triton_dist_tpu_torch.kernels._build import (  # noqa: F401
    launch_counts, method_counts, reset_launch_counts)
from triton_dist_tpu_torch.kernels.allgather import (  # noqa: F401
    AllGatherMethod, all_gather, all_gather_ref, get_auto_all_gather_method)
from triton_dist_tpu_torch.kernels.allgather_gemm import ag_gemm, ag_gemm_ref  # noqa: F401
from triton_dist_tpu_torch.kernels.ag_group_gemm import (  # noqa: F401
    ag_group_gemm, ag_group_gemm_ref)
from triton_dist_tpu_torch.kernels.all_to_all import (  # noqa: F401
    all_to_all, all_to_all_ref, low_latency_all_to_all)
from triton_dist_tpu_torch.kernels.allreduce import (  # noqa: F401
    AllReduceMethod, all_reduce, all_reduce_ref, get_auto_allreduce_method)
from triton_dist_tpu_torch.kernels.ep_a2a import (  # noqa: F401
    combine_a2a, create_ep_a2a_context, dispatch_a2a, dispatch_a2a_int8, ep_dispatch_combine)
from triton_dist_tpu_torch.kernels.ep_fused import (  # noqa: F401
    ep_moe_fused_device, ep_moe_fused_device_ref)
from triton_dist_tpu_torch.kernels.flash_attn import (  # noqa: F401
    flash_decode, flash_decode_partial, flash_decode_partial_ref, flash_decode_ref,
    kv_update, kv_update_ref, lse_combine)
from triton_dist_tpu_torch.kernels.flash_attn_train import (  # noqa: F401
    flash_attention, flash_attention_bwd, flash_attention_bwd_ref, flash_attention_ref)
from triton_dist_tpu_torch.kernels.gdn import gdn_chunk_ref, gdn_fwd, gdn_fwd_ref  # noqa: F401
from triton_dist_tpu_torch.kernels.gemm import gemm, gemm_ref  # noqa: F401
from triton_dist_tpu_torch.kernels.gemm_allreduce import (  # noqa: F401
    gemm_allreduce, gemm_allreduce_ref)
from triton_dist_tpu_torch.kernels.gemm_reduce_scatter import gemm_rs, gemm_rs_ref  # noqa: F401
from triton_dist_tpu_torch.kernels.grad import ag_gemm_grad, gemm_rs_grad  # noqa: F401
from triton_dist_tpu_torch.kernels.group_gemm import (  # noqa: F401
    grouped_gemm, grouped_gemm_ref)
from triton_dist_tpu_torch.kernels.moe_reduce_ar import (  # noqa: F401
    moe_reduce_ar, moe_reduce_ar_ref)
from triton_dist_tpu_torch.kernels.moe_reduce_rs import (  # noqa: F401
    moe_reduce_rs, moe_reduce_rs_ref)
from triton_dist_tpu_torch.kernels.paged_kv import (  # noqa: F401
    PageAllocator, flash_decode_paged, flash_decode_paged_partial,
    flash_decode_paged_partial_ref, flash_decode_paged_ref)
from triton_dist_tpu_torch.kernels.p2p import p2p_push_pages, p2p_shift, p2p_shift_ref  # noqa: F401
from triton_dist_tpu_torch.kernels.quant import (  # noqa: F401
    QuantW, dequantize_kv_int8, qmm, quantize_int8, quantize_kv_int8)
from triton_dist_tpu_torch.kernels.reduce_scatter import (  # noqa: F401
    ReduceScatterMethod, get_auto_reduce_scatter_method, reduce_scatter, reduce_scatter_ref)
from triton_dist_tpu_torch.kernels.registry import KernelSpec, kernel_registry  # noqa: F401
from triton_dist_tpu_torch.kernels.sp_attention import (  # noqa: F401
    gemm_all_to_all, gemm_all_to_all_ref, o_a2a_gemm, o_a2a_gemm_ref, qkv_gemm_a2a,
    ring_attn_ref, sp_ring_attention, sp_ring_attention_ref, ulysses_combine, ulysses_dispatch)
from triton_dist_tpu_torch.kernels.sp_flash_decode import (  # noqa: F401
    kv_cache_scatter, kv_cache_scatter_ref, lse_combine_dist_ref, sp_combine_partials,
    sp_flash_decode, sp_flash_decode_ref)
from triton_dist_tpu_torch.kernels.swiglu import swiglu, swiglu_ref  # noqa: F401
