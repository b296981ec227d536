"""Build, load and count the package's CUDA kernels.

All kernel sources in `csrc/` and the one small binding file
(`csrc/binding.cpp`, the only source that includes PyTorch's headers)
are compiled by one `torch.utils.cpp_extension.load` call, for
`sm_90a`, into `build/torch_ext/` at the root of the checkout, at first
use; `load` compiles the sources in parallel (ninja) and rebuilds when
a source changes. Nothing here runs at import time.

Every kernel wrapper adds one to its entry of the launch counts each
time it launches its kernel, and nowhere else, so a run can show that a
path went through the kernels (`launch_counts`, `reset_launch_counts`).
A collective also counts the launch under its method (`method_counts`),
so a run can show which of its methods it took.
"""

from __future__ import annotations

from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
# kernel sources (csrc/{name}.cu)
SOURCES = ("a2a", "a2a_gemm", "ag_gemm", "ag_group_gemm", "allgather", "allreduce", "ep_fused",
           "flash_attn_bwd", "flash_decode", "flash_decode_paged", "gdn", "gemm", "gemm_a2a",
           "gemm_allreduce", "gemm_rs", "grouped_gemm", "kv_scatter", "kv_update", "lse_combine",
           "mega_decode", "mega_paged_decode", "moe_reduce_ar", "moe_reduce_rs", "p2p",
           "reduce_scatter", "ring_attn", "swiglu")
# launch counts, one per kernel: flash_decode.cu and flash_decode_paged.cu
# each hold two launchers (the kernel and its partial form),
# flash_attn_bwd.cu two kernels (dq, dk/dv); gemm counts the launches of
# the one-rank ag_gemm and gemm_rs together, ag_gemm and gemm_rs those of
# their rings; a2a.cu's one kernel counts as all_to_all (all_to_all,
# low_latency_all_to_all, the EP combine) or dispatch_a2a (the EP
# dispatch with its metadata); the sequence-parallel kernels count under
# their sources' names (lse_combine, kv_scatter, ring_attn), the Ulysses
# kernels as gemm_a2a (gemm_a2a.cu) and o_a2a_gemm (a2a_gemm.cu), the
# pipeline handoff as p2p_shift (p2p.cu); mega_decode counts both
# forms of mega_decode.cu, its tensor-parallel form also under the method
# "tp" (method_counts()["mega_decode tp"]); a collective, and the TP form,
# count one launch per distinct device of its mesh (one for four ranks
# emulated on one card)
KERNELS = ("ag_gemm", "ag_group_gemm", "all_gather", "all_reduce", "all_to_all",
           "dispatch_a2a", "ep_moe_fused", "flash_attn_bwd_dkdv", "flash_attn_bwd_dq",
           "flash_decode", "flash_decode_paged", "flash_decode_paged_partial",
           "flash_decode_partial", "gdn_fwd", "gemm", "gemm_a2a", "gemm_allreduce", "gemm_rs",
           "grouped_gemm", "kv_scatter", "kv_update", "lse_combine", "mega_decode",
           "mega_paged_decode", "moe_reduce_ar", "moe_reduce_rs", "o_a2a_gemm", "p2p_shift",
           "reduce_scatter", "ring_attn", "swiglu")
CUDA_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-O3", "-lineinfo"]
# dtype codes of csrc/launchers.h (tdt::Dtype)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_ext = None
_launches = dict.fromkeys(KERNELS, 0)
_methods: dict[str, int] = {}


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last reset."""
    return dict(_launches)


def method_counts() -> dict[str, int]:
    """Launches of each collective by method since the last reset, keyed
    "all_reduce two_shot" and so on (a method not launched is absent)."""
    return dict(_methods)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0
    _methods.clear()


def ext():
    """The loaded extension module (built on first call): one function
    per kernel, each raising on a launch error."""
    global _ext
    if _ext is None:
        from torch.utils.cpp_extension import load
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        sources = [CSRC / "binding.cpp"] + [CSRC / f"{n}.cu" for n in SOURCES]
        _ext = load(name="tdt_kernels", sources=[str(s) for s in sources],
                    build_directory=str(BUILD_DIR), extra_cflags=["-O3"],
                    extra_cuda_cflags=CUDA_FLAGS, verbose=False)
    return _ext


def count(name: str, method: str | None = None) -> None:
    """Count one launch of kernel `name` (called after the launch), and
    of its method where it has one."""
    _launches[name] += 1
    if method is not None:
        key = f"{name} {method}"
        _methods[key] = _methods.get(key, 0) + 1


def stream_ptr(device: torch.device) -> int:
    """The current PyTorch stream of `device`, as a pointer-sized int."""
    return torch.cuda.current_stream(device).cuda_stream
