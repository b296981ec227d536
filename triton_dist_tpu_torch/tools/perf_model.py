"""Speed-of-light models for GEMMs and collectives on NVIDIA Hopper cards.

Counterpart of triton_dist_tpu/tools/perf_model.py (`ChipSpec`,
`chip_specs`, `gemm_sol_us`, `collective_sol_us`, `sol_report`), with the
cards' data-sheet numbers (NVIDIA's data sheets for the SXM parts, dense
rates): the least time a card could take for a piece of work, so that a
report can say how far a kernel is from it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    bf16_tflops: float     # dense tensor-core peak
    hbm_gbps: float        # device memory rate
    link_gbps: float       # NVLink to the other cards of the host, one direction


_SPECS = {
    "h100": ChipSpec("H100 SXM", 989.0, 3350.0, 450.0),
    "h200": ChipSpec("H200 SXM", 989.0, 4800.0, 450.0),
}
# an unknown card gets the JAX package's conservative fallback
_FALLBACK = ChipSpec("unknown", 100.0, 500.0, 25.0)


def chip_specs(device_name: Optional[str] = None) -> ChipSpec:
    """The spec of the card named `device_name`, by default
    torch.cuda.get_device_name() (which raises without a card). The PCIe
    and NVL parts, with other rates, are not the SXM parts: they get the
    fallback."""
    if device_name is None:
        import torch
        device_name = torch.cuda.get_device_name()
    name = device_name.lower()
    if "pcie" in name or "nvl" in name:
        return _FALLBACK
    for key, spec in _SPECS.items():
        if key in name:
            return spec
    return _FALLBACK


def gemm_sol_us(M: int, K: int, N: int, *, itemsize: int = 2,
                spec: Optional[ChipSpec] = None) -> float:
    """max(tensor-core time, memory time) of one [M, K] @ [K, N] product."""
    spec = spec or chip_specs()
    t_mma = 2.0 * M * K * N / (spec.bf16_tflops * 1e12)
    t_hbm = itemsize * (M * K + K * N + M * N) / (spec.hbm_gbps * 1e9)
    return max(t_mma, t_hbm) * 1e6


def collective_sol_us(op: str, nbytes: int, n: int, *,
                      spec: Optional[ChipSpec] = None) -> float:
    """Least time for `nbytes` of payload (the whole tensor) over n cards
    joined all to all by NVLink, each sending at the one-direction link
    rate; 0 at n = 1. ops: ag | rs | ar | a2a | p2p. In an all-to-all each
    card holds 1/n of the whole tensor and sends (n-1)/n of that (the JAX
    model's (n-1)/n would have each card send the whole tensor's share)."""
    if n <= 1:
        return 0.0
    spec = spec or chip_specs()
    factor = {
        "ag": (n - 1) / n,
        "rs": (n - 1) / n,
        "ar": 2 * (n - 1) / n,
        "a2a": (n - 1) / n ** 2,
        "p2p": 1.0,
    }[op]
    return factor * nbytes / (spec.link_gbps * 1e9) * 1e6


def sol_report(name: str, achieved_us: float, sol_us: float) -> str:
    """One report line: achieved against SOL and the share."""
    ratio = sol_us / achieved_us if achieved_us > 0 else 0.0
    return (f"{name}: {achieved_us:8.1f} us achieved, "
            f"{sol_us:8.1f} us SOL, {100.0 * ratio:5.1f}% of SOL")
