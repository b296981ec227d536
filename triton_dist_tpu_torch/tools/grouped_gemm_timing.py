"""Time the grouped GEMM kernel at chip_smoke.py's rows 7a-7e, for an A/B
of two checkouts in one call to the card.

    cd <checkout> && python3 <this file>

imports the package of the working directory (so a parent checkout, which
lacks this file, is timed by it too) and prints one line: per row the
median ms of one launch between CUDA events (30 calls) and, for the
prefill rows 7c-7d, of ten back-to-back launches and the kernel's device
time by torch.profiler; then, where the checkout's grouped_gemm takes
strided panels, their gap to the plain version. Run parent, change,
change, parent in one call and compare within it (a card's clocks and the
host differ between calls). Needs a card.
"""

import os
import statistics
import sys

import torch
from torch.profiler import ProfilerActivity, profile

ROWS = {"7a": (128, 24, 2048, 1536), "7b": (128, 24, 768, 2048), "7c": (128, 2056, 2048, 1536),
        "7d": (128, 2056, 768, 2048), "7e": (3, 200, 512, 320)}


def main() -> None:
    sys.path.insert(0, os.getcwd())
    from triton_dist_tpu_torch.kernels import _build, grouped_gemm
    _build.ext()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape):
        return (torch.randn(shape, generator=gen, device="cuda") * 0.05).bfloat16()

    def events(fn, k=1):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(k):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / k

    out = []
    for name, (E, C, D, F) in ROWS.items():
        x, w = rn(E, C, D), rn(E, D, F)
        for _ in range(5):
            grouped_gemm(x, w)
        torch.cuda.synchronize()
        line = f"{name} {statistics.median(events(lambda: grouped_gemm(x, w)) for _ in range(30)):.4f}"
        if C > 1000:
            ten = statistics.median(events(lambda: grouped_gemm(x, w), 10) for _ in range(15))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    grouped_gemm(x, w)
                torch.cuda.synchronize()
            dev = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
            k = max(dev, key=lambda e: e.self_device_time_total)
            line += f" (ten {ten:.4f}, profiler {k.self_device_time_total / k.count / 1e3:.4f})"
        out.append(line)
    print(os.path.basename(os.getcwd()), "; ".join(out), flush=True)
    gg = sys.modules["triton_dist_tpu_torch.kernels.group_gemm"]
    if hasattr(gg, "column_blocks"):
        W, x = rn(128, 2048, 1536), rn(128, 24, 2048)
        pair = (W[:, :, 192:384], W[:, :, 960:1152])
        Wd, h = rn(128, 768, 2048), rn(128, 24, 192)
        err = [(grouped_gemm(a, b).float() - gg.grouped_gemm_ref(a, b).float()).abs().max().item()
               for a, b in ((x, pair), (h, Wd[:, 192:384]))]
        print(f"strided panels: [gate_r | up_r] views max |d| {err[0]}, w_down rows {err[1]}",
              flush=True)


if __name__ == "__main__":
    main()
