"""Cold build time of the kernels by the package's way and by nvcc alone.

    python3 -m triton_dist_tpu_torch.tools.build_timing

(a) the package's way (kernels/_build.py): one torch.utils.cpp_extension
    .load of the kernel sources and csrc/binding.cpp, the one source that
    includes PyTorch's headers.
(b) one `nvcc` per kernel source, all started together, each into a
    shared library of its own, with no PyTorch header and no binding:
    the least a build of these kernels can cost.

Both build from nothing into fresh directories under build/build_timing/;
(a) runs in a child process. Prints one line per way and a JSON line;
needs the CUDA toolkit and ninja.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

LOAD = """
import sys
from triton_dist_tpu_torch.kernels import _build
from pathlib import Path
_build.BUILD_DIR = Path(sys.argv[1])
_build.ext()
"""


def main() -> int:
    from torch.utils.cpp_extension import CUDA_HOME

    from triton_dist_tpu_torch.kernels import _build
    root = _build.BUILD_DIR.parent / "build_timing"
    shutil.rmtree(root, ignore_errors=True)
    (root / "nvcc").mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(_build.CSRC.parents[2]))

    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", LOAD, str(root / "load")], env=env, check=True)
    t_load = time.perf_counter() - t0
    print(f"build_timing (a) cpp_extension.load, sources and binding: {t_load:.1f} s",
          flush=True)

    nvcc = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "nvcc")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *_build.CUDA_FLAGS, "-shared", "-Xcompiler", "-fPIC",
                               "-o", str(root / "nvcc" / f"lib{n}.so"),
                               str(_build.CSRC / f"{n}.cu")]) for n in _build.SOURCES]
    rcs = [p.wait() for p in procs]
    t_nvcc = time.perf_counter() - t0
    if any(rcs):
        print(f"build_timing (b) nvcc failed: exit codes {rcs}", flush=True)
        return 1
    print(f"build_timing (b) nvcc per source, in parallel: {t_nvcc:.1f} s", flush=True)
    print(json.dumps({"load_s": t_load, "nvcc_parallel_s": t_nvcc}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
