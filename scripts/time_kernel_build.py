"""Time the build of the CUDA kernels of ``metagraph_tpu_torch/csrc``.

Compares two ways to build the same sources with the same flags, each
from nothing: one ``nvcc`` call that compiles every source in turn into
one library, and ``_cuda.build_kernels`` (one ``nvcc`` per source, all
started together, a library each). Runs them as one, parallel,
parallel, one, and prints each wall time. Needs ``nvcc``; no card.

    python3 scripts/time_kernel_build.py
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from metagraph_tpu_torch.common import _cuda  # noqa: E402

OUT = os.path.join(_cuda.BUILD_DIR, "timing")


def one_call() -> float:
    os.makedirs(OUT, exist_ok=True)
    cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o",
           os.path.join(OUT, "libmg_all.so"),
           *(os.path.join(_cuda.CSRC, name) for name in _cuda.SOURCES)]
    t0 = time.perf_counter()
    subprocess.run(cmd, check=True, capture_output=True)
    return time.perf_counter() - t0


def parallel() -> float:
    keep = _cuda.BUILD_DIR
    _cuda.BUILD_DIR = OUT
    try:
        t0 = time.perf_counter()
        _cuda.build_kernels()
        return time.perf_counter() - t0
    finally:
        _cuda.BUILD_DIR = keep


def main():
    times = {"one nvcc, one library": [], "one nvcc per source, parallel": []}
    try:
        for name, fn in (("one nvcc, one library", one_call),
                         ("one nvcc per source, parallel", parallel),
                         ("one nvcc per source, parallel", parallel),
                         ("one nvcc, one library", one_call)):
            shutil.rmtree(OUT, ignore_errors=True)
            times[name].append(fn())
    finally:
        shutil.rmtree(OUT, ignore_errors=True)
    print(f"sources: {', '.join(_cuda.SOURCES)}; cores: {os.cpu_count()}")
    for name, ts in times.items():
        print(f"{name}: " + " / ".join(f"{t:.2f} s" for t in ts))


if __name__ == "__main__":
    main()
