"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Each source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface, all sources at once
(one ``nvcc`` process each, started together), and loaded with ctypes.
Nothing happens at import: the CPU tests import every module, and a
machine without ``nvcc`` never builds. The libraries land in
``metagraph_tpu_torch/_build/`` under names that carry a hash of the
source, the shared headers and the flags, so an edited source rebuilds
and an unchanged one loads the cached file.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import types

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# source -> {function: (argtypes, restype)}
SOURCES = {
    "partition.cu": {
        "mg_partition_tile": ([], _I),
        "mg_partition": ([_P, _I, _LL, _P, _P, _P, _I, _P, _P, _P, _LL,
                          ctypes.c_uint, _P, _P, _P], _I),
    },
    "merge.cu": {
        "mg_merge_tile": ([_I], _I),
        "mg_merge_max_lanes": ([], _I),
        "mg_merge": ([_P, _LL, _P, _LL, _I, _P, _P, _P, _P, _I, _P, _P, _P,
                      _P, _P], _I),
    },
    "sort.cu": {
        "mg_sort_tile": ([], _I),
        "mg_sort_lanes_route_max": ([], _I),
        "mg_sort_blocks_per_sm": ([_I, _I], _I),
        "mg_sort_row_words": ([_I], _I),
        "mg_sort_hist": ([_P, _LL, _I, _P, _P, _P, _P], _I),
        "mg_sort_pass": ([_P, _LL, _I, _P, _P, _I, _P, _P, _P, _P, _I, _I,
                          _P, _P], _I),
        "mg_sort_index_pass": ([_P, _LL, _I, _P, _P, _P, _P, _I, _P, _P,
                                _P], _I),
        "mg_sort_gather": ([_P, _LL, _I, _P, _P, _P, _I, _P, _P, _P, _P],
                           _I),
    },
    "align_dp.cu": {
        "mg_align_dp_scratch_ints": ([_LL, _I], _LL),
        "mg_align_dp": ([_P, _P, _P, _P, _LL, _I, _I, _P, _I, _I, _I, _I,
                         _I, _P, _P, _P], _I),
    },
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "metagraph_tpu_torch/csrc need the CUDA toolkit")


def _lib_path(name: str) -> str:
    """The library's path, named by a hash of the flags, the source and
    the shared headers (``*.cuh``) it may include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for part in [name] + headers:
        with open(os.path.join(CSRC, part), "rb") as f:
            h.update(part.encode() + b"\0" + f.read())
    stem = os.path.splitext(name)[0]
    return os.path.join(BUILD_DIR, f"libmg_{stem}_{h.hexdigest()[:16]}.so")


def build_kernels() -> list:
    """Compile every source that has no library yet, in parallel; returns
    the libraries' paths in the order of ``SOURCES``."""
    paths = [_lib_path(name) for name in SOURCES]
    todo = [(name, path) for name, path in zip(SOURCES, paths)
            if not os.path.exists(path)]
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    try:
        for name, path in todo:
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name)]
            jobs.append((cmd, tmp, path, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        errors = []
        for cmd, tmp, path, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{err}")
            else:
                os.replace(tmp, path)  # atomic: concurrent builds agree
        if errors:
            raise RuntimeError("\n".join(errors))
    finally:
        for _, tmp, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return paths


@functools.lru_cache(maxsize=None)
def lib() -> types.SimpleNamespace:
    """Every kernel function, bound from the loaded libraries (built on
    first call)."""
    fns = {}
    for (name, sigs), path in zip(SOURCES.items(), build_kernels()):
        cdll = ctypes.CDLL(path)
        for fname, (argtypes, restype) in sigs.items():
            fn = getattr(cdll, fname)
            fn.argtypes = argtypes
            fn.restype = restype
            fns[fname] = fn
    return types.SimpleNamespace(**fns)


def check(status: int, what: str):
    """Raise on a non-zero cudaError_t returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {status}")
