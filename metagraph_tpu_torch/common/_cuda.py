"""Build and bind the hand-written CUDA kernels of ``csrc/``.

The kernels are compiled at first use with ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface and loaded with ctypes.
Nothing happens at import: the CPU tests import every module, and a
machine without ``nvcc`` never builds. The library lands in
``metagraph_tpu_torch/_build/`` under a name that carries a hash of the
sources and flags, so an edited source rebuilds and an unchanged one
loads the cached file.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("partition.cu", "merge.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_SIGNATURES = {
    "mg_partition_tile": ([], ctypes.c_int),
    "mg_partition": ([_P, ctypes.c_int, ctypes.c_longlong, _P, _P, _P,
                      ctypes.c_int, _P, _P, _P, ctypes.c_longlong,
                      ctypes.c_uint, _P, _P, _P], ctypes.c_int),
    "mg_merge_tile": ([], ctypes.c_int),
    "mg_merge": ([_P, ctypes.c_longlong, _P, ctypes.c_longlong, ctypes.c_int,
                  _P, _P, _P, _P, ctypes.c_int, _P, _P, _P, _P, _P],
                 ctypes.c_int),
}

def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "metagraph_tpu_torch/csrc need the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build_kernels() -> str:
    """Compile the kernels if no library for these sources exists yet;
    returns the library's path."""
    path = os.path.join(BUILD_DIR, f"libmg_kernels_{_digest()}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               *(os.path.join(CSRC, s) for s in SOURCES)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stderr}")
        os.replace(tmp, path)      # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    cdll = ctypes.CDLL(build_kernels())
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return cdll


def check(status: int, what: str):
    """Raise on a non-zero cudaError_t returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {status}")
