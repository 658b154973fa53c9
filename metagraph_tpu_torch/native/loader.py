"""Build at first use and bind with ctypes: the host FASTA/FastQ codec.

Counterpart of ``metagraph_tpu/native/loader.py``, with its own copy of
the C source (``fasta_codec.c``). The codec is compiled once with the
system C compiler (``gcc -O3 -shared -fPIC``) into
``metagraph_tpu_torch/_build/``, the directory of the CUDA kernels'
libraries, under a name that carries a hash of the source; nothing is
built at import. Without a compiler ``native_available()`` is false and
the functions return None. This is a host codec, not a device kernel:
its results are numpy arrays, byte for byte those of the JAX package's
codec.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "fasta_codec.c")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CFLAGS = ("-O3", "-shared", "-fPIC")

_U8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_U32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_L = ctypes.c_long


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libmg_fasta_codec_{h.hexdigest()[:16]}.so")


@functools.lru_cache(maxsize=None)
def _lib() -> Optional[ctypes.CDLL]:
    """The bound codec, built on first call; None without a compiler or
    when the build fails."""
    path = _lib_path()
    if not os.path.exists(path):
        cc = shutil.which("gcc") or shutil.which("cc")
        if cc is None:
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            done = subprocess.run([cc, *CFLAGS, "-o", tmp, SRC],
                                  capture_output=True)
            if done.returncode != 0:
                return None
            os.replace(tmp, path)       # atomic: concurrent builds agree
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(path)
    lib.fasta_encode.restype = _L
    lib.fasta_encode.argtypes = [ctypes.c_char_p, _L, ctypes.c_char_p,
                                 ctypes.c_ubyte, _U8, _L, _I64, _L,
                                 ctypes.POINTER(_L)]
    lib.pack2_codes.restype = _L
    lib.pack2_codes.argtypes = [_U8, _L, _U32, _I64, _L]
    return lib


def native_available() -> bool:
    return _lib() is not None


def fasta_encode_native(data: bytes, table: np.ndarray, sep_code: int = 255
                        ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(codes with a separator after each record, record start offsets)
    of a FASTA or FastQ file's bytes; None when the codec is unavailable
    or the data is neither format."""
    lib = _lib()
    if lib is None:
        return None
    table = np.ascontiguousarray(table, np.uint8)
    if table.shape != (256,):
        raise ValueError(f"table must have 256 entries, not {table.shape}")
    out = np.empty(len(data) + 1, np.uint8)
    max_recs = max(16, data.count(b"\n") // 2 + 2)
    offsets = np.empty(max_recs, np.int64)
    n_recs = _L(0)
    written = lib.fasta_encode(data, len(data), table.tobytes(), sep_code,
                               out, len(out), offsets, max_recs,
                               ctypes.byref(n_recs))
    if written < 0:
        return None
    return out[:written], offsets[:n_recs.value].copy()


def pack2_codes_native(codes: np.ndarray, max_inval: int
                       ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """2-bit block pack of a code array whose length is a multiple of 16,
    with the positions of codes outside 1..4 aside. Returns (words uint32,
    invalid positions int64), or None when the codec is unavailable or
    more than ``max_inval`` positions are invalid."""
    lib = _lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    n = codes.shape[0]
    if n % 16:
        raise ValueError(f"code array length {n} is not a multiple of 16")
    words = np.empty(n // 16, np.uint32)
    inval = np.empty(max(max_inval, 1), np.int64)
    ninv = lib.pack2_codes(codes, n, words, inval, max_inval)
    if ninv < 0:
        return None
    return words, inval[:ninv].copy()
