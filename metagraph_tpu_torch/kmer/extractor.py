"""Sequence -> code arrays and k-window validity.

PyTorch counterpart of ``metagraph_tpu/kmer/extractor.py``. Sequences
are concatenated with a single INVALID separator byte, so no window
straddles two sequences; a window is a real k-mer iff it holds no
invalid or sentinel code, which one prefix sum decides for all windows.
``extract_packed_kmers`` packs the valid windows and compacts them;
with a node suffix it keeps only the windows whose last node characters
match it (the k-mer-space sharding predicate of suffix-sharded builds).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import merge as pmerge
from . import packing
from .alphabets import Alphabet, INVALID_CODE


def encode_sequences(seqs: Sequence[bytes | str],
                     alphabet: Alphabet) -> np.ndarray:
    """Host-side: concatenate sequences into one uint8 code array with
    INVALID separators between (and after) each sequence."""
    tbl = alphabet.encode_table()
    parts = []
    for s in seqs:
        if isinstance(s, str):
            s = s.encode()
        parts.append(tbl[np.frombuffer(s, np.uint8)])
        parts.append(np.array([INVALID_CODE], np.uint8))
    if not parts:
        return np.zeros((0,), np.uint8)
    return np.concatenate(parts)


def window_validity(codes: torch.Tensor, K: int) -> torch.Tensor:
    """(N-K+1,) bool: window i..i+K-1 holds only real character codes."""
    bad = (codes == int(INVALID_CODE)) | (codes == 0)
    prefix = torch.cat([torch.zeros((1,), dtype=torch.int32,
                                    device=codes.device),
                        torch.cumsum(bad, 0, dtype=torch.int32)])
    return (prefix[K:] - prefix[:-K]) == 0


def suffix_mask(codes: torch.Tensor, K: int,
                suffix: Tuple[int, ...]) -> torch.Tensor:
    """(N-K+1,) bool: the window's last ``len(suffix)`` node characters
    (BOSS fields K-s..K-1) equal ``suffix``."""
    num_windows = codes.shape[0] - K + 1
    s = len(suffix)
    ok = torch.ones((num_windows,), dtype=torch.bool, device=codes.device)
    for i, c in enumerate(suffix):
        slot = K - s + i
        off = K - 1 if slot == 0 else slot - 1     # field -> window offset
        ok &= codes[off:off + num_windows] == int(c)
    return ok


def extract_packed_kmers(codes: torch.Tensor, K: int, B: int,
                         suffix: Optional[Tuple[int, ...]] = None):
    """All valid K-windows of ``codes``, packed in BOSS field layout at
    ``B`` bits per char and compacted to the front (partition kernel).
    With ``suffix`` only the windows whose node suffix equals it are kept.
    Returns (lanes (L, N-K+1) with a PAD tail, count as a 0-d int32
    tensor)."""
    num_windows = codes.shape[0] - K + 1
    assert num_windows >= 0, "input shorter than k"
    ok = window_validity(codes, K)
    if suffix:
        ok &= suffix_mask(codes, K, suffix)
    lanes = packing.pack_windows(codes, K, B)
    lanes, count, _ = pmerge.partition_compact(lanes, ok, num_windows)
    return lanes, count
