"""Which records a read comes from, worked out by plain PyTorch sorts.

MetaGraph's label query (``query --discovery-fraction f``) on a canonical
graph annotated one label a record: a window of a read counts for a
record when the record holds the window's k-mer in either orientation;
the read reports, in label order, each record that at least
max(1, ceil(f * windows)) of its windows count for. The index is a sorted
table of (k-mer, record) pairs of the records' windows, each pair once.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .kmers import window_ints


def _canonical(fwd, rc, both_strands):
    return torch.minimum(fwd, rc) if both_strands else fwd


class LabelIndex:
    """The (k-mer, record) table of records cut from one base array.
    ``both_strands`` False matches each k-mer as read (the control: the
    graph's canonical guarantee broken)."""

    def __init__(self, bases: np.ndarray, bounds: np.ndarray, K: int,
                 device="cpu", both_strands: bool = True):
        self.K = K
        self.both_strands = both_strands
        self.device = torch.device(device)
        self.num_records = len(bounds) - 1
        b = torch.from_numpy(np.ascontiguousarray(bases)).to(self.device)
        v = (b.to(torch.int64) - 1)[None]
        keys = _canonical(window_ints(v, K)[0],
                          window_ints(v, K, reverse_complement=True)[0],
                          both_strands)
        del v
        starts = torch.from_numpy(np.asarray(bounds[:-1], np.int64)).to(
            self.device)
        pos = torch.arange(keys.shape[0], device=self.device)
        rec = torch.searchsorted(starts, pos, right=True) - 1
        rec_end = torch.searchsorted(starts, pos + K - 1, right=True) - 1
        inside = rec == rec_end                  # no window spans two
        keys, rec = keys[inside], rec[inside]
        keys, order = torch.sort(keys, stable=True)  # records ascending
        rec = rec[order]                             # within a k-mer
        first = torch.ones_like(keys, dtype=torch.bool)
        first[1:] = (keys[1:] != keys[:-1]) | (rec[1:] != rec[:-1])
        self.keys, self.rec = keys[first], rec[first]

    def read_labels(self, reads: np.ndarray, ratio: float,
                    block: int = 1 << 16) -> np.ndarray:
        """Sorted int64 keys read * num_records + record of every label
        that each read ((R, length) codes 1..4) reports."""
        R, length = reads.shape
        n_win = length - self.K + 1
        if n_win <= 0:
            return np.zeros(0, np.int64)
        need = max(1, math.ceil(ratio * n_win))
        C = self.num_records
        out = []
        for s in range(0, R, block):
            v = torch.from_numpy(np.ascontiguousarray(
                reads[s:s + block])).to(self.device).to(torch.int64) - 1
            q = _canonical(window_ints(v, self.K),
                           window_ints(v, self.K, reverse_complement=True),
                           self.both_strands).reshape(-1)
            lo = torch.searchsorted(self.keys, q)
            hi = torch.searchsorted(self.keys, q, right=True)
            n = hi - lo
            read = torch.arange(v.shape[0], device=self.device)
            read = read.repeat_interleave(n_win).repeat_interleave(n)
            first = lo.repeat_interleave(n)
            within = torch.arange(first.shape[0], device=self.device) - \
                torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
            rec = self.rec[first + within]
            keys, counts = torch.unique((read + s) * C + rec,
                                        return_counts=True)
            out.append(keys[counts >= need].cpu().numpy())
        return np.concatenate(out + [np.zeros(0, np.int64)])
