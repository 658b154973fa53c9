"""Binary annotation matrices as sorted-COO device tensors.

PyTorch counterpart of ``metagraph_tpu/anno/matrix.py``: ``RowSparse``
holds the set (row, column) bits sorted by (row, column) as two aligned
int32 tensors, plus optional per-bit integer values (count
annotations). Row queries are batched: per-row [lo, hi) ranges by
``torch.searchsorted``, flattened by one more search over the range
sizes ("interval expand"), then summed per column with ``index_add_``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..common import device as devmod


def _expand_intervals(lo: torch.Tensor, hi: torch.Tensor, capacity: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flatten per-query [lo, hi) ranges into (query_idx, flat_idx,
    valid) of length ``capacity``: entry p is the p-th element across
    all ranges in query order."""
    dev = lo.device
    sizes = torch.clamp(hi - lo, min=0).to(torch.int64)
    starts = torch.cat([torch.zeros((1,), dtype=torch.int64, device=dev),
                        torch.cumsum(sizes, 0)])
    p = torch.arange(capacity, dtype=torch.int64, device=dev)
    q = torch.searchsorted(starts, p, side="right") - 1
    qc = torch.clamp(q, 0, max(lo.shape[0] - 1, 0))
    flat = lo.to(torch.int64)[qc] + (p - starts[qc]) if lo.shape[0] else p
    return qc, flat, p < starts[-1]


@dataclass(frozen=True)
class RowSparse:
    """Sorted-COO binary matrix with optional integer values."""
    rows: torch.Tensor               # (nnz,) int32, sorted
    cols: torch.Tensor               # (nnz,) int32, sorted within a row
    num_rows: int
    num_cols: int
    values: Optional[torch.Tensor] = None   # (nnz,) int32

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @staticmethod
    def from_coo(rows, cols, num_rows: int, num_cols: int, values=None,
                 device="cuda") -> "RowSparse":
        """Sorted by (row, col), duplicates merged (values summed), on
        ``device`` (the card unless the caller names another)."""
        device = devmod.resolve(device)
        rows = torch.as_tensor(np.asarray(rows, np.int32), device=device)
        cols = torch.as_tensor(np.asarray(cols, np.int32), device=device)
        # (row, col) order: stable sort by col, then stable sort by row
        perm = torch.sort(cols, stable=True).indices
        perm = perm[torch.sort(rows[perm], stable=True).indices]
        r, c = rows[perm], cols[perm]
        v = None
        if values is not None:
            v = torch.as_tensor(np.asarray(values, np.int32),
                                device=device)[perm]
        if r.shape[0] > 0:
            first = torch.cat([torch.ones((1,), dtype=torch.bool,
                                          device=r.device),
                               (r[1:] != r[:-1]) | (c[1:] != c[:-1])])
            idx = torch.nonzero(first).reshape(-1)
            if v is not None:
                seg = torch.cumsum(first, 0) - 1
                v = torch.zeros((idx.shape[0],), dtype=torch.int32,
                                device=r.device).index_add_(0, seg, v)
            r, c = r[idx], c[idx]
        return RowSparse(rows=r, cols=c, num_rows=num_rows,
                         num_cols=num_cols, values=v)

    # -- queries -----------------------------------------------------------

    def row_ranges(self, row_idx: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        row_idx = row_idx.to(self.rows.dtype)
        lo = torch.searchsorted(self.rows, row_idx, side="left")
        hi = torch.searchsorted(self.rows, row_idx, side="right")
        return lo, hi

    def sum_rows(self, row_idx: torch.Tensor,
                 weights: torch.Tensor) -> torch.Tensor:
        """(num_cols,) weighted count of set bits per column over the
        given rows (reference BinaryMatrix::sum_rows)."""
        lo, hi = self.row_ranges(row_idx)
        q, flat, valid = _expand_intervals(lo, hi,
                                           max(int(torch.sum(hi - lo)), 1))
        col = self.cols[torch.clamp(flat, 0, max(self.nnz - 1, 0))]
        w = torch.where(valid, weights.to(torch.int64)[q], 0)
        return torch.zeros((self.num_cols,), dtype=torch.int64,
                           device=w.device).index_add_(0, col.long(), w)

    def _expand_rows(self, row_idx: torch.Tensor):
        """(query index, clamped entry index, valid) over the entries of
        the given rows, or None when there are none."""
        lo, hi = self.row_ranges(row_idx)
        cap = int(torch.sum(hi - lo)) if self.nnz else 0
        if cap == 0:
            return None
        q, flat, valid = _expand_intervals(lo, hi, cap)
        return q, torch.clamp(flat, 0, self.nnz - 1), valid

    def _dense(self, row_idx: torch.Tensor, vals, dtype) -> torch.Tensor:
        """(Q, num_cols) with ``vals(entry index)`` at each set bit."""
        Q, C = row_idx.shape[0], self.num_cols
        out = torch.zeros((Q * C + 1,), dtype=dtype, device=self.rows.device)
        hits = self._expand_rows(row_idx)
        if hits is not None:
            q, fc, valid = hits
            key = torch.where(valid, q * C + self.cols[fc].long(), Q * C)
            out.index_add_(0, key, vals(fc).to(dtype))
        return out[:Q * C].view(Q, C)

    def presence(self, row_idx: torch.Tensor) -> torch.Tensor:
        """(Q, num_cols) bool: the set bits of each queried row (the
        per-k-mer signature of --print-signature)."""
        return self._dense(row_idx, torch.ones_like, torch.int32) > 0

    def values_dense(self, row_idx: torch.Tensor) -> torch.Tensor:
        """(Q, num_cols) int32 values of each queried row, 0 where unset
        (the reference IntMatrix::get_row_values)."""
        if self.values is None:
            raise ValueError("values_dense needs a matrix with values")
        return self._dense(row_idx, lambda fc: self.values[fc], torch.int32)

    # -- serialization -----------------------------------------------------

    def to_npz_dict(self, prefix: str = "") -> dict:
        d = {prefix + "rows": self.rows.cpu().numpy(),
             prefix + "cols": self.cols.cpu().numpy(),
             prefix + "shape": np.array([self.num_rows, self.num_cols])}
        if self.values is not None:
            d[prefix + "values"] = self.values.cpu().numpy()
        return d

    @staticmethod
    def from_npz_dict(d, prefix: str = "", device="cuda") -> "RowSparse":
        device = devmod.resolve(device)
        shape = d[prefix + "shape"]
        values = d[prefix + "values"] if prefix + "values" in d else None

        def t(a):
            return torch.from_numpy(np.array(a)).to(device)

        return RowSparse(rows=t(d[prefix + "rows"]), cols=t(d[prefix + "cols"]),
                         num_rows=int(shape[0]), num_cols=int(shape[1]),
                         values=None if values is None else t(values))
