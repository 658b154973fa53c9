"""Binary annotation matrices as sorted-COO device tensors.

PyTorch counterpart of ``metagraph_tpu/anno/matrix.py``: ``RowSparse``
holds the set (row, column) bits sorted by (row, column) as two aligned
int32 tensors, plus optional per-bit integer values (count
annotations). Row queries are batched: per-row [lo, hi) ranges by
``torch.searchsorted``, flattened exactly ("interval expand",
``expand_ranges``), then summed per column with ``index_add_``.

Every representation of ``anno/`` (RowSparse, Brwt, RowDiff, ...)
answers ``row_hits(rows)``: the (query, column, value) of every entry of
the queried rows, sparse, value 1 in a binary matrix. ``RowHits`` builds
the row API of the JAX package's forms on that one call, for every
form: ``presence`` / ``get_rows_dense``, ``get_rows``, ``sum_rows`` and,
for the integer ones (``has_values``), ``values_dense`` /
``get_row_values_dense``, ``sum_row_values`` and ``row_values_list``.
Rows and weights may be tensors, numpy arrays or lists; the results are
tensors on the matrix's device. Each representation gives back its
logical matrix with ``to_row_sparse()``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..common import device as devmod


def expand_ranges(lo: torch.Tensor, hi: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flatten per-query [lo, hi) ranges exactly: (owner (T,), flat (T,))
    int64, entry p the p-th element across all ranges in query order."""
    dev = lo.device
    sizes = torch.clamp(hi - lo, min=0).to(torch.int64)
    owner = torch.repeat_interleave(
        torch.arange(sizes.shape[0], device=dev), sizes)
    starts = torch.cumsum(sizes, 0) - sizes
    pos = torch.arange(owner.shape[0], device=dev)
    return owner, lo.to(torch.int64)[owner] + pos - starts[owner]


def host_tensor(a, device) -> torch.Tensor:
    """A numpy array of a ``.annodbg.npz`` as a tensor on ``device``
    (uint32 words keep their bits in int32)."""
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


class RowHits:
    """The row API of a representation that has ``row_hits``,
    ``num_cols``, ``device`` and ``has_values``. A query row outside the
    matrix, or without a set bit, has no entries."""

    def _int64(self, x) -> torch.Tensor:
        """Rows or weights (a tensor, numpy array or list) as a flat int64
        tensor on the matrix's device."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x, np.int64))
        return x.reshape(-1).to(device=self.device, dtype=torch.int64)

    def _need_values(self, what: str):
        if not self.has_values:
            raise ValueError(f"{what} needs a matrix with values (a count "
                             f"annotation)")

    def _scatter(self, rows, dtype, value) -> torch.Tensor:
        """(Q, num_cols) with ``value(v)`` summed at each entry."""
        rows = self._int64(rows)
        Q, C = rows.shape[0], self.num_cols
        q, c, v = self.row_hits(rows)
        return torch.zeros((Q * C,), dtype=dtype, device=self.device) \
            .index_add_(0, q * C + c, value(v).to(dtype)).view(Q, C)

    def presence(self, rows) -> torch.Tensor:
        """(Q, num_cols) bool: the set bits of each queried row (the
        per-k-mer signature of --print-signature)."""
        return self._scatter(rows, torch.int32, torch.ones_like) > 0

    def get_rows_dense(self, rows) -> torch.Tensor:
        """(Q, num_cols) bool: ``presence``."""
        return self.presence(rows)

    def values_dense(self, rows) -> torch.Tensor:
        """(Q, num_cols) int64 values of each queried row, 0 where unset
        (the reference IntMatrix::get_row_values)."""
        self._need_values("values_dense")
        return self._scatter(rows, torch.int64, lambda v: v)

    def get_row_values_dense(self, rows) -> torch.Tensor:
        """(Q, num_cols) int64: ``values_dense``."""
        return self.values_dense(rows)

    def get_rows(self, rows) -> List[List[int]]:
        """Per queried row, its set columns ascending (the reference
        BinaryMatrix::get_rows)."""
        dense = self.presence(rows)
        q, c = torch.nonzero(dense, as_tuple=True)
        per = torch.bincount(q, minlength=dense.shape[0]).tolist()
        return [x.tolist() for x in torch.split(c, per)] if per else []

    def _weighted(self, rows, weights, value) -> torch.Tensor:
        q, c, v = self.row_hits(self._int64(rows))
        return torch.zeros((self.num_cols,), dtype=torch.int64,
                           device=self.device).index_add_(
            0, c, self._int64(weights)[q] * value(v))

    def sum_rows(self, rows, weights) -> torch.Tensor:
        """(num_cols,) int64: per column, the sum of the weights of the
        queried rows that have it set (reference BinaryMatrix::sum_rows;
        a row queried twice counts twice)."""
        return self._weighted(rows, weights, torch.ones_like)

    def sum_row_values(self, rows, weights) -> torch.Tensor:
        """(num_cols,) int64: per column, the sum of weight times value
        over the queried rows (reference IntMatrix::sum_row_values, the
        --query-counts sum)."""
        self._need_values("sum_row_values")
        return self._weighted(rows, weights, lambda v: v)

    def row_values_list(self, rows) -> Tuple[torch.Tensor, torch.Tensor]:
        """(columns, values) int64 of the non-zero values of the queried
        rows, row by row, columns ascending (the quantile queries'
        IntMatrix::get_row_values; a row queried twice counts twice)."""
        self._need_values("row_values_list")
        dense = self.values_dense(rows)
        q, c = torch.nonzero(dense, as_tuple=True)
        return c, dense[q, c]

    def to_row_sparse(self) -> "RowSparse":
        return row_sparse_of(self)


@dataclass(frozen=True)
class RowSparse(RowHits):
    """Sorted-COO binary matrix with optional integer values."""
    rows: torch.Tensor               # (nnz,) int32, sorted
    cols: torch.Tensor               # (nnz,) int32, sorted within a row
    num_rows: int
    num_cols: int
    values: Optional[torch.Tensor] = None   # (nnz,) int32

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @property
    def has_values(self) -> bool:
        return self.values is not None

    @property
    def device(self) -> torch.device:
        return self.rows.device

    def to_row_sparse(self) -> "RowSparse":
        return self

    @staticmethod
    def from_coo(rows, cols, num_rows: int, num_cols: int, values=None,
                 device="cuda") -> "RowSparse":
        """Sorted by (row, col), duplicates merged (values summed), on
        ``device`` (the card unless the caller names another). The
        arrays may be numpy arrays or tensors."""
        device = devmod.resolve(device)
        rows = torch.as_tensor(rows, device=device).to(torch.int32)
        cols = torch.as_tensor(cols, device=device).to(torch.int32)
        # (row, col) order: stable sort by col, then stable sort by row
        perm = torch.sort(cols, stable=True).indices
        perm = perm[torch.sort(rows[perm], stable=True).indices]
        r, c = rows[perm], cols[perm]
        v = None
        if values is not None:
            v = torch.as_tensor(values, device=device).to(torch.int32)[perm]
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
        row_idx = self._int64(row_idx).to(self.rows.dtype)
        lo = torch.searchsorted(self.rows, row_idx, side="left")
        hi = torch.searchsorted(self.rows, row_idx, side="right")
        return lo, hi

    def row_entries(self, row_idx: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(query index, entry index) int64 of every entry of the given
        rows, in query order (rows outside the matrix have none)."""
        return expand_ranges(*self.row_ranges(row_idx))

    def row_hits(self, row_idx: torch.Tensor):
        """(query index, column, value) int64 of every entry of the given
        rows, in query order (value 1 without values)."""
        q, e = self.row_entries(row_idx)
        return q, self.cols[e].long(), (torch.ones_like(q) if self.values
                                        is None else self.values[e].long())

    def get_column(self, col: int) -> torch.Tensor:
        """The rows with column ``col`` set, ascending (the stored int32
        rows)."""
        return self.rows[self.cols == col]

    def slice_rows(self, row_idx, max_row_nnz: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """((Q, max_row_nnz) int32 columns of each queried row, padded
        with -1 and cut at ``max_row_nnz``; (Q,) int64 set-bit counts,
        not cut)."""
        lo, hi = self.row_ranges(row_idx)
        counts = hi - lo
        offs = torch.arange(max_row_nnz, device=self.device)[None, :]
        flat = torch.clamp(lo[:, None] + offs, max=max(self.nnz - 1, 0))
        col = (self.cols[flat] if self.nnz else
               torch.zeros(flat.shape, dtype=self.cols.dtype,
                           device=self.device))
        return torch.where(offs < counts[:, None], col, -1), counts

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


def row_sparse_of(m, chunk: int = 1 << 18) -> RowSparse:
    """The logical matrix of any representation as a RowSparse on its
    device (with values for the integer ones), decoded ``chunk`` rows at
    a time."""
    dev = m.device
    rs, cs, vs = [], [], []
    for s in range(0, m.num_rows, chunk):
        rows = torch.arange(s, min(s + chunk, m.num_rows), device=dev)
        dense = m.values_dense(rows) if m.has_values else m.presence(rows)
        r, c = torch.nonzero(dense, as_tuple=True)
        rs.append(r + s)
        cs.append(c)
        if m.has_values:
            vs.append(dense[r, c])
    empty = torch.zeros((0,), dtype=torch.int64, device=dev)
    return RowSparse(rows=torch.cat(rs + [empty]).to(torch.int32),
                     cols=torch.cat(cs + [empty]).to(torch.int32),
                     num_rows=m.num_rows, num_cols=m.num_cols,
                     values=torch.cat(vs + [empty]).to(torch.int32)
                     if m.has_values else None)
