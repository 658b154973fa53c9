"""Count annotations over a BRWT-compressed pattern.

PyTorch counterpart of ``metagraph_tpu/anno/int_brwt.py``: the
reference's IntMultiBRWT (``int_brwt``) and IntRowDiffBRWT
(``row_diff_int_brwt``) targets. The presence pattern lives in a
Multi-BRWT and the values in ONE flat array in row-major (row, col)
order, with a per-row pointer array: a lookup asks the BRWT for the
row's set columns (ascending) and matches them against the row's value
slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .brwt import Brwt, build_brwt
from .matrix import RowHits, RowSparse, host_tensor
from .row_diff import (DEFAULT_MAX_LENGTH, _npz_walk, _walk_from_npz,
                       _Walked, build_int_row_diff, fold_hits)


@dataclass
class IntBrwt(RowHits):
    """Count annotation: BRWT pattern + flat row-major values (reference
    IntMultiBRWT, ``--anno-type int_brwt``)."""
    pattern: Brwt
    row_ptr: torch.Tensor        # (num_rows + 1,) int64
    vals: torch.Tensor           # (nnz,) int64
    has_values = True

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def num_rows(self) -> int:
        return self.pattern.num_rows

    @property
    def num_cols(self) -> int:
        return self.pattern.num_cols

    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])

    @property
    def values(self) -> torch.Tensor:
        """(nnz,) int64 values in row-major (row, column) order."""
        return self.vals

    def row_hits(self, rows: torch.Tensor):
        """(query index, column, value) of every entry of the given rows,
        ascending by (query, column)."""
        C = self.num_cols
        q, c, _ = self.pattern.row_hits(rows)
        key = torch.sort(q * C + c).values
        q, c = key // C, key % C
        # rank of each entry within its query's entries
        first = torch.searchsorted(q, torch.arange(rows.shape[0],
                                                   device=q.device))
        offs = torch.arange(q.shape[0], device=q.device) - first[q]
        return q, c, self.vals[self.row_ptr[rows.to(torch.int64)[q]] + offs]

    def to_npz_dict(self) -> dict:
        d = self.pattern.to_npz_dict()
        d["ibrwt_ptr"] = self.row_ptr.cpu().numpy()
        d["ibrwt_vals"] = self.vals.cpu().numpy()
        return d

    @staticmethod
    def from_npz_dict(d, device) -> "IntBrwt":
        return IntBrwt(pattern=Brwt.from_npz_dict(d, device),
                       row_ptr=host_tensor(d["ibrwt_ptr"], device),
                       vals=host_tensor(d["ibrwt_vals"], device))


@dataclass
class IntRowDiffBrwt(_Walked):
    """Count annotation delta-compressed along successor paths with a
    BRWT delta pattern (reference IntRowDiffBRWT, ``--anno-type
    row_diff_int_brwt``): a walk sums the deltas fetched through it."""
    diffs: IntBrwt
    anchor: torch.Tensor
    succ: torch.Tensor
    max_length: int
    has_values = True

    @property
    def num_rows(self) -> int:
        return self.diffs.num_rows

    @property
    def num_cols(self) -> int:
        return self.diffs.num_cols

    @property
    def nnz(self) -> int:
        return self.diffs.nnz

    def row_hits(self, rows: torch.Tensor):
        qi, nodes, _ = self._walk(rows)
        q, c, v = self.diffs.row_hits(torch.clamp(nodes, 0,
                                                  self.num_rows - 1))
        return fold_hits(self.num_cols, qi[q], c, v)

    def to_npz_dict(self) -> dict:
        return _npz_walk(self.diffs.to_npz_dict(), "irdb_", self.anchor,
                         self.succ, self.max_length)

    @staticmethod
    def from_npz_dict(d, device) -> "IntRowDiffBrwt":
        return IntRowDiffBrwt(diffs=IntBrwt.from_npz_dict(d, device),
                              **_walk_from_npz(d, "irdb_", device))


def build_int_brwt(matrix: RowSparse, subsample: int = 1_000_000,
                   linkage=None) -> IntBrwt:
    """The int_brwt target of a count annotation (its entries are in
    (row, col) order already: the values are that order's)."""
    if matrix.values is None:
        raise ValueError("int_brwt needs a count annotation "
                         "(annotate --count-kmers)")
    pattern = build_brwt(matrix, subsample=subsample, linkage=linkage)
    row_ptr = torch.searchsorted(
        matrix.rows.to(torch.int64),
        torch.arange(matrix.num_rows + 1, device=matrix.device))
    return IntBrwt(pattern=pattern, row_ptr=row_ptr,
                   vals=matrix.values.to(torch.int64))


def build_int_row_diff_brwt(matrix: RowSparse, graph,
                            max_length: int = DEFAULT_MAX_LENGTH,
                            subsample: int = 1_000_000,
                            row_counts=None, row_reduction=None
                            ) -> IntRowDiffBrwt:
    """row_diff_int_brwt: the IntRowDiff deltas on a BRWT pattern."""
    ird = build_int_row_diff(matrix, graph, max_length=max_length,
                             row_counts=row_counts,
                             row_reduction=row_reduction)
    delta = RowSparse(rows=ird.rows.to(torch.int32), cols=ird.cols,
                      num_rows=ird.num_rows, num_cols=ird.num_cols,
                      values=ird.vals.to(torch.int32))
    return IntRowDiffBrwt(diffs=build_int_brwt(delta, subsample=subsample),
                          anchor=ird.anchor, succ=ird.succ,
                          max_length=ird.max_length)
