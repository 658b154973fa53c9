"""Row-deduplicated annotations (the "rainbow" family).

PyTorch counterpart of ``metagraph_tpu/anno/unique_row.py`` (reference
UniqueRowBinmat, Rainbowfish, Rainbow<BRWT>): rows with the same label
set are stored once, as distinct rows plus a per-row code; a query is
two gathers, row -> code -> distinct row. The distinct rows are a
RowSparse or (``rb_brwt``) a Multi-BRWT.

The build runs on the matrix's device: each row's columns, padded with
-1 to the widest row, are packed into uint32 lanes as ``col + 1``
fields (the first column most significant; a field's width a power of
two), so the lanes' order is the padded rows' lexicographic order,
which ``np.unique(axis=0)`` gives in the JAX package; ``merge.lex_order``
orders them (one sort kernel call for any number of lanes, returning
the order alone), and each run of equal rows is one code.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..common import merge as pmerge
from ..common import packed
from .matrix import RowHits, RowSparse, expand_ranges, host_tensor


@dataclass
class UniqueRow(RowHits):
    codes: torch.Tensor          # (num_rows,) int32 -> distinct row id
    distinct: object             # RowSparse or Brwt (num_distinct, C)
    num_rows: int
    has_values = False

    @property
    def device(self) -> torch.device:
        return self.codes.device

    @property
    def num_cols(self) -> int:
        return self.distinct.num_cols

    @property
    def num_distinct_rows(self) -> int:
        return self.distinct.num_rows

    @property
    def nnz(self) -> int:
        """Set bits of the expanded matrix."""
        n_d = self.num_distinct_rows
        q, _, _ = self.distinct.row_hits(torch.arange(n_d,
                                                      device=self.device))
        sizes = torch.bincount(q, minlength=n_d)
        freq = torch.bincount(self.codes.to(torch.int64), minlength=n_d)
        return int((sizes * freq).sum())

    @staticmethod
    def from_row_sparse(m: RowSparse) -> "UniqueRow":
        dev = m.device
        C = m.num_cols
        if m.num_rows == 0:
            return UniqueRow(
                codes=torch.zeros((0,), dtype=torch.int32, device=dev),
                distinct=RowSparse.from_coo([], [], 1, C, device=dev),
                num_rows=0)
        rows = m.rows.to(torch.int64)
        counts = torch.bincount(rows, minlength=m.num_rows)
        width = max(int(counts.max()), 1)
        padded = torch.full((m.num_rows, width), -1, dtype=torch.int32,
                            device=dev)
        pos = torch.arange(rows.shape[0], device=dev) \
            - (torch.cumsum(counts, 0) - counts)[rows]
        padded[rows, pos] = m.cols
        bits = 1 << (max(C.bit_length(), 1) - 1).bit_length()  # divides 32
        lanes = packed.from_fields((padded.flip(1) + 1).T, bits)
        order = pmerge.lex_order(lanes)
        start = packed.neighbor_ne(lanes[:, order])
        codes = torch.empty((m.num_rows,), dtype=torch.int32, device=dev)
        codes[order] = (torch.cumsum(start, 0) - 1).to(torch.int32)
        uniq = padded[order[start]]
        d_rows, d_pos = torch.nonzero(uniq >= 0, as_tuple=True)
        distinct = RowSparse(rows=d_rows.to(torch.int32),
                             cols=uniq[d_rows, d_pos],
                             num_rows=max(uniq.shape[0], 1), num_cols=C)
        return UniqueRow(codes=codes, distinct=distinct, num_rows=m.num_rows)

    def with_brwt_distinct(self, subsample: int = 1_000_000) -> "UniqueRow":
        """Rainbow<BRWT>: the distinct rows as a Multi-BRWT."""
        from .brwt import build_brwt
        return UniqueRow(codes=self.codes,
                         distinct=build_brwt(self.distinct.to_row_sparse(),
                                             subsample=subsample),
                         num_rows=self.num_rows)

    def row_hits(self, rows: torch.Tensor):
        return self.distinct.row_hits(self.codes[rows.to(torch.int64)])

    def to_row_sparse(self) -> RowSparse:
        dm = self.distinct.to_row_sparse()
        d_rows = dm.rows.to(torch.int64)
        codes = self.codes.to(torch.int64)
        owner, flat = expand_ranges(
            torch.searchsorted(d_rows, codes, side="left"),
            torch.searchsorted(d_rows, codes, side="right"))
        return RowSparse(rows=owner.to(torch.int32), cols=dm.cols[flat],
                         num_rows=self.num_rows, num_cols=self.num_cols)

    def to_npz_dict(self) -> dict:
        if isinstance(self.distinct, RowSparse):
            d = self.distinct.to_npz_dict(prefix="ur_")
        else:
            d = self.distinct.to_npz_dict()
            d["ur_brwt"] = np.array(1)
        d["ur_codes"] = self.codes.cpu().numpy()
        d["ur_num_rows"] = np.array(self.num_rows)
        return d

    @staticmethod
    def from_npz_dict(d, device) -> "UniqueRow":
        if "ur_brwt" in d:
            from .brwt import Brwt
            distinct = Brwt.from_npz_dict(d, device)
        else:
            distinct = RowSparse.from_npz_dict(d, "ur_", device)
        return UniqueRow(codes=host_tensor(d["ur_codes"], device)
                         .to(torch.int32),
                         distinct=distinct, num_rows=int(d["ur_num_rows"]))

