"""Coordinate annotations: per (row, label) sets of k-mer coordinates.

PyTorch counterpart of ``metagraph_tpu/anno/coords.py`` (reference
TupleCSCMatrix and TupleRowDiff, used by ``annotate --coordinates`` and
``query --query-coords``). A ``CoordMatrix`` is the (row, col, coord)
triples sorted lexicographically on the device, so each (row, col) set
is a contiguous range. ``TupleRowDiff`` stores, for each non-anchor row,
the symmetric difference of its triples and its successor's shifted
back by ``SHIFT`` (a coordinate advances by one an edge), so the inside
of a path stores nothing.

Triples sort as four uint32 lanes (row, col, then the coordinate biased
by 2^32 in two lanes: a shifted coordinate may be negative) through the
``sort_packed`` kernel, whose order is ``np.lexsort((coord, col, row))``;
a symmetric difference keeps the triples that occur an odd number of
times (``row_diff.odd_keys``, the partition kernel).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..common import device as devmod
from ..common import merge as pmerge
from ..common import packed
from .annotator import Annotation, LabelEncoder
from .matrix import RowHits, expand_ranges, host_tensor
from .row_diff import (DEFAULT_MAX_LENGTH, _npz_walk, _successor_entries,
                       _walk_from_npz, _Walked, assign_successors_and_anchors,
                       odd_keys, walk_paths)

_BIAS = 1 << 32


def _triple_lanes(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor
                  ) -> torch.Tensor:
    """(4, n) lanes of (a, b, t + 2^32): a, b in [0, 2^32), t > -2^32."""
    tb = t.to(torch.int64) + _BIAS
    return torch.stack([packed.from_uint(a.to(torch.int64)),
                        packed.from_uint(b.to(torch.int64)),
                        packed.from_uint(tb >> 32), packed.from_uint(tb)])


def _lane_triples(lanes: torch.Tensor):
    t = (packed.as_uint(lanes[2]) << 32 | packed.as_uint(lanes[3])) - _BIAS
    return packed.as_uint(lanes[0]), packed.as_uint(lanes[1]), t


def _split_triples(q, qq, cc, tt) -> Dict[int, Dict[int, np.ndarray]]:
    """Triples sorted by (qq, cc, tt) into {row: {col: coords}} for the
    rows ``q`` (``qq`` indexes them), one dict entry per group."""
    out = {int(r): {} for r in q}
    if len(qq):
        key = np.stack([qq, cc])
        cut = np.nonzero((key[:, 1:] != key[:, :-1]).any(axis=0))[0] + 1
        starts = np.concatenate([[0], cut, [len(qq)]])
        for s, e in zip(starts[:-1].tolist(), starts[1:].tolist()):
            out[int(q[qq[s]])][int(cc[s])] = tt[s:e]
    return out


class _Coords(RowHits):
    """Surface shared by the two coordinate representations:
    ``_triples(q)`` gives the sorted (index into q, col, coord) triples
    of the valid unique rows ``q``."""
    has_values = False

    def _valid_unique(self, rows: torch.Tensor):
        rows = rows.to(torch.int64)
        ok = (rows >= 0) & (rows < self.num_rows)
        q, inv = torch.unique(rows[ok], return_inverse=True)
        return q, inv, ok

    def row_hits(self, rows: torch.Tensor):
        """(query index, column, 1) of the labels with a coordinate at
        each row (invalid rows: none)."""
        q, inv, ok = self._valid_unique(rows)
        qq, cc, _ = self._triples(q)
        C = max(self.num_cols, 1)
        key = torch.unique_consecutive(qq * C + cc)
        uq = key // C
        owner, flat = expand_ranges(
            torch.searchsorted(uq, inv, side="left"),
            torch.searchsorted(uq, inv, side="right"))
        return (torch.nonzero(ok).reshape(-1)[owner], key[flat] % C,
                torch.ones_like(owner))

    def columns_of_rows(self, query_rows) -> torch.Tensor:
        """(Q, num_cols) bool: the labels with a coordinate at each
        row (``presence``)."""
        return self.presence(query_rows)

    def tuples_for_rows(self, rows) -> Dict[int, Dict[int, np.ndarray]]:
        """{row: {col: ascending coords}} of the unique valid rows, from
        one batched fetch (the reference's get_row_tuples)."""
        rows = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
        q, _, _ = self._valid_unique(rows)
        qq, cc, tt = (x.cpu().numpy() for x in self._triples(q))
        return _split_triples(q.cpu().numpy(), qq, cc, tt)

    def get_tuples(self, query_rows, col: int) -> List[List[int]]:
        """Per query row, its ascending coordinates in ``col`` (invalid
        rows: none)."""
        rec = self.tuples_for_rows(query_rows)
        return [[int(x) for x in rec.get(int(r), {}).get(col, ())]
                for r in np.asarray(query_rows, np.int64)]


@dataclass
class CoordMatrix(_Coords):
    rows: torch.Tensor      # (nnz,) int64, ascending
    cols: torch.Tensor      # (nnz,) int32, ascending within a row
    coords: torch.Tensor    # (nnz,) int64, ascending within (row, col)
    num_rows: int
    num_cols: int

    @property
    def device(self) -> torch.device:
        return self.rows.device

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @staticmethod
    def from_triples(rows, cols, coords, num_rows: int, num_cols: int,
                     device="cuda") -> "CoordMatrix":
        """Sorted by (row, col, coord), equal triples once."""
        device = devmod.resolve(device)

        def t(a):
            return torch.as_tensor(a, device=device).to(torch.int64)

        lanes = _triple_lanes(t(rows), t(cols), t(coords))
        if lanes.shape[1]:
            lanes, _ = pmerge.sort_packed(lanes)
            out, count, _ = pmerge.partition_compact(
                lanes, packed.neighbor_ne(lanes), lanes.shape[1])
            lanes = out[:, :int(count)]
        r, c, x = _lane_triples(lanes)
        return CoordMatrix(r, c.to(torch.int32), x, num_rows, num_cols)

    def pair_key(self, r, c) -> torch.Tensor:
        """row * num_cols + col, int64 on the matrix's device."""
        return self._int64(r) * self.num_cols + self._int64(c)

    def _triples(self, q: torch.Tensor):
        owner, flat = expand_ranges(
            torch.searchsorted(self.rows, q, side="left"),
            torch.searchsorted(self.rows, q, side="right"))
        return owner, self.cols[flat].to(torch.int64), self.coords[flat]

    def to_npz_dict(self) -> dict:
        return {"coord_rows": self.rows.cpu().numpy(),
                "coord_cols": self.cols.cpu().numpy(),
                "coord_coords": self.coords.cpu().numpy(),
                "coord_shape": np.array([self.num_rows, self.num_cols])}

    @staticmethod
    def from_npz_dict(d, device) -> "CoordMatrix":
        shape = d["coord_shape"]
        return CoordMatrix(
            host_tensor(d["coord_rows"], device).to(torch.int64),
            host_tensor(d["coord_cols"], device).to(torch.int32),
            host_tensor(d["coord_coords"], device).to(torch.int64),
            int(shape[0]), int(shape[1]))


@dataclass
class TupleRowDiff(_Coords, _Walked):
    """Coordinate sets delta-compressed along successor paths (reference
    TupleRowDiff, tuple_row_diff.hpp:27). A row's set is the symmetric
    difference of D(v_i) - i * SHIFT over its walk v_0 .. v_m."""
    diffs: CoordMatrix
    anchor: torch.Tensor         # (num_rows,) bool
    succ: torch.Tensor           # (num_rows,) int64, -1 for none
    max_length: int

    SHIFT = 1

    @property
    def num_rows(self) -> int:
        return self.diffs.num_rows

    @property
    def num_cols(self) -> int:
        return self.diffs.num_cols

    @property
    def nnz(self) -> int:
        return self.diffs.nnz

    def _triples(self, q: torch.Tensor):
        """The walks of ``q`` as flat (query, node, depth) records, every
        node's diff triples shifted back by its depth, and the triples
        that occur an odd number of times kept, sorted."""
        qi, nodes, depth = walk_paths(self.anchor, self.succ, q,
                                      self.max_length)
        owner, cc, tt = self.diffs._triples(nodes)
        lanes = odd_keys(_triple_lanes(qi[owner], cc,
                                       tt - depth[owner] * self.SHIFT))
        qq, cc, tt = _lane_triples(lanes)
        return qq, cc, tt

    def to_npz_dict(self) -> dict:
        d = {"trd_" + k: v for k, v in self.diffs.to_npz_dict().items()}
        return _npz_walk(d, "trd_", self.anchor, self.succ, self.max_length)

    @staticmethod
    def from_npz_dict(d, device) -> "TupleRowDiff":
        inner = {k[len("trd_"):]: d[k] for k in d
                 if k.startswith("trd_coord_")}
        return TupleRowDiff(diffs=CoordMatrix.from_npz_dict(inner, device),
                            **_walk_from_npz(d, "trd_", device))


def build_tuple_row_diff(matrix: CoordMatrix, graph,
                         max_length: int = DEFAULT_MAX_LENGTH
                         ) -> TupleRowDiff:
    """D(v) = symdiff(T(v), T(succ(v)) - SHIFT) per column for non-anchor
    rows; anchors keep their full sets."""
    succ, anchor = assign_successors_and_anchors(graph, max_length)
    vv, flat = _successor_entries(matrix.rows, succ, anchor)
    lanes = odd_keys(_triple_lanes(
        torch.cat([matrix.rows, vv]),
        torch.cat([matrix.cols, matrix.cols[flat]]),
        torch.cat([matrix.coords,
                   matrix.coords[flat] - TupleRowDiff.SHIFT])))
    r, c, x = _lane_triples(lanes)
    diffs = CoordMatrix(r, c.to(torch.int32), x, matrix.num_rows,
                        matrix.num_cols)
    return TupleRowDiff(diffs=diffs, anchor=anchor, succ=succ,
                        max_length=max_length)


class CoordAnnotator:
    """Accumulates (row, label, coordinate) triples during annotation
    (reference annotate.cpp annotate_coordinates)."""

    def __init__(self, num_rows: int, device="cuda"):
        self.num_rows = num_rows
        self.device = devmod.resolve(device)
        self.encoder = LabelEncoder()
        self._r: List[np.ndarray] = []
        self._c: List[np.ndarray] = []
        self._x: List[np.ndarray] = []

    def add(self, rows: np.ndarray, label: str, coords: np.ndarray):
        code = self.encoder.insert(label)
        rows = np.asarray(rows, np.int64)
        self._r.append(rows)
        self._c.append(np.full(len(rows), code, np.int64))
        self._x.append(np.asarray(coords, np.int64))

    def finalize(self) -> Annotation:
        empty = [np.zeros(0, np.int64)]
        mat = CoordMatrix.from_triples(
            np.concatenate(self._r + empty), np.concatenate(self._c + empty),
            np.concatenate(self._x + empty), self.num_rows,
            max(len(self.encoder), 1), device=self.device)
        return Annotation(matrix=mat, encoder=self.encoder)


def annotate_coordinates(graph, items: Sequence[Tuple[bytes, Sequence[str]]],
                         annotator: CoordAnnotator = None) -> CoordAnnotator:
    """items: (sequence, labels). A window's coordinate is its offset in
    its label's coordinate axis: a label's sequences follow one another
    on it, each taking as many places as it has windows."""
    from ..graph.dbg_succinct import map_sequences
    if annotator is None:
        annotator = CoordAnnotator(num_rows=graph.num_anno_rows(),
                                   device=graph.device)
    offsets: Dict[str, int] = {}
    for (_, labels), nodes in zip(items, map_sequences(
            graph, [seq for seq, _ in items])):
        present = nodes > 0
        rows = graph.node_to_anno_row(nodes[present])
        pos = np.nonzero(present)[0]
        for label in labels:
            off = offsets.get(label, 0)
            annotator.add(rows, label, off + pos)
            offsets[label] = off + len(nodes)
    return annotator
