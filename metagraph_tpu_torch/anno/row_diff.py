"""RowDiff: annotation rows delta-compressed along graph paths.

PyTorch counterpart of ``metagraph_tpu/anno/row_diff.py`` (reference
row_diff.hpp:29-230, row_diff_builder.cpp:322-688). Each row is stored
as its XOR against its successor's row (``IntRowDiff``: the difference
of the values), except at anchor rows, which store the full row; a
query walks successor links to an anchor and folds the diffs back.

On the graph's device:
  * successors and anchors: one batched adjacency pass routes forks to
    the neighbour with the most labels (the first on a tie); the pointer
    doubling of ``graph/traversal.py`` (minimum-id cycle leaders) gives
    each node's distance to its root; anchors are the roots, every
    ``max_length``-th node, and (stage 2) the rows whose diff grows;
  * diffs: the rows' (row, col) keys and their successors' keys pulled
    onto each non-anchor row, as int64 ``row * C + col`` split into two
    uint32 lanes, sorted by the ``sort_packed`` kernel; keys that occur
    an odd number of times survive the XOR (non-zero sums the
    difference), compacted by the ``partition_compact`` kernel;
  * query: every row's walk to its anchor (at most ``max_length + 1``
    nodes) as flat (query, node) records, the diffs of all of them in
    one interval expand, then the parity (or the sum) per (query, col),
    sparse, by the same sort and compaction as the builds.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..common import merge as pmerge
from ..common import packed
from ..common import telemetry
from ..graph.traversal import in_chunks, rank_chains
from .matrix import RowHits, RowSparse, expand_ranges, host_tensor

DEFAULT_MAX_LENGTH = 64

# nodes on every walk of ``walk_paths`` since import (its (query, node)
# records), counted from the sizes the walk's masked steps already bring
# to the host
walk_nodes = 0


# ---------------------------------------------------------------------------
# successors and anchors
# ---------------------------------------------------------------------------

def assign_successors_and_anchors(graph, max_length: int = DEFAULT_MAX_LENGTH,
                                  row_counts=None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(succ (N,) int64 successor row, -1 for none; anchor (N,) bool) on
    the graph's device. A node's successor is one outgoing neighbour: with
    ``row_counts`` (labels per row, the stage-0 artifact) the one with the
    most labels, the first on a tie; without, the first. Anchors: nodes
    without a successor, cycle leaders, and every ``max_length``-th node
    of each chain counted from its root."""
    N = graph.num_nodes()
    dev = graph.device
    succs = in_chunks(graph.successors,
                      torch.arange(1, N + 1, device=dev))      # (N, sigma-1)
    if row_counts is not None and len(row_counts) >= N:
        rc = torch.as_tensor(row_counts, device=dev).to(torch.int64)
        cnt = torch.where(succs > 0, rc[torch.clamp(succs - 1, 0, N - 1)], -1)
        choice = torch.argmax(cnt, dim=1)                   # first maximum
    else:
        choice = torch.argmax((succs > 0).to(torch.int8), dim=1)
    picked = torch.gather(succs, 1, choice[:, None])[:, 0].to(torch.int64)
    ids = torch.arange(1, N + 1, device=dev)
    # self-successors would loop forever
    first = torch.cat([picked.new_zeros((1,)),
                       torch.where((picked > 0) & (picked != ids), picked, 0)])
    _, dist, _ = rank_chains(first)
    first = torch.where(dist > 0, first, 0)      # roots and cycle leaders
    anchor = ((first == 0) | (dist % max_length == 0))[1:]
    return torch.where(first[1:] > 0, first[1:] - 1, -1), anchor


# ---------------------------------------------------------------------------
# diff keys
# ---------------------------------------------------------------------------

def _key_lanes(keys: torch.Tensor) -> torch.Tensor:
    """Non-negative int64 keys as (2, n) uint32 lanes (high, low)."""
    return torch.stack([packed.from_uint(keys >> 32), packed.from_uint(keys)])


def _lane_keys(lanes: torch.Tensor) -> torch.Tensor:
    return (packed.as_uint(lanes[0]) << 32) | packed.as_uint(lanes[1])


def _groups(lanes: torch.Tensor):
    """(first-of-group mask, group id) of sorted lanes."""
    start = packed.neighbor_ne(lanes)
    return start, torch.cumsum(start, 0) - 1


def odd_keys(lanes: torch.Tensor) -> torch.Tensor:
    """Sort (L, n) key lanes (``sort_packed``) and keep one copy of each
    key that occurs an odd number of times (``partition_compact``):
    the surviving lanes, ascending."""
    n = lanes.shape[1]
    if n == 0:
        return lanes
    lanes, _ = pmerge.sort_packed(lanes)
    start, gid = _groups(lanes)
    odd = (torch.bincount(gid) & 1).to(torch.bool)
    out, count, _ = pmerge.partition_compact(lanes, start & odd[gid], n)
    return out[:, :int(count)]


def _summed_keys(keys: torch.Tensor, vals: torch.Tensor):
    """Sort int64 keys with their int32 values and sum the values of
    equal keys; the keys whose sum is not zero and their sums."""
    n = keys.shape[0]
    if n == 0:
        return keys, keys
    lanes, (v,) = pmerge.sort_packed(_key_lanes(keys), vals.to(torch.int32))
    start, gid = _groups(lanes)
    sums = torch.zeros((int(gid[-1]) + 1,), dtype=torch.int64,
                       device=keys.device).index_add_(0, gid, v.to(torch.int64))
    out, count, (s,) = pmerge.partition_compact(
        lanes, start & (sums[gid] != 0), n, sums[gid].to(torch.int32))
    c = int(count)
    return _lane_keys(out[:, :c]), s[:c].to(torch.int64)


def _successor_entries(rows: torch.Tensor, succ: torch.Tensor,
                       anchor: torch.Tensor):
    """(row, entry index): each non-anchor row with a successor, once per
    entry of its successor's row (``rows`` sorted int64)."""
    v = torch.nonzero(~anchor).squeeze(1)
    sv = succ[v]
    ok = sv >= 0
    v, sv = v[ok], sv[ok]
    owner, flat = expand_ranges(torch.searchsorted(rows, sv, side="left"),
                                torch.searchsorted(rows, sv, side="right"))
    return v[owner], flat


def diff_keys(matrix: RowSparse, succ, anchor) -> torch.Tensor:
    """Sorted int64 ``row * C + col`` keys of the XOR-diff matrix."""
    rows = matrix.rows.to(torch.int64)
    cols = matrix.cols.to(torch.int64)
    C = matrix.num_cols
    vv, flat = _successor_entries(rows, succ, anchor)
    keys = torch.cat([rows * C + cols, vv * C + cols[flat]])
    return _lane_keys(odd_keys(_key_lanes(keys)))


def int_delta_keys(matrix: RowSparse, succ, anchor):
    """(keys, sums): the ``row * C + col`` keys of the value deltas that
    are not zero, ascending, and the deltas (anchor rows keep their
    values; the others subtract their successor's)."""
    rows = matrix.rows.to(torch.int64)
    cols = matrix.cols.to(torch.int64)
    vals = matrix.values.to(torch.int64)
    C = matrix.num_cols
    vv, flat = _successor_entries(rows, succ, anchor)
    return _summed_keys(torch.cat([rows * C + cols, vv * C + cols[flat]]),
                        torch.cat([vals, -vals[flat]]))


def _reduction(matrix: RowSparse, kept: torch.Tensor) -> torch.Tensor:
    """Per row, nnz(row) - nnz(diff row)."""
    n = matrix.num_rows
    return (torch.bincount(matrix.rows.to(torch.int64), minlength=n)
            - torch.bincount(kept // matrix.num_cols, minlength=n))


def compute_row_counts(matrix: RowSparse) -> torch.Tensor:
    """Stage-0 artifact: labels per row."""
    return torch.bincount(matrix.rows.to(torch.int64),
                          minlength=matrix.num_rows)


def compute_row_reduction(matrix: RowSparse, graph,
                          max_length: int = DEFAULT_MAX_LENGTH,
                          row_counts=None) -> torch.Tensor:
    """Stage-1 artifact: per row nnz(row) - nnz(diff row) under the
    path-position anchors. Negative entries mark rows whose diff grows
    the annotation; stage 2 makes them anchors."""
    succ, anchor = assign_successors_and_anchors(graph, max_length,
                                                 row_counts)
    return _reduction(matrix, diff_keys(matrix, succ, anchor))


def compute_row_reduction_int(matrix: RowSparse, graph,
                              max_length: int = DEFAULT_MAX_LENGTH,
                              row_counts=None) -> torch.Tensor:
    """Stage-1 artifact of a count annotation: the nnz reduction of its
    value deltas."""
    if row_counts is None:
        row_counts = compute_row_counts(matrix)
    succ, anchor = assign_successors_and_anchors(graph, max_length,
                                                 row_counts)
    return _reduction(matrix, int_delta_keys(matrix, succ, anchor)[0])


def _stage2_anchors(matrix, graph, max_length, row_counts, row_reduction,
                    kept_fn):
    """Successors and anchors with the rows whose diff grows made
    anchors (the reduction computed here unless given)."""
    succ, anchor = assign_successors_and_anchors(graph, max_length,
                                                 row_counts)
    if row_reduction is None:
        row_reduction = _reduction(matrix, kept_fn(matrix, succ, anchor))
    red = torch.as_tensor(row_reduction, device=anchor.device)
    return succ, anchor | (red[:matrix.num_rows] < 0)


def build_row_diff(matrix: RowSparse, graph,
                   max_length: int = DEFAULT_MAX_LENGTH,
                   row_counts=None, row_reduction=None) -> "RowDiff":
    """A column annotation in RowDiff form against ``graph``: the
    reference's three stages in one pass (``row_counts`` /
    ``row_reduction`` take the staged CLI artifacts, so staged and
    one-shot conversions give the same annotation)."""
    if row_counts is None:
        row_counts = compute_row_counts(matrix)
    succ, anchor = _stage2_anchors(matrix, graph, max_length, row_counts,
                                   row_reduction, diff_keys)
    kept = diff_keys(matrix, succ, anchor)
    C = matrix.num_cols
    diffs = RowSparse(rows=(kept // C).to(torch.int32),
                      cols=(kept % C).to(torch.int32),
                      num_rows=matrix.num_rows, num_cols=C)
    return RowDiff(diffs=diffs, anchor=anchor, succ=succ,
                   max_length=max_length)


def build_int_row_diff(matrix: RowSparse, graph,
                       max_length: int = DEFAULT_MAX_LENGTH,
                       row_counts=None, row_reduction=None) -> "IntRowDiff":
    """Count values delta-compressed along successor paths, with the
    same fork routing and reduction anchors as ``build_row_diff``."""
    if matrix.values is None:
        raise ValueError("int_row_diff needs a count annotation "
                         "(annotate --count-kmers)")
    if row_counts is None:
        row_counts = compute_row_counts(matrix)
    succ, anchor = _stage2_anchors(
        matrix, graph, max_length, row_counts, row_reduction,
        lambda m, s, a: int_delta_keys(m, s, a)[0])
    keys, sums = int_delta_keys(matrix, succ, anchor)
    C = matrix.num_cols
    return IntRowDiff(rows=keys // C, cols=(keys % C).to(torch.int32),
                      vals=sums, anchor=anchor, succ=succ,
                      max_length=max_length, num_rows=matrix.num_rows,
                      num_cols=C)


def build_row_diff_brwt(matrix: RowSparse, graph,
                        max_length: int = DEFAULT_MAX_LENGTH,
                        subsample: int = 1_000_000) -> "RowDiffBrwt":
    """RowDiff whose diff matrix is a Multi-BRWT (the reference's
    row_diff_brwt target)."""
    from .brwt import build_brwt
    rd = build_row_diff(matrix, graph, max_length)
    return RowDiffBrwt(diffs=build_brwt(rd.diffs, subsample=subsample),
                       anchor=rd.anchor, succ=rd.succ,
                       max_length=rd.max_length)


# ---------------------------------------------------------------------------
# the anchor walk
# ---------------------------------------------------------------------------

def walk_paths(anchor: torch.Tensor, succ: torch.Tensor, rows: torch.Tensor,
               max_length: int):
    """(query index, node, depth) int64 of every node on each row's walk:
    the row, then successor after successor until an anchor, a row
    without successor, or ``max_length + 1`` nodes."""
    global walk_nodes
    dev = rows.device
    q = torch.arange(rows.shape[0], device=dev)
    cur = rows.to(torch.int64)
    nmax = anchor.shape[0] - 1
    qs, nodes, depths = [q[:0]], [q[:0]], [q[:0]]
    walked = 0
    for d in range(max_length + 1):
        n = q.numel()
        if not n:
            break
        walked += n
        qs.append(q)
        nodes.append(cur)
        depths.append(torch.full_like(q, d))
        curc = torch.clamp(cur, 0, nmax)
        nxt = succ[curc]
        go = ~anchor[curc] & (nxt >= 0)
        q, cur = q[go], nxt[go]
    walk_nodes += walked
    return torch.cat(qs), torch.cat(nodes), torch.cat(depths)


def fold_hits(C: int, q, col, vals=None):
    """Hits merged per (query, column) as (query, column, value) int64:
    the pairs hit an odd number of times (value 1), or with ``vals`` the
    pairs whose values do not sum to zero, with their sums. The keys go
    through ``odd_keys`` / ``_summed_keys`` (the sort and partition
    kernels)."""
    C = max(C, 1)
    with telemetry.span("anno.fold", quiet=True):
        keys = q * C + col
        if vals is None:
            keys = _lane_keys(odd_keys(_key_lanes(keys)))
            vals = torch.ones_like(keys)
        else:
            keys, vals = _summed_keys(keys, vals)
        return keys // C, keys % C, vals


def _npz_walk(d: dict, prefix: str, anchor, succ, max_length: int,
              anchor_key: str = "anchor"):
    """``d`` with the walk's arrays added under ``prefix`` (the anchors as
    ``np.packbits`` bytes and their count)."""
    d[prefix + anchor_key] = np.packbits(anchor.cpu().numpy())
    d[prefix + "anchor_len"] = np.array(anchor.shape[0])
    d[prefix + "succ"] = succ.cpu().numpy()
    d[prefix + "max_length"] = np.array(max_length)
    return d


def _walk_from_npz(d, prefix: str, device, anchor_key: str = "anchor"):
    n = int(d[prefix + "anchor_len"])
    anchor = np.unpackbits(d[prefix + anchor_key])[:n].astype(bool)
    return dict(anchor=torch.from_numpy(anchor).to(device),
                succ=host_tensor(d[prefix + "succ"], device).to(torch.int64),
                max_length=int(d[prefix + "max_length"]))


class _Walked(RowHits):
    """Shared surface of the representations that walk to anchors."""

    @property
    def device(self) -> torch.device:
        return self.anchor.device

    def num_anchors(self) -> int:
        return int(self.anchor.sum())

    def _walk(self, rows):
        with telemetry.span("anno.walk", quiet=True):
            return walk_paths(self.anchor, self.succ, rows, self.max_length)


@dataclass
class RowDiff(_Walked):
    diffs: RowSparse             # XOR diffs (full rows at anchors)
    anchor: torch.Tensor         # (num_rows,) bool
    succ: torch.Tensor           # (num_rows,) int64, -1 for none
    max_length: int
    has_values = False

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
        """The XOR of the diffs along each walk."""
        qi, nodes, _ = self._walk(rows)
        q, c, _ = self.diffs.row_hits(nodes)
        return fold_hits(self.num_cols, qi[q], c)

    def to_npz_dict(self) -> dict:
        return _npz_walk(self.diffs.to_npz_dict(prefix="rd_"), "rd_",
                         self.anchor, self.succ, self.max_length,
                         anchor_key="anchor_prefix")

    @staticmethod
    def from_npz_dict(d, device) -> "RowDiff":
        return RowDiff(diffs=RowSparse.from_npz_dict(d, "rd_", device),
                       **_walk_from_npz(d, "rd_", device,
                                        anchor_key="anchor_prefix"))


@dataclass
class IntRowDiff(_Walked):
    """Count values delta-compressed along successor paths (reference
    IntRowDiff, int_row_diff.hpp:48): non-anchor rows store value minus
    the successor's value; a walk sums the deltas to the true value."""
    rows: torch.Tensor           # (nnz,) int64, ascending
    cols: torch.Tensor           # (nnz,) int32
    vals: torch.Tensor           # (nnz,) int64 deltas, may be negative
    anchor: torch.Tensor
    succ: torch.Tensor
    max_length: int
    num_rows: int
    num_cols: int
    has_values = True

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    def row_hits(self, rows: torch.Tensor):
        """The sum of the deltas along each walk."""
        qi, nodes, _ = self._walk(rows)
        owner, flat = expand_ranges(
            torch.searchsorted(self.rows, nodes, side="left"),
            torch.searchsorted(self.rows, nodes, side="right"))
        return fold_hits(self.num_cols, qi[owner],
                         self.cols[flat].to(torch.int64), self.vals[flat])

    def to_npz_dict(self) -> dict:
        return _npz_walk({"ird_rows": self.rows.cpu().numpy(),
                          "ird_cols": self.cols.cpu().numpy(),
                          "ird_vals": self.vals.cpu().numpy(),
                          "ird_shape": np.array([self.num_rows,
                                                 self.num_cols])},
                         "ird_", self.anchor, self.succ, self.max_length)

    @staticmethod
    def from_npz_dict(d, device) -> "IntRowDiff":
        shape = d["ird_shape"]
        return IntRowDiff(
            rows=host_tensor(d["ird_rows"], device).to(torch.int64),
            cols=host_tensor(d["ird_cols"], device).to(torch.int32),
            vals=host_tensor(d["ird_vals"], device).to(torch.int64),
            num_rows=int(shape[0]), num_cols=int(shape[1]),
            **_walk_from_npz(d, "ird_", device))


@dataclass
class RowDiffBrwt(_Walked):
    """RowDiff whose diffs are a Multi-BRWT (the reference's RowDiffBRWT
    annotator): the XOR walk over BRWT rows."""
    diffs: "object"              # Brwt
    anchor: torch.Tensor
    succ: torch.Tensor
    max_length: int
    has_values = False

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
        q, c, _ = self.diffs.row_hits(torch.clamp(nodes, 0,
                                                  self.num_rows - 1))
        return fold_hits(self.num_cols, qi[q], c)

    def to_npz_dict(self) -> dict:
        return _npz_walk(self.diffs.to_npz_dict(), "rdb_", self.anchor,
                         self.succ, self.max_length)

    @staticmethod
    def from_npz_dict(d, device) -> "RowDiffBrwt":
        from .brwt import Brwt
        return RowDiffBrwt(diffs=Brwt.from_npz_dict(d, device),
                           **_walk_from_npz(d, "rdb_", device))
