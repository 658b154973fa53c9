"""AnnotatedDbg: graph + annotation, the label-query engine.

PyTorch counterpart of ``metagraph_tpu/engine/annotated_dbg.py`` for the
batched query path. A read batch is concatenated with one INVALID byte
between reads, every window is mapped to a node in one device pass, and
per-(read, label) k-mer counts come from one interval expand + one
``index_add_`` over ``read_id * num_labels + label`` keys. Selection
semantics are the reference's:

  * anno row = node - 1 (``graph.node_to_anno_row``: on a primary graph
    behind ``CanonicalDbg`` both orientations share the base node's row);
  * min_count = max(1, ceil(presence_ratio * num_windows));
  * get_labels: labels with count >= min_count, in label-code order;
  * get_top_labels: the same set with counts, sorted by (count desc,
    code asc) and truncated only past ``num_top_labels``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..anno.annotator import Annotation, ColumnAnnotator
from ..anno.matrix import RowSparse, _expand_intervals
from ..graph.dbg_succinct import DbgSuccinct
from ..kmer.alphabets import INVALID_CODE
from ..kmer.extractor import encode_sequences


@dataclass
class AnnotatedDbg:
    graph: DbgSuccinct
    annotation: Annotation


class BatchQuery:
    """Batched query executor: a whole read batch is mapped and
    aggregated in a few device calls."""

    def __init__(self, adbg: AnnotatedDbg):
        if not isinstance(adbg.annotation.matrix, RowSparse):
            raise NotImplementedError(
                "queries over compressed annotations are not yet ported")
        self.adbg = adbg
        # host copy of the row index for the exact expand size
        self._rows_np = adbg.annotation.matrix.rows.cpu().numpy()

    def _map_batch(self, seqs: Sequence[bytes]):
        """Returns (rows (W,) int64 anno rows, -1 = absent; read_id (W,);
        windows per read (R,))."""
        g = self.adbg.graph
        k = g.k
        codes_np = encode_sequences(seqs, g.alphabet)
        if len(codes_np) < k:
            codes_np = np.concatenate(
                [codes_np, np.full(k - len(codes_np), INVALID_CODE,
                                   np.uint8)])
        nodes = g.map_codes_to_nodes(
            torch.from_numpy(codes_np).to(g.device)).cpu().numpy()
        rows_all = np.where(nodes > 0, g.node_to_anno_row(nodes), -1)
        # window w belongs to read r iff it lies fully inside r's span;
        # reads are one separator byte apart
        rows, read_ids, wpr = [], [], []
        off = 0
        for r, s in enumerate(seqs):
            nw = max(0, len(s) - k + 1)
            rows.append(rows_all[off:off + nw])
            read_ids.append(np.full(nw, r, np.int64))
            wpr.append(nw)
            off += len(s) + 1
        return (np.concatenate(rows) if rows else np.zeros(0, np.int64),
                np.concatenate(read_ids) if read_ids
                else np.zeros(0, np.int64),
                np.array(wpr, np.int64))

    def label_count_matrix(self, seqs: Sequence[bytes]
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """((R, num_labels) per-read label k-mer counts, (R,) windows
        per read, (R,) present windows per read)."""
        m = self.adbg.annotation.matrix
        rows, read_ids, wpr = self._map_batch(seqs)
        present = rows >= 0
        n_present = np.zeros(len(seqs), np.int64)
        np.add.at(n_present, read_ids[present], 1)
        pr = rows[present].astype(np.int32)
        rid = read_ids[present].astype(np.int32)
        lo = np.searchsorted(self._rows_np, pr, side="left")
        hi = np.searchsorted(self._rows_np, pr, side="right")
        dev = m.rows.device
        counts = _batch_sum_rows(m, torch.from_numpy(pr).to(dev),
                                 torch.from_numpy(rid).to(dev), len(seqs),
                                 int((hi - lo).sum()))
        return counts.cpu().numpy().astype(np.int64), wpr, n_present

    def _selected(self, seqs, presence_ratio):
        """Per read: None if it reports nothing, else (counts row,
        min_count)."""
        counts, wpr, n_present = self.label_count_matrix(seqs)
        out = []
        for r, s in enumerate(seqs):
            min_count = max(1, math.ceil(presence_ratio * wpr[r]))
            if len(s) < self.adbg.graph.k or n_present[r] < min_count:
                out.append(None)
            else:
                out.append((counts[r], min_count))
        return out

    def get_labels_batch(self, seqs: Sequence[bytes],
                         presence_ratio: float = 0.0) -> List[List[str]]:
        enc = self.adbg.annotation.encoder
        return [[] if sel is None else
                [enc.decode(c) for c in np.nonzero(sel[0] >= sel[1])[0]]
                for sel in self._selected(seqs, presence_ratio)]

    def get_top_labels_batch(self, seqs: Sequence[bytes],
                             num_top_labels: int = 2 ** 62,
                             presence_ratio: float = 0.0,
                             with_kmer_counts: bool = False
                             ) -> List[List[Tuple[str, int]]]:
        if with_kmer_counts:
            raise NotImplementedError(
                "--query-counts / --count-kmers queries are not yet ported")
        enc = self.adbg.annotation.encoder
        out = []
        for sel in self._selected(seqs, presence_ratio):
            if sel is None:
                out.append([])
                continue
            counts, min_count = sel
            pairs = [(int(c), int(counts[c]))
                     for c in np.nonzero(counts >= min_count)[0]]
            if len(pairs) > num_top_labels:
                pairs.sort(key=lambda p: (-p[1], p[0]))
                pairs = pairs[:num_top_labels]
            out.append([(enc.decode(c), n) for c, n in pairs])
        return out


def _batch_sum_rows(m: RowSparse, rows: torch.Tensor,
                    read_ids: torch.Tensor, num_reads: int,
                    cap: int) -> torch.Tensor:
    """(R, C) counts: interval-expand the matrix hits of each row, keyed
    by read, summed with one ``index_add_`` (the segment sum)."""
    out = torch.zeros((num_reads * m.num_cols,), dtype=torch.int64,
                      device=rows.device)
    if rows.shape[0] and cap:
        lo, hi = m.row_ranges(rows)
        q, flat, valid = _expand_intervals(lo, hi, cap)
        col = m.cols[torch.clamp(flat, 0, max(m.nnz - 1, 0))].to(torch.int64)
        key = read_ids.to(torch.int64)[q] * m.num_cols + col
        out.index_add_(0, key, valid.to(torch.int64))
    return out.view(num_reads, m.num_cols)


def annotate_sequences(graph: DbgSuccinct,
                       items: Sequence[Tuple[bytes, Sequence[str]]],
                       annotator: Optional[ColumnAnnotator] = None,
                       with_counts: bool = False) -> ColumnAnnotator:
    """Build a column annotation from (sequence, labels) pairs: map each
    sequence's windows to nodes and set its labels on every present row.
    ``graph`` is a ``DbgSuccinct`` or a ``CanonicalDbg``."""
    if annotator is None:
        annotator = ColumnAnnotator(num_rows=graph.num_anno_rows(),
                                    device=graph.device)
    for seq, labels in items:
        nodes = graph.map_to_nodes(seq)
        rows = graph.node_to_anno_row(nodes[nodes > 0])
        if with_counts:
            uniq, cnt = np.unique(rows, return_counts=True)
            for label in labels:
                annotator.add(uniq, label, values=cnt)
        else:
            rows = np.unique(rows)
            for label in labels:
                annotator.add(rows, label)
    return annotator
