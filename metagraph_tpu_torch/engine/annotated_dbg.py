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
    code asc) and truncated only past ``num_top_labels``; with k-mer
    counts (``--query-counts``) the count is the sum of the annotation's
    values, the selection still by presence;
  * signatures (``--print-signature``): per label its k-mer presence
    mask, scored by ``score_kmer_presence_mask``;
  * count quantiles (``--count-quantiles``): per label, quantile q of the
    zero-padded sorted values is entry floor((num_windows - 1) * q).

The unique rows of a batch are gathered on the device (``presence`` /
``values_dense``); the per-read selection and formatting run on the
host, in the JAX package's order of operations.
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

    @property
    def num_labels(self) -> int:
        return self.annotation.num_labels

    def score_kmer_presence_mask(self, mask: np.ndarray,
                                 match_score: int = 1,
                                 mismatch_score: int = 2) -> int:
        """Alignment-free score of a k-mer presence mask (the reference
        AnnotatedDBG::score_kmer_presence_mask): AND the mask over windows
        of 3, run-length encode with +1 on every run but the last, sum
        the one-runs, charge the zero-runs the BIGSI SNP penalty, and
        scale by sequence length / mask length. float64 arithmetic, in
        the reference's order, truncated by ``int``."""
        mask = np.asarray(mask, bool)
        n = mask.size
        if n == 0:
            return 0
        k = self.graph.k
        kmer_adjust = 3
        seq_len = n + k - 1
        snp_t = float(k + kmer_adjust)
        # autocorrelate: out[i] = AND of mask[i..i+2], bits past the end
        # counting as set
        ac = mask.copy()
        for j in range(1, kmer_adjust):
            ac &= np.concatenate([mask[j:], np.ones(j, bool)])
        change = np.nonzero(ac[1:] != ac[:-1])[0]
        bounds = np.concatenate([[0], change + 1, [n]])
        lens = np.diff(bounds).astype(np.int64)
        vals = ac[bounds[:-1]]
        lens[:-1] += 1
        ones = lens[vals]
        zeros = lens[~vals]
        score = float(int(ones.sum()) * match_score)
        if score == 0:
            return 0
        if len(zeros) == 0:
            return int(score * seq_len / n)
        c = zeros.astype(np.float64)
        min_n = c / snp_t
        max_n = np.maximum(c - snp_t + 1, min_n)
        mean_n = max_n * 0.05 + min_n
        mean_penalty = mean_n * mismatch_score
        score += float(((c - mean_penalty) * match_score
                        - mean_penalty).sum())
        return int(max(score * seq_len / n, 0.0))


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
        if (getattr(g, "boss", None) is not None
                and g.boss.edge_lanes is None):
            # small state: the incremental walk (O(1) rank/select calls per
            # window) in place of the flat k-step search per window
            per = g.map_read_batch(list(seqs))
            return (np.concatenate([np.where(nodes > 0,
                                             g.node_to_anno_row(nodes), -1)
                                    for nodes in per]
                                   + [np.zeros(0, np.int64)]),
                    np.concatenate([np.full(len(nodes), r, np.int64)
                                    for r, nodes in enumerate(per)]
                                   + [np.zeros(0, np.int64)]),
                    np.array([len(nodes) for nodes in per], np.int64))
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

    def _present(self, seqs: Sequence[bytes]):
        """_map_batch plus (present mask (W,), present windows per read)."""
        rows, read_ids, wpr = self._map_batch(seqs)
        present = rows >= 0
        n_present = np.zeros(len(seqs), np.int64)
        np.add.at(n_present, read_ids[present], 1)
        return rows, read_ids, wpr, present, n_present

    def _sum_present(self, rows, read_ids, present, num_reads: int,
                     weights=None) -> np.ndarray:
        """(R, C) per-read sums over the present windows' matrix entries
        (``weights`` per entry; None counts each entry once)."""
        m = self.adbg.annotation.matrix
        pr = rows[present].astype(np.int32)
        rid = read_ids[present].astype(np.int32)
        lo = np.searchsorted(self._rows_np, pr, side="left")
        hi = np.searchsorted(self._rows_np, pr, side="right")
        dev = m.rows.device
        counts = _batch_sum_rows(m, torch.from_numpy(pr).to(dev),
                                 torch.from_numpy(rid).to(dev), num_reads,
                                 int((hi - lo).sum()), weights)
        return counts.cpu().numpy().astype(np.int64)

    def _unique_rows(self, rows, present):
        """The present windows' unique rows as a device tensor (None when
        no window is present) and each present window's index into it."""
        pr = rows[present]
        if not len(pr):
            return None, np.zeros(0, np.int64)
        uniq, inv = np.unique(pr, return_inverse=True)
        dev = self.adbg.annotation.matrix.rows.device
        return torch.from_numpy(uniq).to(dev), inv

    def label_count_matrix(self, seqs: Sequence[bytes]
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """((R, num_labels) per-read label k-mer counts, (R,) windows
        per read, (R,) present windows per read)."""
        rows, read_ids, wpr, present, n_present = self._present(seqs)
        counts = self._sum_present(rows, read_ids, present, len(seqs))
        return counts, wpr, n_present

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
            return self._top_labels_batch_values(seqs, num_top_labels,
                                                 presence_ratio)
        enc = self.adbg.annotation.encoder
        out = []
        for sel in self._selected(seqs, presence_ratio):
            if sel is None:
                out.append([])
                continue
            counts, min_count = sel
            out.append(_top_pairs(enc, counts, counts, min_count,
                                  num_top_labels))
        return out

    def _top_labels_batch_values(self, seqs, num_top_labels,
                                 presence_ratio):
        """--query-counts: per read and label the sum of the values over
        the present windows, selected by the presence counts. Without
        values the presence counts stand in for them."""
        m = self.adbg.annotation.matrix
        enc = self.adbg.annotation.encoder
        rows, read_ids, wpr, present, n_present = self._present(seqs)
        R = len(seqs)
        if m.values is None:
            vals_sum = bin_sum = self._sum_present(rows, read_ids, present, R)
        else:
            vals_sum = self._sum_present(rows, read_ids, present, R,
                                         m.values)
            bin_sum = self._sum_present(rows, read_ids, present, R,
                                        m.values > 0)
        out = []
        for r, s in enumerate(seqs):
            min_count = max(1, math.ceil(presence_ratio * wpr[r]))
            if len(s) < self.adbg.graph.k or n_present[r] < min_count:
                out.append([])
                continue
            out.append(_top_pairs(enc, bin_sum[r], vals_sum[r], min_count,
                                  num_top_labels))
        return out

    def get_top_label_signatures_batch(self, seqs: Sequence[bytes],
                                       num_top_labels: int = 2 ** 62,
                                       presence_ratio: float = 0.0
                                       ) -> List[List[Tuple[str, np.ndarray]]]:
        """--print-signature: per read, (label, k-mer presence mask) of
        the labels present in at least min_count windows, by (count
        desc, code asc)."""
        m = self.adbg.annotation.matrix
        C = self.adbg.num_labels
        enc = self.adbg.annotation.encoder
        rows, _, wpr = self._map_batch(seqs)
        present = rows >= 0
        uniq_t, inv = self._unique_rows(rows, present)
        pres = (m.presence(uniq_t).cpu().numpy() if uniq_t is not None
                else np.zeros((0, C), bool))
        sig_all = np.zeros((len(rows), C), bool)
        sig_all[np.nonzero(present)[0]] = pres[inv]
        bounds = np.concatenate([[0], np.cumsum(wpr)])
        out = []
        for r, s in enumerate(seqs):
            if len(s) < self.adbg.graph.k:
                out.append([])
                continue
            sig = sig_all[bounds[r]:bounds[r + 1]]
            min_count = max(1, math.ceil(presence_ratio * wpr[r]))
            counts = sig.sum(axis=0)
            codes = np.nonzero(counts >= min_count)[0]
            pairs = sorted(((int(c), int(counts[c])) for c in codes),
                           key=lambda p: (-p[1], p[0]))[:num_top_labels]
            out.append([(enc.decode(c), sig[:, c]) for c, _ in pairs])
        return out

    def get_label_count_quantiles_batch(self, seqs: Sequence[bytes],
                                        num_top_labels: int = 2 ** 62,
                                        presence_ratio: float = 0.0,
                                        count_quantiles: Sequence[float] = ()
                                        ) -> List[List[Tuple[str, List[int]]]]:
        """--count-quantiles: per read and label present in at least
        min_count windows, the quantiles of its values over the read's
        windows, zeros (absent windows) first; labels by (windows desc,
        code asc). Without values each present window counts 1."""
        m = self.adbg.annotation.matrix
        C = self.adbg.num_labels
        enc = self.adbg.annotation.encoder
        rows, read_ids, wpr, present, n_present = self._present(seqs)
        rid = read_ids[present]
        uniq_t, inv = self._unique_rows(rows, present)
        if uniq_t is None:
            wv = np.zeros((0, C), np.int64)
        else:
            dense = (m.values_dense(uniq_t) if m.values is not None
                     else m.presence(uniq_t))
            wv = dense.cpu().numpy().astype(np.int64)[inv]
        # (read, label, value) records of every present window, grouped
        # by (read, label) with the values ascending
        wq, wc = np.nonzero(wv)
        owner = rid[wq]
        vals = wv[wq, wc]
        order = np.lexsort((vals, wc, owner))
        owner, wc, vals = owner[order], wc[order], vals[order]
        key = owner * (C + 1) + wc
        starts = (np.concatenate(
            [[0], np.nonzero(key[1:] != key[:-1])[0] + 1, [len(key)]])
            if len(key) else np.array([0]))
        per_read = [[] for _ in seqs]
        for s_, e_ in zip(starts[:-1], starts[1:]):
            per_read[int(owner[s_])].append((int(wc[s_]), vals[s_:e_]))
        out = []
        for r, s in enumerate(seqs):
            min_count = max(1, math.ceil(presence_ratio * wpr[r]))
            if len(s) < self.adbg.graph.k or n_present[r] < min_count:
                out.append([])
                continue
            q_low = [int((wpr[r] - 1) * q) for q in count_quantiles]
            groups = [(c, v) for c, v in per_read[r] if len(v) >= min_count]
            groups.sort(key=lambda p: (-len(p[1]), p[0]))
            res = []
            for c, v in groups[:num_top_labels]:
                num_zeros = wpr[r] - len(v)
                res.append((enc.decode(c),
                            [0 if ql < num_zeros else int(v[ql - num_zeros])
                             for ql in q_low]))
            out.append(res)
        return out


def _top_pairs(enc, select_counts, counts, min_count: int,
               num_top_labels: int) -> List[Tuple[str, int]]:
    """The labels with ``select_counts >= min_count`` and their
    ``counts``, in code order, or by (count desc, code asc) when more
    than ``num_top_labels`` survive and only those are kept."""
    pairs = [(int(c), int(counts[c]))
             for c in np.nonzero(select_counts >= min_count)[0]]
    if len(pairs) > num_top_labels:
        pairs.sort(key=lambda p: (-p[1], p[0]))
        pairs = pairs[:num_top_labels]
    return [(enc.decode(c), n) for c, n in pairs]


def _batch_sum_rows(m: RowSparse, rows: torch.Tensor,
                    read_ids: torch.Tensor, num_reads: int,
                    cap: int, weights: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """(R, C) sums: interval-expand the matrix hits of each row, keyed by
    read, summed with one ``index_add_`` (the segment sum). Each hit adds
    its entry's ``weights`` value, or 1 without ``weights``."""
    out = torch.zeros((num_reads * m.num_cols,), dtype=torch.int64,
                      device=rows.device)
    if rows.shape[0] and cap:
        lo, hi = m.row_ranges(rows)
        q, flat, valid = _expand_intervals(lo, hi, cap)
        fc = torch.clamp(flat, 0, max(m.nnz - 1, 0))
        key = read_ids.to(torch.int64)[q] * m.num_cols + m.cols[fc].long()
        w = (valid.to(torch.int64) if weights is None
             else torch.where(valid, weights[fc].to(torch.int64), 0))
        out.index_add_(0, key, w)
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
