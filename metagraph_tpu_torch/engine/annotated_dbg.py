"""AnnotatedDbg: graph + annotation, the label-query engine.

PyTorch counterpart of ``metagraph_tpu/engine/annotated_dbg.py``. A read
batch is concatenated with one INVALID byte between reads, every window
is mapped to a node in one device pass, and
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
    zero-padded sorted values is entry floor((num_windows - 1) * q);
  * coordinates (``--query-coords``): per selected label, each window's
    coordinates (a coordinate annotation).

The annotation may be any representation of ``anno/``: each gives the
sparse entries of the present windows' rows (``row_hits``, the anchor
walks and BRWT descents included), decoded a bounded number of windows
at a time, and those are summed per read on the device. The label and
top-label queries also select on the device: each read's counts are
compared with its min_count there, and only the (read, label) pairs that
pass come to the host, where the label lists are sliced from them by
per-read offsets. The other modes copy the whole (reads x labels)
matrix and select per read on the host, in the JAX package's order of
operations. ``AnnotatedDbg``'s per-sequence calls (``get_labels``,
``get_top_labels``, ``get_top_label_signatures``,
``get_label_count_quantiles``, ``get_kmer_coordinates``) are one-read
batches.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..anno.annotator import Annotation, ColumnAnnotator
from ..common import telemetry
from ..graph.dbg_succinct import DbgSuccinct, map_sequences

# present windows per row_hits call: bounds a batch's temporaries (its
# entries, anchor walks and descents) whatever the batch's size
_CHUNK = 1 << 20

# (read, label) pairs the device selection brought to the host since
# import (``BatchQuery._selected``): the labels of the label queries'
# answers before any top-labels cut
select_pairs = 0


@dataclass
class AnnotatedDbg:
    graph: DbgSuccinct
    annotation: Annotation

    @property
    def num_labels(self) -> int:
        return self.annotation.num_labels

    # -- one sequence: a one-read batch (the reference AnnotatedDBG's
    # per-sequence calls; ``sequence`` is bytes or str) --------------------

    def get_labels(self, sequence: bytes | str,
                   presence_ratio: float = 0.0) -> List[str]:
        """The labels in at least min_count of the sequence's windows, in
        label-code order."""
        return BatchQuery(self).get_labels_batch(
            _one(sequence), presence_ratio)[0]

    def get_top_labels(self, sequence: bytes | str,
                       num_top_labels: int = 2 ** 62,
                       presence_ratio: float = 0.0,
                       with_kmer_counts: bool = False
                       ) -> List[Tuple[str, int]]:
        """(label, count) of the labels in at least min_count windows;
        with ``with_kmer_counts`` the count is the sum of the
        annotation's values. That needs a count annotation: on a binary
        one a sequence that reports labels raises ValueError, where the
        JAX package fails too."""
        bq = BatchQuery(self)
        if with_kmer_counts and not self.annotation.matrix.has_values:
            if bq._selected(_one(sequence), presence_ratio).passes[0]:
                raise ValueError("with_kmer_counts needs a count "
                                 "annotation (annotate --count-kmers)")
            return []
        return bq.get_top_labels_batch(
            _one(sequence), num_top_labels, presence_ratio,
            with_kmer_counts)[0]

    def get_top_label_signatures(self, sequence: bytes | str,
                                 num_top_labels: int = 2 ** 62,
                                 presence_ratio: float = 0.0
                                 ) -> List[Tuple[str, np.ndarray]]:
        """(label, bool k-mer presence mask over the windows) of the
        labels in at least min_count windows, by (count desc, code
        asc)."""
        return BatchQuery(self).get_top_label_signatures_batch(
            _one(sequence), num_top_labels, presence_ratio)[0]

    def get_label_count_quantiles(self, sequence: bytes | str,
                                  num_top_labels: int = 2 ** 62,
                                  presence_ratio: float = 0.0,
                                  count_quantiles: Sequence[float] = ()
                                  ) -> List[Tuple[str, List[int]]]:
        """(label, its values' quantiles over the windows, zeros first)
        of the labels in at least min_count windows."""
        return BatchQuery(self).get_label_count_quantiles_batch(
            _one(sequence), num_top_labels, presence_ratio,
            count_quantiles)[0]

    def get_kmer_coordinates(self, sequence: bytes | str,
                             num_top_labels: int = 2 ** 62,
                             presence_ratio: float = 0.0
                             ) -> List[Tuple[str, List[List[int]]]]:
        """Per label, one coordinate list per k-mer window of one
        sequence (reference AnnotatedDBG::get_kmer_coordinates)."""
        return BatchQuery(self).get_kmer_coordinates_batch(
            _one(sequence), num_top_labels, presence_ratio)[0]

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
        self.adbg = adbg

    def _map_batch(self, seqs: Sequence[bytes]):
        """Returns (rows (W,) int64 anno rows, -1 = absent; read_id (W,);
        windows per read (R,))."""
        g = self.adbg.graph
        with telemetry.span("map", quiet=True):
            if (getattr(g, "boss", None) is not None
                    and g.boss.edge_lanes is None):
                # small state: the incremental walk (O(1) rank/select calls
                # per window) in place of the flat k-step search per window
                per = g.map_read_batch(list(seqs))
            else:
                per = map_sequences(g, seqs)
            wpr = np.array([len(nodes) for nodes in per], np.int64)
            nodes = np.concatenate(per + [np.zeros(0, np.int64)])
            return (np.where(nodes > 0, g.node_to_anno_row(nodes), -1),
                    np.repeat(np.arange(len(per), dtype=np.int64), wpr), wpr)

    def _window_hits(self, rows, present):
        """(index into the present windows, column, value) int64 device
        tensors of every entry of the present windows' rows (value 1 in a
        binary matrix), one ``row_hits`` call per _CHUNK windows."""
        m = self.adbg.annotation.matrix
        pr = torch.from_numpy(rows[present]).to(m.device)
        for s in range(0, pr.shape[0], _CHUNK):
            q, c, v = m.row_hits(pr[s:s + _CHUNK])
            yield q + s, c, v

    def _read_sums(self, rows, read_ids, present, num_reads: int,
                   *weights) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The present windows per read (R,), and per weight (a function
        of the entries' values) the (R, C) per-read sums of it over the
        present windows' entries: int64 tensors on the matrix's device,
        one ``index_add_`` per chunk keyed by read and label."""
        m = self.adbg.annotation.matrix
        C = m.num_cols
        with telemetry.span("sums", quiet=True):
            rid = torch.from_numpy(read_ids[present]).to(m.device)
            n_present = torch.zeros(num_reads, dtype=torch.int64,
                                    device=m.device)
            n_present.index_add_(0, rid, torch.ones_like(rid))
            outs = [torch.zeros((num_reads * C,), dtype=torch.int64,
                                device=m.device) for _ in weights]
            for w, c, v in self._window_hits(rows, present):
                key = rid[w] * C + c
                for out, weight in zip(outs, weights):
                    out.index_add_(0, key, weight(v))
            return n_present, [out.view(num_reads, C) for out in outs]

    def label_count_matrix(self, seqs: Sequence[bytes]
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """((R, num_labels) per-read label k-mer counts, (R,) windows
        per read, (R,) present windows per read)."""
        rows, read_ids, wpr = self._map_batch(seqs)
        n_present, (counts,) = self._read_sums(
            rows, read_ids, rows >= 0, len(seqs), torch.ones_like)
        return counts.cpu().numpy(), wpr, n_present.cpu().numpy()

    def _selected(self, seqs, presence_ratio) -> _Selection:
        """The (read, label) pairs with count >= the read's min_count,
        selected on the device; only they come to the host. A read
        shorter than k has no windows, so none present: it never
        passes."""
        global select_pairs
        rows, read_ids, wpr = self._map_batch(seqs)
        n_present, (counts,) = self._read_sums(
            rows, read_ids, rows >= 0, len(seqs), torch.ones_like)
        with telemetry.span("select", quiet=True):
            # float64, the same product as math.ceil(ratio * wpr[r])
            min_count = torch.from_numpy(np.maximum(
                1, np.ceil(presence_ratio * wpr)).astype(np.int64)).to(
                    counts.device)
            passes = n_present >= min_count
            hit = (counts >= min_count[:, None]) & passes[:, None]
            r, c = hit.nonzero().unbind(1)      # by read, then label code
            n = r.shape[0]
            flat = torch.cat([r, c, counts[r, c],
                              passes.to(torch.int64)]).cpu().numpy()
            select_pairs += n
            return _Selection(
                offsets=np.searchsorted(flat[:n],
                                        np.arange(len(seqs) + 1)).tolist(),
                codes=flat[n:2 * n], counts=flat[2 * n:3 * n],
                passes=flat[3 * n:] > 0)

    def get_labels_batch(self, seqs: Sequence[bytes],
                         presence_ratio: float = 0.0) -> List[List[str]]:
        labels = self.adbg.annotation.encoder.labels
        with telemetry.span("query", quiet=True):
            sel = self._selected(seqs, presence_ratio)
            with telemetry.span("select", quiet=True):
                names = [labels[c] for c in sel.codes.tolist()]
                o = sel.offsets
                return [names[o[r]:o[r + 1]] for r in range(len(seqs))]

    def get_top_labels_batch(self, seqs: Sequence[bytes],
                             num_top_labels: int = 2 ** 62,
                             presence_ratio: float = 0.0,
                             with_kmer_counts: bool = False
                             ) -> List[List[Tuple[str, int]]]:
        if with_kmer_counts:
            return self._top_labels_batch_values(seqs, num_top_labels,
                                                 presence_ratio)
        labels = self.adbg.annotation.encoder.labels
        sel = self._selected(seqs, presence_ratio)
        o = sel.offsets
        return [_top_pairs(labels, sel.codes[o[r]:o[r + 1]],
                           sel.counts[o[r]:o[r + 1]], num_top_labels)
                for r in range(len(seqs))]

    def _top_labels_batch_values(self, seqs, num_top_labels,
                                 presence_ratio):
        """--query-counts: per read and label the sum of the values over
        the present windows, selected by the presence counts. Without
        values the presence counts stand in for them."""
        labels = self.adbg.annotation.encoder.labels
        rows, read_ids, wpr = self._map_batch(seqs)
        n_present, (vals_sum, bin_sum) = self._read_sums(
            rows, read_ids, rows >= 0, len(seqs), lambda v: v,
            lambda v: (v > 0).to(torch.int64))
        n_present, vals_sum, bin_sum = (
            t.cpu().numpy() for t in (n_present, vals_sum, bin_sum))
        out = []
        for r, s in enumerate(seqs):
            min_count = max(1, math.ceil(presence_ratio * wpr[r]))
            if len(s) < self.adbg.graph.k or n_present[r] < min_count:
                out.append([])
                continue
            codes = np.nonzero(bin_sum[r] >= min_count)[0]
            out.append(_top_pairs(labels, codes, vals_sum[r][codes],
                                  num_top_labels))
        return out

    def get_top_label_signatures_batch(self, seqs: Sequence[bytes],
                                       num_top_labels: int = 2 ** 62,
                                       presence_ratio: float = 0.0
                                       ) -> List[List[Tuple[str, np.ndarray]]]:
        """--print-signature: per read, (label, k-mer presence mask) of
        the labels present in at least min_count windows, by (count
        desc, code asc)."""
        C = self.adbg.num_labels
        enc = self.adbg.annotation.encoder
        rows, _, wpr = self._map_batch(seqs)
        present = rows >= 0
        where = np.nonzero(present)[0]
        sig_all = np.zeros((len(rows), C), bool)
        for w, c, _ in self._window_hits(rows, present):
            sig_all[where[w.cpu().numpy()], c.cpu().numpy()] = True
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

    def get_kmer_coordinates_batch(self, seqs: Sequence[bytes],
                                   num_top_labels: int = 2 ** 62,
                                   presence_ratio: float = 0.0
                                   ) -> List[List[Tuple[str, List[List[int]]]]]:
        """--query-coords: per read and label present in at least
        min_count windows (by (count desc, code asc), the first
        ``num_top_labels``), one ascending coordinate list per window
        (empty where the window is absent or lacks the label). One
        batched fetch of the batch's unique rows (anchor walks included)
        serves every read and label."""
        m = self.adbg.annotation.matrix
        if not hasattr(m, "tuples_for_rows"):
            raise ValueError("coordinate queries need a coordinate "
                             "annotation (annotate --coordinates)")
        enc = self.adbg.annotation.encoder
        rows, read_ids, wpr = self._map_batch(seqs)
        present = rows >= 0
        n_present, (counts,) = self._read_sums(
            rows, read_ids, present, len(seqs), torch.ones_like)
        n_present, counts = n_present.cpu().numpy(), counts.cpu().numpy()
        rec = m.tuples_for_rows(rows[present])
        bounds = np.concatenate([[0], np.cumsum(wpr)])
        out = []
        for r, s in enumerate(seqs):
            min_count = max(1, math.ceil(presence_ratio * wpr[r]))
            if len(s) < self.adbg.graph.k or n_present[r] < min_count:
                out.append([])
                continue
            codes = np.nonzero(counts[r] >= min_count)[0]
            pairs = sorted(((int(c), int(counts[r][c])) for c in codes),
                           key=lambda p: (-p[1], p[0]))[:num_top_labels]
            rrows = rows[bounds[r]:bounds[r + 1]].tolist()
            out.append([(enc.decode(c),
                         [rec[q].get(c, np.zeros(0, np.int64)).tolist()
                          if q >= 0 else [] for q in rrows])
                        for c, _ in pairs])
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
        C = self.adbg.num_labels
        enc = self.adbg.annotation.encoder
        rows, read_ids, wpr = self._map_batch(seqs)
        present = rows >= 0
        n_present = np.bincount(read_ids[present], minlength=len(seqs))
        # (read, label, value) records of every present window's non-zero
        # entries, grouped by (read, label) with the values ascending
        hits = [tuple(x.cpu().numpy() for x in h)
                for h in self._window_hits(rows, present)]
        wq, wc, vals = (np.concatenate([h[i] for h in hits]
                                       + [np.zeros(0, np.int64)])
                        for i in range(3))
        nz = vals != 0
        owner, wc, vals = read_ids[present][wq[nz]], wc[nz], vals[nz]
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


def _one(sequence: bytes | str) -> List[bytes]:
    return [sequence.encode() if isinstance(sequence, str) else sequence]


def _top_pairs(labels, codes, counts,
               num_top_labels: int) -> List[Tuple[str, int]]:
    """(label, count) of a read's selected codes (ascending) and their
    counts, in code order, or by (count desc, code asc) when more than
    ``num_top_labels`` are selected and only those are kept."""
    pairs = list(zip(codes.tolist(), counts.tolist()))
    if len(pairs) > num_top_labels:
        pairs.sort(key=lambda p: (-p[1], p[0]))
        pairs = pairs[:num_top_labels]
    return [(labels[c], n) for c, n in pairs]


@dataclass
class _Selection:
    """A batch's selected (read, label) pairs, by read then label code:
    read r's are ``codes[offsets[r]:offsets[r + 1]]`` with their
    ``counts`` (the read's windows holding the label); ``passes[r]``:
    read r has at least min_count present windows."""
    offsets: List[int]
    codes: np.ndarray
    counts: np.ndarray
    passes: np.ndarray


def annotate_sequences(graph: DbgSuccinct,
                       items: Sequence[Tuple[bytes, Sequence[str]]],
                       annotator: Optional[ColumnAnnotator] = None,
                       with_counts: bool = False) -> ColumnAnnotator:
    """Build a column annotation from (sequence, labels) pairs: map each
    sequence's windows to nodes (all sequences in a few batched calls)
    and set its labels on every present row. ``graph`` is a
    ``DbgSuccinct`` or a ``CanonicalDbg``."""
    if annotator is None:
        annotator = ColumnAnnotator(num_rows=graph.num_anno_rows(),
                                    device=graph.device)
    for (_, labels), nodes in zip(items, map_sequences(
            graph, [seq for seq, _ in items])):
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
