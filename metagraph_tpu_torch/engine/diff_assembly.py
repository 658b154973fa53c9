"""Differential assembly: label-based node masks.

PyTorch counterpart of ``metagraph_tpu/engine/diff_assembly.py``
(reference annotated_graph_algorithm.hpp:28-74): a node mask keeps the
unitigs (or nodes) whose annotation matches a foreground / background
label contrast, then the masked graph is assembled. The in / out /
other label counts per node or unitig are bincounts over the
annotation's (row, col) pairs on the device: those of its logical
matrix, whatever its representation (the JAX package reads the
``rows`` / ``cols`` fields of the column form, and fails on, or for
IntRowDiff misreads, the others: a fault of the reference, repaired).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..graph.masked import MaskedDbg
from ..graph.traversal import unitig_decomposition
from .annotated_dbg import AnnotatedDbg


def _label_groups(m, codes_in, codes_out, cols: torch.Tensor) -> torch.Tensor:
    """Group of each column index: 0 other, 1 in, 2 out (out wins)."""
    group = torch.zeros((m.num_cols,), dtype=torch.int64, device=cols.device)
    group[list(codes_in)] = 1
    group[list(codes_out)] = 2
    return group[cols]


def _codes(adbg: AnnotatedDbg, labels_in, labels_out):
    """Codes of the in-labels (all must exist) and of the out-labels
    that do."""
    enc = adbg.annotation.encoder
    return ([enc.encode(label) for label in labels_in],
            [enc.encode(label) for label in labels_out if label in enc])


def _per_node_group_counts(adbg: AnnotatedDbg, codes_in, codes_out):
    """(N+1,) counts of in / out / other labels per node (one pass over
    the matrix)."""
    m = adbg.annotation.matrix.to_row_sparse()
    N = adbg.graph.num_nodes()
    grp = _label_groups(m, codes_in, codes_out, m.cols.to(torch.int64))
    node = m.rows.to(torch.int64) + 1
    return tuple(torch.bincount(node[grp == j], minlength=N + 1)
                 for j in (1, 2, 0))


def mask_nodes_by_node_label(adbg: AnnotatedDbg,
                             labels_in: Sequence[str],
                             labels_out: Sequence[str],
                             label_mask_in_fraction: float = 1.0,
                             label_mask_out_fraction: float = 0.0
                             ) -> torch.Tensor:
    """(N+1,) keep mask: the node has >= in_fraction of the in-labels and
    <= out_fraction of the out-labels."""
    codes_in, codes_out = _codes(adbg, labels_in, labels_out)
    n_in, n_out, _ = _per_node_group_counts(adbg, codes_in, codes_out)
    keep = (n_in.double() >= label_mask_in_fraction * max(len(codes_in), 1)) \
        & (n_out.double() <= label_mask_out_fraction
           * max(len(codes_out), 1))
    keep[0] = False
    return keep


def mask_nodes_by_unitig_labels(adbg: AnnotatedDbg,
                                labels_in: Sequence[str],
                                labels_out: Sequence[str],
                                label_mask_in_fraction: float = 1.0,
                                label_mask_out_fraction: float = 0.0,
                                label_other_fraction: float = 1.0
                                ) -> torch.Tensor:
    """(N+1,) keep mask at unitig granularity: a unitig is kept when,
    over the union of the labels on its nodes, >= in_fraction of the
    in-labels are present, <= out_fraction of the out-labels are, and
    the other labels make <= other_fraction of those seen."""
    codes_in, codes_out = _codes(adbg, labels_in, labels_out)
    u = unitig_decomposition(adbg.graph)
    m = adbg.annotation.matrix.to_row_sparse()
    cols = m.cols.to(torch.int64)
    cid = u.chain_id[m.rows.to(torch.int64) + 1]
    # distinct (unitig, label) pairs
    pair = torch.unique(cid * m.num_cols + cols)
    grp = _label_groups(m, codes_in, codes_out, pair % m.num_cols)
    ucid = pair // m.num_cols
    nU = u.num_unitigs
    in_cnt, out_cnt, other_cnt = (
        torch.bincount(ucid[grp == j], minlength=nU).double()
        for j in (1, 2, 0))
    total = in_cnt + out_cnt + other_cnt
    keep_u = (in_cnt >= label_mask_in_fraction * max(len(codes_in), 1)) \
        & (out_cnt <= label_mask_out_fraction * max(len(codes_out), 1)) \
        & (other_cnt <= label_other_fraction * torch.clamp(total, min=1))
    keep = keep_u[u.chain_id]
    keep[0] = False
    return keep


def differential_assembly(adbg: AnnotatedDbg,
                          labels_in: Sequence[str],
                          labels_out: Sequence[str],
                          unitig_mode: bool = True,
                          **fractions) -> MaskedDbg:
    mask = (mask_nodes_by_unitig_labels if unitig_mode
            else mask_nodes_by_node_label)(adbg, labels_in, labels_out,
                                           **fractions)
    return MaskedDbg(base=adbg.graph, mask=mask)
