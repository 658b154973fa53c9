"""Graph cleaning: abundance-threshold estimation and unreliable-unitig
filtering.

PyTorch counterpart of ``metagraph_tpu/graph/cleaning.py`` (reference
graph_cleaning.cpp:14-330). The threshold picker fits the gamma-Poisson
error model to the k-mer coverage histogram (McVean's method, as in
mccortex's clean_graph); the histogram is small, so the picker is a
host numpy copy of the JAX package's. The per-node weights, histogram
and masks are tensors on the graph's device.

``clean_graph`` is what the ``clean`` command runs before it writes
(reference cli/clean.cpp:28-200), inside the spans ``clean`` (root),
``clean.threshold``, ``clean.unitigs``, ``clean.keep`` and
``clean.contigs``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..common import telemetry
from .masked import MaskedDbg
from .traversal import (Walks, contig_walks, single_form_mask, spell_walks,
                        split_walks, unitig_decomposition, unitig_keep_mask,
                        unitig_walks)

# nodes kept by every ``clean_graph`` since import (the nodes of its
# contigs or unitigs)
kept_nodes = 0


def node_weights(g) -> torch.Tensor:
    """(N+1,) per-node k-mer count: the BOSS weights of the real edges,
    in node order (slot 0 = 0)."""
    if g.boss.weights is None:
        raise ValueError("graph built without --count-kmers")
    w = g.boss.weights[g.valid_rank.set_positions()]
    return torch.cat([torch.zeros((1,), dtype=w.dtype, device=w.device), w])


def node_weight_histogram(g) -> np.ndarray:
    """hist[c] = #nodes with k-mer count c (c >= 1), on the host."""
    hist = torch.bincount(node_weights(g)[1:].to(torch.int64), minlength=10)
    hist = hist.cpu().numpy().astype(np.uint64)
    hist[0] = 0
    return hist


def pick_kmer_threshold(hist: np.ndarray,
                        fdr: float = 0.001,
                        frac_covg_kept: float = 0.2) -> int:
    """Gamma-Poisson cleaning threshold; -1 when estimation fails
    (reference cleaning_pick_kmer_threshold, graph_cleaning.cpp:210-330)."""
    hist = np.asarray(hist, np.float64)
    if hist.shape[0] < 10:
        hist = np.concatenate([hist, np.zeros(10 - hist.shape[0])])
    n = hist.shape[0]
    if hist[1] == 0 or hist[2] == 0:
        return -1
    r1 = hist[2] / hist[1]
    r2 = hist[3] / hist[2] if hist[2] else 0.0
    rr = r2 / r1 if r1 else 0.0

    aa = np.arange(1, 201) * 0.01
    faa = (np.vectorize(math.gamma)(aa) * np.vectorize(math.gamma)(aa + 2)
           / (2 * np.vectorize(math.gamma)(aa + 1) ** 2))
    a_est = aa[np.argmin(np.abs(faa - rr))]
    b_est = math.gamma(a_est + 1.0) / (r1 * math.gamma(a_est)) - 1.0
    b_est = max(b_est, 1.0)
    c0 = hist[1] * (b_est / (1 + b_est)) ** (-a_est)

    i = np.arange(1, n, dtype=np.float64)
    log_e = (a_est * math.log(b_est) - math.lgamma(a_est)
             - np.vectorize(math.lgamma)(i)
             + np.vectorize(math.lgamma)(a_est + i - 1)
             - (a_est + i - 1) * math.log(1 + b_est))
    e_covg = np.concatenate([[0.0], np.exp(log_e) * c0])
    e_total = e_covg[1:].sum()
    d_total = hist[1:].sum()

    cutoff = -1
    # rule 1: first level where expected errors < fdr of observed coverage
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = e_covg[1:] / hist[1:]
    ok = np.nonzero(ratio <= fdr)[0]
    if ok.size:
        cutoff = int(ok[0] + 1)
    # rule 2: first cutoff with FP < FN (pick_cutoff_FP_lt_FN returns
    # the FIRST qualifying level, graph_cleaning.cpp:116-137)
    if cutoff < 0:
        e_sum = np.cumsum(e_covg[1:])
        d_sum = np.cumsum(hist[1:])
        e_rem = e_total - e_sum
        d_rem = d_total - d_sum
        with np.errstate(divide="ignore", invalid="ignore"):
            cond = (1 - e_sum / d_sum) > (e_rem / d_rem)
        ok = np.nonzero(cond)[0]
        if ok.size:
            cutoff = int(ok[0] + 1)
    # rule 3: lost real sequence exceeds remaining error
    if cutoff < 0:
        e_sum = np.cumsum(e_covg[1:])
        d_sum = np.cumsum(hist[1:])
        e_rem = e_total - e_sum
        cond = (d_sum - e_sum) > e_rem
        ok = np.nonzero(cond)[0]
        if ok.size:
            cutoff = int(ok[0] + 1)
    if cutoff < 0:
        return -1
    # keep >= 20% of coverage
    lv = np.arange(n, dtype=np.float64)
    below = (hist * lv)[:cutoff].sum()
    above = (hist * lv)[cutoff:].sum()
    if below + above > 0 and above / (below + above) < frac_covg_kept:
        return -1
    return cutoff


def estimate_min_kmer_abundance(g, num_singleton_kmers: int = 0) -> int:
    hist = node_weight_histogram(g)
    if num_singleton_kmers:
        hist[1] = num_singleton_kmers
    return pick_kmer_threshold(hist)


def is_unreliable_unitig(path_weights: np.ndarray,
                         min_median_abundance: int) -> bool:
    """Median-abundance test (graph_cleaning.cpp:14-31): unreliable when
    more than half the k-mers fall below the threshold."""
    if min_median_abundance <= 1:
        return False
    return int((np.asarray(path_weights) < min_median_abundance).sum()) * 2 \
        > len(path_weights)


def clean_node_mask(g, min_count: int = 1, max_count: Optional[int] = None,
                    prune_unitigs: int = 1, min_tip_size: int = 1,
                    node_w=None) -> torch.Tensor:
    """(N+1,) bool keep mask over nodes, as the reference's cli/clean.cpp:
    1) the node-level min / max-count mask (clean.cpp:101-113);
    2) the unitig decomposition of the masked graph, dropping unitigs
       that are short tips (sequence_graph.cpp:208-211) or whose k-mer
       majority lies below the median-abundance threshold
       (graph_cleaning.cpp:14-31)."""
    N = g.num_nodes()
    node_w = node_weights(g) if node_w is None else torch.as_tensor(
        node_w, device=g.device)
    base = g
    base_mask = torch.ones((N + 1,), dtype=torch.bool, device=g.device)
    base_mask[0] = False
    if min_count > 1 or max_count is not None:
        base_mask[1:] = node_w[1:] >= min_count
        if max_count is not None:
            base_mask[1:] &= node_w[1:] <= max_count
        base = MaskedDbg(base=g, mask=base_mask)
    if prune_unitigs <= 1 and min_tip_size <= 1:
        return base_mask
    with telemetry.span("clean.unitigs", quiet=True):
        u = unitig_decomposition(base)
    with telemetry.span("clean.keep", quiet=True):
        keep_u = unitig_keep_mask(base, u, min_tip_size, node_w,
                                  prune_unitigs)
        keep = keep_u[u.chain_id] & base_mask
        keep[0] = False
    return keep


class NoThreshold(Exception):
    """The abundance threshold could not be estimated and the fallback is
    disabled (``fallback`` < 0)."""


class Cleaned(NamedTuple):
    """What ``clean_graph`` keeps: the sequences (``Walks`` of bytes) and
    their node paths (``Walks`` of host int32 node ids), each path's k-mer
    counts (None on a graph without counts), the median-abundance
    threshold used (``threshold``; the estimate, -1 where it failed, or
    None where none was asked for: ``estimate``) and the number of nodes
    kept."""
    seqs: Walks
    paths: Walks
    counts: Optional[Walks]
    threshold: int
    estimate: Optional[int]
    kept: int


def clean_graph(g, min_count: int = 1, max_count: Optional[int] = None,
                prune_tips: int = 1, prune_unitigs: int = 1,
                fallback: int = 5, num_singletons: int = 0,
                unitigs: bool = False) -> Cleaned:
    """Clean ``g`` as the reference's cli/clean.cpp:28-200 does before
    it writes: ``prune_unitigs`` 0 estimates the median-abundance
    threshold (``fallback`` where that fails; ``NoThreshold`` where the
    fallback is negative), then the node min / max-count mask, tips
    shorter than ``prune_tips`` nodes and unreliable unitigs go
    (``clean_node_mask``); a canonical graph keeps each k-mer in one
    orientation (single form). Returns the contigs of the kept nodes,
    or, with ``unitigs`` on a graph that keeps every node, its unitigs,
    with their paths and counts."""
    global kept_nodes
    with telemetry.span("clean", quiet=True):
        with telemetry.span("clean.threshold", quiet=True):
            has_weights = g.boss.weights is not None
            node_w = node_weights(g) if has_weights else None
            estimate = None
            if prune_unitigs == 0:
                # the automatic threshold (clean.cpp:76-100)
                estimate = estimate_min_kmer_abundance(g, num_singletons)
                if estimate < 0 and fallback < 0:
                    raise NoThreshold()
                prune_unitigs = fallback if estimate < 0 else estimate
        filtered = (min_count > 1 or max_count is not None
                    or prune_unitigs > 1 or prune_tips > 1)
        mask = clean_node_mask(g, min_count=min_count, max_count=max_count,
                               prune_unitigs=prune_unitigs,
                               min_tip_size=prune_tips, node_w=node_w) \
            if filtered else None
        if g.mode == "canonical":
            with telemetry.span("clean.keep", quiet=True):
                sf = single_form_mask(g)
                mask = sf if mask is None else (mask & sf)
        with telemetry.span("clean.contigs", quiet=True):
            if mask is None:
                sub = g
                nodes, first = (unitig_walks(g) if unitigs
                                else contig_walks(g))
            else:
                # contigs, also after masking, where the unitigs of the
                # masked graph are the kept paths and kept fragments
                sub = MaskedDbg(base=g, mask=mask)
                nodes, first = contig_walks(sub)
            seqs = spell_walks(sub, nodes, first)
            values = (nodes.to(torch.int32),) + (
                (node_w[nodes],) if has_weights else ())
            paths, *counts = split_walks(first, *values)
            kept = int(mask[1:].sum()) if mask is not None \
                else g.num_nodes()
        kept_nodes += kept
        return Cleaned(seqs=seqs, paths=paths,
                       counts=counts[0] if counts else None,
                       threshold=prune_unitigs, estimate=estimate,
                       kept=kept)
