"""A read sample's cleaned k-mers, worked out by plain PyTorch sorts.

MetaGraph's per-sample pipeline (Karasikov et al., bioRxiv
2020.10.01.322164, Methods): ``build --mode canonical --count-kmers``,
then ``clean --prune-tips T --prune-unitigs 0 --fallback F``, which
keeps contigs in single form with their k-mer counts. The definition:

  * the graph's nodes are the reads' k-mers in both orientations; each
    counts the windows that read it or its reverse complement (a k-mer
    that is its own reverse complement, twice), saturated at
    2^count_width - 1;
  * w follows v when the last k - 1 characters of v are the first k - 1
    of w; a unitig is a maximal chain of links v -> w where v has one
    successor and w one predecessor (a closed chain is a cycle);
  * the threshold is McVean's gamma-Poisson fit to the histogram of the
    nodes' counts (graph_cleaning.cpp:210-330, as the JAX package reads
    it: ``threshold``), the fallback where the fit fails;
  * a unitig goes when it has fewer than T nodes and is a tip (its
    first node's predecessors and its last node's successors number
    fewer than 2), or when more than half of its nodes count less than
    the threshold (when the threshold is above 1);
  * the answer is each kept k-mer once, in canonical form (the smaller
    of it and its reverse complement as a 2-bit integer), with its count.

Departures from the program, none of which changes the answer: k-mers
are 2-bit integers (k <= 32, DNA only); unitigs are labelled by the
smallest node of their chain through doubling in both directions at
once, and cycles need no break. The gamma-Poisson fit keeps the JAX
package's float64 arithmetic and its order, so that its comparisons
round alike.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .kmers import kmer_ints, reverse_digits


def revcomp(x: torch.Tensor, K: int) -> torch.Tensor:
    """Reverse complements of 2-bit k-mers."""
    return reverse_digits(x, K) ^ ((1 << (2 * K)) - 1)


def sample_kmers(codes: np.ndarray, K: int, device="cpu"):
    """(sorted distinct canonical k-mers, their window counts) of a code
    array (1..4 = ACGT, anything else ends a read)."""
    c = torch.from_numpy(np.ascontiguousarray(codes)).to(device)
    fwd, ok = kmer_ints(c, K)
    rc, _ = kmer_ints(c, K, reverse_complement=True)
    can = torch.minimum(fwd, rc)[ok]
    del fwd, rc, ok
    return torch.unique(can, return_counts=True)


def threshold(hist, fdr: float = 0.001, frac_covg_kept: float = 0.2) -> int:
    """The gamma-Poisson cleaning threshold of a count histogram
    (``hist[c]``: nodes of count c, c >= 1); -1 where the fit fails.
    float64 arithmetic in the JAX package's order (numpy's sums), so
    that the rules' comparisons round alike."""
    h = np.zeros(max(len(hist), 10))
    h[:len(hist)] = np.asarray(hist, np.float64)
    h[0] = 0.0
    n = h.shape[0]
    if h[1] == 0 or h[2] == 0:
        return -1
    r1 = h[2] / h[1]
    rr = (h[3] / h[2]) / r1
    # the gamma shape a in 0.01..2.00 whose moment ratio lies nearest rr
    a = np.arange(1, 201) * 0.01
    gam = np.array([math.gamma(x) for x in a])
    gam1 = np.array([math.gamma(x) for x in a + 1])
    gam2 = np.array([math.gamma(x) for x in a + 2])
    a_est = a[np.argmin(np.abs(gam * gam2 / (2 * gam1 ** 2) - rr))]
    b_est = max(math.gamma(a_est + 1.0) / (r1 * math.gamma(a_est)) - 1.0,
                1.0)
    c0 = h[1] * (b_est / (1 + b_est)) ** (-a_est)
    # the error component's expected nodes at counts 1..n-1
    i = np.arange(1, n, dtype=np.float64)
    log_e = (a_est * math.log(b_est) - math.lgamma(a_est)
             - np.array([math.lgamma(x) for x in i])
             + np.array([math.lgamma(x) for x in a_est + i - 1])
             - (a_est + i - 1) * math.log(1 + b_est))
    err = np.exp(log_e) * c0
    obs = h[1:]
    err_cum, obs_cum = np.cumsum(err), np.cumsum(obs)
    err_left, obs_left = err.sum() - err_cum, obs.sum() - obs_cum
    with np.errstate(divide="ignore", invalid="ignore"):
        rules = (
            # 1: expected errors at most fdr of the nodes at that count
            err / obs <= fdr,
            # 2: errors kept fewer than the signal lost, as shares
            (1 - err_cum / obs_cum) > (err_left / obs_left),
            # 3: the signal lost exceeds the errors left
            (obs_cum - err_cum) > err_left)
    cutoff = -1
    for rule in rules:
        hits = np.flatnonzero(rule)
        if hits.size:
            cutoff = int(hits[0]) + 1
            break
    if cutoff < 0:
        return -1
    # the nodes' coverage kept has to be at least frac_covg_kept of it
    covg = h * np.arange(n)
    below, above = covg[:cutoff].sum(), covg[cutoff:].sum()
    if below + above > 0 and above / (below + above) < frac_covg_kept:
        return -1
    return cutoff


def _present(nodes: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    pos = torch.clamp(torch.searchsorted(nodes, x), max=nodes.numel() - 1)
    return nodes[pos] == x


def clean_sample(codes: np.ndarray, K: int, prune_tips: int,
                 prune_unitigs: int, fallback: int, count_width: int,
                 device="cpu") -> dict:
    """The cleaned sample: ``kmers`` (sorted canonical k-mers kept) and
    their ``counts``, both on the host, the ``threshold`` used and the
    graph's ``nodes``. ``prune_unitigs`` 0 asks for the estimated
    threshold, as the pipeline does."""
    if not 2 <= K <= 32:
        raise ValueError("2-bit k-mers need 2 <= k <= 32")
    dev = torch.device(device)
    kmers, counts = sample_kmers(codes, K, dev)
    rc = revcomp(kmers, K)
    pal = rc == kmers
    counts = torch.where(pal, 2 * counts, counts).clamp_(
        max=(1 << count_width) - 1)
    nodes = torch.cat([kmers, rc[~pal]])
    w = torch.cat([counts, counts[~pal]])
    del rc, pal
    nodes, order = torch.sort(nodes)
    w = w[order]
    del order
    N = nodes.numel()

    thr = prune_unitigs
    if prune_unitigs == 0:
        thr = threshold(torch.bincount(w).cpu().tolist())
        thr = fallback if thr < 0 else thr

    # successors and predecessors by (k - 1)-overlap
    full = (1 << (2 * K)) - 1
    outdeg = torch.zeros(N, dtype=torch.int64, device=dev)
    indeg = torch.zeros(N, dtype=torch.int64, device=dev)
    succ = torch.zeros(N, dtype=torch.int64, device=dev)
    for c in range(4):
        s = ((nodes << 2) & full) | c
        hit = _present(nodes, s)
        outdeg += hit
        succ = torch.where(hit, s, succ)
        indeg += _present(nodes, (c << (2 * (K - 1))) | (nodes >> 2))
    # links: v -> w where v has one successor w and w one predecessor
    w_idx = torch.searchsorted(nodes, succ)
    link = (outdeg == 1) & (indeg[torch.clamp(w_idx, max=N - 1)] == 1)
    ids = torch.arange(N, device=dev)
    nxt = torch.where(link, w_idx, ids)
    prv = ids.clone()
    prv[nxt[link]] = ids[link]
    has_prev = torch.zeros(N, dtype=torch.bool, device=dev)
    has_prev[nxt[link]] = True
    # each node's chain labelled by its smallest node: after r rounds a
    # node has seen 2^r - 1 nodes each way along its chain
    lab = ids.clone()
    fwd, back = nxt, prv
    for _ in range(max(1, math.ceil(math.log2(max(N, 2)))) + 1):
        lab = torch.minimum(lab, torch.minimum(lab[fwd], lab[back]))
        fwd, back = fwd[fwd], back[back]
    del fwd, back, nxt, prv
    length = torch.bincount(lab, minlength=N)
    # a chain's first node has no link into it, its last no link out;
    # a cycle has neither, and is no tip
    first = ~has_prev
    last = ~link
    ends = torch.zeros(N, dtype=torch.int64, device=dev)
    ends.index_add_(0, lab[first], indeg[first])
    ends.index_add_(0, lab[last], outdeg[last])
    has_first = torch.zeros(N, dtype=torch.bool, device=dev)
    has_first[lab[first]] = True
    tip = has_first & (ends < 2) & (length < prune_tips)
    drop = tip
    if thr > 1:
        weak = torch.bincount(lab, weights=(w < thr).to(torch.float64),
                              minlength=N)
        drop = drop | (weak * 2 > length)
    keep = ~drop[lab]
    can = torch.minimum(nodes, revcomp(nodes, K))[keep]
    kept, first_of = torch.unique(can, return_inverse=True)
    kc = torch.zeros_like(kept)
    kc[first_of] = w[keep]
    return {"kmers": kept.cpu().numpy(), "counts": kc.cpu().numpy(),
            "threshold": int(thr), "nodes": int(N)}
