"""The BOSS table of a DNA k-mer set, worked out by plain PyTorch sorts.

The definition (Bowe, Onodera, Sadakane and Shibuya 2012, as MetaGraph
builds it): the edges are the real k-mers plus the dummy edges that make
every node reachable from the root and give every node an outgoing edge:

  * a dummy sink (T, $) for each target node T of a real edge that has no
    real outgoing edge;
  * for each source node S = S_1..S_{k-1} of a real edge that has no real
    incoming edge, the dummy sources ($^j S_1..S_{k-1-j}, S_{k-j}) for
    j = 1..k-1, each once;
  * the root edge $^k.

Edges sort by their node read from its last character back (colex), then
by the edge label; $ sorts before A < C < G < T. ``last`` marks the last
edge of each node, ``W`` is the label, plus the alphabet size (5) on an
edge that is not the first in this order into its target with that
label, and ``F[c]`` counts the edges whose node ends in a character
below c. Row 0 of ``W`` and ``last`` is the sentinel (0, False).

Modes: ``basic`` takes the k-mers as read, ``canonical`` adds the
reverse complement of each, ``primary`` keeps one of a k-mer and its
reverse complement: the one that comes first in BOSS order (MetaGraph's
packed k-mer keeps its characters in that order, and its canonical form
is the smaller packed value). A k-mer is a 2-bit integer (A = 0 .. T = 3,
the first character most significant), so k <= 32.
"""

from __future__ import annotations

import numpy as np
import torch

from .kmers import kmer_ints, reverse_digits

ALPH = 5                       # $ A C G T


def boss_order(kmers: torch.Tensor, n1: int) -> torch.Tensor:
    """A key of 2-bit k-mers that sorts them in BOSS order: the node's
    characters from the last back, then the label."""
    return (reverse_digits(kmers >> 2, n1) << 2) | (kmers & 3)


def real_kmers(codes: torch.Tensor, K: int, mode: str) -> torch.Tensor:
    """Sorted distinct real edges of the mode."""
    fwd, ok = kmer_ints(codes, K)
    fwd = fwd[ok]
    if mode == "basic":
        return torch.unique(fwd)
    rc, _ = kmer_ints(codes, K, reverse_complement=True)
    rc = rc[ok]
    if mode == "primary":
        n1 = K - 1
        fwd_first = boss_order(fwd, n1) <= boss_order(rc, n1)
        return torch.unique(torch.where(fwd_first, fwd, rc))
    if mode == "canonical":
        return torch.unique(torch.cat([fwd, rc]))
    raise ValueError(f"mode {mode!r}")


def _not_in(x: torch.Tensor, sorted_set: torch.Tensor) -> torch.Tensor:
    """Mask of the entries of ``x`` absent from a sorted int64 set."""
    if sorted_set.numel() == 0:
        return torch.ones_like(x, dtype=torch.bool)
    pos = torch.searchsorted(sorted_set, x)
    hit = sorted_set[torch.clamp(pos, max=sorted_set.numel() - 1)] == x
    return ~hit


def boss_table(codes: np.ndarray, K: int, mode: str, device="cpu",
               dummy_levels: str = "all") -> dict:
    """W (int8), last (bool), F (int64, 5) and the node count of the BOSS
    table of the k-mers of ``codes``, on the host. ``dummy_levels``
    "first" leaves out the dummy sources past the first level (the
    control: nodes that the root no longer reaches)."""
    if not 2 <= K <= 32:
        raise ValueError("2-bit k-mers need 2 <= k <= 32")
    dev = torch.device(device)
    n1 = K - 1                                   # node length
    full = (1 << (2 * n1)) - 1
    real = real_kmers(torch.from_numpy(np.ascontiguousarray(codes)).to(dev),
                      K, mode)
    src = real >> 2                              # S: first K-1 characters
    tgt = real & full                            # T: last K-1 characters
    src_u = torch.unique(src)
    tgt_u = torch.unique(tgt)
    sinks = tgt_u[_not_in(tgt_u, src_u)]
    sources = src_u[_not_in(src_u, tgt_u)]
    del src, tgt, tgt_u

    # each part: (colex node key, real characters in the node, label)
    keys, nreal, labels = [], [], []

    def part(key, m, lab):
        keys.append(key)
        nreal.append(torch.full_like(key, m, dtype=torch.int16)
                     if isinstance(m, int) else m.to(torch.int16))
        labels.append(torch.full_like(key, lab, dtype=torch.int16)
                      if isinstance(lab, int) else lab.to(torch.int16))

    part(reverse_digits(real >> 2, n1), n1, (real & 3) + 1)
    part(reverse_digits(sinks, n1), n1, 0)
    last_level = n1 if dummy_levels == "all" else 1
    for j in range(1, last_level + 1):
        # level j: node $^j S_1..S_{K-1-j}, label S_{K-j}: the distinct
        # prefixes of K-j characters of the sources
        p = torch.unique(sources >> (2 * (j - 1)))
        part(reverse_digits(p >> 2, n1), n1 - j, (p & 3) + 1)
    part(torch.zeros(1, dtype=torch.int64, device=dev), 0, 0)   # $^K
    del real, sinks, sources, src_u

    key = torch.cat(keys)
    keys.clear()
    sec = torch.cat(nreal) * 8 + torch.cat(labels)
    nreal.clear()
    labels.clear()
    # order by (key, real characters, label): two stable sorts
    sec, order = torch.sort(sec, stable=True)
    key = key[order]
    key, order = torch.sort(key, stable=True)
    sec = sec[order]
    del order
    m = sec >> 3
    lab = sec & 7
    del sec
    N = key.numel()

    new_node = torch.ones(N, dtype=torch.bool, device=dev)
    new_node[1:] = (key[1:] != key[:-1]) | (m[1:] != m[:-1])
    last = torch.ones(N, dtype=torch.bool, device=dev)
    last[:-1] = new_node[1:]
    nodes = int(last.sum())

    # minus flags: edges into one target share the node's last K-2
    # characters (key >> 2, with min(m, K-2) real ones), which sit in one
    # block of the order; the first edge of each label in its block is
    # the representative
    gkey = key >> 2
    gm = torch.clamp(m, max=n1 - 1)
    block_first = torch.ones(N, dtype=torch.bool, device=dev)
    block_first[1:] = (gkey[1:] != gkey[:-1]) | (gm[1:] != gm[:-1])
    del gkey, gm
    block = torch.cumsum(block_first.to(torch.int64), 0) - 1
    starts = torch.nonzero(block_first).squeeze(1)
    minus = torch.zeros(N, dtype=torch.bool, device=dev)
    for c in range(1, ALPH):
        is_c = (lab == c).to(torch.int64)
        cnt = torch.cumsum(is_c, 0)
        before_block = (cnt - is_c)[starts][block]
        minus |= (is_c == 1) & (cnt - before_block > 1)
        del is_c, cnt, before_block
    W = (lab + ALPH * minus.to(torch.int64)).to(torch.int8)
    del minus, block, starts

    # the node's last character: the key's top digit, $ for the root
    top = torch.where(m > 0, (key >> (2 * (n1 - 1))) + 1,
                      torch.zeros_like(key))
    F = torch.stack([(top < c).sum() for c in range(ALPH)])
    return {"W": np.concatenate([[0], W.cpu().numpy()]).astype(np.int8),
            "last": np.concatenate([[False], last.cpu().numpy()]),
            "F": F.cpu().numpy().astype(np.int64),
            "nodes": nodes}
