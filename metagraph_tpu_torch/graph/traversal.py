"""Unitig and contig extraction by pointer doubling.

PyTorch counterpart of ``metagraph_tpu/graph/traversal.py``. Unitigs
are the chains of the unique-successor function:

  1. ``next[v]`` = the unique successor w of v when outdeg(v) == 1 and
     indeg(w) == 1 (0 otherwise), from one batched adjacency pass;
  2. pointer doubling over ``prev`` (the inverse of ``next``) finds each
     node's chain start and position in ceil(log2(N + 1)) rounds of
     gathers; pure cycles are broken at their minimum node id, found by
     min-propagation in the same rounds;
  3. the strings come from one scatter of node characters into a flat
     buffer on the graph's device (a chain's first node writes its k-mer,
     every other node its last character), copied to the host once with
     the chains' cuts; text, paths and counts stay one host buffer each,
     sliced a walk at a time when read (``Walks``).

Contigs join unitigs end to start by the same greedy matching as the
JAX package and are ordered by a second doubling over the joins, so no
per-chain Python loop runs. A masked graph's contigs are found among its
kept nodes alone, renumbered in the order of their ids: the masked-out
nodes, each a chain of its own, change no choice and no order. Every
tensor lives on the graph's device; outputs (sequences, paths) are the
JAX package's, order included.
"""

from __future__ import annotations

from collections.abc import Sequence
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..common import packed
from ..kmer import packing

# nodes per adjacency or decode call: bounds their temporaries to a few
# GiB (the reverse complement's, about 372 B a node, the most), in few
# enough chunks that a pass's binary searches, a few dozen small kernels
# a round, do not wait on their launches
_CHUNK = 1 << 24

# unitigs found by every ``unitig_decomposition`` since import (masked
# graphs included)
unitigs = 0


@dataclass
class Unitigs:
    """Unitig decomposition: per-node chain id and position, per-chain
    start, length and cycle flag (int64 / bool tensors on the graph's
    device)."""
    chain_id: torch.Tensor    # (N+1,); slot 0 unused
    pos: torch.Tensor         # (N+1,) position within the chain
    starts: torch.Tensor      # (U,) start node per chain, ascending
    lengths: torch.Tensor     # (U,) nodes per chain
    is_cycle: torch.Tensor    # (U,) bool

    @property
    def num_unitigs(self) -> int:
        return int(self.starts.shape[0])


def in_chunks(fn, nodes: torch.Tensor) -> torch.Tensor:
    """``fn`` over ``nodes`` in chunks of ``_CHUNK``, concatenated."""
    if nodes.shape[0] <= _CHUNK:
        return fn(nodes)
    return torch.cat([fn(nodes[i:i + _CHUNK])
                      for i in range(0, nodes.shape[0], _CHUNK)])


def _all_nodes(g) -> torch.Tensor:
    return torch.arange(1, g.num_nodes() + 1, device=g.device)


def _next_links(g):
    """(next, prev) over 0..N (0 = chain boundary)."""
    N = g.num_nodes()
    succ = in_chunks(g.successors, _all_nodes(g))          # (N, sigma-1)
    outdeg = torch.sum(succ > 0, dim=1)
    uniq = torch.sum(succ, dim=1)                           # when outdeg == 1
    # in-degrees by atomic adds of the successors alone (``bincount``
    # reads the maximum to the host first, and the empty slots, most of
    # them, would all add into slot 0, which no link reads)
    flat = succ.reshape(-1)
    flat = flat[flat > 0]
    indeg = torch.zeros((N + 1,), dtype=torch.int32,
                        device=succ.device).index_add_(
        0, flat, torch.ones((1,), dtype=torch.int32,
                            device=succ.device).expand(flat.shape[0]))
    link = (outdeg == 1) & (uniq > 0) & (indeg[torch.clamp(uniq, max=N)] == 1)
    zero = torch.zeros((1,), dtype=torch.int64, device=succ.device)
    nxt = torch.cat([zero, torch.where(link, uniq, 0)])
    # next is injective on its support, so one scatter of the linked
    # nodes builds the inverse; slot 0 stays 0
    src = torch.nonzero(nxt).squeeze(1)
    prv = torch.zeros_like(nxt)
    prv[nxt[src]] = src
    return nxt, prv


def rank_chains(prv: torch.Tensor):
    """Pointer doubling over ``prv`` (0 = no link): each slot's chain
    root, its distance to it, and whether it lies on a pure cycle (broken
    at its minimum id, whose link is dropped: distance 0 marks the roots).
    ceil(log2(N1)) rounds, enough for the longest chain and cycle; the
    JAX package's RowDiff anchors run ceil(log2(N1 + 1)), which gives the
    same result. Also the RowDiff successor forest (``anno/row_diff.py``)."""
    N1 = prv.shape[0]
    steps = max(1, int(np.ceil(np.log2(max(N1, 2)))))
    ids = torch.arange(N1, device=prv.device)
    parent = torch.where(prv > 0, prv, ids)
    mins = torch.minimum(ids, parent)
    for _ in range(steps):
        mins = torch.minimum(mins, mins[parent])
        parent = parent[parent]
    in_cycle = prv[parent] > 0          # the final parent is not a root
    leader = torch.where(in_cycle, mins, parent)
    prv2 = torch.where(in_cycle & (ids == leader), 0, prv)
    parent2 = torch.where(prv2 > 0, prv2, ids)
    dist = (prv2 > 0).to(torch.int64)
    for _ in range(steps):
        dist = dist + dist[parent2]
        parent2 = parent2[parent2]
    return parent2, dist, in_cycle


def unitig_decomposition(g) -> Unitigs:
    global unitigs
    _, prv = _next_links(g)
    start_of, pos, in_cycle = rank_chains(prv)
    N1 = prv.shape[0]
    dev = prv.device
    is_start = torch.zeros((N1,), dtype=torch.bool, device=dev)
    is_start[start_of[1:]] = True
    is_start[0] = False
    starts = torch.nonzero(is_start).squeeze(1)
    U = starts.shape[0]
    unitigs += U
    chain_rank = torch.zeros((N1,), dtype=torch.int64, device=dev)
    chain_rank[starts] = torch.arange(U, device=dev)
    chain_id = chain_rank[start_of]
    lengths = torch.zeros((U,), dtype=torch.int64, device=dev).scatter_reduce_(
        0, chain_id[1:], pos[1:] + 1, "amax")
    # every node of a chain carries the chain's cycle flag
    cyc = torch.zeros((U,), dtype=torch.int64, device=dev).scatter_reduce_(
        0, chain_id[1:], in_cycle[1:].to(torch.int64), "amax")
    return Unitigs(chain_id=chain_id, pos=pos, starts=starts,
                   lengths=lengths, is_cycle=cyc.to(torch.bool))


def unitig_ends(g, u: Unitigs) -> torch.Tensor:
    """Last node of each chain (pos == length - 1)."""
    last = torch.zeros((u.num_unitigs,), dtype=torch.int64,
                       device=u.pos.device)
    cid = u.chain_id[1:]
    sel = u.pos[1:] == (u.lengths[cid] - 1)
    last[cid[sel]] = torch.nonzero(sel).squeeze(1) + 1
    return last


def unitig_keep_mask(g, u: Unitigs, min_tip_size: int, weights=None,
                     min_median_abundance: int = 1) -> torch.Tensor:
    """(U,) bool per-unitig keep decision: the reference's tip filter
    (keep iff the path has >= min_tip_size nodes or is no tip:
    indegree(start) + outdegree(end) >= 2) and the median-abundance
    filter (unreliable iff strictly more than half its k-mers weigh less
    than the threshold)."""
    keep = torch.ones((u.num_unitigs,), dtype=torch.bool,
                      device=u.pos.device)
    if min_tip_size > 1:
        ends = unitig_ends(g, u)
        ind = in_chunks(g.indegree, u.starts)
        outd = in_chunks(g.outdegree, ends)
        is_tip = (ind + outd) < 2
        short = u.lengths < min_tip_size
        keep &= ~(short & is_tip)
    if min_median_abundance > 1 and weights is not None:
        w = torch.as_tensor(weights, device=u.pos.device)
        weak = (w[1:] < min_median_abundance).to(torch.int64)
        num_weak = torch.zeros_like(u.lengths).index_add_(
            0, u.chain_id[1:], weak)
        keep &= ~(num_weak * 2 > u.lengths)
    return keep


def single_form_mask(g) -> torch.Tensor:
    """(N+1,) bool: each rc-pair's smaller packed orientation, once (the
    role of the reference's kmers_in_single_form; any one-per-pair cover
    is equivalent after a canonical rebuild)."""
    B = g.alphabet.bits_per_char

    def le_rc(nodes):
        lanes = g.node_lanes(nodes)
        return packed.le(lanes, packing.reverse_complement(
            lanes, g.k, B, g.alphabet.complement))

    keep = in_chunks(le_rc, _all_nodes(g))
    return torch.cat([torch.zeros((1,), dtype=torch.bool,
                                  device=keep.device), keep])


def _path_order(u: Unitigs):
    """(N,) node ids ordered by (chain, pos), and the (U+1,) chain
    bounds into it: chain c's path is order[bounds[c]:bounds[c + 1]]."""
    dev = u.pos.device
    bounds = torch.cat([torch.zeros((1,), dtype=torch.int64, device=dev),
                        torch.cumsum(u.lengths, 0)])
    N = u.pos.shape[0] - 1
    order = torch.empty((N,), dtype=torch.int64, device=dev)
    order[bounds[u.chain_id[1:]] + u.pos[1:]] = torch.arange(
        1, N + 1, device=dev)
    return order, bounds


def unitig_paths(g, u: Unitigs) -> List[np.ndarray]:
    """Node id path per unitig (host arrays)."""
    order, bounds = _path_order(u)
    return np.split(order.cpu().numpy().astype(np.int32),
                    bounds[1:-1].cpu().numpy())


def _chain_nodes(u: Unitigs, chains: torch.Tensor, order, bounds):
    """The paths of ``chains``, concatenated in that order: (flat node
    ids, (len(chains),) offset of each chain's first node in them)."""
    lens = u.lengths[chains]
    offs = torch.cumsum(lens, 0) - lens
    total = int(lens.sum())
    rep = torch.repeat_interleave(torch.arange(chains.shape[0],
                                               device=lens.device), lens,
                                  output_size=total)
    within = torch.arange(total, device=lens.device) - offs[rep]
    return order[bounds[chains[rep]] + within], offs


def spell_walks(g, nodes: torch.Tensor, first: torch.Tensor) -> "Walks":
    """Strings of consecutive node walks, concatenated in ``nodes``;
    ``first`` flags each walk's first node. Each walk spells its first
    node's k-mer, then the last character of every other node. One
    scatter on the device, one copy of the text and one of its cuts to
    the host: returns ``Walks`` of bytes strings over the text."""
    k = g.k
    dev = nodes.device
    n = nodes.shape[0]
    if n == 0:
        return Walks(b"", np.zeros((1,), np.int64))
    walk = torch.cumsum(first.to(torch.int64), 0) - 1
    n_walks = int(walk[-1]) + 1
    # entry i of walk s lands at i + (s + 1)(k - 1); a first node's
    # k-mer starts k - 1 earlier
    dst = torch.arange(n, device=dev) + (walk + 1) * (k - 1)
    buf = torch.empty((n + n_walks * (k - 1),), dtype=torch.uint8,
                      device=dev)
    cols = torch.arange(k, device=dev)
    for i in range(0, n, _CHUNK):
        sl = slice(i, i + _CHUNK)
        chars = g.node_chars(nodes[sl]).to(torch.uint8)
        buf[dst[sl]] = chars[:, k - 1]
        f = first[sl]
        buf[(dst[sl][f] - (k - 1))[:, None] + cols] = chars[f]
    letters = torch.tensor(list(g.alphabet.letters.encode()),
                           dtype=torch.uint8, device=dev)
    bounds = torch.cat([dst[first] - (k - 1),
                        torch.tensor([buf.shape[0]], device=dev)])
    return Walks(_host(letters[buf.long()]).tobytes(), _host(bounds))


class Walks(Sequence):
    """Per-walk host slices of one flat array or bytes string: walk i is
    ``flat[bounds[i]:bounds[i + 1]]``, made when it is read, so no
    object a walk is made until then."""

    def __init__(self, flat, bounds: np.ndarray):
        self.flat, self.bounds = flat, bounds

    def __len__(self) -> int:
        return len(self.bounds) - 1

    def __getitem__(self, i: int):
        i = range(len(self))[i]
        return self.flat[self.bounds[i]:self.bounds[i + 1]]

    def __iter__(self):
        b = self.bounds.tolist()
        return (self.flat[x:y] for x, y in zip(b[:-1], b[1:]))


def split_walks(first: torch.Tensor, *values: torch.Tensor):
    """``Walks`` of each of ``values`` (tensors aligned with the walks'
    nodes; ``first`` flags each walk's first node): one copy of each to
    the host, the cuts shared."""
    bounds = torch.cat([torch.nonzero(first).squeeze(1),
                        torch.tensor([first.shape[0]], device=first.device)])
    bounds = _host(bounds) if first.shape[0] else np.zeros((1,), np.int64)
    return tuple(Walks(_host(v), bounds) for v in values)


def _host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a host array: from a card by one copy into page-locked
    memory (PyTorch's cached pinned blocks; a pageable copy is staged
    through the CPU at a few GB/s)."""
    if t.device.type == "cpu":
        return t.numpy()
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h.numpy()


def _no_walks(dev):
    return (torch.zeros((0,), dtype=torch.int64, device=dev),
            torch.zeros((0,), dtype=torch.bool, device=dev))


def _walk_output(g, nodes, first, return_paths: bool):
    seqs = list(spell_walks(g, nodes, first))
    if not return_paths:
        return seqs
    return seqs, split_walks(first, nodes.to(torch.int32))[0]


def unitig_sequences(g, u: Optional[Unitigs] = None, min_length: int = 0,
                     apply_mask: bool = True, keep=None,
                     return_paths: bool = False):
    """Unitig strings (a path of n nodes spells n + k - 1 chars), in
    chain order. ``keep``: optional per-unitig bool filter; on a masked
    graph (``apply_mask``) the masked-out singleton chains are skipped;
    ``return_paths`` also yields each emitted unitig's node path."""
    nodes, first = unitig_walks(g, u, min_length, apply_mask, keep)
    return _walk_output(g, nodes, first, return_paths)


def unitig_walks(g, u: Optional[Unitigs] = None, min_length: int = 0,
                 apply_mask: bool = True, keep=None):
    """The nodes of ``unitig_sequences``' unitigs on the device, in its
    order, and the flags of each unitig's first node."""
    if u is None:
        u = unitig_decomposition(g)
    k = g.k
    if u.num_unitigs == 0:
        return _no_walks(u.pos.device)
    sel = u.lengths + k - 1 >= max(min_length, k)
    mask = getattr(g, "mask", None) if apply_mask else None
    if mask is not None:
        sel &= mask[u.starts]
    if keep is not None:
        sel &= torch.as_tensor(keep, device=sel.device)
    chains = torch.nonzero(sel).squeeze(1)
    order, bounds = _path_order(u)
    nodes, offs = _chain_nodes(u, chains, order, bounds)
    first = torch.zeros(nodes.shape, dtype=torch.bool, device=nodes.device)
    first[offs] = True
    return nodes, first


def _join_unitigs(g, u: Unitigs):
    """The JAX package's greedy tail -> head matching of unitigs: up to
    sigma - 1 rounds in which every unmatched tail proposes its first
    free head candidate (a successor of its last node that starts
    another non-cycle chain) and each head keeps its lowest tail.
    Returns (next_chain (U,), -1 = none; used_head (U,) bool)."""
    U = u.num_unitigs
    N = g.num_nodes()
    dev = u.pos.device
    succ = in_chunks(g.successors, unitig_ends(g, u))       # (U, sigma-1)
    chain_of_start = torch.full((N + 1,), -1, dtype=torch.int64, device=dev)
    chain_of_start[u.starts] = torch.arange(U, device=dev)
    cand = chain_of_start[torch.clamp(succ, 0, N)]
    cand[succ <= 0] = -1
    tails = torch.arange(U, device=dev)
    ok = (cand >= 0) & (cand != tails[:, None]) & ~u.is_cycle[:, None]
    ok &= torch.where(cand >= 0, ~u.is_cycle[torch.clamp(cand, min=0)],
                      False)
    used_head = torch.zeros((U,), dtype=torch.bool, device=dev)
    next_chain = torch.full((U,), -1, dtype=torch.int64, device=dev)
    for _ in range(succ.shape[1]):
        avail = ok & ~used_head[torch.clamp(cand, min=0)] & (cand >= 0)
        avail &= (next_chain[:, None] < 0)
        has = torch.any(avail, dim=1)
        if not bool(torch.any(has)):
            break
        pick = cand[tails, torch.argmax(avail.to(torch.uint8), dim=1)]
        pick = torch.where(has, pick, -1)
        # lowest tail wins each head: a stable sort by head keeps tails
        # in ascending order within a head
        t_sorted = torch.sort(pick, stable=True).indices
        p_sorted = pick[t_sorted]
        win_first = torch.cat([torch.ones((1,), dtype=torch.bool,
                                          device=dev),
                               p_sorted[1:] != p_sorted[:-1]])
        winners = (p_sorted >= 0) & win_first
        next_chain[t_sorted[winners]] = p_sorted[winners]
        used_head[p_sorted[winners]] = True
    return next_chain, used_head


def contig_sequences(g, return_paths: bool = False):
    """Contigs: a node-disjoint path cover that may run through
    branches (the reference's call_sequences), as the JAX package builds
    it: unitigs joined end to start by a greedy matching. Output order:
    each join path from its first unitig, by that unitig's chain id
    (masked-out chains skipped), then every unitig on a cycle of joins,
    alone, by chain id."""
    nodes, first = contig_walks(g)
    return _walk_output(g, nodes, first, return_paths)


class _Kept:
    """The nodes a masked graph keeps, renumbered 1..M in the order of
    their ids (``ids``: their base ids), with the masked graph's
    adjacency: its unitigs, joins and contigs are the masked graph's
    without the masked-out nodes, each a chain of its own there."""

    def __init__(self, g, ids: torch.Tensor):
        self.g, self.ids, self.device = g, ids, g.device
        self.inv = torch.zeros((g.num_nodes() + 1,), dtype=torch.int64,
                               device=g.device)
        self.inv[ids] = torch.arange(1, ids.shape[0] + 1, device=g.device)

    def num_nodes(self) -> int:
        return int(self.ids.shape[0])

    def successors(self, nodes: torch.Tensor) -> torch.Tensor:
        base = torch.where(nodes > 0, self.ids[torch.clamp(nodes - 1, 0)], 0)
        return self.inv[self.g.successors(base)]


def contig_walks(g):
    """The nodes of ``contig_sequences``' contigs on the device, in its
    order, and the flags of each contig's first node. A masked graph's
    are found among its kept nodes alone."""
    mask = getattr(g, "mask", None)
    if mask is not None:
        ids = torch.nonzero(mask[1:]).squeeze(1) + 1
        nodes, first = contig_walks(_Kept(g, ids))
        return ids[nodes - 1], first
    u = unitig_decomposition(g)
    U = u.num_unitigs
    dev = u.pos.device
    if U == 0:
        return _no_walks(dev)
    next_chain, used_head = _join_unitigs(g, u)
    # rank every chain along its join path by doubling over the inverse
    # joins (chain c is slot c + 1; 0 = no previous)
    prv = torch.zeros((U + 1,), dtype=torch.int64, device=dev)
    tails = torch.nonzero(next_chain >= 0).squeeze(1)
    prv[next_chain[tails] + 1] = tails + 1
    root, rank, on_cycle = rank_chains(prv)
    root, rank, on_cycle = root[1:] - 1, rank[1:], on_cycle[1:]
    keep = on_cycle | ~used_head[root]
    key = torch.where(on_cycle, U * U + torch.arange(U, device=dev),
                      root * U + rank)
    chains = torch.nonzero(keep).squeeze(1)
    chains = chains[torch.sort(key[chains]).indices]
    order, bounds = _path_order(u)
    nodes, offs = _chain_nodes(u, chains, order, bounds)
    first = torch.zeros(nodes.shape, dtype=torch.bool, device=dev)
    first[offs[on_cycle[chains] | (rank[chains] == 0)]] = True
    return nodes, first
