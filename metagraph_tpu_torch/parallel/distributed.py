"""Builds and queries across ranks: k-mer space routed over a process group.

Counterpart of ``metagraph_tpu/parallel/distributed.py``. The JAX package
runs ``shard_map`` steps over a device mesh, with ``all_to_all`` over
fixed per-destination buffers. Here every rank is a process with one
device (``parallel/multihost.py``), a ``Mesh`` names the ranks of one
process group, and every rank calls the same function with the same
arguments (each picks its own part of the input by its rank).

One exchange serves every route (``exchange``): the per-destination
row counts go first (``all_to_all_single``), then the rows, grouped by
destination with one stable sort of their owners, as one ``(n, C)``
int32 matrix (the k-mer's lanes, then its payloads) with those counts
as split sizes. Sizes are exact, so the JAX package's fixed ``per``
buffers, its routing histogram pre-pass (``route_histogram_step``), its
overflow retry loop and its ``_bucket`` capacity classes (all there for
XLA's static shapes) are gone. NCCL moves device tensors; gloo moves
host ones, so a gloo rank on a card stages its buffers through host
memory (``Mesh.staged``), chosen by the group's backend.

The fully sharded build (``build_boss_distributed_full``) routes k-mers
to colex-contiguous shards by sampled group-key splitters, and runs the
out-of-core build's per-shard stages on each rank (``outofcore.py``:
``_sink_join``, ``_src_join``, ``_emit_shard``): a rank is one shard and
the collectives replace its host buckets. Every rank returns the whole
graph, its slices gathered in rank order.

Input is cut into ``size`` equal slabs of the concatenated codes, each
reaching K - 1 codes into the next (``code_slab``), so a record longer
than a slab is split with no k-mer lost or counted twice; the JAX
package packs whole records into slabs and fails on a record longer
than one (``distributed.py:518``).

Primary mode folds each k-mer to its canonical form and builds the basic
graph over them, as ``build_boss`` does; the JAX package's fully sharded
build makes the canonical closure for it (``distributed.py:503``), a
fault not carried over.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..common import device as devmod
from ..common import merge as pmerge
from ..common import packed
from ..graph import boss_construct as bc
from ..graph.boss import Boss
from ..kmer import packing
from ..kmer.alphabets import Alphabet, DNA, INVALID_CODE
from ..kmer.extractor import encode_sequences, extract_packed_kmers
from .multihost import Mesh
from .outofcore import (_Keys, _emit_shard, _min1, _sink_join, _src_join,
                        h_group_key)


def make_mesh(n: Optional[int] = None, device="cuda") -> Mesh:
    """A mesh over the first ``n`` ranks of the process group (all when
    None). Every rank of the group must call it (``dist.new_group`` is
    collective); a rank past ``n`` gets a mesh with rank -1. Without a
    process group: one rank, no collectives."""
    dev = devmod.resolve(device)
    if not dist.is_initialized():
        if n not in (None, 1):
            raise ValueError(f"a mesh of {n} ranks needs a process group "
                             f"(multihost.initialize)")
        return Mesh(None, 0, 1, dev)
    world = dist.get_world_size()
    n = n or world
    if not 1 <= n <= world:
        raise ValueError(f"mesh of {n} ranks in a group of {world}")
    group = (dist.group.WORLD if n == world
             else dist.new_group(list(range(n))))
    me = dist.get_rank()
    return Mesh(group, me if me < n else -1, n, dev)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _to_backend(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    return t.cpu() if mesh.staged else t


def _all_reduce(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Sum over the ranks."""
    if mesh.group is None:
        return t
    h = _to_backend(mesh, t).clone()
    dist.all_reduce(h, group=mesh.group)
    return h.to(mesh.device)


def _log(mesh: Mesh, name: str, recv: torch.Tensor, t0: float):
    log = mesh.routes.setdefault(name, [0, 0, 0, 0.0])
    log[0] += 1
    log[1] += recv.shape[0]
    log[2] += recv.numel() * recv.element_size()
    log[3] += time.perf_counter() - t0


def _all_gather_rows(mesh: Mesh, rows: torch.Tensor) -> torch.Tensor:
    """Every rank's (m_r, C) rows, concatenated in rank order."""
    t0 = time.perf_counter()
    if mesh.group is None:
        out, sizes = rows, [rows.shape[0]]
    else:
        m = _to_backend(mesh, torch.tensor(
            [rows.shape[0]], dtype=torch.int64, device=mesh.device))
        sizes = [torch.empty_like(m) for _ in range(mesh.size)]
        dist.all_gather(sizes, m, group=mesh.group)
        sizes = [int(s) for s in sizes]
        top = max(sizes)
        send = _to_backend(mesh, rows)
        if send.shape[0] < top:
            send = torch.cat([send, send.new_zeros(
                (top - send.shape[0], send.shape[1]))])
        outs = [send.new_empty((top, rows.shape[1]))
                for _ in range(mesh.size)]
        dist.all_gather(outs, send.contiguous(), group=mesh.group)
        out = torch.cat([o[:s] for o, s in zip(outs, sizes)]).to(mesh.device)
    mesh.shard_rows = sizes
    _log(mesh, "gather", out, t0)
    return out


def exchange(mesh: Mesh, name: str, dest: torch.Tensor, rows: torch.Tensor
             ) -> Tuple[torch.Tensor, list]:
    """Send each row of ``rows`` ((n, C) int32) to rank ``dest`` ((n,)
    int64). Returns (the rows this rank received, in source-rank order
    and in their order at the source; the count from each source rank).
    Logs the route under ``name`` in ``mesh.routes``."""
    t0 = time.perf_counter()
    if mesh.group is None:
        recv, counts = rows, [rows.shape[0]]
    else:
        order = torch.sort(dest, stable=True).indices
        send = _to_backend(mesh, rows[order])
        send_counts = _to_backend(mesh, torch.bincount(
            dest, minlength=mesh.size))
        recv_counts = torch.empty_like(send_counts)
        dist.all_to_all_single(recv_counts, send_counts, group=mesh.group)
        counts = recv_counts.tolist()
        recv = send.new_empty((sum(counts), rows.shape[1]))
        dist.all_to_all_single(recv, send, counts, send_counts.tolist(),
                               group=mesh.group)
        recv = recv.to(mesh.device)
    _log(mesh, name, recv, t0)
    return recv, counts


def _route(mesh: Mesh, name: str, dest: torch.Tensor, lanes: torch.Tensor,
           *payloads: torch.Tensor):
    """``exchange`` of (L, n) lanes with (n,) int32 payloads riding along.
    Returns ((L, m) lanes, payloads..., per-source counts)."""
    L = lanes.shape[0]
    rows = torch.cat([lanes.T] + [p.to(torch.int32)[:, None]
                                  for p in payloads], dim=1)
    recv, counts = exchange(mesh, name, dest, rows)
    return ((recv[:, :L].T.contiguous(),)
            + tuple(recv[:, L + i].contiguous()
                    for i in range(len(payloads))) + (counts,))


# ---------------------------------------------------------------------------
# host-side helpers
# ---------------------------------------------------------------------------

def code_slab(seqs: Sequence[bytes | str], alphabet: Alphabet, rank: int,
              n: int, K: int) -> np.ndarray:
    """Rank ``rank``'s part of the input's codes (records joined by one
    INVALID code): the windows that start in its 1/n of the positions,
    i.e. its positions and the K - 1 codes after them."""
    codes = encode_sequences(seqs, alphabet)
    total = codes.shape[0]
    per = -(-total // n)
    lo = min(rank * per, total)
    hi = min(lo + per + K - 1, total)
    slab = codes[lo:hi]
    if slab.shape[0] < K:
        slab = np.concatenate([slab, np.full(K - slab.shape[0],
                                             INVALID_CODE, np.uint8)])
    return slab


def _owner_of(lanes: torch.Tensor, K: int, B: int, n_dev: int
              ) -> torch.Tensor:
    """Owner rank of each k-mer by its fixed 16-bucket prefix (top and
    second node characters): ranks hold contiguous colex ranges."""
    top = packing.top_char(lanes, K, B).to(torch.int64)
    second = packed.get_field(lanes, K - 2, B).to(torch.int64)
    bucket = (top - 1) * 4 + (second - 1)
    per = max(1, 16 // n_dev)
    return torch.clamp(bucket // per, 0, n_dev - 1)


def sample_splitters(seqs, k: int, n_dev: int, alphabet=None,
                     sample: int = 8192, seed: int = 0) -> np.ndarray:
    """(L, n_dev - 1) sorted splitter group keys at the quantiles of a
    host-side sample of windows, the JAX package's for the same input and
    seed."""
    alphabet = alphabet or DNA
    B = alphabet.bits_per_char
    K = k
    L = packed.num_lanes(K, B)
    tbl = alphabet.encode_table()
    rng = np.random.default_rng(seed)
    windows = []
    budget = max(sample // max(len(seqs), 1), 8)
    for s in seqs:
        cs = tbl[np.frombuffer(s.encode() if isinstance(s, str) else bytes(s),
                               np.uint8)]
        n = len(cs) - K + 1
        if n <= 0:
            continue
        take = min(n, budget)
        starts = (rng.choice(n, size=take, replace=False) if n > take
                  else np.arange(n))
        w = cs[starts[:, None] + np.arange(K)]
        windows.append(w[~(w == INVALID_CODE).any(axis=1)])
    chars = np.concatenate(windows) if windows else np.zeros((0, K), np.uint8)
    if chars.shape[0] == 0:
        return np.zeros((L, max(n_dev - 1, 1)), np.uint32)
    lanes = packed.lanes_to_numpy(packing.pack_from_chars(
        torch.from_numpy(chars), K, B))
    gk = h_group_key(lanes, B)
    gs = gk[:, np.lexsort(tuple(gk[j] for j in range(L - 1, -1, -1)))]
    qs = [gs[:, (i * gs.shape[1]) // n_dev] for i in range(1, n_dev)]
    if not qs:
        return np.zeros((L, 0), np.uint32)
    return np.stack(qs, axis=1)


def shard_annotation_coo(rows: np.ndarray, cols: np.ndarray, num_rows: int,
                         num_cols: int, n_dev: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: repartition COO pairs by column shard and pad so shard d
    owns slice d of equal size (rank d passes
    ``x.reshape(n_dev, -1)[d]``); local column ids are shard-relative."""
    cols_per = -(-num_cols // n_dev)
    owner = cols // cols_per
    per = max(int(np.bincount(owner, minlength=n_dev).max()), 1)
    out_rows = np.full((n_dev, per), num_rows, np.int32)    # pad: no match
    out_cols = np.full((n_dev, per), 0, np.int32)
    for d in range(n_dev):
        sel = owner == d
        n = int(sel.sum())
        out_rows[d, :n] = rows[sel]
        out_cols[d, :n] = cols[sel] - d * cols_per
    return out_rows.reshape(-1), out_cols.reshape(-1)


# ---------------------------------------------------------------------------
# per-rank stages
# ---------------------------------------------------------------------------

def _windows(mesh: Mesh, codes, K: int, B: int, canonical: bool = False,
             complement=None) -> torch.Tensor:
    """The valid K-windows of a code slab as (L, n) lanes (partition
    kernel), each folded to its canonical form when ``canonical``."""
    codes = np.asarray(codes, np.uint8)
    if codes.shape[0] < K:
        codes = np.concatenate([codes, np.full(K - codes.shape[0],
                                               INVALID_CODE, np.uint8)])
    lanes, count = extract_packed_kmers(
        torch.from_numpy(codes).to(mesh.device), K, B)
    x = lanes[:, :int(count)]
    if canonical:
        rc = packing.reverse_complement(x, K, B, complement)
        x = torch.where(packed.lt(rc, x)[None, :], rc, x)
    return x


def _sort_unique(x: torch.Tensor):
    """Sorted unique columns of x with their multiplicities (sort and
    partition kernels): (lanes (L, n), counts (n,), n)."""
    m = x.shape[1]
    ul, uc, un = bc._sort_unique_ones_body(
        _min1(x), torch.tensor(m, dtype=torch.int32, device=x.device))
    n = int(un)
    return ul[:, :n], uc[:n], n


def _check_member(mesh: Mesh):
    if mesh.rank < 0:
        raise ValueError("this process is not a rank of the mesh")


def build_distributed_count_step(mesh: Mesh, K: int, B: int = 4):
    """A step a rank calls with its own code slab: extract, route to the
    16-bucket owners, sort-unique. Returns (distinct k-mers over all
    ranks, distinct k-mers on this rank)."""
    _check_member(mesh)

    def step(codes) -> Tuple[int, int]:
        x = _windows(mesh, codes, K, B)
        recv, _ = _route(mesh, "count", _owner_of(x, K, B, mesh.size), x)
        _, _, local = _sort_unique(recv)
        total = _all_reduce(mesh, torch.tensor(
            [local], dtype=torch.int64, device=mesh.device))
        return int(total), local

    return step


def build_distributed_collect_step(mesh: Mesh, K: int, B: int = 4,
                                   canonical: bool = False,
                                   complement=(0, 4, 3, 2, 1)):
    """A step a rank calls with its own code slab; returns this rank's
    sorted unique k-mers (canonical forms when ``canonical``), their
    counts summed over all ranks' slabs, and their number. The ranks'
    outputs concatenate in rank order into the sorted whole."""
    _check_member(mesh)

    def step(codes):
        x = _windows(mesh, codes, K, B, canonical, complement)
        recv, _ = _route(mesh, "collect", _owner_of(x, K, B, mesh.size), x)
        return _sort_unique(recv)

    return step


def build_boss_distributed(seqs, k: int, mesh: Mesh,
                           alphabet: Optional[Alphabet] = None,
                           mode: str = "basic",
                           bits_per_count: int = 0) -> Boss:
    """Distributed collection over the mesh, then on every rank the ranks'
    sorted k-mers gathered in rank order and the single-shard finish
    (``build_boss_from_kmers``, without boundary candidates)."""
    alphabet = alphabet or DNA
    bc._check_mode(mode, alphabet)
    _check_member(mesh)
    B = alphabet.bits_per_char
    L = packed.num_lanes(k, B)
    step = build_distributed_collect_step(mesh, k, B, mode != bc.MODE_BASIC,
                                          alphabet.complement)
    ul, uc, _ = step(code_slab(seqs, alphabet, mesh.rank, mesh.size, k))
    rows = _all_gather_rows(mesh, torch.cat([ul.T, uc[:, None]], dim=1))
    n_real = rows.shape[0]
    real = _min1(rows[:, :L].T.contiguous())
    counts = (rows[:, L].contiguous() if n_real else
              torch.zeros((1,), dtype=torch.int32, device=mesh.device))
    return bc.build_boss_from_kmers(
        real, counts, n_real, k, alphabet,
        mode=bc.MODE_CANONICAL if mode == bc.MODE_CANONICAL else
        bc.MODE_BASIC, bits_per_count=bits_per_count)


# ---------------------------------------------------------------------------
# the fully sharded build
# ---------------------------------------------------------------------------

def _empty(L: int, dev) -> torch.Tensor:
    return packed.zeros(0, L, dev)


def _rc_closure(mesh, keys, real, counts, K, B, complement):
    """Canonical mode: each non-palindrome's reverse complement, with its
    count, routed to its owner and merged into the owner's sorted k-mers
    (sort and merge kernels); palindromes double their count."""
    rc = packing.reverse_complement(real, K, B, complement)
    pal = packed.eq(rc, real)
    counts = torch.where(pal, counts * 2, counts)
    rc_r, c_r, _ = _route(mesh, "rc", keys.owner(rc[:, ~pal]), rc[:, ~pal],
                          counts[~pal])
    if rc_r.shape[1] == 0:
        return real, counts
    rc_s, (c_s,) = pmerge.sort_packed(rc_r, c_r)
    if real.shape[1] == 0:
        return rc_s, c_s
    merged, (mc,) = pmerge.merge_sorted(real, rc_s, (counts,), (c_s,))
    return merged, mc


def _dummy_sinks(mesh, keys, real, B):
    """Sink queries (the node keys of the real edges' successors) routed
    by the successor's group key to the rank that holds that node's
    edges, joined there against its real nodes."""
    q_edge = keys.to_next(real)
    q_nodes, _ = _route(mesh, "sink", keys.owner(q_edge),
                        keys.node_key(q_edge))
    if q_nodes.shape[1] == 0:
        return _empty(real.shape[0], real.device)
    return _sink_join(keys.node_key(real), q_nodes, B)


def _dummy_sources(mesh, keys, real):
    """Dummy-1 sources: each node's predecessor target key and the real
    edges' target keys both routed by the shifted target key; the
    verdicts (no incoming edge) routed home by index; the survivors'
    predecessor edges routed to their owners and sorted."""
    L, dev = real.shape[0], real.device
    firsts = keys.node_firsts(real)
    q_tk = keys.target_key(keys.to_prev(real[:, firsts]))
    ref_tk = keys.target_key(real)
    ref_r, _ = _route(mesh, "src_ref", keys.owner(ref_tk, True), ref_tk)
    q_r, idx_r, q_counts = _route(mesh, "src_query", keys.owner(q_tk, True),
                                  q_tk, firsts)
    verdict = _src_join(ref_r, q_r)
    origin = torch.repeat_interleave(
        torch.arange(mesh.size, device=dev),
        torch.tensor(q_counts, dtype=torch.int64, device=dev))
    home, _ = exchange(mesh, "src_home", origin[verdict],
                       idx_r[verdict][:, None])
    keep = torch.sort(home[:, 0].long()).values
    prev = keys.to_prev(real[:, keep])
    src_r, _ = _route(mesh, "src", keys.owner(prev), prev)
    if src_r.shape[1] == 0:
        return _empty(L, dev)
    return pmerge.sort_packed(src_r)[0]


def _dummy_levels(mesh, keys, src, K):
    """Dummy-source levels 2..K-1: each level's distinct nodes stepped back
    one character, routed to their owners and sorted there. Every rank
    runs all K - 2 rounds (their collectives must match)."""
    levels = []
    cur = src
    for _ in range(max(K - 2, 0)):
        prev = keys.to_prev(cur[:, keys.node_firsts(cur)])
        nxt, _ = _route(mesh, "level", keys.owner(prev), prev)
        cur = pmerge.sort_packed(nxt)[0] if nxt.shape[1] else nxt
        if cur.shape[1]:
            levels.append(cur)
    return levels


def build_boss_distributed_full(seqs, k: int, mesh: Mesh,
                                alphabet: Optional[Alphabet] = None,
                                mode: str = "basic",
                                bits_per_count: int = 0) -> Boss:
    """The build with every stage sharded: k-mers routed by sampled
    splitters; on each rank the sort-unique, the rc closure (canonical),
    the dummy sinks and sources by routed joins, the K - 2 dummy levels,
    the merge and the W / last / weights emit ($^K sentinel on rank 0);
    F from the ranks' summed top-character histograms. Every rank
    returns the whole graph, bit-identical to ``build_boss``."""
    alphabet = alphabet or DNA
    bc._check_mode(mode, alphabet)
    _check_member(mesh)
    K, B, n = k, alphabet.bits_per_char, mesh.size
    L = packed.num_lanes(K, B)
    dev = mesh.device
    max_count = (1 << bits_per_count) - 1 if bits_per_count else (1 << 31) - 1
    splitters = sample_splitters(seqs, K, n, alphabet)
    keys = _Keys(splitters[:, :n - 1], K, B, dev)

    x = _windows(mesh, code_slab(seqs, alphabet, mesh.rank, n, K), K, B,
                 mode != bc.MODE_BASIC, alphabet.complement)
    recv, _ = _route(mesh, "collect", keys.owner(x), x)
    del x
    real, counts, _ = _sort_unique(recv)
    del recv
    if mode == bc.MODE_CANONICAL:
        real, counts = _rc_closure(mesh, keys, real, counts, K, B,
                                   alphabet.complement)
    n_real = real.shape[1]
    sinks = _dummy_sinks(mesh, keys, real, B)
    src = _dummy_sources(mesh, keys, real)
    dummies = [d for d in [sinks, src] + _dummy_levels(mesh, keys, src, K)
               if d.shape[1]]
    del sinks, src

    if n_real or dummies or mesh.rank == 0:
        W, last, weights, _, hist, kept = _emit_shard(
            _min1(real), counts if n_real else torch.zeros(
                (1,), dtype=torch.int32, device=dev), n_real, dummies, K, B,
            alphabet.size, max_count, with_sentinel=mesh.rank == 0)
    else:
        W = weights = torch.zeros((0,), dtype=torch.int32, device=dev)
        last = torch.zeros((0,), dtype=torch.bool, device=dev)
        hist = torch.zeros((alphabet.size,), dtype=torch.int64, device=dev)
        kept = _empty(L, dev)
    del real, counts
    hist = _all_reduce(mesh, hist)
    F = torch.cat([hist.new_zeros(1), torch.cumsum(hist, 0)[:-1]]).to(
        torch.int32)
    rows = _all_gather_rows(mesh, torch.cat(
        [kept.T, W[:, None].to(torch.int32), last[:, None].to(torch.int32),
         weights[:, None].to(torch.int32)], dim=1))
    del kept, W, last, weights
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    return Boss.from_arrays(
        k=K - 1, alph_size=alphabet.size, bits_per_char=B,
        W=torch.cat([zero, rows[:, L]]),
        last=torch.cat([zero, rows[:, L + 1]]).to(torch.bool), F=F,
        edge_lanes=rows[:, :L].T.contiguous(),
        weights=torch.cat([zero, rows[:, L + 2]]) if bits_per_count
        else None)


# ---------------------------------------------------------------------------
# column-sharded annotation query
# ---------------------------------------------------------------------------

def build_distributed_query_step(mesh: Mesh, num_rows: int, num_cols: int):
    """Column-sharded annotation query: each rank holds its column shard
    of the COO pairs (``shard_annotation_coo``; rows ``num_rows`` pad),
    sums the weights of the queried rows per local column, and the
    ranks' sums are gathered. Returns a step (rows_sh, cols_sh,
    query_rows sorted, query_weights) -> (num_cols,) int32 counts on
    every rank. (The JAX package's ``nnz_cap`` and ``query_cap`` are its
    static shapes: sizes here are the arguments' own.)"""
    _check_member(mesh)
    cols_per = -(-num_cols // mesh.size)
    dev = mesh.device

    def step(rows_sh, cols_sh, query_rows, query_weights) -> torch.Tensor:
        rows = torch.as_tensor(np.asarray(rows_sh), device=dev).long()
        cols = torch.as_tensor(np.asarray(cols_sh), device=dev).long()
        q = torch.as_tensor(np.asarray(query_rows), device=dev).long()
        qw = torch.as_tensor(np.asarray(query_weights), device=dev).long()
        pos = torch.clamp(torch.searchsorted(q, rows), max=q.shape[0] - 1)
        w = torch.where(q[pos] == rows, qw[pos], 0)
        local = torch.zeros((cols_per,), dtype=torch.int64, device=dev)
        local.index_add_(0, torch.clamp(cols, 0, cols_per - 1), w)
        counts = _all_gather_rows(mesh, local[:, None])[:, 0]
        return counts[:num_cols].to(torch.int32)

    return step
