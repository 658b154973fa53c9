"""Out-of-core BOSS construction: graphs larger than the card, on one card.

Counterpart of ``metagraph_tpu/parallel/outofcore.py``. The reference
builds graphs past its memory by partitioning k-mer space into buckets,
spilling sorted chunks to disk and finishing one bucket at a time
(boss_chunk_construct.cpp:103-356, sorted_set_disk_base.hpp:34). Here
every sort, merge join and emit runs on the device, one shard at a time,
and the whole data set lives on the host between the passes:

  pass 1  input chunks -> device collect (extract, sort, unique) -> sorted
          runs as ``.npy`` files (``_RunStore``)
  split   samples of the runs -> S - 1 group-key splitters. Group keys
          (``h_group_key``) zero the edge label and the first node
          character, so all edges of a node, and all edges sharing a
          (target node, label) pair, land on one shard: the emit's last
          bits, redundant sinks and minus flags stay shard-local
  pass 2  per shard: its slice of every run -> device sort-unique; its
          queries (to_next / node_key / to_prev / target_key) and their
          owners by group key, on the device over the shard just sorted
          (the JAX package makes them on the host in numpy)
  pass 3  per shard: device joins against its sorted keys: the dummy
          sinks (``_sink_join``: membership merge, then the partition
          kernel) and the has-incoming verdicts of the dummy sources
          (``_src_join``)
  host    the verdicts routed home, the dummy-1 sources built, the K - 2
          dummy levels iterated, each step routed to its owner shard
  pass 4  per shard: device merge and emit (``_merge_emit_body``), the
          $^K sentinel row on shard 0 only, its top-character histogram
  final   W / last / weights concatenated, F summed -> Boss (small state
          unless ``keep_kmer_index``)

Target keys route by their owner shifted one field (``_Keys.owner(x,
tkey=True)``, the JAX package's ``h_owner_tkey``, its commits cb1e0b3 and
6c3cac3): a target key's top field is zero, so it would otherwise land
below every splitter on shard 0.

The device holds one shard's data (O(total / n_shards)) plus one pass-1
chunk; the output equals ``build_boss`` of basic mode bit for bit.
Dropped from the JAX package: its capacity classes (one capacity for
every shard, so XLA compiles once) and its staged collect variants.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import device as devmod
from ..common import merge as pmerge
from ..common import packed
from ..graph import boss_construct as bc
from ..graph.boss import Boss
from ..kmer import packing
from ..kmer.alphabets import Alphabet, DNA

LANE_BITS = 32
U32 = np.uint32


# ---------------------------------------------------------------------------
# host helpers over packed lanes (numpy uint32, over columns): the run
# files' group keys, splitters and the spill pack
# ---------------------------------------------------------------------------

def h_get_field(x: np.ndarray, slot: int, B: int) -> np.ndarray:
    L = x.shape[0]
    bit = slot * B
    return (x[L - 1 - bit // LANE_BITS] >> U32(bit % LANE_BITS)) \
        & U32((1 << B) - 1)


def h_group_key(x: np.ndarray, B: int) -> np.ndarray:
    """Fields 0 (label) and 1 (first node char) zeroed: the 2B low bits,
    always inside the last lane (B <= 8)."""
    out = np.array(x, U32)
    out[-1] &= ~U32((1 << (2 * B)) - 1)
    return out


def rec_view(x: np.ndarray):
    """Structured view for lexicographic compares and searches (lane 0
    most significant: the device's colex order)."""
    return np.rec.fromarrays([np.ascontiguousarray(x[j])
                              for j in range(x.shape[0])])


# ---------------------------------------------------------------------------
# the key transforms of query generation
# ---------------------------------------------------------------------------

class _Keys:
    """Query generation on the device (``kmer/packing.py``; the JAX
    package's ``h_*`` numpy transforms): owners by one batched binary
    search over the splitters, the groups by one stable sort of the
    owners, then one copy of each result to the host; sorts by the sort
    kernel."""

    def __init__(self, splitters: np.ndarray, K: int, B: int, dev):
        self.sp = packed.lanes_from_numpy(splitters, dev)
        self.K, self.B, self.dev = K, B, dev
        self.S = splitters.shape[1] + 1
        self.low_mask = packed.to_i32(~((1 << (2 * B)) - 1))

    def load(self, x):
        return (x if isinstance(x, torch.Tensor)
                else packed.lanes_from_numpy(x, self.dev))

    def node_key(self, x):
        return packing.node_key(x, self.B)

    def target_key(self, x):
        return packing.target_key(x, self.B)

    def to_next(self, x):
        return packing.to_next(x, self.K, self.B, 0)

    def to_prev(self, x):
        return packing.to_prev(x, self.K, self.B, 0)

    def node_firsts(self, x):
        """Column indices of each node's first edge (sorted x)."""
        return torch.nonzero(packed.neighbor_ne(
            packing.node_key(x, self.B))).squeeze(1)

    def owner(self, x, tkey: bool = False):
        """Shard owner per column: the number of splitters <= its group
        key; a target key (``tkey``) shifted up one field first."""
        n = x.shape[1]
        if self.S == 1 or n == 0:
            return torch.zeros((n,), dtype=torch.int64, device=self.dev)
        gk = packed.shift_left(x, self.B) if tkey else x.clone()
        gk[-1] &= self.low_mask
        return packed.searchsorted(self.sp, gk, side="right")

    def split(self, x, owners, *extras):
        """Columns of x (and aligned extras) as S per-owner host groups."""
        order = torch.sort(owners, stable=True).indices
        sizes = torch.bincount(owners, minlength=self.S).cpu().numpy()
        xs = packed.lanes_to_numpy(x[:, order])
        es = [e[order].cpu().numpy() for e in extras]
        b = np.concatenate([[0], np.cumsum(sizes)])
        return [(xs[:, b[s]:b[s + 1]],) + tuple(e[b[s]:b[s + 1]] for e in es)
                for s in range(self.S)]

    def sort(self, x):
        return packed.lanes_to_numpy(
            pmerge.sort_packed(packed.lanes_from_numpy(x, self.dev))[0])


# ---------------------------------------------------------------------------
# device stages (per shard)
# ---------------------------------------------------------------------------

def _min1(t: torch.Tensor) -> torch.Tensor:
    """Device lanes, one PAD column when empty (the kernels' operands are
    never empty)."""
    return t if t.shape[1] else packed.full_pad(1, t.shape[0], t.device)


def _sink_join(keys: torch.Tensor, q_nodes: torch.Tensor, B: int
               ) -> torch.Tensor:
    """The dummy sink edges of a shard, sorted: its routed sink queries
    (node keys of the real edges' successors) that match none of its real
    source node keys (sorted ``keys``, which may end in PAD),
    deduplicated. Either side may be empty."""
    q_s, _ = pmerge.sort_packed(_min1(q_nodes))
    vals, is_q, present, is_pad, run_first = bc._merge_membership(
        _min1(keys), q_s)
    keep = is_q & ~present & ~is_pad & run_first
    nodes, n_out, _ = pmerge.partition_compact(vals, keep, vals.shape[1])
    return packed.shift_left(nodes[:, :int(n_out)], B)


def _src_join(ref_tk: torch.Tensor, q_tk: torch.Tensor) -> torch.Tensor:
    """Per query target key (in its input order): True when no real edge
    of the shard has it, i.e. the origin node needs a dummy source. Either
    side may be empty."""
    n_q = q_tk.shape[1]
    if n_q == 0:
        return torch.zeros((0,), dtype=torch.bool, device=q_tk.device)
    ref_s, _ = pmerge.sort_packed(_min1(ref_tk))
    pos = torch.arange(n_q, dtype=torch.int32, device=q_tk.device)
    q_s, (pos_s,) = pmerge.sort_packed(q_tk, pos)
    _, is_q, present, _, _ = bc._merge_membership(ref_s, q_s)
    verdict = torch.empty((n_q,), dtype=torch.bool, device=q_tk.device)
    verdict[pos_s.long()] = ~present[is_q]       # queries keep their order
    return verdict


def _emit_shard(real, counts, n_real, dummy_parts, K, B, alph_size,
                max_count, with_sentinel):
    """One shard's merge and emit; returns device (W, last, weights, real
    mask, top-char histogram, kept lanes) of its kept edges. ``real`` may
    be one PAD column (``n_real`` 0)."""
    kept, n_kept, W, last, _, weights = bc._merge_emit_body(
        real, counts, n_real, dummy_parts, K, B, alph_size, max_count,
        skip_redundant_sinks=True, with_sentinel=with_sentinel)
    nk = int(n_kept)
    kv = kept[:, :nk]
    hist = torch.bincount(packing.top_char(kv, K, B).long(),
                          minlength=alph_size)[:alph_size]
    real_mask = (packing.label(kv, B) != 0) & (packing.first_char(kv, B) != 0)
    return W[:nk], last[:nk], weights[:nk], real_mask, hist, kv


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

class _RunStore:
    """Sorted (lanes, counts) runs on disk as ``.npy`` memmaps."""

    def __init__(self, directory: Optional[str]):
        self.dir = tempfile.mkdtemp(prefix="mtg_ooc_", dir=directory)
        self.runs: List[Tuple[str, Optional[str], int]] = []

    def add(self, lanes: np.ndarray, counts: Optional[np.ndarray]):
        """``counts=None``: a weightless build spills no counts."""
        i = len(self.runs)
        lp = os.path.join(self.dir, f"run{i}.lanes.npy")
        np.save(lp, np.ascontiguousarray(lanes, U32))
        cp = None
        if counts is not None:
            cp = os.path.join(self.dir, f"run{i}.counts.npy")
            np.save(cp, np.ascontiguousarray(counts, np.int32))
        self.runs.append((lp, cp, lanes.shape[1]))

    def load(self, i):
        lp, cp, _ = self.runs[i]
        return (np.load(lp, mmap_mode="r"),
                np.load(cp, mmap_mode="r") if cp is not None else None)

    def cleanup(self):
        shutil.rmtree(self.dir, ignore_errors=True)


def _sample_splitters_from_runs(store: _RunStore, L: int, B: int,
                                n_shards: int, per_run: int = 4096
                                ) -> np.ndarray:
    """(L, <= n_shards - 1) distinct group-key splitters at the quantiles
    of strided samples of every run."""
    samples = []
    for i in range(len(store.runs)):
        lanes, _ = store.load(i)
        n = lanes.shape[1]
        if n:
            samples.append(np.asarray(lanes[:, ::max(n // per_run, 1)]))
    if not samples:
        return np.zeros((L, 0), U32)
    gk = h_group_key(np.concatenate(samples, axis=1), B)
    gs = gk[:, np.argsort(rec_view(gk), kind="stable")]
    qs = [gs[:, (i * gs.shape[1]) // n_shards] for i in range(1, n_shards)]
    sp = np.stack(qs, axis=1) if qs else np.zeros((L, 0), U32)
    if sp.shape[1] > 1:           # empty shards are legal but wasteful
        sp = sp[:, np.concatenate(
            [[True], (sp[:, 1:] != sp[:, :-1]).any(axis=0)])]
    return sp


def _cat(pieces, L: int, dtype=U32) -> np.ndarray:
    if not pieces:
        return np.zeros((L, 0), dtype) if dtype == U32 else np.zeros(0, dtype)
    return np.concatenate(pieces, axis=1 if dtype == U32 else 0)


def build_boss_out_of_core(seqs, k: int, alphabet: Alphabet = DNA,
                           n_shards: int = 8, bits_per_count: int = 0,
                           chunk_codes: int = 1 << 25,
                           tmp_dir: Optional[str] = None,
                           keep_kmer_index: bool = False,
                           verbose: bool = False, return_valid: bool = False,
                           runs: Optional[Sequence[Tuple]] = None,
                           device="cuda"):
    """A basic-mode build whose device working set is O(total / n_shards)
    plus one pass-1 chunk of ``chunk_codes`` characters. Returns a Boss
    without the edge k-mers unless ``keep_kmer_index`` (and, with
    ``return_valid``, the (m,) real-edge mask that
    ``DbgSuccinct.from_boss(valid=)`` takes).

    ``runs``: sorted unique (lanes (L, n) uint32, counts or None) k-mer
    sets that replace pass 1 (the streaming merge of graphs, reference
    boss_merge.cpp:125-300). With ``bits_per_count`` a run without counts
    counts each k-mer once (the JAX package misaligns the counts of such
    a mix, ROADMAP §3.5)."""
    from .streaming import code_chunks
    dev = devmod.resolve(device)
    K, B = k, alphabet.bits_per_char
    L = packed.num_lanes(K, B)
    max_count = (1 << bits_per_count) - 1 if bits_per_count else (1 << 31) - 1
    t_start = time.time()

    def log(msg):
        if verbose:
            print(f"[ooc +{time.time() - t_start:7.1f}s] {msg}",
                  file=sys.stderr, flush=True)

    store = _RunStore(tmp_dir)
    try:
        # ---- pass 1: sorted unique runs on disk --------------------------
        if runs is not None:
            for lanes, counts in runs:
                lanes = np.asarray(lanes, U32)
                if bits_per_count and counts is None:
                    counts = np.ones(lanes.shape[1], np.int32)
                store.add(lanes, counts if bits_per_count else None)
        else:
            for codes in code_chunks(seqs, alphabet, chunk_codes, K):
                ul, uc, n, _ = bc.collect_kmers(
                    (), K, alphabet, extra_codes=codes, device=dev,
                    with_bounds=False)
                store.add(packed.lanes_to_numpy(ul[:, :n]),
                          uc[:n].cpu().numpy() if bits_per_count else None)
        log(f"pass1: {len(store.runs)} runs, "
            f"{sum(r[2] for r in store.runs) / 1e6:.1f}M entries")

        # ---- splitters and each run's shard boundaries -------------------
        splitters = _sample_splitters_from_runs(store, L, B, n_shards)
        S = splitters.shape[1] + 1
        run_bounds = []
        for i in range(len(store.runs)):
            lanes, _ = store.load(i)
            b = np.searchsorted(rec_view(h_group_key(lanes, B)),
                                rec_view(splitters), side="left")
            run_bounds.append(np.concatenate([[0], b, [lanes.shape[1]]]))
        log(f"splitters: {S} shards")
        ops = _Keys(splitters, K, B, dev)

        # ---- pass 2: per-shard sort-unique and its queries ---------------
        shard_lanes: List[np.ndarray] = []
        shard_counts: List[Optional[np.ndarray]] = []
        sinkq = [[] for _ in range(S)]       # node-key queries
        reftk = [[] for _ in range(S)]       # real edges' target keys
        srcq = [[] for _ in range(S)]        # (target key, origin, index)
        for s in range(S):
            parts_l, parts_c = [], []
            for i in range(len(store.runs)):
                lanes, counts = store.load(i)
                lo, hi = run_bounds[i][s], run_bounds[i][s + 1]
                if hi > lo:
                    parts_l.append(np.asarray(lanes[:, lo:hi]))
                    if counts is not None:
                        parts_c.append(np.asarray(counts[lo:hi]))
            if not parts_l:
                shard_lanes.append(np.zeros((L, 0), U32))
                shard_counts.append(None)
                continue
            cat = packed.lanes_from_numpy(np.concatenate(parts_l, axis=1),
                                          dev)
            n_in = cat.shape[1]
            cnt = (torch.from_numpy(np.concatenate(parts_c)).to(dev)
                   if parts_c else torch.zeros((n_in,), dtype=torch.int32,
                                               device=dev))
            ul, uc, un = bc._sort_unique_stage(cat, cnt, n_in)
            del cat, cnt
            n_u = int(un)
            real_d = ul[:, :n_u]
            shard_lanes.append(packed.lanes_to_numpy(real_d))
            shard_counts.append(uc[:n_u].cpu().numpy() if parts_c else None)
            real = ops.load(real_d)
            del ul, uc, real_d
            # sink queries route by the successor edge's group key (the
            # edges out of its target node live there); the payload is
            # the node key the membership join compares
            q_edge = ops.to_next(real)
            for d, (p,) in enumerate(ops.split(ops.node_key(q_edge),
                                               ops.owner(q_edge))):
                sinkq[d].append(p)
            del q_edge
            ref_tk = ops.target_key(real)
            for d, (p,) in enumerate(ops.split(ref_tk,
                                               ops.owner(ref_tk, True))):
                reftk[d].append(p)
            del ref_tk
            idx = ops.node_firsts(real)
            q_tk = ops.target_key(ops.to_prev(real[:, idx]))
            own = ops.owner(q_tk, True)
            for d, (p, pidx) in enumerate(ops.split(q_tk, own, idx)):
                srcq[d].append((p, np.full(p.shape[1], s, np.int32), pidx))
            del real, q_tk, idx
        store.cleanup()
        log(f"pass2: {sum(x.shape[1] for x in shard_lanes) / 1e6:.2f}M "
            f"unique k-mers in {S} shards (largest "
            f"{max(x.shape[1] for x in shard_lanes) / 1e6:.2f}M)")

        # ---- pass 3: device joins ----------------------------------------
        sink_edges: List[np.ndarray] = [np.zeros((L, 0), U32)] * S
        verdicts = [[] for _ in range(S)]    # per origin: (index, verdict)
        for s in range(S):
            qs = _cat(sinkq[s], L)
            sinkq[s] = None
            if qs.shape[1]:
                keys = packing.node_key(
                    packed.lanes_from_numpy(shard_lanes[s], dev), B)
                sink_edges[s] = packed.lanes_to_numpy(_sink_join(
                    keys, packed.lanes_from_numpy(qs, dev), B))
                del keys
            rt = _cat(reftk[s], L)
            reftk[s] = None
            if srcq[s]:
                qt = _cat([p for p, _, _ in srcq[s]], L)
                org = np.concatenate([o for _, o, _ in srcq[s]])
                qidx = np.concatenate([i for _, _, i in srcq[s]])
                verd = _src_join(
                    packed.lanes_from_numpy(rt, dev),
                    packed.lanes_from_numpy(qt, dev)).cpu().numpy()
                for o in np.unique(org):
                    m = org == o
                    verdicts[int(o)].append((qidx[m], verd[m]))
            srcq[s] = None
        log("pass3: membership joins done")

        # ---- the dummy-1 sources routed home, then the levels ------------
        src_home = [[] for _ in range(S)]
        for s in range(S):
            keep = (np.concatenate([i[v] for i, v in verdicts[s]])
                    if verdicts[s] else np.zeros(0, np.int64))
            if len(keep):
                prev = ops.to_prev(ops.load(shard_lanes[s][:, np.sort(keep)]))
                for d, (p,) in enumerate(ops.split(prev, ops.owner(prev))):
                    src_home[d].append(p)
        src_edges = [ops.sort(_cat(p, L)) if p else np.zeros((L, 0), U32)
                     for p in src_home]
        level_edges: List[List[np.ndarray]] = [[] for _ in range(S)]
        cur = src_edges
        for _ in range(max(K - 2, 0)):
            if all(c.shape[1] == 0 for c in cur):
                break
            nxt = [[] for _ in range(S)]
            for s in range(S):
                if cur[s].shape[1] == 0:
                    continue
                c = ops.load(cur[s])
                prev = ops.to_prev(c[:, ops.node_firsts(c)])
                for d, (p,) in enumerate(ops.split(prev, ops.owner(prev))):
                    nxt[d].append(p)
            cur = [ops.sort(_cat(p, L)) if p else np.zeros((L, 0), U32)
                   for p in nxt]
            for s in range(S):
                if cur[s].shape[1]:
                    level_edges[s].append(cur[s])
        log(f"dummies: {sum(x.shape[1] for x in sink_edges)} sinks, "
            f"{sum(x.shape[1] for x in src_edges)} sources, "
            f"{sum(x.shape[1] for lv in level_edges for x in lv)} in levels")

        # ---- pass 4: per-shard merge and emit ----------------------------
        W_parts, last_parts, w_parts, valid_parts, kept_parts = \
            [], [], [], [], []
        hist = np.zeros(alphabet.size, np.int64)
        for s in range(S):
            real, counts = shard_lanes[s], shard_counts[s]
            n_real = real.shape[1]
            dummies = [sink_edges[s], src_edges[s]] + level_edges[s]
            if n_real == 0 and s > 0 and not any(d.shape[1] for d in dummies):
                continue
            real_d = _min1(packed.lanes_from_numpy(real, dev))
            cnt = torch.zeros((real_d.shape[1],), dtype=torch.int32,
                              device=dev)
            if counts is not None:
                cnt[:n_real] = torch.from_numpy(counts).to(dev)
            W, last, w, vreal, h, kept = _emit_shard(
                real_d, cnt, n_real,
                [packed.lanes_from_numpy(d, dev) for d in dummies if
                 d.shape[1]], K, B, alphabet.size, max_count, s == 0)
            W_parts.append(W.cpu().numpy())
            last_parts.append(last.cpu().numpy())
            w_parts.append(w.cpu().numpy())
            valid_parts.append(vreal.cpu().numpy())
            hist += h.cpu().numpy()
            if keep_kmer_index:
                kept_parts.append(packed.lanes_to_numpy(kept))
            del real_d, cnt, kept
            shard_lanes[s] = shard_counts[s] = None
            sink_edges[s] = src_edges[s] = None
            level_edges[s] = None
        log(f"emit: {sum(len(w) for w in W_parts)} edges")
    finally:
        store.cleanup()

    # ---- final assembly --------------------------------------------------
    def dev_cat(parts, dtype):
        return torch.from_numpy(np.concatenate(
            [np.zeros(1, dtype)] + [p.astype(dtype) for p in parts])).to(dev)

    F = np.concatenate([[0], np.cumsum(hist)[:-1]]).astype(np.int32)
    boss = Boss.from_arrays(
        k=K - 1, alph_size=alphabet.size, bits_per_char=B,
        W=dev_cat(W_parts, np.int32), last=dev_cat(last_parts, bool),
        F=torch.from_numpy(F).to(dev),
        edge_lanes=(packed.lanes_from_numpy(np.concatenate(kept_parts,
                                                           axis=1), dev)
                    if keep_kmer_index else None),
        weights=dev_cat(w_parts, np.int32) if bits_per_count else None)
    if return_valid:
        return boss, np.concatenate([np.zeros(1, bool)] + valid_parts)
    return boss


def merge_boss_graphs_out_of_core(graphs, n_shards: int = 8,
                                  bits_per_count: int = 0,
                                  keep_kmer_index: bool = False,
                                  tmp_dir: Optional[str] = None,
                                  verbose: bool = False,
                                  return_valid: bool = False,
                                  device="cuda"):
    """The streaming merge of graphs (reference boss_merge.cpp:125-300):
    each fast-state graph's real edge k-mers are already a sorted run, so
    the merge is the out-of-core finish over those runs: duplicate
    k-mers sum their weights (31 bits when every input is weighted), the
    dummies are made anew, and no k-mer is extracted again."""
    g0 = graphs[0]
    K, alphabet = g0.k, g0.alphabet
    weighted = all(g.boss.weights is not None for g in graphs)
    runs = []
    for g in graphs:
        if g.k != K:
            raise ValueError("merge inputs must share k")
        if g.boss.edge_lanes is None:
            raise ValueError("the streaming merge needs fast-state inputs "
                             "(edge k-mers)")
        lanes = packed.lanes_to_numpy(g.boss.edge_lanes)
        n = lanes.shape[1]
        valid = g.valid_rank.bits_host()[1:n + 1].astype(bool)
        w = (g.boss.weights[1:n + 1].cpu().numpy() if weighted
             else np.ones(n, np.int32))
        runs.append((lanes[:, valid], w[valid].astype(np.int32)))
    return build_boss_out_of_core(
        (), K, alphabet, n_shards=n_shards,
        bits_per_count=31 if weighted else bits_per_count,
        keep_kmer_index=keep_kmer_index, tmp_dir=tmp_dir, verbose=verbose,
        return_valid=return_valid, runs=runs, device=device)
