"""Multi-BRWT: a tree of column groups over one packed bit array.

PyTorch counterpart of ``metagraph_tpu/anno/brwt.py`` (reference
brwt.hpp:18-75, brwt_builders.hpp:18-59, clustering.hpp:27-48). Every
tree node stores, over its parent's support rows, which of them its own
column group touches; a leaf owns one column. All node bitvectors live
in ONE word array (little-endian bits in int32 words, the same bits as
the JAX package's uint32 words) with a node-relative rank per word.

  * Build (on the matrix's device): the per-column row lists come from
    one stable sort by column (``sort_packed``); a group's support is
    the union of its children's (``merge_sorted`` + dedupe by the
    partition kernel); a node's bits mark its support's positions in
    its parent's support (one ``searchsorted``).
  * Column linkage: the similarity of every pair of columns over a
    seeded row subsample is one product ``S = M @ M.T`` of 0/1 float32
    rows on the device (exact below 2^24 rows); ``S`` goes to the host
    and is ordered by the same unstable ``np.argsort`` the JAX package
    uses, so equal similarities tie alike, and the greedy pairing runs
    over that order.
  * Query: a level-synchronous descent. Each level probes every live
    (query, node) pair's bit and in-node rank (word, per-word rank,
    popcount), records leaf hits, and expands the survivors into their
    children, sized exactly from the spawn count.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common import device as devmod
from ..common import merge as pmerge
from ..common import packed
from ..common import telemetry
from .matrix import RowHits, RowSparse, expand_ranges, host_tensor


@dataclass
class BrwtNode:
    """A node under construction: its bits over the parent's support
    (bool tensor), its children, and its column (leaves)."""
    bits: torch.Tensor
    children: List["BrwtNode"]
    column: int = -1

    @property
    def n_local(self) -> int:
        return int(self.bits.shape[0])

    @property
    def num_set(self) -> int:
        return int(self.bits.sum())


def pack_words(bits_list: List[torch.Tensor]):
    """Bits of several nodes -> (words int32, brank int32, word_off int64
    numpy): node i's bits little-endian in words[word_off[i]:word_off[i+1]]
    (at least one word a node), brank the node-relative exclusive rank
    of each word."""
    n_words = np.array([max((b.shape[0] + 31) // 32, 1) for b in bits_list],
                       np.int64)
    word_off = np.concatenate([[0], np.cumsum(n_words)]).astype(np.int64)
    dev = bits_list[0].device
    parts = []
    for b, nw in zip(bits_list, n_words.tolist()):
        parts += [b, torch.zeros((nw * 32 - b.shape[0],), dtype=torch.bool,
                                 device=dev)]
    padded = torch.cat(parts).view(-1, 32)
    words = torch.zeros((padded.shape[0],), dtype=torch.int32, device=dev)
    for j in range(32):                       # bit j of every word
        words |= padded[:, j].to(torch.int32) << j
    pops = padded.sum(dim=1)
    before = torch.cumsum(pops, 0) - pops     # rank before each word
    node_of_word = torch.repeat_interleave(
        torch.arange(len(bits_list), device=dev),
        torch.from_numpy(n_words).to(dev))
    node_base = before[torch.from_numpy(word_off[:-1]).to(dev)]
    brank = (before - node_base[node_of_word]).to(torch.int32)
    return words, brank, word_off


@dataclass
class Brwt(RowHits):
    """Flattened Multi-BRWT. Node 0 is the root (support over all rows);
    nodes are in BFS order, so each node's children are contiguous. The
    tree's shape is host numpy; the words live on the device."""
    parent: np.ndarray           # (M,) int32, -1 for the root
    column: np.ndarray           # (M,) int32, -1 internal
    child_lo: np.ndarray         # (M,) int32
    child_hi: np.ndarray         # (M,) int32
    n_local: np.ndarray          # (M,) int32 support size of the PARENT
    word_off: np.ndarray         # (M + 1,) int64 into words / brank
    words: torch.Tensor          # (W,) int32 holding uint32 bits
    brank: torch.Tensor          # (W,) int32 node-relative exclusive rank
    level_bounds: np.ndarray     # (L + 1,) node index range per level
    num_rows: int
    num_cols: int
    has_values = False

    @property
    def device(self) -> torch.device:
        return self.words.device

    def num_nodes(self) -> int:
        return len(self.parent)

    def num_tree_nodes(self) -> int:
        return len(self.parent)

    def avg_arity(self) -> float:
        internal = self.child_hi > self.child_lo
        n_int = int(internal.sum())
        return float((self.child_hi - self.child_lo)[internal].sum()) \
            / n_int if n_int else 0.0

    @cached_property
    def nnz(self) -> int:
        """Set bits of the leaves (one per matrix entry)."""
        leaf = torch.from_numpy(self.column >= 0).to(self.device)
        node_of_word = torch.repeat_interleave(
            torch.arange(self.num_nodes(), device=self.device),
            torch.from_numpy(np.diff(self.word_off)).to(self.device))
        return int(packed.popcount32(self.words[leaf[node_of_word]]).sum())

    @cached_property
    def _dev(self):
        def t(a):
            return torch.from_numpy(np.asarray(a, np.int64)).to(self.device)
        return (t(self.word_off), t(self.column), t(self.child_lo),
                t(self.child_hi))

    # -- queries -----------------------------------------------------------

    def row_hits(self, rows: torch.Tensor):
        """(query index, column, 1) int64 of every set bit of the given
        rows, by the level descent."""
        with telemetry.span("anno.descent", quiet=True):
            word_off, column, child_lo, child_hi = self._dev
            q = torch.arange(rows.shape[0], device=self.device)
            node = torch.zeros_like(q)
            local = rows.to(torch.int64)
            W = self.words.shape[0]
            hq, hc = [q[:0]], [q[:0]]
            while q.numel():
                wi = torch.clamp(word_off[node] + (local >> 5), 0, W - 1)
                word = packed.as_uint(self.words[wi])
                bitpos = local & 31
                live = ((word >> bitpos) & 1) == 1
                rank = self.brank[wi].to(torch.int64) + packed.popcount32(
                    word & ((1 << bitpos) - 1))
                col = column[node]
                leaf = live & (col >= 0)
                hq.append(q[leaf])
                hc.append(col[leaf])
                spawn = live & (col < 0)
                q, node, rank = q[spawn], node[spawn], rank[spawn]
                owner, child = expand_ranges(child_lo[node], child_hi[node])
                q, node, local = q[owner], child, rank[owner]
            q = torch.cat(hq)
            return q, torch.cat(hc), torch.ones_like(q)

    # -- serialization -----------------------------------------------------

    def to_npz_dict(self) -> dict:
        return {"brwt_shape": np.array([self.num_rows, self.num_cols]),
                "brwt_parent": self.parent,
                "brwt_column": self.column,
                "brwt_child_lo": self.child_lo,
                "brwt_child_hi": self.child_hi,
                "brwt_n_local": self.n_local,
                "brwt_word_off": self.word_off,
                "brwt_words": self.words.cpu().numpy().view(np.uint32),
                "brwt_brank": self.brank.cpu().numpy(),
                "brwt_level_bounds": self.level_bounds}

    @staticmethod
    def from_npz_dict(d, device) -> "Brwt":
        shape = d["brwt_shape"]
        return Brwt(parent=np.asarray(d["brwt_parent"]),
                    column=np.asarray(d["brwt_column"]),
                    child_lo=np.asarray(d["brwt_child_lo"]),
                    child_hi=np.asarray(d["brwt_child_hi"]),
                    n_local=np.asarray(d["brwt_n_local"]),
                    word_off=np.asarray(d["brwt_word_off"]),
                    words=host_tensor(d["brwt_words"], device),
                    brank=host_tensor(d["brwt_brank"], device),
                    level_bounds=np.asarray(d["brwt_level_bounds"]),
                    num_rows=int(shape[0]), num_cols=int(shape[1]))

    def node_bits(self, i: int) -> torch.Tensor:
        """Node i's bitvector as a bool tensor."""
        w = packed.as_uint(self.words[self.word_off[i]:self.word_off[i + 1]])
        shifts = torch.arange(32, device=self.device, dtype=torch.int64)
        bits = ((w[:, None] >> shifts) & 1).reshape(-1)
        return bits[:int(self.n_local[i])].to(torch.bool)


# ---------------------------------------------------------------------------
# flattening (tree -> packed form)
# ---------------------------------------------------------------------------

def flatten_tree(root_bits: torch.Tensor, root_children: List[BrwtNode],
                 num_rows: int, num_cols: int) -> Brwt:
    """BFS-flatten a construction tree into the packed query form (node
    0 is the root, whose bits are its support over all rows)."""
    nodes: List[Tuple[BrwtNode, int, int]] = []      # (node, parent, level)
    queue = [(BrwtNode(bits=root_bits, children=root_children), -1, 0)]
    while queue:
        base = len(nodes)
        nodes.extend(queue)
        queue = [(c, base + i, lvl + 1)
                 for i, (n, _, lvl) in enumerate(queue) for c in n.children]
    M = len(nodes)
    parent = np.array([p for _, p, _ in nodes], np.int32)
    column = np.array([n.column for n, _, _ in nodes], np.int32)
    level = np.array([lvl for _, _, lvl in nodes], np.int32)
    n_local = np.array([n.n_local for n, _, _ in nodes], np.int32)
    child_lo = np.zeros(M, np.int32)
    child_hi = np.zeros(M, np.int32)
    for i in range(1, M):            # BFS order: children are contiguous
        p = parent[i]
        if child_hi[p] == 0:
            child_lo[p] = i
        child_hi[p] = i + 1
    words, brank, word_off = pack_words([n.bits for n, _, _ in nodes])
    n_levels = int(level.max()) + 1
    level_bounds = np.searchsorted(level, np.arange(n_levels + 1))
    return Brwt(parent=parent, column=column, child_lo=child_lo,
                child_hi=child_hi, n_local=n_local, word_off=word_off,
                words=words, brank=brank,
                level_bounds=level_bounds.astype(np.int64),
                num_rows=num_rows, num_cols=num_cols)


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

def _column_rows(matrix: RowSparse) -> List[torch.Tensor]:
    """Each column's rows, ascending: one stable sort of the entries by
    column (the rows ride along)."""
    n = matrix.nnz
    if n == 0:
        empty = torch.zeros((0,), dtype=torch.int32, device=matrix.device)
        return [empty] * matrix.num_cols
    lanes, (rows,) = pmerge.sort_packed(matrix.cols.reshape(1, n),
                                        matrix.rows.contiguous())
    bounds = torch.searchsorted(
        lanes[0], torch.arange(matrix.num_cols + 1, dtype=torch.int32,
                               device=matrix.device)).tolist()
    return [rows[bounds[c]:bounds[c + 1]] for c in range(matrix.num_cols)]


def _union(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Union of two ascending unique int32 row lists: the merge kernel,
    then the duplicates dropped by the partition kernel."""
    if not a.numel() or not b.numel():
        return a if b.numel() == 0 else b
    m, _ = pmerge.merge_sorted(a.view(1, -1), b.view(1, -1))
    keep = packed.neighbor_ne(m)
    out, count, _ = pmerge.partition_compact(m, keep, m.shape[1])
    return out[0, :int(count)]


def subsample_rows(num_rows: int, subsample: int, seed: int = 0
                   ) -> np.ndarray:
    """The linkage's row sample: all rows, or ``subsample`` of them drawn
    without replacement by ``default_rng(seed)``, ascending."""
    if num_rows > subsample:
        rng = np.random.default_rng(seed)
        return np.sort(rng.choice(num_rows, subsample, replace=False))
    return np.arange(num_rows)


def greedy_pairs(M: torch.Tensor) -> List[Tuple[int, int]]:
    """Greedy similarity pairing of the rows of a 0/1 float32 (n, R)
    matrix (reference greedy_matching, clustering.cpp): pairs (i, j),
    i < j, by descending S = M @ M.T, each index used once, until at most
    one is left."""
    n = M.shape[0]
    if n <= 1:
        return []
    S = (M @ M.T).cpu().numpy()
    np.fill_diagonal(S, -1.0)
    ii, jj = np.unravel_index(np.argsort(-S, axis=None), S.shape)
    up = ii < jj
    used = np.zeros(n, bool)
    pairs = []
    for i, j in zip(ii[up].tolist(), jj[up].tolist()):
        if not used[i] and not used[j]:
            pairs.append((i, j))
            used[i] = used[j] = True
            if 2 * len(pairs) >= n - 1:
                break
    return pairs


def greedy_linkage(columns, num_rows: int, subsample: int = 1_000_000,
                   seed: int = 0, device=None) -> List[Tuple[int, int]]:
    """Greedy similarity pairing of columns given as their row lists
    (tensors or numpy arrays): ``greedy_pairs`` over the columns' bits
    on ``subsample_rows(num_rows, subsample, seed)``. Runs on the
    columns' device (``device``, else the card, for numpy columns)."""
    n = len(columns)
    if n <= 1:
        return []
    dev = devmod.resolve(device if device is not None else next(
        (c.device for c in columns if isinstance(c, torch.Tensor)), "cuda"))
    keep = torch.from_numpy(subsample_rows(num_rows, subsample, seed)).to(dev)

    def bits(col) -> torch.Tensor:
        if not isinstance(col, torch.Tensor):
            col = torch.from_numpy(np.asarray(col, np.int64))
        return torch.isin(keep, col.to(device=dev, dtype=torch.int64))

    return greedy_pairs(torch.stack([bits(c) for c in columns])
                        .to(torch.float32))


def _sample_matrix(matrix: RowSparse, keep: np.ndarray) -> torch.Tensor:
    """(num_cols, len(keep)) float32 0/1: column c's bits on the sample."""
    dev = matrix.device
    keep_t = torch.from_numpy(keep).to(dev)
    R = keep_t.shape[0]
    M = torch.zeros((matrix.num_cols, R), dtype=torch.float32, device=dev)
    if R and matrix.nnz:
        rows = matrix.rows.to(torch.int64)
        pos = torch.clamp(torch.searchsorted(keep_t, rows), max=R - 1)
        hit = keep_t[pos] == rows
        M[matrix.cols.to(torch.int64)[hit], pos[hit]] = 1.0
    return M


def compute_linkage(matrix: RowSparse, subsample: int = 1_000_000
                    ) -> List[Tuple[int, int, float, int]]:
    """Column linkage rows ``(child1, child2, dist, merged_id)`` in the
    reference's format (leaves are column ids, merged ids grow past
    num_cols), from level-by-level greedy pairing. A level's sample
    matrix is the OR of its clusters' leaf columns (a union of supports
    is an OR of their bits)."""
    C = matrix.num_cols
    M0 = _sample_matrix(matrix, subsample_rows(matrix.num_rows, subsample))
    ids = list(range(C))
    member = torch.arange(C, device=matrix.device)   # leaf -> cluster
    next_id = C
    out = []
    while len(ids) > 1:
        M = torch.zeros((len(ids), M0.shape[1]), dtype=torch.float32,
                        device=M0.device).index_add_(0, member, M0)
        pairs = greedy_pairs(torch.clamp(M, max=1.0))
        new_ids, new_pos = [], np.zeros(len(ids), np.int64)
        for i, j in pairs:
            out.append((ids[i], ids[j], 0.0, next_id))
            new_pos[i] = new_pos[j] = len(new_ids)
            new_ids.append(next_id)
            next_id += 1
        paired = {x for p in pairs for x in p}
        for i in range(len(ids)):
            if i not in paired:
                new_pos[i] = len(new_ids)
                new_ids.append(ids[i])
        ids = new_ids
        member = torch.from_numpy(new_pos).to(member.device)[member]
    return out


def trees_from_linkage(linkage, num_cols: int):
    """Tree tuples from parsed linkage rows. A merged cluster id may
    appear on several rows (the reference encodes multi-child clusters
    that way): its children accumulate."""
    nodes = {c: ("leaf", c) for c in range(num_cols)}
    for c1, c2, _dist, m in sorted(linkage, key=lambda r: r[3]):
        m = int(m)
        kids = list(nodes[m][1:]) if m in nodes else []
        for c in (int(c1), int(c2)):
            if c not in nodes:
                raise ValueError(f"linkage references unknown cluster {c}")
            kids.append(nodes.pop(c))
        nodes[m] = ("node", *kids)
    return list(nodes.values())


def build_brwt(matrix: RowSparse, subsample: int = 1_000_000,
               linkage: Optional[List[Tuple[int, int, float, int]]] = None
               ) -> Brwt:
    """Bottom-up Multi-BRWT build (BRWTBottomUpBuilder semantics):
    greedy column pairing level by level (or a given ``linkage``) into
    one tree, then flattened. The greedy path is ``compute_linkage``
    plus the tree of it, so a linkage file written by ``--linkage``
    rebuilds the same tree."""
    num_rows, num_cols = matrix.num_rows, matrix.num_cols
    col_rows = _column_rows(matrix)
    if linkage is None and num_cols > 1:
        linkage = compute_linkage(matrix, subsample)
    trees = trees_from_linkage(linkage or [], num_cols)
    while len(trees) > 1:         # a forest: join the roots pairwise
        trees = [("node", *trees[i:i + 2]) if i + 1 < len(trees)
                 else trees[i] for i in range(0, len(trees), 2)]
    root_support = torch.unique_consecutive(matrix.rows)
    root_bits = torch.zeros((num_rows,), dtype=torch.bool,
                            device=matrix.device)
    root_bits[root_support.to(torch.int64)] = True
    supports: Dict[int, torch.Tensor] = {}

    def support(tree) -> torch.Tensor:
        if id(tree) not in supports:
            if tree[0] == "leaf":
                s = col_rows[tree[1]]
            else:
                s = root_support[:0]
                for t in tree[1:]:
                    s = _union(s, support(t))
            supports[id(tree)] = s
        return supports[id(tree)]

    def build_node(tree, parent_support: torch.Tensor) -> BrwtNode:
        s = support(tree)
        bits = torch.zeros((parent_support.shape[0],), dtype=torch.bool,
                           device=matrix.device)
        bits[torch.searchsorted(parent_support, s)] = True
        if tree[0] == "leaf":
            return BrwtNode(bits=bits, children=[], column=tree[1])
        return BrwtNode(bits=bits, children=[build_node(t, s)
                                             for t in tree[1:]])

    root_tree = trees[0]
    kids = [root_tree] if root_tree[0] == "leaf" else root_tree[1:]
    return flatten_tree(root_bits, [build_node(t, root_support)
                                    for t in kids], num_rows, num_cols)


def relax_brwt(brwt: Brwt, max_arity: int = 8) -> Brwt:
    """Arity relaxation (reference BRWTOptimizer, the ``relax_brwt``
    command): an internal child is replaced by its children while the
    node's arity stays within ``max_arity``, their bits lifted into the
    node's support."""
    def rebuild(i: int) -> BrwtNode:
        return BrwtNode(bits=brwt.node_bits(i),
                        children=[rebuild(j) for j in range(
                            brwt.child_lo[i], brwt.child_hi[i])],
                        column=int(brwt.column[i]))

    def relax(node: BrwtNode) -> BrwtNode:
        node.children = [relax(c) for c in node.children]
        changed = True
        while changed:
            changed = False
            for i, c in enumerate(node.children):
                if c.column < 0 and c.children and \
                        len(node.children) - 1 + len(c.children) <= max_arity:
                    set_pos = torch.nonzero(c.bits).squeeze(1)
                    lifted = []
                    for gc in c.children:
                        bits = torch.zeros_like(c.bits)
                        bits[set_pos] = gc.bits
                        lifted.append(BrwtNode(bits=bits,
                                               children=gc.children,
                                               column=gc.column))
                    node.children = (node.children[:i] + lifted
                                     + node.children[i + 1:])
                    changed = True
                    break
        return node

    root = relax(rebuild(0))
    return flatten_tree(root.bits, root.children, brwt.num_rows,
                        brwt.num_cols)
