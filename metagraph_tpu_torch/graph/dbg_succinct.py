"""DBGSuccinct: the node-level de Bruijn graph over a BOSS table.

PyTorch counterpart of ``metagraph_tpu/graph/dbg_succinct.py``. A DBG
node of k-mer size k is a BOSS edge; dummy edges (holding ``$``) are
masked out of the node index space by a rank over the valid-edge mask,
so node ids run 1..num_nodes. ``map_codes_to_nodes`` maps every window
of a code array with one batched search. A small-state graph (no edge
k-mers) searches, walks and decodes by rank/select alone:
``map_read_batch`` anchors each read with one k-step search and then
follows the BOSS fwd transition window by window.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..common import packed
from ..common import telemetry
from ..common.ranksel import BitRank
from ..kmer import packing
from ..kmer.alphabets import Alphabet, DNA
from ..kmer.extractor import encode_sequences, window_validity
from .boss import Boss

MODE_BASIC = "basic"
MODE_CANONICAL = "canonical"
MODE_PRIMARY = "primary"     # one orientation per k-mer pair (canonical.py)


@dataclass(frozen=True)
class DbgSuccinct:
    boss: Boss
    alphabet: Alphabet
    mode: str
    valid_rank: BitRank          # over (m,) incl. sentinel row 0

    @staticmethod
    def from_boss(boss: Boss, alphabet: Alphabet = DNA,
                  mode: str = MODE_BASIC,
                  valid: Optional[torch.Tensor] = None) -> "DbgSuccinct":
        """``valid``: (m,) bool real-edge mask incl. sentinel row 0;
        derived from edge_lanes when absent."""
        if mode not in (MODE_BASIC, MODE_CANONICAL, MODE_PRIMARY):
            raise NotImplementedError(f"{mode} graphs are not yet ported")
        if valid is None:
            if boss.edge_lanes is None:
                raise ValueError("small-state graphs need an explicit "
                                 "valid-edge mask")
            is_dummy = packing.contains_sentinel(
                boss.edge_lanes, boss.K, alphabet.bits_per_char)
            valid = torch.cat([torch.zeros((1,), dtype=torch.bool,
                                           device=is_dummy.device),
                               ~is_dummy])
        return DbgSuccinct(boss=boss, alphabet=alphabet, mode=mode,
                           valid_rank=BitRank.build(valid))

    @property
    def k(self) -> int:
        return self.boss.K

    @property
    def device(self) -> torch.device:
        return self.boss.device

    def num_nodes(self) -> int:
        return int(self.valid_rank.num_set)

    def num_anno_rows(self) -> int:
        """Rows of an annotation of this graph: one per node."""
        return self.num_nodes()

    def node_to_anno_row(self, nodes: np.ndarray) -> np.ndarray:
        """Annotation row of each (present) node id: node - 1."""
        return np.asarray(nodes).astype(np.int64) - 1

    def edge_to_node(self, edge: torch.Tensor) -> torch.Tensor:
        """BOSS edge row -> DBG node id (0 if dummy or absent)."""
        return torch.where((edge > 0) & self.valid_rank.bit(edge),
                           self.valid_rank.rank1(edge), 0)

    def node_to_edge(self, node: torch.Tensor) -> torch.Tensor:
        """DBG node id -> BOSS edge row (0 for node 0)."""
        return torch.where(node > 0, self.valid_rank.select1(node), 0)

    def node_lanes(self, node: torch.Tensor) -> torch.Tensor:
        """Packed edge k-mers of a node batch (fast state; a small-state
        graph decodes through ``node_kmers_chars``)."""
        if self.boss.edge_lanes is None:
            raise NotImplementedError(
                "packed node k-mers of a small-state graph: the JAX package "
                "has none either (graph/dbg_succinct.py node_lanes)")
        edge = self.node_to_edge(node)
        return self.boss.edge_lanes[:, torch.clamp(edge - 1, min=0)]

    def map_codes_to_nodes(self, codes: torch.Tensor) -> torch.Tensor:
        """Node id of every k-window of a code array (0 = absent or
        invalid window); (len(codes) - k + 1,) int64."""
        K = self.k
        B = self.alphabet.bits_per_char
        ok = window_validity(codes, K)
        lanes = packing.pack_windows(codes, K, B)
        if self.mode in (MODE_CANONICAL, MODE_PRIMARY):
            rc = packing.reverse_complement(lanes, K, B,
                                            self.alphabet.complement)
            lanes = torch.where(packed.lt(rc, lanes)[None, :], rc, lanes)
        nodes = self.edge_to_node(self.boss.map_to_edges(lanes))
        return torch.where(ok, nodes, 0)

    def map_to_nodes(self, seq: bytes | str) -> np.ndarray:
        """Node ids of the windows of one sequence, on the host."""
        codes = encode_sequences([seq], self.alphabet)[:-1]  # no separator
        n = len(codes)
        if n < self.k:
            return np.zeros((max(0, n - self.k + 1),), np.int32)
        out = self.map_codes_to_nodes(
            torch.from_numpy(codes).to(self.device))
        return out.cpu().numpy().astype(np.int32)

    # -- small state: the incremental walk ----------------------------------

    def _node_range(self, T: torch.Tensor, valid: torch.Tensor):
        """(lo, ru): the inclusive edge-row range of BOSS node T."""
        R = T.shape[0]
        Tc = torch.clamp(T, min=1)
        sl = self.boss.select_last(torch.cat([Tc, torch.clamp(Tc - 1, min=1)]))
        return (torch.where(T > 1, sl[R:] + 1, 1),
                torch.where(valid, sl[:R], 0))

    def _map_reads_small_walk(self, chars2d: torch.Tensor, rounds: int = 2):
        """Small-state read mapping: anchor the first unresolved window of
        each read with ONE k-step search, then follow the BOSS fwd
        transition window by window, carrying each read's edge-row range
        (its node's). A step is one fused rank_W call (4 queries a read) and
        one fused select_last call (2 a read); one batched select_W at
        the end materializes the walked rows. Absent windows are known
        zeros; a window after an absent one re-anchors in the next round.
        Returns (nodes (R, nw), known (R, nw), n_unknown)."""
        boss = self.boss
        K = self.k
        R, Lr = chars2d.shape
        nw = Lr - K + 1
        alph = self.alphabet.size
        dev = chars2d.device
        chars2d = chars2d.to(torch.int64)
        bad = ((chars2d < 1) | (chars2d >= alph)).to(torch.int32)
        pref = torch.cat([torch.zeros((R, 1), dtype=torch.int32, device=dev),
                          torch.cumsum(bad, 1, dtype=torch.int32)], dim=1)
        win_ok = (pref[:, K:] - pref[:, :-K]) == 0        # (R, nw)
        zeros = torch.zeros((R, nw), dtype=torch.int64, device=dev)
        edges = zeros.clone()                # anchor-resolved rows
        rsel = zeros.clone()                 # walk-resolved: W rank
        ssel = torch.ones_like(zeros)        # walk-resolved: W symbol
        via_walk = torch.zeros((R, nw), dtype=torch.bool, device=dev)
        known = ~win_ok                      # invalid windows: known 0
        rows = torch.arange(R, device=dev)
        offs = torch.arange(K, device=dev)
        for _ in range(rounds):
            unk = ~known
            has = torch.any(unk, dim=1)
            a = torch.argmax(unk.to(torch.int8), dim=1)
            ach = chars2d[rows[:, None], torch.clamp(a[:, None] + offs,
                                                     max=Lr - 1)]
            e_a = torch.where(has, boss.index_edge_ranksel(ach), 0)
            edges[rows, a] = torch.where(has, e_a, edges[rows, a])
            via_walk[rows, a] = via_walk[rows, a] & ~has
            known[rows, a] = known[rows, a] | has
            # the anchor's carry: the target node of e_a and its range
            cp = torch.clamp(boss.get_W(torch.clamp(e_a, min=1)) % alph,
                             0, alph - 1).long()
            T_a = torch.where(e_a > 0, boss.NF[cp] + boss.rank_W(e_a, cp), 0)
            lo_a, ru_a = self._node_range(T_a, e_a > 0)
            aT, aLo, aRu = zeros.clone(), zeros.clone(), zeros.clone()
            aT[rows, a] = torch.where(has, T_a, 0)
            aLo[rows, a] = lo_a
            aRu[rows, a] = ru_a
            aSet = torch.zeros_like(via_walk)
            aSet[rows, a] = has
            lo, ru = aLo[:, 0], aRu[:, 0]
            live = aSet[:, 0] & (aT[:, 0] > 0)
            res_w = torch.zeros_like(via_walk)
            abs_w = torch.zeros_like(via_walk)
            for p in range(1, nw):
                c = torch.clamp(chars2d[:, K - 1 + p], 1, alph - 1)
                active = live & ~known[:, p] & win_ok[:, p]
                rk = boss.rank_W(torch.cat([ru, lo - 1, ru, lo - 1]),
                                 torch.cat([c, c, c + alph, c + alph]))
                rhc, rlc = rk[:R], rk[R:2 * R]
                rhf, rlf = rk[2 * R:3 * R], rk[3 * R:]
                pres_c = rhc > rlc
                present = pres_c | (rhf > rlf)
                resolved = active & present
                res_w[:, p] = resolved
                abs_w[:, p] = active & ~present
                rsel[:, p] = torch.where(resolved, torch.where(
                    pres_c, rhc, rhf), rsel[:, p])
                ssel[:, p] = torch.where(resolved, torch.where(
                    pres_c, c, c + alph), ssel[:, p])
                # the target node (the flagged edge's unflagged twin sits
                # before lo, so rank_W(ru, c) names it either way)
                T2 = boss.NF[c] + rhc
                lo2, ru2 = self._node_range(T2, resolved)
                s_a = aSet[:, p]
                live = (s_a & (aT[:, p] > 0)) | resolved
                lo = torch.where(s_a, aLo[:, p], lo2)
                ru = torch.where(s_a, aRu[:, p], ru2)
            via_walk = via_walk | res_w
            known = known | res_w | abs_w
        e_w = boss.select_W(torch.clamp(rsel.reshape(-1), min=1),
                            ssel.reshape(-1)).reshape(R, nw)
        edges = torch.where(via_walk, e_w, edges)
        n_unknown = torch.sum(~known)
        nodes = torch.where(win_ok & known & (edges > 0),
                            self.edge_to_node(edges), 0)
        return nodes, known, n_unknown

    def map_read_batch(self, reads) -> list:
        """Node ids per read of a batch: the small-state walk; a
        fast-state graph maps each read by the flat search. Windows the
        walk leaves unresolved (miss-heavy reads) resolve in ONE batched
        k-step search. Returns a list of (len(read) - k + 1,) arrays."""
        k = self.k
        if self.boss.edge_lanes is not None or not reads:
            return [self.map_to_nodes(r) for r in reads]
        Lmax = max(max(len(r) for r in reads), k)
        tbl = self.alphabet.encode_table()
        chars = np.zeros((len(reads), Lmax), np.uint8)   # 0 = invalid pad
        for i, r in enumerate(reads):
            cs = (r if isinstance(r, np.ndarray)
                  else tbl[np.frombuffer(bytes(r), np.uint8)])
            chars[i, :len(cs)] = np.where(cs == 255, 0, cs)
        nodes, known, n_unk = self._map_reads_small_walk(
            torch.from_numpy(chars).to(self.device))
        nodes = nodes.cpu().numpy().astype(np.int32)
        if int(n_unk):
            known_np = known.cpu().numpy()
            nw_arr = np.array([max(0, len(r) - k + 1) for r in reads])
            col = np.arange(known_np.shape[1])
            ui, uj = np.nonzero(~known_np & (col[None, :] < nw_arr[:, None]))
            if len(ui):
                wins = chars[ui[:, None], uj[:, None] + np.arange(k)[None, :]]
                nodes[ui, uj] = self._resolve_windows(
                    torch.from_numpy(wins).to(self.device)).cpu().numpy()
        return [nodes[i, :max(0, len(r) - k + 1)]
                for i, r in enumerate(reads)]

    def _resolve_windows(self, wchars: torch.Tensor) -> torch.Tensor:
        """Node ids of a flat (U, k) batch of char windows by the
        rank/select search (invalid chars -> 0)."""
        return self.edge_to_node(self.boss.index_edge_ranksel(wchars))

    # -- adjacency ---------------------------------------------------------

    def _adjacent(self, nodes: torch.Tensor, shifted, set_slot: int
                  ) -> torch.Tensor:
        """(N, sigma-1) node ids of the k-mers ``shifted`` with field
        ``set_slot`` set to each char c in 1..sigma-1 (0 = absent)."""
        B = self.alphabet.bits_per_char
        cols = []
        for c in range(1, self.alphabet.size):
            q = packed.set_field(
                shifted, set_slot,
                torch.full((shifted.shape[1],), c, dtype=packed.LANE_DTYPE,
                           device=shifted.device), B)
            cols.append(self.edge_to_node(self.boss.map_to_edges(q)))
        out = torch.stack(cols, dim=1)
        return torch.where((nodes > 0)[:, None], out, 0)

    def _pick_edges(self, lo: torch.Tensor, ru: torch.Tensor):
        """(Q, sigma-1): the row of the edge labelled c (unflagged, else
        flagged) among each node's rows [lo, ru], 0 if none, for every c
        in 1..sigma-1 (the reference's pick_edge, every label in one
        fused rank_W and one fused select_W call)."""
        boss = self.boss
        alph = self.alphabet.size
        S = alph - 1
        n = lo.shape[0] * S
        c = torch.arange(1, alph, device=lo.device).repeat(lo.shape[0])
        cc = torch.cat([c, c + alph])
        ru2 = ru.repeat_interleave(S).repeat(2)
        lo2 = lo.repeat_interleave(S).repeat(2)
        rr = boss.rank_W(ru2, cc)
        pos = boss.select_W(torch.clamp(rr, min=1), cc)
        hit = torch.where((rr >= 1) & (pos >= lo2), pos, 0)
        return torch.where(hit[:n] > 0, hit[:n], hit[n:]).reshape(-1, S)

    def _adjacent_ranksel(self, nodes: torch.Tensor, forward: bool
                          ) -> torch.Tensor:
        """Small-state adjacency by BOSS navigation (the JAX package
        decodes each node by the bwd walk and runs sigma - 1 k-step
        searches; this finds the same edges in a fixed handful of
        rank/select calls). Successors: fwd to the target node, then the
        edge of each label among its rows. Predecessors: the incoming
        edges of the source node (bwd's first, then the flagged edges of
        the same label up to the next unflagged one), each placed at the
        first char of its own source node, found k - 2 bwd steps back."""
        boss = self.boss
        alph = self.alphabet.size
        S = alph - 1
        ok = nodes > 0
        e = torch.clamp(self.node_to_edge(nodes), min=1)
        if forward:
            a = (boss.get_W(e) % alph).long()
            lo, ru = self._node_range(boss.NF[a] + boss.rank_W(e, a), ok)
            out = self.edge_to_node(self._pick_edges(lo, ru))
            return torch.where(ok[:, None], out, 0)
        c = boss.get_node_last_value(e).long()     # the incoming label
        j0 = boss.bwd(e)
        m = boss.num_edges
        r_un = boss.rank_W(j0, c)
        total = boss.rank_W(torch.full_like(c, m), c)
        nxt = torch.where(r_un < total, boss.select_W(r_un + 1, c), m + 1)
        rf0 = boss.rank_W(j0, c + alph)
        n_flag = boss.rank_W(nxt - 1, c + alph) - rf0
        i = torch.arange(1, S, device=e.device)
        flagged = boss.select_W(
            torch.clamp(rf0[:, None] + i, min=1).reshape(-1),
            (c + alph).repeat_interleave(S - 1)).reshape(-1, S - 1)
        rows = torch.cat([j0[:, None], flagged], dim=1)       # (Q, S)
        valid = torch.cat([torch.ones_like(ok)[:, None],
                           i[None, :] <= n_flag[:, None]], dim=1)
        x = rows.reshape(-1)
        for _ in range(self.k - 2):
            x = boss.bwd(x)
        first = boss.get_node_last_value(x).reshape(rows.shape)
        valid = valid & ok[:, None] & (first >= 1)
        src = self.edge_to_node(rows)
        out = torch.zeros_like(src)
        q = torch.arange(rows.shape[0], device=e.device)[:, None].expand_as(
            rows)
        out[q[valid], first[valid].long() - 1] = src[valid]
        return out

    def successors(self, nodes: torch.Tensor) -> torch.Tensor:
        """(N, sigma-1) node ids of the successors (0-padded), one column
        per next character c in 1..sigma-1."""
        if self.boss.edge_lanes is None:
            return self._adjacent_ranksel(nodes, forward=True)
        lanes = self.node_lanes(nodes)
        shifted = packing.to_next(lanes, self.k, self.alphabet.bits_per_char,
                                  0)
        return self._adjacent(nodes, shifted, 0)

    def predecessors(self, nodes: torch.Tensor) -> torch.Tensor:
        """(N, sigma-1) node ids of the predecessors (0-padded), one column
        per first character c in 1..sigma-1."""
        if self.boss.edge_lanes is None:
            return self._adjacent_ranksel(nodes, forward=False)
        lanes = self.node_lanes(nodes)
        shifted = packing.to_prev(lanes, self.k, self.alphabet.bits_per_char,
                                  0)
        return self._adjacent(nodes, shifted, 1)

    def outdegree(self, nodes: torch.Tensor) -> torch.Tensor:
        return torch.sum(self.successors(nodes) > 0, dim=1)

    def indegree(self, nodes: torch.Tensor) -> torch.Tensor:
        return torch.sum(self.predecessors(nodes) > 0, dim=1)

    # -- node decoding -----------------------------------------------------

    def node_chars(self, nodes: torch.Tensor) -> torch.Tensor:
        """(N, k) char codes of the node k-mers, on the graph's device:
        uint8 from the packed k-mers, int32 from the small state's bwd
        walk."""
        if self.boss.edge_lanes is None:
            return self.boss.node_chars_ranksel(self.node_to_edge(nodes))
        return packing.unpack_to_chars(self.node_lanes(nodes), self.k,
                                       self.alphabet.bits_per_char)

    def node_kmers_chars(self, nodes) -> np.ndarray:
        """``node_chars`` on the host (the dtypes the JAX package gives)."""
        return self.node_chars(torch.as_tensor(
            np.asarray(nodes, np.int64), device=self.device)).cpu().numpy()

    def node_sequence(self, node: int) -> str:
        return self.alphabet.decode(self.node_kmers_chars([node])[0])


# codes per mapping call of ``map_sequences``: bounds its temporaries
_MAP_CHUNK = 1 << 24


def map_sequences(graph, seqs) -> list:
    """Node ids of the windows of each sequence (what ``map_to_nodes``
    gives for each), from one ``map_codes_to_nodes`` call per chunk of
    about 2^24 codes: the sequences are concatenated with one INVALID
    separator each, so no window straddles two. ``graph`` is a
    ``DbgSuccinct`` or a ``CanonicalDbg``."""
    k = graph.k
    out = []
    i = 0
    while i < len(seqs):
        j, size = i, 0
        while j < len(seqs) and (j == i or size + len(seqs[j]) < _MAP_CHUNK):
            size += len(seqs[j]) + 1
            j += 1
        batch = seqs[i:j]
        codes = encode_sequences(batch, graph.alphabet)
        if len(codes) >= k:
            with telemetry.span("map.search", quiet=True):
                found = graph.map_codes_to_nodes(
                    torch.from_numpy(codes).to(graph.device)).cpu()
            nodes = found.numpy().astype(np.int32)
        else:
            nodes = np.zeros(0, np.int32)
        off = 0
        for s in batch:
            out.append(nodes[off:off + max(0, len(s) - k + 1)])
            off += len(s) + 1
        i = j
    return out
