"""The BOSS table as dense device tensors with batched navigation.

PyTorch counterpart of ``metagraph_tpu/graph/boss.py``. The logical
arrays are the reference's

    W    : edge labels, +alph_size "minus" flags on non-representative
           incoming edges
    last : 1 marks the final outgoing edge of each source node
    F[c] : #edges whose source node ends in a char < c

held inside blocked rank structures (``common/ranksel.py``), plus the
sorted packed edge k-mers (``edge_lanes``) as a search accelerator:
``map_to_edges`` is one batched binary search over them, narrowed by a
table of bucket starts over the top 16 bits (``lut``). A small-state
table (no ``edge_lanes``) searches by rank/select alone: the
reference's range tightening, one fused ``rank_W`` and one fused
``select_last`` call per character (``index_edge_ranksel``,
``suffix_range_ranksel``), and decodes rows by the backward walk
(``node_chars_ranksel``). Indexing is 1-based over edges; row 0 is a
sentinel and index 0 means "absent".
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..common import packed
from ..common.ranksel import BitRank, SymbolRank
from ..kmer import packing


@dataclass(frozen=True)
class Boss:
    k: int                      # node length (edge k-mer has k+1 chars)
    alph_size: int
    bits_per_char: int
    F: torch.Tensor             # (alph_size,) int32
    last_rank: BitRank
    W_rank: SymbolRank
    NF: torch.Tensor            # (alph_size,) int32: rank_last(F[c])
    edge_lanes: Optional[torch.Tensor] = None   # (L, m-1) sorted edge k-mers
    weights: Optional[torch.Tensor] = None      # (m,) int32 k-mer counts
    lut: Optional[torch.Tensor] = None          # (2^16+1,) bucket starts
    lut_steps: int = 0                          # search rounds per bucket

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_arrays(k: int, alph_size: int, bits_per_char: int,
                    W: torch.Tensor, last: torch.Tensor, F: torch.Tensor,
                    edge_lanes: Optional[torch.Tensor] = None,
                    weights: Optional[torch.Tensor] = None) -> "Boss":
        """From full-length W / last (row 0 included) and F."""
        F = F.to(torch.int32)
        last_rank, W_rank, NF = _finalize_ranks(
            W.to(torch.int32), last.to(torch.bool), F, sigma=2 * alph_size)
        if edge_lanes is not None and edge_lanes.shape[1] > 0:
            lut, max_bucket = _build_lut(edge_lanes, edge_lanes.shape[1])
            lut_steps = max(1, int(np.ceil(np.log2(int(max_bucket) + 1))))
        else:
            lut, lut_steps = None, 0
        return Boss(k=k, alph_size=alph_size, bits_per_char=bits_per_char,
                    F=F, last_rank=last_rank, W_rank=W_rank, NF=NF,
                    edge_lanes=edge_lanes, weights=weights,
                    lut=lut, lut_steps=lut_steps)

    @staticmethod
    def from_finish(k: int, alph_size: int, bits_per_char: int,
                    kept: torch.Tensor, W: torch.Tensor, last: torch.Tensor,
                    F: torch.Tensor, n_kept: int,
                    weights: Optional[torch.Tensor] = None,
                    lut: Optional[torch.Tensor] = None,
                    max_bucket: Optional[int] = None) -> "Boss":
        """From the construction finish buffers: slice to ``n_kept``, add
        the sentinel row, build the ranks; ``lut``/``max_bucket`` come
        from the finish."""
        dev = W.device
        zero = torch.zeros((1,), dtype=torch.int32, device=dev)
        W_full = torch.cat([zero, W[:n_kept].to(torch.int32)])
        last_full = torch.cat([zero.to(torch.bool), last[:n_kept]])
        w_full = (torch.cat([zero, weights[:n_kept].to(torch.int32)])
                  if weights is not None else None)
        F = F.to(torch.int32)
        last_rank, W_rank, NF = _finalize_ranks(W_full, last_full, F,
                                                sigma=2 * alph_size)
        lanes = kept[:, :n_kept] if n_kept > 0 else None
        if lut is not None and n_kept > 0:
            lut_steps = max(1, int(np.ceil(np.log2(max_bucket + 1))))
        else:
            lut, lut_steps = None, 0
        return Boss(k=k, alph_size=alph_size, bits_per_char=bits_per_char,
                    F=F, last_rank=last_rank, W_rank=W_rank, NF=NF,
                    edge_lanes=lanes, weights=w_full,
                    lut=lut, lut_steps=lut_steps)

    # -- basic accessors ---------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.F.device

    @property
    def W(self) -> torch.Tensor:
        """(m,) int8 W array (stored inside W_rank)."""
        return self.W_rank.seq

    @property
    def last(self) -> torch.Tensor:
        """(m,) bool last bits (host-materialized from the packed words)."""
        return torch.from_numpy(self.last_rank.bits_host())

    @property
    def num_edges(self) -> int:
        return self.W_rank.n_seq - 1

    def num_nodes(self) -> torch.Tensor:
        return self.last_rank.num_set

    @property
    def K(self) -> int:
        """Edge k-mer length."""
        return self.k + 1

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def get_W(self, i) -> torch.Tensor:
        return self.W_rank[torch.clamp(self._t(i), 0, self.W_rank.n_seq - 1)]

    def get_last(self, i) -> torch.Tensor:
        """last[i] as bool (False outside [0, m])."""
        return self.last_rank.bit(self._t(i))

    # -- rank / select (the reference's 1-based semantics) ------------------

    def rank_last(self, i) -> torch.Tensor:
        """#set bits in last[1..i] (last[0] is 0)."""
        return self.last_rank.rank1(self._t(i))

    def select_last(self, r) -> torch.Tensor:
        return self.last_rank.select1(self._t(r))

    def succ_last(self, i) -> torch.Tensor:
        """Smallest j >= i with last[j] set, else m + 1."""
        return self.last_rank.next1(self._t(i))

    def pred_last(self, i) -> torch.Tensor:
        """Largest j <= i with last[j] set, else 0."""
        i = self._t(i)
        p = self.last_rank.prev1(torch.clamp(i, min=0))
        return torch.where((i <= 0) | (p >= self.last_rank.n), 0, p)

    def rank_W(self, i, c) -> torch.Tensor:
        """#occurrences of c in W[1..i] (W[0] = 0 excluded)."""
        i, c = self._t(i), self._t(c)
        r = self.W_rank.rank(c, i)
        return r - torch.where((c == 0) & (i >= 0), 1, 0)

    def select_W(self, r, c) -> torch.Tensor:
        """Position of the r-th occurrence of c in W[1..]."""
        r, c = self._t(r), self._t(c)
        return self.W_rank.select(c, r + (c == 0).to(r.dtype))

    def succ_W(self, i, c) -> torch.Tensor:
        """Smallest j >= i (j >= 1) with W[j] == c, else num_edges + 1."""
        i, c = self._t(i), self._t(c)
        m = self.num_edges
        total = self.rank_W(torch.full_like(c, m), c)
        r = self.rank_W(i - 1, c) + 1
        return torch.where(r <= total, self.select_W(r, c), m + 1)

    # -- navigation --------------------------------------------------------

    def get_node_last_value(self, i) -> torch.Tensor:
        """Last character of the source node of edge i (by F offsets)."""
        i = self._t(i)
        c = torch.searchsorted(self.F, i.to(torch.int32).contiguous(),
                               right=False) - 1
        return torch.where(i == 0, 0, torch.clamp(c, 0, self.alph_size - 1))

    def fwd(self, i, c) -> torch.Tensor:
        """Edge row of the target node of edge i (label c, unflagged)."""
        i, c = self._t(i), self._t(c)
        return self.select_last(self.NF[c.long()] + self.rank_W(i, c))

    def bwd(self, i) -> torch.Tensor:
        """Row of the first incoming edge of the source node of edge i."""
        i = self._t(i)
        target_node = self.rank_last(i - 1) + 1
        c = self.get_node_last_value(i)
        res = self.select_W(target_node - self.NF[c.long()], c)
        return torch.where(target_node == 1, 1, res)

    # -- searching ---------------------------------------------------------

    def _first_range(self, u1: torch.Tensor):
        """Inclusive edge-row range [rl, ru] of the nodes ending in char
        ``u1`` (by F), and whether it is non-empty."""
        m = self.num_edges
        alph = self.alph_size
        u1 = torch.clamp(u1, 0, alph - 1).long()
        rl = torch.clamp(self.F[u1] + 1, max=m + 1)
        ru = torch.where(u1 + 1 < alph,
                         self.F[torch.clamp(u1 + 1, max=alph - 1)], m)
        return rl, ru, rl <= ru

    def _tighten(self, ok, rl, ru, c):
        """One tighten_range step on char ``c``: the rows of the nodes
        reached from [rl, ru] by an edge labelled c. The two ends ride
        one fused rank_W and one fused select_last call."""
        Q = rl.shape[0]
        c = torch.clamp(c, 0, self.alph_size - 1)
        cc = torch.cat([c, c])
        rk = self.rank_W(torch.cat([rl - 1, ru]), cc)
        rk_rl = rk[:Q] + 1
        rk_ru = rk[Q:]
        nf = self.NF[c.long()]
        sl = self.select_last(torch.clamp(torch.cat(
            [nf + rk_rl - 1, nf + rk_ru]), min=1))
        ok = ok & (rk_rl <= rk_ru)
        return (ok, torch.where(ok, sl[:Q] + 1, rl),
                torch.where(ok, sl[Q:], ru))

    def index_edge_ranksel(self, chars) -> torch.Tensor:
        """Rank/select-only edge lookup (no ``edge_lanes``): the
        reference's index + pick_edge search. ``chars``: (Q, K) edge
        k-mers in sequence order (node chars u_1..u_k, then the label).
        Per query an F range on u_1, k - 1 tighten steps, then pick_edge
        over the terminal node's rows. Returns 1-based rows, 0 = absent."""
        chars = self._t(chars).to(torch.int64)
        Q = chars.shape[0]
        k = self.k
        alph = self.alph_size
        ok = torch.all((chars >= 1) & (chars < alph), dim=1)
        rl, ru, nonempty = self._first_range(chars[:, 0])
        ok = ok & nonempty
        for i in range(1, k):
            ok, rl, ru = self._tighten(ok, rl, ru, chars[:, i])
        # pick_edge(ru, label): the node's rows holding W == c or c + alph
        c = torch.clamp(chars[:, k], 0, alph - 1)
        lo = self.pred_last(ru - 1) + 1
        cc = torch.cat([c, c + alph])
        rr = self.rank_W(torch.cat([ru, ru]), cc)
        pos = self.select_W(torch.clamp(rr, min=1), cc)
        p1 = torch.where((rr[:Q] >= 1) & (pos[:Q] >= lo), pos[:Q], 0)
        p2 = torch.where((rr[Q:] >= 1) & (pos[Q:] >= lo), pos[Q:], 0)
        return torch.where(ok, torch.where(p1 > 0, p1, p2), 0)

    def suffix_range_ranksel(self, patterns):
        """(ok, rl, ru): the inclusive 1-based row range of the edges
        whose source node ends in each pattern of (Q, s) chars, by
        rank/select alone (the reference's partial index_range; the
        JAX package searches one pattern a call)."""
        pat = self._t(patterns).to(torch.int64)
        alph = self.alph_size
        ok = torch.all((pat >= 1) & (pat < alph), dim=1)
        rl, ru, nonempty = self._first_range(pat[:, 0])
        ok = ok & nonempty
        for i in range(1, pat.shape[1]):
            ok, rl, ru = self._tighten(ok, rl, ru, pat[:, i])
        return ok, rl, ru

    def map_to_edges(self, query_lanes: torch.Tensor) -> torch.Tensor:
        """Map packed edge k-mers (BOSS layout) to 1-based edge rows;
        0 = not present. One batched binary search over ``edge_lanes``,
        narrowed to each query's top-16-bit bucket; without them (small
        state) the rank/select search."""
        if self.edge_lanes is None:
            return self.index_edge_ranksel(packing.unpack_to_chars(
                query_lanes, self.K, self.bits_per_char))
        n = self.edge_lanes.shape[1]
        if self.lut is not None:
            t = packed.srl(query_lanes[0], 16).to(torch.int64)
            pos = packed.searchsorted(
                self.edge_lanes, query_lanes, side="left",
                lo0=self.lut[t], hi0=self.lut[t + 1], steps=self.lut_steps)
        else:
            pos = packed.searchsorted(self.edge_lanes, query_lanes,
                                      side="left")
        pos_c = torch.clamp(pos, max=n - 1)
        hit = packed.eq(self.edge_lanes[:, pos_c], query_lanes)
        return torch.where(hit, pos_c + 1, 0)

    def index_range_nodes(self, node_lanes: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[lo, hi) 1-based edge rows of the edges whose source node is
        each packed node (its label field 0): two searches over
        ``edge_lanes``, the second for the node plus one just above the
        label field. Fast state only."""
        if self.edge_lanes is None:
            raise ValueError("index_range_nodes needs the edge k-mers "
                             "(the fast state)")
        lo = packed.searchsorted(self.edge_lanes, node_lanes, side="left")
        hi = packed.searchsorted(
            self.edge_lanes, _increment(node_lanes, self.bits_per_char),
            side="left")
        return lo + 1, hi + 1

    def node_chars_ranksel(self, rows) -> torch.Tensor:
        """(Q, K) int32 char codes of the edge k-mers at ``rows``, by
        rank/select alone (the reference's get_node_seq bwd walk): K - 1
        backward steps recover the node chars, W the label."""
        x = self._t(rows).to(torch.int64)
        K = self.K
        out = torch.zeros((x.shape[0], K), dtype=torch.int32,
                          device=self.device)
        out[:, K - 1] = self.get_W(x) % self.alph_size
        for i in range(K - 1):
            out[:, K - 2 - i] = self.get_node_last_value(x).to(torch.int32)
            x = self.bwd(x)
        return out

    # -- statistics --------------------------------------------------------

    def char_counts_W(self) -> torch.Tensor:
        """(alph_size,) total W occurrences folding minus flags."""
        m = self.num_edges
        cs = torch.arange(self.alph_size, device=self.device)
        full = torch.full_like(cs, m)
        base = self.rank_W(full, cs)
        flagged = self.rank_W(full, cs + self.alph_size)
        return base + torch.where(cs == 0, 0, flagged)

    def num_dummy_edges(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(#dummy source edges, #dummy sink edges), from the edge k-mers."""
        if self.edge_lanes is None:
            raise NotImplementedError(
                "small-state graphs (no edge_lanes) are not yet ported")
        B = self.bits_per_char
        is_src = packing.first_char(self.edge_lanes, B) == 0
        is_sink = (packing.label(self.edge_lanes, B) == 0) & ~is_src
        return torch.sum(is_src), torch.sum(is_sink)

    def tensors(self):
        """Every index tensor the graph holds (for its byte count)."""
        out = [self.F, self.last_rank.words, self.last_rank.brank,
               self.last_rank.total, self.W_rank.seq_words,
               self.W_rank.blocks, self.NF]
        return out + [t for t in (self.edge_lanes, self.weights, self.lut)
                      if t is not None]


def _finalize_ranks(W: torch.Tensor, last: torch.Tensor, F: torch.Tensor,
                    sigma: int):
    """Blocked BitRank over ``last``, SymbolRank over ``W`` and
    NF[c] = rank_last(F[c])."""
    last_rank = BitRank.build(last)
    W_rank = SymbolRank.build(W, sigma)
    i = torch.clamp(F, -1, last_rank.n - 1)
    NF = torch.where(i < 0, 0, last_rank.rank1(i)).to(torch.int32)
    return last_rank, W_rank, NF


def _increment(lanes: torch.Tensor, shift: int) -> torch.Tensor:
    """(L, N) packed keys plus 1 << shift, the carry running from the
    last (least significant) lane up; queries never overflow."""
    out = []
    carry = torch.full_like(lanes[0], 1 << shift, dtype=torch.int64)
    for j in range(lanes.shape[0] - 1, -1, -1):
        s = packed.as_uint(lanes[j]) + carry
        carry = s >> 32
        out.append(packed.from_uint(s))
    return torch.stack(out[::-1])


def _build_lut(edge_lanes: torch.Tensor, n_kept):
    """(2^16+1,) int32 bucket starts over the top lane's high 16 bits,
    capped at ``n_kept``, and the largest bucket (a 0-d tensor)."""
    n = edge_lanes.shape[1]
    top = packed.srl(edge_lanes[0], 16)
    lut = torch.searchsorted(
        top, torch.arange(1 << 16, dtype=top.dtype, device=top.device),
        side="left").to(torch.int32)
    lut = torch.cat([lut, torch.full((1,), n, dtype=torch.int32,
                                     device=top.device)])
    lut = torch.minimum(lut, torch.as_tensor(n_kept, dtype=torch.int32,
                                             device=top.device))
    return lut, torch.max(torch.diff(lut))
