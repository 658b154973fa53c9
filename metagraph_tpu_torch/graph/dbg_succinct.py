"""DBGSuccinct: the node-level de Bruijn graph over a BOSS table.

PyTorch counterpart of ``metagraph_tpu/graph/dbg_succinct.py`` (fast
state only: the graph keeps its sorted edge k-mers). A DBG node of k-mer
size k is a BOSS edge; dummy edges (holding ``$``) are masked out of the
node index space by a rank over the valid-edge mask, so node ids run
1..num_nodes. ``map_codes_to_nodes`` maps every window of a code array
with one batched search.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..common import packed
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
        """Packed edge k-mers of a node batch (adjacency and decoding go
        through it)."""
        if self.boss.edge_lanes is None:
            raise NotImplementedError(
                "node k-mers of small-state graphs are not yet ported")
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

    def successors(self, nodes: torch.Tensor) -> torch.Tensor:
        """(N, sigma-1) node ids of the successors (0-padded), one column
        per next character c in 1..sigma-1."""
        lanes = self.node_lanes(nodes)
        shifted = packing.to_next(lanes, self.k, self.alphabet.bits_per_char,
                                  0)
        return self._adjacent(nodes, shifted, 0)

    def predecessors(self, nodes: torch.Tensor) -> torch.Tensor:
        """(N, sigma-1) node ids of the predecessors (0-padded), one column
        per first character c in 1..sigma-1."""
        lanes = self.node_lanes(nodes)
        shifted = packing.to_prev(lanes, self.k, self.alphabet.bits_per_char,
                                  0)
        return self._adjacent(nodes, shifted, 1)

    def outdegree(self, nodes: torch.Tensor) -> torch.Tensor:
        return torch.sum(self.successors(nodes) > 0, dim=1)

    def indegree(self, nodes: torch.Tensor) -> torch.Tensor:
        return torch.sum(self.predecessors(nodes) > 0, dim=1)

    # -- node decoding -----------------------------------------------------

    def node_kmers_chars(self, nodes) -> np.ndarray:
        """(N, k) uint8 char codes of the node k-mers, on the host."""
        nodes = torch.as_tensor(np.asarray(nodes, np.int64), device=self.device)
        lanes = self.node_lanes(nodes)
        return packing.unpack_to_chars(
            lanes, self.k, self.alphabet.bits_per_char).cpu().numpy()

    def node_sequence(self, node: int) -> str:
        return self.alphabet.decode(self.node_kmers_chars([node])[0])
