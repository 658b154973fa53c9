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
        if mode not in (MODE_BASIC, MODE_CANONICAL):
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

    def edge_to_node(self, edge: torch.Tensor) -> torch.Tensor:
        """BOSS edge row -> DBG node id (0 if dummy or absent)."""
        return torch.where((edge > 0) & self.valid_rank.bit(edge),
                           self.valid_rank.rank1(edge), 0)

    def map_codes_to_nodes(self, codes: torch.Tensor) -> torch.Tensor:
        """Node id of every k-window of a code array (0 = absent or
        invalid window); (len(codes) - k + 1,) int64."""
        K = self.k
        B = self.alphabet.bits_per_char
        ok = window_validity(codes, K)
        lanes = packing.pack_windows(codes, K, B)
        if self.mode == MODE_CANONICAL:
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
