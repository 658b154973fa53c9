"""CanonicalDbg: a PRIMARY graph presented as its canonical closure.

PyTorch counterpart of ``metagraph_tpu/graph/canonical.py`` (reference
canonical_dbg.hpp:21). A primary graph stores one orientation of each
k-mer pair, the canonical form; the wrapper exposes a virtual node space
of 2N ids, where 1..N are the stored orientation and N+1..2N their
reverse complements, and resolves adjacency through the base graph with
that bookkeeping. Every operation is batched over node tensors on the
base graph's device; both orientations of a k-mer share one annotation
row, the base node's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..common import packed
from ..kmer import packing
from ..kmer.extractor import encode_sequences, window_validity
from .dbg_succinct import DbgSuccinct


@dataclass(frozen=True)
class CanonicalDbg:
    base: DbgSuccinct

    @property
    def k(self) -> int:
        return self.base.k

    @property
    def alphabet(self):
        return self.base.alphabet

    @property
    def mode(self) -> str:
        return "canonical"

    @property
    def device(self) -> torch.device:
        return self.base.device

    def num_nodes(self) -> int:
        return 2 * self.base.num_nodes()

    def num_anno_rows(self) -> int:
        """Rows of an annotation: one per base node."""
        return self.base.num_nodes()

    # -- virtual node resolution -------------------------------------------

    def _rc(self, lanes: torch.Tensor) -> torch.Tensor:
        return packing.reverse_complement(lanes, self.k,
                                          self.alphabet.bits_per_char,
                                          self.alphabet.complement)

    def _resolve(self, lanes: torch.Tensor) -> torch.Tensor:
        """Packed (possibly non-canonical) k-mers -> virtual node ids."""
        rc = self._rc(lanes)
        is_rc = packed.lt(rc, lanes)            # the canonical form is rc
        canon = torch.where(is_rc[None, :], rc, lanes)
        v = self.base.edge_to_node(self.base.boss.map_to_edges(canon))
        return torch.where(v > 0, torch.where(is_rc, v + self.base.num_nodes(),
                                              v), 0)

    def node_lanes(self, nodes: torch.Tensor) -> torch.Tensor:
        """Packed k-mer of each virtual node, in its own orientation."""
        N = self.base.num_nodes()
        is_rc = nodes > N
        lanes = self.base.node_lanes(torch.where(is_rc, nodes - N, nodes))
        return torch.where(is_rc[None, :], self._rc(lanes), lanes)

    # -- mapping -----------------------------------------------------------

    def map_codes_to_nodes(self, codes: torch.Tensor) -> torch.Tensor:
        """Virtual node id of every k-window of a code array (0 = absent
        or invalid window)."""
        ok = window_validity(codes, self.k)
        lanes = packing.pack_windows(codes, self.k,
                                     self.alphabet.bits_per_char)
        return torch.where(ok, self._resolve(lanes), 0)

    def map_to_nodes(self, seq: bytes | str) -> np.ndarray:
        """Virtual node ids of the windows of one sequence, on the host."""
        codes = encode_sequences([seq], self.alphabet)[:-1]  # no separator
        n = len(codes)
        if n < self.k:
            return np.zeros((max(0, n - self.k + 1),), np.int32)
        out = self.map_codes_to_nodes(torch.from_numpy(codes).to(self.device))
        return out.cpu().numpy().astype(np.int32)

    # -- adjacency ---------------------------------------------------------

    def _adjacent(self, nodes: torch.Tensor, queries) -> torch.Tensor:
        out = torch.stack([self._resolve(q) for q in queries], dim=1)
        return torch.where((nodes > 0)[:, None], out, 0)

    def successors(self, nodes: torch.Tensor) -> torch.Tensor:
        """(N, sigma-1) virtual ids of the successors (0 = absent), one
        column per next character c in 1..sigma-1."""
        B = self.alphabet.bits_per_char
        shifted = packing.to_next(self.node_lanes(nodes), self.k, B, 0)
        return self._adjacent(nodes, [
            packed.set_field(shifted, 0, torch.full(
                (shifted.shape[1],), c, dtype=packed.LANE_DTYPE,
                device=shifted.device), B)
            for c in range(1, self.alphabet.size)])

    def predecessors(self, nodes: torch.Tensor) -> torch.Tensor:
        """(N, sigma-1) virtual ids of the predecessors (0 = absent), one
        column per first character c in 1..sigma-1."""
        lanes = self.node_lanes(nodes)
        return self._adjacent(nodes, [
            packing.to_prev(lanes, self.k, self.alphabet.bits_per_char, c)
            for c in range(1, self.alphabet.size)])

    def outdegree(self, nodes: torch.Tensor) -> torch.Tensor:
        return torch.sum(self.successors(nodes) > 0, dim=1)

    def indegree(self, nodes: torch.Tensor) -> torch.Tensor:
        return torch.sum(self.predecessors(nodes) > 0, dim=1)

    # -- decoding and annotation rows --------------------------------------

    def node_chars(self, nodes: torch.Tensor) -> torch.Tensor:
        """(N, k) uint8 char codes of the virtual nodes, on the device."""
        return packing.unpack_to_chars(self.node_lanes(nodes), self.k,
                                       self.alphabet.bits_per_char)

    def node_kmers_chars(self, nodes) -> np.ndarray:
        """``node_chars`` on the host."""
        return self.node_chars(torch.as_tensor(
            np.asarray(nodes, np.int64), device=self.device)).cpu().numpy()

    def node_sequence(self, node: int) -> str:
        return self.alphabet.decode(self.node_kmers_chars([node])[0])

    def node_to_anno_row(self, nodes: np.ndarray) -> np.ndarray:
        """Annotation row of each (present) virtual node: its base node's
        row, shared by both orientations."""
        N = self.base.num_nodes()
        nodes = np.asarray(nodes).astype(np.int64)
        return np.where(nodes > N, nodes - N, nodes) - 1
