"""MaskedDbg: a graph restricted to a node subset.

PyTorch counterpart of ``metagraph_tpu/graph/masked.py`` (reference
masked_graph.hpp:14). It offers the traversal surface of ``DbgSuccinct``
(``num_nodes``, ``successors``, ``predecessors``, ``node_chars``,
``map_to_nodes``) with the mask applied, so unitig extraction, cleaning
and differential assembly run unchanged on the restricted graph. Node
ids keep the base graph's numbering (masked nodes vanish from the
adjacency); the mask lives on the base graph's device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class MaskedDbg:
    base: object              # DbgSuccinct or CanonicalDbg
    mask: torch.Tensor        # (N+1,) bool over base node ids

    def __post_init__(self):
        self.mask = torch.as_tensor(self.mask, dtype=torch.bool,
                                    device=self.base.device)

    @property
    def k(self) -> int:
        return self.base.k

    @property
    def alphabet(self):
        return self.base.alphabet

    @property
    def mode(self):
        return self.base.mode

    @property
    def device(self) -> torch.device:
        return self.base.device

    def num_nodes(self) -> int:
        return self.base.num_nodes()

    def num_masked_nodes(self) -> int:
        return int(self.mask[1:].sum())

    def map_to_nodes(self, seq) -> np.ndarray:
        nodes = self.base.map_to_nodes(seq)
        keep = self.mask[torch.from_numpy(nodes.astype(np.int64)).to(
            self.device)].cpu().numpy()
        return np.where(keep, nodes, 0)

    def _masked(self, nodes: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        adj = torch.where(self.mask[adj], adj, 0)
        return torch.where(self.mask[nodes][:, None], adj, 0)

    def successors(self, nodes: torch.Tensor) -> torch.Tensor:
        return self._masked(nodes, self.base.successors(nodes))

    def predecessors(self, nodes: torch.Tensor) -> torch.Tensor:
        return self._masked(nodes, self.base.predecessors(nodes))

    def outdegree(self, nodes: torch.Tensor) -> torch.Tensor:
        return torch.sum(self.successors(nodes) > 0, dim=1)

    def indegree(self, nodes: torch.Tensor) -> torch.Tensor:
        return torch.sum(self.predecessors(nodes) > 0, dim=1)

    def node_chars(self, nodes: torch.Tensor) -> torch.Tensor:
        return self.base.node_chars(nodes)

    def node_kmers_chars(self, nodes) -> np.ndarray:
        return self.base.node_kmers_chars(nodes)
