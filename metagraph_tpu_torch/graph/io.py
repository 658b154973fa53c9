"""Graph serialization (``.dbg.npz``), shared with the JAX package.

The container holds the same keys and dtypes as
``metagraph_tpu/graph/io.py`` writes (``edge_lanes`` as uint32), so a
file written by either package loads in the other. ``dbg_from_numpy``
turns those arrays (or the same arrays taken from a JAX-built graph)
into the port's objects.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common import packed
from ..common.device import resolve
from ..kmer.alphabets import ALPHABETS
from .boss import Boss
from .dbg_succinct import DbgSuccinct

GRAPH_EXT = ".dbg.npz"


def graph_to_numpy(graph: DbgSuccinct, with_lanes: bool = True) -> dict:
    """The graph's arrays on the host (``dbg_from_numpy`` inverts it):
    ``last`` and ``valid`` as full-length bool, ``edge_lanes`` uint32
    (left out without ``with_lanes``)."""
    boss = graph.boss
    d = dict(
        k=np.array(boss.k),
        alphabet=np.array(graph.alphabet.name),
        mode=np.array(graph.mode),
        W=boss.W.cpu().numpy().astype(np.int8),
        last=boss.last_rank.bits_host(),
        F=boss.F.cpu().numpy(),
        valid=graph.valid_rank.bits_host(),
    )
    if with_lanes and boss.edge_lanes is not None:
        d["edge_lanes"] = packed.lanes_to_numpy(boss.edge_lanes)
    if boss.weights is not None:
        d["weights"] = boss.weights.cpu().numpy()
    return d


def save_graph(path: str, graph: DbgSuccinct, state: str = "fast") -> str:
    """Write the graph. State ``fast`` keeps the edge k-mers (the search
    accelerator); ``small`` drops them, leaving the rank/select
    structures alone (the reference's BOSS states)."""
    if state not in ("fast", "small"):
        raise ValueError(f"state {state!r}: fast or small")
    if not path.endswith(GRAPH_EXT):
        path = path + GRAPH_EXT
    d = graph_to_numpy(graph, with_lanes=state == "fast")
    d["last_len"] = np.array(d["last"].shape[0])
    d["last"] = np.packbits(d["last"])
    d["valid"] = np.packbits(d["valid"])
    np.savez_compressed(path, **d)
    return path


def dbg_from_numpy(d, device="cuda") -> DbgSuccinct:
    """A graph from its arrays: ``k``, ``alphabet``, ``mode``, ``W`` and
    ``last`` (full length, row 0 included), ``F``, and optionally
    ``edge_lanes`` (uint32), ``weights`` and ``valid`` (bool)."""
    dev = resolve(device)
    alphabet = ALPHABETS[str(d["alphabet"])]

    def t(a, dtype):
        return torch.from_numpy(np.asarray(a).astype(dtype)).to(dev)

    lanes = (packed.lanes_from_numpy(d["edge_lanes"], dev)
             if d.get("edge_lanes") is not None else None)
    weights = t(d["weights"], np.int32) if d.get("weights") is not None \
        else None
    boss = Boss.from_arrays(
        k=int(d["k"]), alph_size=alphabet.size,
        bits_per_char=alphabet.bits_per_char,
        W=t(d["W"], np.int32), last=t(d["last"], bool), F=t(d["F"], np.int32),
        edge_lanes=lanes, weights=weights)
    valid = t(d["valid"], bool) if d.get("valid") is not None else None
    return DbgSuccinct.from_boss(boss, alphabet, str(d["mode"]), valid=valid)


def load_graph(path: str, device="cuda") -> DbgSuccinct:
    if not path.endswith(GRAPH_EXT):
        path = path + GRAPH_EXT
    with np.load(path) as z:
        n = int(z["last_len"])
        d = {key: z[key] for key in z.files}
    d["last"] = np.unpackbits(d["last"])[:n].astype(bool)
    if "valid" in d:
        d["valid"] = np.unpackbits(d["valid"])[:n].astype(bool)
    return dbg_from_numpy(d, device)


def load_query_graph(path: str, device="cuda"):
    """Load a graph as ``query``, ``align`` and ``server_query`` read it:
    a primary graph comes wrapped in ``CanonicalDbg``, so a read matches
    whichever orientation of its k-mers is stored."""
    g = load_graph(path, device=device)
    if g.mode == "primary":
        from .canonical import CanonicalDbg
        return CanonicalDbg(base=g)
    return g


def index_bytes(graph: DbgSuccinct) -> int:
    """Total bytes of the loaded index tensors (for stats bytes/edge)."""
    vr = graph.valid_rank
    tensors = graph.boss.tensors() + [vr.words, vr.brank, vr.total]
    return sum(x.numel() * x.element_size() for x in tensors)
