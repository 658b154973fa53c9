"""clean.unitigs: unitigs decomposed (``traversal.unitigs``, an exact
count over every ``unitig_decomposition``: the clean's of the graph and
its contigs' of the masked graph), mean per call. A program without the
counter declares no probe and reads nothing."""

from metagraph_tpu_torch.graph import traversal

PROBES = ([{"name": "unitigs",
            "counter": "metagraph_tpu_torch.graph.traversal:unitigs"}]
          if hasattr(traversal, "unitigs") else [])


def read(win):
    if "unitigs" not in win.counters:
        return None
    return win.counters["unitigs"] / len(win.done)
