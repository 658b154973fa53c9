"""clean.kept_nodes: nodes the clean kept (``cleaning.kept_nodes``, an
exact count of the nodes of its contigs), mean per call. A program
without the counter declares no probe and reads nothing."""

from metagraph_tpu_torch.graph import cleaning

PROBES = ([{"name": "kept_nodes",
            "counter": "metagraph_tpu_torch.graph.cleaning:kept_nodes"}]
          if hasattr(cleaning, "kept_nodes") else [])


def read(win):
    if "kept_nodes" not in win.counters:
        return None
    return win.counters["kept_nodes"] / len(win.done)
