"""query.select_pairs: (read, label) pairs the label query's device
selection brought to the host (``annotated_dbg.select_pairs``, an exact
count of the labels in the answers), mean per request. A program without
the counter declares no probe and reads nothing."""

from metagraph_tpu_torch.engine import annotated_dbg

PROBES = ([{"name": "select_pairs",
            "counter": "metagraph_tpu_torch.engine.annotated_dbg:select_pairs"}]
          if hasattr(annotated_dbg, "select_pairs") else [])


def read(win):
    if "select_pairs" not in win.counters:
        return None
    return win.counters["select_pairs"] / len(win.done)
