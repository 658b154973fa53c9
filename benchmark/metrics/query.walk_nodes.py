"""query.walk_nodes: nodes on the anchor walks of a request
(``row_diff.walk_nodes``, an exact count that ``walk_paths`` keeps from
the sizes its masked steps bring to the host), mean per request. A
program without the counter declares no probe and reads nothing."""

from metagraph_tpu_torch.anno import row_diff

PROBES = ([{"name": "walk_nodes",
            "counter": "metagraph_tpu_torch.anno.row_diff:walk_nodes"}]
          if hasattr(row_diff, "walk_nodes") else [])


def read(win):
    if "walk_nodes" not in win.counters:
        return None
    return win.counters["walk_nodes"] / len(win.done)
