"""kernel.sort_roofline (read as ``kernel.sort_roofline.build`` and
``.query``, one entry for each end-to-end metric it moves): the sort
kernel's share of its roofline over a window: the least time
of every ``merge.sort_packed`` call (its keys and payloads read once and
written once, at the H100's HBM rate) over their time between CUDA
events around the call, summed over the window's calls."""

from benchmark import yardstick

PROBES = [{"name": "sort_packed", "clock": "events",
           "target": "metagraph_tpu_torch.common.merge:sort_packed"}]


def read(win):
    times = win.spans.get("sort_packed")
    if not times:
        return None
    bound = 0.0
    for shapes in win.span_args["sort_packed"]:
        lanes, n = shapes[0]
        nbytes = yardstick.sort_bound_bytes(n, lanes, len(shapes) - 1)
        bound += yardstick.bound_seconds(nbytes)
    return 100.0 * bound / sum(times)
