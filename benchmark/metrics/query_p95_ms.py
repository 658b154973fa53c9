"""query_p95_ms: the 95th percentile (nearest rank) of the latency of
every request completed in the window, from the time it was sent (by
the traffic's loop) to its return with the label lists on the host (host
clock)."""

import math


def read(win):
    lat = sorted(c[1] - c[0] for c in win.done)
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]
