"""The yardstick: the chip's peaks, the bounds of the program's kernels
computed from their shapes, and the union of a trace's device intervals.
Later changes to the program do not change these."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, at its 700 W limit
HBM_BYTES_PER_S = 3.35e12


def sort_bound_bytes(n: int, lanes: int, payloads: int) -> int:
    """Bytes a sort of ``n`` keys of ``lanes`` 4-byte lanes with
    ``payloads`` 4-byte payloads must move: every input word read once,
    every output word written once."""
    return 2 * 4 * n * (lanes + payloads)


def bound_seconds(nbytes: int) -> float:
    """The least time to move ``nbytes`` through HBM."""
    return nbytes / HBM_BYTES_PER_S


def merged_intervals(intervals):
    """The union of (start, end) intervals, as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out

