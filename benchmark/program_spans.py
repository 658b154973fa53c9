"""The program's own spans, as the per-layer readers see them.

``metagraph_tpu_torch.common.telemetry`` records a span at each layer
boundary of the build and label-query paths while its ``TRACING`` switch
is on (``telemetry.recorded()``: id, name, parent, root, t0, t1 on
``time.perf_counter()``, the window's clock, and each record's self
time). Importing this module turns the switch on. The harness loads the
per-layer readers only in ``--trace 1`` runs, after set-up, so a
``--trace 0`` run measures the program with its spans off.

A window's records are those whose root span (a ``build``, a ``query``)
began at or after the window's start and ended by its last completion.
Every function returns None where there is nothing to read: a program
without the recorder, or a buffer that dropped records.
"""

from __future__ import annotations

from metagraph_tpu_torch.common import telemetry

telemetry.TRACING = True


def window_records(win):
    """The records of the window's calls, or None."""
    read = getattr(telemetry, "recorded", None)
    if read is None or not win.done:
        return None
    records, dropped = read()
    if dropped:
        return None
    end = max(c[1] for c in win.done)
    roots = {r.id for r in records
             if r.parent is None and r.t0 >= win.start and r.t1 <= end}
    return [r for r in records if r.root in roots]


def ms_per_call(win, name: str, own: bool = False):
    """Milliseconds in the spans named ``name`` per completed call: their
    self time with ``own``, else their whole time; None where no such
    span ran."""
    records = window_records(win)
    if records is None:
        return None
    picked = [r.self_s if own else r.t1 - r.t0
              for r in records if r.name == name]
    return 1e3 * sum(picked) / len(win.done) if picked else None
