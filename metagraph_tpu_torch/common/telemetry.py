"""Spans, timers and memory for the port's commands.

PyTorch counterpart of ``metagraph_tpu/common/telemetry.py`` (the
reference's Timer, logger spans and get_curr_RSS,
metagraph/src/common/unix_tools.hpp:18-29): ``span`` times a region and
prints one line to stderr, ``[span] NAME: SECONDSs (rss X GB, +Y MB...)``,
when ``VERBOSE`` is on (``METAGRAPH_TPU_VERBOSE``, or ``-v`` / ``--debug``
on the CLI) or the span counts items. Where CUDA is in use, a span that
prints synchronises the card first, so the time it prints is the card's,
and reports ``torch.cuda.max_memory_allocated()`` beside RSS. With
``METAGRAPH_TPU_TRACE_DIR`` set, each span is a ``record_function``
range and ``device_trace`` writes a ``torch.profiler`` trace there.
``torch`` is imported only where it is used, so a client that needs no
tensors (``query --address``) does not load it.
"""

from __future__ import annotations

import contextlib
import os
import resource
import sys
import time
from typing import Dict, Iterator, Optional

VERBOSE = os.environ.get("METAGRAPH_TPU_VERBOSE", "0") != "0"
_TRACE_DIR = os.environ.get("METAGRAPH_TPU_TRACE_DIR")


def get_curr_rss() -> int:
    """The current resident set size in bytes (not the peak, which would
    hide what a stage frees)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGESIZE")
    except (OSError, IndexError, ValueError):
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.time()

    def elapsed(self) -> float:
        return time.time() - self._t0


_spans: Dict[str, float] = {}


def _cuda_in_use() -> bool:
    torch = sys.modules.get("torch")
    return (torch is not None and torch.cuda.is_available()
            and torch.cuda.is_initialized())


@contextlib.contextmanager
def span(name: str, items: Optional[int] = None,
         unit: str = "items") -> Iterator[None]:
    """A timed region: wall seconds, RSS and its change, the device's
    peak allocation where CUDA is in use, and ``items`` per second."""
    t0 = time.time()
    rss0 = get_curr_rss()
    record = None
    if _TRACE_DIR:
        import torch
        record = torch.profiler.record_function(name)
        record.__enter__()
    try:
        yield
    finally:
        if record is not None:
            record.__exit__(None, None, None)
        printing = bool(VERBOSE or items)
        cuda = _cuda_in_use()
        if printing and cuda:
            import torch
            torch.cuda.synchronize()
        dt = time.time() - t0
        _spans[name] = _spans.get(name, 0.0) + dt
        if printing:
            rss = get_curr_rss()
            device = (f", device peak "
                      f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
                      if cuda else "")
            rate = (f", {items / max(dt, 1e-9) / 1e6:.2f} M{unit}/s"
                    if items else "")
            print(f"[span] {name}: {dt:.3f}s (rss {rss / 1e9:.2f} GB, "
                  f"+{(rss - rss0) / 1e6:.0f} MB{device}{rate})",
                  file=sys.stderr, flush=True)


def span_totals() -> Dict[str, float]:
    return dict(_spans)


@contextlib.contextmanager
def device_trace(out_dir: Optional[str] = None) -> Iterator[None]:
    """A ``torch.profiler`` trace of the region (host and, where there is
    a card, CUDA activity), written to ``out_dir`` or
    ``METAGRAPH_TPU_TRACE_DIR`` as a Chrome trace; nothing without
    either."""
    out = out_dir or _TRACE_DIR
    if not out:
        yield
        return
    import torch
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(out)):
        yield
