"""Spans, timers and memory for the port's commands and library paths.

PyTorch counterpart of ``metagraph_tpu/common/telemetry.py`` (the
reference's Timer, logger spans and get_curr_RSS,
metagraph/src/common/unix_tools.hpp:18-29). ``span`` times a region.

Printing: a span prints one line to stderr, ``[span] NAME: SECONDSs (rss
X GB, +Y MB...)``, when ``VERBOSE`` is on (``METAGRAPH_TPU_VERBOSE``, or
``-v`` / ``--debug`` on the CLI) or the span counts items. Where CUDA is
in use, a span that prints synchronises the card first, so the time it
prints is the card's, and reports ``torch.cuda.max_memory_allocated()``
beside RSS. The library's spans (``quiet=True``: the build's collect and
finish stages, the label query's mapping, walks, descents, folds, sums
and selection) never print.

Recording: with ``TRACING`` on (``METAGRAPH_TPU_TRACE_DIR`` set, or set
by code) every span, printing or quiet, synchronises the current CUDA
device on entry and exit, so its interval is the card's, runs inside a
``torch.profiler.record_function`` range of its name, and appends one
record to a bounded buffer: (id, name, parent id, root id, t0, t1) on
``time.perf_counter()``'s clock, parent and root from a per-thread stack,
so the spans of one build or request share their root's id. ``recorded``
reads the buffer with each record's self time. With ``TRACING`` off a
span that does not print costs a flag test and records nothing.

With ``METAGRAPH_TPU_TRACE_DIR`` set, the CLI runs each command inside
``device_trace``, which writes a ``torch.profiler`` trace there, the
spans (the library's included) as ranges. ``torch`` is imported only
where it is used, so a client that needs no tensors (``query
--address``) does not load it.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import resource
import sys
import threading
import time
from typing import Iterator, List, NamedTuple, Optional, Tuple

VERBOSE = os.environ.get("METAGRAPH_TPU_VERBOSE", "0") != "0"
_TRACE_DIR = os.environ.get("METAGRAPH_TPU_TRACE_DIR")
TRACING = bool(_TRACE_DIR)

RECORDS_MAX = 1 << 16
_records: collections.deque = collections.deque(maxlen=RECORDS_MAX)
_dropped = 0
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()                   # the buffer and its drop count
_OFF = contextlib.nullcontext()


class Record(NamedTuple):
    """One span as ``recorded`` returns it; ``parent`` is None at a root,
    whose ``root`` is its own id. Seconds on ``time.perf_counter()``."""
    id: int
    name: str
    parent: Optional[int]
    root: int
    t0: float
    t1: float
    self_s: float             # t1 - t0 less the time its children cover


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


def _cuda_in_use() -> bool:
    torch = sys.modules.get("torch")
    return (torch is not None and torch.cuda.is_available()
            and torch.cuda.is_initialized())


def _synchronize() -> bool:
    """Synchronise the current CUDA device where CUDA is in use; whether
    it was."""
    if not _cuda_in_use():
        return False
    sys.modules["torch"].cuda.synchronize()
    return True


def span(name: str, items: Optional[int] = None, unit: str = "items",
         quiet: bool = False):
    """A timed region (a context manager): recorded while ``TRACING`` is
    on; printed, with RSS and its change, the device's peak allocation
    where CUDA is in use and ``items`` per second, when ``VERBOSE`` is on
    or it counts ``items``, unless ``quiet``."""
    printing = not quiet and bool(VERBOSE or items)
    if TRACING or printing:
        return _Span(name, items, unit, printing)
    return _OFF


class _Span:
    __slots__ = ("name", "items", "unit", "printing", "tracing", "rss0",
                 "range", "id", "parent", "root", "t0")

    def __init__(self, name, items, unit, printing):
        self.name, self.items, self.unit = name, items, unit
        self.printing, self.tracing = printing, TRACING

    def __enter__(self):
        if self.printing:
            self.rss0 = get_curr_rss()
        if self.tracing:
            _synchronize()
            stack = getattr(_local, "stack", None)
            if stack is None:
                stack = _local.stack = []
            self.id = next(_ids)
            self.parent, self.root = stack[-1] if stack else (None, self.id)
            stack.append((self.id, self.root))
            import torch
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        cuda = _synchronize()
        t1 = time.perf_counter()
        if self.tracing:
            self.range.__exit__(*exc)
            _local.stack.pop()
            _record((self.id, self.name, self.parent, self.root, self.t0, t1))
        if self.printing:
            dt = t1 - self.t0
            rss = get_curr_rss()
            peak = (sys.modules["torch"].cuda.max_memory_allocated()
                    if cuda else 0)
            device = f", device peak {peak / 1e9:.2f} GB" if cuda else ""
            rate = (f", {self.items / max(dt, 1e-9) / 1e6:.2f} M{self.unit}/s"
                    if self.items else "")
            print(f"[span] {self.name}: {dt:.3f}s (rss {rss / 1e9:.2f} GB, "
                  f"+{(rss - self.rss0) / 1e6:.0f} MB{device}{rate})",
                  file=sys.stderr, flush=True)
        return False


def _record(rec):
    global _dropped
    with _lock:
        if len(_records) == _records.maxlen:    # the oldest record goes
            _dropped += 1
        _records.append(rec)


def recorded() -> Tuple[List[Record], int]:
    """(every record in the buffer, oldest first by end, with its self
    time; the number of records dropped from the buffer so far)."""
    with _lock:
        recs, dropped = list(_records), _dropped
    children = collections.defaultdict(float)
    for r in recs:
        if r[2] is not None:
            children[r[2]] += r[5] - r[4]
    return ([Record(*r, r[5] - r[4] - children[r[0]]) for r in recs],
            dropped)


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
