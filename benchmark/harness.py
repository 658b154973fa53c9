"""The harness: runs one cell once and returns its result line.

A cell is found by name. ``BENCHMARK.json`` gives its configuration,
traffic mix and metrics; ``workloads/<cell>.json`` names the entry of
the program that its window drives (``entries/<entry>.py``) and how many
of the window's calls a traced run profiles; ``configs/``, ``traffic/``,
``recipes/<kind>.py`` and ``metrics/<metric>.py`` hold the rest, each
found by its name.

One run: set-up (the entry's: inputs, warm-up of the traffic's shapes),
then a window of ``seconds`` in which the entry is called with the
traffic's items as its loop says (``drive``), then the comparison with
the plain reference once the program's state is freed. ``trace`` 0 reports the cell's
end-to-end metrics; ``trace`` 1 installs the probes that its per-layer
metrics declare, profiles the window's first calls, and reports those.
"""

from __future__ import annotations

import bisect
import importlib
import importlib.util
import itertools
import json
import os
import sys
import time
import traceback
from collections import defaultdict, deque

from benchmark import generator

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "metagraph_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_file(path: str, name: str):
    """A module from a file: entries and metric readers are found by
    name, and metric names hold dots."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules():
    """Loaded modules whose top-level name is one that no run may load,
    compared whole (``metagraph_tpu_torch`` is not ``metagraph_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


class Cell:
    """One entry of ``workloads`` with everything it names, read from
    the files under ``<root>/benchmark``. ``overrides`` ({"config": {},
    "traffic": {}, "workload": {}}) change sizes for tests. The traffic
    mix is checked against its recipe and the entry's ``ROLE``."""

    def __init__(self, name: str, root: str = ROOT, overrides=None):
        spec = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json "
                             f"has {sorted(cells)}")
        bench = os.path.join(root, "benchmark")
        over = overrides or {}
        w = cells[name]
        self.name = name
        self.root = root
        self.bench = bench
        self.chips = w["chips"]
        self._modules = {}
        configs = {c["name"]: c for c in spec["configs"]}
        self.config_name = w["config"]
        self.config = dict(load_json(os.path.join(
            root, configs[w["config"]]["file"])), **over.get("config", {}))
        self.workload = dict(load_json(os.path.join(
            bench, "workloads", name + ".json")), **over.get("workload", {}))
        self.traffic_name = w["traffic"]
        self.recipes = os.path.join(bench, "recipes")
        self.traffic = generator.mix(dict(load_json(os.path.join(
            bench, "traffic", w["traffic"] + ".json")),
            **over.get("traffic", {})), self.entry().ROLE, self.recipes)
        self.end_to_end = [m for m in spec["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        # a per-layer metric with ``workloads`` is read in those cells,
        # one without in every cell that reports the metric it moves
        self.per_layer = [m for m in spec["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]

    def entry(self):
        name = self.workload["entry"]
        return self._module(os.path.join(self.bench, "entries", name + ".py"),
                            "benchmark_entry_" + name)

    def metric(self, name: str):
        """The reader of a metric: ``metrics/<name>.py``, or the file of
        the longest part of the name before a dot (one reader serves
        ``device.idle_share.build`` and ``device.idle_share.query``)."""
        parts = name.split(".")
        for n in range(len(parts), 0, -1):
            stem = ".".join(parts[:n])
            path = os.path.join(self.bench, "metrics", stem + ".py")
            if os.path.exists(path):
                return self._module(path, "benchmark_metric_"
                                    + stem.replace(".", "_"))
        raise FileNotFoundError(f"no reader for metric {name!r}")

    def _module(self, path, name):
        if path not in self._modules:
            self._modules[path] = load_file(path, name)
        return self._modules[path]

    def probe_specs(self):
        """The probes that the cell's per-layer metrics declare, once
        each by name."""
        out = {}
        for m in self.per_layer:
            for p in getattr(self.metric(m["name"]), "PROBES", ()):
                out[p["name"]] = p
        return list(out.values())


# ---------------------------------------------------------------------------
# the device
# ---------------------------------------------------------------------------

def _torch():
    import torch
    return torch


def synchronize(device):
    torch = _torch()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def peak_bytes(device, reset=False) -> int:
    torch = _torch()
    if torch.device(device).type != "cuda":
        return 0
    peak = torch.cuda.max_memory_allocated()
    if reset:
        torch.cuda.reset_peak_memory_stats()
    return int(peak)


# ---------------------------------------------------------------------------
# probes: spans and counters at the program's layer boundaries
# ---------------------------------------------------------------------------

def _resolve(target: str):
    """"module:Attr.attr" -> (owner object, attribute name)."""
    module, _, path = target.partition(":")
    owner = importlib.import_module(module)
    *parents, attr = path.split(".")
    for p in parents:
        owner = getattr(owner, p)
    return owner, attr


class Probes:
    """Wraps the targets of the probes: a ``sync`` span synchronizes
    before and after the call and takes the host clock, an ``events``
    span records CUDA events around it (with the shapes of its tensor
    arguments), a ``counter`` reads a module global at the window's ends.
    Spans run inside a profiler range of their name."""

    def __init__(self, specs, device):
        self.specs = specs
        self.device = device
        self.spans = defaultdict(list)       # name -> [seconds]
        self.args = defaultdict(list)        # name -> [[shape, ...]]
        self._events = defaultdict(list)
        self.counters = {}
        self._saved = []
        self._start = {}

    def install(self):
        torch = _torch()
        cuda = torch.device(self.device).type == "cuda"
        for spec in self.specs:
            owner, attr = _resolve(spec.get("target") or spec["counter"])
            if "counter" in spec:
                self._start[spec["name"]] = (owner, attr, getattr(owner, attr))
                continue
            orig = getattr(owner, attr)
            wrap = (self._events_span if spec["clock"] == "events" and cuda
                    else self._sync_span)(spec["name"], orig)
            self._saved.append((owner, attr, orig))
            setattr(owner, attr, wrap)

    def _sync_span(self, name, orig):
        from torch.profiler import record_function
        spans, device = self.spans[name], self.device
        args = self.args[name]

        def span(*a, **k):
            synchronize(device)
            t0 = time.perf_counter()
            with record_function(name):
                out = orig(*a, **k)
            synchronize(device)
            spans.append(time.perf_counter() - t0)
            args.append(_shapes(a))
            return out
        return span

    def _events_span(self, name, orig):
        torch = _torch()
        from torch.profiler import record_function
        pending = self._events[name]

        def span(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            with record_function(name):
                out = orig(*a, **k)
            end.record()
            pending.append((start, end, _shapes(a)))
            return out
        return span

    def remove(self):
        """Restore the targets; resolve the events; take the counters'
        deltas."""
        for owner, attr, orig in reversed(self._saved):
            setattr(owner, attr, orig)
        self._saved.clear()
        synchronize(self.device)
        for name, pending in self._events.items():
            for start, end, shapes in pending:
                self.spans[name].append(start.elapsed_time(end) / 1e3)
                self.args[name].append(shapes)
        self._events.clear()
        for name, (owner, attr, v0) in self._start.items():
            self.counters[name] = getattr(owner, attr) - v0


def _shapes(args):
    torch = _torch()
    return [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]


# ---------------------------------------------------------------------------
# the profiler
# ---------------------------------------------------------------------------

def read_profile(prof, span_names=(), top: int = 10):
    """(busy seconds, breakdown) of a profiled window: the union of the
    device's operations, the operations that took most device time, and
    the idle gaps between them, each named by the probe span and the
    innermost host operation around its middle ("python" where no
    operation runs)."""
    torch = _torch()
    spans = set(span_names)
    events = prof.events()
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.name not in spans
           and not getattr(e, "is_user_annotation", False)]
    host = sorted((e for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.time_range.start)
    if not dev or not host:
        return 0.0, None
    from benchmark import yardstick
    merged = yardstick.merged_intervals(
        (e.time_range.start, e.time_range.end) for e in dev)
    busy_us = sum(e - s for s, e in merged)
    ops = defaultdict(float)
    for e in dev:
        ops[_short(e.name)] += (e.time_range.end - e.time_range.start) / 1e6
    lo = host[0].time_range.start
    hi = max(e.time_range.end for e in host)
    gaps, cur = [], lo
    for s, e in merged:
        if s > cur:
            gaps.append((cur, min(s, hi)))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))
    ops_host = [e for e in host if e.name not in spans]
    starts = [e.time_range.start for e in ops_host]
    span_ev = [e for e in host if e.name in spans]
    named = defaultdict(float)
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:1000]:
        t = (s + e) / 2
        op = _innermost(ops_host, starts, t) or "python"
        span = [x.name for x in span_ev
                if x.time_range.start <= t <= x.time_range.end]
        name = f"{span[-1]}/{op}" if span else op
        named[name] += (e - s) / 1e6
    by_time = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return busy_us / 1e6, {
        "device_ops": [[k, v] for k, v in by_time(ops)],
        "idle_gaps": [[k, v] for k, v in by_time(named)]}


def _short(name: str, width: int = 96) -> str:
    """A kernel's name without the namespaces that every ATen kernel
    shares, cut to ``width``."""
    for common in ("void ", "at::native::", "(anonymous namespace)::",
                   "at_cuda_detail::", "at::"):
        name = name.replace(common, "")
    return name if len(name) <= width else name[:width - 3] + "..."


def _innermost(host, starts, t, reach=4000):
    """The latest-started host operation that covers time ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    for e in host[max(0, i - reach):i + 1][::-1]:
        if e.time_range.end >= t:
            return e.name
    return None


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

class Window:
    """What the readers of metrics see: the calls of the window (host
    time sent, answered, work, ok), set-up seconds and peaks, and in a traced run
    the probes' spans and counters and the profiled share."""

    def __init__(self):
        self.calls = []
        self.start = 0.0
        self.setup_s = 0.0
        self.peak_bytes = 0
        self.spans = {}
        self.span_args = {}
        self.counters = {}
        self.busy_s = None
        self.traced_s = None

    @property
    def done(self):
        return [c for c in self.calls if c[3]]

    def elapsed(self) -> float:
        """Window start to the last completion."""
        return max(c[1] for c in self.done) - self.start


LATE_S = 60.0        # how long past the close an answer due is waited for


def drive(cell, entry, state, seed, seconds, win, after, log):
    """Call the entry for ``seconds`` from ``win.start`` as the traffic's
    loop says, recording (sent, answered, work, ok) a call in
    ``win.calls``; ``after(i)`` follows call i.

    Closed loop: ``clients`` calls are outstanding at any time; each
    client sends its next call when its last is answered, and the calls
    are answered one at a time in the order sent. No call is sent past
    the close. Open loop: calls arrive at the mix's times, each answered
    in order of arrival from its arrival on; every call that arrives
    before the close is due, and one not answered by ``LATE_S`` past the
    close never came."""
    mix = cell.traffic
    items = entry.items(state)
    deadline = win.start + seconds

    def serve(i, sent, item):
        try:
            answer, ok = entry.call(state, item), True
        except Exception:                   # an answer that never came
            answer, ok = None, False
            log(f"call {i} failed:\n{traceback.format_exc()}")
        t1 = time.perf_counter()
        win.calls.append((sent, t1, entry.work(state, item), ok))
        entry.keep(state, i, item, answer, ok, closing=t1 >= deadline)
        after(i)
        return t1

    if mix["loop"] == "closed":
        queue = deque((win.start, next(items)) for _ in range(mix["clients"]))
        for i in itertools.count():
            sent, item = queue.popleft()
            if i and time.perf_counter() >= deadline:
                break
            queue.append((serve(i, sent, item), next(items)))
        return
    for i, at in enumerate(generator.arrivals(seed, mix, seconds)):
        sent, item = win.start + at, next(items)
        now = time.perf_counter()
        if now < sent:
            time.sleep(sent - now)
        elif now > deadline + LATE_S:
            win.calls.append((sent, now, entry.work(state, item), False))
            continue
        serve(i, sent, item)


def _mean_call(calls) -> float:
    return sum(c[1] - c[0] for c in calls) / max(1, len(calls))


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: str = ROOT, overrides=None,
             t_process: float = None, log=None):
    """Set up, run the window, compare; returns the result line as a
    dict, ``checks`` last."""
    torch = _torch()
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    t_process = time.perf_counter() if t_process is None else t_process
    cell = Cell(name, root, overrides)
    entry = cell.entry()
    state = entry.setup(cell, seed, device, log)
    probes = Probes(cell.probe_specs(), device) if trace else None
    if probes:
        probes.install()
    trace_calls = int(cell.workload.get("trace_calls", 0)) if trace else 0
    synchronize(device)
    setup_peak = peak_bytes(device, reset=True)

    win = Window()
    win.setup_s = time.perf_counter() - t_process
    prof = None
    if trace_calls:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    traced = {}

    def after(i):
        if prof is not None and i + 1 == trace_calls and not traced:
            synchronize(device)
            win.traced_s = time.perf_counter() - win.start
            prof.__exit__(None, None, None)
            traced["prof"] = prof

    win.start = time.perf_counter()
    drive(cell, entry, state, seed, seconds, win, after, log)
    prof_done = traced.get("prof")
    if prof_done is not None:
        prof = None
    synchronize(device)
    win.peak_bytes = peak_bytes(device)
    third = max(1, len(win.calls) // 3)
    thirds = [win.calls[:third], win.calls[third:-third], win.calls[-third:]]
    lat = sorted(c[1] - c[0] for c in win.calls) or [0.0]
    log(f"window: {len(win.calls)} calls in "
        f"{time.perf_counter() - win.start:.3f} s; mean call "
        + " / ".join(f"{_mean_call(c):.4f}" for c in thirds)
        + f" s by thirds; latency min {lat[0]:.4f} median "
        f"{lat[len(lat) // 2]:.4f} max {lat[-1]:.4f} s")
    if prof is not None:                    # fewer calls than trace_calls
        win.traced_s = time.perf_counter() - win.start
        prof.__exit__(None, None, None)
        prof_done = prof
    if probes:
        probes.remove()
        win.spans, win.span_args = dict(probes.spans), dict(probes.args)
        win.counters = probes.counters
    breakdown = None
    if trace_calls:
        win.busy_s, breakdown = read_profile(
            prof_done, [p["name"] for p in cell.probe_specs()])

    entry.release(state)                    # the program's state goes
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    checks = entry.check(state, win, log)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cell.metric(m["name"]).read(win) if win.done else None
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    failed = sum(1 for c in win.calls if not c[3])
    correct = (failed == 0 and bool(win.calls)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    dev = torch.device(device)
    result = {
        "correct": correct,
        "attempted": len(win.calls),
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                     else "cpu"),
            "count": cell.chips,
            "memory_peak_bytes": max(setup_peak, win.peak_bytes)}}
    if trace:
        result["device"]["busy_s"] = win.busy_s
        result["device"]["window_s"] = win.traced_s
        if breakdown:
            result["breakdown"] = breakdown
    result["checks"] = checks
    for k, c in checks.items():
        log(f"check {k}: {c['value']} (limit {c['limit']})")
    return result
