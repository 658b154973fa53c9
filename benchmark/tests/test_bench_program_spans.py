"""The readers of the program's own spans (``benchmark/program_spans.py``):
a traced run of each cell reads every one, a run that is not traced
leaves the program's recorder off, and a program without the recorder or
counter, or a buffer that dropped records, reads nothing."""

import collections
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

from benchmark import harness, program_spans
from benchmark.tests._tiny import ROOT, run

NEW = {
    "build.dna31-primary": ["build.collect_ms", "build.dummies_ms",
                            "build.levels_ms", "build.emit_ms"],
    "query.dna31-canonical-rdbrwt": [
        "query.map_host_ms", "query.map_search_ms", "query.walk_ms",
        "query.descent_ms", "query.fold_ms", "query.sums_ms",
        "query.select_ms", "query.walk_nodes"],
}


@pytest.fixture(scope="module")
def traced():
    """One tiny traced run of each cell, long enough for the build cell's
    two checked builds whatever else the host runs."""
    return {cell: run(cell, seconds=3.0, trace=True) for cell in NEW}


@pytest.mark.parametrize("cell", sorted(NEW))
def test_a_traced_run_reads_every_new_metric(traced, cell):
    r = traced[cell]
    assert r["correct"], (r["attempted"], r["checks"])
    for name in NEW[cell]:
        v = r["metrics"].get(name, {}).get("value")
        assert isinstance(v, float) and v > 0, (name, r["metrics"])


def test_build_stages_add_up_to_the_build(traced):
    """Per build: the collect, the finish's three stages and the finish's
    own time make up the ``build`` span, less the build's own time, which
    is small in a typical build (a pause of the host can land in it)."""
    from metagraph_tpu_torch.common import telemetry
    recs, dropped = telemetry.recorded()
    assert not dropped
    builds = [r for r in recs if r.name == "build"]
    assert builds
    for b in builds:
        mine = [r for r in recs if r.root == b.id]
        assert sorted(r.name for r in mine) == sorted(
            ["build", "collect", "finish", "finish.dummies", "finish.levels",
             "finish.emit"])
        parts = sum(r.t1 - r.t0 for r in mine if r.name in (
            "collect", "finish.dummies", "finish.levels", "finish.emit"))
        own = next(r.self_s for r in mine if r.name == "finish")
        assert parts + own + b.self_s == pytest.approx(b.t1 - b.t0)
    shares = sorted(b.self_s / (b.t1 - b.t0) for b in builds)
    assert shares[len(shares) // 2] < 0.02


def test_a_run_that_is_not_traced_leaves_the_recorder_off():
    code = ("import sys, json; sys.path.insert(0, %r)\n"
            "from benchmark.tests._tiny import run\n"
            "from metagraph_tpu_torch.common import telemetry\n"
            "r = run('query.dna31-canonical-rdbrwt', trace=False)\n"
            "print(json.dumps([telemetry.TRACING, sorted(r['metrics']),"
            " telemetry.recorded()[0] == []]))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={k: v for k, v in os.environ.items()
                              if k != "METAGRAPH_TPU_TRACE_DIR"})
    assert out.returncode == 0, out.stderr[-2000:]
    tracing, names, empty = json.loads(out.stdout.strip().splitlines()[-1])
    assert not tracing and empty
    assert names == ["query_p95_ms", "query_reads_per_s", "setup_s"]


def _win(records, dropped=0, monkeypatch=None):
    rec = [SimpleNamespace(id=i, name=n, parent=p, root=rt, t0=t0, t1=t1,
                           self_s=s)
           for i, n, p, rt, t0, t1, s in records]
    stub = SimpleNamespace(recorded=lambda: (rec, dropped))
    monkeypatch.setattr(program_spans, "telemetry", stub)
    w = harness.Window()
    w.start, w.calls = 10.0, [(10.0, 12.0, 1, True), (12.0, 14.0, 1, True)]
    return w


def test_the_window_keeps_the_records_of_its_calls(monkeypatch):
    w = _win([(1, "query", None, 1, 9.0, 9.5, 0.5),      # before the window
              (2, "map", 3, 3, 10.2, 10.4, 0.1),
              (3, "query", None, 3, 10.1, 11.9, 1.6),
              (4, "map", 5, 5, 12.2, 12.8, 0.3),
              (5, "query", None, 5, 12.1, 13.9, 1.2),
              (6, "query", None, 6, 14.1, 14.5, 0.4)],     # after it
             monkeypatch=monkeypatch)
    assert program_spans.ms_per_call(w, "map") == pytest.approx(400.0)
    assert program_spans.ms_per_call(w, "map", own=True) == pytest.approx(
        200.0)
    assert program_spans.ms_per_call(w, "query") == pytest.approx(1800.0)
    assert program_spans.ms_per_call(w, "select") is None


def test_nothing_is_read_where_records_were_dropped(monkeypatch):
    w = _win([(3, "query", None, 3, 10.1, 11.9, 1.8)], dropped=1,
             monkeypatch=monkeypatch)
    assert program_spans.window_records(w) is None
    assert program_spans.ms_per_call(w, "query") is None


def test_nothing_is_read_from_a_program_without_the_recorder(monkeypatch):
    monkeypatch.setattr(program_spans, "telemetry", SimpleNamespace())
    w = harness.Window()
    w.calls = [(0.0, 1.0, 1, True)]
    cell = harness.Cell("build.dna31-primary", ROOT)
    for name in NEW["build.dna31-primary"]:
        assert cell.metric(name).read(w) is None


def test_no_counter_probe_on_a_program_without_the_counter(monkeypatch):
    from metagraph_tpu_torch.anno import row_diff
    monkeypatch.delattr(row_diff, "walk_nodes")
    reader = harness.Cell("query.dna31-canonical-rdbrwt",
                          ROOT).metric("query.walk_nodes")
    assert reader.PROBES == []
    w = harness.Window()
    w.calls = [(0.0, 1.0, 1, True)]
    assert reader.read(w) is None


def test_span_names_are_not_probe_names():
    spec = json.load(open(f"{ROOT}/BENCHMARK.json"))
    probes = {p["name"] for m in spec["per_layer"]
              for p in getattr(harness.Cell(m["workloads"][0], ROOT).metric(
                  m["name"]), "PROBES", ())}
    spans = {"build", "collect", "finish", "finish.dummies", "finish.levels",
             "finish.emit", "query", "map", "map.search", "sums",
             "anno.walk", "anno.descent", "anno.fold", "select"}
    assert not spans & probes
    assert collections.Counter(m["source"] for m in spec["per_layer"]
                               if m["name"] in sum(NEW.values(), [])) == {
        "program_span": 11, "program_counter": 1}
