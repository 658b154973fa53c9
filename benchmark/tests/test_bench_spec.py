"""BENCHMARK.json keeps to the benchmark's contract, and the harness finds
a cell, a configuration, a traffic mix and a metric by name: a cell that
later work adds as files and entries alone runs with no edit."""

import json
import os
import re
import shutil

import pytest

from benchmark import harness
from benchmark.tests._tiny import CELLS, ROOT, run

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_lines():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [x["name"] for x in SPEC["configs"] + SPEC["workloads"]] + \
        [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        cell = m.get("workloads", [SPEC["workloads"][0]["name"]])[0]
        assert callable(harness.Cell(cell, ROOT).metric(m["name"]).read)
    for w in SPEC["workloads"]:
        assert _line(w["why"]) and w["chips"] in (1, 4)
    for c in SPEC["configs"]:
        assert _line(c["why"]) and _line(c["source"])
        assert all(NAME.match(k) for k in c["reduced"])


def test_metrics_keep_to_the_contract():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m["workloads"]) <= cells
        assert all(c in e2e[m["moves"]].get("workloads", cells)
                   for c in m["workloads"])
        if "roofline" in m["name"] or "share" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        c = harness.Cell(cell, ROOT)
        assert any(m["name"] == "setup_s" for m in c.end_to_end)
        assert len(c.end_to_end) >= 2 and c.per_layer


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    c = harness.Cell(cell, ROOT)
    assert c.config["k"] == 31 and c.traffic["kind"]
    assert c.traffic["loop"] == "closed" and c.traffic["clients"] == 1
    assert hasattr(c.entry(), "setup")
    for m in c.per_layer + c.end_to_end:
        assert callable(c.metric(m["name"]).read)


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        harness.Cell("no.such-cell", ROOT)


def _copy(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    _write(os.path.join(root, "BENCHMARK.json"), SPEC)
    return root, os.path.join(root, "benchmark"), json.loads(json.dumps(SPEC))


def _write(path, obj):
    with open(path, "w") as f:
        f.write(obj if isinstance(obj, str) else json.dumps(obj))


def test_a_cell_added_as_files_alone(tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric, added
    as files and BENCHMARK.json entries to a copy of the tree, run on the
    CPU without an edit to any file that was there."""
    root, b, spec = _copy(tmp_path)
    before = {p: open(p).read() for p in _files(root)}
    cfg = json.load(open(os.path.join(b, "configs", "dna31-primary.json")))
    cfg.update(name="dna21-basic", k=21, mode="basic")
    _write(os.path.join(b, "configs", "dna21-basic.json"), cfg)
    _write(os.path.join(b, "traffic", "build_pool2.json"),
           {"kind": "code_pool", "pool": 2})
    _write(os.path.join(b, "workloads", "build.dna21-basic.json"),
           {"entry": "build", "trace_calls": 2, "check_builds": 2})
    _write(os.path.join(b, "metrics", "build.calls.py"),
           "def read(win):\n    return float(len(win.done))\n")
    spec["configs"].append(dict(spec["configs"][0], name="dna21-basic",
                                file="benchmark/configs/dna21-basic.json"))
    spec["workloads"].append({"name": "build.dna21-basic",
                              "config": "dna21-basic",
                              "traffic": "build_pool2", "chips": 1,
                              "why": "a fixture"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "build.dna31-primary" in m["workloads"]:
            m["workloads"].append("build.dna21-basic")
    spec["per_layer"].append({"name": "build.calls", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "fixture",
                              "moves": "build_kmers_per_s",
                              "workloads": ["build.dna21-basic"]})
    _write(os.path.join(root, "BENCHMARK.json"), spec)
    r = run("build.dna21-basic", seconds=1.0, root=root)
    assert r["correct"] and "build_kmers_per_s" in r["metrics"]
    r = run("build.dna21-basic", seconds=1.0, trace=True, root=root)
    assert r["correct"] and r["metrics"]["build.calls"]["value"] >= 1
    assert set(r["metrics"]) == {"build.calls"}
    assert all(open(p).read() == text for p, text in before.items())


RECIPE = '''"""Reads from the first bases of each record, one a record in turn."""

import numpy as np

from benchmark import generator

ROLE = "requests"
PARAMS = {"reads_per_request": None, "read_length": None,
          "pool_requests": None, "warm_requests": 1}


def request(seed, stream, index, bases, bounds, mix):
    n, rl = mix["reads_per_request"], mix["read_length"]
    rec = (np.arange(n) + index) % (len(bounds) - 1)
    return bases[bounds[rec][:, None] + np.arange(rl)]
'''


@pytest.mark.parametrize("loop", [{"clients": 2},
                                  {"loop": "open", "rate_per_s": 20.0}])
def test_a_traffic_kind_added_as_files_alone(tmp_path, loop):
    """A new kind of traffic (its recipe), a mix of it with two clients or
    an open loop, and a cell over an existing configuration, added as
    files and entries alone, run on the CPU with every read checked."""
    root, b, spec = _copy(tmp_path)
    before = {p: open(p).read() for p in _files(root)}
    _write(os.path.join(b, "recipes", "reads_at_starts.py"), RECIPE)
    _write(os.path.join(b, "traffic", "starts32.json"),
           dict({"kind": "reads_at_starts", "reads_per_request": 32,
                 "read_length": 60, "pool_requests": 2}, **loop))
    _write(os.path.join(b, "workloads", "query.starts.json"),
           {"entry": "label_query", "trace_calls": 2})
    spec["workloads"].append({"name": "query.starts",
                              "config": "dna31-canonical-rdbrwt",
                              "traffic": "starts32", "chips": 1,
                              "why": "a fixture"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "query.dna31-canonical-rdbrwt" in \
                m["workloads"]:
            m["workloads"].append("query.starts")
    _write(os.path.join(root, "BENCHMARK.json"), spec)
    r = run("query.starts", seconds=1.0, root=root)
    assert r["correct"] and r["attempted"] >= 2 and not r["failed"]
    assert r["metrics"]["query_reads_per_s"]["value"] > 0
    assert r["checks"]["reads_wrong"]["value"] == 0
    assert all(open(p).read() == text for p, text in before.items())


def test_a_mix_with_a_key_no_code_reads_is_refused(tmp_path):
    root, b, spec = _copy(tmp_path)
    mix = json.load(open(os.path.join(b, "traffic",
                                      "reads4096_closed1.json")))
    _write(os.path.join(b, "traffic", "reads4096_closed1.json"),
           dict(mix, order="shuffled"))
    with pytest.raises(ValueError, match="does not take"):
        harness.Cell("query.dna31-canonical-rdbrwt", root)


def _files(root):
    out = []
    for d, _, files in os.walk(os.path.join(root, "benchmark")):
        out += [os.path.join(d, f) for f in files if "__pycache__" not in d]
    return out

