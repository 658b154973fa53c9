"""The port's span recorder (``common/telemetry.py``) on the CPU.

Off (the default), a span that does not print costs a flag test: no
synchronise, no RSS read, no record. On (``telemetry.TRACING``), every
span records (id, name, parent, root, t0, t1) with its self time in a
bounded buffer that counts what it drops. The build records one
``build`` root with ``collect`` and ``finish`` (``finish.dummies``,
``finish.levels``, ``finish.emit``), the label query one ``query`` root
with ``map`` (``map.search``), ``sums`` (the annotation's ``anno.walk``,
``anno.descent``, ``anno.fold``) and ``select``; ``row_diff.walk_nodes``
counts the walks' nodes. Tracing changes no result.
"""

import collections
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from conftest import random_dna
from metagraph_tpu_torch.anno import row_diff
from metagraph_tpu_torch.anno.annotator import Annotation
from metagraph_tpu_torch.common import telemetry
from metagraph_tpu_torch.engine.annotated_dbg import (AnnotatedDbg,
                                                      BatchQuery,
                                                      annotate_sequences)
from metagraph_tpu_torch.graph.boss_construct import build_boss_from_codes
from metagraph_tpu_torch.graph.dbg_succinct import DbgSuccinct
from metagraph_tpu_torch.kmer.alphabets import DNA
from metagraph_tpu_torch.kmer.extractor import encode_sequences

torch.set_num_threads(2)


@pytest.fixture
def buffer(monkeypatch):
    """A fresh record buffer, the spans silent and tracing off unless a
    test turns it on."""
    monkeypatch.setattr(telemetry, "_records",
                        collections.deque(maxlen=telemetry.RECORDS_MAX))
    monkeypatch.setattr(telemetry, "_dropped", 0)
    monkeypatch.setattr(telemetry, "VERBOSE", False)
    monkeypatch.setattr(telemetry, "TRACING", False)


@pytest.fixture
def calls(buffer, monkeypatch):
    """Counts of ``torch.cuda.synchronize`` and ``get_curr_rss`` calls, as
    if CUDA were in use."""
    n = collections.Counter()
    monkeypatch.setattr(telemetry, "_cuda_in_use", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: n.update(["sync"]))
    monkeypatch.setattr(telemetry, "get_curr_rss",
                        lambda: n.update(["rss"]) or 1 << 30)
    return n


@pytest.mark.parametrize("quiet", [True, False])
def test_span_off_neither_synchronises_nor_reads_rss(calls, quiet):
    with telemetry.span("off", quiet=quiet):
        with telemetry.span("off.inner", quiet=quiet):
            pass
    assert not calls
    assert telemetry.recorded() == ([], 0)
    assert telemetry.span("off", quiet=quiet) is telemetry.span("x")


@pytest.mark.parametrize("quiet", [True, False])
def test_span_on_synchronises_and_records(calls, quiet, capsys):
    telemetry.TRACING = True
    with telemetry.span("on", quiet=quiet):
        pass
    assert calls == {"sync": 2}                 # entry and exit; no RSS
    (rec,), dropped = telemetry.recorded()
    assert (rec.name, rec.parent, rec.root, dropped) == ("on", None,
                                                         rec.id, 0)
    assert rec.t1 >= rec.t0 and rec.self_s == rec.t1 - rec.t0
    assert not capsys.readouterr().err          # recording never prints


def test_nested_spans_parent_root_and_self_time(buffer):
    telemetry.TRACING = True
    with telemetry.span("a", quiet=True):
        with telemetry.span("b", quiet=True):
            with telemetry.span("c", quiet=True):
                time.sleep(0.002)
            time.sleep(0.002)
        with telemetry.span("d", quiet=True):
            time.sleep(0.002)
        time.sleep(0.002)
    with telemetry.span("e", quiet=True):
        pass
    recs, dropped = telemetry.recorded()
    by = {r.name: r for r in recs}
    assert [r.name for r in recs] == ["c", "b", "d", "a", "e"]  # by end
    a, b, c, d, e = (by[x] for x in "abcde")
    assert a.parent is None and a.root == a.id
    assert (b.parent, c.parent, d.parent) == (a.id, b.id, a.id)
    assert {b.root, c.root, d.root} == {a.id}
    assert e.parent is None and e.root == e.id != a.id
    dur = {r.name: r.t1 - r.t0 for r in recs}
    assert a.self_s == pytest.approx(dur["a"] - dur["b"] - dur["d"])
    assert b.self_s == pytest.approx(dur["b"] - dur["c"])
    assert c.self_s == pytest.approx(dur["c"])
    assert all(r.self_s >= 0.0015 for r in (a, b, c, d))
    assert dropped == 0


def test_threads_keep_their_own_roots(buffer):
    telemetry.TRACING = True

    def work():
        with telemetry.span("t.outer", quiet=True):
            with telemetry.span("t.inner", quiet=True):
                pass
    with telemetry.span("main", quiet=True):
        th = threading.Thread(target=work)
        th.start()
        th.join()
    by = {r.name: r for r in telemetry.recorded()[0]}
    assert by["t.outer"].parent is None
    assert by["t.inner"].root == by["t.outer"].id != by["main"].id


def test_buffer_counts_what_it_drops(buffer, monkeypatch):
    monkeypatch.setattr(telemetry, "_records", collections.deque(maxlen=3))
    telemetry.TRACING = True
    for i in range(5):
        with telemetry.span(f"s{i}", quiet=True):
            pass
    recs, dropped = telemetry.recorded()
    assert [r.name for r in recs] == ["s2", "s3", "s4"] and dropped == 2


def _codes(seed, n_records=6, length=300):
    rng = np.random.default_rng(seed)
    return encode_sequences([random_dna(rng, length)
                             for _ in range(n_records)], DNA)


def _arrays(boss):
    return [np.asarray(x) for x in (boss.W.cpu(), boss.last, boss.F.cpu(),
                                    boss.edge_lanes.cpu(),
                                    boss.num_nodes())]


@pytest.mark.parametrize("mode", ["primary", "canonical"])
def test_build_records_its_stages(buffer, mode):
    codes = _codes(11)
    off = build_boss_from_codes(codes, 11, DNA, mode=mode, device="cpu")
    assert telemetry.recorded() == ([], 0)
    telemetry.TRACING = True
    on = build_boss_from_codes(codes, 11, DNA, mode=mode, device="cpu")
    for x, y in zip(_arrays(off), _arrays(on)):
        np.testing.assert_array_equal(x, y)
    recs, dropped = telemetry.recorded()
    assert dropped == 0
    (root,) = [r for r in recs if r.parent is None]
    assert root.name == "build" and all(r.root == root.id for r in recs)
    kids = lambda p: [r.name for r in sorted(recs, key=lambda r: r.t0)
                      if r.parent == p.id]
    assert kids(root) == ["collect", "finish"]
    finish = next(r for r in recs if r.name == "finish")
    assert kids(finish) == ["finish.dummies", "finish.levels",
                            "finish.emit"]
    # the stages and the finish's own time make up the build, less the
    # build's own time (a pause of the host can land in it)
    parts = sum(r.t1 - r.t0 for r in recs if r.name in (
        "collect", "finish.dummies", "finish.levels", "finish.emit"))
    assert parts + finish.self_s + root.self_s == pytest.approx(
        root.t1 - root.t0)
    assert 0 <= root.self_s < root.t1 - root.t0


@pytest.fixture(scope="module")
def index():
    """A canonical k = 15 graph of 8 records, a label a record, served as
    RowDiff<Multi-BRWT> with walks of at most 4 nodes; 24 reads, some cut
    from the records (half reverse-complemented), some random."""
    rng = np.random.default_rng(19)
    recs = [random_dna(rng, 240) for _ in range(8)]
    boss = build_boss_from_codes(encode_sequences(recs, DNA), 15, DNA,
                                 mode="canonical", device="cpu")
    graph = DbgSuccinct.from_boss(boss, DNA, mode="canonical")
    ann = annotate_sequences(graph, [(r, [f"rec_{i}"])
                                     for i, r in enumerate(recs)]).finalize()
    matrix = row_diff.build_row_diff_brwt(ann.matrix.to_row_sparse(), graph,
                                          max_length=4)
    bq = BatchQuery(AnnotatedDbg(graph=graph, annotation=Annotation(
        matrix=matrix, encoder=ann.encoder)))
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    reads = []
    for i in range(24):
        if i % 4 == 3:
            reads.append(random_dna(rng, 80))
            continue
        r = recs[i % 8]
        a = int(rng.integers(0, len(r) - 80))
        read = r[a:a + 80]
        reads.append(read.translate(comp)[::-1] if i % 2 else read)
    return bq, reads


def test_label_query_records_its_layers(buffer, index, monkeypatch):
    bq, reads = index
    off = bq.get_labels_batch(reads, 0.7)
    assert telemetry.recorded() == ([], 0)
    assert any(off) and not all(off)
    walked = []
    walk = row_diff.walk_paths

    def spy(*a, **k):
        out = walk(*a, **k)
        walked.append(out[1].shape[0])
        return out
    monkeypatch.setattr(row_diff, "walk_paths", spy)
    telemetry.TRACING = True
    n0 = row_diff.walk_nodes
    on = bq.get_labels_batch(reads, 0.7)
    assert on == off
    assert row_diff.walk_nodes - n0 == sum(walked) > len(walked)
    recs, dropped = telemetry.recorded()
    (root,) = [r for r in recs if r.parent is None]
    assert root.name == "query" and dropped == 0
    assert all(r.root == root.id for r in recs)
    by_id = {r.id: r for r in recs}
    parent = {r.name: by_id[r.parent].name for r in recs if r.parent}
    assert parent == {"map": "query", "map.search": "map", "sums": "query",
                      "anno.walk": "sums", "anno.descent": "sums",
                      "anno.fold": "sums", "select": "query"}
    names = [r.name for r in sorted(recs, key=lambda r: r.t0)]
    assert names == ["query", "map", "map.search", "sums", "anno.walk",
                     "anno.descent", "anno.fold", "select", "select"]


def test_walk_nodes_counts_the_walks_nodes():
    anchor = torch.tensor([False, False, True, False, True])
    succ = torch.tensor([1, 2, 3, -1, 0])
    rows = torch.tensor([0, 3, 4, 1])
    n0 = row_diff.walk_nodes
    q, nodes, depth = row_diff.walk_paths(anchor, succ, rows, 4)
    assert row_diff.walk_nodes - n0 == nodes.shape[0] == 7
    assert q.tolist() == [0, 1, 2, 3, 0, 3, 0]


@pytest.mark.parametrize("trace_dir", [None, "trace_out"])
def test_trace_dir_turns_tracing_on(tmp_path, trace_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "METAGRAPH_TPU_TRACE_DIR"}
    if trace_dir:
        env["METAGRAPH_TPU_TRACE_DIR"] = str(tmp_path / trace_dir)
    out = subprocess.run(
        [sys.executable, "-c", "from metagraph_tpu_torch.common import "
         "telemetry as t; print(t.TRACING)"],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.stdout.strip() == str(bool(trace_dir)), out.stderr
