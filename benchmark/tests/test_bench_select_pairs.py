"""The reader of the label query's selection counter
(``query.select_pairs``): a tiny traced run of the query cell reads it,
and a program without the counter declares no probe and reads nothing."""

from benchmark import harness
from benchmark.tests._tiny import ROOT, run

CELL = "query.dna31-canonical-rdbrwt"


def test_a_traced_run_reads_the_pairs_a_request():
    r = run(CELL, seconds=2.0, trace=True)
    assert r["correct"], (r["attempted"], r["checks"])
    v = r["metrics"]["query.select_pairs"]["value"]
    assert isinstance(v, float) and v > 0, r["metrics"]


def test_no_counter_probe_on_a_program_without_the_counter(monkeypatch):
    from metagraph_tpu_torch.engine import annotated_dbg
    monkeypatch.delattr(annotated_dbg, "select_pairs")
    reader = harness.Cell(CELL, ROOT).metric("query.select_pairs")
    assert reader.PROBES == []
    w = harness.Window()
    w.calls = [(0.0, 1.0, 1, True)]
    assert reader.read(w) is None
