"""The port's telemetry against the JAX package's, on the CPU.

``span`` prints the JAX package's stderr line (one format, the same
numbers' places) when verbose or counting items, and nothing otherwise;
with ``TRACING`` on it records (``recorded``; tests/test_torch_trace.py
covers the recorder); ``Timer``, ``get_curr_rss`` and ``device_trace``
(a ``torch.profiler`` trace where the JAX package writes a
``jax.profiler`` one; the CLI writes one of its command where
``METAGRAPH_TPU_TRACE_DIR`` says, the library's spans among its
ranges). Through the CLI, ``-v`` prints the JAX CLI's span
names for ``build`` and ``align`` (and its out-of-core build the names
the JAX CLI's code gives), and stdout is byte for byte the same with and
without it, and the JAX CLI's.
"""

import collections
import os
import re

import numpy as np
import pytest
import torch

from conftest import random_dna
from metagraph_tpu.cli.main import main as jmain
from metagraph_tpu.common import telemetry as jtel
from metagraph_tpu_torch.cli.main import main as tmain
from metagraph_tpu_torch.common import telemetry

torch.set_num_threads(2)

SPAN = re.compile(r"^\[span\] (\w+): \d+\.\d{3}s \(rss \d+\.\d{2} GB, "
                  r"\+-?\d+ MB(, \d+\.\d{2} M\w+/s)?\)$")


def span_names(err: str) -> list:
    names = []
    for line in err.splitlines():
        if line.startswith("[span]"):
            assert SPAN.match(line), line
            names.append(SPAN.match(line).group(1))
    return names


@pytest.fixture
def quiet(monkeypatch):
    """Both packages' spans off unless a test turns them on (the JAX
    CLI's -v leaves its flag set for the process); the port's recorder
    off, its buffer fresh."""
    monkeypatch.setattr(jtel, "VERBOSE", False)
    monkeypatch.setattr(telemetry, "VERBOSE", False)
    monkeypatch.setattr(telemetry, "TRACING", False)
    monkeypatch.setattr(telemetry, "_records",
                        collections.deque(maxlen=telemetry.RECORDS_MAX))
    monkeypatch.setattr(telemetry, "_dropped", 0)


@pytest.mark.parametrize("verbose,items", [(False, None), (False, 1000),
                                           (True, None), (True, 5)])
def test_span_line_as_jax(quiet, capsys, verbose, items):
    for mod in (jtel, telemetry):
        mod.VERBOSE = verbose
    capsys.readouterr()
    with jtel.span("stage", items=items, unit="chars"):
        pass
    want = capsys.readouterr().err
    with telemetry.span("stage", items=items, unit="chars"):
        pass
    got = capsys.readouterr().err
    assert re.sub(r"\d+", "0", got) == re.sub(r"\d+", "0", want)
    assert bool(got) == bool(verbose or items)
    assert span_names(got) == (["stage"] if got else [])


def test_span_totals_timer_rss(quiet):
    for _ in range(2):                   # off: a silent span records nothing
        with telemetry.span("totals_test"):
            sum(range(1000))
    assert telemetry.recorded() == ([], 0)
    telemetry.TRACING = True
    for _ in range(2):
        with telemetry.span("totals_test"):
            sum(range(1000))
    recs, dropped = telemetry.recorded()
    assert [r.name for r in recs] == ["totals_test"] * 2 and dropped == 0
    assert sum(r.self_s for r in recs) > 0
    t = telemetry.Timer()
    assert t.elapsed() >= 0
    t.reset()
    assert t.elapsed() < 60
    rss = telemetry.get_curr_rss()
    assert 1 << 20 < rss < 1 << 40


def test_device_trace_and_record_function(quiet, tmp_path, monkeypatch):
    with telemetry.device_trace():                 # no directory: no trace
        pass
    assert not os.listdir(tmp_path)
    monkeypatch.setattr(telemetry, "_TRACE_DIR", str(tmp_path))
    monkeypatch.setattr(telemetry, "TRACING", True)     # as the variable
    with telemetry.device_trace():
        with telemetry.span("traced_span"):
            torch.ones(8).sum()
    traces = os.listdir(tmp_path)
    assert len(traces) == 1 and traces[0].endswith(".json")
    assert "traced_span" in (tmp_path / traces[0]).read_text()


def test_cli_trace_dir(quiet, fasta, tmp_path, monkeypatch):
    """METAGRAPH_TPU_TRACE_DIR: the command runs inside ``device_trace``,
    its spans ranges of the trace, the library's (which the variable
    turns on with the trace) among them."""
    monkeypatch.setattr(telemetry, "_TRACE_DIR", str(tmp_path))
    monkeypatch.setattr(telemetry, "TRACING", True)     # as the variable
    tmain(["build", "-k", "11", "-o", str(fasta / "tr"),
           str(fasta / "in.fa"), "--device", "cpu"])
    traces = os.listdir(tmp_path)
    assert len(traces) == 1 and traces[0].endswith(".json")
    text = (tmp_path / traces[0]).read_text()
    assert '"construct"' in text and '"serialize"' in text
    assert '"collect"' in text and '"finish.levels"' in text


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tel")
    rng = np.random.default_rng(31)
    recs = [random_dna(rng, 200) for _ in range(3)]
    (tmp / "in.fa").write_bytes(b"".join(
        b">r%d\n%s\n" % (i, s) for i, s in enumerate(recs)))
    (tmp / "q.fa").write_bytes(b"".join(
        b">q%d\n%s\n" % (i, s[10:80]) for i, s in enumerate(recs)))
    return tmp


FLOWS = {
    "build": ["build", "-k", "11", "-o", "{d}/{p}g", "{d}/in.fa"],
    "build_ooc": ["build", "-k", "11", "--num-shards", "2", "-o",
                  "{d}/{p}o", "{d}/in.fa"],
    "align": ["align", "-i", "{d}/{p}a", "{d}/q.fa"],
}


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_cli_spans_as_jax(quiet, fasta, capsys, flow):
    """-v: the JAX CLI's span names on stderr, in its order; stdout the
    same with and without -v, and the same as the JAX CLI's."""
    if flow == "align":
        jmain(["build", "-k", "11", "-o", str(fasta / "ja"),
               str(fasta / "in.fa")])
        tmain(["build", "-k", "11", "-o", str(fasta / "ta"),
               str(fasta / "in.fa"), "--device", "cpu"])

    def cli(main, prefix, extra):
        capsys.readouterr()
        main([a.format(d=fasta, p=prefix) for a in FLOWS[flow]] + extra)
        out = capsys.readouterr()
        return out.out, span_names(out.err)

    got_out, got_spans = cli(tmain, "t", ["-v", "--device", "cpu"])
    assert got_spans == {"build": ["construct", "serialize"],
                         "build_ooc": ["construct_ooc", "serialize"],
                         "align": ["align_batch"]}[flow]
    if flow != "build_ooc":
        # (the JAX CLI's out-of-core build collects chunks of 2^25 codes:
        # a minute on the CPU for any input; its spans are the two above,
        # metagraph_tpu/cli/main.py:265 and :291)
        want_out, want_spans = cli(jmain, "j", ["-v"])
        jtel.VERBOSE = False
        assert got_spans == want_spans
        assert got_out == want_out
    assert not telemetry.VERBOSE                 # -v for its command only
    quiet_out, quiet_spans = cli(tmain, "t", ["--device", "cpu"])
    assert quiet_out == got_out
    # spans that count items print without -v, as in the JAX CLI (the
    # out-of-core build streams its input: no count)
    assert quiet_spans == [n for n in got_spans
                           if n not in ("serialize", "construct_ooc")]
