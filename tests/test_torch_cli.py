"""The port's CLI against the JAX package's CLI, in process.

build (from FASTA in modes basic, canonical and primary, and from a KMC
database), annotate, query (also with --align), align and stats must
print byte-identical stdout (the port with ``--device cpu``), and a
``.dbg.npz`` written by either package must load in the other. On
primary graphs align and query --align print alike for reads with a
full k-mer seed, and both packages fail on a read that needs suffix
seeds (a fault of the reference, matched).
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import random_dna
from metagraph_tpu.cli.main import main as jmain
from metagraph_tpu_torch.cli.main import main as tmain
from test_torch_kmc import write_kmc2

torch.set_num_threads(2)


def run(capsys, main, argv):
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out


def tport(capsys, argv):
    return run(capsys, tmain, argv + ["--device", "cpu"])


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    rng = np.random.default_rng(21)
    tmp = tmp_path_factory.mktemp("cli")
    recs = [random_dna(rng, int(rng.integers(20, 240))) for _ in range(16)]
    recs.append(b"ACGTNACGTACGTTTGCANNACGT")
    with open(tmp / "in.fa", "wb") as f:
        for i, s in enumerate(recs):
            f.write(b">rec%d some comment\n%s\n" % (i, s))
    with open(tmp / "q.fa", "wb") as f:
        for i, s in enumerate(recs):
            f.write(b">q%d\n%s\n" % (i, s[5:5 + int(rng.integers(8, 80))]))
        f.write(b">random\n" + random_dna(rng, 70) + b"\n>short\nACG\n")
    with open(tmp / "reads.fq", "wb") as f:
        for i, s in enumerate(recs[:6]):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, s, b"I" * len(s)))
    return tmp


BUILDS = [("basic", []), ("canonical", []), ("basic", ["--count-kmers"]),
          ("canonical", ["--count-kmers", "--count-width", "4"])]


@pytest.mark.parametrize("mode,extra", BUILDS)
def test_build_stats_identical(fasta, capsys, mode, extra):
    for k, inp in (("13", "in.fa"), ("31", "reads.fq")):
        j, t = str(fasta / f"j{mode}{k}"), str(fasta / f"t{mode}{k}")
        args = ["build", "-k", k, "--mode", mode] + extra
        run(capsys, jmain, args + ["-o", j, str(fasta / inp)])
        tport(capsys, args + ["-o", t, str(fasta / inp)])
        want = run(capsys, jmain, ["stats", j])
        assert want.startswith("====")
        assert tport(capsys, ["stats", t]) == want
        # the .dbg.npz files cross-load both ways
        assert run(capsys, jmain, ["stats", t]) == want
        assert tport(capsys, ["stats", j]) == want


QUERIES = [
    [],
    ["--discovery-fraction", "0.0"],
    ["--count-labels", "--discovery-fraction", "0.2"],
    ["--count-labels", "--num-top-labels", "2", "--discovery-fraction", "0"],
    ["--labels-delimiter", ",", "--discovery-fraction", "0.1",
     "--suppress-unlabeled"],
]


@pytest.mark.parametrize("mode", ["basic", "canonical"])
def test_annotate_query_identical(fasta, capsys, mode):
    j, t = str(fasta / f"aj{mode}"), str(fasta / f"at{mode}")
    inp = str(fasta / "in.fa")
    run(capsys, jmain, ["build", "-k", "15", "--mode", mode, "-o", j, inp])
    tport(capsys, ["build", "-k", "15", "--mode", mode, "-o", t, inp])
    anno = ["--anno-header", "--anno-label", "all", "--anno-filename"]
    run(capsys, jmain, ["annotate", "-i", j] + anno + [inp])
    tport(capsys, ["annotate", "-i", t] + anno + [inp])
    ja, ta = j + ".column.annodbg.npz", t + ".column.annodbg.npz"
    assert tport(capsys, ["stats", ta]) == run(capsys, jmain, ["stats", ja])
    for q in QUERIES:
        argv = ["query"] + q + [str(fasta / "q.fa")]
        want = run(capsys, jmain, argv[:1] + ["-i", j, "-a", ja] + argv[1:])
        assert want
        assert tport(capsys, argv[:1] + ["-i", t, "-a", ta] + argv[1:]) \
            == want
        # and the port queries the JAX package's files the same way
        assert tport(capsys, argv[:1] + ["-i", j, "-a", ja] + argv[1:]) \
            == want


def test_annotate_counts_identical(fasta, capsys):
    j, t = str(fasta / "cj"), str(fasta / "ct")
    inp = str(fasta / "in.fa")
    run(capsys, jmain, ["build", "-k", "11", "-o", j, inp])
    tport(capsys, ["build", "-k", "11", "-o", t, inp])
    run(capsys, jmain, ["annotate", "-i", j, "--anno-header",
                        "--count-kmers", inp])
    tport(capsys, ["annotate", "-i", t, "--anno-header", "--count-kmers",
                   inp])
    jz = np.load(j + ".column.annodbg.npz")
    tz = np.load(t + ".column.annodbg.npz")
    for key in ("rows", "cols", "values", "shape", "labels"):
        np.testing.assert_array_equal(tz[key], jz[key])


def annotate_and_query(capsys, j, t, inp, queries):
    """Annotate graphs j (JAX) and t (port) with the records of ``inp``
    and check the annotation stats and every query of QUERIES."""
    anno = ["--anno-header", "--anno-label", "all", "--anno-filename"]
    run(capsys, jmain, ["annotate", "-i", j] + anno + [inp])
    tport(capsys, ["annotate", "-i", t] + anno + [inp])
    ja, ta = j + ".column.annodbg.npz", t + ".column.annodbg.npz"
    assert tport(capsys, ["stats", ta]) == run(capsys, jmain, ["stats", ja])
    for q in QUERIES:
        argv = ["query"] + q + [queries]
        want = run(capsys, jmain, argv[:1] + ["-i", j, "-a", ja] + argv[1:])
        assert want
        assert tport(capsys, argv[:1] + ["-i", t, "-a", ta] + argv[1:]) \
            == want


@pytest.mark.parametrize("extra", [[], ["--count-kmers"]])
def test_primary_build_annotate_query_identical(fasta, capsys, extra):
    j, t = str(fasta / f"pj{len(extra)}"), str(fasta / f"pt{len(extra)}")
    inp = str(fasta / "in.fa")
    args = ["build", "-k", "15", "--mode", "primary"] + extra
    run(capsys, jmain, args + ["-o", j, inp])
    tport(capsys, args + ["-o", t, inp])
    want = run(capsys, jmain, ["stats", j])
    assert "mode: primary" in want
    assert tport(capsys, ["stats", t]) == want
    assert tport(capsys, ["stats", j]) == want
    annotate_and_query(capsys, j, t, inp, str(fasta / "q.fa"))


@pytest.fixture(scope="module")
def kmc_db(fasta):
    """A both-strand KMC2 database of the k = 11 k-mers of in.fa's
    records, each canonical form with its count."""
    tbl = np.full(256, 255, np.uint8)
    tbl[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    codes = tbl[np.frombuffer(b"N".join(
        line for line in (fasta / "in.fa").read_bytes().split(b"\n")
        if not line.startswith(b">")), np.uint8)]
    win = np.lib.stride_tricks.sliding_window_view(codes, 11)
    win = win[(win != 255).all(axis=1)]
    rc = 3 - win[:, ::-1]
    take = np.array([tuple(r) < tuple(w) for r, w in zip(rc, win)])
    kmers, counts = np.unique(np.where(take[:, None], rc, win), axis=0,
                              return_counts=True)
    return write_kmc2(str(fasta / "db"), kmers, counts.astype(np.int64), 11,
                      4, 5, 3, 0)


@pytest.mark.parametrize("mode,extra", [
    ("basic", []), ("canonical", ["--min-count", "2"]),
    ("primary", ["--count-kmers"]),
    ("basic", ["--min-count", "2", "--max-count", "3", "--count-kmers"])])
def test_kmc_build_stats_identical(fasta, kmc_db, capsys, mode, extra):
    j, t = (str(fasta / f"kj{mode}{len(extra)}"),
            str(fasta / f"kt{mode}{len(extra)}"))
    args = ["build", "-k", "11", "--mode", mode] + extra
    run(capsys, jmain, args + ["-o", j, kmc_db + ".kmc_pre"])
    tport(capsys, args + ["-o", t, kmc_db + ".kmc_pre"])
    want = run(capsys, jmain, ["stats", j])
    assert f"mode: {mode}" in want
    assert tport(capsys, ["stats", t]) == want
    if mode == "primary":
        annotate_and_query(capsys, j, t, str(fasta / "in.fa"),
                           str(fasta / "q.fa"))


@pytest.fixture(scope="module")
def primary_align(fasta, tmp_path_factory):
    """A k = 15 primary graph of in.fa and its --anno-header annotation,
    built by each package, and reads that all hold a full k-mer seed:
    substrings of the records and their reverse complements."""
    tmp = tmp_path_factory.mktemp("palign")
    inp = str(fasta / "in.fa")
    j, t = str(tmp / "j"), str(tmp / "t")
    for main, g, dev in ((jmain, j, []), (tmain, t, ["--device", "cpu"])):
        main(["build", "-k", "15", "--mode", "primary", "-o", g, inp] + dev)
        main(["annotate", "-i", g, "--anno-header", inp] + dev)
    rng = np.random.default_rng(23)
    recs = [line for line in (fasta / "in.fa").read_bytes().split(b"\n")
            if line and not line.startswith(b">") and b"N" not in line]
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    with open(tmp / "reads.fa", "wb") as f:
        for i, s in enumerate(recs):
            a = int(rng.integers(0, len(s) - 15))
            r = s[a:a + int(rng.integers(15, 90))]
            f.write(b">fwd%d\n%s\n>rc%d\n%s\n"
                    % (i, r, i, r.translate(comp)[::-1]))
    with open(tmp / "unseeded.fa", "wb") as f:
        f.write(b">ok\n" + recs[0][:40] + b"\n>random\n"
                + random_dna(rng, 60) + b"\n")
    return j, t, str(tmp / "reads.fa"), str(tmp / "unseeded.fa")


@pytest.mark.parametrize("argv", [
    ["align"],
    ["align", "--json"],
    ["align", "--align-both-strands", "--num-alternative-paths", "2"],
    ["align", "--map", "--count-kmers"],
    ["query", "--align"],
    ["query", "--batch-align", "--count-labels", "--discovery-fraction",
     "0.5"],
], ids=["tsv", "json", "both-strands", "map", "query-align",
        "query-batch-align"])
def test_primary_align_identical(primary_align, capsys, argv):
    """align and query --align on a primary graph: every read aligns
    (forward or reverse complement) and prints as the JAX package's."""
    j, t, reads, _ = primary_align

    def cmd(g):
        anno = ["-a", g + ".column.annodbg.npz"] if argv[0] == "query" else []
        return [argv[0], "-i", g] + anno + argv[1:] + [reads]

    want = run(capsys, jmain, cmd(j))
    assert want
    assert tport(capsys, cmd(t)) == want
    if argv == ["align"]:
        rows = [line.split("\t") for line in want.splitlines()]
        assert all(r[2] == "+" and r[3] == r[1] and r[6] == f"{len(r[1])}="
                   for r in rows)


@pytest.mark.parametrize("what", ["align", "query --align"])
def test_primary_suffix_seeds_exit_nonzero(primary_align, capsys, what):
    """A read without a full k-mer seed needs suffix seeds, which the
    reference aligner cannot search on a primary graph: both packages
    exit non-zero, the port naming the reference's fault."""
    j, t, _, unseeded = primary_align
    argv = what.split()
    for main, g in ((jmain, j), (tmain, t)):
        anno = ["-a", g + ".column.annodbg.npz"] if argv[0] == "query" else []
        full = argv[:1] + ["-i", g] + anno + argv[1:] + [unseeded]
        if main is jmain:
            with pytest.raises(AttributeError, match="boss"):
                run(capsys, main, full)
        else:
            with pytest.raises(SystemExit) as e:
                tport(capsys, full)
            assert "metagraph_tpu/align/aligner.py:337" in str(e.value.code)


@pytest.fixture(scope="module")
def align_graphs(fasta, tmp_path_factory):
    """A k=15 basic graph of in.fa built by each package."""
    tmp = tmp_path_factory.mktemp("align")
    j, t = str(tmp / "j"), str(tmp / "t")
    inp = str(fasta / "in.fa")
    jmain(["build", "-k", "15", "-o", j, inp])
    tmain(["build", "-k", "15", "-o", t, inp, "--device", "cpu"])
    return j, t


ALIGNS = [
    [],
    ["--json"],
    ["--align-both-strands", "--num-alternative-paths", "2"],
    ["--align-edit-distance", "--align-min-path-score", "10"],
    ["--map"],
    ["--map", "--count-kmers"],
    ["--query-presence", "--discovery-fraction", "0.5"],
    ["--query-presence", "--filter-present"],
]


@pytest.mark.parametrize("flags", ALIGNS)
def test_align_identical(fasta, align_graphs, capsys, flags):
    j, t = align_graphs
    q = str(fasta / "q.fa")
    want = run(capsys, jmain, ["align", "-i", j] + flags + [q])
    assert want
    assert tport(capsys, ["align", "-i", t] + flags + [q]) == want


def test_align_to_file(fasta, align_graphs, capsys, tmp_path):
    j, t = align_graphs
    q = str(fasta / "q.fa")
    run(capsys, jmain, ["align", "-i", j, "-o", str(tmp_path / "j.tsv"), q])
    assert tport(capsys, ["align", "-i", t, "-o", str(tmp_path / "t.tsv"),
                          q]) == ""
    assert (tmp_path / "t.tsv").read_bytes() == \
        (tmp_path / "j.tsv").read_bytes()


@pytest.mark.parametrize("mode", ["basic", "canonical"])
def test_query_align_identical(fasta, capsys, mode):
    j, t = str(fasta / f"qj{mode}"), str(fasta / f"qt{mode}")
    inp = str(fasta / "in.fa")
    run(capsys, jmain, ["build", "-k", "15", "--mode", mode, "-o", j, inp])
    tport(capsys, ["build", "-k", "15", "--mode", mode, "-o", t, inp])
    run(capsys, jmain, ["annotate", "-i", j, "--anno-header", inp])
    tport(capsys, ["annotate", "-i", t, "--anno-header", inp])
    for flags in (["--align"],
                  ["--batch-align", "--align-min-exact-match", "0.5",
                   "--count-labels", "--discovery-fraction", "0.5",
                   "--max-hull-depth", "3", "--fast"]):
        argv = ["query"] + flags + [str(fasta / "q.fa")]
        want = run(capsys, jmain, argv[:1] + ["-i", j, "-a",
                                              j + ".column.annodbg.npz"]
                   + argv[1:])
        assert want
        assert tport(capsys, argv[:1] + ["-i", t, "-a",
                                         t + ".column.annodbg.npz"]
                     + argv[1:]) == want


@pytest.mark.parametrize("command", ["server_query", "query --address"])
def test_unported_exits_nonzero(command, fasta, capsys, tmp_path):
    """server_query and query --address were once refused; now each
    makes a round trip: the port's server_query (a process of its own)
    answers the JAX CLI's query --address, and the port's query
    --address asks a JAX server, both printing what the JAX CLI's query
    -i -a prints."""
    from test_torch_server import free_port, serve_jax
    g = str(tmp_path / "g")
    inp, q = str(fasta / "in.fa"), str(fasta / "q.fa")
    run(capsys, jmain, ["build", "-k", "15", "-o", g, inp])
    run(capsys, jmain, ["annotate", "-i", g, "--anno-header", inp])
    anno = g + ".column.annodbg.npz"
    want = run(capsys, jmain, ["query", "-i", g, "-a", anno, q])
    assert "rec3" in want
    if command == "query --address":
        httpd, port, _ = serve_jax(g, anno)
        try:
            assert tport(capsys, ["query", "--address", f"127.0.0.1:{port}",
                                  q]) == want
        finally:
            httpd.shutdown()
        return
    from metagraph_tpu_torch.server.client import GraphClient
    port = free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "metagraph_tpu_torch.cli.main",
         "server_query", "-i", g, "-a", anno, "--port", str(port),
         "--device", "cpu"], env=dict(os.environ, PYTHONPATH=root),
        stderr=subprocess.PIPE, text=True)
    try:
        client = GraphClient("127.0.0.1", port)
        for _ in range(600):
            if client.ready() or proc.poll() is not None:
                break
            time.sleep(0.1)
        assert client.ready(), proc.stderr.read() if proc.poll() else ""
        assert run(capsys, jmain, ["query", "--address",
                                   f"127.0.0.1:{port}", q]) == want
    finally:
        proc.kill()
        proc.wait()


# the scale-out commands, unported until the parallel/ modules came:
# (commands, the files they write) with '@' the package's prefix
SCALE_OUT = {
    "concatenate": ([
        ["build", "-k", "11", "--suffix-len", "1", "--parts-total", "2",
         "--part-idx", "0", "-o", "@p", "in.fa"],
        ["build", "-k", "11", "--suffix-len", "1", "--parts-total", "2",
         "--part-idx", "1", "-o", "@p", "in.fa"],
        ["concatenate", "-o", "@c", "-i", "@p"]], ["@c.dbg.npz"]),
    "merge --num-shards": ([
        ["build", "-k", "11", "--count-kmers", "-o", "@m1", "in.fa"],
        ["build", "-k", "11", "--count-kmers", "-o", "@m2", "reads.fq"],
        ["merge", "--num-shards", "2", "-o", "@m", "@m1", "@m2"]],
        ["@m.dbg.npz"]),
    "build --suffix": ([["build", "-k", "11", "--suffix", "A", "-o", "@s",
                         "in.fa"]], ["@s.A.chunk.npz"]),
    "build --suffix-len": ([["build", "-k", "11", "--suffix-len", "2", "-o",
                             "@l", "in.fa"]], ["@l.dbg.npz"]),
    "transform_anno --disk-swap": ([
        ["build", "-k", "11", "-o", "@d", "in.fa"],
        ["annotate", "-i", "@d", "--anno-header", "in.fa"],
        ["transform_anno", "--anno-type", "row_diff", "-i", "@d",
         "--disk-swap", "@swap", "-o", "@rd", "@d.column.annodbg.npz"]],
        ["@rd.row_diff.annodbg.npz"]),
}


@pytest.mark.parametrize("flow", list(SCALE_OUT))
def test_scale_out_commands_identical(fasta, capsys, flow):
    """Each command's stdout and output files equal the JAX CLI's."""
    argvs, files = SCALE_OUT[flow]

    def at(x, p):
        return str(fasta / x.replace("@", p)) if (
            "@" in x or x.endswith((".fa", ".fq"))) else x

    for argv in argvs:
        want = run(capsys, jmain, [at(x, "j") for x in argv])
        assert tport(capsys, [at(x, "t") for x in argv]) == want
    for f in files:
        with np.load(at(f, "j")) as a, np.load(at(f, "t")) as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_device_cuda_without_gpu_raises(fasta, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain(["build", "-k", "11", "-o", str(fasta / "nogpu"),
               str(fasta / "in.fa"), "--device", "cuda"])
