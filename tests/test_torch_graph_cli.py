"""The port's graph commands against the JAX package's CLI, in process.

assemble (unitigs, contigs, GFA both ways, label masks), clean (min /
max counts, quantiles, the automatic threshold and its exit 129, tips,
smoothing, slices, unitigs), transform (every flag), compare, extend,
merge (weighted or not) and align -o *.gfa must give byte-identical
stdout and output files (FASTA and count sidecars compared
decompressed, GFA, .adjlist, .path.gfa) with the port on the CPU; a
.dbg.npz written by either package must hold the same arrays and load in
the other. Each package runs on the graphs it built itself, which are
checked equal first.
"""

import gzip
import os

import numpy as np
import pytest
import torch

from conftest import random_dna
from metagraph_tpu.cli.main import main as jmain
from metagraph_tpu_torch.cli.main import main as tmain
from test_torch_traversal import error_reads

torch.set_num_threads(2)

# name: (mode, k, input, extra build flags)
GRAPHS = {
    "b": ("basic", "9", "in.fa", []),
    "c": ("canonical", "11", "in.fa", []),
    "p": ("primary", "9", "in.fa", []),
    "w": ("canonical", "11", "reads.fa", ["--count-kmers"]),
    "wb": ("basic", "11", "reads.fa", ["--count-kmers", "--count-width", "5"]),
    "d": ("basic", "11", "dup.fa", ["--count-kmers"]),
    "h1": ("canonical", "11", "half1.fa", ["--count-kmers"]),
    "h2": ("canonical", "11", "half2.fa", ["--count-kmers"]),
    "hb1": ("basic", "9", "half1.fa", []),
    "hb2": ("basic", "9", "half2.fa", []),
}


def run(main, argv):
    """(stdout, exit code) of one CLI call."""
    import contextlib
    import io
    buf = io.StringIO()
    code = 0
    try:
        with contextlib.redirect_stdout(buf):
            main(argv)
    except SystemExit as e:
        code = e.code
    return buf.getvalue(), code


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gcli")
    rng = np.random.default_rng(31)
    recs = [random_dna(rng, int(rng.integers(30, 200))) for _ in range(10)]
    recs.append(b"ACGTNACGTACGTTTGCANNACGTACGTAA")
    with open(tmp / "in.fa", "wb") as f:
        for i, s in enumerate(recs):
            f.write(b">rec%d\n%s\n" % (i, s))
    for h, part in ((1, recs[:5]), (2, recs[5:])):
        with open(tmp / f"half{h}.fa", "wb") as f:
            for i, s in enumerate(part):
                f.write(b">h%d\n%s\n" % (i, s))
    genome = random_dna(rng, 300)
    with open(tmp / "reads.fa", "wb") as f:
        for i, r in enumerate(error_reads(rng, genome, 300, 40, 0.01)):
            f.write(b">r%d\n%s\n" % (i, r))
    with open(tmp / "dup.fa", "wb") as f:     # every k-mer counted twice
        for i, s in enumerate(recs[:4] * 2):
            f.write(b">d%d\n%s\n" % (i, s))
    with open(tmp / "q.fa", "wb") as f:
        for i, s in enumerate(recs[:8]):
            f.write(b">q%d\n%s\n" % (i, s[3:3 + int(rng.integers(12, 60))]))
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        for name, (mode, k, inp, extra) in GRAPHS.items():
            argv = ["build", "-k", k, "--mode", mode] + extra
            run(jmain, argv + ["-o", "j" + name, inp])
            run(tmain, argv + ["-o", "t" + name, inp, "--device", "cpu"])
            same_npz(tmp / f"j{name}.dbg.npz", tmp / f"t{name}.dbg.npz")
        run(jmain, ["annotate", "-i", "jc", "--anno-header", "in.fa"])
        run(tmain, ["annotate", "-i", "tc", "--anno-header", "in.fa",
                    "--device", "cpu"])
        run(jmain, ["transform", "-i", "jb", "--state", "small", "-o", "jsb"])
        run(tmain, ["transform", "-i", "tb", "--state", "small", "-o", "tsb",
                    "--device", "cpu"])
        same_npz(tmp / "jsb.dbg.npz", tmp / "tsb.dbg.npz")
    finally:
        os.chdir(cwd)
    return tmp


def same_npz(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for key in x.files:
            np.testing.assert_array_equal(x[key], y[key], err_msg=key)


def read(path):
    if not os.path.exists(path):
        return None
    with (gzip.open(path) if str(path).endswith(".gz") else
          open(path, "rb")) as f:
        return f.read()


def run_both(work, argv, outs, npz=()):
    """Run ``argv`` (``@`` = the package's prefix) in both packages and
    compare stdout, exit codes and the output files; .dbg.npz outputs
    must hold equal arrays and give equal stats in both packages."""
    cwd = os.getcwd()
    os.chdir(work)
    try:
        res = {}
        for p, main, dev in (("j", jmain, []), ("t", tmain,
                                               ["--device", "cpu"])):
            a = [x.replace("@", p) for x in argv] + dev
            res[p] = run(main, a) + tuple(
                read(o.replace("@", p)) for o in outs)
        assert res["t"] == res["j"]
        for o in npz:
            j, t = o.replace("@", "j"), o.replace("@", "t")
            same_npz(j + ".dbg.npz", t + ".dbg.npz")
            want = run(jmain, ["stats", j])[0]
            assert want.startswith("====")
            # each package reads the other's file
            assert run(jmain, ["stats", t])[0] == want
            assert run(tmain, ["stats", j, "--device", "cpu"])[0] == want
        return res["j"]
    finally:
        os.chdir(cwd)


ASSEMBLE = [
    (["-i", "@b", "--unitigs"], [".fasta.gz"]),
    (["-i", "@b"], [".fasta.gz"]),
    (["-i", "@c", "--unitigs", "--min-length", "30"], [".fasta.gz"]),
    (["@c", "--unitigs", "--to-gfa"], [".fasta.gz", ".gfa"]),
    (["-i", "@c", "--unitigs", "--to-gfa", "--compacted"],
     [".fasta.gz", ".gfa"]),
    (["-i", "@p", "--unitigs", "--to-gfa", "--compacted"],
     [".fasta.gz", ".gfa"]),
    (["-i", "@p"], [".fasta.gz"]),
    (["-i", "@c", "--to-gfa"], [".fasta.gz", ".gfa"]),       # exit 1
    (["-i", "@sb", "--unitigs"], [".fasta.gz"]),
    (["-i", "@c", "-a", "@c.column.annodbg.npz", "--unitigs",
      "--label-mask-in", "rec0", "--label-mask-in", "rec3"], [".fasta.gz"]),
    (["-i", "@c", "-a", "@c.column.annodbg.npz", "--unitigs",
      "--label-mask-in", "rec1", "--label-mask-out", "rec2",
      "--label-mask-out", "absent", "--label-other-fraction", "0.5",
      "--to-gfa", "--compacted"], [".fasta.gz", ".gfa"]),
    (["-i", "@c", "-a", "@c.column.annodbg.npz", "--unitigs",
      "--label-mask-in", "rec4", "--label-mask-in", "rec5",
      "--label-mask-in-fraction", "0.5", "--label-mask-out", "rec6",
      "--label-mask-out-fraction", "1"], [".fasta.gz"]),
]


@pytest.mark.parametrize("i", range(len(ASSEMBLE)))
def test_assemble_identical(work, i):
    argv, outs = ASSEMBLE[i]
    run_both(work, ["assemble"] + argv + ["-o", f"@a{i}"],
             [f"@a{i}{s}" for s in outs])


def test_assemble_label_mask_without_unitigs_fails_alike(work):
    """The JAX CLI passes label_other_fraction to the node-level mask,
    which takes none (TypeError): a fault of the reference; the port
    exits non-zero naming it."""
    argv = ["assemble", "-i", "@c", "-a", "@c.column.annodbg.npz",
            "--label-mask-in", "rec0", "-o", "@x"]
    cwd = os.getcwd()
    os.chdir(work)
    try:
        with pytest.raises(TypeError, match="label_other_fraction"):
            jmain([x.replace("@", "j") for x in argv])
        out, code = run(tmain, [x.replace("@", "t") for x in argv]
                        + ["--device", "cpu"])
        assert code not in (0, None) and "label_other_fraction" in code
    finally:
        os.chdir(cwd)


CLEAN = [
    ("w", ["--min-count", "2", "--to-fasta"]),
    ("w", ["--max-count", "6"]),
    ("w", ["--min-count-q", "0.2", "--max-count-q", "0.9"]),
    ("w", ["--prune-tips", "22", "--prune-unitigs", "0", "--fallback", "2",
           "--to-fasta"]),
    ("w", ["--min-count-auto", "--num-singletons", "4000", "--header",
           "ctg"]),
    ("w", ["--prune-unitigs", "3", "--smoothing-window", "3"]),
    ("w", ["--min-count", "2", "--count-slice-quantiles", "0 0.5 1"]),
    ("w", ["--count-bins-q", "0 0.3 0.6 1", "--prune-tips", "12"]),
    ("wb", ["--unitigs"]),
    ("wb", ["--prune-tips", "15", "--smoothing-window", "4"]),
    ("b", ["--to-fasta"]),
    ("c", ["--unitigs", "--header", "u"]),
    ("d", ["--prune-unitigs", "0", "--fallback", "3"]),
    ("d", ["--prune-unitigs", "0", "--fallback", "-1"]),       # exit 129
]
CLEAN_OUT = [".fasta.gz", ".kmer_counts.gz", ".0.0.5.fasta.gz",
             ".0.5.1.fasta.gz", ".0.0.3.fasta.gz", ".0.3.0.6.fasta.gz",
             ".0.6.1.fasta.gz"]


@pytest.mark.parametrize("i", range(len(CLEAN)))
def test_clean_identical(work, i):
    g, argv = CLEAN[i]
    res = run_both(work, ["clean", "-i", f"@{g}"] + argv + ["-o", f"@k{i}"],
                   [f"@k{i}{s}" for s in CLEAN_OUT])
    if "-1" in argv:
        assert res[1] == 129


def test_clean_filters_without_counts_fail_alike(work):
    """Tip pruning on a graph without counts: the JAX package's
    clean_node_mask asserts on the missing weights, the port exits
    non-zero naming the need."""
    argv = ["clean", "-i", "@b", "--prune-tips", "10", "-o", "@kx"]
    cwd = os.getcwd()
    os.chdir(work)
    try:
        with pytest.raises(AssertionError, match="count-kmers"):
            jmain([x.replace("@", "j") for x in argv])
        _, code = run(tmain, [x.replace("@", "t") for x in argv]
                      + ["--device", "cpu"])
        assert code not in (0, None) and "--count-kmers" in code
    finally:
        os.chdir(cwd)


TRANSFORM = [
    ("w", ["--to-fasta"], [".fasta.gz"]),
    ("c", ["--to-fasta", "--primary-kmers"], [".fasta.gz"]),
    ("p", ["--to-fasta"], [".fasta.gz"]),
    ("b", ["--to-gfa"], [".gfa"]),
    ("c", ["--to-gfa", "--compacted"], [".gfa"]),
    ("b", ["--to-adj-list"], [".adjlist"]),
    ("p", ["--to-adj-list"], [".adjlist"]),
    ("c", ["--state", "small"], [".dbg.npz"]),
    ("sb", ["--state", "fast"], [".dbg.npz"]),                 # exit 1
    ("w", ["--state", "fast"], [".dbg.npz"]),
    ("b", ["--initialize-bloom", "--bloom-fpp", "0.1"], [".fasta.gz"]),
    ("b", ["--bloom-fpp", "0.1", "--to-fasta"], [".fasta.gz"]),
]


@pytest.mark.parametrize("i", range(len(TRANSFORM)))
def test_transform_identical(work, i):
    g, argv, outs = TRANSFORM[i]
    saves = outs == [".dbg.npz"] and g != "sb"
    res = run_both(work, ["transform", "-i", f"@{g}"] + argv
                   + ["-o", f"@x{i}"], [f"@x{i}{s}" for s in outs if
                                        not s.endswith(".npz")],
                   (f"@x{i}",) if saves else ())
    if g == "sb":
        assert res[1] == 1


@pytest.mark.parametrize("a,b", [("b", "b"), ("c", "c"), ("b", "c"),
                                 ("h1", "w"), ("sb", "b")])
def test_compare_identical(work, a, b):
    out = run_both(work, ["compare", f"@{a}", f"@{b}"], [])
    # the small state holds the same W and last as the fast state
    same = a == b or {a, b} == {"sb", "b"}
    assert out[0] == ("Graphs are identical\n" if same
                      else "Graphs are not identical\n")


@pytest.mark.parametrize("what", ["compare", "merge"])
def test_primary_compare_merge_fail_alike(work, what):
    """merge and compare load primary graphs wrapped, and the wrapper has
    no BOSS table: the JAX CLI raises AttributeError, the port exits
    non-zero naming the fault."""
    argv = (["compare", "@p", "@p"] if what == "compare"
            else ["merge", "-o", "@mp", "@p", "@b"])
    cwd = os.getcwd()
    os.chdir(work)
    try:
        with pytest.raises(AttributeError):
            jmain([x.replace("@", "j") for x in argv])
        _, code = run(tmain, [x.replace("@", "t") for x in argv]
                      + ["--device", "cpu"])
        assert code not in (0, None) and "primary" in code
    finally:
        os.chdir(cwd)


EXTEND = [("hb1", "half2.fa"), ("h1", "half2.fa"), ("w", "in.fa"),
          ("p", "half2.fa")]


@pytest.mark.parametrize("i", range(len(EXTEND)))
def test_extend_identical(work, i):
    g, fa = EXTEND[i]
    run_both(work, ["extend", "-i", f"@{g}", "-o", f"@e{i}", fa], [],
             (f"@e{i}",))


def test_extend_equals_whole_build(work):
    """Extending the first half's graph by the second half gives the
    graph of both halves (basic; compare's check and every array but
    the weights, which the basic rebuild does not carry)."""
    run_both(work, ["extend", "-i", "@hb1", "-o", "@ew", "half2.fa"], [])
    cwd = os.getcwd()
    os.chdir(work)
    try:
        run(tmain, ["build", "-k", "9", "-o", "tall", "in.fa",
                    "--device", "cpu"])
        out, _ = run(tmain, ["compare", "tew", "tall", "--device", "cpu"])
        assert out == "Graphs are identical\n"
    finally:
        os.chdir(cwd)


def test_canonical_extend_fault_matched(work):
    """extend of a canonical graph feeds both orientations of the old
    closure to a canonical rebuild, which adds each one's reverse
    complement again: the result holds every old k-mer twice and is not
    the graph of both inputs (JAX cli/main.py cmd_extend, a fault of the
    reference). The port matches it; merge of the two halves is the
    whole graph."""
    run_both(work, ["extend", "-i", "@h1", "-o", "@ec", "half2.fa"], [])
    run_both(work, ["merge", "-o", "@mc", "@h1", "@h2"], [])
    cwd = os.getcwd()
    os.chdir(work)
    try:
        for p, main, dev in (("j", jmain, []), ("t", tmain,
                                               ["--device", "cpu"])):
            run(main, ["build", "-k", "11", "--mode", "canonical",
                       "--count-kmers", "-o", p + "hall", "in.fa"] + dev)
            assert run(main, ["compare", p + "ec", p + "hall"] + dev)[0] \
                == "Graphs are not identical\n"
            assert run(main, ["compare", p + "mc", p + "hall"] + dev)[0] \
                == "Graphs are identical\n"
        with np.load("tec.dbg.npz") as e, np.load("thall.dbg.npz") as w:
            assert len(e["W"]) > len(w["W"])
    finally:
        os.chdir(cwd)


MERGE = [["@hb1", "@hb2"], ["@h1", "@h2"], ["@h1", "@c"], ["@w", "@h1"]]


@pytest.mark.parametrize("i", range(len(MERGE)))
def test_merge_identical(work, i):
    run_both(work, ["merge", "-o", f"@m{i}"] + MERGE[i], [], (f"@m{i}",))


@pytest.mark.parametrize("i", range(len(MERGE)))
def test_merge_num_shards_unported(work, i):
    """``merge --num-shards`` was not yet ported; now the out-of-core
    merge writes the JAX CLI's graph, for the in-memory merge's inputs."""
    run_both(work, ["merge", "--num-shards", "3", "-o", f"@ms{i}"]
             + MERGE[i], [], (f"@ms{i}",))


ALIGN_GFA = [("b", []), ("b", ["--compacted"]), ("c", ["--compacted"]),
             ("p", []), ("p", ["--compacted"])]


@pytest.mark.parametrize("i", range(len(ALIGN_GFA)))
def test_align_gfa_identical(work, i):
    g, flags = ALIGN_GFA[i]
    run_both(work, ["align", "-i", f"@{g}"] + flags
             + ["-o", f"@pg{i}.gfa", "q.fa"], [f"@pg{i}.path.gfa"])


# clean_graph's arguments for each case of CLEAN that cmd_clean passes
# straight through (the quantile and slice cases compute the CLI's own
# thresholds and files): (kwargs, smoothing window); None for exit 129
CLEAN_GRAPH = {
    0: (dict(min_count=2), 1),
    1: (dict(max_count=6), 1),
    3: (dict(prune_tips=22, prune_unitigs=0, fallback=2), 1),
    4: (dict(prune_unitigs=0, num_singletons=4000), 1),
    5: (dict(prune_unitigs=3, unitigs=True), 3),
    8: (dict(unitigs=True), 1),
    9: (dict(prune_tips=15, unitigs=True), 4),
    10: (dict(), 1),
    11: (dict(unitigs=True), 1),
    12: (dict(prune_unitigs=0, fallback=3), 1),
    13: None,
}


@pytest.mark.parametrize("i", sorted(CLEAN_GRAPH))
def test_clean_graph_is_what_clean_writes(work, i):
    """``graph/cleaning.py clean_graph`` gives the sequences and counts
    that the port's ``clean`` writes, for the CLI's arguments; with the
    fallback disabled it raises where the CLI exits 129."""
    from metagraph_tpu_torch.cli.main import _smooth_counts
    from metagraph_tpu_torch.graph import io as tio
    from metagraph_tpu_torch.graph.cleaning import NoThreshold, clean_graph
    from metagraph_tpu_torch.seqio.fasta import (iter_weighted_records,
                                                 parse_records)
    g, argv = CLEAN[i]
    graph = tio.load_graph(str(work / f"t{g}"), device="cpu")
    out = str(work / f"tcg{i}")
    _, code = run(tmain, ["clean", "-i", str(work / f"t{g}")] + argv
                  + ["-o", out, "--device", "cpu"])
    if CLEAN_GRAPH[i] is None:
        assert code == 129
        with pytest.raises(NoThreshold):
            clean_graph(graph, prune_unitigs=0, fallback=-1)
        return
    kwargs, window = CLEAN_GRAPH[i]
    res = clean_graph(graph, **kwargs)
    assert code in (0, None) and len(res.paths) == len(res.seqs)
    assert res.kept == sum(len(p) for p in res.paths)
    if graph.boss.weights is None:
        assert res.counts is None
        assert list(res.seqs) == [r.seq for r in
                            parse_records(out + ".fasta.gz")]
        return
    written = list(iter_weighted_records(out + ".fasta.gz"))
    assert list(res.seqs) == [r.seq for r, _ in written]
    for c, (_, want) in zip(res.counts, written):
        got = _smooth_counts(c, window) if window > 1 else c
        np.testing.assert_array_equal(got, want)
