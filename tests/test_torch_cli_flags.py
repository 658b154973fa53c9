"""The port's CLI flags against the JAX package's CLI, in process.

Builds from several files, from a stdin file list, with
--fwd-and-reverse and from count sidecars; every stats flag (including
--validate's exit code on a damaged graph); the annotate header flags;
the query modes --query-counts / --count-kmers, --count-quantiles,
--print-signature and --fwd-and-reverse on basic, canonical and primary
graphs, with and without count annotations. stdout must be byte for
byte the JAX CLI's (the port with ``--device cpu``) and the written
``.dbg.npz`` / ``.annodbg.npz`` arrays equal.
"""

import io

import numpy as np
import pytest
import torch

from conftest import random_dna
from metagraph_tpu.cli.main import main as jmain
from metagraph_tpu.seqio.fasta import ExtendedFastaWriter
from metagraph_tpu_torch.cli.main import main as tmain

torch.set_num_threads(2)
K = 13


def run(capsys, main, argv):
    """stdout and exit code of one CLI call."""
    capsys.readouterr()
    code = 0
    try:
        main(argv)
    except SystemExit as e:
        code = e.code
    return capsys.readouterr().out, code


def both(capsys, tmp, argv):
    """Run ``argv`` through both CLIs, '@' in an argument standing for the
    package's own file prefix ('j' or 't'); both must print the same and
    exit alike. Returns the JAX package's stdout."""
    want = run(capsys, jmain, [a.replace("@", str(tmp / "j")) for a in argv])
    got = run(capsys, tmain, [a.replace("@", str(tmp / "t")) for a in argv]
              + ["--device", "cpu"])
    assert got == want
    return want[0]


def same_npz(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for key in x.files:
            np.testing.assert_array_equal(x[key], y[key], err_msg=key)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Two FASTA files with headers holding '|' fields and comments, and
    query reads (fragments of the records longer than k, their reverse
    complements, random, short and N-broken reads)."""
    tmp = tmp_path_factory.mktemp("flags")
    rng = np.random.default_rng(77)
    recs = [random_dna(rng, int(rng.integers(30, 200))) for _ in range(14)]
    recs[3] = recs[3][:20] + b"N" + recs[3][20:]
    recs.append(recs[0])                                # a repeated record
    for name, part in (("a.fa", recs[:8]), ("b.fa", recs[8:])):
        with open(tmp / name, "wb") as f:
            for i, s in enumerate(part):
                f.write(b">%s%d|grp%d|x cmt%d|y\n%s\n"
                        % (name[:1].encode(), i, i % 3, i % 2, s))
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    with open(tmp / "q.fa", "wb") as f:
        for i in range(40):
            s = recs[i % len(recs)]
            a = int(rng.integers(0, max(len(s) - K - 2, 1)))
            q = s[a:a + int(rng.integers(K + 1, 90))]
            if i % 4 == 3:
                q = q.translate(comp)[::-1]
            f.write(b">q%d\n%s\n" % (i, q))
        f.write(b">rand\n" + random_dna(rng, 60) + b"\n>short\nACGTA\n"
                + b">broken\n" + recs[1][:30] + b"NN" + recs[2][:30] + b"\n")
    return tmp


# ---------------------------------------------------------------------------
# build inputs
# ---------------------------------------------------------------------------

BUILDS = {
    "two-files": ["--mode", "basic", "a.fa", "b.fa"],
    "two-files-canonical-counts": ["--mode", "canonical", "--count-kmers",
                                   "b.fa", "a.fa"],
    "fwd-and-reverse": ["--fwd-and-reverse", "a.fa"],
    "fwd-and-reverse-primary-two-files": ["--mode", "primary",
                                          "--fwd-and-reverse", "a.fa", "b.fa"],
    "global-and-parity-flags": ["-v", "-p", "4", "--debug", "--threads", "2",
                                "--mask-dummy", "--clear-dummy",
                                "--no-postprocessing", "--index-ranges", "4",
                                "--graph", "succinct", "--alphabet", "DNA",
                                "--state", "fast", "--mode", "canonical",
                                "a.fa"],
}


@pytest.mark.parametrize("name", list(BUILDS))
def test_build_inputs_identical(inputs, capsys, monkeypatch, name):
    monkeypatch.chdir(inputs)
    out = f"@{name}"
    assert both(capsys, inputs, ["build", "-k", str(K), "-o", out]
                + BUILDS[name]) == ""
    assert both(capsys, inputs, ["stats", out]).startswith("====")
    same_npz(inputs / f"j{name}.dbg.npz", inputs / f"t{name}.dbg.npz")


def test_inert_flags_warn_alike(graphs, capsys):
    """An inert reference option is accepted with the same warning on
    stderr and no effect."""
    warnings = []
    for main, dev in ((jmain, []), (tmain, ["--device", "cpu"])):
        capsys.readouterr()
        main(["stats", "--threads", "3", "--sparse", "--cache-size", "9",
              str(graphs / "gbasic")] + dev)
        err = capsys.readouterr().err
        warnings.append([line.split("] ", 1)[1] for line in err.splitlines()
                         if "WARNING" in line])
    assert warnings[1] == warnings[0] and len(warnings[0]) == 3


class _Stdin(io.StringIO):
    def isatty(self):
        return False


def test_build_from_stdin_list(inputs, capsys, monkeypatch):
    """`find . -name "*.fa" | metagraph build ...`: the file list (blank
    lines skipped) comes from stdin when no file is named."""
    monkeypatch.chdir(inputs)
    for main, prefix, dev in ((jmain, "j", []), (tmain, "t", ["--device",
                                                              "cpu"])):
        monkeypatch.setattr("sys.stdin", _Stdin("a.fa\n\n  b.fa\n"))
        assert run(capsys, main, ["build", "-k", str(K), "-o",
                                  f"{prefix}stdin"] + dev) == ("", 0)
    same_npz(inputs / "jstdin.dbg.npz", inputs / "tstdin.dbg.npz")
    # the same graph as naming the two files
    both(capsys, inputs, ["build", "-k", str(K), "-o", "@named", "a.fa",
                          "b.fa"])
    same_npz(inputs / "tstdin.dbg.npz", inputs / "tnamed.dbg.npz")


@pytest.fixture(scope="module")
def sidecars(inputs):
    """Contigs with count sidecars written by the JAX package's
    ExtendedFastaWriter: counts 1-300, so 8-bit weights saturate, and
    repeated contigs whose counts add up."""
    rng = np.random.default_rng(5)
    for part in range(2):
        with ExtendedFastaWriter(str(inputs / f"sc{part}"), K) as w:
            for i in range(6):
                s = random_dna(rng, int(rng.integers(K, 150)))
                if i == 2:
                    s = s[:20] + b"N" + s[20:]
                w.write(s, rng.integers(1, 301, len(s) - K + 1))
            rep = b"ACGTTGCAAGGCTTAACG" * 2
            for _ in range(2):
                w.write(rep, rng.integers(100, 301, len(rep) - K + 1))
    return ["sc0.fasta.gz", "sc1.fasta.gz"]


@pytest.mark.parametrize("mode,extra", [
    ("basic", []), ("canonical", []), ("primary", []),
    ("canonical", ["--count-width", "16"]), ("basic", ["--count-width", "4"])])
def test_sidecar_build_identical(inputs, sidecars, capsys, monkeypatch, mode,
                                 extra):
    monkeypatch.chdir(inputs)
    out = f"@sc{mode}{len(extra)}"
    both(capsys, inputs, ["build", "-k", str(K), "--mode", mode,
                          "--count-kmers", "-o", out] + extra + sidecars)
    want = both(capsys, inputs, ["stats", "--count-dummy", "--validate", out])
    assert f"mode: {mode}" in want and "nnz weights" in want
    same_npz(inputs / f"jsc{mode}{len(extra)}.dbg.npz",
             inputs / f"tsc{mode}{len(extra)}.dbg.npz")


def test_sidecar_needs_every_file(inputs, sidecars, capsys, monkeypatch):
    """With one input lacking a sidecar, --count-kmers counts the
    sequences as usual."""
    monkeypatch.chdir(inputs)
    both(capsys, inputs, ["build", "-k", str(K), "--count-kmers", "-o",
                          "@mixed", sidecars[0], "a.fa"])
    same_npz(inputs / "jmixed.dbg.npz", inputs / "tmixed.dbg.npz")


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def graphs(inputs):
    """k = 13 graphs of a.fa in each mode, and a count annotation of the
    primary one, built by the JAX package (both CLIs read them)."""
    for mode in ("basic", "canonical", "primary"):
        g = str(inputs / f"g{mode}")
        jmain(["build", "-k", str(K), "--mode", mode, "--count-kmers", "-o",
               g, str(inputs / "a.fa")])
    jmain(["annotate", "-i", str(inputs / "gprimary"), "--anno-header",
           "--count-kmers", str(inputs / "a.fa")])
    return inputs


STATS = [["--count-dummy"], ["--validate"], ["--print"], ["--print-internal"],
         ["--count-dummy", "--validate", "--print", "-a", "x.annodbg.npz"]]


@pytest.mark.parametrize("mode", ["basic", "canonical", "primary"])
@pytest.mark.parametrize("flags", STATS, ids=lambda f: "+".join(f))
def test_stats_flags_identical(graphs, capsys, mode, flags):
    want = both(capsys, graphs, ["stats"] + flags + [str(graphs / f"g{mode}")])
    assert want.endswith("=" * 56 + "\n")


def test_stats_annotation_col_names(graphs, capsys):
    anno = str(graphs / "gprimary.column.annodbg.npz")
    for flags in ([], ["--print-col-names"]):
        want = both(capsys, graphs, ["stats"] + flags + [anno, str(graphs /
                                                                 "gbasic")])
        assert ("<a0|grp0|x>" in want) == bool(flags)


@pytest.mark.parametrize("damage", ["F", "edge_lanes"])
def test_stats_validate_violation_exits_1(graphs, capsys, damage):
    """A damaged graph fails --validate in both packages alike: the same
    report, exit code 1."""
    with np.load(graphs / "gbasic.dbg.npz") as z:
        d = {key: z[key] for key in z.files}
    if damage == "F":
        d["F"] = d["F"].copy()
        d["F"][2] = d["F"][3] + 1
    else:
        lanes = d["edge_lanes"].copy()
        lanes[:, [5, 9]] = lanes[:, [9, 5]]
        d["edge_lanes"] = lanes
    np.savez_compressed(graphs / f"bad{damage}.dbg.npz", **d)
    want = run(capsys, jmain, ["stats", "--validate",
                               str(graphs / f"bad{damage}")])
    assert want[1] == 1 and "validation: FAILED" in want[0]
    assert run(capsys, tmain, ["stats", "--validate",
                               str(graphs / f"bad{damage}"),
                               "--device", "cpu"]) == want


# ---------------------------------------------------------------------------
# annotate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag,flags", [
    ("delimiter", ["--header-delimiter", "|"]),
    ("comment", ["--header-comment-delim", "|"]),
    ("both", ["--header-comment-delim", " ", "--header-delimiter", "|",
              "--anno-filename", "--count-kmers", "--separately"]),
])
def test_annotate_header_flags_identical(graphs, capsys, monkeypatch, tag,
                                         flags):
    monkeypatch.chdir(graphs)
    both(capsys, graphs, ["annotate", "-i", "gcanonical", "--anno-header",
                          "-o", "@h" + tag] + flags + ["a.fa", "b.fa"])
    same_npz(graphs / f"jh{tag}.column.annodbg.npz",
             graphs / f"th{tag}.column.annodbg.npz")
    both(capsys, graphs, ["stats", "--print-col-names",
                          f"@h{tag}.column.annodbg.npz"])


# ---------------------------------------------------------------------------
# query modes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[
    ("basic", False), ("basic", True), ("canonical", False),
    ("canonical", True), ("primary", False), ("primary", True)],
    ids=lambda p: f"{p[0]}-{'counts' if p[1] else 'binary'}")
def annotated(graphs, request):
    """A graph of a.fa + b.fa and an annotation of both files (labels:
    header fields and file name), with or without k-mer counts."""
    mode, counts = request.param
    g = str(graphs / f"q{mode}")
    jmain(["build", "-k", str(K), "--mode", mode, "-o", g,
           str(graphs / "a.fa"), str(graphs / "b.fa")])
    out = f"{g}{int(counts)}"
    jmain(["annotate", "-i", g, "--anno-header", "--header-delimiter", "|",
           "--anno-filename", "-o", out]
          + (["--count-kmers"] if counts else [])
          + [str(graphs / "a.fa"), str(graphs / "b.fa"), str(graphs / "a.fa")])
    return g, out + ".column.annodbg.npz"


QUERIES = [
    ["--query-counts"],
    ["--count-kmers", "--num-top-labels", "2", "--discovery-fraction", "0.3"],
    ["--count-kmers", "--count-labels", "--suppress-unlabeled"],
    ["--count-quantiles", "0 0.5 1"],
    ["--count-quantiles", "0.25 0.75", "--discovery-fraction", "0.3",
     "--num-top-labels", "3"],
    ["--print-signature"],
    ["--print-signature", "--num-top-labels", "1", "--suppress-unlabeled",
     "--discovery-fraction", "0.9"],
    ["--fwd-and-reverse"],
    ["--fwd-and-reverse", "--count-labels", "--query-counts"],
    ["--fwd-and-reverse", "--print-signature", "--count-quantiles", "0.5"],
]


@pytest.mark.parametrize("flags", QUERIES, ids=lambda f: "+".join(f))
def test_query_modes_identical(graphs, annotated, capsys, flags):
    g, anno = annotated
    assert both(capsys, graphs, ["query", "-i", g, "-a", anno] + flags
                + [str(graphs / "q.fa")])


def test_signature_one_window_read_fails_alike(graphs, annotated, capsys):
    """A fault of the reference, matched: --print-signature on a labelled
    read of exactly k characters (a one-window mask) fails in its score
    (``score_kmer_presence_mask``) in both packages."""
    g, anno = annotated
    seq = (graphs / "a.fa").read_bytes().split(b"\n")[1][:K]
    (graphs / "one.fa").write_bytes(b">one\n" + seq + b"\n")
    argv = ["query", "--print-signature", "-i", g, "-a", anno,
            str(graphs / "one.fa")]
    with pytest.raises(ValueError):
        run(capsys, jmain, argv)
    with pytest.raises(ValueError):
        run(capsys, tmain, argv + ["--device", "cpu"])
