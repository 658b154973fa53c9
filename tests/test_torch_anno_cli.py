"""The port's annotation commands against the JAX package's CLI, in process.

For every ``transform_anno --anno-type`` of the JAX CLI's choices, the
two packages convert their own (identical) annotations of one graph:
the files must hold equal arrays, each package must load the other's,
and ``query`` (in the modes each form answers) and ``stats`` must print
byte-identical stdout (the port with ``--device cpu``). The same holds
for ``relax_brwt``, ``merge_anno``, ``coordinate`` / ``annotate
--coordinates`` and ``query --query-coords``, and for the flags of
``transform_anno`` (the contract of ``tests/test_cli.py``'s
``test_all_anno_types_save_load_query`` and the flag tests of
``tests/test_anno_compressed.py``).
"""

import os

import numpy as np
import pytest
import torch

from conftest import random_dna
from metagraph_tpu.cli.main import main as jmain
from metagraph_tpu_torch.cli.main import main as tmain

torch.set_num_threads(2)

GRAPH_TYPES = {"row_diff", "row_diff_sparse", "row_diff_brwt", "int_row_diff",
               "row_diff_int_brwt", "int_row_diff_brwt", "row_diff_coord",
               "tuple_row_diff"}
INT_TYPES = {"int_row_diff", "int_brwt", "row_diff_int_brwt",
             "int_row_diff_brwt"}
COORD_TYPES = ["column_coord", "row_diff_coord", "tuple_row_diff"]
BINARY_TYPES = ["column", "row", "row_sparse", "flat", "brwt", "bin_rel_wt",
                "bin_rel_wt_sdsl", "unique_row", "rbfish", "rb_brwt",
                "row_diff", "row_diff_sparse", "row_diff_brwt"]


def run(capsys, main, argv):
    """stdout of one CLI call and its exit code (None when it returned)."""
    capsys.readouterr()
    code = None
    try:
        main(argv)
    except SystemExit as e:
        code = e.code
    return capsys.readouterr().out, code


def both(capsys, argv):
    """Run argv through the JAX CLI ('@' -> 'j') and the port ('@' ->
    't'); returns the two (stdout, exit code) pairs."""
    return (run(capsys, jmain, [x.replace("@", "j") for x in argv]),
            run(capsys, tmain, [x.replace("@", "t") for x in argv]
                + ["--device", "cpu"]))


def same_npz(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for key in x.files:
            assert x[key].dtype == y[key].dtype, key
            np.testing.assert_array_equal(x[key], y[key], err_msg=key)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """Graphs and annotations of both packages in one directory (j*: the
    JAX package's, t*: the port's): records with a shared prefix (forks),
    a circular one (a cycle), one shorter than k (an empty label)."""
    rng = np.random.default_rng(31)
    tmp = tmp_path_factory.mktemp("annocli")
    shared = random_dna(rng, 40)
    unit = random_dna(rng, 30)
    recs = [random_dna(rng, int(rng.integers(80, 220))) for _ in range(5)]
    recs += [shared + b"A" + random_dna(rng, 60),
             shared + b"C" + random_dna(rng, 60),
             unit * 3 + unit[:10], b"ACGTAC"]
    with open(tmp / "in.fa", "wb") as f:
        for i, s in enumerate(recs):
            f.write(b">rec%d\n%s\n" % (i % 7, s))
    with open(tmp / "q.fa", "wb") as f:
        for i, s in enumerate(recs[:8]):
            f.write(b">q%d\n%s\n" % (i, s[3:3 + int(rng.integers(30, 70))]))
        f.write(b">both\n" + recs[5][:60] + recs[6][41:90] + b"\n")
        f.write(b">random\n" + random_dna(rng, 50) + b"\n")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        for p, main, dev in (("j", jmain, []),
                             ("t", tmain, ["--device", "cpu"])):
            for argv in (
                    ["build", "-k", "11", "-o", f"{p}g", "in.fa"],
                    ["annotate", "-i", f"{p}g", "-o", f"{p}a",
                     "--anno-header", "--count-kmers", "in.fa"],
                    ["annotate", "-i", f"{p}g", "-o", f"{p}b",
                     "--anno-header", "--anno-label", "all", "in.fa"],
                    ["annotate", "-i", f"{p}g", "-o", f"{p}c",
                     "--anno-header", "--coordinates", "in.fa"]):
                main(argv + dev)
        same_npz("jg.dbg.npz", "tg.dbg.npz")
        for a in ("a.column", "b.column", "c.coord"):
            same_npz(f"j{a}.annodbg.npz", f"t{a}.annodbg.npz")
        yield tmp
    finally:
        os.chdir(cwd)


def convert(capsys, anno_type, src, out, extra=()):
    argv = ["transform_anno", "--anno-type", anno_type, "-o", out,
            src] + list(extra)
    if anno_type in GRAPH_TYPES:
        argv[3:3] = ["-i", "@g"]
    (jo, jc), (to, tc) = both(capsys, argv)
    assert jc is None and tc is None, (jc, tc)
    name = "row_diff_int_brwt" if anno_type == "int_row_diff_brwt" \
        else anno_type
    j, t = (out.replace("@", p) + f".{name}.annodbg.npz" for p in "jt")
    same_npz(j, t)
    return j, t


def query_alike(capsys, j, t, flags):
    """The JAX CLI over the port's file, the port over both files: one
    stdout."""
    argv = ["query", "-i", "jg", "-a", t] + flags + ["q.fa"]
    want, code = run(capsys, jmain, argv)
    assert code is None and want.startswith("0\tq0")
    for a in (t, j):
        got, code = run(capsys, tmain, ["query", "-i", "tg", "-a", a]
                        + flags + ["q.fa", "--device", "cpu"])
        assert code is None and got == want, (a, flags)


BINARY_MODES = [["--discovery-fraction", "0.9"], ["--count-labels"],
                ["--query-counts", "--discovery-fraction", "0.5"],
                ["--count-quantiles", "0 0.5 1"], ["--print-signature"]]


@pytest.mark.parametrize("anno_type", BINARY_TYPES + sorted(INT_TYPES))
def test_transform_query_stats_identical(work, capsys, anno_type):
    j, t = convert(capsys, anno_type, "@a.column.annodbg.npz",
                   f"@x_{anno_type}")
    modes = BINARY_MODES if anno_type in INT_TYPES or anno_type in (
        "column", "brwt", "row_diff") else BINARY_MODES[:2]
    for flags in modes:
        query_alike(capsys, j, t, flags)
    if anno_type not in ("rb_brwt",):
        want, code = run(capsys, jmain, ["stats", t])
        assert code is None and "representation:" in want
        assert run(capsys, tmain, ["stats", j, "--device", "cpu"])[0] == want


@pytest.mark.parametrize("anno_type", COORD_TYPES)
def test_coordinate_types_identical(work, capsys, anno_type):
    j, t = convert(capsys, anno_type, "@c.coord.annodbg.npz",
                   f"@y_{anno_type}", ["--max-path-length", "5"])
    for flags in (["--query-coords"],
                  ["--query-coords", "--num-top-labels", "1",
                   "--discovery-fraction", "0.2"], []):
        query_alike(capsys, j, t, flags)
    want, code = run(capsys, jmain, ["stats", t])
    assert code is None
    assert run(capsys, tmain, ["stats", j, "--device", "cpu"])[0] == want


def test_rb_brwt_stats_repaired(work, capsys):
    """The JAX package's UniqueRow.nnz reads the distinct rows' ``rows``,
    which a BRWT store lacks (AttributeError): a fault of the reference.
    The port's stats of rb_brwt equal the JAX stats of unique_row."""
    j, t = convert(capsys, "rb_brwt", "@b.column.annodbg.npz", "@rb")
    with pytest.raises(AttributeError):
        jmain(["stats", t])
    ju, _ = convert(capsys, "unique_row", "@b.column.annodbg.npz", "@ur")
    want, _ = run(capsys, jmain, ["stats", ju])
    assert run(capsys, tmain, ["stats", j, "--device", "cpu"])[0] == want


def test_relax_brwt_and_flags_identical(work, capsys):
    """brwt at arity 2, relax_brwt to 4 and transform_anno --relax-arity 3;
    --linkage / --greedy, --linkage-file, --rename-cols, --dump-text-anno,
    --aggregate-columns, --num-rows-subsampled."""
    convert(capsys, "brwt", "@b.column.annodbg.npz", "@br",
            ["--num-rows-subsampled", "50"])
    (_, jc), (_, tc) = both(capsys, ["relax_brwt", "--relax-arity", "4",
                                     "-o", "@rx", "@br.brwt.annodbg.npz"])
    assert jc is None and tc is None
    same_npz("jrx.brwt.annodbg.npz", "trx.brwt.annodbg.npz")
    query_alike(capsys, "jrx.brwt.annodbg.npz", "trx.brwt.annodbg.npz",
                ["--count-labels"])
    convert(capsys, "brwt", "@b.column.annodbg.npz", "@r3",
            ["--relax-arity", "3"])
    both(capsys, ["transform_anno", "--linkage", "--greedy", "-o", "@lk",
                  "@b.column.annodbg.npz"])
    assert open("jlk.linkage").read() == open("tlk.linkage").read()
    assert len(open("tlk.linkage").read().splitlines()) == 7   # 8 labels
    convert(capsys, "brwt", "@b.column.annodbg.npz", "@lf",
            ["--linkage-file", "tlk.linkage"])
    with open("rename.txt", "w") as f:
        f.write("rec0 first\nrec3 third\n")
    convert(capsys, "column", "@b.column.annodbg.npz", "@rn",
            ["--rename-cols", "rename.txt"])
    (_, jc), (_, tc) = both(capsys, ["transform_anno", "--dump-text-anno",
                                     "-o", "@dump", "@b.column.annodbg.npz"])
    for ci in range(8):
        assert open(f"jdump.{ci}.text.annodbg").read() == \
            open(f"tdump.{ci}.text.annodbg").read()
    for flags in (["--min-count", "2"], ["--max-count", "1"],
                  ["--min-fraction", "0.2", "--max-fraction", "0.3",
                   "--anno-label", "agg"]):
        both(capsys, ["transform_anno", "--aggregate-columns", "-o", "@ag",
                      "@b.column.annodbg.npz", "@a.column.annodbg.npz"]
             + flags)
        same_npz("jag.column.annodbg.npz", "tag.column.annodbg.npz")


@pytest.mark.parametrize("anno_type", ["row_diff", "int_row_diff",
                                       "row_diff_int_brwt"])
def test_row_diff_stages_identical(work, capsys, anno_type):
    """--row-diff-stage 0, 0 again (the artifact accumulates), 1, then 2
    (which reads both artifacts); --max-path-length."""
    base = ["transform_anno", "--anno-type", anno_type, "-i", "@g",
            "--max-path-length", "4", "-o", f"@st_{anno_type}",
            "@a.column.annodbg.npz"]
    for stage in ("0", "0", "1", "2"):
        (_, jc), (_, tc) = both(capsys, base + ["--row-diff-stage", stage])
        assert jc is None and tc is None
    for art in ("row_count", "row_reduction"):
        same_npz(f"jst_{anno_type}.{art}.npz", f"tst_{anno_type}.{art}.npz")
    same_npz(f"jst_{anno_type}.{anno_type}.annodbg.npz",
             f"tst_{anno_type}.{anno_type}.annodbg.npz")


def test_merge_anno_identical(work, capsys):
    (_, jc), (_, tc) = both(capsys, ["merge_anno", "-o", "@m",
                                     "@b.column.annodbg.npz",
                                     "@a.column.annodbg.npz"])
    assert jc is None and tc is None
    same_npz("jm.column.annodbg.npz", "tm.column.annodbg.npz")
    query_alike(capsys, "jm.column.annodbg.npz", "tm.column.annodbg.npz",
                ["--query-counts"])


def test_merge_anno_compressed_input(work, capsys):
    """merge_anno of a row_diff file: the JAX package reads the
    ``values`` / ``rows`` fields only the column form has
    (AttributeError), a fault of the reference; the port merges the
    logical matrix, equal to merging the column files."""
    convert(capsys, "row_diff", "@b.column.annodbg.npz", "@mr")
    with pytest.raises(AttributeError):
        jmain(["merge_anno", "-o", "jmx", "tmr.row_diff.annodbg.npz"])
    run(capsys, jmain, ["merge_anno", "-o", "jmy", "jb.column.annodbg.npz"])
    run(capsys, tmain, ["merge_anno", "-o", "tmx",
                        "tmr.row_diff.annodbg.npz", "--device", "cpu"])
    same_npz("jmy.column.annodbg.npz", "tmx.column.annodbg.npz")


def test_coordinate_command_identical(work, capsys):
    """coordinate is annotate --coordinates: the same file from both
    packages (with --anno-label; the JAX CLI's coordinate parser lacks
    --header-comment-delim, so its --anno-header raises AttributeError, a
    fault of the reference; the port's coordinate --anno-header equals
    the JAX annotate --coordinates --anno-header)."""
    (_, jc), (_, tc) = both(capsys, ["coordinate", "-i", "@g", "-o", "@co",
                                     "--anno-label", "x", "--anno-filename",
                                     "in.fa"])
    assert jc is None and tc is None
    same_npz("jco.coord.annodbg.npz", "tco.coord.annodbg.npz")
    with pytest.raises(AttributeError):
        jmain(["coordinate", "-i", "jg", "-o", "jch", "--anno-header",
               "in.fa"])
    run(capsys, tmain, ["coordinate", "-i", "tg", "-o", "tch",
                        "--anno-header", "in.fa", "--device", "cpu"])
    same_npz("jc.coord.annodbg.npz", "tch.coord.annodbg.npz")


@pytest.mark.parametrize("anno", ["@x_row_diff_brwt.row_diff_brwt",
                                  "@x_int_brwt.int_brwt",
                                  "@x_unique_row.unique_row"])
def test_assemble_label_masks_over_compressed(work, capsys, anno):
    """assemble with label masks over a compressed annotation: the JAX
    package reads the column form's ``rows`` / ``cols`` (AttributeError
    on these forms, a fault of the reference); the port's output equals
    the JAX output over the column annotation."""
    kind = anno.split(".")[-1]
    convert(capsys, kind, "@a.column.annodbg.npz", f"@x_{kind}")
    masks = ["--unitigs", "--label-mask-in", "rec1", "--label-mask-out",
             "rec2", "--label-other-fraction", "0.5"]
    run(capsys, jmain, ["assemble", "-i", "jg", "-a", "ja.column.annodbg.npz",
                        "-o", "jdm"] + masks)
    got, code = run(capsys, tmain, ["assemble", "-i", "tg", "-a",
                                    anno.replace("@", "t") + ".annodbg.npz",
                                    "-o", f"tdm_{kind}", "--device", "cpu"]
                    + masks)
    assert code is None
    import gzip
    assert gzip.open(f"tdm_{kind}.fasta.gz").read() == \
        gzip.open("jdm.fasta.gz").read()


def test_query_coords_on_binary_annotation_fails_alike(work, capsys):
    with pytest.raises(AssertionError):
        jmain(["query", "-i", "jg", "-a", "ja.column.annodbg.npz",
               "--query-coords", "q.fa"])
    _, code = run(capsys, tmain, ["query", "-i", "tg", "-a",
                                  "ta.column.annodbg.npz", "--query-coords",
                                  "q.fa", "--device", "cpu"])
    assert code not in (0, None) and "coordinate annotation" in code


@pytest.mark.parametrize("anno_type", ["row_diff", "int_row_diff"])
def test_disk_swap_not_yet_ported(work, capsys, anno_type):
    """``--disk-swap`` was not yet ported; now the staged conversion of
    both files (``a``: counts, ``b``) writes the JAX CLI's file, equal to
    the in-memory conversion of their merge."""
    argv = ["transform_anno", "--anno-type", anno_type, "-i", "@g",
            "--disk-swap", "@swap", "--mem-cap-gb", "0.000001", "-o", "@ds",
            "@a.column.annodbg.npz"]
    if anno_type == "row_diff":
        argv.append("@b.column.annodbg.npz")
    j, t = both(capsys, argv)
    assert j == t and t[1] is None
    same_npz(f"jds.{anno_type}.annodbg.npz", f"tds.{anno_type}.annodbg.npz")


def test_primary_graph_row_diff(work, capsys):
    """On a primary graph the binary and integer row-diff builds fail in
    the JAX package (its successors run over the wrapper's 2N virtual
    nodes against N annotation rows: ValueError), and the port exits
    non-zero naming it; row_diff_coord converts, and its --query-coords
    prints alike."""
    for p, main, dev in (("j", jmain, []), ("t", tmain, ["--device", "cpu"])):
        for argv in (["build", "-k", "11", "--mode", "primary", "-o",
                      f"{p}p", "in.fa"],
                     ["annotate", "-i", f"{p}p", "--anno-header", "in.fa"],
                     ["coordinate", "-i", f"{p}p", "--anno-label", "x",
                      "in.fa"]):
            run(capsys, main, argv + dev)
    argv = ["transform_anno", "--anno-type", "row_diff", "-i", "jp", "-o",
            "jpr", "jp.column.annodbg.npz"]
    with pytest.raises(ValueError, match="broadcast"):
        jmain(argv)
    _, code = run(capsys, tmain, [x.replace("jp", "tp") for x in argv]
                  + ["--device", "cpu"])
    assert code not in (0, None) and "primary" in code
    (_, jc), (_, tc) = both(capsys, [
        "transform_anno", "--anno-type", "row_diff_coord", "-i", "@p", "-o",
        "@pc", "@p.coord.annodbg.npz"])
    assert jc is None and tc is None
    same_npz("jpc.row_diff_coord.annodbg.npz", "tpc.row_diff_coord.annodbg.npz")
    want, _ = run(capsys, jmain, ["query", "--query-coords", "-i", "jp",
                                  "-a", "tpc.row_diff_coord.annodbg.npz",
                                  "q.fa"])
    got, _ = run(capsys, tmain, ["query", "--query-coords", "-i", "tp",
                                 "-a", "jpc.row_diff_coord.annodbg.npz",
                                 "q.fa", "--device", "cpu"])
    assert got == want and "<x>:" in want
