"""The port's out-of-core staged RowDiff conversion against the JAX
package's and against the in-memory conversion.

Column files over one graph (two files with a shared label; a tiny
``mem_cap_mb`` forces several spilled runs and disk merges): the port's
``build_row_diff_staged`` / ``build_int_row_diff_staged`` give the JAX
package's staged result array for array (diff rows and columns, values,
anchors, successors) and decompress to the source; on one file they
equal the port's in-memory ``build_row_diff``. ``transform_anno
--disk-swap`` through both CLIs writes files that hold the same arrays
and load in either package. Each test draws its data from its own
generator.
"""

import numpy as np
import pytest
import torch

from metagraph_tpu.anno.annotator import Annotation as JAnnotation
from metagraph_tpu.anno.annotator import LabelEncoder as JEncoder
from metagraph_tpu.anno.matrix import RowSparse as JRowSparse
from metagraph_tpu.anno import row_diff_disk as jrdd
from metagraph_tpu.cli.main import main as jmain
from metagraph_tpu.graph.boss_construct import build_boss as jbuild
from metagraph_tpu.graph.dbg_succinct import DbgSuccinct as JDbg
from metagraph_tpu_torch.anno import row_diff as trd
from metagraph_tpu_torch.anno import row_diff_disk as trdd
from metagraph_tpu_torch.anno.annotator import Annotation
from metagraph_tpu_torch.cli.main import main as tmain
from metagraph_tpu_torch.graph import boss_construct as tbc
from metagraph_tpu_torch.graph.dbg_succinct import DbgSuccinct
from test_torch_graph_cli import run
from test_torch_sharded import seqs_of, write_fasta

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def graphs():
    seqs = seqs_of(201, 4, 300, 500)
    return (JDbg.from_boss(jbuild(seqs, 11)),
            DbgSuccinct.from_boss(tbc.build_boss(seqs, 11, device="cpu")))


def save_file(path, rows_by_label, num_rows, with_vals=False):
    """A column annotation file written by the JAX package."""
    enc = JEncoder()
    rr, cc, vv = [], [], []
    for label, rows, vals in rows_by_label:
        c = enc.insert(label)
        rr.append(np.asarray(rows, np.int64))
        cc.append(np.full(len(rows), c, np.int64))
        vv.append(np.asarray(vals, np.int64))
    mat = JRowSparse.from_coo(np.concatenate(rr), np.concatenate(cc),
                              num_rows, max(len(enc), 1),
                              values=np.concatenate(vv) if with_vals
                              else None)
    JAnnotation(matrix=mat, encoder=enc).save(path)


def two_files(tmp_path, N, seed, with_vals):
    rng = np.random.default_rng(seed)

    def rows_vals():
        rows = np.unique(rng.integers(0, N, int(rng.integers(1, N))))
        return rows, rng.integers(1, 9, len(rows))

    f1 = str(tmp_path / f"a{seed}.column.annodbg.npz")
    f2 = str(tmp_path / f"b{seed}.column.annodbg.npz")
    save_file(f1, [("L0", *rows_vals()), ("L1", *rows_vals())], N, with_vals)
    save_file(f2, [("L1", *rows_vals()), ("L2", *rows_vals())], N, with_vals)
    return [f1, f2]


def np_of(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("max_length", [8, 64])
@pytest.mark.parametrize("mem_cap_mb", [0, 64])
def test_staged_identical(graphs, tmp_path, max_length, mem_cap_mb):
    jg, tg = graphs
    files = two_files(tmp_path, tg.num_nodes(), 211 + max_length, False)
    j = jrdd.build_row_diff_staged(files, jg, swap_dir=str(tmp_path / "js"),
                                   mem_cap_mb=mem_cap_mb,
                                   max_length=max_length)
    t = trdd.build_row_diff_staged(files, tg, swap_dir=str(tmp_path / "ts"),
                                   mem_cap_mb=mem_cap_mb,
                                   max_length=max_length)
    assert t.encoder.labels == j.encoder.labels
    for a, b in ((t.matrix.diffs.rows, j.matrix.diffs.rows),
                 (t.matrix.diffs.cols, j.matrix.diffs.cols),
                 (t.matrix.anchor, j.matrix.anchor),
                 (t.matrix.succ, j.matrix.succ)):
        np.testing.assert_array_equal(np_of(a), np_of(b))
    # decompressed, the staged annotation is the merged source
    merged = Annotation.merge([Annotation.load(f, device="cpu")
                               for f in files], tg.num_nodes(), device="cpu")
    rows = torch.arange(tg.num_nodes())
    assert torch.equal(t.matrix.presence(rows), merged.matrix.presence(rows))


def test_staged_single_file_equals_in_memory(graphs, tmp_path):
    jg, tg = graphs
    N = tg.num_nodes()
    rng = np.random.default_rng(221)
    f1 = str(tmp_path / "c.column.annodbg.npz")
    rows = np.unique(rng.integers(0, N, N // 2))
    save_file(f1, [("only", rows, np.ones(len(rows)))], N)
    staged = trdd.build_row_diff_staged([f1], tg, swap_dir=str(tmp_path / "s"),
                                        mem_cap_mb=64)
    expect = trd.build_row_diff(Annotation.load(f1, device="cpu").matrix, tg)
    for a, b in ((staged.matrix.diffs.rows, expect.diffs.rows),
                 (staged.matrix.diffs.cols, expect.diffs.cols),
                 (staged.matrix.anchor, expect.anchor),
                 (staged.matrix.succ, expect.succ)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mem_cap_mb", [0, 64])
def test_int_staged_identical(graphs, tmp_path, mem_cap_mb):
    """Counts: values summed where the files repeat a (label, row)."""
    jg, tg = graphs
    files = two_files(tmp_path, tg.num_nodes(), 231 + mem_cap_mb, True)
    j = jrdd.build_int_row_diff_staged(files, jg, swap_dir=str(tmp_path / "j"),
                                       mem_cap_mb=mem_cap_mb, max_length=8)
    t = trdd.build_int_row_diff_staged(files, tg,
                                       swap_dir=str(tmp_path / "t"),
                                       mem_cap_mb=mem_cap_mb, max_length=8)
    assert t.encoder.labels == j.encoder.labels
    for name in ("rows", "cols", "vals", "anchor", "succ"):
        np.testing.assert_array_equal(np_of(getattr(t.matrix, name)),
                                      np_of(getattr(j.matrix, name)))
    merged = Annotation.merge([Annotation.load(f, device="cpu")
                               for f in files], tg.num_nodes(), device="cpu")
    rows = torch.arange(tg.num_nodes())
    assert torch.equal(t.matrix.values_dense(rows),
                       merged.matrix.values_dense(rows))


@pytest.mark.parametrize("target", ["row_diff", "int_row_diff"])
def test_cli_disk_swap_identical(tmp_path, target):
    seqs = seqs_of(241, 3, 200, 300)
    fa = str(tmp_path / "in.fa")
    write_fasta(fa, seqs)
    paths = {}
    for pkg, main, extra in (("j", jmain, []),
                             ("t", tmain, ["--device", "cpu"])):
        def p(name):
            return str(tmp_path / f"{pkg}_{name}")
        for argv in (["build", "-k", "11", "-o", p("g"), fa],
                     ["annotate", "-i", p("g"), "-o", p("a"), "--anno-header",
                      "--count-kmers", fa],
                     ["transform_anno", "--anno-type", target, "-i", p("g"),
                      "-o", p("disk"), "--disk-swap", p("swap"),
                      "--mem-cap-gb", "0.000001",
                      p("a") + ".column.annodbg.npz"],
                     ["transform_anno", "--anno-type", target, "-i", p("g"),
                      "-o", p("mem"), p("a") + ".column.annodbg.npz"]):
            _, code = run(main, argv + extra)
            assert code in (0, None), (pkg, argv)
        paths[pkg] = p("disk") + f".{target}.annodbg.npz"
        paths[pkg + "mem"] = p("mem") + f".{target}.annodbg.npz"
    with np.load(paths["j"]) as a, np.load(paths["t"]) as b, \
            np.load(paths["tmem"]) as m:
        assert sorted(a.files) == sorted(b.files) == sorted(m.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])
            np.testing.assert_array_equal(m[key], b[key])
    Annotation.load(paths["j"], device="cpu")
    JAnnotation.load(paths["t"])


@pytest.mark.parametrize("with_vals", [False, True])
def test_spilled_runs_merge_identical(tmp_path, with_vals):
    """Several spilled runs (past the 2^16-key floor of the spill cap)
    merged a few keys a block at a time: the JAX package's merge, and a
    stable sort of everything added."""
    rng = np.random.default_rng(251)
    chunks = [rng.integers(0, 50_000, int(rng.integers(10_000, 40_000)))
              for _ in range(8)]
    vals = [rng.integers(-5, 9, len(c)) for c in chunks]
    out = {}
    for pkg, mod in (("t", trdd), ("j", jrdd)):
        d = tmp_path / pkg
        d.mkdir()
        spill = mod._RunSpiller(str(d), 0, prefix="x", with_vals=with_vals)
        for c, v in zip(chunks, vals):
            spill.add(c.astype(np.int64), v if with_vals else None)
        spill.flush()
        assert len(spill.runs) >= 3
        if pkg == "t":          # no run past the cap, whatever was added
            assert max(np.load(r, mmap_mode="r").size
                       for r in spill.runs) <= spill.cap
        out[pkg] = mod._merge_runs(spill.runs, str(d), block=997,
                                   with_vals=with_vals)
    keys = np.concatenate(chunks)
    order = np.argsort(keys, kind="stable")
    if with_vals:
        np.testing.assert_array_equal(np.asarray(out["t"][0]), keys[order])
        np.testing.assert_array_equal(np.asarray(out["t"][0]),
                                      np.asarray(out["j"][0]))

        def pairs(k, v):
            k, v = np.asarray(k), np.asarray(v)
            o = np.lexsort((v, k))
            return np.stack([k[o], v[o]])
        # equal keys keep their value multiset (the order among them
        # follows where the runs were cut, which differs from the JAX
        # package's one run per add); the sums agree per key
        want = pairs(keys, np.concatenate(vals))
        np.testing.assert_array_equal(pairs(*out["t"]), want)
        np.testing.assert_array_equal(pairs(*out["j"]), want)
        np.testing.assert_array_equal(
            np.bincount(keys, weights=np.concatenate(vals)),
            np.bincount(np.asarray(out["t"][0]),
                        weights=np.asarray(out["t"][1])))
    else:
        np.testing.assert_array_equal(np.asarray(out["t"]), keys[order])
        np.testing.assert_array_equal(np.asarray(out["t"]),
                                      np.asarray(out["j"]))


def test_staged_many_labels_spills(graphs, tmp_path):
    """128 labels in one file over the graph's rows: more raw keys than
    one run holds (2^16 at the least), so stage 2a cuts the file into
    several spilled runs and merges them; equal to the JAX package's
    (which spills the file as one run)."""
    jg, tg = graphs
    N = tg.num_nodes()
    rng = np.random.default_rng(261)
    f1 = str(tmp_path / "m.column.annodbg.npz")
    labels = [(f"L{i}", np.unique(rng.integers(0, N, N))) for i in range(128)]
    assert sum(len(r) for _, r in labels) > 1 << 16
    save_file(f1, [(lab, r, np.ones(len(r))) for lab, r in labels], N)
    j = jrdd.build_row_diff_staged([f1], jg, swap_dir=str(tmp_path / "j"),
                                   mem_cap_mb=0, max_length=16)
    spilled = {}
    t = trdd.build_row_diff_staged([f1], tg, swap_dir=str(tmp_path / "t"),
                                   mem_cap_mb=0, max_length=16,
                                   spilled=spilled)
    total = sum(len(r) for _, r in labels)
    assert spilled == {"raw_runs": -(-total // (1 << 16)), "diff_runs":
                       -(-t.matrix.diffs.rows.numel() // (1 << 16))}
    assert spilled["raw_runs"] >= 2
    for a, b in ((t.matrix.diffs.rows, j.matrix.diffs.rows),
                 (t.matrix.diffs.cols, j.matrix.diffs.cols),
                 (t.matrix.anchor, j.matrix.anchor),
                 (t.matrix.succ, j.matrix.succ)):
        np.testing.assert_array_equal(np_of(a), np_of(b))
