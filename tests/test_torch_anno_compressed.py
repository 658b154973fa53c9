"""The port's compressed and coordinate annotations against the JAX
package's, module by module.

The same seeded inputs (k = 11 graphs over a few hundred rows, 1-9
columns) go through the JAX and the port builds of every form; every
array of the two ``.annodbg.npz`` dicts must be equal (dtypes too), and
so must ``presence``, the values of the integer forms, the coordinates,
and each form's rows against the column annotation it came from. The
graph holds the cases a walk or a build gets wrong by one: rows exactly
``max_length - 1`` steps from their anchor, a pure cycle, forks whose
branches tie in label count, and a label with no rows.
"""

import numpy as np
import pytest
import torch

from conftest import random_dna
from metagraph_tpu.anno import brwt as jbrwt
from metagraph_tpu.anno import coords as jco
from metagraph_tpu.anno import int_brwt as jib
from metagraph_tpu.anno import row_diff as jrd
from metagraph_tpu.anno import unique_row as jur
from metagraph_tpu.anno.annotator import Annotation as JAnnotation
from metagraph_tpu.anno.matrix import RowSparse as JRowSparse
from metagraph_tpu.engine.annotated_dbg import AnnotatedDbg as JAdbg
from metagraph_tpu.engine.annotated_dbg import BatchQuery as JBatchQuery
from metagraph_tpu.engine.annotated_dbg import annotate_sequences as jannot
from metagraph_tpu.graph.boss_construct import build_boss as jbuild
from metagraph_tpu.graph.dbg_succinct import DbgSuccinct as JDbg
from metagraph_tpu_torch.anno import brwt as tbrwt
from metagraph_tpu_torch.anno import coords as tco
from metagraph_tpu_torch.anno import int_brwt as tib
from metagraph_tpu_torch.anno import row_diff as trd
from metagraph_tpu_torch.anno import unique_row as tur
from metagraph_tpu_torch.anno.annotator import Annotation, annotation_from_numpy
from metagraph_tpu_torch.anno.matrix import RowSparse
from metagraph_tpu_torch.engine import annotated_dbg
from metagraph_tpu_torch.engine.annotated_dbg import AnnotatedDbg, BatchQuery
from metagraph_tpu_torch.engine.annotated_dbg import annotate_sequences
from metagraph_tpu_torch.graph.boss_construct import build_boss
from metagraph_tpu_torch.graph.dbg_succinct import DbgSuccinct

torch.set_num_threads(2)
K = 11


def same_dict(j: dict, t: dict):
    assert sorted(j) == sorted(t)
    for key in j:
        a, b = np.asarray(j[key]), np.asarray(t[key])
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.fixture(scope="module")
def world():
    """Both packages' graph of the same records and their annotations:
    binary (a label per record, one on all, and an empty one), counts,
    and coordinates."""
    rng = np.random.default_rng(44)
    shared = random_dna(rng, 30)
    unit = random_dna(rng, 40)
    seqs = [random_dna(rng, int(rng.integers(60, 200))) for _ in range(5)]
    # two branches of one fork, each its own label: their rows tie
    seqs += [shared + b"A" + random_dna(rng, 50),
             shared + b"G" + random_dna(rng, 50)]
    seqs += [unit * 3 + unit[:K - 1]]            # a pure cycle of 40 nodes
    items = [(s, [f"l{i % 6}", "all"]) for i, s in enumerate(seqs)]
    items.append((b"ACGT", ["empty"]))           # no windows: empty column
    jg = JDbg.from_boss(jbuild(seqs, K))
    tg = DbgSuccinct.from_boss(build_boss(seqs, K, device="cpu"))
    jb, tb = jannot(jg, items).finalize(), annotate_sequences(tg,
                                                              items).finalize()
    jc = jannot(jg, items, with_counts=True).finalize()
    tc = annotate_sequences(tg, items, with_counts=True).finalize()
    jx = jco.annotate_coordinates(jg, items).finalize()
    tx = tco.annotate_coordinates(tg, items).finalize()
    for j, t in ((jb, tb), (jc, tc), (jx, tx)):
        same_dict(j.matrix.to_npz_dict(), t.matrix.to_npz_dict())
        assert j.encoder.labels == t.encoder.labels
    return dict(jg=jg, tg=tg, jb=jb, tb=tb, jc=jc, tc=tc, jx=jx, tx=tx,
                seqs=seqs, items=items)


def dense_of(m: RowSparse, values=False) -> np.ndarray:
    out = np.zeros((m.num_rows, m.num_cols), np.int64)
    v = m.values.numpy() if values else 1
    out[m.rows.numpy(), m.cols.numpy()] = v
    return out


def all_rows(m):
    return torch.arange(m.num_rows)


def check_form(j, t, truth=None, values=False):
    """Equal arrays, equal presence (and values) to the JAX form's and to
    the truth, a round trip through the JAX form's dict."""
    same_dict(j.to_npz_dict(), t.to_npz_dict())
    rows = np.arange(t.num_rows)
    pres = t.presence(all_rows(t)).numpy()
    np.testing.assert_array_equal(pres, np.asarray(j.presence(rows)))
    if truth is not None:
        np.testing.assert_array_equal(pres, truth > 0)
    if values:
        got = t.values_dense(all_rows(t)).numpy()
        np.testing.assert_array_equal(got, j.get_row_values_dense(rows))
        if truth is not None:
            np.testing.assert_array_equal(got, truth)
    d = dict(j.to_npz_dict(), labels=np.array(["x"] * t.num_cols))
    back = annotation_from_numpy(d, "cpu").matrix
    assert type(back) is type(t)
    np.testing.assert_array_equal(back.presence(all_rows(t)).numpy(), pres)


def walk_lengths(rd) -> np.ndarray:
    """Nodes on each row's walk to its anchor (numpy, from the form)."""
    anchor, succ = rd.anchor.numpy(), rd.succ.numpy()
    out = np.zeros(len(anchor), np.int64)
    for r in range(len(anchor)):
        cur, n = r, 1
        while not anchor[cur] and succ[cur] >= 0:
            cur, n = succ[cur], n + 1
        out[r] = n
    return out


@pytest.mark.parametrize("max_length", [3, 7, 64])
def test_row_diff_identical(world, max_length):
    """RowDiff and IntRowDiff: the successors, anchors and diffs of the
    JAX builds; every row, including those max_length - 1 steps from
    their anchor and those on the cycle, decodes to the column form."""
    jg, tg = world["jg"], world["tg"]
    jb, tb, jc, tc = (world[x].matrix for x in ("jb", "tb", "jc", "tc"))
    succ, anchor = trd.assign_successors_and_anchors(
        tg, max_length, trd.compute_row_counts(tb))
    jsucc, janchor = jrd.assign_successors_and_anchors(
        jg, max_length, jrd.compute_row_counts(jb))
    np.testing.assert_array_equal(succ.numpy(), jsucc)
    np.testing.assert_array_equal(anchor.numpy(), janchor)
    rd = trd.build_row_diff(tb, tg, max_length)
    check_form(jrd.build_row_diff(jb, jg, max_length), rd, dense_of(tb))
    lengths = walk_lengths(rd)
    if max_length < 64:
        assert lengths.max() == max_length      # the longest walks occur
    ird = trd.build_int_row_diff(tc, tg, max_length)
    check_form(jrd.build_int_row_diff(jc, jg, max_length), ird,
               dense_of(tc, values=True), values=True)
    for fn, jfn, m, jm in ((trd.compute_row_reduction,
                            jrd.compute_row_reduction, tb, jb),
                           (trd.compute_row_reduction_int,
                            jrd.compute_row_reduction_int, tc, jc)):
        np.testing.assert_array_equal(fn(m, tg, max_length).numpy(),
                                      jfn(jm, jg, max_length))


def test_row_diff_fork_tie_and_cycle(world):
    """At the fork the two branches carry one label each: the first
    successor wins the tie, as argmax's first maximum; the cycle's
    minimum node is an anchor, every other cycle node has a successor."""
    tg, tb = world["tg"], world["tb"].matrix
    counts = trd.compute_row_counts(tb)
    succ, anchor = trd.assign_successors_and_anchors(tg, 64, counts)
    succs = tg.successors(torch.arange(1, tg.num_nodes() + 1))
    fork = torch.nonzero((succs > 0).sum(dim=1) > 1).squeeze(1)
    assert fork.numel()
    for v in fork.tolist():
        cand = succs[v][succs[v] > 0]
        cnt = counts[cand - 1]
        want = cand[torch.nonzero(cnt == cnt.max())[0, 0]] - 1
        assert int(succ[v]) == int(want)
    ties = [v for v in fork.tolist()
            if len(set(counts[succs[v][succs[v] > 0] - 1].tolist())) == 1]
    assert ties                       # a tied fork is among them
    cycle_rows = world["tg"].map_to_nodes(world["seqs"][-1]) - 1
    lead = int(cycle_rows.min())
    assert bool(anchor[lead])
    assert all(int(succ[r]) >= 0 for r in set(cycle_rows.tolist()) - {lead})


def test_brwt_identical(world):
    """Brwt (greedy linkage over ties and an empty column), its relaxed
    form, a linkage-guided build, the linkage rows themselves, and a
    sample smaller than the rows."""
    jb, tb = world["jb"].matrix, world["tb"].matrix
    truth = dense_of(tb)
    assert truth[:, world["tb"].encoder.encode("empty")].sum() == 0
    assert tbrwt.compute_linkage(tb) == jbrwt.compute_linkage(jb)
    assert tbrwt.compute_linkage(tb, 40) == jbrwt.compute_linkage(jb, 40)
    b = tbrwt.build_brwt(tb)
    jbw = jbrwt.build_brwt(jb)
    check_form(jbw, b, truth)
    assert b.nnz == jbw.nnz and b.num_nodes() == jbw.num_nodes()
    for arity in (3, 8):
        check_form(jbrwt.relax_brwt(jbw, arity), tbrwt.relax_brwt(b, arity),
                   truth)
    link = [(0, 1, 0.0, 9), (2, 3, 0.0, 9), (4, 9, 0.0, 10)]
    check_form(jbrwt.build_brwt(jb, linkage=link),
               tbrwt.build_brwt(tb, linkage=link), truth)
    check_form(jbrwt.build_brwt(jb, subsample=25),
               tbrwt.build_brwt(tb, subsample=25), truth)
    # rows the sample skips and columns of one row
    rng = np.random.default_rng(3)
    dense = rng.random((300, 9)) < 0.1
    r, c = np.nonzero(dense)
    jm = JRowSparse.from_coo(r, c, 300, 9)
    tm = RowSparse.from_coo(r, c, 300, 9, device="cpu")
    check_form(jbrwt.build_brwt(jm, subsample=100),
               tbrwt.build_brwt(tm, subsample=100), dense)


def test_int_brwt_identical(world):
    jg, tg = world["jg"], world["tg"]
    jc, tc = world["jc"].matrix, world["tc"].matrix
    truth = dense_of(tc, values=True)
    check_form(jib.build_int_brwt(jc), tib.build_int_brwt(tc), truth,
               values=True)
    for max_length in (4, 64):
        check_form(jib.build_int_row_diff_brwt(jc, jg, max_length),
                   tib.build_int_row_diff_brwt(tc, tg, max_length), truth,
                   values=True)
    check_form(jrd.build_row_diff_brwt(world["jb"].matrix, jg, 5),
               trd.build_row_diff_brwt(world["tb"].matrix, tg, 5),
               dense_of(world["tb"].matrix))


def test_unique_row_identical(world):
    """UniqueRow (and Rainbow<BRWT>) on the annotation, and on a matrix
    whose rows need more than 8 lanes (the chunked lexicographic sort)."""
    jb, tb = world["jb"].matrix, world["tb"].matrix
    ur = tur.UniqueRow.from_row_sparse(tb)
    jur_ = jur.UniqueRow.from_row_sparse(jb)
    check_form(jur_, ur, dense_of(tb))
    assert ur.nnz == jur_.nnz == tb.nnz
    check_form(jur_.with_brwt_distinct(), ur.with_brwt_distinct(),
               dense_of(tb))
    rng = np.random.default_rng(9)
    patterns = rng.random((7, 300)) < 0.5
    dense = patterns[rng.integers(0, 7, 120)]
    dense[5] = False                               # an empty row
    r, c = np.nonzero(dense)
    jm = JRowSparse.from_coo(r, c, 120, 300)
    tm = RowSparse.from_coo(r, c, 120, 300, device="cpu")
    wide = tur.UniqueRow.from_row_sparse(tm)
    check_form(jur.UniqueRow.from_row_sparse(jm), wide, dense)
    assert wide.num_distinct_rows <= 8
    np.testing.assert_array_equal(
        wide.to_row_sparse().rows.numpy(), tm.rows.numpy())


@pytest.mark.parametrize("max_length", [3, 64])
def test_coords_identical(world, max_length):
    """CoordMatrix and TupleRowDiff: equal arrays, equal tuples per row
    and column (the walk's depth shift and symmetric difference), and the
    coordinates against a direct gold of the records' windows."""
    jg, tg = world["jg"], world["tg"]
    jx, tx = world["jx"].matrix, world["tx"].matrix
    trd_ = tco.build_tuple_row_diff(tx, tg, max_length)
    jtrd = jco.build_tuple_row_diff(jx, jg, max_length)
    same_dict(jtrd.to_npz_dict(), trd_.to_npz_dict())
    rows = np.arange(tx.num_rows)
    for j, t in ((jx, tx), (jtrd, trd_)):
        check_form(j, t)
        for c in range(tx.num_cols):
            want = [sorted(int(v) for v in x) for x in j.get_tuples(rows, c)]
            assert t.get_tuples(rows, c) == want
    # gold: label l's axis is its records' windows, one after the other
    enc = world["tx"].encoder
    gold = {}
    offsets = {}
    for seq, labels in world["items"]:
        nodes = tg.map_to_nodes(seq)
        for label in labels:
            off = offsets.get(label, 0)
            for w, v in enumerate(nodes):
                if v > 0:
                    gold.setdefault((int(v) - 1, enc.encode(label)),
                                    []).append(off + w)
            offsets[label] = off + len(nodes)
    rec = trd_.tuples_for_rows(rows)
    got = {(r, c): list(x) for r, d in rec.items() for c, x in d.items()}
    assert got == {key: sorted(v) for key, v in gold.items()}


FORMS = ["column", "brwt", "row_diff", "row_diff_brwt", "unique_row",
         "rb_brwt", "int_row_diff", "int_brwt", "row_diff_int_brwt",
         "coord", "tuple_row_diff"]


def make_form(world, name):
    """(JAX matrix, port matrix) of one form (counts for the int forms)."""
    jg, tg = world["jg"], world["tg"]
    src = "c" if "int" in name else ("x" if "coord" in name
                                     or "tuple" in name else "b")
    j, t = world["j" + src].matrix, world["t" + src].matrix
    build = {
        "column": (lambda m, g: m, lambda m, g: m),
        "coord": (lambda m, g: m, lambda m, g: m),
        "brwt": (lambda m, g: jbrwt.build_brwt(m),
                 lambda m, g: tbrwt.build_brwt(m)),
        "row_diff": (lambda m, g: jrd.build_row_diff(m, g, 5),
                     lambda m, g: trd.build_row_diff(m, g, 5)),
        "row_diff_brwt": (lambda m, g: jrd.build_row_diff_brwt(m, g, 5),
                          lambda m, g: trd.build_row_diff_brwt(m, g, 5)),
        "unique_row": (lambda m, g: jur.UniqueRow.from_row_sparse(m),
                       lambda m, g: tur.UniqueRow.from_row_sparse(m)),
        "rb_brwt": (lambda m, g: jur.UniqueRow.from_row_sparse(m)
                    .with_brwt_distinct(),
                    lambda m, g: tur.UniqueRow.from_row_sparse(m)
                    .with_brwt_distinct()),
        "int_row_diff": (lambda m, g: jrd.build_int_row_diff(m, g, 5),
                         lambda m, g: trd.build_int_row_diff(m, g, 5)),
        "int_brwt": (lambda m, g: jib.build_int_brwt(m),
                     lambda m, g: tib.build_int_brwt(m)),
        "row_diff_int_brwt": (
            lambda m, g: jib.build_int_row_diff_brwt(m, g, 5),
            lambda m, g: tib.build_int_row_diff_brwt(m, g, 5)),
        "tuple_row_diff": (lambda m, g: jco.build_tuple_row_diff(m, g, 5),
                           lambda m, g: tco.build_tuple_row_diff(m, g, 5)),
    }[name]
    enc = world["j" + src].encoder
    return (JAnnotation(matrix=build[0](j, jg), encoder=enc),
            Annotation(matrix=build[1](t, tg), encoder=world["t" + src]
                       .encoder))


@pytest.mark.parametrize("chunk", [None, 7], ids=["one_call", "chunks"])
@pytest.mark.parametrize("name", FORMS)
def test_batch_query_identical(world, name, chunk, monkeypatch):
    """BatchQuery over every form: labels, label counts, k-mer counts,
    quantiles, signatures (and coordinates) equal the JAX executor's,
    also when the batch is decoded 7 windows per ``row_hits`` call (the
    chunks then split reads, walks and descents anywhere)."""
    if chunk is not None:
        monkeypatch.setattr(annotated_dbg, "_CHUNK", chunk)
    ja, ta = make_form(world, name)
    jq = JBatchQuery(JAdbg(graph=world["jg"], annotation=ja))
    tq = BatchQuery(AnnotatedDbg(graph=world["tg"], annotation=ta))
    rng = np.random.default_rng(12)
    reads = [s[i:i + 40] for s in world["seqs"] for i in (0, 17)]
    reads += [random_dna(rng, 45), world["seqs"][5][:50]
              + world["seqs"][6][31:70]]
    assert tq.get_labels_batch(reads, 0.3) == jq.get_labels_batch(reads, 0.3)
    assert tq.get_top_labels_batch(reads, 3, 0.0) == \
        jq.get_top_labels_batch(reads, 3, 0.0)
    if "coord" not in name and "tuple" not in name:
        # the JAX package reads the column form's fields for quantiles of a
        # coordinate annotation (AttributeError): not compared there
        assert tq.get_top_labels_batch(reads, 2 ** 62, 0.2, True) == \
            jq.get_top_labels_batch(reads, 2 ** 62, 0.2, True)
        assert tq.get_label_count_quantiles_batch(reads, 5, 0.0,
                                                  [0, 0.5, 1]) == \
            jq.get_label_count_quantiles_batch(reads, 5, 0.0, [0, 0.5, 1])
    for (lt, mt), (lj, mj) in zip(
            sum(tq.get_top_label_signatures_batch(reads), []),
            sum(jq.get_top_label_signatures_batch(reads), [])):
        assert lt == lj and np.array_equal(mt, mj)
    if "coord" in name or "tuple" in name:
        want = jq.get_kmer_coordinates_batch(reads, 4, 0.1)
        assert tq.get_kmer_coordinates_batch(reads, 4, 0.1) == want
        for read, w in zip(reads, want):
            assert AnnotatedDbg(graph=world["tg"], annotation=ta) \
                .get_kmer_coordinates(read, 4, 0.1) == w
            assert JAdbg(graph=world["jg"], annotation=ja) \
                .get_kmer_coordinates(read, 4, 0.1) == w


def test_annotation_merge_identical(world):
    parts_j = [world["jb"], world["jc"]]
    parts_t = [world["tb"], world["tc"]]
    n = world["tb"].matrix.num_rows
    m_j = JAnnotation.merge(parts_j, n)
    m_t = Annotation.merge(parts_t, n, device="cpu")
    same_dict(m_j.matrix.to_npz_dict(), m_t.matrix.to_npz_dict())
    assert m_j.encoder.labels == m_t.encoder.labels
