"""The rest of the JAX package's public API in the port, call by call.

The row API of every annotation form (``sum_rows``, ``sum_row_values``,
``get_rows``, ``get_rows_dense``, ``get_row_values_dense``,
``row_values_list``, ``presence`` and the forms' own calls), the BRWT
linkage's pairs, ``AnnotatedDbg``'s per-sequence queries, ``query``'s
``format_query_result``, the BOSS navigation calls (``get_last``,
``succ_last``, ``succ_W``, ``index_range_nodes``, ``BitRank.rank0``,
``SymbolRank.seq_pad``), ``CanonicalDbg``'s degrees,
``kmc_to_sequences`` and the single-file ``build`` through the native
codec. The graphs and annotations are built by the JAX package and
handed to the port as their numpy arrays (``.dbg.npz`` files and
``annotation_from_numpy``), so both packages answer the same calls on
the same index. Small sizes (k = 7-11, a few hundred characters), numpy
seeds, integer results: every comparison is exact, integers as int64.
"""

import gzip
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_dna
from metagraph_tpu.anno import brwt as jbrwt
from metagraph_tpu.anno import coords as jco
from metagraph_tpu.anno import int_brwt as jib
from metagraph_tpu.anno import row_diff as jrd
from metagraph_tpu.anno import unique_row as jur
from metagraph_tpu.anno.matrix import RowSparse as JRowSparse
from metagraph_tpu.cli import main as jcli
from metagraph_tpu.engine.annotated_dbg import AnnotatedDbg as JAdbg
from metagraph_tpu.engine.annotated_dbg import _row_values_host
from metagraph_tpu.engine.annotated_dbg import annotate_sequences as jannot
from metagraph_tpu.graph import io as jio
from metagraph_tpu.graph.boss_construct import build_boss as jbuild
from metagraph_tpu.graph.canonical import CanonicalDbg as JCanonicalDbg
from metagraph_tpu.graph.dbg_succinct import DbgSuccinct as JDbg
from metagraph_tpu.kmer.alphabets import DNA
from metagraph_tpu.seqio.kmc import kmc_to_sequences as jkmc_to_sequences
from metagraph_tpu_torch.anno import brwt as tbrwt
from metagraph_tpu_torch.anno.annotator import annotation_from_numpy
from metagraph_tpu_torch.cli import main as tcli
from metagraph_tpu_torch.common import packed as tpacked
from metagraph_tpu_torch.engine.annotated_dbg import AnnotatedDbg
from metagraph_tpu_torch.graph import io as tio
from metagraph_tpu_torch.graph.canonical import CanonicalDbg
from metagraph_tpu_torch.native import native_available
from metagraph_tpu_torch.seqio import fasta as tfasta
from metagraph_tpu_torch.seqio.kmc import kmc_to_sequences
from test_kmc import _write_kmc2

torch.set_num_threads(2)
K = 9


def np64(x):
    """A result of either package as numpy, integers as int64."""
    a = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    return a if a.dtype == bool else a.astype(np.int64)


def lists(rows):
    return [[int(c) for c in r] for r in rows]


def port_annotation(j_matrix, num_labels):
    """The JAX form handed over as its arrays (the ``.annodbg.npz``
    dict) and loaded by the port's loader on the CPU."""
    d = dict(j_matrix.to_npz_dict(),
             labels=np.array([f"l{i}" for i in range(num_labels)]))
    return annotation_from_numpy(d, "cpu")


# ---------------------------------------------------------------------------
# the row API of every form
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def forms():
    """Every form of one graph's annotations, built by the JAX package
    and loaded by the port: binary (a label a record, one on several
    records, and records left out so that rows without bits exist),
    counts, and coordinates. ``max_length`` 3 makes most walks exactly
    that long; a pure cycle holds walks that never end at a sink."""
    rng = np.random.default_rng(15)
    unit = random_dna(rng, 24)
    seqs = [random_dna(rng, int(rng.integers(40, 120))) for _ in range(6)]
    seqs += [unit * 3 + unit[:K - 1]]
    jg = JDbg.from_boss(jbuild(seqs + [random_dna(rng, 60)], K))
    items = [(s, [f"l{i % 4}"] + (["all"] if i % 2 else []))
             for i, s in enumerate(seqs)]
    jb = jannot(jg, items).finalize().matrix
    jc = jannot(jg, items, with_counts=True).finalize().matrix
    jx = jco.annotate_coordinates(jg, items).finalize().matrix
    uniq = jur.UniqueRow.from_row_sparse(jb)
    built = {
        "column": jb,
        "row_diff": jrd.build_row_diff(jb, jg, 3),
        "row_diff_brwt": jrd.build_row_diff_brwt(jb, jg, 3),
        "brwt": jbrwt.build_brwt(jb),
        "brwt_relax": jbrwt.relax_brwt(jbrwt.build_brwt(jb), 4),
        "unique_row": uniq,
        "rb_brwt": uniq.with_brwt_distinct(),
        "int_column": jc,
        "int_row_diff": jrd.build_int_row_diff(jc, jg, 3),
        "int_brwt": jib.build_int_brwt(jc),
        "row_diff_int_brwt": jib.build_int_row_diff_brwt(jc, jg, 3),
        "column_coord": jx,
        "row_diff_coord": jco.build_tuple_row_diff(jx, jg, 3),
    }
    C = int(jb.num_cols)
    pairs = {name: (j, port_annotation(j, C).matrix)
             for name, j in built.items()}
    n = jb.num_rows
    set_rows = np.unique(np.asarray(jb.rows))
    absent = np.setdiff1d(np.arange(n), set_rows)
    assert len(absent) >= 8          # rows without a bit are queried too
    rows = np.concatenate([rng.choice(set_rows, 40), rng.choice(absent, 8),
                           set_rows[:3], set_rows[:3]]).astype(np.int64)
    rng.shuffle(rows)
    weights = rng.integers(1, 6, len(rows)).astype(np.int64)
    return dict(pairs=pairs, rows=rows, weights=weights, jb=jb, jc=jc,
                jx=jx, n=n)


def jax_call(j, name, *args):
    """``j.name(*args)``: a RowSparse takes device arrays, the other
    forms numpy."""
    conv = jnp.asarray if isinstance(j, JRowSparse) else np.asarray
    return getattr(j, name)(*[conv(a) for a in args])


def jax_dense(j, rows):
    """The JAX form's (Q, C) presence and (for the integer forms) values:
    the gold of every call it lacks."""
    pres = np64(jax_call(j, "presence", rows))
    if isinstance(j, JRowSparse):
        vals = (np64(j.values_dense(jnp.asarray(rows)))
                if j.values is not None else None)
    else:
        vals = (np64(j.get_row_values_dense(np.asarray(rows)))
                if hasattr(j, "get_row_values_dense") else None)
    return pres, vals


FORMS = ["column", "row_diff", "row_diff_brwt", "brwt", "brwt_relax",
         "unique_row", "rb_brwt", "int_column", "int_row_diff", "int_brwt",
         "row_diff_int_brwt", "column_coord", "row_diff_coord"]


@pytest.mark.parametrize("name", FORMS)
def test_row_api(forms, name):
    """Each call of the row API: equal to the JAX form's call of the same
    name where it has one, and always to the gold its presence and
    values give; duplicate rows count twice, rows without bits give
    nothing, an empty row list gives empty answers. The value calls raise
    on a binary form, as the JAX package fails there."""
    j, t = forms["pairs"][name]
    rows, w = forms["rows"], forms["weights"]
    pres, vals = jax_dense(j, rows)
    C = pres.shape[1]
    gold = {"presence": pres, "get_rows_dense": pres,
            "get_rows": [list(np.nonzero(r)[0]) for r in pres],
            "sum_rows": (pres * w[:, None]).sum(axis=0)}
    if vals is not None:
        q, c = np.nonzero(vals)
        gold.update(values_dense=vals, get_row_values_dense=vals,
                    sum_row_values=(vals * w[:, None]).sum(axis=0),
                    row_values_list=(c, vals[q, c]))
    for call, want in gold.items():
        args = (rows, w) if call.startswith("sum_") else (rows,)
        got = getattr(t, call)(*args)
        if call == "get_rows":
            assert got == lists(want), call
            if hasattr(j, call):
                assert got == lists(jax_call(j, call, rows)), call
            continue
        if call == "row_values_list":
            for g, x in zip(got, want):
                np.testing.assert_array_equal(np64(g), np64(x), err_msg=call)
            if hasattr(j, call):
                for g, x in zip(got, j.row_values_list(rows)):
                    np.testing.assert_array_equal(np64(g), np64(x))
            continue
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_array_equal(np64(got), np64(want), err_msg=call)
        if hasattr(j, call):
            np.testing.assert_array_equal(
                np64(got), np64(jax_call(j, call, *args)), err_msg=call)
    if vals is None:
        for call in ("sum_row_values", "row_values_list",
                     "get_row_values_dense", "values_dense"):
            args = (rows, w) if call.startswith("sum_") else (rows,)
            with pytest.raises(ValueError):
                getattr(t, call)(*args)
            with pytest.raises((AssertionError, AttributeError)):
                jax_call(j, call, *args)
    # the empty row list (torch and numpy inputs alike)
    empty = np.zeros(0, np.int64)
    assert t.get_rows(empty) == []
    assert tuple(t.get_rows_dense(torch.zeros(0, dtype=torch.int64))
                 .shape) == (0, C)
    np.testing.assert_array_equal(np64(t.sum_rows(empty, empty)),
                                  np.zeros(C, np.int64))
    if vals is not None:
        np.testing.assert_array_equal(np64(t.sum_row_values([], [])),
                                      np.zeros(C, np.int64))


def test_form_specific_calls(forms):
    """RowSparse.get_column and slice_rows (below a row's nnz, counts not
    cut), CoordMatrix.pair_key and columns_of_rows on both coordinate
    forms, IntBrwt.values, Brwt.num_tree_nodes and BrwtNode.num_set."""
    pairs, rows = forms["pairs"], forms["rows"]
    j, t = pairs["column"]
    for col in range(j.num_cols + 1):
        np.testing.assert_array_equal(np64(t.get_column(col)),
                                      np64(j.get_column(col)))
    widest = int(np.bincount(np.asarray(j.rows)).max())
    assert widest >= 2
    for width in (1, widest - 1, widest + 2):
        got, want = (x.slice_rows(conv(rows), width) for x, conv in
                     ((t, np.asarray), (j, jnp.asarray)))
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(np64(g), np64(w_))
    for name in ("column_coord", "row_diff_coord"):
        j, t = pairs[name]
        np.testing.assert_array_equal(np64(t.columns_of_rows(rows)),
                                      np64(j.columns_of_rows(rows)))
    j, t = pairs["column_coord"]
    r, c = rows, np.arange(len(rows)) % j.num_cols
    np.testing.assert_array_equal(np64(t.pair_key(r, c)),
                                  np64(j.pair_key(r, c)))
    j, t = pairs["int_brwt"]
    np.testing.assert_array_equal(np64(t.values), np64(j.values))
    for name in ("brwt", "brwt_relax", "rb_brwt"):
        j, t = pairs[name]
        tree = (j.distinct, t.distinct) if name == "rb_brwt" else (j, t)
        assert tree[1].num_tree_nodes() == tree[0].num_tree_nodes()
    bits = np.random.default_rng(3).integers(0, 2, 77).astype(bool)
    assert (tbrwt.BrwtNode(torch.from_numpy(bits), []).num_set
            == jbrwt.BrwtNode(bits, []).num_set == int(bits.sum()))


@pytest.mark.parametrize("subsample,seed", [(10 ** 6, 0), (40, 0), (40, 7)])
def test_greedy_linkage(forms, subsample, seed):
    """The pairs of JAX ``greedy_linkage`` over every column's rows,
    repeated columns included (equal similarities tie in numpy's argsort
    order), on all rows and on seeded subsamples; numpy and tensor
    columns alike."""
    jb, n = forms["jb"], forms["n"]
    cols = jbrwt._column_bitmaps(jb)
    cols = cols + [cols[0], cols[1], cols[0]]
    want = jbrwt.greedy_linkage(cols, n, subsample, seed)
    assert tbrwt.greedy_linkage(cols, n, subsample, seed,
                                device="cpu") == want
    assert tbrwt.greedy_linkage([torch.from_numpy(c) for c in cols], n,
                                subsample, seed) == want
    assert tbrwt.greedy_linkage(cols[:1], n, subsample, seed) == []


def test_quantile_values_match_jax_host(forms):
    """The count forms' ``row_values_list`` is what JAX
    ``_row_values_host`` gives the quantile query, row by row."""
    rows = forms["rows"]
    for name in ("int_column", "int_row_diff", "int_brwt",
                 "row_diff_int_brwt"):
        j, t = forms["pairs"][name]
        for g, w in zip(t.row_values_list(rows), _row_values_host(j, rows)):
            np.testing.assert_array_equal(np64(g), np64(w), err_msg=name)


# ---------------------------------------------------------------------------
# per-sequence queries and format_query_result
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["basic", "canonical", "primary"])
def indexes(request, tmp_path_factory):
    """One graph per mode built and annotated (labels, counts) by the JAX
    package, loaded by the port from its ``.dbg.npz`` through
    ``load_query_graph`` (a primary graph behind ``CanonicalDbg``); the
    column form and the row_diff_brwt form (basic) or the count form
    (canonical, primary: the JAX package builds no row-diff form of a
    primary graph); reads shorter than k, with N, as str, a
    reverse complement and random, most of one length (the JAX side
    compiles per length)."""
    mode = request.param
    k = 7 if mode == "basic" else 11
    rng = np.random.default_rng({"basic": 1, "canonical": 2,
                                 "primary": 3}[mode])
    seqs = [random_dna(rng, int(rng.integers(80, 140))) for _ in range(5)]
    path = str(tmp_path_factory.mktemp(f"q_{mode}") / "g")
    jio.save_graph(path, JDbg.from_boss(jbuild(seqs, k, mode=mode), DNA,
                                        mode))
    jg = jcli._load_graph(path + ".dbg.npz")
    tg = tio.load_query_graph(path, device="cpu")
    items = [(s, [f"l{i % 3}"] + (["odd"] if i % 2 else []))
             for i, s in enumerate(seqs)]
    ja = jannot(jg, items).finalize()
    annos = {"column": ja}
    if mode == "basic":
        annos["row_diff_brwt"] = type(ja)(
            matrix=jrd.build_row_diff_brwt(ja.matrix, jg, 4),
            encoder=ja.encoder)
    else:
        annos["counts"] = jannot(jg, items, with_counts=True).finalize()
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    mid = bytearray(seqs[1][5:65])
    mid[30] = ord("N")
    reads = [seqs[0][3:63], bytes(mid), seqs[2][:k - 1],
             seqs[3][10:70].decode(), seqs[4][::-1].translate(comp)[:60],
             random_dna(rng, 60)]
    pairs = {}
    for name, a in annos.items():
        d = dict(a.matrix.to_npz_dict(), labels=np.array(a.encoder.labels))
        pairs[name] = (JAdbg(graph=jg, annotation=a),
                       AnnotatedDbg(graph=tg, annotation=annotation_from_numpy(
                           d, "cpu")))
    return dict(pairs=pairs, reads=reads, k=k)


def per_sequence_calls(read, ratio, top):
    yield "get_labels", (read, ratio)
    yield "get_top_labels", (read, top, ratio)
    yield "get_top_label_signatures", (read, top, ratio)
    yield "get_label_count_quantiles", (read, top, ratio, [0.0, 0.5, 1.0])


def plain(result):
    """A per-sequence result with its numpy masks as lists."""
    return [(x[0], [bool(b) for b in x[1]]) if isinstance(x[1], np.ndarray)
            else x for x in result] if isinstance(result, list) else result


def same_or_both_raise(port, jax_, what) -> bool:
    """``port()`` equals ``jax_()``, or both raise (the port ValueError);
    whether they raised."""
    try:
        want = jax_()
    except (AssertionError, AttributeError):
        with pytest.raises(ValueError):
            port()
        return True
    assert plain(port()) == plain(want), what
    return False


def test_per_sequence_queries(indexes):
    """get_labels, get_top_labels (and with_kmer_counts on the count
    annotation), get_top_label_signatures and get_label_count_quantiles
    on every read, at ratios 0, 0.7 and 1, with ``num_top_labels`` binding
    (1, 2) and not: the JAX package's answers. with_kmer_counts on a binary
    annotation raises in both on the reads that report labels."""
    for name, (ja, ta) in indexes["pairs"].items():
        raised = 0
        # the JAX row_diff_brwt walk compiles per step and shape: three
        # reads and one setting there
        rdb = name == "row_diff_brwt"
        for read in indexes["reads"][1:4] if rdb else indexes["reads"]:
            for ratio, top in (((0.7, 2),) if rdb else
                               ((0.0, 1), (0.7, 2 ** 62), (1.0, 2))):
                for call, args in per_sequence_calls(read, ratio, top):
                    assert (plain(getattr(ta, call)(*args))
                            == plain(getattr(ja, call)(*args))), \
                        (name, call, read, ratio, top)
            args = (read, 2 ** 62, 0.3, True)
            raised += same_or_both_raise(lambda: ta.get_top_labels(*args),
                                         lambda: ja.get_top_labels(*args),
                                         (name, read))
        assert (raised > 0) == (name != "counts"), name


QUERY_MODES = {
    "labels": {},
    "count_labels": dict(count_labels=True),
    "query_counts": dict(query_counts=True),
    "count_quantiles": dict(count_quantiles="0 0.5 1"),
    "print_signature": dict(print_signature=True),
    "query_coords": dict(query_coords=True),
}


def query_args(mode, suppress):
    base = dict(print_signature=False, query_coords=False,
                count_quantiles=None, count_labels=False, query_counts=False,
                num_top_labels=2, discovery_fraction=0.5,
                anno_labels_delimiter=":", suppress_unlabeled=suppress)
    return SimpleNamespace(**dict(base, **QUERY_MODES[mode]))


@pytest.mark.parametrize("mode", sorted(QUERY_MODES))
def test_format_query_result(indexes, mode):
    """``format_query_result`` lines equal the JAX function's in every
    query mode, with and without --suppress-unlabeled, over the column,
    count and coordinate annotations (a read of exactly k characters is
    left out of --print-signature: both packages fail on it); where the
    JAX function raises (k-mer counts over a binary annotation on a read
    that reports labels, coordinates over any other annotation), the port
    raises too."""
    pairs = dict(indexes["pairs"])
    if mode == "query_coords":
        ja, ta = pairs["column"]
        jx = type(ja.annotation)(
            matrix=jco.annotate_coordinates(
                ja.graph, [(b"ACGT" * 20, ["x"])]).finalize().matrix,
            encoder=ja.annotation.encoder)
        d = dict(jx.matrix.to_npz_dict(),
                 labels=np.array(jx.encoder.labels))
        pairs["coords"] = (JAdbg(graph=ja.graph, annotation=jx),
                           AnnotatedDbg(graph=ta.graph,
                                        annotation=annotation_from_numpy(
                                            d, "cpu")))
    reads = [r for r in indexes["reads"] if not (
        mode == "print_signature" and len(r) == indexes["k"])]
    for name, (ja, ta) in pairs.items():
        raised = 0
        for suppress in (False, True):
            args = query_args(mode, suppress)
            for i, read in enumerate(reads):
                seq = read.encode() if isinstance(read, str) else read
                raised += same_or_both_raise(
                    lambda: tcli.format_query_result(i, f"r{i}", ta, seq,
                                                     args),
                    lambda: jcli.format_query_result(i, f"r{i}", ja, seq,
                                                     args), (name, read))
        assert (raised > 0) == ((mode == "query_counts" and name != "counts")
                                or (mode == "query_coords"
                                    and name != "coords")), name


# ---------------------------------------------------------------------------
# BOSS navigation, CanonicalDbg degrees
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """A JAX primary graph (BOSS tables as in any mode; CanonicalDbg
    wraps it), saved fast and small, loaded by both packages."""
    rng = np.random.default_rng(21)
    seqs = [random_dna(rng, int(rng.integers(30, 150))) for _ in range(8)]
    seqs.append(b"ACGTACGTAC" * 4)
    jg = JDbg.from_boss(jbuild(seqs, K, mode="primary"), DNA, "primary")
    tmp = tmp_path_factory.mktemp("nav")
    out = {}
    for state in ("fast", "small"):
        p = jio.save_graph(str(tmp / state), jg, state=state)
        out[state] = (jio.load_graph(p), tio.load_graph(p, device="cpu"))
    return out


def test_navigation(graphs):
    """get_last, succ_last, succ_W (every label c, minus flags included),
    rank_last's complement rank0 and seq_pad on every position, past both
    ends too, on the fast and the small state; on the fast state
    index_range_nodes of every edge's source node and of absent nodes,
    and CanonicalDbg.outdegree / indegree of every virtual node (the small
    state has no packed node k-mers in either package)."""
    for state, (jg, tg) in graphs.items():
        jb, tb = jg.boss, tg.boss
        m = jb.num_edges
        i = np.arange(-2, m + 3, dtype=np.int64)
        ji, ti = jnp.asarray(i, jnp.int32), torch.from_numpy(i)
        for call in ("get_last", "succ_last"):
            np.testing.assert_array_equal(
                np64(getattr(tb, call)(ti)), np64(getattr(jb, call)(ji)),
                err_msg=f"{state} {call}")
        np.testing.assert_array_equal(np64(tb.last_rank.rank0(ti)),
                                      np64(jb.last_rank.rank0(ji)))
        np.testing.assert_array_equal(np64(tb.W_rank.seq_pad),
                                      np64(jb.W_rank.seq_pad))
        sigma = 2 * jb.alph_size
        ii = np.tile(np.arange(0, m + 2, dtype=np.int64), sigma)
        cc = np.repeat(np.arange(sigma, dtype=np.int64), m + 2)
        np.testing.assert_array_equal(
            np64(tb.succ_W(torch.from_numpy(ii), torch.from_numpy(cc))),
            np64(jb.succ_W(jnp.asarray(ii, jnp.int32),
                           jnp.asarray(cc, jnp.int32))),
            err_msg=f"{state} succ_W")
        if state == "small":
            with pytest.raises(ValueError):
                tb.index_range_nodes(tpacked.zeros(1, 1, "cpu"))
            continue
        lanes = tb.edge_lanes
        B = tb.bits_per_char
        nodes = tpacked.set_field(lanes, 0, torch.zeros(
            lanes.shape[1], dtype=lanes.dtype), B)
        rand = tpacked.from_fields(torch.from_numpy(
            np.random.default_rng(5).integers(1, 5, (tb.K, 16))
            .astype(np.int32)), B, lanes.shape[0])
        rand = tpacked.set_field(rand, 0, torch.zeros(16, dtype=lanes.dtype),
                                 B)
        q = torch.cat([nodes, rand], dim=1)
        got = tb.index_range_nodes(q)
        want = jb.index_range_nodes(jnp.asarray(
            tpacked.lanes_to_numpy(q)))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np64(g), np64(w))
        jw, tw = JCanonicalDbg(base=jg), CanonicalDbg(base=tg)
        nodes = np.arange(0, 2 * int(jg.num_nodes()) + 1)
        for call in ("outdegree", "indegree"):
            np.testing.assert_array_equal(
                np64(getattr(tw, call)(torch.from_numpy(nodes))),
                np64(getattr(jw, call)(jnp.asarray(nodes, jnp.int32))),
                err_msg=call)


# ---------------------------------------------------------------------------
# KMC input and the single-file build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("both", [0, 1])
def test_kmc_to_sequences(tmp_path, both):
    """The separator-joined code array and counts of JAX
    ``kmc_to_sequences`` on ``tests/test_kmc.py``'s KMC2 writer, with and
    without both strands, and under count bounds."""
    rng = np.random.default_rng(8)
    k = 11
    kmers = np.unique(rng.integers(0, 4, (60, k)).astype(np.uint8), axis=0)
    counts = rng.integers(1, 9, len(kmers))
    base = _write_kmc2(tmp_path, kmers, counts, k, p=3, sig_len=4, n_bins=5,
                       both_strands_byte=both)
    for bounds in ((1, None), (3, 6)):
        got, want = kmc_to_sequences(base, *bounds), jkmc_to_sequences(
            base, *bounds)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def npz(path):
    with np.load(path) as d:
        return {key: d[key] for key in d.files}


@pytest.mark.parametrize("mode,extra", [("basic", ()),
                                        ("canonical", ("--count-kmers",))])
def test_single_file_build_native_codec(tmp_path, capsys, mode, extra):
    """``build`` of one (gzipped) FASTA file reads it through
    ``read_and_encode``'s native codec, logs the route, and writes the
    JAX CLI's ``.dbg.npz`` arrays; the records split into two files (the
    parsed-records route) give the same arrays."""
    if not native_available():
        pytest.skip("no C compiler: the native codec cannot build")
    rng = np.random.default_rng(12)
    recs = [random_dna(rng, int(rng.integers(50, 300))) for _ in range(12)]
    recs[3] = recs[3][:40] + b"NN" + recs[3][40:]
    text = b"".join(b">r%d\n%s\n" % (i, s) for i, s in enumerate(recs))
    one = tmp_path / "in.fa.gz"
    with gzip.open(one, "wb") as f:
        f.write(text)
    halves = [tmp_path / "a.fa", tmp_path / "b.fa"]
    for h, part in zip(halves, (recs[:6], recs[6:])):
        h.write_bytes(b"".join(b">x\n%s\n" % s for s in part))
    argv = ["build", "-k", "11", "--mode", mode, *extra]
    jcli.main(argv + ["-o", str(tmp_path / "j"), str(one)])
    capsys.readouterr()
    tcli.main(argv + ["-o", str(tmp_path / "t"), str(one), "--device",
                      "cpu"])
    assert "M chars (native codec)" in capsys.readouterr().err
    assert tfasta.last_route == "native codec"
    tcli.main(argv + ["-o", str(tmp_path / "two"), *map(str, halves),
                      "--device", "cpu"])
    want = npz(tmp_path / "j.dbg.npz")
    for got in (npz(tmp_path / "t.dbg.npz"), npz(tmp_path / "two.dbg.npz")):
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_read_and_encode_routes(tmp_path, monkeypatch):
    """``read_and_encode``: the codec's codes where it runs, the Python
    parser's (equal) where the codec returns None, as in the JAX
    package; ``last_route`` names each."""
    from metagraph_tpu.seqio.fasta import read_and_encode as jread
    from metagraph_tpu_torch import native
    from metagraph_tpu_torch.kmer.alphabets import DNA
    rng = np.random.default_rng(13)
    path = tmp_path / "r.fq"
    path.write_bytes(b"".join(b"@q%d\n%s\n+\n%s\n" % (i, s, b"I" * len(s))
                              for i, s in enumerate(
                                  random_dna(rng, 30 + i) for i in range(9))))
    want = jread(str(path), DNA)
    if native_available():
        np.testing.assert_array_equal(tfasta.read_and_encode(str(path), DNA),
                                      want)
        assert tfasta.last_route == "native codec"
    monkeypatch.setattr(native, "fasta_encode_native", lambda *a: None)
    np.testing.assert_array_equal(tfasta.read_and_encode(str(path), DNA),
                                  want)
    assert tfasta.last_route == "Python parser"
