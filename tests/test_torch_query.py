"""The port's query path against the JAX package.

A graph and a column annotation are built by the JAX package; their
arrays go to the port through ``dbg_from_numpy`` and
``annotation_from_numpy``; then node mapping, ``label_count_matrix``,
``get_labels_batch``, ``get_top_labels_batch`` and ``get_top_labels``
must be identical, on batches that hold every case of the selection
(``query_batch``). The
rank/select structures, ``RowSparse.from_coo`` and ``annotate_sequences``
are compared the same way. Integer data: the tolerance is exact.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_dna
from metagraph_tpu.anno.annotator import ColumnAnnotator as JColumnAnnotator
from metagraph_tpu.anno.matrix import RowSparse as JRowSparse
from metagraph_tpu.common.ranksel import BitRank as JBitRank
from metagraph_tpu.common.ranksel import SymbolRank as JSymbolRank
from metagraph_tpu.engine import annotated_dbg as jeng
from metagraph_tpu.graph.boss_construct import build_boss as jbuild
from metagraph_tpu.graph.dbg_succinct import DbgSuccinct as JDbg
from metagraph_tpu.kmer.alphabets import DNA
from metagraph_tpu_torch.anno.annotator import annotation_from_numpy
from metagraph_tpu_torch.anno.matrix import RowSparse as TRowSparse
from metagraph_tpu_torch.common.ranksel import BitRank, SymbolRank
from metagraph_tpu_torch.engine import annotated_dbg as teng
from metagraph_tpu_torch.graph.io import dbg_from_numpy

torch.set_num_threads(2)


def jax_state(g, ann):
    """The JAX package's graph and annotation as numpy arrays."""
    boss = g.boss
    gd = dict(k=boss.k, alphabet=g.alphabet.name, mode=g.mode,
              W=np.asarray(boss.W), last=boss.last_rank.bits_host(),
              F=np.asarray(boss.F), edge_lanes=np.asarray(boss.edge_lanes),
              valid=g.valid_rank.bits_host())
    if boss.weights is not None:
        gd["weights"] = np.asarray(boss.weights)
    m = ann.matrix
    ad = dict(rows=np.asarray(m.rows), cols=np.asarray(m.cols),
              num_rows=m.num_rows, labels=np.array(ann.encoder.labels))
    if m.values is not None:
        ad["values"] = np.asarray(m.values)
    return gd, ad


@pytest.fixture(scope="module", params=["basic", "canonical"])
def both(request):
    """(jax AnnotatedDbg, port AnnotatedDbg, records, queries)."""
    mode = request.param
    rng = np.random.default_rng(17)
    records = [random_dna(rng, int(rng.integers(40, 200))) for _ in range(30)]
    k = 13
    g = JDbg.from_boss(jbuild(records, k, mode=mode, bits_per_count=8),
                       DNA, mode)
    items = [(s, [f"L{i % 4}", f"R{i}"]) for i, s in enumerate(records)]
    ann = jeng.annotate_sequences(
        g, items, JColumnAnnotator(num_rows=g.num_nodes())).finalize()
    gd, ad = jax_state(g, ann)
    tg = dbg_from_numpy(gd, device="cpu")
    tann = annotation_from_numpy(ad, device="cpu")
    queries = []
    for i in range(60):
        s = records[i % len(records)]
        a = int(rng.integers(0, max(len(s) - 30, 1)))
        queries.append(s[a:a + int(rng.integers(5, 60))])
    queries += [random_dna(rng, 50), b"", b"ACGTNNNNACGTACGTAC",
                records[3] + records[4]]
    return (jeng.AnnotatedDbg(graph=g, annotation=ann),
            teng.AnnotatedDbg(graph=tg, annotation=tann), records, queries,
            items)


def test_state_carries_across(both):
    jadbg, tadbg, *_ = both
    jb, tb = jadbg.graph.boss, tadbg.graph.boss
    assert tadbg.graph.num_nodes() == jadbg.graph.num_nodes()
    assert tb.lut_steps == jb.lut_steps
    np.testing.assert_array_equal(tb.NF.numpy(), np.asarray(jb.NF))
    np.testing.assert_array_equal(tb.char_counts_W().numpy(),
                                  np.asarray(jb.char_counts_W()))


def test_map_to_nodes(both):
    jadbg, tadbg, records, queries, _ = both
    for s in records[:10] + queries[:20]:
        np.testing.assert_array_equal(tadbg.graph.map_to_nodes(s),
                                      jadbg.graph.map_to_nodes(s))


def test_label_count_matrix(both):
    jadbg, tadbg, _, queries, _ = both
    want = jeng.BatchQuery(jadbg).label_count_matrix(queries)
    got = teng.BatchQuery(tadbg).label_count_matrix(queries)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


RATIOS = [0.0, 1 / 3, 0.5, 0.7, 1.0]
BATCHES = ["mixed", "one", "none", "edge"]


def query_batch(both, kind, ratio):
    """The reads of a batch: ``mixed`` the fixture's queries (cut from the
    records, random, the empty read, reads shorter than k, one with N);
    ``one`` a one-read batch; ``none`` reads of which none passes (empty,
    shorter than k, random: no present window; past ratio 0 also one
    present window of 61); ``edge`` reads whose
    labels hold exactly min_count windows, and reads one window short:
    a piece of a record with a random tail, so that the piece's windows
    are the present ones."""
    _, tadbg, records, queries, _ = both
    k = tadbg.graph.k
    rng = np.random.default_rng(int(ratio * 1000) + 5)
    if kind == "mixed":
        return queries
    if kind == "one":
        return [queries[1]]
    if kind == "none":
        return [b"", records[0][:k - 1], random_dna(rng, 40),
                random_dna(rng, k)] + ([records[1][:k] + random_dna(rng, 60)]
                                       if ratio > 0 else [])
    long_records = [r for r in records if len(r) >= 60]
    reads = []
    for i, windows in enumerate((1, 7, 20, 31, 45)):
        need = max(1, math.ceil(ratio * windows))
        for present in (need, need - 1):
            if present < 1:
                continue
            rec = long_records[i % len(long_records)]
            reads.append(rec[:present + k - 1]
                         + random_dna(rng, windows - present))
    return reads


def jax_answers(jadbg, call, queries, *args):
    """The JAX package's ``<call>_batch`` answer, or its per-sequence
    ``<call>`` answers where no read of the batch has a present window
    (its batch call fails there, on an empty gather)."""
    jq = jeng.BatchQuery(jadbg)
    if (jq._map_batch(queries)[0] >= 0).any():
        return getattr(jq, call + "_batch")(queries, *args)
    return [getattr(jadbg, call)(s, *args) for s in queries]


@pytest.mark.parametrize("kind", BATCHES)
@pytest.mark.parametrize("ratio", RATIOS)
def test_get_labels_batch(both, ratio, kind):
    jadbg, tadbg, *_ = both
    queries = query_batch(both, kind, ratio)
    want = jax_answers(jadbg, "get_labels", queries, ratio)
    assert teng.BatchQuery(tadbg).get_labels_batch(queries, ratio) == want
    if kind == "none":
        assert not any(want)
    if kind == "edge":   # labels at exactly min_count pass
        counts, wpr, _ = jeng.BatchQuery(jadbg).label_count_matrix(queries)
        assert any(row.max() == max(1, math.ceil(ratio * w)) and labels
                   for row, w, labels in zip(counts, wpr, want))


@pytest.mark.parametrize("kind", BATCHES)
@pytest.mark.parametrize("top", [1, 3, 2 ** 62])
def test_get_top_labels_batch(both, top, kind):
    """The batch call and the per-sequence call; at ``top`` 1 and 3 the
    cut falls between labels of equal count (two labels a record)."""
    jadbg, tadbg, *_ = both
    for ratio in (0.3, 1.0):
        queries = query_batch(both, kind, ratio)
        want = jax_answers(jadbg, "get_top_labels", queries, top, ratio)
        assert (teng.BatchQuery(tadbg).get_top_labels_batch(queries, top,
                                                            ratio) == want)
        if kind == "mixed":     # the per-sequence calls of a few of them
            queries = queries[:6] + queries[-4:]
        for s in queries:
            assert (tadbg.get_top_labels(s, top, ratio)
                    == jadbg.get_top_labels(s, top, ratio)), s


@pytest.mark.parametrize("ratio", RATIOS)
def test_select_pairs_counts_the_answers(both, ratio):
    """``select_pairs`` grows by the labels of a batch's answers; the calls
    that copy the whole count matrix leave it as it was."""
    _, tadbg, _, queries, _ = both
    bq = teng.BatchQuery(tadbg)
    n0 = teng.select_pairs
    answers = bq.get_labels_batch(queries, ratio)
    assert teng.select_pairs - n0 == sum(map(len, answers)) > 0
    n0 = teng.select_pairs
    bq.label_count_matrix(queries)
    bq.get_top_labels_batch(queries, 2, ratio, with_kmer_counts=True)
    assert teng.select_pairs == n0


@pytest.mark.parametrize("with_counts", [False, True])
def test_annotate_sequences(both, with_counts):
    jadbg, tadbg, _, _, items = both
    jann = jeng.annotate_sequences(
        jadbg.graph, items, JColumnAnnotator(num_rows=jadbg.graph.num_nodes()),
        with_counts=with_counts).finalize()
    tann = teng.annotate_sequences(tadbg.graph, items,
                                   with_counts=with_counts).finalize()
    assert tann.encoder.labels == jann.encoder.labels
    for name in ("rows", "cols") + (("values",) if with_counts else ()):
        np.testing.assert_array_equal(
            getattr(tann.matrix, name).numpy(),
            np.asarray(getattr(jann.matrix, name)))


def test_row_sparse_from_coo():
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 50, 400).astype(np.int32)
    cols = rng.integers(0, 7, 400).astype(np.int32)
    vals = rng.integers(1, 9, 400).astype(np.int32)
    j = JRowSparse.from_coo(rows, cols, 50, 7, values=vals)
    t = TRowSparse.from_coo(rows, cols, 50, 7, values=vals, device="cpu")
    for name in ("rows", "cols", "values"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))
    q = np.array([0, 3, 3, 49, 12], np.int32)
    w = np.array([1, 2, 1, 5, 1], np.int32)
    np.testing.assert_array_equal(
        t.sum_rows(torch.from_numpy(q), torch.from_numpy(w)).numpy(),
        np.asarray(j.sum_rows(jnp.asarray(q), jnp.asarray(w))))


@pytest.mark.parametrize("n,density", [(1, 0.5), (31, 0.5), (1000, 0.01),
                                       (4097, 0.5), (3000, 0.99)])
def test_bit_rank(n, density):
    bits = np.random.default_rng(n).random(n) < density
    j = JBitRank.build(jnp.asarray(bits))
    t = BitRank.build(torch.from_numpy(bits))
    np.testing.assert_array_equal(t.words.numpy().view(np.uint32),
                                  np.asarray(j.words))
    np.testing.assert_array_equal(t.brank.numpy(), np.asarray(j.brank))
    assert int(t.total) == int(j.total)
    i = np.arange(-2, n + 2, dtype=np.int32)
    for name in ("rank1", "bit", "next1", "prev1"):
        np.testing.assert_array_equal(
            getattr(t, name)(torch.from_numpy(i)).numpy(),
            np.asarray(getattr(j, name)(jnp.asarray(i))))
    r = np.arange(1, int(j.total) + 1, dtype=np.int32)
    np.testing.assert_array_equal(t.select1(torch.from_numpy(r)).numpy(),
                                  np.asarray(j.select1(jnp.asarray(r))))


@pytest.mark.parametrize("n,sigma", [(1, 10), (127, 10), (1000, 10),
                                     (5000, 4)])
def test_symbol_rank(n, sigma):
    seq = np.random.default_rng(n + sigma).integers(0, sigma, n).astype(
        np.int8)
    j = JSymbolRank.build(jnp.asarray(seq), sigma)
    t = SymbolRank.build(torch.from_numpy(seq), sigma)
    np.testing.assert_array_equal(t.blocks.numpy(), np.asarray(j.blocks))
    np.testing.assert_array_equal(t.seq.numpy(), seq)
    i = np.tile(np.arange(-1, n + 1, dtype=np.int32), sigma)
    c = np.repeat(np.arange(sigma, dtype=np.int32), n + 2)
    np.testing.assert_array_equal(
        t.rank(torch.from_numpy(c), torch.from_numpy(i)).numpy(),
        np.asarray(j.rank(jnp.asarray(c), jnp.asarray(i))))
    # every occurrence of every symbol, in one batched select
    cs = np.concatenate([np.full(int((seq == s).sum()), s, np.int32)
                         for s in range(sigma)])
    r = np.concatenate([np.arange(1, int((seq == s).sum()) + 1,
                                  dtype=np.int32) for s in range(sigma)])
    np.testing.assert_array_equal(
        t.select(torch.from_numpy(cs), torch.from_numpy(r)).numpy(),
        np.asarray(j.select(jnp.asarray(cs), jnp.asarray(r))))
