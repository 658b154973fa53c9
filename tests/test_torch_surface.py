"""The rest of the port's query, stats and input surface against the JAX
package, function by function.

BOSS navigation (``get_W`` .. ``bwd``, ``num_dummy_edges``) on every row
of small basic, canonical and primary graphs; ``SymbolRank[i]``;
``RowSparse.presence`` / ``values_dense``; the ``--query-counts``,
``--print-signature`` and ``--count-quantiles`` executors of
``BatchQuery`` with and without count annotations;
``score_kmer_presence_mask`` on seeded masks; the FASTA writers, the
count-sidecar format both ways and the k-mers of a sidecar build. The port runs
on the CPU; inputs come from numpy seeds; integer data, so every
comparison is exact.
"""

import gzip
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_dna
from metagraph_tpu.align.aligner import _revcomp
from metagraph_tpu.anno.annotator import ColumnAnnotator as JColumnAnnotator
from metagraph_tpu.anno.annotator import LabelEncoder as JLabelEncoder
from metagraph_tpu.anno.matrix import RowSparse as JRowSparse
from metagraph_tpu.common.ranksel import SymbolRank as JSymbolRank
from metagraph_tpu.engine import annotated_dbg as jeng
from metagraph_tpu.graph.boss_construct import build_boss as jbuild
from metagraph_tpu.graph.canonical import CanonicalDbg as JCanonicalDbg
from metagraph_tpu.graph.dbg_succinct import DbgSuccinct as JDbg
from metagraph_tpu.kmer.alphabets import DNA
from metagraph_tpu.seqio import fasta as jfasta
from metagraph_tpu_torch.anno.annotator import LabelEncoder
from metagraph_tpu_torch.anno.matrix import RowSparse
from metagraph_tpu_torch.cli.main import sidecar_kmers
from metagraph_tpu_torch.common.ranksel import SymbolRank
from metagraph_tpu_torch.engine import annotated_dbg as teng
from metagraph_tpu_torch.graph import boss_construct as tbc
from metagraph_tpu_torch.graph.canonical import CanonicalDbg
from metagraph_tpu_torch.graph.dbg_succinct import DbgSuccinct
from metagraph_tpu_torch.seqio import fasta as tfasta

torch.set_num_threads(2)
K = 11


def jt(x):
    return jnp.asarray(np.asarray(x))


def tt(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ---------------------------------------------------------------------------
# BOSS navigation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["basic", "canonical", "primary"])
def boss_pair(request):
    rng = np.random.default_rng(31)
    seqs = [random_dna(rng, int(rng.integers(30, 160))) for _ in range(8)]
    seqs.append(b"ACGTACGTAC" * 4)                       # repeats, cycles
    mode = request.param
    jb = jbuild(seqs, K, mode=mode, bits_per_count=8)
    tb = tbc.build_boss(seqs, K, mode=mode, bits_per_count=8, device="cpu")
    return jb, tb


def test_boss_point_queries(boss_pair):
    jb, tb = boss_pair
    m = jb.num_edges
    assert tb.num_edges == m
    i = np.arange(0, m + 1, dtype=np.int32)
    for name in ("get_W", "rank_last", "get_node_last_value"):
        same(getattr(tb, name)(tt(i)), getattr(jb, name)(jt(i)))
    r = np.arange(1, int(jb.num_nodes()) + 1, dtype=np.int32)
    same(tb.select_last(tt(r)), jb.select_last(jt(r)))
    same(tb.num_dummy_edges(), jb.num_dummy_edges())


def test_boss_W_rank_select(boss_pair):
    jb, tb = boss_pair
    m = jb.num_edges
    sigma = 2 * jb.alph_size
    i = np.tile(np.arange(0, m + 1, dtype=np.int32), sigma)
    c = np.repeat(np.arange(sigma, dtype=np.int32), m + 1)
    same(tb.rank_W(tt(i), tt(c)), jb.rank_W(jt(i), jt(c)))
    # every occurrence of every symbol in W[1..m]
    totals = np.asarray(jb.rank_W(jnp.full(sigma, m, jnp.int32),
                                  jnp.arange(sigma, dtype=jnp.int32)))
    cs = np.repeat(np.arange(sigma, dtype=np.int32), totals)
    rs = np.concatenate([np.arange(1, t + 1, dtype=np.int32) for t in totals])
    same(tb.select_W(tt(rs), tt(cs)), jb.select_W(jt(rs), jt(cs)))


def test_boss_fwd_bwd(boss_pair):
    jb, tb = boss_pair
    m = jb.num_edges
    rows = np.arange(1, m + 1, dtype=np.int32)
    same(tb.bwd(tt(rows)), jb.bwd(jt(rows)))
    W = np.asarray(jb.W)[1:]
    real = (W % jb.alph_size) != 0
    i = rows[real]
    c = (W[real] % jb.alph_size).astype(np.int32)
    tgt = tb.fwd(tt(i), tt(c))
    same(tgt, jb.fwd(jt(i), jt(c)))
    # the target's source node ends in the edge's label
    same(tb.get_node_last_value(tgt), c)


# ---------------------------------------------------------------------------
# SymbolRank point access
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 130, 999])
def test_symbol_rank_getitem(n):
    seq = np.random.default_rng(n).integers(0, 10, n).astype(np.int8)
    j = JSymbolRank.build(jnp.asarray(seq), 10)
    t = SymbolRank.build(torch.from_numpy(seq), 10)
    i = np.arange(n, dtype=np.int32)
    got = t[tt(i)]
    assert got.dtype == torch.int32
    same(got, j[jt(i)])
    same(got, seq)


# ---------------------------------------------------------------------------
# annotation matrix and label dictionary
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_values", [False, True])
def test_row_sparse_row_queries(with_values):
    rng = np.random.default_rng(8)
    rows = rng.integers(0, 60, 500).astype(np.int32)
    cols = rng.integers(0, 9, 500).astype(np.int32)
    vals = rng.integers(1, 40, 500).astype(np.int32) if with_values else None
    j = JRowSparse.from_coo(rows, cols, 70, 9, values=vals)
    t = RowSparse.from_coo(rows, cols, 70, 9, values=vals, device="cpu")
    q = np.array([0, 5, 5, 59, 65, 12, 0], np.int32)   # repeats, empty row
    same(t.presence(tt(q)), j.presence(jt(q)))
    same(t.presence(tt(q[:0])), np.zeros((0, 9), bool))
    if with_values:
        same(t.values_dense(tt(q)), j.values_dense(jt(q)))
    else:
        with pytest.raises(ValueError):
            t.values_dense(tt(q))


def test_label_encoder_and_representation():
    labels = ["b", "a", "c", "a"]
    j, t = JLabelEncoder(labels), LabelEncoder(labels)
    assert len(t) == len(j) == 3
    assert t.labels == j.labels
    assert [t.decode(i) for i in range(3)] == [j.decode(i) for i in range(3)]
    t_ann = teng.annotate_sequences(
        DbgSuccinct.from_boss(tbc.build_boss([b"ACGTACGTTA"], 5,
                                             device="cpu")),
        [(b"ACGTACGTTA", ["x"])]).finalize()
    assert t_ann.representation == "rowsparse"


# ---------------------------------------------------------------------------
# the count, signature and quantile query executors
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[("basic", False), ("basic", True),
                                        ("canonical", True),
                                        ("primary", False),
                                        ("primary", True)],
                ids=lambda p: f"{p[0]}-{'values' if p[1] else 'binary'}")
def adbgs(request):
    mode, with_counts = request.param
    rng = np.random.default_rng(41)
    records = [random_dna(rng, int(rng.integers(30, 150))) for _ in range(20)]
    records += records[:4]                            # repeated: counts > 1
    items = [(s, [f"L{i % 3}", f"R{i % 7}"]) for i, s in enumerate(records)]
    jg = JDbg.from_boss(jbuild(records, K, mode=mode), DNA, mode)
    tg = DbgSuccinct.from_boss(tbc.build_boss(records, K, mode=mode,
                                              device="cpu"), tbc.DNA, mode)
    if mode == "primary":
        jg, tg = JCanonicalDbg(base=jg), CanonicalDbg(base=tg)
        rows = jg.base.num_nodes()
    else:
        rows = jg.num_nodes()
    jann = jeng.annotate_sequences(jg, items, JColumnAnnotator(num_rows=rows),
                                   with_counts=with_counts).finalize()
    tann = teng.annotate_sequences(tg, items,
                                   with_counts=with_counts).finalize()
    queries = []
    for i in range(40):
        s = records[i % len(records)]
        a = int(rng.integers(0, max(len(s) - 20, 1)))
        queries.append(s[a:a + int(rng.integers(6, 70))])
    queries += [_revcomp(q) for q in queries[:10]]
    queries += [random_dna(rng, 40), b"", b"ACGTNNNNACGTACGTAC",
                records[1] + records[2], records[0] + b"N" + records[3]]
    return (jeng.BatchQuery(jeng.AnnotatedDbg(graph=jg, annotation=jann)),
            teng.BatchQuery(teng.AnnotatedDbg(graph=tg, annotation=tann)),
            queries)


@pytest.mark.parametrize("top,ratio", [(2 ** 62, 0.0), (2, 0.5), (1, 1.0)])
def test_query_counts_batch(adbgs, top, ratio):
    jq, tq, queries = adbgs
    assert (tq.get_top_labels_batch(queries, top, ratio,
                                    with_kmer_counts=True)
            == jq.get_top_labels_batch(queries, top, ratio,
                                       with_kmer_counts=True))


@pytest.mark.parametrize("top,ratio", [(2 ** 62, 0.0), (2, 0.6)])
def test_signatures_batch(adbgs, top, ratio):
    jq, tq, queries = adbgs
    got = tq.get_top_label_signatures_batch(queries, top, ratio)
    want = jq.get_top_label_signatures_batch(queries, top, ratio)
    assert [[label for label, _ in r] for r in got] == \
        [[label for label, _ in r] for r in want]
    for g, w in zip(got, want):
        for (_, gm), (_, wm) in zip(g, w):
            same(gm, wm)
            assert (tq.adbg.score_kmer_presence_mask(gm)
                    == jq.adbg.score_kmer_presence_mask(wm))


@pytest.mark.parametrize("qs,top,ratio", [((0.0, 0.5, 1.0), 2 ** 62, 0.0),
                                          ((0.1, 0.33, 0.9), 2, 0.4),
                                          ((), 1, 0.0)])
def test_count_quantiles_batch(adbgs, qs, top, ratio):
    jq, tq, queries = adbgs
    assert (tq.get_label_count_quantiles_batch(queries, top, ratio, qs)
            == jq.get_label_count_quantiles_batch(queries, top, ratio, qs))


# ---------------------------------------------------------------------------
# score_kmer_presence_mask
# ---------------------------------------------------------------------------

def _masks():
    rng = np.random.default_rng(5)
    out = [("empty", np.zeros(0, bool))]
    for n in (1, 2, 3, 4, 40, 250):
        out += [(f"ones{n}", np.ones(n, bool)),
                (f"zeros{n}", np.zeros(n, bool))]
    for n, p in ((5, 0.5), (30, 0.8), (90, 0.95), (90, 0.3), (400, 0.99),
                 (400, 0.6)):
        out.append((f"random{n}_{p}", rng.random(n) < p))
    return out


@pytest.mark.parametrize("k", [11, 31])
@pytest.mark.parametrize("name,mask", _masks(), ids=[m[0] for m in _masks()])
def test_score_kmer_presence_mask(k, name, mask):
    g = SimpleNamespace(k=k)
    want = jeng.AnnotatedDbg(graph=g, annotation=None)
    got = teng.AnnotatedDbg(graph=g, annotation=None)
    if mask.size == 1:
        # a fault of the reference, matched: its autocorrelation pads a
        # one-window mask to two windows and fails
        for adbg in (want, got):
            with pytest.raises(ValueError):
                adbg.score_kmer_presence_mask(mask)
        return
    for match, mismatch in ((1, 2), (2, 3)):
        assert (got.score_kmer_presence_mask(mask, match, mismatch)
                == want.score_kmer_presence_mask(mask, match, mismatch))


# ---------------------------------------------------------------------------
# FASTA writers and count sidecars
# ---------------------------------------------------------------------------

def _weighted_records():
    rng = np.random.default_rng(9)
    recs = []
    for n in (11, 12, 40, 200):
        s = random_dna(rng, n)
        recs.append((s, rng.integers(1, 1 << 32, n - 9, dtype=np.uint64)))
    recs.append((b"ACGTNACGTACGTTT", np.arange(1, 7)))
    return recs


@pytest.mark.parametrize("writer_pkg", ["port", "jax"])
def test_sidecar_round_trip(tmp_path, writer_pkg):
    writer = (tfasta if writer_pkg == "port" else jfasta).ExtendedFastaWriter
    recs = _weighted_records()
    with writer(str(tmp_path / "c.fasta.gz"), 10, header="ctg") as w:
        for s, c in recs:
            w.write(s, c)
        w.write(b"ACGTACGTACGT")                        # counts default 1
    fa = str(tmp_path / "c.fasta.gz")
    side = str(tmp_path / "c.kmer_counts.gz")
    assert tfasta.kmer_counts_sidecar(fa) == jfasta.kmer_counts_sidecar(fa) \
        == side
    got = list(tfasta.iter_weighted_records(fa))
    want = list(jfasta.iter_weighted_records(fa))
    assert len(got) == len(want) == len(recs) + 1
    for (gr, gc), (wr, wc) in zip(got, want):
        assert (gr.name, gr.seq) == (wr.name, wr.seq)
        assert gc.dtype == wc.dtype == np.uint32
        same(gc, wc)
    for (_, gc), (_, c) in zip(got, recs):
        same(gc, c)


def test_sidecar_files_identical(tmp_path):
    recs = _weighted_records()
    for pkg, base in ((tfasta, "t"), (jfasta, "j")):
        with pkg.ExtendedFastaWriter(str(tmp_path / base), 10) as w:
            for s, c in recs:
                w.write(s, c)
    for suf in (".fasta.gz", ".kmer_counts.gz"):
        assert gzip.decompress((tmp_path / f"t{suf}").read_bytes()) == \
            gzip.decompress((tmp_path / f"j{suf}").read_bytes())
    assert tfasta.kmer_counts_sidecar(str(tmp_path / "none.fa")) is None


@pytest.mark.parametrize("name,kw", [
    ("p.fa", {}), ("p.fa.gz", {}),
    ("q.fa", dict(header="x", width=7, enumerate_sequences=False))])
def test_fasta_writer_identical(tmp_path, name, kw):
    rng = np.random.default_rng(2)
    seqs = [random_dna(rng, n) for n in (0, 1, 7, 80, 81, 300)]
    for pkg, d in ((tfasta, "t"), (jfasta, "j")):
        (tmp_path / d).mkdir()
        with pkg.FastaWriter(str(tmp_path / d / name), **kw) as w:
            for i, s in enumerate(seqs):
                w.write(s.decode() if i % 2 else s,
                        name="named" if i == 3 else None)
    got = (tmp_path / "t" / name).read_bytes()
    want = (tmp_path / "j" / name).read_bytes()
    if name.endswith(".gz"):
        got, want = gzip.decompress(got), gzip.decompress(want)
    assert got == want
    assert [r.seq for r in tfasta.parse_records(str(tmp_path / "t" / name))] \
        == [s for s in seqs]


@pytest.mark.parametrize("k", [5, 10, 21, 31])
def test_sidecar_kmers(tmp_path, k):
    """The windows and counts a sidecar build collects: every k-window of
    every record with its count, those holding a non-ACGT byte dropped,
    records shorter than k skipped; against a plain loop."""
    rng = np.random.default_rng(k)
    seqs = [random_dna(rng, n) for n in (k - 1, k, k + 6, 150)]
    seqs.append(random_dna(rng, k + 3) + b"N" + random_dna(rng, k + 2))
    recs = [(s, rng.integers(1, 1000, max(len(s) - k + 1, 0)))
            for s in seqs]
    with jfasta.ExtendedFastaWriter(str(tmp_path / "c"), k) as w:
        for s, c in recs:
            w.write(s, c)
    chars, counts = sidecar_kmers([str(tmp_path / "c.fasta.gz")], k, tbc.DNA)
    want_chars, want_counts = [], []
    for s, c in recs:
        for j in range(len(s) - k + 1):
            if all(ch in b"ACGT" for ch in s[j:j + k]):
                want_chars.append([b"ACGT".index(ch) + 1 for ch in s[j:j + k]])
                want_counts.append(c[j])
    assert chars.dtype == np.uint8 and counts.dtype == np.uint32
    same(chars, np.array(want_chars, np.uint8).reshape(-1, k))
    same(counts, np.array(want_counts, np.uint32))
