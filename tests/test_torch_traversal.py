"""The port's graph algorithms against the JAX package's, on the CPU.

Unitig decomposition (cycles included), unitig and contig sequences and
paths (order included) on basic, canonical, primary (``CanonicalDbg``)
and small-state graphs and on ``MaskedDbg``; ``single_form_mask``,
``unitig_keep_mask``, the cleaning functions (``node_weights``, the
histogram, ``pick_kmer_threshold``, ``clean_node_mask``), both
differential-assembly masks, and the helpers they call
(``BitRank.set_positions``, ``LabelEncoder.encode`` / ``in``). Every
graph is built by the JAX package and loaded by the port from its file,
so both run on the same arrays; inputs are seeded with numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_dna
from metagraph_tpu.anno.annotator import ColumnAnnotator as JAnnotator
from metagraph_tpu.common.ranksel import BitRank as JBitRank
from metagraph_tpu.engine import diff_assembly as jdiff
from metagraph_tpu.engine.annotated_dbg import AnnotatedDbg as JAdbg
from metagraph_tpu.graph import cleaning as jclean
from metagraph_tpu.graph import io as jio
from metagraph_tpu.graph import traversal as jt
from metagraph_tpu.graph.boss_construct import build_boss as jbuild
from metagraph_tpu.graph.canonical import CanonicalDbg as JCanon
from metagraph_tpu.graph.dbg_succinct import DbgSuccinct as JDbg
from metagraph_tpu.graph.masked import MaskedDbg as JMasked
from metagraph_tpu.kmer.alphabets import DNA as JDNA
from metagraph_tpu_torch.anno.annotator import LabelEncoder, annotation_from_numpy
from metagraph_tpu_torch.common.ranksel import BitRank
from metagraph_tpu_torch.engine import diff_assembly as tdiff
from metagraph_tpu_torch.engine.annotated_dbg import AnnotatedDbg as TAdbg
from metagraph_tpu_torch.graph import cleaning as tclean
from metagraph_tpu_torch.graph import io as tio
from metagraph_tpu_torch.graph import traversal as tt
from metagraph_tpu_torch.graph.canonical import CanonicalDbg as TCanon
from metagraph_tpu_torch.graph.masked import MaskedDbg as TMasked

torch.set_num_threads(2)
SUBS = {65: b"CGT", 67: b"AGT", 71: b"ACT", 84: b"ACG"}
COMP = bytes.maketrans(b"ACGT", b"TGCA")


def error_reads(rng, genome: bytes, n: int, rl: int, err: float):
    """Reads of ``genome`` from both strands with uniform substitutions."""
    out = []
    for _ in range(n):
        o = int(rng.integers(0, len(genome) - rl + 1))
        r = bytearray(genome[o:o + rl])
        if rng.random() < 0.5:
            r = bytearray(bytes(r).translate(COMP)[::-1])
        for j in np.nonzero(rng.random(rl) < err)[0]:
            r[j] = SUBS[r[j]][int(rng.integers(0, 3))]
        out.append(bytes(r))
    return out


def build_pair(tmp, name, seqs, k, mode, bits=0, state="fast"):
    """(JAX graph, port graph) of the same file, the port's on the CPU;
    primary graphs come wrapped in each package's CanonicalDbg."""
    jg = JDbg.from_boss(jbuild(seqs, k, mode=mode, bits_per_count=bits),
                        JDNA, mode)
    path = str(tmp / name)
    jio.save_graph(path, jg, state=state)
    jg = jio.load_graph(path)
    tg = tio.load_graph(path, device="cpu")
    if mode == "primary":
        return JCanon(base=jg), TCanon(base=tg)
    return jg, tg


def case_seqs(name):
    rng = np.random.default_rng(11)
    if name == "cycle":
        return [b"ACGTTGCA" * 2], 4
    if name == "repeats":
        core = random_dna(rng, 60)
        return [random_dna(rng, 40) + core + random_dna(rng, 30) + core
                + random_dna(rng, 50) for _ in range(3)], 7
    return [random_dna(rng, int(rng.integers(60, 240))) for _ in range(6)], 9


GRAPHS = [("basic", "random"), ("basic", "cycle"), ("basic", "repeats"),
          ("canonical", "random"), ("canonical", "repeats"),
          ("primary", "random"), ("small", "repeats")]


@pytest.fixture(scope="module", params=GRAPHS, ids=lambda p: "-".join(p))
def pair(request, tmp_path_factory):
    mode, data = request.param
    seqs, k = case_seqs(data)
    tmp = tmp_path_factory.mktemp("trav")
    if mode == "small":
        return build_pair(tmp, "g", seqs, k, "basic", state="small")
    return build_pair(tmp, "g", seqs, k, mode)


def same_paths(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_unitig_decomposition(pair):
    jg, tg = pair
    ju, tu = jt.unitig_decomposition(jg), tt.unitig_decomposition(tg)
    for f in ("chain_id", "pos", "starts", "lengths", "is_cycle"):
        np.testing.assert_array_equal(getattr(tu, f).numpy(),
                                      np.asarray(getattr(ju, f)), err_msg=f)
    np.testing.assert_array_equal(tt.unitig_ends(tg, tu).numpy(),
                                  jt.unitig_ends(jg, ju))
    same_paths(tt.unitig_paths(tg, tu), jt.unitig_paths(jg, ju))


def test_unitigs_cycle_broken_at_minimum(tmp_path):
    """A pure cycle is one chain starting at its minimum node id, so the
    strings do not rotate (the JAX package's tests/test_traversal.py
    test_unitigs_cycle)."""
    jg, tg = build_pair(tmp_path, "c", [b"ACGTTGCA" * 2], 4, "basic")
    tu = tt.unitig_decomposition(tg)
    assert tu.num_unitigs == 1 and bool(tu.is_cycle[0])
    assert int(tu.starts[0]) == 1
    assert tt.unitig_sequences(tg, tu) == jt.unitig_sequences(jg)


@pytest.mark.parametrize("min_length", [0, 12, 30])
def test_unitig_sequences(pair, min_length):
    jg, tg = pair
    js, jp = jt.unitig_sequences(jg, min_length=min_length, return_paths=True)
    ts, tp = tt.unitig_sequences(tg, min_length=min_length, return_paths=True)
    assert ts == js
    same_paths(tp, jp)


def test_contig_sequences(pair):
    jg, tg = pair
    js, jp = jt.contig_sequences(jg, return_paths=True)
    ts, tp = tt.contig_sequences(tg, return_paths=True)
    assert ts == js
    same_paths(tp, jp)
    # every node once
    assert sorted(np.concatenate(tp).tolist()) == list(
        range(1, tg.num_nodes() + 1))


@pytest.mark.parametrize("frac", [0.3, 0.8])
def test_masked_graph(pair, frac):
    jg, tg = pair
    rng = np.random.default_rng(int(frac * 10))
    mask = rng.random(jg.num_nodes() + 1) < frac
    mask[0] = False
    jm, tm = JMasked(base=jg, mask=mask), TMasked(base=tg, mask=mask)
    assert tm.num_masked_nodes() == jm.num_masked_nodes()
    nodes = np.arange(1, jg.num_nodes() + 1, dtype=np.int32)
    for fn in ("successors", "predecessors", "outdegree", "indegree"):
        want = np.asarray(getattr(jm, fn)(jnp.asarray(nodes)))
        got = getattr(tm, fn)(torch.from_numpy(nodes.astype(np.int64)))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=fn)
    js, jp = jt.unitig_sequences(jm, return_paths=True)
    ts, tp = tt.unitig_sequences(tm, return_paths=True)
    assert ts == js
    same_paths(tp, jp)
    js, jp = jt.contig_sequences(jm, return_paths=True)
    ts, tp = tt.contig_sequences(tm, return_paths=True)
    assert ts == js
    same_paths(tp, jp)
    keep = rng.random(tt.unitig_decomposition(tm).num_unitigs) < 0.5
    assert tt.unitig_sequences(tm, keep=keep) == \
        jt.unitig_sequences(jm, keep=keep)


def test_masked_map_to_nodes(tmp_path):
    seqs, k = case_seqs("random")
    jg, tg = build_pair(tmp_path, "m", seqs, k, "canonical")
    mask = np.random.default_rng(4).random(jg.num_nodes() + 1) < 0.5
    jm, tm = JMasked(base=jg, mask=mask), TMasked(base=tg, mask=mask)
    for s in seqs[:3]:
        np.testing.assert_array_equal(tm.map_to_nodes(s), jm.map_to_nodes(s))


def test_small_state_equals_fast(tmp_path):
    """Small-state traversal (navigation adjacency, bwd-walk decode)
    gives the fast state's unitigs and contigs (the JAX package's
    tests/test_ranksel.py test_small_state_traversal_parity)."""
    seqs, k = case_seqs("repeats")
    _, fast = build_pair(tmp_path, "f", seqs, k, "basic")
    _, small = build_pair(tmp_path, "s", seqs, k, "basic", state="small")
    assert small.boss.edge_lanes is None
    assert tt.unitig_sequences(small) == tt.unitig_sequences(fast)
    assert tt.contig_sequences(small) == tt.contig_sequences(fast)


@pytest.fixture(scope="module")
def weighted(tmp_path_factory):
    """Weighted canonical and basic graphs of error reads of a genome."""
    rng = np.random.default_rng(5)
    genome = random_dna(rng, 500)
    reads = error_reads(rng, genome, 400, 40, 0.01)
    tmp = tmp_path_factory.mktemp("w")
    return {mode: build_pair(tmp, mode, reads, 11, mode, bits=8)
            for mode in ("canonical", "basic")}


@pytest.mark.parametrize("mode", ["canonical", "basic"])
def test_single_form_and_weights(weighted, mode):
    jg, tg = weighted[mode]
    np.testing.assert_array_equal(tt.single_form_mask(tg).numpy(),
                                  jt.single_form_mask(jg))
    np.testing.assert_array_equal(tclean.node_weights(tg).numpy(),
                                  jclean.node_weights(jg))
    np.testing.assert_array_equal(tclean.node_weight_histogram(tg),
                                  jclean.node_weight_histogram(jg))
    for singletons in (0, 50):
        assert tclean.estimate_min_kmer_abundance(tg, singletons) == \
            jclean.estimate_min_kmer_abundance(jg, singletons)


@pytest.mark.parametrize("tip,mma", [(1, 1), (22, 1), (1, 3), (12, 4)])
def test_unitig_keep_mask(weighted, tip, mma):
    jg, tg = weighted["canonical"]
    ju, tu = jt.unitig_decomposition(jg), tt.unitig_decomposition(tg)
    w = jclean.node_weights(jg)
    np.testing.assert_array_equal(
        tt.unitig_keep_mask(tg, tu, tip, w, mma).numpy(),
        jt.unitig_keep_mask(jg, ju, tip, w, mma))


CLEAN = [dict(min_count=2), dict(max_count=6),
         dict(min_count=2, max_count=20, prune_unitigs=3),
         dict(prune_unitigs=4), dict(min_tip_size=22),
         dict(min_count=2, min_tip_size=22, prune_unitigs=3)]


@pytest.mark.parametrize("mode", ["canonical", "basic"])
@pytest.mark.parametrize("kw", CLEAN, ids=lambda kw: "-".join(
    f"{a}{b}" for a, b in kw.items()))
def test_clean_node_mask(weighted, mode, kw):
    jg, tg = weighted[mode]
    np.testing.assert_array_equal(tclean.clean_node_mask(tg, **kw).numpy(),
                                  jclean.clean_node_mask(jg, **kw))


def test_pick_kmer_threshold():
    """The histogram of the JAX package's tests/test_traversal.py
    test_pick_kmer_threshold_histogram, a degenerate one, a failing one
    (no count-2 bin) and a seeded error + signal mixture."""
    hist = np.zeros(64, np.float64)
    hist[1], hist[2], hist[3], hist[4] = 100000, 20000, 5000, 1000
    for c in range(20, 45):
        hist[c] = 5000 * np.exp(-((c - 30) ** 2) / 30)
    flat = np.zeros(10, np.uint64)
    flat[1] = 5
    no2 = np.zeros(10, np.uint64)
    no2[1], no2[3] = 7, 9
    rng = np.random.default_rng(3)
    mix = np.bincount(np.concatenate([
        rng.poisson(1.2, 20000) + 1, rng.poisson(25, 5000)]),
        minlength=80).astype(np.uint64)
    mix[0] = 0
    for h in (hist.astype(np.uint64), flat, no2, mix, hist[:6]):
        assert tclean.pick_kmer_threshold(h) == jclean.pick_kmer_threshold(h)
    assert tclean.pick_kmer_threshold(no2) == -1
    for pw, t in ((np.array([1, 1, 5, 9]), 3), (np.array([1, 5, 9]), 3),
                  (np.array([1, 1]), 1)):
        assert tclean.is_unreliable_unitig(pw, t) == \
            jclean.is_unreliable_unitig(pw, t)


@pytest.fixture(scope="module")
def annotated(tmp_path_factory):
    """A canonical graph of 12 records with labels rec{i}, g{i % 3} and
    'all', annotated by the JAX package; the port's copy of both."""
    rng = np.random.default_rng(8)
    core = random_dna(rng, 50)
    seqs = [random_dna(rng, 40) + (core if i % 4 == 0 else b"")
            + random_dna(rng, int(rng.integers(30, 90))) for i in range(12)]
    jg, tg = build_pair(tmp_path_factory.mktemp("a"), "g", seqs, 9,
                        "canonical")
    ann = JAnnotator(jg.num_nodes())
    for i, s in enumerate(seqs):
        rows = np.asarray(jg.map_to_nodes(s))
        rows = np.unique(rows[rows > 0]) - 1
        for label in (f"rec{i}", f"g{i % 3}", "all"):
            ann.add(rows, label)
    jann = ann.finalize()
    d = dict(rows=np.asarray(jann.matrix.rows),
             cols=np.asarray(jann.matrix.cols),
             shape=np.array([jann.matrix.num_rows, jann.matrix.num_cols]),
             labels=np.array(jann.encoder.labels))
    return (JAdbg(graph=jg, annotation=jann),
            TAdbg(graph=tg, annotation=annotation_from_numpy(d, "cpu")))


MASKS = [(["rec0"], [], {}), (["g0"], ["g1"], {}),
         (["g0", "rec4"], ["rec0", "absent"],
          dict(label_mask_in_fraction=0.5)),
         (["all"], ["g2"], dict(label_mask_out_fraction=0.5)),
         (["g1"], [], dict(label_other_fraction=0.4))]


@pytest.mark.parametrize("lin,lout,fr", MASKS)
def test_diff_assembly_masks(annotated, lin, lout, fr):
    ja, ta = annotated
    np.testing.assert_array_equal(
        tdiff.mask_nodes_by_unitig_labels(ta, lin, lout, **fr).numpy(),
        jdiff.mask_nodes_by_unitig_labels(ja, lin, lout, **fr))
    fr_node = {a: b for a, b in fr.items() if a != "label_other_fraction"}
    np.testing.assert_array_equal(
        tdiff.mask_nodes_by_node_label(ta, lin, lout, **fr_node).numpy(),
        jdiff.mask_nodes_by_node_label(ja, lin, lout, **fr_node))
    for unitig_mode, f in ((True, fr), (False, fr_node)):
        jm = jdiff.differential_assembly(ja, lin, lout, unitig_mode, **f)
        tm = tdiff.differential_assembly(ta, lin, lout, unitig_mode, **f)
        assert tt.unitig_sequences(tm) == jt.unitig_sequences(jm)
        assert tt.contig_sequences(tm) == jt.contig_sequences(jm)


def test_diff_assembly_group_counts(annotated):
    ja, ta = annotated
    enc = ta.annotation.encoder
    cin, cout = [enc.encode("g0")], [enc.encode("rec1")]
    for got, want in zip(tdiff._per_node_group_counts(ta, cin, cout),
                         jdiff._per_node_group_counts(ja, cin, cout)):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,p", [(1, 0.5), (31, 0.3), (32, 0.9), (33, 0.0),
                                 (1000, 0.5), (4097, 0.01)])
def test_bit_rank_set_positions(n, p):
    bits = np.random.default_rng(n).random(n) < p
    got = BitRank.build(torch.from_numpy(bits)).set_positions()
    want = JBitRank.build(jnp.asarray(bits)).set_positions()
    np.testing.assert_array_equal(got.numpy(), want)


def test_label_encoder_encode_contains():
    enc = LabelEncoder(["b", "a", "c", "a"])
    assert [enc.encode(x) for x in "abc"] == [1, 0, 2]
    assert "a" in enc and "z" not in enc
    with pytest.raises(KeyError):
        enc.encode("z")
