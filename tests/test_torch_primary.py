"""The port's primary graphs and ``CanonicalDbg`` against the JAX package.

The graphs of ``tests/test_canonical.py`` (k = 9, three random reads)
are built in mode primary by each package (the port on the CPU); each
is wrapped in its package's ``CanonicalDbg``. Virtual node mapping,
adjacency, decoding, annotation rows, ``annotate_sequences`` and the
``BatchQuery`` labels must be identical. Integer data: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_dna
from metagraph_tpu.align.aligner import _revcomp
from metagraph_tpu.anno.annotator import ColumnAnnotator as JColumnAnnotator
from metagraph_tpu.engine import annotated_dbg as jeng
from metagraph_tpu.graph.boss_construct import build_boss as jbuild
from metagraph_tpu.graph.canonical import CanonicalDbg as JCanonicalDbg
from metagraph_tpu.graph.dbg_succinct import DbgSuccinct as JDbg
from metagraph_tpu.kmer.alphabets import DNA
from metagraph_tpu_torch.engine import annotated_dbg as teng
from metagraph_tpu_torch.graph import boss_construct as tbc
from metagraph_tpu_torch.graph.canonical import CanonicalDbg
from metagraph_tpu_torch.graph.dbg_succinct import DbgSuccinct

torch.set_num_threads(2)
K = 9


@pytest.fixture(scope="module")
def graphs():
    """(JAX wrapper, port wrapper, reads, queries)."""
    rng = np.random.default_rng(11)
    seqs = [random_dna(rng, 150) for _ in range(3)]
    jw = JCanonicalDbg(base=JDbg.from_boss(
        jbuild(seqs, K, mode="primary"), DNA, "primary"))
    tw = CanonicalDbg(base=DbgSuccinct.from_boss(
        tbc.build_boss(seqs, K, mode="primary", device="cpu"), tbc.DNA,
        "primary"))
    queries = [s[a:a + 40] for s in seqs for a in (0, 37, 100)]
    queries += [_revcomp(q) for q in queries]
    queries += [random_dna(rng, 60), b"ACGTNNACGTACGTT", b"ACG",
                seqs[0] + seqs[2]]
    return jw, tw, seqs, queries


def test_num_nodes(graphs):
    jw, tw, _, _ = graphs
    assert tw.num_nodes() == jw.num_nodes()
    assert tw.num_anno_rows() == jw.base.num_nodes()
    assert tw.mode == jw.mode == "canonical"


def test_map_to_nodes(graphs):
    jw, tw, seqs, queries = graphs
    for s in seqs + [_revcomp(s) for s in seqs] + queries:
        np.testing.assert_array_equal(tw.map_to_nodes(s), jw.map_to_nodes(s))


def test_adjacency_and_decode(graphs):
    jw, tw, _, _ = graphs
    nodes = np.arange(tw.num_nodes() + 1, dtype=np.int32)   # 0 included
    tn = torch.from_numpy(nodes.astype(np.int64))
    np.testing.assert_array_equal(tw.successors(tn).numpy(),
                                  np.asarray(jw.successors(jnp.asarray(nodes))))
    np.testing.assert_array_equal(
        tw.predecessors(tn).numpy(),
        np.asarray(jw.predecessors(jnp.asarray(nodes))))
    np.testing.assert_array_equal(tw.node_kmers_chars(nodes[1:]),
                                  jw.node_kmers_chars(nodes[1:]))
    np.testing.assert_array_equal(tw.node_to_anno_row(nodes[1:]),
                                  jw.node_to_anno_row(nodes[1:]))
    assert tw.node_sequence(5) == jw.node_sequence(5)


@pytest.fixture(scope="module")
def annotated(graphs):
    jw, tw, seqs, queries = graphs
    items = [(s, [f"L{i % 2}", f"R{i}"]) for i, s in enumerate(seqs)]
    items.append((_revcomp(seqs[1][20:90]), ["rc"]))
    jann = jeng.annotate_sequences(
        jw, items, JColumnAnnotator(num_rows=jw.base.num_nodes())).finalize()
    tann = teng.annotate_sequences(tw, items).finalize()
    return (jeng.AnnotatedDbg(graph=jw, annotation=jann),
            teng.AnnotatedDbg(graph=tw, annotation=tann), queries)


def test_annotate_sequences(annotated):
    jadbg, tadbg, _ = annotated
    jm, tm = jadbg.annotation.matrix, tadbg.annotation.matrix
    assert tadbg.annotation.encoder.labels == jadbg.annotation.encoder.labels
    assert tm.num_rows == jm.num_rows
    for name in ("rows", "cols"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)))


@pytest.mark.parametrize("ratio", [0.0, 0.7, 1.0])
def test_batch_query_labels(annotated, ratio):
    jadbg, tadbg, queries = annotated
    jq, tq = jeng.BatchQuery(jadbg), teng.BatchQuery(tadbg)
    assert (tq.get_labels_batch(queries, ratio)
            == jq.get_labels_batch(queries, ratio))
    assert (tq.get_top_labels_batch(queries, 2, ratio)
            == jq.get_top_labels_batch(queries, 2, ratio))
