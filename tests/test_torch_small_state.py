"""Small-state graphs (no edge k-mers: every search by rank/select on W,
last and F) in the port, against the fast state and the JAX package's
small state, on the CPU.

Mirrors the JAX package's tests/test_ranksel.py (small-state query,
search against the lane search, traversal) and tests/test_align.py
(small-state alignment, suffix ranges): ``index_edge_ranksel`` and
``suffix_range_ranksel`` against the lane search, absent probes
included; ``map_read_batch`` against fast-state mapping; adjacency and
decoding; ``pred_last``; query and align identical to the fast state and
to the JAX small state; small ``.dbg.npz`` files written by either
package loading in the other; and the entry points that default to the
card.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_dna
from metagraph_tpu.align import aligner as jal
from metagraph_tpu.cli.main import main as jmain
from metagraph_tpu.graph import io as jio
from metagraph_tpu.graph.boss_construct import build_boss as jbuild
from metagraph_tpu.graph.dbg_succinct import DbgSuccinct as JDbg
from metagraph_tpu.kmer.alphabets import DNA as JDNA
from metagraph_tpu_torch.align import aligner as tal
from metagraph_tpu_torch.cli.main import main as tmain
from metagraph_tpu_torch.graph import io as tio
from metagraph_tpu_torch.kmer import packing

torch.set_num_threads(2)
SUBS = {65: 67, 67: 65, 71: 84, 84: 71}


@pytest.fixture(scope="module", params=["basic", "canonical"])
def graphs(request, tmp_path_factory):
    """(JAX small, port fast, port small, ref, other) of one k = 15 graph,
    the port's loaded from the JAX package's files."""
    tmp = tmp_path_factory.mktemp("small")
    rng = np.random.default_rng(7)
    ref = random_dna(rng, 400)
    other = random_dna(rng, 100)
    jg = JDbg.from_boss(jbuild([ref], 15, mode=request.param), JDNA,
                        request.param)
    jio.save_graph(str(tmp / "f"), jg)
    jio.save_graph(str(tmp / "s"), jg, state="small")
    js = jio.load_graph(str(tmp / "s"))
    tf = tio.load_graph(str(tmp / "f"), device="cpu")
    ts = tio.load_graph(str(tmp / "s"), device="cpu")
    assert js.boss.edge_lanes is None and ts.boss.edge_lanes is None
    return js, tf, ts, ref, other


def edge_chars(boss):
    return packing.unpack_to_chars(boss.edge_lanes, boss.K,
                                   boss.bits_per_char).to(torch.int64)


def test_index_edge_ranksel_vs_lanes(graphs):
    js, tf, ts, _, _ = graphs
    chars = edge_chars(tf.boss)
    real = (chars > 0).all(dim=1)
    via_lanes = tf.boss.map_to_edges(tf.boss.edge_lanes)
    via_rank = ts.boss.index_edge_ranksel(chars)
    assert torch.equal(via_rank[real], via_lanes[real])
    # absent probes (and the sentinel, which no real k-mer holds)
    rng = np.random.default_rng(2)
    probe = rng.integers(0, 5, (200, tf.boss.K))
    probe[:5] = chars[real][:5].numpy()
    lanes = packing.pack_from_chars(torch.from_numpy(probe.astype(np.uint8)),
                                    tf.boss.K, 4)
    got = ts.boss.index_edge_ranksel(torch.from_numpy(probe))
    assert torch.equal(got, tf.boss.map_to_edges(lanes) * torch.from_numpy(
        (probe > 0).all(axis=1)))
    assert torch.equal(ts.boss.map_to_edges(lanes), got)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(js.boss.index_edge_ranksel(
            jnp.asarray(probe.astype(np.int32)))))


def test_suffix_range_ranksel_vs_lanes(graphs):
    """The rank/select range of each node suffix equals the lane search's
    and the JAX package's (one pattern a call there), for suffixes of the
    graph and absent ones."""
    js, tf, ts, ref, _ = graphs
    K = tf.k
    tbl = tf.alphabet.encode_table()
    codes = tbl[np.frombuffer(ref, np.uint8)].astype(np.int64)
    rng = np.random.default_rng(3)
    for s in (1, 2, 5, 9, K - 1):
        pos = rng.integers(0, len(ref) - K, 12)
        pat = np.stack([codes[p:p + s] for p in pos])
        pat[-3:] = rng.integers(1, 5, (3, s))      # absent ones, likely
        ok, rl, ru = ts.boss.suffix_range_ranksel(torch.from_numpy(pat))
        lo, hi = tal._suffix_range_lanes(tf.boss.edge_lanes,
                                         torch.from_numpy(pat), K, 4)
        has = hi >= lo
        assert torch.equal(ok, has)
        assert torch.equal(rl[has], lo[has]) and torch.equal(ru[has],
                                                             hi[has])
        for q in (0, len(pat) - 1):
            jok, jrl, jru = js.boss.suffix_range_ranksel(
                jnp.asarray(pat[q].astype(np.int32)))
            assert bool(jok) == bool(ok[q])
            if bool(jok):
                assert (int(jrl), int(jru)) == (int(rl[q]), int(ru[q]))


def reads_for(ref, other, rng):
    reads = [ref[10:110], ref[200:380], other[:60], ref[50:64], b"ACG", b"",
             ref[100:150] + b"N" + ref[151:220],
             ref[0:40] + other[:30] + ref[300:360]]
    r = bytearray(ref[120:260])
    for p in range(20, 140, 17):
        r[p] = SUBS[r[p]]
    reads.append(bytes(r))
    for _ in range(8):
        a = int(rng.integers(0, len(ref) - 100))
        reads.append(ref[a:a + int(rng.integers(15, 100))])
    return reads


def forward_nodes(g, read):
    """Node ids of a read's windows in their own orientation (no
    canonical fold), by the fast state's lane search."""
    from metagraph_tpu_torch.kmer.extractor import (encode_sequences,
                                                    window_validity)
    codes = torch.from_numpy(encode_sequences([read], g.alphabet)[:-1])
    if len(codes) < g.k:
        return np.zeros((0,), np.int32)
    lanes = packing.pack_windows(codes, g.k, 4)
    nodes = g.edge_to_node(g.boss.map_to_edges(lanes))
    return torch.where(window_validity(codes, g.k), nodes, 0).numpy()


def test_map_read_batch(graphs):
    """The walk (anchors, fwd steps, re-anchoring after misses, the
    stragglers' flat search) maps as the JAX small state does, and as the
    fast state on basic graphs. On canonical graphs the walk maps each
    window in its own orientation where the fast state's search folds it
    to the canonical one: a fault of the reference, matched (ROADMAP
    §3.4), so there the gold is the unfolded lane search."""
    js, tf, ts, ref, other = graphs
    reads = reads_for(ref, other, np.random.default_rng(4))
    got = ts.map_read_batch(reads)
    want = js.map_read_batch(reads)
    assert len(got) == len(reads)
    for r, g, w in zip(reads, got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, forward_nodes(tf, r))
        np.testing.assert_array_equal(ts.map_to_nodes(r), tf.map_to_nodes(r))
        if tf.mode == "basic":
            np.testing.assert_array_equal(g, tf.map_to_nodes(r))


def test_adjacency_and_decoding(graphs):
    js, tf, ts, _, _ = graphs
    n = tf.num_nodes()
    nodes = torch.arange(0, n + 1)
    for name in ("successors", "predecessors", "outdegree", "indegree"):
        want = getattr(tf, name)(nodes)
        assert torch.equal(getattr(ts, name)(nodes), want), name
    np.testing.assert_array_equal(
        ts.successors(nodes[:40]).numpy(),
        np.asarray(js.successors(jnp.arange(0, 40, dtype=jnp.int32))))
    np.testing.assert_array_equal(ts.node_kmers_chars(np.arange(1, n + 1)),
                                  tf.node_kmers_chars(np.arange(1, n + 1)))
    np.testing.assert_array_equal(ts.node_kmers_chars(np.arange(1, 30)),
                                  js.node_kmers_chars(np.arange(1, 30)))
    assert ts.node_sequence(5) == tf.node_sequence(5)
    rows = torch.arange(1, tf.boss.num_edges + 1)
    assert torch.equal(ts.boss.node_chars_ranksel(rows),
                       edge_chars(tf.boss).to(torch.int32))


def test_pred_last(graphs):
    js, tf, _, _, _ = graphs
    i = np.arange(-3, tf.boss.num_edges + 4)
    np.testing.assert_array_equal(tf.boss.pred_last(torch.from_numpy(i))
                                  .numpy(),
                                  np.asarray(js.boss.pred_last(
                                      jnp.asarray(i.astype(np.int32)))))


def assert_same_alignments(got, want):
    assert len(got) == len(want)
    for gs, ws in zip(got, want):
        assert len(gs) == len(ws)
        for g, w in zip(gs, ws):
            for f in ("score", "cigar", "query_begin", "query_end",
                      "sequence", "orientation"):
                assert getattr(g, f) == getattr(w, f), (f, g, w)
            np.testing.assert_array_equal(g.nodes, w.nodes)


@pytest.mark.parametrize("with_cigar", [True, False])
def test_align_small_equals_fast(graphs, with_cigar):
    """Seeds through map_to_edges, suffix seeds through
    suffix_range_ranksel and the beam's neighbours looked up by
    rank/select: every read aligns as on the fast state."""
    _, tf, ts, ref, other = graphs
    reads = reads_for(ref, other, np.random.default_rng(5))
    reads += [ref[200:210], ref[37:49], jal._revcomp(ref[150:230])]
    want = tal.Aligner(tf).align_batch(reads, with_cigar=with_cigar,
                                       num_alternative_paths=2)
    got = tal.Aligner(ts).align_batch(reads, with_cigar=with_cigar,
                                      num_alternative_paths=2)
    assert sum(1 for r in got if r) >= len(reads) // 2
    assert_same_alignments(got, want)


def test_align_small_equals_jax_small(graphs):
    """The JAX package's tests/test_align.py small-state reads: an exact
    read, and a prefix-anchored read whose full-k seeds are destroyed
    (suffix seeds)."""
    js, _, ts, ref, _ = graphs
    short = bytearray(ref[200:240])
    for i in range(20, 40):
        short[i] = SUBS[short[i]]
    reads = [ref[100:200], bytes(short)]
    want = jal.Aligner(js).align_batch(reads)
    got = tal.Aligner(ts).align_batch(reads)
    assert got[0][0].score == 2 * 100
    # canonical graphs spell paths without node orientation (kept for
    # parity, ROADMAP §3.5): the spelling is checked on basic graphs
    assert got[0][0].sequence == ref[100:200] or ts.mode == "canonical"
    assert_same_alignments(got, want)


def run(capsys, main, argv):
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("mode", ["basic", "canonical"])
def test_cli_small_state_identical(tmp_path, capsys, mode):
    """build --state small in both CLIs; stats (--print), annotate, query
    and align print byte for byte alike, across the packages' files, and
    as the fast state does but for its state and index lines. On a
    canonical graph the small state's query walk maps reads unfolded (a
    fault of the reference, matched: ROADMAP §3.4), so there query is
    held to the JAX small state only."""
    rng = np.random.default_rng(11)
    recs = [random_dna(rng, int(rng.integers(40, 200))) for _ in range(6)]
    with open(tmp_path / "in.fa", "wb") as f:
        for i, s in enumerate(recs):
            f.write(b">rec%d\n%s\n" % (i, s))
    with open(tmp_path / "q.fa", "wb") as f:
        for i, s in enumerate(recs):
            f.write(b">q%d\n%s\n" % (i, s[3:60]))
        f.write(b">miss\n" + random_dna(rng, 50) + b"\n")
    fa, q = str(tmp_path / "in.fa"), str(tmp_path / "q.fa")
    j, t, tfast = (str(tmp_path / x) for x in ("j", "t", "tf"))
    build = ["build", "-k", "13", "--mode", mode]
    run(capsys, jmain, build + ["--state", "small", "-o", j, fa])
    run(capsys, tmain, build + ["--state", "small", "-o", t, fa,
                                "--device", "cpu"])
    run(capsys, tmain, build + ["-o", tfast, fa, "--device", "cpu"])
    assert os.path.getsize(t + ".dbg.npz") < os.path.getsize(
        tfast + ".dbg.npz")

    def port(argv):
        return run(capsys, tmain, argv + ["--device", "cpu"])

    stats = ["stats", "--print", "--validate"]
    want = run(capsys, jmain, stats + [j])
    assert "state: small" in want and "validation: OK" in want
    assert port(stats + [t]) == want
    assert port(stats + [j]) == want
    assert run(capsys, jmain, stats + [t]) == want
    fast = port(stats + [tfast])

    def body(out):
        return [ln for ln in out.splitlines()
                if not ln.startswith(("state:", "index bytes:",
                                      "bytes/edge:", "indexed suffix"))]

    assert body(fast) == body(want)
    run(capsys, jmain, ["annotate", "-i", j, "--anno-header", fa])
    port(["annotate", "-i", t, "--anno-header", fa])
    port(["annotate", "-i", tfast, "--anno-header", fa])
    for flags in ([], ["--count-labels"], ["--align"]):
        want = run(capsys, jmain, ["query", "-i", j, "-a",
                                   j + ".column.annodbg.npz"] + flags + [q])
        assert port(["query", "-i", t, "-a", t + ".column.annodbg.npz"]
                    + flags + [q]) == want
        fast = port(["query", "-i", tfast, "-a",
                     tfast + ".column.annodbg.npz"] + flags + [q])
        assert fast == want or mode == "canonical"
    want = port(["align", "-i", tfast, q])
    assert port(["align", "-i", t, q]) == want


def test_small_files_cross_load(tmp_path):
    """A small .dbg.npz written by the port loads in the JAX package with
    the same arrays, and maps alike."""
    rng = np.random.default_rng(12)
    seqs = [random_dna(rng, 150) for _ in range(3)]
    from metagraph_tpu_torch.graph.boss_construct import build_boss
    from metagraph_tpu_torch.graph.dbg_succinct import DbgSuccinct
    tg = DbgSuccinct.from_boss(build_boss(seqs, 11, device="cpu"))
    p = tio.save_graph(str(tmp_path / "g"), tg, state="small")
    with np.load(p) as d:
        assert "edge_lanes" not in d.files
    jg = jio.load_graph(p)
    assert jg.boss.edge_lanes is None
    np.testing.assert_array_equal(np.asarray(jg.boss.W),
                                  tg.boss.W.numpy())
    back = tio.load_graph(p, device="cpu")
    for s in (seqs[0], seqs[1][20:90], random_dna(rng, 40)):
        np.testing.assert_array_equal(np.asarray(jg.map_to_nodes(s)),
                                      back.map_to_nodes(s))
        np.testing.assert_array_equal(back.map_to_nodes(s),
                                      tg.map_to_nodes(s))


@pytest.mark.parametrize("call", ["score_table", "from_coo", "from_npz_dict"])
def test_defaults_on_card(call):
    """The entry points that build device tensors default to the card:
    without a GPU and with no device named, each raises."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a GPU")
    from metagraph_tpu_torch.align import pallas_dp
    from metagraph_tpu_torch.anno.matrix import RowSparse
    rows = np.array([0, 1], np.int32)
    calls = {
        "score_table": lambda: pallas_dp.score_table(2, 3, 3),
        "from_coo": lambda: RowSparse.from_coo(rows, rows, 2, 2),
        "from_npz_dict": lambda: RowSparse.from_npz_dict(
            {"rows": rows, "cols": rows, "shape": np.array([2, 2])}),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[call]()
