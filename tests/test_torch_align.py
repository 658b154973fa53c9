"""The port's alignment path against the JAX package, on the CPU.

* ``pallas_dp``: the port's plain ``batch_align_ends`` /
  ``batch_align_scores`` against the JAX Pallas kernel in interpret mode
  (as ``tests/test_pallas_dp.py`` runs it), against the JAX
  ``_full_dp_ends`` and against the numpy gold;
* ``batched_cigars`` / ``batched_ends`` against the JAX ones, op codes
  included;
* ``successors`` / ``predecessors`` / ``node_kmers_chars`` against the
  JAX graph's;
* ``Aligner.align_batch`` on a JAX-built graph carried over with
  ``dbg_from_numpy``, every field of every ``GraphAlignment``.

Integer data: every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_dna
from metagraph_tpu.align import aligner as jal
from metagraph_tpu.align import batch_extender as jbe
from metagraph_tpu.align import pallas_dp as jdp
from metagraph_tpu.graph.boss_construct import build_boss as jbuild
from metagraph_tpu.graph.dbg_succinct import DbgSuccinct as JDbg
from metagraph_tpu.kmer.alphabets import DNA
from metagraph_tpu_torch.align import aligner as tal
from metagraph_tpu_torch.align import batch_extender as tbe
from metagraph_tpu_torch.align import pallas_dp as tdp
from metagraph_tpu_torch.graph.io import dbg_from_numpy

torch.set_num_threads(2)

SUBS = {65: 67, 67: 65, 71: 84, 84: 71}     # transversions A<->C, G<->T


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def make_pairs(rng, R, LQ, LR):
    """Related pairs (the ref a mutated copy of the query) with random
    lengths, plus the edge rows: qlen 0, rlen 0, identical pairs and
    all-0 codes."""
    q = rng.integers(1, 5, (R, LQ)).astype(np.int32)
    r = rng.integers(1, 5, (R, LR)).astype(np.int32)
    n = min(LQ, LR)
    for i in range(0, R, 2):                  # every other ref: a copy
        r[i, :n] = q[i, :n]
        r[i, rng.integers(0, LR)] = rng.integers(1, 5)
    qlens = rng.integers(0, LQ + 1, R).astype(np.int32)
    rlens = rng.integers(0, LR + 1, R).astype(np.int32)
    if R >= 5:
        qlens[1] = 0
        rlens[2] = 0
        r[3, :n] = q[3, :n]                   # identical: many equal maxima
        qlens[3], rlens[3] = n, n
        q[4] = 0                              # all-0 codes
        r[4] = 0
    return q, r, qlens, rlens


PENALTIES = [
    # match, tpen, tvpen, open, ext
    (2, 3, 3, 5, 2),
    (1, 1, 4, 3, 1),
    (3, 2, 5, 6, 3),
]
SHAPES = [(8, 17, 21), (5, 1, 9), (13, 24, 16)]   # R, LQ, LR


@pytest.mark.parametrize("R,LQ,LR", SHAPES)
@pytest.mark.parametrize("pen", PENALTIES)
def test_dp_ends_and_scores(R, LQ, LR, pen):
    match, tpen, tvpen, open_p, ext_p = pen
    rng = np.random.default_rng(R * 100 + LQ + sum(pen))
    q, r, ql, rl = make_pairs(rng, R, LQ, LR)
    kw = dict(match=match, tpen=tpen, tvpen=tvpen, open_p=open_p,
              ext_p=ext_p)
    got = tdp.batch_align_ends(T(q), T(r), T(ql), T(rl), **kw).numpy()
    J = [jnp.asarray(x) for x in (q, r, ql, rl)]
    np.testing.assert_array_equal(
        got, np.asarray(jdp.batch_align_ends(*J, interpret=True, **kw)))
    np.testing.assert_array_equal(
        got, np.asarray(jbe._full_dp_ends(*J, **kw)))
    scores = tdp.batch_align_scores(T(q), T(r), T(ql), T(rl), **kw).numpy()
    np.testing.assert_array_equal(scores, got[:, 0])
    np.testing.assert_array_equal(
        scores, np.asarray(jdp.batch_align_scores(*J, interpret=True, **kw)))
    np.testing.assert_array_equal(
        scores, jdp.batch_align_scores_reference(q, r, ql, rl, **kw))
    np.testing.assert_array_equal(
        scores, tdp.batch_align_scores_reference(q, r, ql, rl, **kw))


def test_dp_open_below_ext():
    """open < ext pins the prefix-max form of the insertions (taken over
    Hn before insertions); the numpy gold runs Gotoh over the final H and
    may differ, so only the interpret-mode kernel and the full DP hold."""
    rng = np.random.default_rng(5)
    q, r, ql, rl = make_pairs(rng, 11, 20, 23)
    kw = dict(match=2, tpen=1, tvpen=2, open_p=1, ext_p=4)
    got = tdp.batch_align_ends(T(q), T(r), T(ql), T(rl), **kw).numpy()
    J = [jnp.asarray(x) for x in (q, r, ql, rl)]
    np.testing.assert_array_equal(
        got, np.asarray(jdp.batch_align_ends(*J, interpret=True, **kw)))
    np.testing.assert_array_equal(
        got, np.asarray(jbe._full_dp_ends(*J, **kw)))


def wavefront_ends(q, r, qlen, rlen, table, open_p, ext_p):
    """One pair by the schedule of the lane wavefront in csrc/align_dp.cu,
    in numpy: element i of each (32,) array is lane i of the warp.

    Lane i owns rows [i*P, (i+1)*P) of the column, P the smallest of 1, 2,
    4, 8 with 32*P >= qlen + 1, and computes column t = s - i at step s.
    What a lane takes from lane i - 1 (the shuffles) is what that lane
    held after step s - 1: its ref char, the bottom row's final H (the
    diagonal of the next column) and the insertion carry. Insertions run
    sequentially over Hn, before insertions: I[j] = max(Hn[j-1] - open,
    I[j-1] - ext). Each lane keeps the first strictly greater H of its
    own valid cells in (t, j) order; one reduce by (value desc, t asc,
    j asc) ends it. Returns [best, bt, bj]."""
    NEG, lanes = tdp.NEG, np.arange(32)
    sigma = table.shape[0]
    P = next(p for p in (1, 2, 4, 8) if 32 * p >= qlen + 1)
    j = lanes[:, None] * P + np.arange(P)[None, :]           # (32, P)
    valid = j <= qlen
    qc = np.where((j >= 1) & valid, q[np.clip(j - 1, 0, max(len(q) - 1, 0))]
                  if len(q) else 0, 0)

    def h0(jj):
        return np.where(jj == 0, 0, -open_p - (jj - 1) * ext_p)

    H = h0(j).astype(np.int64)
    D = np.full((32, P), NEG, np.int64)
    bv = np.full(32, np.iinfo(np.int32).min, np.int64)
    bt = np.zeros(32, np.int64)
    bj = np.zeros(32, np.int64)
    for p in range(P):                                       # column 0
        upd = valid[:, p] & (H[:, p] > bv)
        bv, bj = np.where(upd, H[:, p], bv), np.where(upd, j[:, p], bj)
    up = h0(lanes * P - 1)                     # H0 of the row above lane i
    nl = -(-(qlen + 1) // P)                   # lanes holding a valid row
    c_reg = np.zeros(32, np.int64)
    h_out = np.zeros(32, np.int64)
    i_out = np.zeros(32, np.int64)
    for s in range(rlen + nl - 1 if rlen else 0):
        c_in, h_in, i_in = (np.roll(x, 1) for x in (c_reg, h_out, i_out))
        c_in[0] = r[s] if s < rlen else 0
        i_in[0] = NEG - (open_p - ext_p)      # I at row 0, as in the plain
        c_reg = c_in
        t = s - lanes
        act = (t >= 0) & (t < rlen) & (lanes < nl)
        diag, I, hn_prev = up, i_in, None
        newH, newD = H.copy(), D.copy()
        for p in range(P):
            dn = np.maximum(H[:, p] - open_p, D[:, p] - ext_p)
            hn = np.maximum(diag + table[qc[:, p], c_in], dn)
            if p == 0:
                hn = np.where(lanes == 0, dn, hn)  # row 0: no diagonal
            else:
                I = np.maximum(hn_prev - open_p, I - ext_p)
            h = np.maximum(hn, I)
            diag, hn_prev = H[:, p], hn
            newH[:, p], newD[:, p] = h, dn
            upd = act & valid[:, p] & (h > bv)
            bv = np.where(upd, h, bv)
            bt = np.where(upd, t + 1, bt)
            bj = np.where(upd, j[:, p], bj)
        H = np.where(act[:, None], newH, H)
        D = np.where(act[:, None], newD, D)
        h_out = np.where(act, H[:, P - 1], h_out)
        i_out = np.where(act, np.maximum(hn_prev - open_p, I - ext_p), i_out)
        up = np.where(act, h_in, up)
    win = min(lanes, key=lambda i: (-bv[i], bt[i], bj[i]))
    return [int(bv[win]), int(bt[win]), int(bj[win])], P


@pytest.mark.parametrize("pen", [(2, 3, 3, 5, 2), (2, 1, 2, 1, 4)])
@pytest.mark.parametrize("band", [1, 2, 4, 8])
def test_wavefront_schedule(band, pen):
    """The lane wavefront's recurrence and tie rule, emulated step by step,
    equal the JAX kernel (interpret mode) and the port's plain version:
    rows of ``band`` per lane, open < ext, qlen 0, rlen 0, identical pairs
    (ties) and all-0 codes."""
    match, tpen, tvpen, open_p, ext_p = pen
    LQ, LR = 32 * band - 1, 37
    rng = np.random.default_rng(band * 10 + open_p)
    q, r, ql, rl = make_pairs(rng, 9, LQ, LR)
    ql[5:] = rng.integers(16 * band if band > 1 else 0, LQ + 1, 4)
    rl[5:7] = LR                               # full columns
    kw = dict(match=match, tpen=tpen, tvpen=tvpen, open_p=open_p,
              ext_p=ext_p)
    table = tdp.dna_table(match, tpen, tvpen).astype(np.int64)
    got, bands = zip(*(wavefront_ends(q[i], r[i], int(ql[i]), int(rl[i]),
                                      table, open_p, ext_p)
                       for i in range(len(q))))
    assert band in bands
    J = [jnp.asarray(x) for x in (q, r, ql, rl)]
    np.testing.assert_array_equal(
        np.array(got), np.asarray(jdp.batch_align_ends(*J, interpret=True,
                                                       **kw)))
    np.testing.assert_array_equal(
        np.array(got), tdp.batch_align_ends(T(q), T(r), T(ql), T(rl),
                                            **kw).numpy())


def test_dp_table_scoring():
    """The unit table runs on the same plain version / kernel as the DNA
    table; the DNA table equals the arithmetic substitution."""
    rng = np.random.default_rng(9)
    q, r, ql, rl = make_pairs(rng, 9, 15, 18)
    unit = tuple(tuple(int(v) for v in row)
                 for row in jal.unit_matrix(DNA, 1))
    kw = dict(match=1, tpen=1, tvpen=1, open_p=1, ext_p=1)
    got = tdp.batch_align_ends(T(q), T(r), T(ql), T(rl), sub_tt=unit,
                               **kw).numpy()
    want = jbe._full_dp_ends(*[jnp.asarray(x) for x in (q, r, ql, rl)],
                             sub_tt=unit, **kw)
    np.testing.assert_array_equal(got, np.asarray(want))
    codes = jnp.arange(5)
    np.testing.assert_array_equal(
        tdp.dna_table(2, 3, 5),
        np.asarray(jdp._subst(codes[:, None], codes[None, :], 2, 3, 5)))


def test_dp_empty_batch():
    z = torch.zeros((0, 4), dtype=torch.int32)
    n = torch.zeros((0,), dtype=torch.int32)
    assert tdp.batch_align_ends(z, z, n, n).shape == (0, 3)
    assert tdp.batch_align_scores(z, z, n, n).shape == (0,)
    assert tbe.batched_ends(np.zeros((0, 4)), np.zeros((0, 4)), [], [],
                            5, 2, 2, 3, 3, device="cpu").shape == (0, 3)
    assert tbe.batched_cigars(np.zeros((0, 4)), np.zeros((0, 4)), [], [],
                              5, 2, 2, 3, 3, device="cpu") == []


@pytest.mark.parametrize("table", [False, True])
def test_batched_cigars_and_ends(table):
    rng = np.random.default_rng(21 + table)
    q, r, ql, rl = make_pairs(rng, 14, 27, 31)
    cfg = jal.AlignerConfig()
    sub = cfg.score_matrix()
    sub_tt = (tuple(tuple(int(v) for v in row)
                    for row in jal.unit_matrix(DNA, 1)) if table else None)
    args = (cfg.gap_opening_penalty, cfg.gap_extension_penalty,
            cfg.match_score, cfg.mm_transition_penalty,
            cfg.mm_transversion_penalty)
    want = jbe.batched_cigars(q, r, ql, rl, sub, *args, sub_tt=sub_tt)
    got = tbe.batched_cigars(q, r, ql, rl, *args, sub_tt=sub_tt,
                             device="cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:3] == w[:3]
        assert g[3].dtype == w[3].dtype
        np.testing.assert_array_equal(g[3], w[3])
    np.testing.assert_array_equal(
        tbe.batched_ends(q, r, ql, rl, *args, sub_tt=sub_tt, device="cpu"),
        jbe.batched_ends(q, r, ql, rl, *args, sub_tt=sub_tt))
    J = [jnp.asarray(x) for x in (q, r, ql, rl)]
    kw = dict(match=cfg.match_score, tpen=cfg.mm_transition_penalty,
              tvpen=cfg.mm_transversion_penalty,
              open_p=cfg.gap_opening_penalty,
              ext_p=cfg.gap_extension_penalty, sub_tt=sub_tt)
    np.testing.assert_array_equal(
        tbe._full_dp_ends(T(q), T(r), T(ql), T(rl), **kw).numpy(),
        np.asarray(jbe._full_dp_ends(*J, **kw)))


# ---------------------------------------------------------------------------
# graphs built by the JAX package, carried over with dbg_from_numpy
# ---------------------------------------------------------------------------

def jax_graph_arrays(g):
    boss = g.boss
    return dict(k=boss.k, alphabet=g.alphabet.name, mode=g.mode,
                W=np.asarray(boss.W), last=boss.last_rank.bits_host(),
                F=np.asarray(boss.F), edge_lanes=np.asarray(boss.edge_lanes),
                valid=g.valid_rank.bits_host())


def make_reads(rng, ref, other):
    """Two read sets of ``ref``: "seeded" (exact, substitution, insertion,
    deletion, chimeric, reverse-complement, and mixed lengths so that the
    extension splits short from long tails) and "suffix" (reads with no
    full-k seed: shorter than k, unmappable, empty)."""
    reads = [ref[100:200], ref[10:90], ref[0:40], ref[330:400]]
    for p in (30, 120, 250):
        r = bytearray(ref[p:p + 100])
        r[50] = SUBS[r[50]]
        reads.append(bytes(r))
    r = bytearray(ref[60:140])
    r[5] = SUBS[r[5]]                          # near the start: backward DP
    reads.append(bytes(r))
    reads.append(ref[100:150] + b"G" + ref[150:200])        # insertion
    reads.append(ref[200:240] + ref[242:290])               # deletion
    reads.append(ref[50:90] + ref[300:340])                 # chimeric
    reads.append(jal._revcomp(ref[150:230]))
    for _ in range(20):                        # mixed lengths: short/long
        a = int(rng.integers(0, len(ref) - 120))
        r = bytearray(ref[a:a + int(rng.integers(16, 120))])
        if len(r) > 30 and rng.random() < 0.5:
            p = int(rng.integers(0, len(r)))
            r[p] = SUBS[r[p]]
        reads.append(bytes(r))
    r = bytearray(jal._revcomp(ref[20:120]))
    r[40] = SUBS[r[40]]
    strands = [ref[100:200], jal._revcomp(ref[150:230]), bytes(r)]
    suffix = [ref[200:210], ref[37:49], b"ACG", other[:70], b""]
    return {"seeded": reads, "suffix": suffix, "strands": strands}


@pytest.fixture(scope="module", params=["basic", "canonical"])
def graphs(request):
    rng = np.random.default_rng(7)
    ref = random_dna(rng, 400)
    other = random_dna(rng, 100)
    jg = JDbg.from_boss(jbuild([ref], 15, mode=request.param), DNA,
                        request.param)
    tg = dbg_from_numpy(jax_graph_arrays(jg), device="cpu")
    return jg, tg, make_reads(rng, ref, other)


def test_adjacency_and_decoding(graphs):
    jg, tg, _ = graphs
    nodes = np.arange(0, jg.num_nodes() + 1, dtype=np.int32)
    for name in ("successors", "predecessors", "outdegree", "indegree"):
        np.testing.assert_array_equal(
            getattr(tg, name)(torch.from_numpy(nodes)).numpy(),
            np.asarray(getattr(jg, name)(jnp.asarray(nodes))))
    np.testing.assert_array_equal(tg.node_kmers_chars(nodes[1:]),
                                  jg.node_kmers_chars(nodes[1:]))
    assert tg.node_sequence(3) == jg.node_sequence(3)


def test_suffix_seeds(graphs):
    jg, tg, reads = graphs
    ja, ta = jal.Aligner(jg), tal.Aligner(tg)
    codes = [np.where(c == 255, 0, c).astype(np.int32) for c in
             (ja._tbl[np.frombuffer(s, np.uint8)] for s in reads["suffix"])]
    want = [ja._suffix_seeds(c) for c in codes]
    assert ta._suffix_seeds_batch(codes) == want
    assert ta._suffix_seeds(codes[0]) == want[0]
    assert want[0][1] == 10 and want[3][0]     # a full-length and a short hit


def assert_same_alignments(got, want):
    assert len(got) == len(want)
    for gs, ws in zip(got, want):
        assert len(gs) == len(ws)
        for g, w in zip(gs, ws):
            for f in ("score", "cigar", "query_begin", "query_end",
                      "sequence", "orientation"):
                assert getattr(g, f) == getattr(w, f), (f, g, w)
            assert type(g.nodes) is type(w.nodes)
            assert np.asarray(g.nodes).dtype == np.asarray(w.nodes).dtype
            np.testing.assert_array_equal(g.nodes, w.nodes)


CONFIGS = {
    "default": (dict(), dict(num_alternative_paths=4), ("seeded", "suffix")),
    "strands": (dict(), dict(both_strands=True, num_alternative_paths=2),
                ("strands",)),
    "chimeric": (dict(min_exact_match=0.3), dict(num_alternative_paths=4),
                 ("seeded",)),
    "edit_distance": (dict(score_matrix_type="unit", match_score=1,
                           mm_transition_penalty=1,
                           mm_transversion_penalty=1, gap_opening_penalty=1,
                           gap_extension_penalty=1, min_exact_match=0.5),
                      dict(), ("seeded",)),
    "max_ram": (dict(max_ram_mb=0.1, min_cell_score=-20, xdrop=12), dict(),
                ("seeded",)),
}


@pytest.mark.parametrize("name,with_cigar", [
    ("default", True), ("default", False), ("strands", True),
    ("chimeric", True), ("chimeric", False),
    ("edit_distance", True), ("edit_distance", False), ("max_ram", True)])
def test_align_batch(graphs, name, with_cigar):
    jg, tg, read_sets = graphs
    cfg_kw, call_kw, sets = CONFIGS[name]
    reads = [r for s in sets for r in read_sets[s]]
    want = jal.Aligner(jg, jal.AlignerConfig(**cfg_kw)).align_batch(
        reads, with_cigar=with_cigar, **call_kw)
    got = tal.Aligner(tg, tal.AlignerConfig(**cfg_kw)).align_batch(
        reads, with_cigar=with_cigar, **call_kw)
    assert sum(1 for r in got if r) >= len(reads) // 2
    assert_same_alignments(got, want)


def test_beam_lookup_on_the_fly(graphs):
    """The beam walk gives the same paths with the adjacency table and
    with on-the-fly successor / predecessor lookups."""
    _, tg, reads = graphs
    al = tal.Aligner(tg)
    rng = np.random.default_rng(3)
    B, L = 12, 40
    tails = rng.integers(1, 5, (B, L)).astype(np.int32)
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    starts = rng.integers(0, tg.num_nodes() + 1, B).astype(np.int32)
    for backward in (False, True):
        a = tbe.beam_extend_batch(tg, starts, tails, lens, al.config, 4,
                                  backward, al._adjacency_table(backward))
        b = tbe.beam_extend_batch(tg, starts, tails, lens, al.config, 4,
                                  backward, None)
        np.testing.assert_array_equal(a[0], b[0])
        for x, y in zip(a[1] + a[2], b[1] + b[2]):
            np.testing.assert_array_equal(x, y)
