"""The plain references on tiny inputs, against brute force from the
definitions written out in Python."""

import math

import numpy as np
import pytest
import torch

from benchmark import generator
from benchmark.reference.boss import boss_table
from benchmark.reference.kmers import reverse_digits
from benchmark.reference.labels import LabelIndex

COMP = {1: 4, 2: 3, 3: 2, 4: 1}


def _rc(s):
    return tuple(COMP[c] for c in reversed(s))


def _kmers(codes, K, mode):
    seqs, cur = [], []
    for c in list(codes) + [255]:
        if 1 <= c <= 4:
            cur.append(int(c))
        else:
            seqs.append(cur)
            cur = []
    out = set()
    for s in seqs:
        for i in range(len(s) - K + 1):
            w = tuple(s[i:i + K])
            if mode == "primary":
                w = min(w, _rc(w), key=lambda x: (x[-2::-1], x[-1]))
            out.add(w)
            if mode == "canonical":
                out.add(_rc(w))
    return out


def brute_boss(codes, K, mode):
    """BOSS by the definition, with tuples of codes ($ = 0)."""
    real = _kmers(codes, K, mode)
    srcs = {e[:-1] for e in real}
    tgts = {e[1:] for e in real}
    edges = set(real)
    edges |= {t + (0,) for t in tgts - srcs}
    for s in srcs - tgts:
        for j in range(1, K):
            edges.add((0,) * j + s[:K - 1 - j] + (s[K - 1 - j],))
    edges.add((0,) * K)
    order = sorted(edges, key=lambda e: (e[-2::-1], e[-1]))
    W, last, seen = [0], [False], set()
    for i, e in enumerate(order):
        nxt = order[i + 1] if i + 1 < len(order) else None
        last.append(nxt is None or nxt[:-1] != e[:-1])
        key = (e[1:-1], e[-1])
        W.append(e[-1] + (5 if e[-1] and key in seen else 0))
        if e[-1]:
            seen.add(key)
    F = [sum(1 for e in order if e[-2] < c) for c in range(5)]
    return W, last, F, sum(last[1:])


@pytest.mark.parametrize("K,mode", [(3, "basic"), (4, "canonical"),
                                    (5, "primary"), (6, "primary"),
                                    (4, "basic")])
def test_boss_table_equals_the_definition(K, mode):
    rng = np.random.default_rng(K * 7 + len(mode))
    bases = rng.integers(1, 5, 90, dtype=np.uint8)
    codes = generator.with_separators(bases, np.array([0, 30, 61, 90]))
    ref = boss_table(codes, K, mode)
    W, last, F, nodes = brute_boss(codes, K, mode)
    assert ref["W"].tolist() == W
    assert ref["last"].tolist() == last
    assert ref["F"].tolist() == F and ref["nodes"] == nodes


def test_dummy_levels_first_is_a_different_table():
    codes = generator.with_separators(
        np.random.default_rng(1).integers(1, 5, 60, dtype=np.uint8),
        np.array([0, 60]))
    full = boss_table(codes, 5, "primary")
    cut = boss_table(codes, 5, "primary", dummy_levels="first")
    assert len(cut["W"]) < len(full["W"])


def test_reverse_digits():
    x = torch.tensor([0b00011011, 1, 0])     # A C G T -> T G C A
    assert reverse_digits(x, 4).tolist() == [0b11100100, 1 << 6, 0]


def brute_labels(bases, bounds, reads, K, ratio, both):
    recs = [tuple(bases[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]
    out = set()
    need = max(1, math.ceil(ratio * (reads.shape[1] - K + 1)))
    for r, read in enumerate(reads):
        count = {}
        for i in range(reads.shape[1] - K + 1):
            w = tuple(int(c) for c in read[i:i + K])
            for c, s in enumerate(recs):
                hits = [tuple(int(x) for x in s[j:j + K])
                        for j in range(len(s) - K + 1)]
                if w in hits or (both and _rc(w) in hits):
                    count[c] = count.get(c, 0) + 1
        out |= {r * len(recs) + c for c, n in count.items() if n >= need}
    return sorted(out)


@pytest.mark.parametrize("both", [True, False])
def test_read_labels_equal_the_definition(both):
    rng = np.random.default_rng(3)
    bases = rng.integers(1, 5, 120, dtype=np.uint8)
    bounds = np.array([0, 40, 80, 120])
    traffic = {"reads_per_request": 12, "read_length": 14,
               "indexed_fraction": 0.75, "revcomp_fraction": 0.5,
               "error_rate": 0.05}
    reads = generator.recipe("read_requests", "requests").request(
        5, 3, 0, bases, bounds, traffic)
    got = LabelIndex(bases, bounds, 5, both_strands=both).read_labels(
        reads, 0.7)
    want = brute_labels(bases, bounds, reads, 5, 0.7, both)
    assert got.tolist() == want and len(want) > 0


def test_strain_clusters_share_kmers_within_a_species():
    cfg = {"alphabet": "DNA", "collection": {
        "kind": "strain_clusters", "species": 3, "strains_per_species": 4,
        "record_bases": 20000, "strain_divergence": 0.01}}
    bases, bounds = generator.collection(9, 1, 0, cfg)
    assert bases.size == 3 * 4 * 20000 and bounds.tolist() == [
        i * 20000 for i in range(13)]
    strains = bases.reshape(3, 4, 20000)
    # two strains of a species differ at about twice the divergence
    diff = (strains[:, 0] != strains[:, 1]).mean()
    assert 0.015 < diff < 0.025
    assert 0.7 < (strains[0, 0] != strains[1, 0]).mean() < 0.8
    # so most of a strain's 31-mers are in its siblings, none elsewhere
    index = LabelIndex(bases, bounds, 31)
    recs = index.rec.numpy()
    keys = index.keys.numpy()
    per_key = np.bincount(np.unique(keys, return_inverse=True)[1])
    assert per_key.max() == 4 and (per_key > 1).mean() > 0.3
    first = np.searchsorted(keys, keys)
    assert (recs // 4 == recs[first] // 4).all()
    assert generator.windows(bounds, 31) == 12 * (20000 - 30)


@pytest.mark.parametrize("bad", [{"alphabet": "Protein"},
                                 {"collection": {"kind": "strain_clusters",
                                                 "species": 2}},
                                 {"collection": {"kind": "no_such_kind"}}])
def test_collections_the_references_cannot_take_are_refused(bad):
    cfg = dict({"alphabet": "DNA", "collection": {
        "kind": "strain_clusters", "species": 1, "strains_per_species": 1,
        "record_bases": 100, "strain_divergence": 0}}, **bad)
    with pytest.raises(ValueError):
        generator.collection(1, 1, 0, cfg)
