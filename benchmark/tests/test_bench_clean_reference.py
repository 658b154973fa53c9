"""The clean cell's reference (``reference/clean.py``) against brute-force
definitions, the program against the reference on seeded read samples,
the ``read_sample`` recipe's reads against their genome, and the entry's
comparison: 0 on the program, above its limits on the control."""

import numpy as np
import pytest
import torch

from benchmark import generator, harness
from benchmark.entries import clean as entry
from benchmark.reference.clean import clean_sample, threshold
from benchmark.tests._tiny import ROOT, SEED

CELL = "clean.dna31-isolate-reads"
COMP = bytes.maketrans(b"ACGT", b"TGCA")


def _sample(G, coverage, err, rl=100):
    return {"kind": "read_sample", "genome_bases": G, "read_length": rl,
            "read_chars": coverage * G, "error_rate": err,
            "revcomp_fraction": 0.5}


def _tiny(G=1 << 12, coverage=48, err=0.0024):
    return {"config": {"collection": _sample(G, coverage, err)},
            "traffic": {"pool": 2, "warm_calls": 1},
            "workload": {"trace_calls": 2, "check_within": 2}}


def _reads(seed, G, coverage, err, rl=100):
    """(codes with a separator after each read, bases, bounds)."""
    bases, bounds = generator.collection(
        seed, generator.STREAM_POOL, 0,
        {"alphabet": "DNA", "collection": _sample(G, coverage, err, rl)})
    return generator.with_separators(bases, bounds), bases, bounds


def _rc(s):
    return s.translate(COMP)[::-1]


def brute_force(reads, K, tips, thr, width):
    """The cleaned sample by its definition, on Python strings."""
    count = {}
    for r in reads:
        for i in range(len(r) - K + 1):
            w = r[i:i + K]
            c = min(w, _rc(w))
            count[c] = count.get(c, 0) + 1
    weight = {}
    for c, n in count.items():
        n = 2 * n if c == _rc(c) else n
        weight[c] = weight[_rc(c)] = min(n, (1 << width) - 1)
    succ = {v: [v[1:] + x for x in "ACGT" if v[1:] + x in weight]
            for v in weight}
    pred = {v: [x + v[:-1] for x in "ACGT" if x + v[:-1] in weight]
            for v in weight}
    nxt = {v: s[0] for v, s in succ.items()
           if len(s) == 1 and len(pred[s[0]]) == 1}
    prv = {w: v for v, w in nxt.items()}
    keep, seen = set(), set()
    for v in sorted(weight):
        if v in seen:
            continue
        start = v                   # back to the chain's first node
        while start in prv and prv[start] != v:
            start = prv[start]
        chain, x = [], start
        while x not in seen:
            seen.add(x)
            chain.append(x)
            if x not in nxt:
                break
            x = nxt[x]
        cycle = chain[-1] in nxt
        tip = (not cycle and len(chain) < tips
               and len(pred[chain[0]]) + len(succ[chain[-1]]) < 2)
        weak = sum(weight[x] < thr for x in chain)
        if not tip and not (thr > 1 and 2 * weak > len(chain)):
            keep.update(chain)
    kept = sorted({min(v, _rc(v)) for v in keep})
    return kept, [weight[v] for v in kept], weight


def _as_strings(kmers, K):
    return ["".join("ACGT"[(int(x) >> (2 * (K - 1 - j))) & 3]
                    for j in range(K)) for x in kmers]


@pytest.mark.parametrize("K,tips,unitigs,width,err", [
    (11, 22, 0, 8, 0.02), (11, 22, 3, 8, 0.02), (9, 1, 4, 3, 0.01),
    (13, 30, 2, 8, 0.0)])
def test_reference_equals_the_definition(K, tips, unitigs, width, err):
    codes, bases, bounds = _reads(SEED + K, 400, 15, err, rl=40)
    reads = [generator.LETTERS[bases[a:b]].tobytes().decode()
             for a, b in zip(bounds[:-1], bounds[1:])]
    got = clean_sample(codes, K, tips, unitigs, 2, width)
    thr = unitigs
    if unitigs == 0:
        weight = brute_force(reads, K, tips, 1, width)[2]
        hist = np.bincount(list(weight.values()))
        thr = threshold(hist)
        thr = 2 if thr < 0 else thr
    kept, counts, weight = brute_force(reads, K, tips, thr, width)
    assert got["threshold"] == thr and got["nodes"] == len(weight)
    assert _as_strings(got["kmers"], K) == kept
    assert got["counts"].tolist() == counts


def test_threshold_is_the_programs():
    """The reference's gamma-Poisson fit gives the program's threshold on
    seeded error + signal mixtures and on histograms where it fails."""
    from metagraph_tpu_torch.graph.cleaning import pick_kmer_threshold
    rng = np.random.default_rng(3)
    hists = []
    for lam_err, lam, n_sig in ((1.2, 25, 5000), (0.3, 33, 8000),
                                (2.5, 9, 3000), (0.1, 60, 200)):
        h = np.bincount(np.concatenate([
            rng.poisson(lam_err, 20000) + 1, rng.poisson(lam, n_sig)]),
            minlength=80)[:256].astype(np.uint64)
        h[0] = 0
        hists.append(h)
    no2 = np.zeros(10, np.uint64)
    no2[1], no2[3] = 7, 9
    flat = np.zeros(12, np.uint64)
    flat[1:4] = 5
    for h in hists + [no2, flat]:
        assert threshold(h) == pick_kmer_threshold(h)


@pytest.mark.parametrize("G,coverage,err", [(1 << 12, 48, 0.0024),
                                            (1 << 13, 32, 0.01),
                                            (1 << 14, 40, 0.005)])
def test_program_equals_the_reference(G, coverage, err):
    """``build_boss_from_codes`` + ``clean_graph`` (the entry's call) on
    the CPU against the reference: every compared number 0."""
    cell = harness.Cell(CELL, ROOT, _tiny(G, coverage, err))
    s = entry.setup(cell, SEED + G, "cpu", lambda m: None)
    res = entry.call(s, 0)
    assert res.kept > 0.9 * G
    got = entry.answer(res, 31, "cpu")
    ref = entry.reference(s, 0)
    assert entry.compare(got, ref) == dict.fromkeys(entry.COMPARED, 0)


def test_read_sample_covers_its_genome():
    """The reads are the genome's, half of them reverse-complemented, at
    the asked coverage and error rate: nearly every genome k-mer is read,
    and a read's k-mers are the genome's as often as (1 - err)^K says."""
    G, cov, err, K = 1 << 13, 48, 0.0024, 31
    mix = _sample(G, cov, err)
    g = generator.rng(SEED, generator.STREAM_POOL, 0)
    genome = g.integers(1, 5, G, dtype=np.uint8)     # the recipe's first draw
    codes, bases, bounds = _reads(SEED, G, cov, err)
    assert len(bounds) - 1 == round(mix["read_chars"] / 100)
    assert np.all(np.diff(bounds) == 100)
    from benchmark.reference.kmers import kmer_ints
    fwd_g, _ = kmer_ints(torch.from_numpy(genome), K)
    rc_g, _ = kmer_ints(torch.from_numpy(genome), K, reverse_complement=True)
    fwd_r, ok = kmer_ints(torch.from_numpy(codes), K)
    fwd_r = fwd_r[ok]
    gs, rs = torch.unique(fwd_g), torch.unique(rc_g)
    in_fwd = torch.isin(fwd_r, gs)
    in_rc = torch.isin(fwd_r, rs)
    assert float(torch.isin(gs, fwd_r).float().mean()) > 0.98
    found = float((in_fwd | in_rc).float().mean())
    assert abs(found - (1 - err) ** K) < 0.02
    assert 0.45 < float(in_fwd.sum()) / float((in_fwd | in_rc).sum()) < 0.55


def test_check_reads_zero_on_the_program_and_above_on_the_control():
    over = _tiny()
    r = harness.run_cell(CELL, SEED, 2.0, False, device="cpu", root=ROOT,
                         overrides=over, log=lambda m: None)
    assert r["correct"], r["checks"]
    assert all(c["value"] == 0 for c in r["checks"].values())
    c = harness.Cell(CELL, ROOT, over)
    checks = c.entry().control(c, SEED, "cpu", lambda m: None)
    assert any(v["value"] > v["limit"] for v in checks.values())


def test_the_last_answer_is_kept_without_a_closing_call():
    """A window whose last call ended just before the close has no call
    marked ``closing``; the latest good answer stands for the last."""
    s = entry.State()
    s.sample, s.kept, s.final = {0}, [], None
    for i in range(3):
        entry.keep(s, i, i % 2, f"r{i}", True, closing=False)
    entry.keep(s, 3, 1, None, False, closing=True)      # a call that failed
    assert s.kept == [(0, "r0")] and s.final == (0, "r2")
