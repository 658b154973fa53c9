"""A sample's pipeline, back to back: ``build_boss_from_codes(codes, k,
DNA, mode, bits_per_count)`` from host codes, the graph over it
(``DbgSuccinct.from_boss``: what ``build --count-kmers`` saves and
``clean`` loads), then ``graph/cleaning.py clean_graph`` with the
configuration's clean settings, closed by a synchronize: the contigs,
their node paths and counts on the host, as ``clean`` holds them before
its writers (the files and their gzip are left out). Over the traffic's
pool of samples (a recipe of role ``inputs``) in the mix's order.

Work: the k-mer windows of the sample. Comparison with the plain
reference's cleaned k-mers of the same sample, for ``check_calls`` calls
drawn from the seed among the window's first ``check_within`` and for the
window's last call, each in full (the answers are on the host): the
threshold, the canonical k-mers spelled from the contigs against the
reference's kept set (the gap in their numbers, the k-mers in one and
not the other), each kept k-mer's count, and the k-mers written twice
or in both orientations.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import generator
from benchmark.reference.clean import clean_sample, revcomp
from benchmark.reference.kmers import kmer_ints

ROLE = "inputs"
COMPARED = ("threshold_mismatch", "kmers_gap", "kmers_mismatch",
            "counts_mismatch", "kmers_duplicated")


class State:
    pass


def _inputs(cell, seed):
    r = generator.recipe(cell.traffic["kind"], ROLE, cell.recipes)
    return (r.inputs(seed, cell.config, cell.traffic, cell.recipes),
            r.order(seed, cell.traffic))


def _sample(cell, seed):
    w = cell.workload
    within = w.get("check_within", 8)
    return set(generator.rng(seed, generator.STREAM_CHECK).choice(
        within, min(w.get("check_calls", 2), within),
        replace=False).tolist())


def _settings(cfg):
    c = cfg["clean"]
    return c["prune_tips"], c["prune_unitigs"], c["fallback"]


def setup(cell, seed, device, log):
    from metagraph_tpu_torch.graph import boss_construct
    from metagraph_tpu_torch.graph.cleaning import clean_graph
    from metagraph_tpu_torch.graph.dbg_succinct import DbgSuccinct
    from metagraph_tpu_torch.kmer.alphabets import ALPHABETS
    s = State()
    s.cell, s.seed, s.device, s.control = cell, seed, device, False
    cfg = cell.config
    s.K, s.mode, width = cfg["k"], cfg["mode"], cfg["count_width"]
    tips, unitigs, fallback = _settings(cfg)
    alphabet = ALPHABETS[cfg["alphabet"]]

    def pipeline(codes):
        boss = boss_construct.build_boss_from_codes(
            codes, s.K, alphabet, mode=s.mode, bits_per_count=width,
            device=device)
        g = DbgSuccinct.from_boss(boss, alphabet, s.mode)
        return clean_graph(g, prune_tips=tips, prune_unitigs=unitigs,
                           fallback=fallback)

    s.pipeline = pipeline
    s.pool, s.order = _inputs(cell, seed)
    s.windows = [generator.windows(bounds, s.K) for _, _, bounds in s.pool]
    s.sample = _sample(cell, seed)
    s.kept, s.final = [], None
    for i in range(cell.traffic["warm_calls"]):       # the pool's shapes
        res = call(s, i % len(s.pool))
        log(f"warm call {i}: threshold {res.threshold}, kept {res.kept} "
            f"nodes, {len(res.seqs)} contigs")
        del res
    log(f"set-up: {len(s.pool)} samples of {len(s.pool[0][0])} codes, "
        f"{s.windows[0]} windows, k = {s.K} {s.mode}, counts of "
        f"{width} bits")
    return s


def items(s):
    return s.order


def call(s, item):
    res = s.pipeline(s.pool[item][0])
    if torch.device(s.device).type == "cuda":
        torch.cuda.synchronize()
    return res


def work(s, item):
    return s.windows[item]


def keep(s, i, item, res, ok, closing):
    """The sampled calls' answers, and the latest answer as the window's
    last: the loop can stop without a call that ends past the close
    (``closing``), when a call ends just before it."""
    if not ok:
        return
    if i in s.sample:
        s.kept.append((item, res))
    s.final = (item, res)


def answer(res, K, device):
    """The check's form of an answer: (threshold, sorted canonical k-mers
    spelled from the contigs, their counts, duplicates: spelled k-mers
    less distinct canonical ones)."""
    text = b"\0".join(res.seqs)
    codes = np.frombuffer(text, np.uint8)
    lut = np.zeros(256, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = [1, 2, 3, 4]
    c = torch.from_numpy(lut[codes]).to(device)
    fwd, ok = kmer_ints(c, K)
    can = torch.minimum(fwd, revcomp(fwd, K))[ok]
    counts = (torch.from_numpy(np.concatenate(res.counts).astype(np.int64))
              .to(device) if res.counts else torch.zeros(
                  0, dtype=torch.int64, device=device))
    if counts.numel() != can.numel():           # a count a window, or none
        counts = torch.full_like(can, -1)
    kmers, order = torch.sort(can, stable=True)
    counts = counts[order]
    first = torch.ones_like(kmers, dtype=torch.bool)
    first[1:] = kmers[1:] != kmers[:-1]
    return (res.threshold, kmers[first].cpu().numpy(),
            counts[first].cpu().numpy(), int((~first).sum()))


def release(s):
    """The answers kept in the check's form; every program object goes."""
    s.kept = [(item, answer(res, s.K, s.device)) for item, res in s.kept]
    if s.final is not None:
        s.final = (s.final[0], answer(s.final[1], s.K, s.device))
    s.pipeline = None


def compare(got, ref):
    """The numbers compared for one answer against the reference's."""
    thr, kmers, counts, dup = got
    r_kmers, r_counts = ref["kmers"], ref["counts"]
    pos = np.clip(np.searchsorted(r_kmers, kmers), 0,
                  max(len(r_kmers) - 1, 0))
    hit = (r_kmers[pos] == kmers) if len(r_kmers) else \
        np.zeros(len(kmers), bool)
    both = int(hit.sum())
    return {"threshold_mismatch": int(thr != ref["threshold"]),
            "kmers_gap": abs(len(kmers) - len(r_kmers)),
            "kmers_mismatch": (len(kmers) - both) + (len(r_kmers) - both),
            "counts_mismatch": int((counts[hit] != r_counts[pos[hit]]).sum()),
            "kmers_duplicated": dup}


def reference(s, item):
    """The reference's cleaned sample; the control's skips the
    median-abundance filter (threshold 1), so the error k-mers that are
    no tips stay."""
    tips, unitigs, fallback = _settings(s.cell.config)
    return clean_sample(s.pool[item][0], s.K, tips,
                        1 if s.control else unitigs, fallback,
                        s.cell.config["count_width"], s.device)


def check(s, win, log):
    """Numbers compared, each with its limit: the reference is exact."""
    answers = s.kept + ([s.final] if s.final is not None else [])
    if not answers:
        return {"calls_checked_missing": {"value": 1, "limit": 0}}
    total = dict.fromkeys(COMPARED, 0)
    for p in sorted({item for item, _ in answers}):
        ref = reference(s, p)
        for item, got in answers:
            if item == p:
                for k, v in compare(got, ref).items():
                    total[k] += v
        log(f"sample {p}: reference threshold {ref['threshold']}, "
            f"{ref['nodes']} nodes, {len(ref['kmers'])} k-mers kept")
        del ref
    log(f"compared {len(answers)} calls in full with the reference")
    out = {"calls_checked_missing": {
        "value": int(len(s.kept) < len(s.sample) or s.final is None),
        "limit": 0}}
    out.update({k: {"value": v, "limit": 0} for k, v in total.items()})
    return out


def control(cell, seed, device, log):
    """The check's numbers for the control in the program's place: the
    reference without the median-abundance filter, for the sampled calls
    and a last one, of the seed's pool and order. (With the tips kept
    alone, the control read 0 on some seeds: the threshold's filter drops
    nearly every error tip too.)"""
    s = State()
    s.cell, s.seed, s.device = cell, seed, device
    s.K, s.control = cell.config["k"], True
    s.pool, order = _inputs(cell, seed)
    s.sample = _sample(cell, seed)
    s.kept, s.final = [], None
    answers = {}
    for i in range(max(s.sample) + 1):
        item = next(order)
        if i in s.sample or i == max(s.sample):
            if item not in answers:
                r = reference(s, item)
                answers[item] = (r["threshold"], r["kmers"], r["counts"], 0)
            if i in s.sample:
                s.kept.append((item, answers[item]))
            s.final = (item, answers[item])
    s.control = False                   # the check's reference is sound
    return check(s, None, log)
