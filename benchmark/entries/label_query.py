"""Label queries: each request is ``BatchQuery(AnnotatedDbg(graph,
annotation)).get_labels_batch(reads, discovery_fraction)`` (what
``query`` and ``server_query``'s /search run), timed from the time the
request was sent (by the mix's loop, ``harness.drive``) to its return
with the label lists on the host.

Set-up builds the configuration's graph (its alphabet, k and mode) from
its collection, annotates one label a record (``rec_<i>``) and converts
the annotation to the configuration's form, as ``annotate`` and
``transform_anno`` do; then it makes the request pool by the mix's
recipe (role ``requests``) and warms up on requests of its own.

Work: the reads answered. Comparison: every read of every request the
window answered against the plain reference's labels of the same reads,
worked out from the records alone.
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from benchmark import generator
from benchmark.reference.labels import LabelIndex


ROLE = "requests"


class State:
    pass


class _Clock:
    """Logs the seconds of each set-up phase (synchronized)."""

    def __init__(self, log):
        self.log, self.t = log, time.perf_counter()

    def __call__(self, phase):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t = time.perf_counter()
        self.log(f"set-up {phase}: {t - self.t:.3f} s")
        self.t = t


def _request(s, stream, index):
    reads = s.recipe.request(s.seed, stream, index, s.bases, s.bounds,
                             s.cell.traffic)
    return reads, generator.as_bytes(reads)


def _collection(s, cell, seed):
    s.recipe = generator.recipe(cell.traffic["kind"], ROLE, cell.recipes)
    s.bases, s.bounds = generator.collection(seed, generator.STREAM_RECORDS,
                                             0, cell.config, cell.recipes)


def setup(cell, seed, device, log):
    from metagraph_tpu_torch.anno import row_diff
    from metagraph_tpu_torch.anno.annotator import Annotation
    from metagraph_tpu_torch.engine.annotated_dbg import (
        AnnotatedDbg, BatchQuery, annotate_sequences)
    from metagraph_tpu_torch.graph.boss_construct import build_boss_from_codes
    from metagraph_tpu_torch.graph.dbg_succinct import DbgSuccinct
    from metagraph_tpu_torch.kmer.alphabets import ALPHABETS
    cfg = cell.config
    clock = _Clock(log)
    s = State()
    s.cell, s.seed, s.device = cell, seed, device
    s.K, s.ratio = cfg["k"], cfg["discovery_fraction"]
    alphabet = ALPHABETS[cfg["alphabet"]]
    _collection(s, cell, seed)
    clock("collection")
    boss = build_boss_from_codes(
        generator.with_separators(s.bases, s.bounds), s.K, alphabet,
        mode=cfg["mode"], device=device)
    graph = DbgSuccinct.from_boss(boss, alphabet, mode=cfg["mode"])
    del boss
    clock("graph")
    letters = generator.LETTERS
    s.labels = [f"rec_{i}" for i in range(len(s.bounds) - 1)]
    ann = annotate_sequences(graph, [
        (letters[s.bases[a:b]].tobytes(), [name])
        for a, b, name in zip(s.bounds[:-1], s.bounds[1:], s.labels)
    ]).finalize()
    clock("annotate")
    anno = cfg["annotation"]
    if anno["form"] != "row_diff_brwt":
        raise ValueError(f"annotation form {anno['form']!r}")
    matrix = row_diff.build_row_diff_brwt(
        ann.matrix.to_row_sparse(), graph, max_length=anno["max_length"],
        subsample=anno["subsample"])
    s.bq = BatchQuery(AnnotatedDbg(
        graph=graph, annotation=Annotation(matrix=matrix,
                                           encoder=ann.encoder)))
    del ann, matrix, graph
    clock("convert")
    s.pool = [_request(s, generator.STREAM_REQUESTS, i)
              for i in range(cell.traffic["pool_requests"])]
    clock("requests")
    for i in range(cell.traffic["warm_requests"]):
        s.bq.get_labels_batch(_request(s, generator.STREAM_WARM, i)[1],
                              s.ratio)
    clock("warm-up")
    s.answers = {}
    s.code = {name: i for i, name in enumerate(s.labels)}
    log(f"set-up: {len(s.labels)} records, {s.bq.adbg.graph.num_nodes()} "
        f"nodes, a pool of {len(s.pool)} requests")
    return s


def items(s):
    for i in itertools.count():
        if i == len(s.pool):                  # past the pool: made now
            s.pool.append(_request(s, generator.STREAM_REQUESTS, i))
        yield i


def call(s, item):
    return s.bq.get_labels_batch(s.pool[item][1], s.ratio)


def work(s, item):
    return len(s.pool[item][1])


def _pack(answer):
    """A request's label lists as one string, a line a read: a string is
    not tracked by Python's collector, so the answers kept for the check
    do not slow the program's collections as the window goes on (about
    0.3 ms a request of 4096 reads)."""
    return "\n".join(map(" ".join, answer))


def keep(s, i, item, answer, ok, closing):
    if ok:
        s.answers[item] = _pack(answer)


def release(s):
    s.bq = None


def _keys(s, answers, n_reads):
    C = len(s.labels)
    out = []
    for item, packed in sorted(answers.items()):
        base = item * n_reads
        out += [(base + r) * C + s.code[name]
                for r, line in enumerate(packed.split("\n"))
                for name in line.split()]
    return np.unique(np.asarray(out, np.int64))


def check(s, win, log, both_strands=True):
    """Numbers compared, each with its limit: the labels are exact."""
    n_reads = s.cell.traffic["reads_per_request"]
    C = len(s.labels)
    ref_index = LabelIndex(s.bases, s.bounds, s.K, s.device,
                           both_strands=both_strands)
    items = sorted(s.answers)
    ref = []
    for k in range(0, len(items), 64):
        block = items[k:k + 64]
        reads = np.concatenate([s.pool[i][0] for i in block])
        keys = ref_index.read_labels(reads, s.ratio)
        # block-local read numbers back to (request, read)
        local, rec = keys // C, keys % C
        req = np.asarray(block, np.int64)[local // n_reads]
        ref.append((req * n_reads + local % n_reads) * C + rec)
    ref = np.unique(np.concatenate(ref + [np.zeros(0, np.int64)]))
    got = _keys(s, s.answers, n_reads)
    missing = np.setdiff1d(ref, got)
    extra = np.setdiff1d(got, ref)
    wrong_reads = np.unique(np.concatenate([missing, extra]) // C)
    log(f"compared {len(items)} requests, {len(items) * n_reads} reads, "
        f"{len(ref)} reference labels")
    return {"requests_answered_missing": {"value": int(not items),
                                          "limit": 0},
            "reads_wrong": {"value": int(len(wrong_reads)), "limit": 0},
            "labels_missing": {"value": int(len(missing)), "limit": 0},
            "labels_extra": {"value": int(len(extra)), "limit": 0}}


def control(cell, seed, device, log, requests=None):
    """The check's numbers for the control in the program's place: the
    reference matching each k-mer as read (the graph's canonical
    guarantee broken), over as many requests as a run answers."""
    s = State()
    s.cell, s.seed, s.device = cell, seed, device
    cfg = cell.config
    s.K, s.ratio = cfg["k"], cfg["discovery_fraction"]
    _collection(s, cell, seed)
    s.labels = [f"rec_{i}" for i in range(len(s.bounds) - 1)]
    s.code = {name: i for i, name in enumerate(s.labels)}
    n = requests or cell.traffic["pool_requests"]
    s.pool = [_request(s, generator.STREAM_REQUESTS, i) for i in range(n)]
    forward = LabelIndex(s.bases, s.bounds, s.K, device, both_strands=False)
    n_reads = cell.traffic["reads_per_request"]
    C = len(s.labels)
    s.answers = {}
    for i, (reads, _) in enumerate(s.pool):
        keys = forward.read_labels(reads, s.ratio)
        per_read = [[] for _ in range(n_reads)]
        for k in keys:
            per_read[k // C].append(s.labels[k % C])
        s.answers[i] = _pack(per_read)
    del forward
    return check(s, None, log)
