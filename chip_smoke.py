#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the process exits non-zero):
  0. device: a CUDA device must be present; prints its name and power
     limit.
  1. builds the CUDA kernels of metagraph_tpu_torch/csrc from source.
  2. checks each kernel against its plain PyTorch version on the card,
     bit for bit, at the main path's shapes (2^25 entries) and at edge
     cases; prints both median times.
  3. the main path: build_boss_from_codes on 2^25 random ACGT codes,
     k = 31 canonical and k = 20 basic; then annotates the k = 20 input
     split into 1000 labelled records and queries 2^15 reads of 100 bp.
     The kernels' launch counters are zeroed just before and read just
     after. Checks: real-edge counts against numpy, sorted edges, both
     kernels launched, every sampled read carries its record's label,
     CUDA label counts equal CPU counts on 512 reads, and at 2^16 codes
     the CUDA build equals the CPU build array for array.
  4. the CLI: build, annotate, query and stats with --device cuda.
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N_CODES = 1 << 25
SEED = 0


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps=5):
    """Median milliseconds of ``fn`` on the card (CUDA events), warm."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def max_abs_err(got, want):
    import torch
    err = 0
    for g, w in zip(got, want):
        g = torch.as_tensor(g).cpu().to(torch.int64)
        w = torch.as_tensor(w).cpu().to(torch.int64)
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g - w).abs().max()))
    return err


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def random_sorted_lanes(gen, n, L, dev, top_bits=28, n_valid=None):
    """(L, n) sorted lanes, the first ``n_valid`` random, PAD after."""
    import torch
    from metagraph_tpu_torch.common import packed
    n_valid = n if n_valid is None else n_valid
    x = torch.randint(-2**31, 2**31, (L, n_valid), generator=gen,
                      dtype=torch.int64, device=dev).to(torch.int32)
    x[0] &= (1 << top_bits) - 1
    x, _ = packed.sort(x)
    return packed.pad_to(x, n)


def check_partition(gen, dev, n, L, capacity, frac, E=1, time_it=False):
    import torch
    from metagraph_tpu_torch.common import merge
    x = torch.randint(-2**31, 2**31, (L, n), generator=gen,
                      dtype=torch.int64, device=dev).to(torch.int32)
    keep = torch.rand(n, generator=gen, device=dev) < frac
    extras = [torch.arange(n, dtype=torch.int32, device=dev)
              for _ in range(E)]
    got = merge.partition_compact(x, keep, capacity, *extras, extra_fill=-3)
    want = merge.partition_compact_plain(x, keep, capacity, *extras,
                                         extra_fill=-3)
    torch.cuda.synchronize()
    err = max_abs_err([got[0], got[1], *got[2]],
                      [want[0], want[1], *want[2]])
    if err:
        raise AssertionError(f"partition_compact n={n} L={L} cap={capacity}"
                             f": kernel differs from plain (err {err})")
    if not time_it:
        return err, None, None
    ms = cuda_ms(lambda: merge.partition_compact(x, keep, capacity, *extras))
    plain = cuda_ms(lambda: merge.partition_compact_plain(
        x, keep, capacity, *extras))
    return err, ms, plain


def check_merge(gen, dev, na, nb, L, time_it=False, a=None, b=None):
    import torch
    from metagraph_tpu_torch.common import merge
    a = random_sorted_lanes(gen, na, L, dev) if a is None else a
    b = random_sorted_lanes(gen, nb, L, dev) if b is None else b
    ea = (torch.arange(a.shape[1], dtype=torch.int32, device=dev),)
    eb = (torch.arange(a.shape[1], a.shape[1] + b.shape[1],
                       dtype=torch.int32, device=dev),)
    got, (gp,) = merge.merge_sorted(a, b, ea, eb)
    want, (wp,) = merge.merge_sorted_plain(a, b, ea, eb)
    torch.cuda.synchronize()
    err = max_abs_err([got, gp], [want, wp])
    if err:
        raise AssertionError(f"merge_sorted na={a.shape[1]} "
                             f"nb={b.shape[1]} L={L}: kernel differs from "
                             f"plain (err {err})")
    if not time_it:
        return err, None, None
    ms = cuda_ms(lambda: merge.merge_sorted(a, b, ea, eb))
    plain = cuda_ms(lambda: merge.merge_sorted_plain(a, b, ea, eb))
    return err, ms, plain


def phase_kernels(dev):
    import torch
    from metagraph_tpu_torch.common import packed
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    n = N_CODES
    summary = {}
    # main-path shapes: 2^25 windows, one int32 payload, half kept
    for L in (2, 3, 4):
        err, ms, plain = check_partition(gen, dev, n, L, n, 0.5,
                                         time_it=True)
        log(f"partition_compact L={L} N=2^25 keep=0.5: bit-exact, kernel "
            f"{ms:.3f} ms, plain {plain:.3f} ms (median of 5)")
        if L == 2:
            summary["partition_compact"] = (err, ms, plain)
    # merges: the dummy merge (|B| << |A|; k=20 basic has L=3, k=31
    # canonical L=4 over twice the edges) and the rc merge (|A| = |B|)
    for na, nb, L, what in ((n, 1 << 12, 3, "dummy merge, k=20 basic"),
                            (2 * n, 1 << 12, 4, "dummy merge, k=31 canon."),
                            (n, n, 4, "rc merge, k=31 canonical")):
        err, ms, plain = check_merge(gen, dev, na, nb, L, time_it=True)
        log(f"merge_sorted L={L} |A|={na} |B|={nb} ({what}): bit-exact, "
            f"kernel {ms:.3f} ms, plain {plain:.3f} ms (median of 5)")
        summary.setdefault("merge_sorted", (err, ms, plain))
    # edge cases, all bit-exact
    for args in ((n + 13, 3, n + 13, 0.5),       # N off the block size
                 (100003, 2, 1000, 0.7),          # capacity < count
                 (100003, 4, 300000, 0.2),        # capacity > N
                 (4096, 2, 4096, 0.0), (4096, 2, 4096, 1.0), (0, 2, 16, 0.5)):
        check_partition(gen, dev, *args, E=2)
    empty = packed.full_pad(0, 3, dev)
    some = random_sorted_lanes(gen, 70001, 3, dev)
    check_merge(gen, dev, 0, 0, 3, a=empty, b=some)
    check_merge(gen, dev, 0, 0, 3, a=some, b=empty)
    check_merge(gen, dev, 0, 0, 3, a=empty, b=empty)
    pad = packed.full_pad(50000, 2, dev)
    check_merge(gen, dev, 0, 0, 2, a=pad, b=pad)                 # all PAD
    dup_a = random_sorted_lanes(gen, 300000, 2, dev, top_bits=0,
                                n_valid=290000)
    dup_b = random_sorted_lanes(gen, 200000, 2, dev, top_bits=0)
    dup_a[1] &= 15                                               # few keys
    dup_b[1] &= 15
    dup_a, _ = packed.sort(dup_a)
    dup_b, _ = packed.sort(dup_b)
    check_merge(gen, dev, 0, 0, 2, a=dup_a, b=dup_b)             # duplicates
    log("edge cases (N off the block, capacity < count and > N, zero-width "
        "sides, all-PAD, heavy duplicates): bit-exact")
    return summary


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def gold_real_edges(codes, K, canonical):
    """numpy count of the distinct k-mers (canonical closure: both
    orientations, palindromes once)."""
    c = codes.astype(np.uint64) - np.uint64(1)           # ACGT -> 0..3
    nw = len(c) - K + 1
    fwd = np.zeros(nw, np.uint64)
    for j in range(K):
        fwd = (fwd << np.uint64(2)) | c[j:j + nw]
    if not canonical:
        return len(np.unique(fwd))
    rc = np.zeros(nw, np.uint64)
    for j in range(K - 1, -1, -1):
        rc = (rc << np.uint64(2)) | (np.uint64(3) - c[j:j + nw])
    canon = np.unique(np.minimum(fwd, rc))
    rc_canon = np.zeros_like(canon)
    x = canon.copy()
    for _ in range(K):
        rc_canon = (rc_canon << np.uint64(2)) | (np.uint64(3)
                                                 - (x & np.uint64(3)))
        x >>= np.uint64(2)
    pal = int(np.count_nonzero(rc_canon == canon))
    return 2 * len(canon) - pal


def check_graph(boss, codes, K, canonical):
    import torch
    from metagraph_tpu_torch.common import packed
    from metagraph_tpu_torch.kmer import packing
    lanes = boss.edge_lanes
    real = int((~packing.contains_sentinel(lanes, K, 4)).sum())
    gold = gold_real_edges(codes, K, canonical)
    if real != gold:
        raise AssertionError(f"k={K}: {real} real edges, numpy gold {gold}")
    if not bool(torch.all(packed.lt(lanes[:, :-1], lanes[:, 1:]))):
        raise AssertionError(f"k={K}: edge_lanes not strictly increasing")
    return real


def timed_build(codes, K, mode, dev):
    import torch
    from metagraph_tpu_torch.graph.boss_construct import build_boss_from_codes
    torch.cuda.synchronize()
    t0 = time.time()
    boss = build_boss_from_codes(codes, K, mode=mode, device=dev)
    torch.cuda.synchronize()
    return boss, time.time() - t0


def split_records(codes, n_rec):
    letters = np.frombuffer(b"$ACGT", np.uint8)
    bounds = np.linspace(0, len(codes), n_rec + 1).astype(np.int64)
    return [letters[codes[bounds[i]:bounds[i + 1]]].tobytes()
            for i in range(n_rec)]


def phase_main_path(dev):
    import torch
    from metagraph_tpu_torch.common import merge
    from metagraph_tpu_torch.engine.annotated_dbg import (
        AnnotatedDbg, BatchQuery, annotate_sequences)
    from metagraph_tpu_torch.graph.dbg_succinct import DbgSuccinct
    rng = np.random.default_rng(SEED)
    codes = rng.integers(1, 5, N_CODES).astype(np.uint8)   # bench_capacity

    merge.partition_launches = 0
    merge.merge_launches = 0
    results = {}
    for K, mode in ((31, "canonical"), (20, "basic")):
        boss, cold = timed_build(codes, K, mode, dev)
        del boss
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        boss, warm = timed_build(codes, K, mode, dev)
        peak = torch.cuda.max_memory_allocated() / 2**30
        real = check_graph(boss, codes, K, mode == "canonical")
        rate = (N_CODES - K + 1) / warm
        log(f"build k={K} {mode} 2^25 codes: {boss.num_edges} edges, "
            f"{real} real = numpy gold; cold {cold:.3f} s, warm "
            f"{warm:.3f} s = {rate / 1e6:.2f} M k-mers/s; peak device "
            f"memory {peak:.1f} GiB")
        results[K] = (warm, rate)
        if K == 31:
            del boss
            torch.cuda.empty_cache()

    graph = DbgSuccinct.from_boss(boss, mode="basic")
    records = split_records(codes, 1000)
    labels = [f"label_{i % 10}" for i in range(len(records))]
    t0 = time.time()
    ann = annotate_sequences(graph, [(s, [l]) for s, l in
                                     zip(records, labels)]).finalize()
    torch.cuda.synchronize()
    log(f"annotate: 1000 records, {ann.matrix.nnz} relations in "
        f"{time.time() - t0:.2f} s")

    n_reads, rl = 1 << 15, 100
    which = rng.integers(0, len(records), n_reads // 2)
    reads = []
    for r in which:
        off = int(rng.integers(0, len(records[r]) - rl + 1))
        reads.append(records[r][off:off + rl])
    letters = np.frombuffer(b"ACGT", np.uint8)
    reads += [letters[rng.integers(0, 4, rl)].tobytes()
              for _ in range(n_reads - len(reads))]
    bq = BatchQuery(AnnotatedDbg(graph=graph, annotation=ann))
    bq.get_labels_batch(reads[:256], 0.7)                   # warm
    torch.cuda.synchronize()
    t0 = time.time()
    got = bq.get_labels_batch(reads, 0.7)
    dt = time.time() - t0
    launches = {"partition_compact": merge.partition_launches,
                "merge_sorted": merge.merge_launches}
    for name, cnt in launches.items():
        if cnt <= 0:
            raise AssertionError(f"{name} was not launched by the main path")
    log(f"launch counts over the main path: {launches}")
    bad = [i for i, r in enumerate(which) if labels[r] not in got[i]]
    if bad:
        raise AssertionError(f"{len(bad)} sampled reads miss their label, "
                             f"e.g. read {bad[0]}: {got[bad[0]]}")
    n_lab = sum(1 for g in got[len(which):] if g)
    log(f"query: {n_reads} reads of {rl} bp in {dt:.3f} s = "
        f"{n_reads / dt:.0f} reads/s; all {len(which)} sampled reads carry "
        f"their record's label; {n_lab} of {n_reads - len(which)} random "
        f"reads labelled")

    # CUDA counts == CPU counts on 512 reads (CPU copies of the state)
    from metagraph_tpu_torch.anno.annotator import annotation_from_numpy
    from metagraph_tpu_torch.graph import io as graph_io
    anno_np = dict(ann.matrix.to_npz_dict(), labels=np.array(
        ann.encoder.labels))
    cpu = AnnotatedDbg(
        graph=graph_io.dbg_from_numpy(graph_io.graph_to_numpy(graph), "cpu"),
        annotation=annotation_from_numpy(anno_np, "cpu"))
    sub = reads[:256] + reads[-256:]
    cg, cw, cp = bq.label_count_matrix(sub)
    hg, hw, hp = BatchQuery(cpu).label_count_matrix(sub)
    if not (np.array_equal(cg, hg) and np.array_equal(cw, hw)
            and np.array_equal(cp, hp)):
        raise AssertionError("CUDA label counts differ from CPU counts")
    log("query: CUDA label counts equal CPU counts on 512 reads")
    del graph, boss, ann, bq, cpu
    torch.cuda.empty_cache()

    # the whole build, CUDA against CPU, array for array
    small = np.random.default_rng(SEED + 1).integers(
        1, 5, 1 << 16).astype(np.uint8)
    small[rng.integers(0, len(small), 200)] = 255            # read breaks
    for K, mode in ((20, "basic"), (31, "canonical")):
        from metagraph_tpu_torch.graph.boss_construct import (
            build_boss_from_codes)
        a = build_boss_from_codes(small, K, mode=mode, bits_per_count=8,
                                  device=dev)
        b = build_boss_from_codes(small, K, mode=mode, bits_per_count=8,
                                  device="cpu")
        for name in ("W", "last", "F", "NF", "weights", "edge_lanes"):
            x, y = getattr(a, name).cpu(), getattr(b, name).cpu()
            if not torch.equal(x, y):
                raise AssertionError(f"2^16 codes k={K} {mode}: CUDA {name} "
                                     f"differs from CPU")
    log("build at 2^16 codes: CUDA W, last, F, NF, weights, edge_lanes "
        "equal the CPU build (k=20 basic, k=31 canonical)")
    return launches, results


# ---------------------------------------------------------------------------
# phase 4: the CLI
# ---------------------------------------------------------------------------

def phase_cli(device):
    rng = np.random.default_rng(SEED + 2)
    letters = np.frombuffer(b"ACGT", np.uint8)
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory() as tmp:
        fa = os.path.join(tmp, "in.fa")
        names = [f"rec{i}" for i in range(200)]
        with open(fa, "w") as f:
            for name in names:
                seq = letters[rng.integers(0, 4, int(rng.integers(
                    200, 1000)))].tobytes().decode()
                f.write(f">{name}\n{seq}\n")
        g = os.path.join(tmp, "g")

        def run(*argv):
            res = subprocess.run(
                [sys.executable, "-m", "metagraph_tpu_torch.cli.main", *argv,
                 "--device", device], capture_output=True, text=True,
                env=env, cwd=tmp, timeout=600)
            if res.returncode != 0:
                raise AssertionError(f"CLI {argv[0]} exited "
                                     f"{res.returncode}:\n{res.stderr}")
            return res.stdout

        run("build", "-k", "31", "--mode", "canonical", "-o", g, fa)
        run("annotate", "-i", g, "--anno-header", fa)
        out = run("query", "-i", g, "-a", g + ".column.annodbg.npz", fa)
        stats = run("stats", g)
        lines = out.splitlines()
        want = [f"{i}\t{n}\t{n}" for i, n in enumerate(names)]
        if lines != want:
            raise AssertionError(f"CLI query output wrong: {lines[:3]}")
        if "mode: canonical" not in stats:
            raise AssertionError(f"CLI stats output wrong:\n{stats}")
    log(f"CLI build/annotate/query/stats --device {device}: exit 0; each of "
        f"{len(names)} records labelled with its own name")


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script needs one "
                         "NVIDIA GPU")
    sys.path.insert(0, HERE)
    from metagraph_tpu_torch.common import _cuda
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {name} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda})")
    log(smi)

    t0 = time.time()
    _cuda.lib()
    log(f"kernels built with nvcc from {_cuda.CSRC} and loaded in "
        f"{time.time() - t0:.2f} s")

    summary = phase_kernels(dev)
    launches, _ = phase_main_path(dev)
    phase_cli("cuda")

    kernels = []
    for kname, src, rep in (
            ("partition_compact", "metagraph_tpu_torch/csrc/partition.cu",
             "metagraph_tpu/common/merge.py:633"),
            ("merge_sorted", "metagraph_tpu_torch/csrc/merge.cu",
             "metagraph_tpu/common/merge.py:332")):
        err, ms, plain = summary[kname]
        kernels.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches[kname],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
