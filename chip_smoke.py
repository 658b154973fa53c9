#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the process exits non-zero):
  0. device: a CUDA device must be present; prints its name and power
     limit.
  1. builds the CUDA kernels of metagraph_tpu_torch/csrc from source.
  2. checks each kernel against its plain PyTorch version on the card,
     bit for bit, at the main path's shapes (2^25 entries for the build
     kernels, the sort at L = 2, 3, 4, 4 with a payload and 5, and on
     the lanes the k = 20 collect sorts, with the radix passes that ran;
     2^14 pairs of 112 x 128 for the alignment DP, whose wave route is
     timed in turns with its long route) and at edge cases; then the
     three build kernels at 5 to 8 lanes (the sort of the Protein k = 31
     collect's lanes with 0-2 payloads, partition and merges at 2^25,
     the sort's edge cases); past 8 lanes at 2^25 (sort_packed, one
     launch a call, at L = 9, 10, 12 and 16 with 0 and 2 payloads and
     its edge cases at L = 9 and 16; partition_compact in one launch and
     merge_sorted by merge-path tiles at L = 9, 12 and 16, the merge
     with |B| << |A| and |A| = |B|); and the
     DP with BLOSUM62 (sigma = 27) and a 32 x 32 table on both routes;
     prints the median times of the kernel, of its plain version and
     (where one exists) of one PyTorch library call, and its bound.
  3. the main paths, each with every kernel's launch counter zeroed just
     before and read just after it:
     a. build: build_boss_from_codes on 2^25 random ACGT codes, k = 31
        canonical and k = 20 basic; then annotates the k = 20 input split
        into 1000 labelled records and queries 2^15 reads of 100 bp.
        Checks: real-edge counts against numpy, sorted edges, the three
        build kernels launched, every sampled read carries its record's label,
        CUDA label counts equal CPU counts on 512 reads, and at 2^16 codes
        the CUDA build equals the CPU build array for array.
     b. align: Aligner.align_batch on the k = 20 graph, 2^13 reads of
        100 bp (3/4 one transversion, 1/8 an indel, 1/8 random), with
        CIGARs and score-only. Checks: >= 99 % of the substitution reads
        score 195 with one X and spell their source window, >= 99 % of
        the indel reads align, score-only agrees with the CIGAR run, the
        DP kernel launched; at 2^20 codes, 512 reads align identically on
        CUDA and on the CPU.
     c. primary: build_boss_from_codes(mode="primary") on the 2^25 codes
        at k = 31 (the finish over sorts of all real edges), then 100
        labelled records of 2^15 codes annotated and 2^13 reads of them
        and their reverse complements queried through CanonicalDbg.
        Checks: real edges =
        the numpy count of canonical forms, sorted edges, the three build
        kernels launched, every read and reverse complement labelled, and
        at 2^16 codes the CUDA build equals the CPU build.
     d. KMC: a KMC2 database of the forward k = 31 k-mers of 2^24 codes
        with their counts, read by seqio/kmc.py and built by
        collect_counted_kmers + build_boss_from_kmers; the graph must equal
        build_boss_from_codes on those codes, the build kernels launched.
     e. the rest of the surface. In 3a: a count annotation of its 1000
        records and its 2^15 reads through --query-counts,
        --count-quantiles "0 0.5 1" and --print-signature (every sampled
        read reports its label; CUDA equals CPU on 512 reads), and
        stats --validate --count-dummy on its k = 20 graph (OK; dummy
        counts equal numpy's). In 3c: 2^13 reads of its records and
        reverse complements, one transversion each, aligned on the
        primary graph with CIGARs and score-only (>= 99 % score 195 and
        spell the unmutated read; pallas_dp launched; CUDA equals CPU on
        512 reads of a 2^18-code primary graph). On its own: a
        count-sidecar build at k = 31 canonical of 256 contigs of the
        first 2^22 codes with counts 1-300 (weights equal a numpy gold
        that sums and saturates; the three build kernels launched).
     f. the other alphabets and the small state. Protein at k = 31 (8
        lanes), basic: 2^25 residues as 1000 records (real edges = the
        valid windows, stats --validate, CUDA = CPU on 2^18 codes), the
        records annotated, 2^15 reads queried, 2^13 reads with one
        substitution aligned (>= 99 % score the BLOSUM62 sum of their
        window with one X; score-only = CIGARs; pallas_dp launched).
        DNA5 k = 31 canonical (the 2^25 codes, 1 % N) and DNACaseSent
        k = 31 primary (alternate runs of 1000 in lower case): stats
        --validate at full size, CUDA = CPU on 2^18 codes. In 3a: the
        k = 20 graph saved small (a smaller file than the fast one,
        which the script stores without zlib), its 2^15 reads' labels,
        3b's first 2^12 alignments and every row's decode identical to
        the fast state's.
     g. the graph algorithms. At k = 31 canonical on the 2^25 codes,
        through the functions assemble and transform call: unitigs by
        pointer doubling (a canonical build of them equals the graph),
        contigs (their windows are every node once), the compacted GFA
        (L lines = predecessors). clean through the CLI on 2^25 read
        characters of a 2^20-base genome with 1 % substitutions
        (build --count-kmers; clean --prune-tips 62 --prune-unitigs 0
        --fallback 2 --to-fasta, then with --count-slice-quantiles):
        >= 99 % of the genome k-mers and <= 1 % of the error k-mers
        kept, the card's files on the first 2^14 reads equal the CPU
        run's. In 3a: differential assembly (label_0 in, label_1 out)
        by unitigs and by nodes equal to a numpy gold, and through the
        CLI; transform --state small, whose assemble --unitigs equals
        the fast graph's; align -o paths.gfa (plain and --compacted)
        for 2^10 of 3b's reads; compare; transform --to-gfa and
        --to-adj-list of the first 2^20 codes' graph. merge and extend
        of k = 31 --count-kmers graphs of the halves of 1000 records of
        the first 2^21 codes: merge equals the whole build (weights =
        numpy gold), basic extend too; canonical extend equals the CPU
        run on 2^16 codes (the reference's duplicates).
     h. annotation compression and coordinates, on 3a's k = 20 graph
        (33.5 M rows): its label_{i % 10} annotation to row_diff,
        row_diff_brwt, brwt relaxed to arity 8, unique_row and rb_brwt;
        3e's count annotation to int_row_diff, int_brwt and
        row_diff_int_brwt; the records as rec_{i} (1000 columns) to brwt
        (a linkage product over 10^6 sampled rows); the label_{i % 10}
        coordinates (annotate_coordinates) as column_coord and
        row_diff_coord. Per form: transform seconds, stored nnz against
        the column's, query reads/s against the column form's (2^15
        reads for row_diff and row_diff_brwt, 2^13 for the rest) and
        peak device memory (the forms' files are not written: their
        bytes are fixed by the data and format, PERF.md). Checks: each
        form answers as its column
        form read for read (labels; --query-counts and quantiles;
        coordinates, which equal a numpy gold), the row-diff builds
        launch sort_packed and partition_compact, and at a 2^18-code
        prefix every form built on the card equals the CPU build. The
        row API of each form (get_rows_dense and sum_rows; the integer
        forms' get_row_values_dense and sum_row_values) on 2^12 rows,
        half without a bit, equals its column form's (the walked forms'
        calls launch sort_packed and partition_compact); AnnotatedDbg's
        per-sequence queries of 64 of 3a's reads over the label column
        and row_diff_brwt forms equal the BatchQuery answers (their
        reads/s one at a time against the batch logged). Before 3h, the
        BOSS navigation calls (get_last, succ_last, succ_W, rank0) on
        2^16 random positions of the k = 20 graph equal a nonzero /
        searchsorted gold, and index_range_nodes holds 2^16 edges.
     i. the scale-out builds, each held bit for bit against 3a's
        in-core graphs: build_boss_out_of_core at k = 20 basic over 8
        shards and 4 pass-1 runs of 2^23 + 64 codes (its peak device
        memory at most half of 3a's in-core k = 20 peak, both measured in
        this run); build_boss_streaming at k = 31 canonical with its runs
        spilled to a directory (2^23-code chunks, as build --disk-swap
        --mem-cap-gb 0.125); build_boss_sharded at k = 20 with suffix
        length 2 (16 buckets through the suffix filter); the out-of-core
        merge (4 shards) of 3g's two halves against their in-memory
        merge; in 3a, after 3h: the staged row_diff (transform_anno
        --disk-swap, build_row_diff_staged, a 128 MiB spill cap that
        makes 2 runs) of 3a's label_{i % 10} annotation, equal to 3h's
        in-memory row_diff. The three build kernels must launch there.
     serve. In 3a, after 3h: the k = 20 graph (33.5 M rows) served from
        this process (server/http_server.py serve, background) with
        3a's label_{i % 10} column annotation, 3h's row_diff_brwt form
        of it and 3e's count annotation; 4 client threads each send 8
        POST /search of 2^10 of 3a's reads to the column and to the
        row_diff_brwt server; then, 4 times each, one at a time:
        /search of 2^10 reads (column server), /search with_signature,
        /search align and /align (2^8 of 3b's
        reads), /search abundance_sum (count server), GET /stats and
        /column_labels. Every response equals the answer built in this
        process from BatchQuery / Aligner; the row_diff_brwt server
        launches sort_packed and partition_compact. Logs requests/s,
        reads/s and p50 / p99 latency per endpoint.
     wide. 3a's 2^25 codes at k = 65, canonical (9 lanes), cold and
        warm: real edges equal a host gold (the distinct forward windows
        and their reverse complements); the
        three build kernels launched; at 2^18 codes the card's build
        equals the CPU's array for array.
     j. the distributed build (parallel/distributed.py, multihost.py):
        build_boss_distributed_full on 3a's 2^25 codes at k = 31
        canonical and k = 20 basic, cold then warm, at width 1 over
        NCCL, width 4 as four processes sharing the card over gloo
        (staged through host memory) and, where there are four cards,
        width 4 over NCCL one card a rank; rank 0 is this process.
        Checks: rank 0's graph equals 3a's array for array (on the
        card), every other rank's digest equals rank 0's, partition,
        merge and sort launch on every rank. Logs walls, edges and peak
        memory per rank, bytes, rows and host seconds per route, the
        transport and the launches per rank. Then 3g's reads as FASTA
        through seqio/fasta.py read_and_encode (the native codec,
        native/) and its Python parser: equal codes, both timed.
  4. the CLI (build, stats and align in processes of their own, the
     rest through its main in this process): build (of one file: it
     must read through the native codec, and its graph must equal the
     build of the same records from two files), annotate, query,
     query --align, align (TSV and --json) and stats with --device
     cuda; build --mode primary, stats,
     annotate and query (records and reverse complements) on it; build
     from a KMC database with --min-count 2; then, in this process, each
     flag of 3e: builds of two files, of a stdin list, with
     --fwd-and-reverse and from count sidecars, the stats flags, the
     annotate header flags, the three query modes and align / query
     --align on the primary graph; then build --alphabet Protein / DNA5
     --mode canonical / DNACaseSent --mode primary with stats, annotate,
     query and align, and build --state small, whose stats --print,
     query and align equal the fast graph's; then the annotation
     commands on the canonical graph: transform_anno to seven forms,
     relax_brwt, merge_anno, coordinate, query over each (labels,
     --query-counts, --query-coords) and stats; then the scale-out
     commands on the card and the CPU: build --suffix-len 1
     --parts-total 2 --part-idx 0/1 with concatenate, build --disk-swap,
     build --num-shards 4, merge --num-shards 2, coordinator with two
     worker processes (card), build --reference from a VCF and its
     .vcf.gz, each graph's stats equal to the direct build's; and
     server_query on the canonical graph in a process of its own, query
     --address against it (each record labelled with its own name), and
     build -v (the construct and serialize spans on stderr).
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}.
"""

import contextlib
import io
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
PROTEIN_LETTERS = b"ACDEFGHIKLMNPQRSTVWY"


T_START = time.time()


def log(msg):
    print(f"[{time.time() - T_START:7.1f} s] {msg}", flush=True)


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
    """The largest absolute difference, compared where the tensors lie
    (on the card: no copy of 2^25-entry lanes to the host), one lane at
    a time."""
    import torch
    err = 0
    for g, w in zip(got, want):
        g, w = torch.as_tensor(g), torch.as_tensor(w)
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if not g.numel():
            continue
        rows = g.shape[0] if g.dim() > 1 else 1
        for gi, wi in zip(g.reshape(rows, -1), w.to(g.device).reshape(rows,
                                                                      -1)):
            err = max(err, int((gi.to(torch.int64) - wi.to(torch.int64))
                               .abs().max()))
    return err


# H100 SXM peaks (NVIDIA data sheet / Hopper white paper) at a 700 W limit
HBM_BYTES_PER_S = 3.35e12
# 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def bound(nbytes, ops=0):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    int32 operations over the ALU rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


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
        return err
    ms = cuda_ms(lambda: merge.partition_compact(x, keep, capacity, *extras))
    plain = cuda_ms(lambda: merge.partition_compact_plain(
        x, keep, capacity, *extras))
    # library yardstick: a boolean-mask gather of the stacked lanes and
    # payloads (compacts, but writes no PAD / extra_fill tail)
    stacked = torch.cat([x] + [e[None] for e in extras])
    lib_ms = cuda_ms(lambda: stacked[:, keep])
    # lanes + payloads + keep read once; lanes + payloads + count written
    nbytes = (4 * (L + E) + 1) * n + 4 * (L + E) * capacity + 4
    return err, ms, plain, lib_ms, bound(nbytes)


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
        return err
    ms = cuda_ms(lambda: merge.merge_sorted(a, b, ea, eb))
    plain = cuda_ms(lambda: merge.merge_sorted_plain(a, b, ea, eb))
    # keys + payload of A and B read once, the merged ones written once
    ntot = a.shape[1] + b.shape[1]
    return err, ms, plain, None, bound(2 * 4 * (L + 1) * ntot)


def check_sort(gen, dev, n, L, E, time_it=False, x=None):
    """sort_packed against its plain version, lanes and payloads bit for
    bit (both are stable, so payload order is fixed)."""
    import torch
    from metagraph_tpu_torch.common import merge, packed
    if x is None:
        x = torch.randint(-2**31, 2**31, (L, n), generator=gen,
                          dtype=torch.int64, device=dev).to(torch.int32)
    L, n = x.shape
    extras = [torch.randint(-2**31, 2**31, (n,), generator=gen,
                            dtype=torch.int64, device=dev).to(torch.int32)
              for _ in range(E)]
    got, ge = merge.sort_packed(x, *extras)
    want, we = merge.sort_packed_plain(x, *extras)
    torch.cuda.synchronize()
    err = max_abs_err([got, *ge], [want, *we])
    if err:
        raise AssertionError(f"sort_packed n={n} L={x.shape[0]} E={E}: "
                             f"kernel differs from plain (err {err})")
    if not time_it:
        return err
    ms = cuda_ms(lambda: merge.sort_packed(x, *extras))
    plain = cuda_ms(lambda: merge.sort_packed_plain(x, *extras))
    lib_ms = None
    if L <= 2 and not E:
        # library yardstick: one stable torch.sort of the fused int64 key
        # (two lanes fit one key; more lanes or a payload need more calls)
        (key,) = packed._sort_keys(x)
        lib_ms = cuda_ms(lambda: torch.sort(key, stable=True))
    # lanes + payloads read once and written once
    return err, ms, plain, lib_ms, bound(2 * (4 * L + 4 * E) * n)


def collect_lanes(dev, K):
    """The (2, N - K + 1) lanes that _collect sorts for a basic build of
    the 2^25 codes: 2-bit windows, PAD at invalid ones."""
    import torch
    from metagraph_tpu_torch.common import packed
    from metagraph_tpu_torch.kmer import packing
    from metagraph_tpu_torch.kmer.extractor import window_validity
    codes = torch.from_numpy(np.random.default_rng(SEED).integers(
        1, 5, N_CODES).astype(np.uint8)).to(dev)
    ok = window_validity(codes, K)
    lanes2 = packing.pack_windows((codes - 1) & 3, K, 2)
    return torch.where(ok[None, :], lanes2, packed.PAD_LANE).contiguous()


def phase_sort(gen, dev):
    """sort_packed at the main path's shapes (the collect's L = 2, the
    sort-based finish's L = 4, the KMC stage's L = 4 with one payload;
    L = 3 and 5 beside them) and at edge cases, all bit-exact; returns
    the L = 2 summary."""
    import torch
    from metagraph_tpu_torch.common import merge, packed
    n = N_CODES
    summary = None
    for L, E, what in ((2, 0, "collect, 2-bit domain"),
                       (3, 0, "k=20 edge keys, random"),
                       (4, 0, "finish keys, k=31"),
                       (4, 1, "KMC sort-unique / rc half, k=31"),
                       (5, 0, "DNA5 k=33-40, random")):
        res = check_sort(gen, dev, n, L, E, time_it=True)
        err, ms, plain, lib_ms, (bms, _) = res
        lib = f"{lib_ms:.3f} ms" if lib_ms is not None else "none"
        log(f"sort_packed L={L} E={E} N=2^25 ({what}; "
            f"{merge.sort_route(L, E)} route): bit-exact, kernel "
            f"{ms:.3f} ms, plain {plain:.3f} ms, library torch.sort of the "
            f"fused key {lib}, bound {bms:.3f} ms (median of 5)")
        summary = summary or res
    # the lanes _collect hands to _sort_unique_ones_body at k = 20 (2 bits
    # per char: 40 bits in two lanes), where constant digits drop
    lanes = collect_lanes(dev, 20)
    p0 = merge.sort_digit_passes
    merge.sort_packed(lanes)
    passes = merge.sort_digit_passes - p0
    err, ms, plain, lib_ms, (bms, _) = check_sort(gen, dev, 0, 0, 0,
                                                  time_it=True, x=lanes)
    log(f"sort_packed L=2 N={lanes.shape[1]} (the k=20 collect's lanes): "
        f"bit-exact, {passes} of 8 digit passes run, kernel {ms:.3f} ms, "
        f"plain {plain:.3f} ms, library torch.sort of the fused key "
        f"{lib_ms:.3f} ms, bound {bms:.3f} ms (median of 5)")
    del lanes
    tile = merge._cuda.lib().mg_sort_tile()
    for m in (0, 1, 2, tile - 1, tile, tile + 1, 5 * tile + 100,
              (1 << 20) + 13):
        check_sort(gen, dev, m, 3, 2)
    m = 100_003
    check_sort(gen, dev, 0, 0, 1, x=packed.lanes_from_numpy(
        np.full((3, m), 77, np.uint32), dev))     # all equal: stability
    check_sort(gen, dev, 0, 0, 1, x=packed.full_pad(m, 2, dev))   # all PAD
    x = torch.randint(0, 9, (4, 1 << 20), generator=gen, device=dev,
                      dtype=torch.int32)
    x, _ = merge.sort_packed_plain(x)
    check_sort(gen, dev, 0, 0, 2, x=x)                             # sorted
    check_sort(gen, dev, 0, 0, 2, x=x.flip(1).contiguous())      # reversed
    # constant digits (passes skipped) with PAD mixed in, and non-PAD keys
    # that read 0xFF on every digit that runs
    x = torch.randint(0, 1 << 16, (3, m), generator=gen, device=dev,
                      dtype=torch.int32)
    x[:2] = 0x01020304
    x[:, torch.rand(m, generator=gen, device=dev) < 0.1] = packed.PAD_LANE
    check_sort(gen, dev, 0, 0, 1, x=x)
    x[:2] = 0
    x[2] = torch.randint(0, 3, (m,), generator=gen, device=dev,
                         dtype=torch.int32) * 0x7F7F7F7F
    x[2, torch.rand(m, generator=gen, device=dev) < 0.2] = packed.PAD_LANE
    x[:, torch.rand(m, generator=gen, device=dev) < 0.2] = packed.PAD_LANE
    check_sort(gen, dev, 0, 0, 2, x=x)
    log(f"sort_packed edge cases (N = 0, 1, 2, tile - 1, tile, tile + 1, "
        f"5 tiles + 100, 2^20 + 13 with tile = {tile} at L = 3; all keys "
        f"equal, all PAD, sorted and reversed with duplicates, constant "
        f"digits with PAD, keys 0xFF on every digit that runs; 1-2 "
        f"payloads): bit-exact")
    return summary


def protein_lanes(n, K, dev, seed):
    """The (L, n - K + 1) lanes of every K-window of n random amino acid
    codes (1..26 of the 8-bit Protein alphabet, 20 of them used): what
    the Protein collect extracts."""
    import torch
    from metagraph_tpu_torch.kmer import packing
    from metagraph_tpu_torch.kmer.alphabets import PROTEIN
    tbl = PROTEIN.encode_table()
    codes = tbl[np.frombuffer(PROTEIN_LETTERS, np.uint8)[
        np.random.default_rng(seed).integers(0, 20, n)]]
    return packing.pack_windows(torch.from_numpy(codes).to(dev), K, 8)


def phase_wide_lanes(gen, dev):
    """3f's kernels at 5 to 8 lanes (DNA5 / DNACaseSent at k = 33-64,
    Protein at k = 17-32), never launched before this slice: the sort's
    12-key tile, its shared staging and digit plan, the partition and
    the merge, each against its plain version at 2^25 with 0-2 payloads
    and PAD, and at the sort's edge cases; L = 8 timed beside L = 4
    (phase 2 above)."""
    import torch
    from metagraph_tpu_torch.common import merge, packed
    n = N_CODES
    # the Protein k = 31 collect's lanes: 248 bits in 8 lanes, the top
    # byte always 0 (its digit is skipped), PAD at a few windows
    x = protein_lanes(n + 30, 31, dev, SEED + 5)
    x[:, torch.rand(n, generator=gen, device=dev) < 0.01] = packed.PAD_LANE
    p0 = merge.sort_digit_passes
    merge.sort_packed(x)
    passes = merge.sort_digit_passes - p0
    for E in (0, 1, 2):
        err, ms, plain, _, (bms, _) = check_sort(gen, dev, 0, 0, E,
                                                 time_it=True, x=x)
        log(f"sort_packed L=8 E={E} N=2^25 (the Protein k=31 collect's "
            f"lanes, 1 % PAD; {merge.sort_route(8, E)} route): bit-exact, "
            f"{passes} of 32 digit passes run, kernel {ms:.3f} ms, plain "
            f"{plain:.3f} ms, bound {bms:.3f} ms (median of 5)")
    for L in (5, 6, 7, 8):
        res = check_partition(gen, dev, n, L, n, 0.5, time_it=L == 8)
        if L == 8:
            err, ms, plain, lib_ms, (bms, _) = res
            log(f"partition_compact L=8 N=2^25 keep=0.5: bit-exact, kernel "
                f"{ms:.3f} ms, plain {plain:.3f} ms, library x[:, keep] "
                f"{lib_ms:.3f} ms, bound {bms:.3f} ms (median of 5)")
        check_partition(gen, dev, 100003, L, 1000, 0.7, E=2)
        check_partition(gen, dev, n + 13, L, n + 13, 0.5, E=2)
        if L < 8:
            check_sort(gen, dev, n, L, L % 3)
        tile = merge._cuda.lib().mg_sort_tile()
        for m in (0, 1, tile - 1, tile, tile + 1, 5 * tile + 100):
            check_sort(gen, dev, m, L, 2)
        m = 100_003
        check_sort(gen, dev, 0, 0, 2, x=packed.lanes_from_numpy(
            np.full((L, m), 77, np.uint32), dev))      # all equal
        check_sort(gen, dev, 0, 0, 1, x=packed.full_pad(m, L, dev))
        y = torch.randint(0, 9, (L, 1 << 20), generator=gen, device=dev,
                          dtype=torch.int32)
        y, _ = merge.sort_packed_plain(y)
        check_sort(gen, dev, 0, 0, 2, x=y)                           # sorted
        check_sort(gen, dev, 0, 0, 1, x=y.flip(1).contiguous())    # reversed
        y = torch.randint(0, 1 << 16, (L, m), generator=gen, device=dev,
                          dtype=torch.int32)
        y[:L - 1] = 0x01020304                       # constant digits
        y[L - 1] = torch.randint(0, 3, (m,), generator=gen, device=dev,
                                 dtype=torch.int32) * 0x7F7F7F7F
        y[:, torch.rand(m, generator=gen, device=dev) < 0.2] = \
            packed.PAD_LANE
        check_sort(gen, dev, 0, 0, 2, x=y)           # 0xFF digits and PAD
        a = random_sorted_lanes(gen, n, L, dev)
        check_merge(gen, dev, 0, 0, L, a=a,
                    b=random_sorted_lanes(gen, 1 << 12, L, dev))
        check_merge(gen, dev, 0, 0, L, a=random_sorted_lanes(
            gen, 300000, L, dev, n_valid=290000),
            b=random_sorted_lanes(gen, 200000, L, dev))
        del a
    for na, nb, what in ((n, 1 << 12, "dummy merge, Protein k=31"),
                         (n, n, "merge of equal halves")):
        err, ms, plain, _, (bms, _) = check_merge(gen, dev, na, nb, 8,
                                                  time_it=True)
        log(f"merge_sorted L=8 |A|={na} |B|={nb} ({what}): bit-exact, "
            f"kernel {ms:.3f} ms, plain {plain:.3f} ms, bound {bms:.3f} ms "
            f"(median of 5)")
    log("L = 5, 6, 7, 8 (sort at 2^25 with L mod 3 payloads, partition at "
        "2^25 and 2^25 + 13 and with capacity < count, merges of 2^25 + "
        "2^12 and with PAD tails; the sort at N = 0, 1, tile - 1, tile, "
        "tile + 1, 5 tiles + 100, all keys equal, all PAD, sorted, "
        "reversed, constant digits with 0xFF digits and PAD; 0-2 "
        "payloads): bit-exact")
    del x
    torch.cuda.empty_cache()


def wide_lanes(gen, n, L, dev, pad=0.01):
    """(L, n) random lanes with PAD at ``pad`` of the columns and equal
    keys in the high lanes (values 0-3), so that the high lanes decide
    some order too."""
    import torch
    from metagraph_tpu_torch.common import packed
    x = torch.randint(-2**31, 2**31, (L, n), generator=gen,
                      dtype=torch.int64, device=dev).to(torch.int32)
    x[: L // 2] &= 3
    x[:, torch.rand(n, generator=gen, device=dev) < pad] = packed.PAD_LANE
    return x


def sort_edge_cases(gen, dev, L):
    """The index route's edges at L lanes, bit-exact with 0-2 payloads:
    N around its tile, all keys equal, all PAD, a constant middle lane
    (never read) with PAD, duplicates in every lane; one sort launch a
    call."""
    import torch
    from metagraph_tpu_torch.common import merge, packed
    tile = merge._cuda.lib().mg_sort_tile()
    for m in (0, 1, tile - 1, tile, tile + 1, 5 * tile + 100):
        check_sort(gen, dev, m, L, 2)
    m = 100_003
    check_sort(gen, dev, 0, 0, 1, x=packed.lanes_from_numpy(
        np.full((L, m), 77, np.uint32), dev))
    check_sort(gen, dev, 0, 0, 2, x=packed.full_pad(m, L, dev))
    y = torch.randint(0, 4, (L, m), generator=gen, device=dev,
                      dtype=torch.int32)
    y[L // 2] = -1                           # all ones, never a digit
    y[:, torch.rand(m, generator=gen, device=dev) < 0.1] = packed.PAD_LANE
    p0, s0 = merge.sort_digit_passes, merge.sort_launches
    check_sort(gen, dev, 0, 0, 2, x=y)
    if merge.sort_digit_passes - p0 != L - 1 or merge.sort_launches - s0 != 1:
        raise AssertionError(f"sort_packed L={L}, a constant middle lane: "
                             f"{merge.sort_digit_passes - p0} digit passes "
                             f"(want {L - 1}), "
                             f"{merge.sort_launches - s0} launches")


def phase_past_eight_lanes(gen, dev):
    """The build kernels past 8 lanes (k > 64 over the 4-bit alphabets,
    k > 32 over Protein), at 2^25 entries, bit for bit against the plain
    versions: sort_packed (the index route, one launch a call) at L = 9,
    10, 12 and 16 with 0 and 2 payloads and its edge cases at L = 9 and
    16; partition_compact (one launch) and merge_sorted (merge-path
    tiles: a splits launch, then a tile launch) at L = 9, 12 and 16, the
    merge with |B| << |A| and |A| = |B|; logs the kernel's, the plain
    version's, the library's and the bound's ms."""
    import torch
    from metagraph_tpu_torch.common import merge
    n = N_CODES
    for L in (9, 10, 12, 16):
        x = wide_lanes(gen, n, L, dev)
        for E in (0, 2):
            s0 = merge.sort_launches
            err, ms, plain, _, (bms, _) = check_sort(
                gen, dev, 0, 0, E, time_it=True, x=x)
            log(f"sort_packed L={L} E={E} N=2^25 ({merge.sort_route(L, E)} "
                f"route, 1 % PAD): bit-exact, kernel {ms:.3f} ms, plain "
                f"{plain:.3f} ms, bound {bms:.3f} ms (median of 5)")
            if merge.sort_launches - s0 != 7:    # check, warm-up, 5 timed
                raise AssertionError(f"sort_packed L={L}: "
                                     f"{merge.sort_launches - s0} launches "
                                     f"for 7 calls")
        if L in (9, 16):
            sort_edge_cases(gen, dev, L)
        if L != 10:
            res = check_partition(gen, dev, n, L, n, 0.5, E=1, time_it=True)
            check_partition(gen, dev, 100003, L, 1000, 0.7, E=2)
            err, ms, plain, lib_ms, (bms, _) = res
            log(f"partition_compact L={L} N=2^25 keep=0.5 (one launch): "
                f"bit-exact, kernel {ms:.3f} ms, plain {plain:.3f} ms, "
                f"library x[:, keep] {lib_ms:.3f} ms, bound {bms:.3f} ms "
                f"(median of 5)")
            one = merge.partition_launches
            merge.partition_compact(x, x[0] > 0, n)
            if merge.partition_launches - one != 1:
                raise AssertionError(f"partition_compact L={L}: "
                                     f"{merge.partition_launches - one} "
                                     f"launches for one call")
            a, _ = merge.sort_packed_plain(x)
            for nb, what in ((1 << 12, "|B| << |A|"), (n, "|A| = |B|")):
                b, _ = merge.sort_packed_plain(
                    wide_lanes(gen, nb, L, dev))
                err, ms, plain, _, (bms, _) = check_merge(
                    gen, dev, 0, 0, L, time_it=True, a=a, b=b)
                log(f"merge_sorted L={L} |A|={n} |B|={nb} ({what}, "
                    f"merge-path tiles): bit-exact, kernel {ms:.3f} ms, "
                    f"plain {plain:.3f} ms, bound {bms:.3f} ms (median "
                    f"of 5)")
                del b
            del a
        del x
        torch.cuda.empty_cache()
    log("sort_packed edge cases at L = 9 and 16 (N = 0, 1, tile - 1, tile, "
        "tile + 1, 5 tiles + 100; all equal, all PAD, a constant middle "
        "lane that no pass reads; one launch a call): bit-exact")


def phase_kernels(dev):
    import torch
    from metagraph_tpu_torch.common import packed
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    n = N_CODES
    summary = {}
    # main-path shapes: 2^25 windows, one int32 payload, half kept
    for L in (2, 3, 4):
        res = check_partition(gen, dev, n, L, n, 0.5, time_it=True)
        err, ms, plain, lib_ms, (bms, _) = res
        log(f"partition_compact L={L} N=2^25 keep=0.5: bit-exact, kernel "
            f"{ms:.3f} ms, plain {plain:.3f} ms, library x[:, keep] "
            f"{lib_ms:.3f} ms, bound {bms:.3f} ms (median of 5)")
        if L == 2:
            summary["partition_compact"] = res
    # merges: the dummy merge (|B| << |A|; k=20 basic has L=3, k=31
    # canonical L=4 over twice the edges) and the rc merge (|A| = |B|)
    for na, nb, L, what in ((n, 1 << 12, 3, "dummy merge, k=20 basic"),
                            (2 * n, 1 << 12, 4, "dummy merge, k=31 canon."),
                            (n, n, 4, "rc merge, k=31 canonical")):
        res = check_merge(gen, dev, na, nb, L, time_it=True)
        err, ms, plain, _, (bms, _) = res
        log(f"merge_sorted L={L} |A|={na} |B|={nb} ({what}): bit-exact, "
            f"kernel {ms:.3f} ms, plain {plain:.3f} ms, bound {bms:.3f} ms "
            f"(median of 5)")
        summary.setdefault("merge_sorted", res)
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
    summary["sort_packed"] = phase_sort(gen, dev)
    phase_wide_lanes(gen, dev)
    phase_past_eight_lanes(gen, dev)
    summary["pallas_dp"] = phase_align_dp(dev)
    return summary


def dp_pairs(rng, R, LQ, LR, dev, copy_frac=0.25):
    """R random (query, ref) pairs, lengths uniform in [0, LQ] / [0, LR],
    a ``copy_frac`` share of the refs copied from their queries (with one
    substitution) so that the scores vary."""
    import torch
    q = rng.integers(1, 5, (R, LQ)).astype(np.int32)
    r = rng.integers(1, 5, (R, LR)).astype(np.int32)
    n = min(LQ, LR)
    cp = rng.random(R) < copy_frac
    r[cp, :n] = q[cp, :n]
    r[cp, rng.integers(0, LR)] = 2
    ql = rng.integers(0, LQ + 1, R).astype(np.int32)
    rl = rng.integers(0, LR + 1, R).astype(np.int32)
    return [torch.from_numpy(x).to(dev) for x in (q, r, ql, rl)]


def check_dp(args, what, sub_tt=None, **pen):
    import torch
    from metagraph_tpu_torch.align import pallas_dp
    pen = dict(dict(match=2, tpen=3, tvpen=3, open_p=5, ext_p=2), **pen)
    got = pallas_dp.batch_align_ends(*args, sub_tt=sub_tt, **pen)
    scores = pallas_dp.batch_align_scores(*args, sub_tt=sub_tt, **pen)
    table = pallas_dp.score_table(pen["match"], pen["tpen"], pen["tvpen"],
                                  sub_tt, args[0].device)
    want = pallas_dp.align_plain(*args, table, pen["open_p"], pen["ext_p"],
                                 True)
    torch.cuda.synchronize()
    err = max_abs_err([got, scores], [want, want[:, 0]])
    if err:
        raise AssertionError(f"batch_align {what}: kernel differs from plain "
                             f"(err {err})")
    return err


def dp_routes():
    from metagraph_tpu_torch.align import pallas_dp
    return (pallas_dp.dp_launches - pallas_dp.dp_long_launches,
            pallas_dp.dp_long_launches)


def phase_align_dp(dev):
    """pallas_dp against its plain version: the main path's shape and the
    edge cases, bit-exact for the ends and the scores, on both routes;
    the wave route timed beside the long route (the first design) on the
    same pairs."""
    from metagraph_tpu_torch.align import pallas_dp
    rng = np.random.default_rng(SEED + 3)
    R, LQ, LR = 1 << 14, 112, 128
    args = dp_pairs(rng, R, LQ, LR, dev)
    err = check_dp(args, "main shape")
    table = pallas_dp.score_table(2, 3, 3, None, dev)

    def run(wave):
        return pallas_dp._align_cuda(*args, table, 5, 2, True, wave)

    old = run(False)
    if max_abs_err([old], [run(True)]):
        raise AssertionError("pallas_dp: the long route differs from the "
                             "wave route at the main shape")
    # launch-only times in turns: wave, long, long, wave
    times = [cuda_ms(lambda w=w: run(w)) for w in (True, False, False, True)]
    # the kernels line keeps the wrapper's time (table built and uploaded
    # on each call), which takes the wave route at this shape
    ms = cuda_ms(lambda: pallas_dp.batch_align_ends(*args))
    plain = cuda_ms(lambda: pallas_dp.align_plain(*args, table, 5, 2, True))
    cells = pallas_dp.dp_cells(args[2], args[3], LQ, LR)
    nbytes = 4 * R * (LQ + LR + 2 + 3)
    bms, by = bound(nbytes, cells * pallas_dp.OPS_PER_CELL)
    log(f"pallas_dp ends R=2^14 LQ={LQ} LR={LR} ({cells} cells): bit-exact "
        f"(ends and scores, both routes); batch_align_ends (wave route, "
        f"with its table upload) {ms:.3f} ms; launch only, in turns, wave "
        f"route {times[0]:.3f} / {times[3]:.3f} ms, long route (the first "
        f"design) {times[1]:.3f} / {times[2]:.3f} ms; plain {plain:.3f} ms; "
        f"bound {bms:.4f} ms (median of 5)")
    w0, l0 = dp_routes()
    for R in (1, 7, 33):
        check_dp(dp_pairs(rng, R, 40, 50, dev), f"R={R}")
    q, r, ql, rl = dp_pairs(rng, 40, 30, 30, dev)
    ql[:5], rl[5:10] = 0, 0                       # qlen 0, rlen 0
    r[10:20], ql[10:20], rl[10:20] = q[10:20], 30, 30   # identical: ties
    q[20:25], r[20:25] = 0, 0                     # all-0 codes
    check_dp([q, r, ql, rl], "edge rows")
    check_dp(dp_pairs(rng, 50, 1, 60, dev), "LQ=1")
    # every band of the wave route and the first width of the long one:
    # qlen + 1 = 32, 33, 64, 65, 128, 129, 256 and 257 on every other pair
    for rows in (32, 33, 64, 65, 128, 129, 256, 257):
        q, r, ql, rl = dp_pairs(rng, 64, rows - 1, 150, dev, copy_frac=0.5)
        ql[::2] = rows - 1
        check_dp([q, r, ql, rl], f"qlen + 1 = {rows}")
    long_args = dp_pairs(rng, 64, 3000, 3000, dev, copy_frac=0.5)
    check_dp(long_args, "R=64 LQ=LR=3000 (scratch columns)")
    long_ms = cuda_ms(lambda: pallas_dp.batch_align_ends(*long_args))
    unit = np.full((5, 5), -1, np.int32)
    np.fill_diagonal(unit, 1)
    unit[0, 0] = -1
    check_dp(dp_pairs(rng, 500, 60, 70, dev), "unit table", sub_tt=unit,
             match=1, tpen=1, tvpen=1, open_p=1, ext_p=1)
    check_dp(dp_pairs(rng, 300, 50, 50, dev), "open < ext", open_p=1,
             ext_p=4)
    check_dp(dp_pairs(rng, 300, 200, 220, dev), "open < ext, 8 rows a lane",
             open_p=1, ext_p=4)
    dp_wide_tables(rng, dev)
    w1, l1 = dp_routes()
    if w1 <= w0 or l1 <= l0:
        raise AssertionError(f"pallas_dp edge cases: a route was not "
                             f"launched (wave {w1 - w0}, long {l1 - l0})")
    log(f"pallas_dp edge cases (R 1/7/33, qlen 0, rlen 0, identical pairs, "
        f"all-0 codes, LQ=1, qlen + 1 = 32/33/64/65/128/129/256/257, "
        f"LQ=LR=3000 in scratch, unit table, open < ext at 2 and 8 rows a "
        f"lane): bit-exact; launches wave {w1 - w0}, long {l1 - l0}; long "
        f"route at R=64 LQ=LR=3000 {long_ms:.3f} ms (median of 5)")
    return err, ms, plain, None, (bms, by)


def dp_wide_tables(rng, dev):
    """pallas_dp with the Protein BLOSUM62 table (sigma = 27, never run on
    the card before this slice) and a full 32 x 32 table, on the wave
    route (the main shape) and the long one, bit-exact; BLOSUM62 at the
    main shape timed."""
    import torch
    from metagraph_tpu_torch.align import pallas_dp
    from metagraph_tpu_torch.align.aligner import blosum62_matrix
    from metagraph_tpu_torch.kmer.alphabets import PROTEIN
    b62 = blosum62_matrix(PROTEIN)
    rand32 = rng.integers(-6, 7, (32, 32)).astype(np.int32)
    for tab, name in ((b62, "BLOSUM62, sigma=27"), (rand32, "sigma=32")):
        sigma = tab.shape[0]
        for R, LQ, LR in ((1 << 14, 112, 128), (64, 300, 330),
                          (64, 255, 260)):
            q, r, ql, rl = dp_pairs(rng, R, LQ, LR, dev, copy_frac=0.5)
            q = torch.from_numpy(rng.integers(0, sigma, (R, LQ)).astype(
                np.int32)).to(dev)
            cp = torch.arange(R, device=dev) % 2 == 0
            n = min(LQ, LR)
            r[cp, :n] = q[cp, :n]
            r[~cp] = torch.from_numpy(rng.integers(0, sigma, (
                int((~cp).sum()), LR)).astype(np.int32)).to(dev)
            args = [q, r, ql, rl]
            check_dp(args, f"{name} R={R} LQ={LQ}", sub_tt=tab, open_p=11,
                     ext_p=1)
            if sigma == 27 and LQ == 112:
                ms = cuda_ms(lambda: pallas_dp.batch_align_ends(
                    *args, sub_tt=tab, open_p=11, ext_p=1))
                cells = pallas_dp.dp_cells(ql, rl, LQ, LR)
                bms, _ = bound(4 * R * (LQ + LR + 2 + 3),
                               cells * pallas_dp.OPS_PER_CELL)
                log(f"pallas_dp ends, BLOSUM62 (sigma=27) R=2^14 LQ={LQ} "
                    f"LR={LR} ({cells} cells): bit-exact, batch_align_ends "
                    f"(wave route, with its table upload) {ms:.3f} ms, "
                    f"bound {bms:.4f} ms (median of 5)")
    log("pallas_dp with BLOSUM62 (sigma = 27) and a 32 x 32 table at "
        "qlen + 1 = 113 (wave), 256 (wave, 8 rows a lane) and 301 (long "
        "route): bit-exact")


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def _window_ints(c, K):
    """The 2-bit integers (first value most significant) of every K-window
    (K <= 32) of ``c``, values 0..3 as uint64, by doubling: windows of
    1, 2, 4, ... values built in place, the parts of K joined from the
    window's end; a few passes and arrays, not two a character."""
    nw = len(c) - K + 1
    v = c.copy()
    t = np.empty_like(v)
    out = np.zeros(nw, np.uint64)
    size, done = 1, 0                 # v holds windows of ``size`` values
    while True:
        if K & size:                  # this part ends where the last began
            done += size
            np.left_shift(v[K - done:K - done + nw], np.uint64(2 * (done -
                                                                    size)),
                          out=t[:nw])
            out |= t[:nw]
        if 2 * size > K:
            return out
        n = len(v) - size
        t[:n] = v[size:]
        v[:n] <<= np.uint64(2 * size)
        v[:n] |= t[:n]
        size *= 2


def fwd_kmer_ints(codes, K):
    """2-bit k-mer integers (ACGT -> 0..3, first char most significant)
    of every window of an ACGT code array."""
    c = codes.astype(np.uint64)
    c -= np.uint64(1)
    return _window_ints(c, K)


def rc_kmer_ints(codes, K):
    """2-bit integers of the reverse complements of every window: the
    windows of the reversed complement, in reverse order."""
    c = np.uint64(4) - codes[::-1].astype(np.uint64)   # the complement
    return _window_ints(c, K)[::-1]


def revcomp_ints(x, K):
    """Reverse complements of 2-bit k-mer integers: complement every
    digit, reverse the 32 digits of the word by swaps, keep the top K."""
    y = ~np.asarray(x, np.uint64)
    for shift, mask in ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
                        (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF)):
        s, m = np.uint64(shift), np.uint64(mask)
        y = ((y >> s) & m) | ((y & m) << s)
    y = (y >> np.uint64(32)) | (y << np.uint64(32))
    return y >> np.uint64(64 - 2 * K)


def distinct(x):
    """The distinct values of a 1-D array, ascending: one sort and a
    neighbour compare (``np.unique`` of 2^25 k-mers took 50-100 s on the
    card's host, where a sort of 2^26 takes seconds: PERF.md §7)."""
    x = np.sort(x)
    return x[np.concatenate([[True], x[1:] != x[:-1]])]


def gold_real_edges(codes, K, mode):
    """numpy count of the distinct k-mers: basic all, primary the
    canonical forms, canonical the closure (both orientations,
    palindromes once)."""
    fwd = fwd_kmer_ints(codes, K)
    if mode == "basic":
        return len(distinct(fwd))
    canon = distinct(np.minimum(fwd, rc_kmer_ints(codes, K)))
    if mode == "primary":
        return len(canon)
    pal = int(np.count_nonzero(revcomp_ints(canon, K) == canon))
    return 2 * len(canon) - pal


def check_graph(boss, codes, K, mode):
    import torch
    from metagraph_tpu_torch.common import packed
    from metagraph_tpu_torch.kmer import packing
    lanes = boss.edge_lanes
    real = int((~packing.contains_sentinel(lanes, K, 4)).sum())
    t0 = time.time()
    gold = gold_real_edges(codes, K, mode)
    log(f"k={K} {mode}: the numpy gold of real edges in "
        f"{time.time() - t0:.1f} s (host)")
    if real != gold:
        raise AssertionError(f"k={K} {mode}: {real} real edges, numpy gold "
                             f"{gold}")
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


def zero_launches():
    from metagraph_tpu_torch.align import pallas_dp
    from metagraph_tpu_torch.common import merge
    merge.partition_launches = 0
    merge.merge_launches = 0
    merge.sort_launches = 0
    merge.sort_digit_passes = 0
    pallas_dp.dp_launches = 0
    pallas_dp.dp_long_launches = 0


def read_launches():
    from metagraph_tpu_torch.align import pallas_dp
    from metagraph_tpu_torch.common import merge
    return {"partition_compact": merge.partition_launches,
            "merge_sorted": merge.merge_launches,
            "sort_packed": merge.sort_launches,
            "pallas_dp": pallas_dp.dp_launches,
            "pallas_dp_long_route": pallas_dp.dp_long_launches}


BUILD_KERNELS = ("partition_compact", "merge_sorted", "sort_packed")


def check_launched(launches, names, what):
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by {what}")


def phase_main_path(dev):
    import torch
    from metagraph_tpu_torch.common import merge
    from metagraph_tpu_torch.engine.annotated_dbg import (
        AnnotatedDbg, BatchQuery, annotate_sequences)
    from metagraph_tpu_torch.graph.dbg_succinct import DbgSuccinct
    rng = np.random.default_rng(SEED)
    codes = rng.integers(1, 5, N_CODES).astype(np.uint8)   # bench_capacity

    zero_launches()
    results = {}
    for K, mode in ((31, "canonical"), (20, "basic")):
        boss, cold = timed_build(codes, K, mode, dev)
        del boss
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        boss, warm = timed_build(codes, K, mode, dev)
        peak_bytes = torch.cuda.max_memory_allocated() - base
        peak = peak_bytes / 2**30
        real = check_graph(boss, codes, K, mode)
        rate = (N_CODES - K + 1) / warm
        log(f"build k={K} {mode} 2^25 codes: {boss.num_edges} edges, "
            f"{real} real = numpy gold; cold {cold:.3f} s, warm "
            f"{warm:.3f} s = {rate / 1e6:.2f} M k-mers/s; peak device "
            f"memory {peak:.1f} GiB")
        results[K] = (warm, rate)
        # phase 3i holds its scale-out builds against these arrays
        results[K, "ref"] = host_boss(boss)
        results[K, "peak_bytes"] = peak_bytes
        results[K, "warm"] = warm
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
    launches = read_launches()
    check_launched(launches, BUILD_KERNELS, "the build path")
    log(f"launch counts over the build path: {launches}; "
        f"{merge.sort_digit_passes} radix digit passes in its sorts")
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
    surface, cnt_ann = surface_query_modes(graph, records, labels, reads,
                                           which, cpu.graph)
    del cpu
    torch.cuda.empty_cache()
    surface["validate"] = surface_validate(graph, real)
    align_launches, align_rates, aln_reads, aln_out = phase_align(
        graph, bq, codes, rng)
    with tempfile.TemporaryDirectory() as tmp:
        surface["small"], fast_path = phase_small_state(
            graph, ann, reads, got, n_reads / dt, aln_reads, aln_out,
            align_rates, dev, tmp)
        zero_launches()
        graph_diff_assembly(graph, ann, records, labels, tmp, fast_path)
        graph_k20_cli(graph, aln_reads, tmp, fast_path, dev)
        surface["graph launches"] = read_launches()
        phase_navigation(graph)
        check_launched(surface["graph launches"], BUILD_KERNELS,
                       "phase 3g on the k=20 graph")
        log(f"3g launch counts on the k=20 graph's paths: "
            f"{surface['graph launches']}")
        (surface["anno launches"], surface["anno"], rd_ref,
         rdb_ann) = phase_anno(graph, ann, cnt_ann, codes, records, labels,
                               reads, tmp)
        surface["serve launches"] = phase_serve(graph, ann, rdb_ann,
                                                cnt_ann, reads, aln_reads)
        del cnt_ann, rdb_ann
        results["3i row_diff"] = scaleout_row_diff(graph, tmp, rd_ref,
                                                   ann.matrix.nnz)
        del rd_ref
        align_launches = (align_launches, align_rates)
        del graph, boss, ann, bq
        torch.cuda.empty_cache()
    cuda_equals_cpu(dev, rng)
    return launches, align_launches, results, surface


def phase_navigation(graph):
    """3a's k = 20 graph: get_last, succ_last, succ_W (a random symbol
    each, minus flags included) and rank0 of ``last`` on 2^16 random
    positions against a torch gold from the set positions of ``last``
    and of each symbol in W (``nonzero``, ``searchsorted``), on the
    card; index_range_nodes of 2^16 edges' source nodes holds each
    edge."""
    import torch
    from metagraph_tpu_torch.common import packed
    boss = graph.boss
    dev = boss.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    m, n = boss.num_edges, boss.last_rank.n
    sigma = 2 * boss.alph_size
    i = torch.randint(0, m + 2, (1 << 16,), device=dev, generator=gen)
    c = torch.randint(0, sigma, (1 << 16,), device=dev, generator=gen)
    torch.cuda.synchronize()
    t0 = time.time()
    got = (boss.get_last(i), boss.succ_last(i), boss.succ_W(i, c),
           boss.last_rank.rank0(i))
    torch.cuda.synchronize()
    t_calls = time.time() - t0
    # the set positions of last and of each symbol in W[1..m], each with
    # the past-the-end answer appended
    ones = boss.last_rank.set_positions()
    last = torch.zeros((n,), dtype=torch.bool, device=dev)
    last[ones] = True
    ones_end = torch.cat([ones, torch.full((1,), n, device=dev)])
    W = boss.W.to(torch.int64)
    succ_w = torch.empty_like(i)
    for sym in range(sigma):
        pos = torch.cat([torch.nonzero(W[1:] == sym).reshape(-1) + 1,
                         torch.full((1,), m + 1, device=dev)])
        sel = c == sym
        succ_w[sel] = pos[torch.searchsorted(pos, i[sel])]
    want = (last[torch.clamp(i, max=n - 1)] & (i < n),
            ones_end[torch.searchsorted(ones_end, i)], succ_w,
            i + 1 - torch.searchsorted(ones, i, right=True))
    for name, g, w in zip(("get_last", "succ_last", "succ_W", "rank0"),
                          got, want):
        if not torch.equal(g.to(torch.int64), w.to(torch.int64)):
            raise AssertionError(f"navigation: {name} differs from its "
                                 f"gold on 2^16 positions")
    e = torch.randint(0, m, (1 << 16,), device=dev, generator=gen)
    lanes = boss.edge_lanes[:, e]
    lo, hi = boss.index_range_nodes(packed.set_field(
        lanes, 0, torch.zeros_like(lanes[0]), boss.bits_per_char))
    if not bool(((lo <= e + 1) & (e + 1 < hi)).all()):
        raise AssertionError("navigation: index_range_nodes misses an "
                             "edge of its node")
    log(f"navigation on the k=20 graph ({m} edges): get_last, succ_last, "
        f"succ_W, rank0 on 2^16 random positions in {t_calls * 1e3:.2f} ms "
        f"= the nonzero / searchsorted gold; index_range_nodes holds 2^16 "
        f"edges")


def cuda_equals_cpu(dev, rng):
    """3a and 3b at small sizes: the card's builds and alignments equal
    the CPU's."""
    import torch

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
    check_align_cuda_cpu(dev)


# ---------------------------------------------------------------------------
# phase 3g: the graph algorithms (assemble, clean, transform, compare,
# extend, merge, align -o *.gfa)
# ---------------------------------------------------------------------------

CODE_OF = np.zeros(256, np.uint8)
CODE_OF[np.frombuffer(b"ACGT", np.uint8)] = [1, 2, 3, 4]
LETTERS = np.frombuffer(b"$ACGT", np.uint8)


def seq_kmer_ints(seqs, K, canonical=True):
    """2-bit ints of every K-window of ACGT byte strings (one pass over
    their concatenation, windows across a boundary dropped);
    ``canonical`` takes the smaller of each window and its reverse
    complement."""
    c = CODE_OF[np.frombuffer(b"$".join(seqs), np.uint8)]
    if len(c) < K:
        return np.zeros(0, np.uint64)
    bad = np.concatenate([[0], np.cumsum(c == 0)])
    ok = (bad[K:] - bad[:-K]) == 0
    f = fwd_kmer_ints(c, K)
    return (np.minimum(f, rc_kmer_ints(c, K)) if canonical else f)[ok]


def read_fasta(path):
    from metagraph_tpu_torch.seqio.fasta import parse_records
    return [r.seq for r in parse_records(path)]


def write_fasta(path, seqs, prefix="s"):
    with open(path, "wb") as f:
        f.write(b"".join(b">%s%d\n%s\n" % (prefix.encode(), i, s)
                         for i, s in enumerate(seqs)))


def gz_text(path):
    import gzip
    with gzip.open(path) as f:
        return f.read()


def cli_logged(device, zlib=True):
    """The in-process CLI runner, returning (stdout, stderr)."""
    run = cli_in_process(device, zlib)

    def logged(*argv):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            out = run(*argv)
        return out, err.getvalue()

    return logged


def timed_sync(times, name, fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    times[name] = time.time() - t0
    return out


def graph_assemble(dev):
    """3g. Assembly of the k = 31 canonical graph of phase 3a's 2^25
    codes through the functions the assemble and transform commands
    call (the graph stays in memory: saving its 67 M edges costs about a
    minute of zlib): unitigs by pointer doubling, their FASTA, a
    canonical rebuild from them (equal W, last, F), contigs covering
    every node exactly once (windows packed and sorted on the card
    against the node k-mers), and the compacted GFA against
    predecessors. Returns the stage times."""
    import torch
    from metagraph_tpu_torch.cli.main import _write_gfa
    from metagraph_tpu_torch.common import packed
    from metagraph_tpu_torch.graph import traversal as tt
    from metagraph_tpu_torch.graph.boss_construct import (
        build_boss, build_boss_from_codes)
    from metagraph_tpu_torch.graph.dbg_succinct import DbgSuccinct
    from metagraph_tpu_torch.kmer import packing
    from metagraph_tpu_torch.kmer.alphabets import DNA
    from metagraph_tpu_torch.kmer.extractor import (encode_sequences,
                                                    window_validity)
    from metagraph_tpu_torch.seqio.fasta import FastaWriter
    codes = np.random.default_rng(SEED).integers(1, 5, N_CODES).astype(
        np.uint8)                                   # phase 3a's codes
    t = {}
    boss = timed_sync(t, "build", lambda: build_boss_from_codes(
        codes, 31, mode="canonical", device=dev))
    g = DbgSuccinct.from_boss(boss, mode="canonical")
    N = g.num_nodes()
    u = timed_sync(t, "decomposition", lambda: tt.unitig_decomposition(g))
    seqs = timed_sync(t, "unitig sequences", lambda: tt.unitig_sequences(
        g, u))
    if sum(len(s) - 30 for s in seqs) != N:
        raise AssertionError("3g assemble: unitigs do not hold every node")
    with tempfile.TemporaryDirectory() as tmp:
        def fasta_out():
            # plain text: gzip of 67 M characters is ≈ 11 s of host zlib
            with FastaWriter(os.path.join(tmp, "u.fasta")) as w:
                for s in seqs:
                    w.write(s)
        timed_sync(t, "unitig FASTA write", fasta_out)
        rebuilt = timed_sync(t, "rebuild from unitigs", lambda: build_boss(
            seqs, 31, mode="canonical", device=dev))
        same_boss(rebuilt, boss, "3g unitig round trip",
                  names=("W", "last", "F"))
        del rebuilt
        contigs = timed_sync(t, "contig sequences",
                             lambda: tt.contig_sequences(g))
        ct = torch.from_numpy(encode_sequences(contigs, DNA)).to(dev)
        lanes = packing.pack_windows(ct, 31, 4)[:, window_validity(ct, 31)]
        real = ~packing.contains_sentinel(boss.edge_lanes, 31, 4)
        if lanes.shape[1] != N or not torch.equal(
                packed.sort(lanes)[0], boss.edge_lanes[:, real]):
            raise AssertionError("3g contigs: the windows are not every "
                                 "node exactly once")
        del ct, lanes, real
        gfa = os.path.join(tmp, "g.gfa")
        timed_sync(t, "compacted GFA write", lambda: _write_gfa(
            g, gfa, compacted=True))
        with open(gfa) as f:
            rows = [line.rstrip("\n").split("\t") for line in f]
    seg = [r for r in rows if r[0] == "S"]
    ends = tt.unitig_ends(g, u).cpu().numpy()
    if [int(r[1]) for r in seg] != ends.tolist() or \
            [r[2].encode() for r in seg] != seqs:
        raise AssertionError("3g GFA: S lines are not the unitigs")
    preds = g.predecessors(u.starts).cpu().numpy()
    want = sorted((int(p), int(e)) for e, row in zip(ends, preds)
                  for p in row if p > 0)
    got = sorted((int(r[1]), int(r[3])) for r in rows if r[0] == "L")
    if got != want:
        raise AssertionError("3g GFA: L lines differ from predecessors")
    log(f"3g assemble, k=31 canonical graph of 2^25 codes ({N} nodes): "
        f"{u.num_unitigs} unitigs ({int(u.lengths.max())} nodes the "
        f"longest), {len(contigs)} contigs; the canonical build of the "
        f"unitigs equals the graph (W, last, F); the contigs' windows are "
        f"every node once; GFA: {len(seg)} S lines, {len(got)} L lines = "
        f"predecessors; s: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                        t.items()))
    return t


def clean_reads(rng, n_chars, genome_len=1 << 20, rl=100, err=0.01):
    """Reads of rl bp from both strands of a random genome, to n_chars
    read characters, with uniform substitutions: (genome codes, (n, rl)
    read codes)."""
    genome = rng.integers(1, 5, genome_len).astype(np.uint8)
    n = n_chars // rl
    reads = genome[rng.integers(0, genome_len - rl + 1, n)[:, None]
                   + np.arange(rl)]
    flip = rng.random(n) < 0.5
    reads[flip] = 5 - reads[flip, ::-1]
    hit = rng.random(reads.shape) < err
    reads[hit] = (reads[hit] - 1 + rng.integers(1, 4, int(hit.sum()))) % 4 + 1
    return genome, reads


def read_window_ints(reads, K):
    """Canonical ints of every window inside each read."""
    n, rl = reads.shape
    flat = reads.reshape(-1)
    f = fwd_kmer_ints(flat, K)
    r = rc_kmer_ints(flat, K)
    keep = (np.arange(len(f)) % rl) <= rl - K
    return np.minimum(f, r)[keep]


CLEAN_ARGS = ("--prune-tips", "62", "--prune-unitigs", "0", "--fallback",
              "2", "--to-fasta")


def graph_clean(dev):
    """3g. clean on a sequencing run with errors: a random genome of 2^20
    bases sampled as 100 bp reads from both strands to 2^25 read
    characters with 1 % substitutions, built with build -k 31 --mode
    canonical --count-kmers, cleaned with clean --prune-tips 62
    --prune-unitigs 0 --fallback 2 --to-fasta, then with
    --count-slice-quantiles "0 0.5 1". The kept genome and error k-mers
    against a numpy gold; the CLI's files on the card byte-identical to
    the CPU run on the first 2^14 reads. Returns numbers to report."""
    # 3g's files are scratch: stored without zlib (np.load reads both)
    run = cli_logged("cuda", zlib=False)
    run_cpu = cli_logged("cpu", zlib=False)
    genome, reads = clean_reads(np.random.default_rng(SEED + 30), N_CODES)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        def p(name):
            return os.path.join(tmp, name)
        seqs = [LETTERS[r].tobytes() for r in reads]
        write_fasta(p("reads.fa"), seqs, "r")
        write_fasta(p("pre.fa"), seqs[:1 << 14], "r")
        t0 = time.time()
        run("build", "-k", "31", "--mode", "canonical", "--count-kmers",
            "-o", p("g"), p("reads.fa"))
        res["build s"] = time.time() - t0
        t0 = time.time()
        _, err = run("clean", "-i", p("g"), *CLEAN_ARGS, "-o", p("c"))
        res["clean s"] = time.time() - t0
        t0 = time.time()
        run("clean", "-i", p("g"), *CLEAN_ARGS, "--count-slice-quantiles",
            "0 0.5 1", "-o", p("q"))
        res["clean slices s"] = time.time() - t0
        thr = [line for line in err.splitlines() if "Threshold" in line
               or "fallback" in line]
        kept = [line for line in err.splitlines() if "Cleaned graph" in line]
        res["threshold"] = thr[0].split(": ")[-1] if thr else "?"
        res["kept"] = kept[0].split("kept ")[-1].split(" nodes")[0]
        out = seq_kmer_ints(read_fasta(p("c.fasta.gz")), 31)
        slices = [seq_kmer_ints(read_fasta(p(f"q.{a}.fasta.gz")), 31)
                  for a in ("0.0.5", "0.5.1")]
        n_side = len(gz_text(p("c.kmer_counts.gz")).splitlines())
        n_seq = len(read_fasta(p("c.fasta.gz")))
        # the CPU port on the first 2^14 reads, the card on the same
        for d, r in (("cuda", run), ("cpu", run_cpu)):
            r("build", "-k", "31", "--mode", "canonical", "--count-kmers",
              "-o", p("pg" + d), p("pre.fa"))
            r("clean", "-i", p("pg" + d), *CLEAN_ARGS, "-o", p("pc" + d))
            r("clean", "-i", p("pg" + d), *CLEAN_ARGS,
              "--count-slice-quantiles", "0 0.5 1", "-o", p("pq" + d))
        for f in ("pc{}.fasta.gz", "pc{}.kmer_counts.gz",
                  "pq{}.0.0.5.fasta.gz", "pq{}.0.5.1.fasta.gz"):
            if gz_text(p(f.format("cuda"))) != gz_text(p(f.format("cpu"))):
                raise AssertionError(f"3g clean: {f.format('')} on the card "
                                     f"differs from the CPU run")
    gold_g = distinct(seq_kmer_ints([LETTERS[genome].tobytes()], 31))
    in_reads = distinct(read_window_ints(reads, 31))
    genome_k = np.intersect1d(gold_g, in_reads, assume_unique=True)
    error_k = np.setdiff1d(in_reads, gold_g, assume_unique=True)
    out_u = np.unique(out)
    if len(out_u) != len(out) or n_side != n_seq:
        raise AssertionError("3g clean: a k-mer written twice, or the count "
                             "sidecar out of step with the FASTA")
    res["genome kept"] = np.isin(genome_k, out_u, assume_unique=True).mean()
    res["error kept"] = np.isin(error_k, out_u, assume_unique=True).mean()
    sl = np.concatenate(slices)
    if len(np.unique(sl)) != len(sl) or not np.array_equal(np.sort(sl),
                                                           out_u):
        raise AssertionError("3g clean: the count slices do not split the "
                             "cleaned k-mers")
    log(f"3g clean, {len(reads)} reads of 100 bp (2^25 chars, 1 % "
        f"substitutions) of a 2^20-base genome: {len(genome_k)} genome and "
        f"{len(error_k)} error canonical 31-mers in the reads; threshold "
        f"{res['threshold']}; kept {res['kept']} nodes, {n_seq} contigs; "
        f"genome k-mers kept {res['genome kept']:.6f}, error k-mers kept "
        f"{res['error kept']:.6f}; the slices split the kept k-mers; CLI "
        f"build {res['build s']:.1f} s, clean {res['clean s']:.1f} s, with "
        f"slices {res['clean slices s']:.1f} s; the card's files on the "
        f"first 2^14 reads equal the CPU run's")
    if res["genome kept"] < 0.99 or res["error kept"] > 0.01:
        raise AssertionError("3g clean: fewer than 99 % of the genome k-mers "
                             "or more than 1 % of the error k-mers kept")
    return res


def graph_diff_assembly(graph, ann, records, labels, tmp, fast_path):
    """3g. Differential assembly on phase 3a's k = 20 graph and its 1000
    labelled records: label_0 in, label_1 out, by unitigs and by nodes,
    against a numpy gold of the JAX rule (diff_assembly.py: a unitig is
    kept when one of its nodes carries label_0 and none label_1; a node
    when it carries label_0 and not label_1), the labels taken from the
    records; then assemble -a ... --unitigs through the CLI, whose FASTA
    must hold the same unitigs, and assemble without --unitigs, which
    fails as in the reference."""
    import torch
    from metagraph_tpu_torch.engine.annotated_dbg import AnnotatedDbg
    from metagraph_tpu_torch.engine.diff_assembly import differential_assembly
    from metagraph_tpu_torch.graph import traversal as tt
    from metagraph_tpu_torch.kmer.packing import unpack_to_chars
    t = {}
    adbg = AnnotatedDbg(graph=graph, annotation=ann)
    m_u = differential_assembly(adbg, ["label_0"], ["label_1"])
    seqs_u = timed_sync(t, "unitig mode", lambda: tt.unitig_sequences(m_u))
    m_n = differential_assembly(adbg, ["label_0"], ["label_1"],
                                unitig_mode=False)
    seqs_n = timed_sync(t, "node mode", lambda: tt.contig_sequences(m_n))
    ins = np.unique(seq_kmer_ints([r for r, l in zip(records, labels)
                                   if l == "label_0"], 20, False))
    outs = np.unique(seq_kmer_ints([r for r, l in zip(records, labels)
                                    if l == "label_1"], 20, False))
    gold_n = np.setdiff1d(ins, outs, assume_unique=True)
    got_n = seq_kmer_ints(seqs_n, 20, False)
    if len(got_n) != len(gold_n) or not np.array_equal(np.sort(got_n),
                                                       gold_n):
        raise AssertionError("3g diff assembly by nodes differs from gold")
    # the unitig rule over the graph's unitigs, labels from the records
    u = tt.unitig_decomposition(graph)
    chars = unpack_to_chars(graph.node_lanes(torch.arange(
        1, graph.num_nodes() + 1, device=graph.device)), 20, 4)
    key = torch.zeros(chars.shape[0], dtype=torch.int64, device=chars.device)
    for j in range(20):
        key = (key << 2) | (chars[:, j].to(torch.int64) - 1)
    key = key.cpu().numpy().astype(np.uint64)
    del chars
    cid = u.chain_id[1:].cpu().numpy()
    has_in = np.zeros(u.num_unitigs, bool)
    has_out = np.zeros(u.num_unitigs, bool)
    has_in[cid[np.isin(key, ins)]] = True
    has_out[cid[np.isin(key, outs)]] = True
    gold_u = np.sort(key[(has_in & ~has_out)[cid]])
    got_u = seq_kmer_ints(seqs_u, 20, False)
    if not len(got_u) or len(got_u) != len(gold_u) or \
            not np.array_equal(np.sort(got_u), gold_u):
        raise AssertionError("3g diff assembly by unitigs differs from gold")
    anno = os.path.join(tmp, "anno.column.annodbg.npz")
    with stored_uncompressed():
        ann.save(anno)
    run = cli_in_process("cuda", zlib=False)
    t0 = time.time()
    run("assemble", "-i", fast_path, "-a", anno, "--label-mask-in",
        "label_0", "--label-mask-out", "label_1", "--unitigs", "-o",
        os.path.join(tmp, "du"))
    t["CLI assemble -a --unitigs"] = time.time() - t0
    if read_fasta(os.path.join(tmp, "du.fasta.gz")) != seqs_u:
        raise AssertionError("3g CLI differential assembly differs")
    try:
        run("assemble", "-i", fast_path, "-a", anno, "--label-mask-in",
            "label_0", "--label-mask-out", "label_1", "-o",
            os.path.join(tmp, "dn"))
    except AssertionError as e:
        if "label_other_fraction" not in str(e):
            raise
    else:
        raise AssertionError("3g: assemble with label masks and without "
                             "--unitigs must fail, as in the reference")
    log(f"3g differential assembly (label_0 in, label_1 out) on the k=20 "
        f"graph: {len(seqs_u)} unitigs holding {len(got_u)} k-mers and "
        f"{len(seqs_n)} contigs holding {len(got_n)} k-mers, both equal to "
        f"the numpy gold of the JAX rule; the CLI's unitigs equal the "
        f"API's; without --unitigs the CLI exits non-zero (the "
        f"reference's fault); s: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                              t.items()))
    return t


GFA_CODES = 1 << 20


def graph_k20_cli(graph, aln_reads, tmp, fast_path, dev):
    """3g. On phase 3a's k = 20 graph file: transform --state small, then
    assemble --unitigs on the fast and the small file (byte-identical);
    align -o paths.gfa with and without --compacted for 2^10 of phase
    3b's reads (every P line holds the read's mapped nodes; compacted,
    the unitig ends among them and the end of the last node's unitig);
    compare of equal and unequal pairs. Then the first 2^20 codes' k = 20
    graph: transform --to-gfa (non-compacted: every node an S line with
    its k-mer, every edge one L line) and --to-adj-list (each node's
    successors)."""
    import torch
    from metagraph_tpu_torch.graph import traversal as tt
    run = cli_in_process("cuda", zlib=False)
    t = {}

    def p(name):
        return os.path.join(tmp, name)

    def timed_run(name, *argv):
        t0 = time.time()
        out = run(*argv)
        t[name] = time.time() - t0
        return out

    timed_run("transform --state small", "transform", "-i", fast_path,
              "--state", "small", "-o", p("g20small"))
    timed_run("assemble --unitigs (fast)", "assemble", "-i", fast_path,
              "--unitigs", "-o", p("uf"))
    timed_run("assemble --unitigs (small)", "assemble", "-i",
              p("g20small"), "--unitigs", "-o", p("us"))
    fast_u = gz_text(p("uf.fasta.gz"))
    if gz_text(p("us.fasta.gz")) != fast_u:
        raise AssertionError("3g small-state unitigs differ from the fast "
                             "state's")
    reads = aln_reads[:1 << 10]
    write_fasta(p("aln.fa"), reads, "a")
    timed_run("align -o paths.gfa", "align", "-i", fast_path, "-o",
              p("paths.gfa"), p("aln.fa"))
    timed_run("align --compacted -o paths.gfa", "align", "-i", fast_path,
              "--compacted", "-o", p("cpaths.gfa"), p("aln.fa"))
    u = tt.unitig_decomposition(graph)
    ends = set(tt.unitig_ends(graph, u).cpu().numpy().tolist())
    for name, compacted in (("paths", False), ("cpaths", True)):
        with open(p(name + ".path.gfa")) as f:
            lines = [line.rstrip("\n").split("\t") for line in f]
        if len(lines) != len(reads):
            raise AssertionError(f"3g {name}: {len(lines)} P lines")
        for i, (row, r) in enumerate(zip(lines, reads)):
            nodes = [int(x[:-1]) for x in row[2].split(",")]
            path = graph.map_to_nodes(r).tolist()
            want = path if not compacted else \
                [v for v in path[:-1] if v in ends]
            if row[:2] != ["P", str(i + 1)] or (
                    nodes != want if not compacted else
                    nodes[:-1] != want or (nodes[-1] not in ends
                                           and nodes[-1] != 0)):
                raise AssertionError(f"3g {name}: P line {i + 1} is not "
                                     f"the read's nodes")
    codes = np.random.default_rng(SEED).integers(1, 5, N_CODES).astype(
        np.uint8)[:GFA_CODES]
    write_fasta(p("pre.fa"), [LETTERS[codes].tobytes()], "c")
    run("build", "-k", "20", "-o", p("pre"), p("pre.fa"))
    timed_run("transform --to-gfa (2^20 codes)", "transform", "-i",
              p("pre"), "--to-gfa", "-o", p("pre"))
    timed_run("transform --to-adj-list (2^20 codes)", "transform", "-i",
              p("pre"), "--to-adj-list", "-o", p("pre"))
    run("transform", "-i", p("pre"), "--state", "small", "-o",
        p("pre_small"))
    write_fasta(p("half.fa"), [LETTERS[codes[:len(codes) // 2]].tobytes()])
    run("build", "-k", "20", "-o", p("half"), p("half.fa"))
    same = [run("compare", p("pre"), p("pre")),
            run("compare", p("pre"), p("pre_small")),
            run("compare", p("pre"), p("half"))]
    if same != ["Graphs are identical\n"] * 2 + ["Graphs are not "
                                                  "identical\n"]:
        raise AssertionError(f"3g compare: {same}")
    from metagraph_tpu_torch.graph.io import load_graph
    pg = load_graph(p("pre"), device=dev)
    n = pg.num_nodes()
    succ = pg.successors(torch.arange(1, n + 1, device=dev)).cpu().numpy()
    with open(p("pre.gfa")) as f:
        rows = [line.rstrip("\n").split("\t") for line in f]
    seg = [r for r in rows if r[0] == "S"]
    links = sum(1 for r in rows if r[0] == "L")
    gold = np.unique(fwd_kmer_ints(codes, 20))
    got = np.sort(seq_kmer_ints([r[2].encode() for r in seg], 20, False))
    if len(seg) != n or not np.array_equal(got, gold) or \
            links != int((succ > 0).sum()):
        raise AssertionError("3g GFA of the 2^20-code graph: not every node "
                             "an S line with its k-mer and every edge an L "
                             "line")
    with open(p("pre.adjlist")) as f:
        adj = [line.rstrip("\n").split("\t") for line in f]
    want = [[str(i), " ".join(str(x) for x in row if x > 0)]
            for i, row in enumerate(succ.tolist(), start=1)]
    if adj != want:
        raise AssertionError("3g --to-adj-list differs from successors")
    log(f"3g k=20 graph CLI: small-state unitigs byte-identical to the fast "
        f"state's ({len(fast_u)} bytes); align -o paths.gfa, plain and "
        f"--compacted: {len(reads)} P lines of the reads' mapped nodes; "
        f"compare: equal, equal (small), unequal; 2^20-code graph ({n} "
        f"nodes): GFA {len(seg)} S and {links} L lines, adjacency list = "
        f"successors; s: " + ", ".join(f"{k} {v:.2f}" for k, v in t.items()))
    return t


EXTEND_CODES = 1 << 21


def graph_extend_merge(dev):
    """3g. merge and extend, the first 2^21 of the 2^25 codes as 1000
    records (cut from 2^25: every graph of this path is written and read
    as a .dbg.npz by the CLI), halves of 500: k = 31 canonical graphs
    with --count-kmers; merge of the halves equals the build of all
    records (W, last, F; weights equal a numpy gold of summed counts,
    31-bit); extend of the first half's basic graph by the second half
    equals the basic build of all, weights included; extend of the
    canonical graph holds the old k-mers twice, as in the reference, and
    equals the CPU run on the first 2^16 codes. Returns the launches."""
    from metagraph_tpu_torch.graph.boss_construct import build_boss
    from metagraph_tpu_torch.graph.io import load_graph
    run = cli_in_process("cuda", zlib=False)
    run_cpu = cli_in_process("cpu", zlib=False)
    codes = np.random.default_rng(SEED).integers(1, 5, N_CODES).astype(
        np.uint8)[:EXTEND_CODES]
    recs = split_records(codes, 1000)
    t = {}
    with tempfile.TemporaryDirectory() as tmp:
        def p(name):
            return os.path.join(tmp, name)
        write_fasta(p("h1.fa"), recs[:500])
        write_fasta(p("h2.fa"), recs[500:])
        write_fasta(p("all.fa"), recs)
        before = read_launches()
        for name, mode in (("h1", "canonical"), ("h2", "canonical"),
                           ("hb1", "basic")):
            run("build", "-k", "31", "--mode", mode, "--count-kmers", "-o",
                p(name), p(name.replace("b", "") + ".fa"))
        for name, argv in (("merge", ("merge", "-o", p("m"), p("h1"),
                                      p("h2"))),
                           ("extend canonical", ("extend", "-i", p("h1"),
                                                 "-o", p("e"), p("h2.fa"))),
                           ("extend basic", ("extend", "-i", p("hb1"), "-o",
                                             p("eb"), p("h2.fa")))):
            t0 = time.time()
            run(*argv)
            t[name] = time.time() - t0
        launches = launch_delta(before)
        check_launched(launches, BUILD_KERNELS, "extend and merge")
        # the whole builds in memory (what build -k 31 --count-kmers of
        # all records makes, before it saves)
        whole, whole_b = (build_boss(recs, 31, mode=mode, bits_per_count=8,
                                     device=dev)
                          for mode in ("canonical", "basic"))
        m = load_graph(p("m"), device=dev)
        same_boss(m.boss, whole, "3g merge", names=("W", "last", "F"))
        keys, w = graph_keys_weights(m.boss, 31)
        contigs = [CODE_OF[np.frombuffer(r, np.uint8)] for r in recs]
        gk, gw = weighted_gold(contigs, [np.ones(len(c) - 30, np.int64)
                                         for c in contigs], 31,
                               max_count=(1 << 31) - 1)
        if not (np.array_equal(keys, gk) and np.array_equal(w, gw)):
            raise AssertionError("3g merge: weights differ from the numpy "
                                 "gold of summed counts")
        eb = load_graph(p("eb"), device=dev)
        same_boss(eb.boss, whole_b, "3g extend basic",
                  names=("W", "last", "F", "weights"))
        e = load_graph(p("e"), device=dev)
        if e.num_nodes() <= m.num_nodes():
            raise AssertionError("3g canonical extend: expected the "
                                 "reference's duplicated k-mers")
        # the canonical extend, card against CPU, on the first 2^16 codes
        pre = split_records(codes[:1 << 16], 20)
        write_fasta(p("p1.fa"), pre[:10])
        write_fasta(p("p2.fa"), pre[10:])
        for d, r in (("cuda", run), ("cpu", run_cpu)):
            r("build", "-k", "31", "--mode", "canonical", "--count-kmers",
              "-o", p("pp" + d), p("p1.fa"))
            r("extend", "-i", p("pp" + d), "-o", p("pe" + d), p("p2.fa"))
        a, b = (load_graph(p("pe" + d), device="cpu") for d in ("cuda",
                                                                 "cpu"))
        same_boss(a.boss, b.boss, "3g canonical extend, card against CPU")
    log(f"3g merge / extend, 1000 records of the first 2^21 codes, k=31 "
        f"--count-kmers: merge of the halves = the build of all "
        f"({m.num_nodes()} nodes; W, last, F; weights = numpy gold of "
        f"summed counts); basic "
        f"extend = the basic build of all, weights included; canonical "
        f"extend {e.num_nodes()} nodes (the reference's duplicates), card "
        f"= CPU on 2^16 codes; launches {launches}; s: "
        + ", ".join(f"{k} {v:.2f}" for k, v in t.items()))
    return launches


def launch_delta(before):
    now = read_launches()
    return {k: now[k] - before[k] for k in now}


def phase_graph(dev):
    """3g on its own (the k = 20 parts run inside the main path, where
    that graph lives): assemble at k = 31 canonical, clean, merge and
    extend, with every kernel's launch counter zeroed just before and
    read just after; returns the launch counts."""
    zero_launches()
    before = read_launches()
    graph_assemble(dev)
    log(f"3g assemble launches: {launch_delta(before)}")
    before = read_launches()
    graph_clean(dev)
    log(f"3g clean launches: {launch_delta(before)}")
    graph_extend_merge(dev)
    launches = read_launches()
    check_launched(launches, BUILD_KERNELS, "phase 3g")
    log(f"3g launch counts (assemble, clean, merge, extend): {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 3h: annotation compression and coordinates
# ---------------------------------------------------------------------------

ANNO_SMALL_READS = 1 << 13
# the forms whose builds sort their diff keys and compact the survivors
ROW_DIFF_FORMS = ("row_diff", "row_diff_brwt", "int_row_diff",
                  "row_diff_int_brwt", "row_diff_coord")


def anno_forms(row_diff, brwt, int_brwt, unique_row, coords, graph):
    """3h's conversions, each a function of the source matrix (the
    functions transform_anno calls), grouped by source annotation."""
    UniqueRow = unique_row.UniqueRow
    return {
        "labels": {
            "row_diff": lambda m: row_diff.build_row_diff(m, graph, 64),
            "row_diff_brwt": lambda m: row_diff.build_row_diff_brwt(
                m, graph, 64),
            "brwt_relax8": lambda m: brwt.relax_brwt(brwt.build_brwt(m), 8),
            "unique_row": UniqueRow.from_row_sparse,
            "rb_brwt": lambda m: UniqueRow.from_row_sparse(m)
            .with_brwt_distinct()},
        "counts": {
            "int_row_diff": lambda m: row_diff.build_int_row_diff(m, graph,
                                                                  64),
            "int_brwt": int_brwt.build_int_brwt,
            "row_diff_int_brwt": lambda m: int_brwt.build_int_row_diff_brwt(
                m, graph, 64)},
        "records": {"brwt": brwt.build_brwt},
        "coords": {
            "column_coord": lambda m: m,
            "row_diff_coord": lambda m: coords.build_tuple_row_diff(
                m, graph, 64)},
    }


def anno_queries(bq_of, name):
    """The query a form's 3h row times and checks: labels, --query-counts
    and quantiles for the count forms, --query-coords for the
    coordinates."""
    if name == "counts":
        return lambda a, rs: (
            bq_of(a).get_top_labels_batch(rs, 2 ** 62, 0.7,
                                          with_kmer_counts=True),
            bq_of(a).get_label_count_quantiles_batch(rs, 2 ** 62, 0.7,
                                                     (0.0, 0.5, 1.0)))
    if name == "coords":
        return lambda a, rs: bq_of(a).get_kmer_coordinates_batch(
            rs, 2 ** 62, 0.7)
    return lambda a, rs: bq_of(a).get_labels_batch(rs, 0.7)


def coord_gold(codes, K, n_rec, reads, ratio=0.7):
    """numpy gold of ``get_kmer_coordinates_batch`` over the annotation of
    ``split_records(codes, n_rec)`` labelled ``label_{i % 10}``: a
    window's coordinate in a label is its offset in the label's records'
    windows, one record after the other. Per read (all of one length),
    the labels in at least ceil(ratio * windows) of its windows by (count
    desc, code asc), each with one ascending coordinate list per
    window."""
    bounds = np.linspace(0, len(codes), n_rec + 1).astype(np.int64)
    nwin = bounds[1:] - bounds[:-1] - K + 1
    lab = np.arange(n_rec) % 10
    off = np.zeros(n_rec, np.int64)
    for label in range(10):
        sel = np.nonzero(lab == label)[0]
        off[sel] = np.concatenate([[0], np.cumsum(nwin[sel])[:-1]])
    # every read's window k-mers at once: (R, W)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    c = np.searchsorted(acgt, np.frombuffer(b"".join(reads), np.uint8)
                        ).reshape(len(reads), -1).astype(np.uint64)
    W = c.shape[1] - K + 1
    q = np.zeros((len(reads), W), np.uint64)
    for j in range(K):
        q = (q << np.uint64(2)) | c[:, j:j + W]
    fwd = fwd_kmer_ints(codes, K)
    # the windows across a record boundary are nodes with no label
    cross = np.zeros(len(fwd), bool)
    starts = (bounds[1:-1, None] - np.arange(1, K)[None, :]).ravel()
    cross[starts[(starts >= 0) & (starts < len(fwd))]] = True
    across = np.sort(fwd[cross])
    # only the windows whose k-mer some read holds matter to the answer:
    # a table of the reads' low 26 bits passes a few candidates to the
    # exact search
    uq = np.unique(q)
    low = np.uint64((1 << 26) - 1)
    table = np.zeros(1 << 26, bool)
    table[(uq & low).astype(np.int64)] = True
    cand = np.nonzero(table[(fwd & low).astype(np.int64)] & ~cross)[0]
    at = np.minimum(np.searchsorted(uq, fwd[cand]), len(uq) - 1)
    pos = cand[uq[at] == fwd[cand]]
    r_in = np.searchsorted(bounds, pos, side="right") - 1
    keys = fwd[pos]
    coord = off[r_in] + pos - bounds[r_in]
    order = np.argsort(keys)
    keys, lab_s, coord = keys[order], lab[r_in][order], coord[order]
    lo = np.searchsorted(keys, q.ravel(), side="left")
    hi = np.searchsorted(keys, q.ravel(), side="right")
    n_occ = hi - lo
    at = np.minimum(np.searchsorted(across, q.ravel()), len(across) - 1)
    n_present = ((n_occ > 0) | (across[at] == q.ravel())).reshape(
        q.shape).sum(axis=1)
    flat = np.repeat(lo - np.cumsum(n_occ) + n_occ, n_occ) + np.arange(
        n_occ.sum())
    win = np.repeat(np.arange(q.size), n_occ)            # read * W + w
    r_id, w_id, lb, cd = win // W, win % W, lab_s[flat], coord[flat]
    # windows per (read, label) holding the label
    pair = np.unique(r_id * 10 * W + lb * W + w_id)
    counts = np.bincount(pair // W, minlength=len(reads) * 10).reshape(
        len(reads), 10)
    min_count = max(1, int(np.ceil(ratio * W)))
    by_read = np.argsort(r_id * 10 + lb, kind="stable")
    out = []
    starts = np.searchsorted(r_id[by_read] * 10 + lb[by_read],
                             np.arange(len(reads) * 10 + 1))
    for r in range(len(reads)):
        if n_present[r] < min_count:
            out.append([])
            continue
        keep = sorted((lb_ for lb_ in range(10)
                       if counts[r, lb_] >= min_count),
                      key=lambda lb_: (-counts[r, lb_], lb_))
        res = []
        for lb_ in keep:
            lists = [[] for _ in range(W)]
            sel = by_read[starts[r * 10 + lb_]:starts[r * 10 + lb_ + 1]]
            for w, x in zip(w_id[sel].tolist(), cd[sel].tolist()):
                lists[w].append(x)
            res.append((f"label_{lb_}", [sorted(x) for x in lists]))
        out.append(res)
    return out


def anno_cpu_parity(codes, dev):
    """3h. Every form of the annotations of a 2^18-code prefix's k = 20
    basic graph (100 records: label_{i % 10}, their counts, rec_{i},
    coordinates) built on the card has the CPU build's arrays."""
    from metagraph_tpu_torch.anno import brwt, coords, int_brwt, row_diff
    from metagraph_tpu_torch.anno import unique_row
    from metagraph_tpu_torch.engine.annotated_dbg import annotate_sequences
    from metagraph_tpu_torch.graph import io as graph_io
    from metagraph_tpu_torch.graph.boss_construct import build_boss_from_codes
    from metagraph_tpu_torch.graph.dbg_succinct import DbgSuccinct
    prefix = codes[:1 << 18]
    g = DbgSuccinct.from_boss(build_boss_from_codes(prefix, 20, device=dev))
    graphs = (g, graph_io.dbg_from_numpy(graph_io.graph_to_numpy(g), "cpu"))
    recs = split_records(prefix, 100)
    sources = {
        "labels": lambda x: annotate_sequences(
            x, [(s, [f"label_{i % 10}"]) for i, s in enumerate(recs)]),
        "counts": lambda x: annotate_sequences(
            x, [(s, [f"label_{i % 10}"]) for i, s in enumerate(recs)],
            with_counts=True),
        "records": lambda x: annotate_sequences(
            x, [(s, [f"rec_{i}"]) for i, s in enumerate(recs)]),
        "coords": lambda x: coords.annotate_coordinates(
            x, [(s, [f"label_{i % 10}"]) for i, s in enumerate(recs)])}
    n = 0
    for src, make in sources.items():
        mats = [make(x).finalize().matrix for x in graphs]
        forms = [anno_forms(row_diff, brwt, int_brwt, unique_row, coords,
                            x)[src] for x in graphs]
        for name in forms[0]:
            got, want = (f[name](m).to_npz_dict()
                         for f, m in zip(forms, mats))
            if sorted(got) != sorted(want) or any(
                    got[k].dtype != want[k].dtype
                    or not np.array_equal(got[k], want[k]) for k in want):
                raise AssertionError(f"3h {src} {name}: the card's build "
                                     f"differs from the CPU's at 2^18 codes")
            n += 1
    log(f"3h: all {n} forms built on the card equal the CPU builds array "
        f"for array at a 2^18-code prefix (k = 20, 100 records)")


ROW_API_ROWS = 1 << 12


def row_api_rows(col, gen):
    """3h's query rows for a form of source ``col`` (a column form): 2^11
    rows with a set bit and 2^11 without, shuffled, on the card, and
    their weights 1-5."""
    import torch
    dev = col.rows.device
    half = ROW_API_ROWS // 2
    without = torch.ones((col.num_rows,), dtype=torch.bool, device=dev)
    without[col.rows.to(torch.int64)] = False
    rows = []
    for pool in (torch.nonzero(~without).reshape(-1),
                 torch.nonzero(without).reshape(-1)):
        rows.append(pool[torch.randint(0, pool.shape[0], (half,),
                                       device=dev, generator=gen)])
    rows = torch.cat(rows)
    rows = rows[torch.randperm(ROW_API_ROWS, device=dev, generator=gen)]
    return rows, torch.randint(1, 6, (ROW_API_ROWS,), device=dev,
                               generator=gen)


def row_api_check(m, col, rows, weights, what):
    """A form's row API on ``rows`` against its column form's answer
    (equal, on the card); the synchronised ms of each call."""
    import torch
    calls = [("get_rows_dense", (rows,)), ("sum_rows", (rows, weights))]
    if m.has_values:
        calls += [("get_row_values_dense", (rows,)),
                  ("sum_row_values", (rows, weights))]
    out = {}
    for call, args in calls:
        want = getattr(col, call)(*args)
        torch.cuda.synchronize()
        t0 = time.time()
        got = getattr(m, call)(*args)
        torch.cuda.synchronize()
        out[call] = (time.time() - t0) * 1e3
        if got.device.type != "cuda" or not torch.equal(got, want):
            raise AssertionError(f"3h {what}: {call} on {len(rows)} rows "
                                 f"differs from the column form's")
    return out


def plain_result(result):
    """A per-sequence query result with its masks as lists."""
    return [(x[0], x[1].tolist()) if isinstance(x[1], np.ndarray) else x
            for x in result]


def per_sequence_check(bq, reads, what):
    """AnnotatedDbg's per-sequence queries on ``reads`` against the
    BatchQuery answer of the same reads; with_kmer_counts raises on this
    binary annotation. Returns (per-sequence, batch) reads/s of
    get_labels, synchronised."""
    import torch
    adbg = bq.adbg
    for name, args in (("get_labels", (0.7,)),
                       ("get_top_labels", (2 ** 62, 0.7)),
                       ("get_top_label_signatures", (3, 0.7)),
                       ("get_label_count_quantiles",
                        (2 ** 62, 0.7, (0.0, 0.5, 1.0)))):
        want = getattr(bq, name + "_batch")(reads, *args)
        got = [getattr(adbg, name)(r, *args) for r in reads]
        if [plain_result(x) for x in got] != [plain_result(x) for x in want]:
            raise AssertionError(f"3h {what}: per-sequence {name} differs "
                                 f"from the batch answer")
    try:
        adbg.get_top_labels(reads[0], 2 ** 62, 0.0, True)
    except ValueError:
        pass
    else:
        raise AssertionError(f"3h {what}: with_kmer_counts on a binary "
                             f"annotation did not raise")
    rates = []
    for fn in (lambda: [adbg.get_labels(r, 0.7) for r in reads],
               lambda: bq.get_labels_batch(reads, 0.7)):
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        rates.append(len(reads) / (time.time() - t0))
    return rates


def phase_anno(graph, ann, cnt_ann, codes, records, labels, reads, tmp):
    """3h. Phase 3a's k = 20 graph (2^25 codes) and its annotations of the
    1000 records: label_{i % 10} (3a's), their k-mer counts (3e's),
    rec_{i} and the label_{i % 10} coordinates (annotated here). Each
    form is converted on the card (time, stored nnz against the column's,
    query reads/s against the column form's, peak device memory) and
    checked: labels equal the column's read for read; the count forms'
    --query-counts and quantiles the count annotation's; coordinates a
    numpy gold; the row-diff builds launch sort_packed and
    partition_compact. The files are not written (their bytes are fixed
    by the data and the format: PERF.md §6), but for the label
    column that phase 3i converts on disk. Returns the launch counts of
    the conversions and queries, the per-form rows, the in-memory
    row_diff of the labels and their row_diff_brwt annotation."""
    import torch
    from metagraph_tpu_torch.anno import brwt, coords, int_brwt, row_diff
    from metagraph_tpu_torch.anno import unique_row
    from metagraph_tpu_torch.anno.annotator import Annotation
    from metagraph_tpu_torch.engine.annotated_dbg import (
        AnnotatedDbg, BatchQuery, annotate_sequences)

    def bq_of(a):
        return BatchQuery(AnnotatedDbg(graph=graph, annotation=a))

    def timed(fn, *args):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, time.time() - t0

    def peak_of(fn, *args):
        """fn(*args) and the device memory it peaked at, in GiB (what was
        allocated before it included)."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = fn(*args)
        return out, torch.cuda.max_memory_allocated() / 2 ** 30

    t_phase = time.time()
    zero_launches()
    gen = torch.Generator(device=graph.device).manual_seed(SEED + 15)
    # 64 reads for the per-sequence queries: 48 of the records, 16 random
    seq_reads = reads[:48] + reads[-16:]
    small = reads[:ANNO_SMALL_READS // 2] + reads[-ANNO_SMALL_READS // 2:]
    with stored_uncompressed():
        ann.save(os.path.join(tmp, "h.labels.column.annodbg.npz"))
    items = [(s, [lab]) for s, lab in zip(records, labels)]
    rec_ann, t_rec = timed(lambda: annotate_sequences(
        graph, [(s, [f"rec_{i}"]) for i, s in enumerate(records)])
        .finalize())
    crd_ann, t_crd = timed(lambda: coords.annotate_coordinates(
        graph, items).finalize())
    log(f"3h annotate: {len(records)} records as rec_i {t_rec:.2f} s "
        f"({rec_ann.matrix.nnz} relations), with coordinates {t_crd:.2f} s "
        f"({crd_ann.matrix.nnz} triples)")
    sources = {"labels": ann, "counts": cnt_ann, "records": rec_ann,
               "coords": crd_ann}
    forms = anno_forms(row_diff, brwt, int_brwt, unique_row, coords, graph)
    rows, launches = [], read_launches()
    per_seq = {}
    for src, source in sources.items():
        query = anno_queries(bq_of, src)
        col_nnz = source.matrix.nnz
        api_rows, api_w = row_api_rows(source.matrix, gen)
        col_out = {}
        if src == "labels":
            per_seq["column"] = per_sequence_check(bq_of(source), seq_reads,
                                                   "labels column")
        for n_reads in ((len(reads), ANNO_SMALL_READS) if src == "labels"
                        else (ANNO_SMALL_READS,)):
            rs = reads if n_reads == len(reads) else small
            query(source, rs[:256])
            (col_out[n_reads], dt), col_out[n_reads, "peak"] = peak_of(
                timed, query, source, rs)
            col_out[n_reads, "rate"] = n_reads / dt
        if src == "coords":
            t_gold = time.time()
            gold = coord_gold(codes, graph.k, len(records), small)
            log(f"3h coordinates: the numpy gold of {len(small)} reads in "
                f"{time.time() - t_gold:.1f} s (host)")
            if col_out[ANNO_SMALL_READS] != gold:
                bad = next(i for i, (a, b) in enumerate(
                    zip(col_out[ANNO_SMALL_READS], gold)) if a != b)
                raise AssertionError(f"3h coordinates: read {bad} differs "
                                     f"from the numpy gold")
        for name, fn in forms[src].items():
            before = read_launches()
            (m, secs), peak = peak_of(timed, fn, source.matrix)
            built = launch_delta(before)
            if name in ROW_DIFF_FORMS:
                check_launched(built, ("sort_packed", "partition_compact"),
                               f"the {name} build")
            a = Annotation(matrix=m, encoder=source.encoder)
            n_reads = (len(reads) if name in ("row_diff", "row_diff_brwt")
                       else ANNO_SMALL_READS)
            rs = reads if n_reads == len(reads) else small
            query(a, rs[:256])
            if (src, name) == ("labels", "row_diff"):
                rd_ref = m.to_npz_dict()        # phase 3i's staged build
            if (src, name) == ("labels", "row_diff_brwt"):
                rdb_ann = a                     # 3-serve serves it
            (got, dt), q_peak = peak_of(timed, query, a, rs)
            if got != col_out[n_reads]:
                bad = next(i for i, (x, y) in enumerate(
                    zip(got, col_out[n_reads])) if x != y)
                raise AssertionError(f"3h {src} {name}: read {bad} answers "
                                     f"differently from the column form")
            before = read_launches()
            api_ms = row_api_check(m, source.matrix, api_rows, api_w,
                                   f"{src} {name}")
            if name in ROW_DIFF_FORMS:
                check_launched(launch_delta(before),
                               ("sort_packed", "partition_compact"),
                               f"the {name} row API")
            if (src, name) == ("labels", "row_diff_brwt"):
                per_seq[name] = per_sequence_check(bq_of(a), seq_reads,
                                                   f"labels {name}")
            rows.append(dict(source=src, form=name, seconds=secs,
                             row_api_ms=api_ms,
                             nnz=m.nnz, col_nnz=col_nnz, reads=n_reads,
                             rate=n_reads / dt,
                             col_rate=col_out[n_reads, "rate"],
                             peak_gib=peak, query_peak_gib=q_peak,
                             col_query_peak_gib=col_out[n_reads, "peak"],
                             build_launches=built))
            del a, m
    launches = launch_delta(launches)
    for row in rows:
        log(f"3h {row['source']} -> {row['form']}: transform "
            f"{row['seconds']:.3f} s; nnz {row['nnz']} = "
            f"{row['nnz'] / max(row['col_nnz'], 1):.4f} of the column's "
            f"{row['col_nnz']}; query {row['rate']:.0f} reads/s over "
            f"{row['reads']} reads (column {row['col_rate']:.0f}); peak "
            f"{row['peak_gib']:.2f} GiB in the transform, "
            f"{row['query_peak_gib']:.2f} GiB in the query (column "
            f"{row['col_query_peak_gib']:.2f}); build launches "
            f"{row['build_launches']}; row API on {ROW_API_ROWS} rows "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in
                        row['row_api_ms'].items()))
    for name, (one, batch) in per_seq.items():
        log(f"3h per-sequence queries ({name} form, {len(seq_reads)} of 3a's "
            f"reads): get_labels one read at a time {one:.0f} reads/s, "
            f"get_labels_batch of the same reads {batch:.0f} reads/s "
            f"({batch / one:.1f}x)")
    log("3h checks: every binary form's labels equal the column form's "
        "read for read; the count forms' --query-counts and quantiles equal "
        "the count annotation's; the coordinates of both coordinate forms "
        f"equal the numpy gold on {ANNO_SMALL_READS} reads; the row-diff "
        "builds launched sort_packed and partition_compact; every form's "
        f"row API on {ROW_API_ROWS} rows (half without a bit) equals its "
        "column form's, the walked forms' calls launched sort_packed and "
        "partition_compact; the per-sequence queries of the column and "
        "row_diff_brwt forms equal the batch answers")
    log(f"3h launch counts (conversions and queries): {launches}")
    t_cpu = time.time()
    anno_cpu_parity(codes, graph.device)
    log(f"3h total {time.time() - t_phase:.1f} s (the CPU comparison "
        f"{time.time() - t_cpu:.1f} s)")
    return launches, rows, rd_ref, rdb_ann


# ---------------------------------------------------------------------------
# phase 3-serve: the query server at full width
# ---------------------------------------------------------------------------

SERVE_CLIENTS = 4               # client threads
SERVE_POSTS = 8                 # POST /search per client
SERVE_READS = 1 << 10           # reads per traffic request
SERVE_SMALL = 1 << 8            # reads per single request
SERVE_REPEATS = 4               # each single request, one at a time


def percentile_ms(seconds, q):
    return float(np.percentile(np.asarray(seconds) * 1e3, q))


def expected_search(bq, seqs, with_signature=False, with_counts=False,
                    aligned=None):
    """What POST /search must answer for ``seqs`` (named 0, 1, ... as the
    client names them), built in this process from ``BatchQuery``;
    ``aligned``: each read's best alignment or None (``align``)."""
    entries = []
    seqs = [a.sequence if a is not None else s
            for s, a in zip(seqs, aligned or [None] * len(seqs))]
    if with_signature:
        tops = bq.get_top_label_signatures_batch(seqs, 100, 0.7)
        results = [[{"sample": lab, "kmer_count": int(mask.sum()),
                     "signature": "".join("1" if b else "0" for b in mask)}
                    for lab, mask in t] for t in tops]
    else:
        tops = bq.get_top_labels_batch(seqs, 100, 0.7,
                                       with_kmer_counts=with_counts)
        results = [[{"sample": lab, "kmer_count": int(c)} for lab, c in t]
                   for t in tops]
    for i, (seq, res) in enumerate(zip(seqs, results)):
        entry = {"seq_description": str(i), "results": res}
        a = (aligned or [None] * len(seqs))[i]
        if a is not None:
            entry.update(sequence=seq.decode(), score=int(a.score),
                         cigar=a.cigar)
        entries.append(entry)
    return entries


def phase_serve(graph, ann, rdb_ann, cnt_ann, reads, aln_reads):
    """3-serve. Phase 3a's k = 20 graph (33.5 M rows) served from this
    process (``serve(..., background=True)`` on 127.0.0.1) three times:
    with 3a's label_{i % 10} column annotation, with 3h's row_diff_brwt
    form of it, and with 3e's count annotation. Traffic: for the column
    and the row_diff_brwt servers, 4 client threads each sending 8 POST
    /search of 2^10 of 3a's reads (discovery_fraction 0.7, num_labels
    100); then, one at a time, 4 times each: /search of 2^10 reads on
    the column server, /search with_signature, /search align (2^8 of
    3b's reads) and /align on the row_diff_brwt server, /search
    abundance_sum on the count server (2^8 reads), GET /stats and
    /column_labels. Every response equals the answer built in
    this process from BatchQuery / Aligner; the row_diff_brwt server
    launches sort_packed and partition_compact. Logs requests/s, reads/s
    and p50 / p99 latency per endpoint; returns the launch counts."""
    import collections
    import concurrent.futures
    from metagraph_tpu_torch.align.aligner import Aligner
    from metagraph_tpu_torch.engine.annotated_dbg import (AnnotatedDbg,
                                                           BatchQuery)
    from metagraph_tpu_torch.server.client import GraphClientJson
    from metagraph_tpu_torch.server.http_server import serve

    t_phase = time.time()
    aligner = Aligner(graph)
    adbgs = {"column": AnnotatedDbg(graph=graph, annotation=ann),
             "row_diff_brwt": AnnotatedDbg(graph=graph, annotation=rdb_ann),
             "counts": AnnotatedDbg(graph=graph, annotation=cnt_ann)}
    servers = {name: serve(a, aligner, port=0, background=True)
               for name, a in adbgs.items()}
    clients = {name: GraphClientJson("127.0.0.1", h.server_address[1])
               for name, h in servers.items()}
    latency = collections.defaultdict(list)

    def call(what, fn, *args, **kw):
        t0 = time.perf_counter()
        out, status = fn(*args, **kw)
        latency[what].append(time.perf_counter() - t0)
        if status != 200:
            raise AssertionError(f"3-serve {what}: HTTP {status}")
        return out

    n_traffic = SERVE_CLIENTS * SERVE_POSTS * SERVE_READS
    traffic = [r.decode() for r in reads[:n_traffic]]
    launches = {}
    try:
        for form in ("column", "row_diff_brwt"):
            # the answers, and their time in this process one request's
            # reads at a time, without HTTP, JSON or other requests
            bq = BatchQuery(adbgs[form])
            t0 = time.time()
            want = [e for lo in range(0, n_traffic, SERVE_READS)
                    for e in expected_search(
                        bq, reads[lo:lo + SERVE_READS])]
            in_process = time.time() - t0
            zero_launches()
            client = clients[form]

            def client_thread(c):
                outs = []
                for p in range(SERVE_POSTS):
                    lo = (c * SERVE_POSTS + p) * SERVE_READS
                    outs.append((lo, call(f"{form} /search", client.search,
                                          traffic[lo:lo + SERVE_READS],
                                          top_labels=100,
                                          discovery_threshold=0.7)))
                return outs

            t0 = time.time()
            with concurrent.futures.ThreadPoolExecutor(SERVE_CLIENTS) as ex:
                answers = [out for f in [ex.submit(client_thread, c)
                                         for c in range(SERVE_CLIENTS)]
                           for out in f.result()]
            wall = time.time() - t0
            for lo, got in answers:
                if got != want[lo:lo + SERVE_READS]:
                    raise AssertionError(f"3-serve {form} /search of reads "
                                         f"{lo}..: differs from BatchQuery")
            lat = latency[f"{form} /search"]
            log(f"3-serve {form}: {len(answers)} POST /search of "
                f"{SERVE_READS} reads from {SERVE_CLIENTS} client threads "
                f"in {wall:.3f} s = {len(answers) / wall:.2f} requests/s, "
                f"{n_traffic / wall:.0f} reads/s; latency p50 "
                f"{percentile_ms(lat, 50):.1f} ms, p99 "
                f"{percentile_ms(lat, 99):.1f} ms; every response equals "
                f"BatchQuery's (in this process, one request's reads at a "
                f"time: {n_traffic / in_process:.0f} reads/s)")
            launches[form] = read_launches()
            if form == "column":
                column_first = want[:SERVE_READS]
        small = reads[:SERVE_SMALL]
        aln_small = aln_reads[:SERVE_SMALL]
        rdb_bq = BatchQuery(adbgs["row_diff_brwt"])
        aligned = [r[0] if r else None
                   for r in aligner.align_batch(aln_small)]
        singles = [
            ("column", "/search alone",
             lambda c: c.search(traffic[:SERVE_READS], top_labels=100,
                                discovery_threshold=0.7), column_first),
            ("row_diff_brwt", "/search with_signature",
             lambda c: c.search([r.decode() for r in small], top_labels=100,
                                discovery_threshold=0.7,
                                with_signature=True),
             expected_search(rdb_bq, small, with_signature=True)),
            ("row_diff_brwt", "/search align",
             lambda c: c.search([r.decode() for r in aln_small],
                                top_labels=100, discovery_threshold=0.7,
                                align=True),
             expected_search(rdb_bq, aln_small, aligned=aligned)),
            ("row_diff_brwt", "/align",
             lambda c: c.align([r.decode() for r in aln_small]),
             [{"seq_description": str(i),
               "alignments": [a.to_json(str(i))] if a is not None else []}
              for i, a in enumerate(aligned)]),
            ("counts", "/search abundance_sum",
             lambda c: c.search([r.decode() for r in small], top_labels=100,
                                discovery_threshold=0.7,
                                abundance_sum=True),
             expected_search(BatchQuery(adbgs["counts"]), small,
                             with_counts=True)),
            ("row_diff_brwt", "/stats", lambda c: c.stats(),
             {"graph": {"k": graph.k, "nodes": int(graph.num_nodes()),
                        "mode": graph.mode},
              "annotation": {"labels": rdb_ann.num_labels,
                             "objects": rdb_ann.matrix.num_rows,
                             "relations": rdb_ann.matrix.nnz}}),
            ("row_diff_brwt", "/column_labels", lambda c: c.column_labels(),
             ann.encoder.labels)]
        n_aligned = sum(a is not None for a in aligned)
        if n_aligned < 0.75 * len(aligned):     # 1/8 of them are random
            raise AssertionError(f"3-serve: {n_aligned} of {len(aligned)} "
                                 f"reads aligned in process")
        # every expected answer is built above: the counts from here on
        # are the servers' requests' alone
        zero_launches()
        for form, what, fn, want in singles:
            for _ in range(SERVE_REPEATS):
                if call(what, fn, clients[form]) != want:
                    raise AssertionError(f"3-serve {what} on the {form} "
                                         f"server differs from the "
                                         f"in-process answer")
        launches["singles"] = read_launches()
    finally:
        for httpd in servers.values():
            httpd.shutdown()
    for _, what, _, _ in singles:
        lat = latency[what]
        n = SERVE_READS if what == "/search alone" else SERVE_SMALL
        log(f"3-serve {what}: {SERVE_REPEATS} requests one at a time, "
            f"{SERVE_REPEATS / sum(lat):.2f} requests/s"
            + (f", {SERVE_REPEATS * n / sum(lat):.0f} reads/s of {n}"
               if what.startswith(("/search", "/align")) else "")
            + f"; latency p50 {percentile_ms(lat, 50):.1f} ms, p99 "
            f"{percentile_ms(lat, 99):.1f} ms; equal to the in-process "
            f"answer")
    rdb = {k: launches["row_diff_brwt"][k] + launches["singles"][k]
           for k in launches["singles"]}
    check_launched(rdb, ("sort_packed", "partition_compact"),
                   "the row_diff_brwt server")
    total = {k: sum(v[k] for v in launches.values()) for k in rdb}
    log(f"3-serve launch counts: column server {launches['column']}, "
        f"row_diff_brwt server {rdb}; {n_aligned} of "
        f"{len(aligned)} alignment reads aligned; phase "
        f"{time.time() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# phase 3i: the scale-out builds (suffix-sharded, streaming, out-of-core,
# the out-of-core merge, the staged row-diff conversion)
# ---------------------------------------------------------------------------

OOC_CHUNK = (1 << 23) + (1 << 6)    # 4 pass-1 runs of the 2^25 codes
STREAM_CHUNK = 1 << 23              # build --disk-swap --mem-cap-gb 0.125
STAGED_MEM_CAP_MB = 128             # runs of 2^24 keys: 2 of 33.5 M entries


@contextlib.contextmanager
def stored_uncompressed():
    """Files that ``np.savez_compressed`` writes inside stored without
    zlib: the same arrays and keys, which ``np.load`` reads alike, with
    no host zlib wait (the script's files are scratch)."""
    real = np.savez_compressed
    np.savez_compressed = np.savez
    try:
        yield
    finally:
        np.savez_compressed = real


def host_boss(boss):
    """A Boss's arrays on the host (edge_lanes where kept)."""
    out = {name: getattr(boss, name).cpu() for name in ("W", "last", "F")}
    for name in ("weights", "edge_lanes"):
        x = getattr(boss, name)
        out[name] = None if x is None else x.cpu()
    return out


def same_as_ref(boss, ref, what):
    import torch
    got = host_boss(boss)
    for name, want in ref.items():
        if name == "edge_lanes" and got[name] is None:
            continue                    # the small state keeps none
        a = got[name]
        if (a is None) != (want is None) or (
                a is not None and not torch.equal(a, want)):
            raise AssertionError(f"3i {what}: {name} differs from the "
                                 f"in-core build's")


def timed_peak(fn):
    """(fn(), wall seconds, device bytes it peaked at over what was
    allocated before it)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0, torch.cuda.max_memory_allocated() - base


def scaleout_row_diff(graph, tmp, rd_ref, col_nnz):
    """3i, staged row-diff: transform_anno --disk-swap's conversion
    (``build_row_diff_staged``) of 3h's label_{i % 10} column file over
    3a's k = 20 graph, with a spill cap that cuts the column into several
    runs, merged on disk; equal to 3h's in-memory row_diff array for
    array. The runs are counted as the conversion wrote them. Returns its
    log line's numbers (it launches none of the kernels: its sorts and
    searches are ``torch`` calls, as the JAX package's are numpy)."""
    from metagraph_tpu_torch.anno.row_diff_disk import build_row_diff_staged
    before = read_launches()
    swap = os.path.join(tmp, "swap")
    spilled = {}
    (ann, secs, peak) = timed_peak(lambda: build_row_diff_staged(
        [os.path.join(tmp, "h.labels.column.annodbg.npz")], graph, swap,
        mem_cap_mb=STAGED_MEM_CAP_MB, spilled=spilled))
    got = ann.matrix.to_npz_dict()
    if sorted(got) != sorted(rd_ref) or any(
            not np.array_equal(got[key], rd_ref[key]) for key in rd_ref):
        raise AssertionError("3i staged row_diff differs from 3h's in-memory "
                             "row_diff")
    launches = launch_delta(before)
    log(f"3i staged row_diff (--disk-swap, mem cap {STAGED_MEM_CAP_MB} MiB): "
        f"{spilled['raw_runs']} raw runs spilled and merged for the "
        f"{col_nnz} column entries, {spilled['diff_runs']} diff run(s); "
        f"{ann.matrix.num_rows} rows, {ann.matrix.nnz} diffs: {secs:.2f} s, "
        f"peak {peak / 2**30:.2f} GiB over the resident graph and "
        f"annotations; equal to 3h's in-memory row_diff, array for array; "
        f"launches {launches}")
    if spilled["raw_runs"] < 2:
        raise AssertionError(f"3i staged row_diff spilled "
                             f"{spilled['raw_runs']} raw run(s), not >= 2")
    return dict(seconds=secs, peak=peak, launches=launches, **spilled)


def phase_scaleout(dev, ref):
    """3i. The scale-out builds at the main path's full width, the 2^25
    codes of 3a, each held bit for bit against 3a's in-core graphs:
    out-of-core k = 20 basic (8 shards, 4 pass-1 runs; its peak at most
    half of 3a's in-core k = 20 peak), streaming k = 31 canonical with
    runs spilled to disk (2^23-code chunks, build --disk-swap
    --mem-cap-gb 0.125), suffix-sharded k = 20 basic (suffix length 2,
    16 buckets through the suffix filter), and the out-of-core merge of
    3g's halves against their in-memory merge. The comparison's own
    graphs (the halves and their in-memory merge) are built before the
    launch counters are zeroed; each entry's launches are read around it
    alone and each must launch all three build kernels. Returns the
    launch counts of the entries together."""
    import torch
    from metagraph_tpu_torch.cli.main import _real_edges, _rebuild
    from metagraph_tpu_torch.graph.boss_construct import build_boss
    from metagraph_tpu_torch.graph.dbg_succinct import DbgSuccinct
    from metagraph_tpu_torch.kmer.alphabets import DNA
    from metagraph_tpu_torch.parallel.outofcore import (
        build_boss_out_of_core, merge_boss_graphs_out_of_core)
    from metagraph_tpu_torch.parallel.sharded_build import build_boss_sharded
    from metagraph_tpu_torch.parallel.streaming import (build_boss_streaming,
                                                        code_chunks)
    codes = np.random.default_rng(SEED).integers(1, 5, N_CODES).astype(
        np.uint8)                                   # phase 3a's codes
    recs = split_records(codes[:EXTEND_CODES], 1000)
    halves = [DbgSuccinct.from_boss(build_boss(h, 31, mode="canonical",
                                               bits_per_count=8, device=dev),
                                    DNA, "canonical")
              for h in (recs[:500], recs[500:])]
    parts = [_real_edges(g, True) for g in halves]
    mem, _ = _rebuild([p[0] for p in parts], [p[1] for p in parts], 31, DNA,
                      bits_per_count=31)
    mem_ref = host_boss(mem)
    del parts, mem, recs
    zero_launches()
    t_phase = time.time()
    per_entry = {}

    def entry(what, fn):
        """fn() timed (``timed_peak``), its launches read around it."""
        before = read_launches()
        out = timed_peak(fn)
        per_entry[what] = launch_delta(before)
        check_launched(per_entry[what], BUILD_KERNELS, f"3i {what}")
        return out

    def n_runs(chunk, K):
        return sum(1 for _ in code_chunks([codes], DNA, chunk, K))

    (boss, valid), secs, peak = entry("out-of-core", lambda:
                                      build_boss_out_of_core(
        [codes], 20, n_shards=8, chunk_codes=OOC_CHUNK, return_valid=True,
        device=dev))
    same_as_ref(boss, ref[20, "ref"], "out-of-core k=20")
    in_peak = ref[20, "peak_bytes"]
    log(f"3i out-of-core k=20 basic, 8 shards, {n_runs(OOC_CHUNK, 20)} "
        f"pass-1 runs of <= {OOC_CHUNK} codes: {boss.num_edges} edges = 3a's "
        f"(W, last, F; small state); {secs:.2f} s (3a in-core warm "
        f"{ref[20, 'warm']:.3f} s); peak {peak / 2**30:.3f} GiB against "
        f"3a's in-core {in_peak / 2**30:.3f} GiB = {peak / in_peak:.3f}; "
        f"launches {per_entry['out-of-core']}")
    if peak > in_peak / 2:
        raise AssertionError(f"3i out-of-core peak {peak} B is over half the "
                             f"in-core peak {in_peak} B")
    n_real = int(valid.sum())
    del boss, valid

    with tempfile.TemporaryDirectory(dir=HERE) as swap:
        boss, secs, peak = entry("streaming", lambda: build_boss_streaming(
            [codes], 31, mode="canonical", chunk_codes=STREAM_CHUNK,
            disk_dir=swap, device=dev))
    same_as_ref(boss, ref[31, "ref"], "streaming k=31 canonical")
    log(f"3i streaming k=31 canonical, disk runs: "
        f"{n_runs(STREAM_CHUNK, 31)} runs spilled, {boss.num_edges} edges = "
        f"3a's (W, last, F, edge_lanes); {secs:.2f} s (3a in-core warm "
        f"{ref[31, 'warm']:.3f} s); peak {peak / 2**30:.3f} GiB (3a "
        f"{ref[31, 'peak_bytes'] / 2**30:.3f}); launches "
        f"{per_entry['streaming']}")
    del boss

    text = np.frombuffer(b"$ACGT", np.uint8)[codes].tobytes()
    boss, secs, peak = entry("suffix-sharded", lambda: build_boss_sharded(
        [text], 20, suffix_len=2, device=dev))
    same_as_ref(boss, ref[20, "ref"], "suffix-sharded k=20")
    log(f"3i suffix-sharded k=20 basic, suffix length 2 (16 buckets): "
        f"{boss.num_edges} edges = 3a's (W, last, F, edge_lanes); "
        f"{secs:.2f} s; peak {peak / 2**30:.3f} GiB; launches "
        f"{per_entry['suffix-sharded']}")
    del boss, text
    torch.cuda.empty_cache()

    boss, secs, peak = entry("out-of-core merge", lambda:
                             merge_boss_graphs_out_of_core(
        halves, n_shards=4, keep_kmer_index=True, device=dev))
    same_as_ref(boss, mem_ref, "out-of-core merge")
    log(f"3i out-of-core merge (4 shards) of 3g's halves (500 + 500 records "
        f"of the first 2^21 codes, k=31 canonical, counted): "
        f"{boss.num_edges} edges = the in-memory merge's (W, last, F, "
        f"weights, edge_lanes); {secs:.2f} s; peak {peak / 2**30:.3f} GiB; "
        f"launches {per_entry['out-of-core merge']}")
    del boss, mem_ref, halves
    launches = read_launches()
    check_launched(launches, BUILD_KERNELS, "phase 3i")
    log(f"3i: {n_real} real edges in the out-of-core graph; launch counts "
        f"{launches}; {time.time() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 3j: the distributed build (parallel/distributed.py, multihost.py)
# ---------------------------------------------------------------------------

DIST_BUILDS = ((31, "canonical"), (20, "basic"))
DIST_WIDTH = 4
DIST_TIMEOUT_S = 120


def dist_text():
    """3a's 2^25 codes as one record of text."""
    codes = np.random.default_rng(SEED).integers(1, 5, N_CODES).astype(
        np.uint8)
    return LETTERS[codes].tobytes()


def boss_digest(boss):
    """Position-weighted int64 sums of a Boss's arrays, on the card: what
    the other ranks' graphs are held to against rank 0's."""
    import torch
    out = []
    for name in ("W", "last", "F", "edge_lanes"):
        x = getattr(boss, name).to(torch.int64).reshape(-1)
        w = torch.arange(x.numel(), device=x.device) % 1000003 + 1
        out.append(int((x * w).sum()))
    return out


def dist_builds(mesh, text, check=None):
    """One rank's runs of 3j: each (k, mode) of DIST_BUILDS cold, then
    warm after a barrier, the warm run's launch counts, routes and peak
    read around it. ``check(K, boss)`` holds the warm graph to 3a's."""
    import torch
    import torch.distributed as dist
    from metagraph_tpu_torch.parallel.distributed import (
        build_boss_distributed_full)
    out = {}
    for K, mode in DIST_BUILDS:
        t0 = time.time()
        boss = build_boss_distributed_full([text], K, mesh, mode=mode)
        torch.cuda.synchronize()
        cold = time.time() - t0
        del boss
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        mesh.routes.clear()
        zero_launches()
        dist.barrier(group=mesh.group)
        t0 = time.time()
        boss = build_boss_distributed_full([text], K, mesh, mode=mode)
        torch.cuda.synchronize()
        warm = time.time() - t0
        res = dict(cold=cold, warm=warm, launches=read_launches(),
                   peak=torch.cuda.max_memory_allocated() - base,
                   routes={k: list(v) for k, v in mesh.routes.items()},
                   shard_rows=list(mesh.shard_rows), edges=boss.num_edges,
                   digest=boss_digest(boss), transport=mesh.transport)
        if check is not None:
            check(K, boss)
        del boss
        torch.cuda.empty_cache()
        out[K] = res
    return out


def dist_rank(rank, width, addr, backend, queue):
    """A spawned rank of 3j (rank >= 1): joins the group, builds, reports
    its numbers (or its traceback) on ``queue``."""
    import traceback
    sys.path.insert(0, HERE)
    import torch
    import torch.distributed as dist
    from metagraph_tpu_torch.common import _cuda
    from metagraph_tpu_torch.parallel import multihost
    try:
        multihost.initialize(addr, width, rank, device="cuda",
                             backend=backend, timeout_s=60)
        _cuda.lib()
        queue.put((rank, dist_builds(multihost.global_mesh("cuda"),
                                     dist_text())))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_width(width, backend, text, ref):
    """3j at one width: ranks 1..width-1 spawned, this process rank 0 (it
    holds 3a's graphs and compares on the card). Returns every rank's
    numbers, rank order."""
    import multiprocessing
    import torch
    import torch.distributed as dist
    from metagraph_tpu_torch.parallel import multihost

    def check(K, boss):
        for name, want in ref[K, "ref"].items():
            got = getattr(boss, name)
            if (got is None) != (want is None) or (
                    want is not None and not torch.equal(
                        got, want.to(got.device))):
                raise AssertionError(f"3j width {width} {backend} k={K}: "
                                     f"{name} differs from 3a's graph")

    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    addr = f"127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=dist_rank,
                         args=(r, width, addr, backend, queue))
             for r in range(1, width)]
    for p in procs:
        p.start()
    try:
        multihost.initialize(addr, width, 0, device="cuda", backend=backend,
                             timeout_s=60)
        res = {0: dist_builds(multihost.global_mesh("cuda"), text, check)}
        for _ in procs:
            rank, got = queue.get(timeout=DIST_TIMEOUT_S)
            if isinstance(got, str):
                raise AssertionError(f"3j rank {rank} failed:\n{got}")
            res[rank] = got
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for p in procs:
            p.join(timeout=DIST_TIMEOUT_S)
            if p.is_alive():
                p.kill()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise AssertionError(f"3j: spawned ranks exited with {bad}")
    for r in range(1, width):
        for K, _ in DIST_BUILDS:
            if res[r][K]["digest"] != res[0][K]["digest"]:
                raise AssertionError(f"3j width {width} k={K}: rank {r}'s "
                                     f"graph differs from rank 0's")
    return [res[r] for r in range(width)]


def native_parse_timing():
    """``seqio/fasta.py`` ``read_and_encode`` (the one-file build's read,
    through the native codec) against the Python parser and encoder it
    falls back to, on 3g's reads as FASTA; the codes must agree and the
    codec's route must have run."""
    from metagraph_tpu_torch.kmer.alphabets import DNA
    from metagraph_tpu_torch.kmer.extractor import encode_sequences
    from metagraph_tpu_torch.seqio import fasta
    _, reads = clean_reads(np.random.default_rng(SEED + 30), N_CODES)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "reads.fa")
        write_fasta(path, [LETTERS[r].tobytes() for r in reads], "r")
        t0 = time.time()
        got = fasta.read_and_encode(path, DNA)
        t_native = time.time() - t0
        if fasta.last_route != "native codec":
            raise AssertionError(f"3j: read_and_encode took the "
                                 f"{fasta.last_route}, not the native codec")
        t0 = time.time()
        want = encode_sequences(fasta.read_sequences(path), DNA)
        t_py = time.time() - t0
    if not np.array_equal(got, want):
        raise AssertionError("3j: the native codes differ from the Python "
                             "parser's")
    log(f"3j native codec: {len(reads)} reads ({len(want)} codes): "
        f"read_and_encode (native codec) {t_native:.3f} s (file read "
        f"included), the Python parser and encoder {t_py:.3f} s "
        f"({t_py / t_native:.1f}x); codes equal")
    return t_native, t_py


def dist_runs():
    """(width, backend) of 3j: width 1 over NCCL, width 4 over gloo on
    the one card, and width 4 over NCCL where there are four cards."""
    import torch
    runs = [(1, "nccl"), (DIST_WIDTH, "gloo")]
    if torch.cuda.device_count() >= DIST_WIDTH:
        runs.append((DIST_WIDTH, "nccl"))
    return runs


def phase_distributed(ref, runs=None, native=True):
    """3j. build_boss_distributed_full on 3a's 2^25 codes at k = 31
    canonical and k = 20 basic, at each (width, backend) of ``runs``
    (``dist_runs()``). Rank 0's warm graphs equal 3a's array for array
    (on the card), the other ranks' digests equal rank 0's; partition,
    merge and sort launch on every rank. Then (``native``) the native
    codec's parse against the port's. Returns the launch counts summed
    over every rank."""
    t_phase = time.time()
    text = dist_text()
    total = {k: 0 for k in read_launches()}
    for width, backend in runs or dist_runs():
        ranks = dist_width(width, backend, text, ref)
        for K, mode in DIST_BUILDS:
            per = [r[K] for r in ranks]
            for r, x in enumerate(per):
                check_launched(x["launches"], BUILD_KERNELS,
                               f"3j width {width} {backend} rank {r}")
                for k in total:
                    total[k] += x["launches"][k]
            edges = np.array(per[0]["shard_rows"], np.float64)
            routes = {name: sum(x["routes"][name][2] for x in per)
                      for name in per[0]["routes"]}
            secs = {name: max(x["routes"][name][3] for x in per)
                    for name in per[0]["routes"]}
            rows = {name: np.array([x["routes"][name][1] for x in per],
                                   np.float64)
                    for name in ("collect", "rc", "sink", "src_ref",
                                 "src_query") if name in per[0]["routes"]}
            warm = max(x["warm"] for x in per)
            log(f"3j width {width} ({per[0]['transport']}) k={K} {mode}: "
                f"{per[0]['edges']} edges = 3a's; warm "
                f"{warm:.3f} s (rank 0 "
                f"{per[0]['warm']:.3f}), cold {per[0]['cold']:.3f} s "
                f"(3a in-core warm {ref[K, 'warm']:.3f} s)")
            log(f"3j width {width} {backend} k={K}: edges per rank "
                f"{[int(e) for e in edges]} (max / mean "
                f"{edges.max() / edges.mean():.3f}); peak GiB per rank "
                f"{[round(x['peak'] / 2**30, 3) for x in per]}")
            log(f"3j width {width} {backend} k={K}: bytes received per route "
                f"(all ranks) {routes}; slowest rank's host s per route "
                f"{ {n: round(s, 3) for n, s in secs.items()} } (sum "
                f"{sum(secs.values()):.3f} s of the {warm:.3f} s wall); "
                f"received rows per rank, max / mean: "
                f"{ {n: round(float(r.max() / r.mean()), 3) for n, r in rows.items()} }")
            launches = [{k: x["launches"][k] for k in BUILD_KERNELS}
                        for x in per]
            log(f"3j width {width} {backend} k={K}: launches per rank "
                f"{launches}")
    if native:
        native_parse_timing()
    log(f"3j: {time.time() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# phase 3b: the alignment path
# ---------------------------------------------------------------------------

SUBS = {65: 67, 67: 65, 71: 84, 84: 71}     # transversions A<->C, G<->T


def align_reads(codes, n, rng, rl=100):
    """``n`` reads of ``rl`` bp cut from ``codes``: 6 in 8 carry one
    transversion at a position in [10, 90), 1 in 8 a 1-bp insertion or a
    2-bp deletion, 1 in 8 are random. Returns (reads, kinds, source
    windows)."""
    letters = np.frombuffer(b"$ACGT", np.uint8)
    reads, kinds, wins = [], [], []
    for i in range(n):
        kind = ("sub", "sub", "sub", "sub", "sub", "sub", "indel",
                "random")[i % 8]
        p = int(rng.integers(0, len(codes) - rl - 2))
        win = letters[codes[p:p + rl]].tobytes()
        q = int(rng.integers(10, 90))
        if kind == "sub":
            r = bytearray(win)
            r[q] = SUBS[r[q]]
            r = bytes(r)
        elif kind == "indel" and rng.random() < 0.5:
            r = win[:q] + b"ACGT"[int(rng.integers(0, 4))].to_bytes(
                1, "little") + win[q:rl - 1]
        elif kind == "indel":
            ext = letters[codes[p:p + rl + 2]].tobytes()
            r = ext[:q] + ext[q + 2:]
        else:
            r = letters[rng.integers(1, 5, rl)].tobytes()
        reads.append(r)
        kinds.append(kind)
        wins.append(win)
    return reads, kinds, wins


def phase_align(graph, bq, codes, rng):
    """Aligner.align_batch on the k = 20 graph, with CIGARs and score
    only, then the label query of the score-only spellings (what query
    --align does); returns the launch counts of the score-only run and
    the rates."""
    import torch
    from metagraph_tpu_torch.align.aligner import Aligner
    n = 1 << 13
    reads, kinds, wins = align_reads(codes, n, rng)
    al = Aligner(graph)
    t0 = time.time()
    al.align_batch(reads[:512])                    # warm: adjacency tables
    al.align_batch(reads[:512], with_cigar=False)
    torch.cuda.synchronize()
    log(f"align warm-up (adjacency tables of {graph.num_nodes()} nodes, "
        f"512 reads twice): {time.time() - t0:.2f} s")
    rates = {}
    out = {}
    for with_cigar in (True, False):
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        out[with_cigar] = al.align_batch(reads, with_cigar=with_cigar)
        torch.cuda.synchronize()
        dt = time.time() - t0
        launches = read_launches()
        rates[with_cigar] = n / dt
        log(f"align_batch {'with CIGARs' if with_cigar else 'score-only'}: "
            f"{n} reads of 100 bp in {dt:.3f} s = {n / dt:.1f} reads/s; "
            f"launches {launches}")
    if launches["pallas_dp"] <= 0:
        raise AssertionError("pallas_dp was not launched by the score-only "
                             "alignment")
    if launches["pallas_dp_long_route"]:
        # the kernels line times the wave route: the path must take it
        raise AssertionError("pallas_dp: the score-only alignment took the "
                             "long route")
    full, fast = out[True], out[False]
    # query --align: the score-only run replaces each read by its best
    # path spelling, then the labels are queried
    t0 = time.time()
    al.align_batch(reads, with_cigar=False)
    labels = bq.get_labels_batch(
        [res[0].sequence if res else r for res, r in zip(fast, reads)], 0.7)
    torch.cuda.synchronize()
    dt = time.time() - t0
    rates["query --align"] = n / dt
    n_lab = sum(1 for lab, k in zip(labels, kinds) if lab and k != "random")
    n_real = n - kinds.count("random")
    log(f"query --align: {n} reads in {dt:.3f} s = {n / dt:.1f} reads/s; "
        f"{n_lab} of {n_real} substitution and indel reads labelled")
    if n_lab < 0.98 * n_real:      # reads across a record border may miss
        raise AssertionError("query --align: too few reads labelled")
    sub_ok = sum(1 for res, k, w in zip(full, kinds, wins) if k == "sub"
                 and res and res[0].score == 195
                 and res[0].cigar.count("X") == 1 and res[0].sequence == w)
    n_sub = kinds.count("sub")
    indel_ok = sum(1 for res, k in zip(full, kinds) if k == "indel" and res)
    n_indel = kinds.count("indel")
    n_rand = sum(1 for res, k in zip(full, kinds) if k == "random" and res)
    log(f"align: {sub_ok} of {n_sub} substitution reads score 195 with one "
        f"X and spell their window; {indel_ok} of {n_indel} indel reads "
        f"align; {n_rand} of {kinds.count('random')} random reads align")
    if sub_ok < 0.99 * n_sub or indel_ok < 0.99 * n_indel:
        raise AssertionError("align: fewer than 99 % of the substitution or "
                             "indel reads align as expected")
    both = 0
    for i, (a, b) in enumerate(zip(full, fast)):
        if a and b:
            both += 1
            if (a[0].score, a[0].sequence, a[0].query_begin,
                    a[0].query_end) != (b[0].score, b[0].sequence,
                                        b[0].query_begin, b[0].query_end):
                raise AssertionError(f"align read {i}: score-only differs "
                                     f"from the CIGAR run: {a[0]} / {b[0]}")
    log(f"align: score-only equals the CIGAR run (score, sequence, span) on "
        f"all {both} reads both keep")
    return launches, rates, reads, out


# ---------------------------------------------------------------------------
# phase 3f: the small state (no edge k-mers: rank/select searches only)
# ---------------------------------------------------------------------------

# 3b's first 2^12 reads (of 2^13): the small state aligns at 250-530
# reads/s
SMALL_ALIGN_READS = 1 << 12


def phase_small_state(graph, ann, reads, labels_fast, fast_rate, aln_reads,
                      aln_out, aln_rates, dev, tmp):
    """3f. Phase 3a's k = 20 graph saved small (no edge k-mers) and loaded:
    the file is smaller than the fast one; the 2^15 reads' labels (the
    incremental rank/select walk) and 3b's first 2^12 alignments with
    CIGARs and score-only (seeds by rank/select search, suffix seeds of
    the random reads by suffix_range_ranksel, neighbours by the bwd-walk
    decode) are
    identical to the fast state's, and so is every row's decode (what
    stats --print prints). Returns the rates and the fast file in
    ``tmp``."""
    import torch
    from metagraph_tpu_torch.align.aligner import Aligner
    from metagraph_tpu_torch.engine.annotated_dbg import (AnnotatedDbg,
                                                          BatchQuery)
    from metagraph_tpu_torch.graph import io as graph_io
    from metagraph_tpu_torch.kmer import packing
    t0 = time.time()
    with stored_uncompressed():        # ≈ 40 s of host zlib otherwise
        pf = graph_io.save_graph(os.path.join(tmp, "fast"), graph)
        ps = graph_io.save_graph(os.path.join(tmp, "small"), graph,
                                 state="small")
    t_save = time.time() - t0
    sizes = os.path.getsize(pf), os.path.getsize(ps)
    gs = graph_io.load_graph(ps, device=dev)
    if gs.boss.edge_lanes is not None or sizes[1] >= sizes[0]:
        raise AssertionError(f"small state: file {sizes[1]} B, not below the "
                             f"fast state's {sizes[0]} B")
    log(f"3f small state, k=20 basic graph of 2^25 codes: .dbg.npz "
        f"{sizes[1] / 2**20:.1f} MiB small, {sizes[0] / 2**20:.1f} MiB fast, "
        f"both stored without zlib (saved in {t_save:.1f} s)")
    bq = BatchQuery(AnnotatedDbg(graph=gs, annotation=ann))
    bq.get_labels_batch(reads[:256], 0.7)                   # warm
    torch.cuda.synchronize()
    t0 = time.time()
    got = bq.get_labels_batch(reads, 0.7)
    dt = time.time() - t0
    if got != labels_fast:
        bad = next(i for i, (a, b) in enumerate(zip(got, labels_fast))
                   if a != b)
        raise AssertionError(f"small-state query: read {bad} labelled "
                             f"{got[bad]}, fast state {labels_fast[bad]}")
    rates = {"query": len(reads) / dt}
    log(f"3f small-state query: {len(reads)} reads of 100 bp in {dt:.3f} s "
        f"= {len(reads) / dt:.0f} reads/s (fast state {fast_rate:.0f} "
        f"reads/s); labels identical to the fast state's")
    al = Aligner(gs)
    sub = aln_reads[:SMALL_ALIGN_READS]
    for with_cigar in (True, False):
        torch.cuda.synchronize()
        t0 = time.time()
        out = al.align_batch(sub, with_cigar=with_cigar)
        torch.cuda.synchronize()
        dt = time.time() - t0
        what = "with CIGARs" if with_cigar else "score-only"
        _same_alignments(out, aln_out[with_cigar][:len(sub)],
                         f"small-state align {what}")
        rates[what] = len(sub) / dt
        log(f"3f small-state align_batch {what}: {len(sub)} reads in "
            f"{dt:.3f} s = {len(sub) / dt:.1f} reads/s (fast state "
            f"{aln_rates[with_cigar]:.1f}); every field identical to the "
            f"fast state's")
    # stats --print decodes every row: the bwd-walk decode of the small
    # state against the fast state's edge k-mers, in chunks of rows
    t0 = time.time()
    m = graph.boss.num_edges
    step = 1 << 22
    for lo in range(1, m + 1, step):
        rows = torch.arange(lo, min(lo + step, m + 1), device=dev)
        want = packing.unpack_to_chars(graph.boss.edge_lanes[:, rows - 1],
                                       20, 4).to(torch.int32)
        if not torch.equal(gs.boss.node_chars_ranksel(rows), want):
            raise AssertionError(f"small-state decode differs in rows "
                                 f"[{lo}, {lo + step})")
    torch.cuda.synchronize()
    log(f"3f small-state decode of all {m} rows (stats --print) equals the "
        f"edge k-mers in {time.time() - t0:.2f} s")
    del gs, bq, al
    torch.cuda.empty_cache()
    return rates, pf


def _same_alignments(got, want, what):
    for i, (gs, ws) in enumerate(zip(got, want)):
        ok = len(gs) == len(ws) and all(
            (a.score, a.cigar, a.query_begin, a.query_end, a.sequence,
             a.orientation) == (b.score, b.cigar, b.query_begin,
                                b.query_end, b.sequence, b.orientation)
            and np.array_equal(a.nodes, b.nodes) for a, b in zip(gs, ws))
        if not ok:
            raise AssertionError(f"{what}: read {i} differs: {gs} / {ws}")


def check_align_cuda_cpu(dev):
    """512 reads on a 2^20-code k = 20 graph the port builds on each
    device: CUDA and CPU alignments equal in every field."""
    from metagraph_tpu_torch.align.aligner import Aligner
    from metagraph_tpu_torch.graph.boss_construct import build_boss_from_codes
    from metagraph_tpu_torch.graph.dbg_succinct import DbgSuccinct
    rng = np.random.default_rng(SEED + 4)
    codes = rng.integers(1, 5, 1 << 20).astype(np.uint8)
    reads, _, _ = align_reads(codes, 512, rng)
    al = {d: Aligner(DbgSuccinct.from_boss(build_boss_from_codes(
        codes, 20, mode="basic", device=d), mode="basic"))
        for d in (dev, "cpu")}
    for with_cigar in (True, False):
        got, want = (al[d].align_batch(reads, with_cigar=with_cigar)
                     for d in (dev, "cpu"))
        _same_alignments(got, want, f"align CUDA vs CPU (with_cigar="
                                    f"{with_cigar})")
    log("align at 2^20 codes: CUDA results equal the CPU results in every "
        "field on 512 reads, with CIGARs and score-only")


# ---------------------------------------------------------------------------
# phase 3a-wide: a build past 8 lanes
# ---------------------------------------------------------------------------

WIDE_K = 65                     # 65 DNA chars of 4 bits: 9 lanes


def wide_gold(codes, K=WIDE_K):
    """Distinct 65-mers of a canonical graph of ``codes`` (every window
    valid): the forward windows and their reverse complements (the
    windows of the reversed complement). Counted exactly: when the first
    32 characters of all these windows are distinct, so are the windows,
    and there are 2 (N - 64) of them (an odd K has no palindromes);
    otherwise the windows are counted by their pieces (32, 32 and 1
    characters)."""
    assert K == 65
    nw = len(codes) - K + 1
    rc_codes = (np.uint8(5) - codes)[::-1]          # A <-> T, C <-> G
    ints = [fwd_kmer_ints(c, 32) for c in (codes, rc_codes)]
    firsts = np.concatenate([v[:nw] for v in ints])
    firsts.sort()
    if not np.any(firsts[1:] == firsts[:-1]):
        return 2 * nw
    pieces = np.concatenate([np.stack([v[:nw], v[32:32 + nw],
                                       c[64:].astype(np.uint64)])
                             for v, c in zip(ints, (codes, rc_codes))],
                            axis=1)
    return len(np.unique(pieces, axis=1).T)


def phase_wide_build(dev):
    """3a-wide. Phase 3a's 2^25 codes at k = 65, canonical (9 lanes: each
    sort one launch of the index route, each compaction one launch, the
    rc and dummy merges by merge-path tiles), cold and warm: real edges
    equal the
    numpy gold (the distinct forward windows and reverse complements,
    counted exactly on the host); the three build kernels launched (the
    warm build's launches logged); and the card's build of a 2^18-code
    prefix equals the CPU's array for array. Returns the warm build's
    launch counts."""
    import torch
    from metagraph_tpu_torch.common import packed
    from metagraph_tpu_torch.graph.boss_construct import build_boss_from_codes
    from metagraph_tpu_torch.kmer import packing
    codes = np.random.default_rng(SEED).integers(1, 5, N_CODES).astype(
        np.uint8)                                   # phase 3a's codes
    boss, cold = timed_build(codes, WIDE_K, "canonical", dev)
    del boss
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    boss, warm = timed_build(codes, WIDE_K, "canonical", dev)
    launches = read_launches()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    lanes = boss.edge_lanes
    real = int((~packing.contains_sentinel(lanes, WIDE_K, 4)).sum())
    ordered = bool(torch.all(packed.lt(lanes[:, :-1], lanes[:, 1:])))
    t_gold = time.time()
    gold = wide_gold(codes)
    t_gold = time.time() - t_gold
    check_launched(launches, BUILD_KERNELS, "the k=65 build")
    if real != gold:
        raise AssertionError(f"k={WIDE_K} canonical: {real} real edges, "
                             f"numpy gold {gold}")
    if not ordered:
        raise AssertionError(f"k={WIDE_K}: edge_lanes not strictly "
                             f"increasing")
    rate = (N_CODES - WIDE_K + 1) / warm
    log(f"3a-wide build k={WIDE_K} canonical ({lanes.shape[0]} lanes) 2^25 "
        f"codes: {boss.num_edges} edges, {real} real = numpy gold "
        f"(counted on the host in {t_gold:.1f} s); cold {cold:.3f} s, "
        f"warm {warm:.3f} s = {rate / 1e6:.2f} M k-mers/s; peak device "
        f"memory {peak:.1f} GiB; launches {launches}")
    del boss, lanes
    torch.cuda.empty_cache()
    prefix = codes[:1 << 18]
    got, want = (build_boss_from_codes(prefix, WIDE_K, mode="canonical",
                                       bits_per_count=8, device=d)
                 for d in (dev, "cpu"))
    for name in ("W", "last", "F", "NF", "weights", "edge_lanes"):
        if not torch.equal(getattr(got, name).cpu(), getattr(want, name)):
            raise AssertionError(f"k={WIDE_K} at 2^18 codes: CUDA {name} "
                                 f"differs from CPU")
    log(f"3a-wide: at 2^18 codes the card's k={WIDE_K} canonical build "
        f"equals the CPU's (W, last, F, NF, weights, edge_lanes)")
    return launches


# ---------------------------------------------------------------------------
# phase 3c: primary mode (the sort-based finish) and CanonicalDbg
# ---------------------------------------------------------------------------

def revcomp(seq: bytes) -> bytes:
    return seq.translate(bytes.maketrans(b"ACGT", b"TGCA"))[::-1]


def same_boss(a, b, what, names=("W", "last", "F", "NF", "weights",
                                  "edge_lanes")):
    import torch
    for name in names:
        x, y = getattr(a, name).cpu(), getattr(b, name).cpu()
        if x.shape != y.shape or not torch.equal(x, y):
            raise AssertionError(f"{what}: {name} differs")


def phase_primary(dev):
    """build_boss_from_codes(mode="primary") on the 2^25 codes at k = 31,
    then annotation and queries through CanonicalDbg; returns the build's
    launch counts."""
    import torch
    from metagraph_tpu_torch.common import merge
    from metagraph_tpu_torch.engine.annotated_dbg import (
        AnnotatedDbg, BatchQuery, annotate_sequences)
    from metagraph_tpu_torch.graph.boss_construct import build_boss_from_codes
    from metagraph_tpu_torch.graph.canonical import CanonicalDbg
    from metagraph_tpu_torch.graph.dbg_succinct import DbgSuccinct
    rng = np.random.default_rng(SEED)
    codes = rng.integers(1, 5, N_CODES).astype(np.uint8)
    K = 31
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    boss = build_boss_from_codes(codes, K, mode="primary", device=dev)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = read_launches()
    passes = merge.sort_digit_passes
    check_launched(launches, BUILD_KERNELS, "the primary build")
    peak = torch.cuda.max_memory_allocated() / 2**30
    real = check_graph(boss, codes, K, "primary")
    log(f"build k=31 primary 2^25 codes: {boss.num_edges} edges, {real} "
        f"real = numpy gold (distinct canonical forms); {dt:.3f} s (first "
        f"primary build of the run) = {(N_CODES - K + 1) / dt / 1e6:.2f} M "
        f"k-mers/s; peak device memory {peak:.1f} GiB; launches {launches}"
        f"; {passes} radix digit passes in its sorts")

    graph = CanonicalDbg(base=DbgSuccinct.from_boss(boss, mode="primary"))
    # annotation is host-bound per char: 100 records of 2^15 codes
    records = split_records(codes[:100 << 15], 100)
    labels = [f"rec_{i}" for i in range(len(records))]
    t0 = time.time()
    ann = annotate_sequences(graph, [(s, [lab]) for s, lab in
                                     zip(records, labels)]).finalize()
    torch.cuda.synchronize()
    log(f"annotate through CanonicalDbg: {len(records)} records, "
        f"{ann.matrix.nnz} relations over {graph.num_anno_rows()} rows in "
        f"{time.time() - t0:.2f} s")
    n_reads, rl = 1 << 13, 100
    which = rng.integers(0, len(records), n_reads)
    reads = []
    for r in which:
        off = int(rng.integers(0, len(records[r]) - rl + 1))
        reads.append(records[r][off:off + rl])
    reads += [revcomp(r) for r in reads]
    bq = BatchQuery(AnnotatedDbg(graph=graph, annotation=ann))
    torch.cuda.synchronize()
    t0 = time.time()
    got = bq.get_labels_batch(reads, 0.7)
    dt = time.time() - t0
    bad = [i for i in range(len(reads)) if labels[which[i % n_reads]]
           not in got[i]]
    if bad:
        raise AssertionError(f"primary query: {len(bad)} reads miss their "
                             f"label, e.g. read {bad[0]}: {got[bad[0]]}")
    log(f"query through CanonicalDbg: {n_reads} reads of {rl} bp and their "
        f"reverse complements in {dt:.3f} s = {len(reads) / dt:.0f} reads/s;"
        f" every read and reverse complement carries its record's label")
    del bq, ann
    surface_primary_align(graph, records, np.random.default_rng(SEED + 9),
                          dev)
    del graph, boss
    torch.cuda.empty_cache()

    small = np.random.default_rng(SEED + 1).integers(
        1, 5, 1 << 16).astype(np.uint8)
    small[rng.integers(0, len(small), 200)] = 255            # read breaks
    a, b = (build_boss_from_codes(small, K, mode="primary", bits_per_count=8,
                                  device=d) for d in (dev, "cpu"))
    same_boss(a, b, "2^16 codes k=31 primary, CUDA against CPU")
    log("primary build at 2^16 codes: CUDA W, last, F, NF, weights, "
        "edge_lanes equal the CPU build")
    return launches


# ---------------------------------------------------------------------------
# phase 3d: a KMC database (pre-counted k-mers, _sort_unique_stage)
# ---------------------------------------------------------------------------

def write_kmc2(base, ints, counts, k, p=4, sig_len=5):
    """Write a KMC2 database (one signature bin, forward strand only) of
    2-bit k-mer integers (first char most significant) with their counts
    (< 2^16), in the layout ``seqio/kmc.py`` reads."""
    import struct
    order = np.argsort(ints, kind="stable")
    ints, counts = ints[order], counts[order]
    n = len(ints)
    s_len, counter_size = k - p, 2
    s_bytes = (s_len + 3) // 4
    lut = np.searchsorted((ints >> np.uint64(2 * s_len)).astype(np.int64),
                          np.arange(4 ** p))
    # the suffix chars, first char in the top bits of the first byte
    suf = ((ints & np.uint64((1 << (2 * s_len)) - 1))
           << np.uint64(8 * s_bytes - 2 * s_len))
    recs = np.zeros((n, s_bytes + counter_size), np.uint8)
    for b in range(s_bytes):
        recs[:, b] = (suf >> np.uint64(8 * (s_bytes - 1 - b))) & np.uint64(255)
    for b in range(counter_size):
        recs[:, s_bytes + b] = (counts >> (8 * b)) & 255
    hdr = struct.pack("<9I", k, 0, counter_size, p, sig_len, 1,
                      1_000_000_000, n & 0xFFFFFFFF, n >> 32)
    hdr += bytes([1])                                   # forward strand
    hdr += b"\0" * (64 - len(hdr) - 4) + struct.pack("<I", 0x200)
    sig_map = np.zeros(4 ** sig_len + 1, np.uint32)
    with open(base + ".kmc_pre", "wb") as f:
        f.write(b"KMCP" + lut.astype("<u8").tobytes() + sig_map.tobytes()
                + hdr + struct.pack("<I", len(hdr)) + b"KMCP")
    with open(base + ".kmc_suf", "wb") as f:
        f.write(b"KMCS" + recs.tobytes() + b"KMCS")
    return base


def phase_kmc(dev):
    """The forward k = 31 k-mers of the first 2^24 codes with their numpy
    counts as a KMC2 database, read by seqio/kmc.py and built by
    collect_counted_kmers + build_boss_from_kmers (basic, 8-bit counts);
    the graph must equal build_boss_from_codes on the same codes."""
    import torch
    from metagraph_tpu_torch.graph.boss_construct import (
        build_boss_from_codes, build_boss_from_kmers, collect_counted_kmers)
    from metagraph_tpu_torch.seqio.kmc import read_kmers
    K = 31
    codes = np.random.default_rng(SEED).integers(
        1, 5, N_CODES).astype(np.uint8)[:1 << 24]
    ints, counts = np.unique(fwd_kmer_ints(codes, K), return_counts=True)
    with tempfile.TemporaryDirectory() as tmp:
        base = write_kmc2(os.path.join(tmp, "db"), ints, counts, K)
        t0 = time.time()
        chars, kcounts, hdr = read_kmers(base)
        t_read = time.time() - t0
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    lanes, cnts, n = collect_counted_kmers(chars, kcounts, K, device=dev)
    boss = build_boss_from_kmers(lanes, cnts, n, K, bits_per_count=8)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = read_launches()
    check_launched(launches, BUILD_KERNELS, "the KMC build")
    ref = build_boss_from_codes(codes, K, mode="basic", bits_per_count=8,
                                device=dev)
    same_boss(boss, ref, "KMC build against the build from codes")
    log(f"KMC: {hdr.total_kmers} k-mers (k=31, 2^24 codes) read in "
        f"{t_read:.2f} s; collect_counted_kmers + build_boss_from_kmers "
        f"{dt:.3f} s; {boss.num_edges} edges; W, last, F, NF, weights, "
        f"edge_lanes equal build_boss_from_codes on the codes; launches "
        f"{launches}")
    del boss, ref, lanes, cnts
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 3e: the rest of the ported commands' surface
# ---------------------------------------------------------------------------

def weighted_gold(contigs, counts, K, max_count=255):
    """numpy gold of a canonical build from contigs with per-k-mer
    counts: each canonical k-mer's counts summed, both orientations
    carrying the sum saturated at ``max_count`` (K odd: no palindromes).
    Returns (2-bit keys, weights), sorted by key."""
    fwd = np.concatenate([fwd_kmer_ints(c, K) for c in contigs])
    rc = np.concatenate([rc_kmer_ints(c, K) for c in contigs])
    keys, inv = np.unique(np.minimum(fwd, rc), return_inverse=True)
    sums = np.zeros(len(keys), np.int64)
    np.add.at(sums, inv, np.concatenate(counts).astype(np.int64))
    all_keys = np.concatenate([keys, revcomp_ints(keys, K)])
    all_w = np.minimum(np.concatenate([sums, sums]), max_count)
    order = np.argsort(all_keys, kind="stable")
    return all_keys[order], all_w[order]


def graph_keys_weights(boss, K):
    """The real edges of a graph as 2-bit k-mer keys (computed on the
    card from the edge k-mers) with their weights, sorted by key."""
    import torch
    from metagraph_tpu_torch.kmer.packing import unpack_to_chars
    chars = unpack_to_chars(boss.edge_lanes, K, boss.bits_per_char)
    real = (chars != 0).all(dim=1)
    chars = chars[real]
    key = torch.zeros(chars.shape[0], dtype=torch.int64, device=chars.device)
    for j in range(K):
        key = (key << 2) | (chars[:, j].to(torch.int64) - 1)
    key = key.cpu().numpy().astype(np.uint64)
    w = boss.weights[1:][real].cpu().numpy().astype(np.int64)
    order = np.argsort(key, kind="stable")
    return key[order], w[order]


def phase_sidecar(dev):
    """3e. A count-sidecar build, what build --count-kmers runs over
    contigs with .kmer_counts.gz sidecars: the first 2^22 of the 2^25
    codes cut into 256 contigs with random per-k-mer counts 1-300, k = 31
    canonical, 8-bit weights (cut from 2^25: the text sidecars are
    written and parsed on the host). Checks: the weights equal a numpy
    gold that sums and saturates; the three build kernels launched."""
    import torch
    from metagraph_tpu_torch.cli.main import sidecar_kmers
    from metagraph_tpu_torch.graph.boss_construct import (
        build_boss_from_kmers, collect_counted_kmers)
    from metagraph_tpu_torch.kmer.alphabets import DNA
    from metagraph_tpu_torch.seqio.fasta import ExtendedFastaWriter
    K, n_ctg = 31, 256
    codes = np.random.default_rng(SEED).integers(
        1, 5, N_CODES).astype(np.uint8)[:1 << 22]
    contigs = np.split(codes, n_ctg)
    rng = np.random.default_rng(SEED + 5)
    counts = [rng.integers(1, 301, len(c) - K + 1) for c in contigs]
    letters = np.frombuffer(b"$ACGT", np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "contigs")
        t0 = time.time()
        with ExtendedFastaWriter(base, K) as w:
            for c, n in zip(contigs, counts):
                w.write(letters[c].tobytes(), n)
        t_write = time.time() - t0
        t0 = time.time()
        chars, kcounts = sidecar_kmers([base + ".fasta.gz"], K, DNA)
        t_read = time.time() - t0
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    lanes, cnts, n = collect_counted_kmers(chars, kcounts, K, DNA,
                                           canonical=True, device=dev)
    boss = build_boss_from_kmers(lanes, cnts, n, K, DNA, mode="canonical",
                                 bits_per_count=8)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = read_launches()
    check_launched(launches, BUILD_KERNELS, "the sidecar build")
    gk, gw = weighted_gold(contigs, counts, K)
    key, w = graph_keys_weights(boss, K)
    if not (np.array_equal(key, gk) and np.array_equal(w, gw)):
        raise AssertionError("sidecar build: real edges or weights differ "
                             "from the numpy gold")
    rate = len(chars) / dt
    log(f"3e sidecar build, k=31 canonical, 256 contigs of the first 2^22 "
        f"codes, counts 1-300: {len(chars)} k-mers; sidecars written in "
        f"{t_write:.2f} s, read in {t_read:.2f} s (host); "
        f"collect_counted_kmers + build_boss_from_kmers {dt:.3f} s = "
        f"{rate / 1e6:.2f} M k-mers/s; {len(key)} real edges and their "
        f"weights (sums saturated at 255: {int((gw == 255).sum())}) equal "
        f"the numpy gold; launches {launches}")
    return launches, rate


def surface_query_modes(graph, records, labels, reads, which, cpu_graph):
    """3e. A count annotation (annotate --count-kmers) of phase 3a's 1000
    records, then its reads through the --query-counts,
    --count-quantiles "0 0.5 1" and --print-signature executors. Checks:
    every sampled read reports its record's label (with at least
    min_count k-mers), and CUDA equals the CPU on 512 reads."""
    import torch
    from metagraph_tpu_torch.anno.annotator import annotation_from_numpy
    from metagraph_tpu_torch.engine.annotated_dbg import (
        AnnotatedDbg, BatchQuery, annotate_sequences)
    t0 = time.time()
    ann = annotate_sequences(graph, [(s, [lab]) for s, lab in
                                     zip(records, labels)],
                             with_counts=True).finalize()
    torch.cuda.synchronize()
    log(f"3e annotate --count-kmers: {len(records)} records, {ann.matrix.nnz} "
        f"relations with values in {time.time() - t0:.2f} s")
    bq = BatchQuery(AnnotatedDbg(graph=graph, annotation=ann))
    anno_np = dict(ann.matrix.to_npz_dict(),
                   labels=np.array(ann.encoder.labels))
    cpu_bq = BatchQuery(AnnotatedDbg(
        graph=cpu_graph, annotation=annotation_from_numpy(anno_np, "cpu")))
    top, ratio = 2 ** 62, 0.7
    modes = {
        "--query-counts": lambda b, rs: b.get_top_labels_batch(
            rs, top, ratio, with_kmer_counts=True),
        "--count-quantiles": lambda b, rs: b.get_label_count_quantiles_batch(
            rs, top, ratio, (0.0, 0.5, 1.0)),
        "--print-signature": lambda b, rs: b.get_top_label_signatures_batch(
            rs, top, ratio),
    }
    min_count = int(np.ceil(ratio * (len(reads[0]) - graph.k + 1)))
    sub = reads[:256] + reads[-256:]
    rates = {}
    for name, fn in modes.items():
        fn(bq, reads[:256])                                     # warm
        torch.cuda.synchronize()
        t0 = time.time()
        got = fn(bq, reads)
        dt = time.time() - t0
        rates[name] = len(reads) / dt
        for i, r in enumerate(which):
            res = dict(got[i])
            if labels[r] not in res:
                raise AssertionError(f"{name}: read {i} misses its label: "
                                     f"{got[i]}")
            v = res[labels[r]]
            if name == "--query-counts":
                ok = v >= min_count
            elif name == "--count-quantiles":
                ok = len(v) == 3 and v[2] >= 1
            else:
                ok = int(v.sum()) >= min_count
            if not ok:
                raise AssertionError(f"{name}: read {i}: {labels[r]} -> {v}")
        a, b = fn(bq, sub), fn(cpu_bq, sub)
        if name == "--print-signature":
            same = all([x[0] for x in p] == [x[0] for x in q] and all(
                np.array_equal(x[1], y[1]) for x, y in zip(p, q))
                for p, q in zip(a, b))
        else:
            same = a == b
        if not same:
            raise AssertionError(f"{name}: CUDA results differ from CPU")
        log(f"3e query {name}: {len(reads)} reads of 100 bp in {dt:.3f} s = "
            f"{len(reads) / dt:.0f} reads/s; all {len(which)} sampled reads "
            f"report their record's label; CUDA equals CPU on 512 reads")
    return rates, ann


def surface_validate(graph, gold_real):
    """3e. stats --validate --count-dummy on the k = 20 basic graph of
    2^25 codes: validation OK; the dummy counts equal numpy's reading of
    the edge k-mers; real edges equal the numpy gold."""
    import torch
    from metagraph_tpu_torch.cli.main import validate_graph
    from metagraph_tpu_torch.common import packed
    boss = graph.boss
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.time()
    errs = validate_graph(graph)
    nsrc, nsink = (int(x) for x in boss.num_dummy_edges())
    torch.cuda.synchronize()
    dt = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    if errs:
        raise AssertionError(f"stats --validate: {errs}")
    low = packed.lanes_to_numpy(boss.edge_lanes[-1])        # fields 0, 1
    src = ((low >> 4) & 15) == 0
    sink = ((low & 15) == 0) & ~src
    if (nsrc, nsink) != (int(src.sum()), int(sink.sum())):
        raise AssertionError(f"--count-dummy: ({nsrc}, {nsink}) != numpy "
                             f"({int(src.sum())}, {int(sink.sum())})")
    if boss.num_edges - nsrc - nsink != gold_real:
        raise AssertionError("--count-dummy: real edges differ from numpy")
    log(f"3e stats --validate --count-dummy, k=20 basic graph of 2^25 "
        f"codes ({boss.num_edges} edges): OK in {dt:.3f} s, peak device "
        f"memory {peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} GiB "
        f"above the graph); {nsrc} dummy source and {nsink} dummy sink "
        f"edges = numpy, {gold_real} real = numpy gold")
    return dt, peak


def primary_reads(records, n, rng, rl=100):
    """``n`` reads of ``rl`` bp cut from ``records``, every other one
    reverse-complemented, each with one transversion at a position in
    [10, 90); returns (reads, the unmutated reads)."""
    reads, wants = [], []
    for i in range(n):
        rec = records[int(rng.integers(0, len(records)))]
        off = int(rng.integers(0, len(rec) - rl + 1))
        win = rec[off:off + rl]
        if i % 2:
            win = revcomp(win)
        r = bytearray(win)
        q = int(rng.integers(10, 90))
        r[q] = SUBS[r[q]]
        reads.append(bytes(r))
        wants.append(win)
    return reads, wants


def surface_primary_align(graph, records, rng, dev):
    """3e. align / query --align on phase 3c's primary graph (through
    CanonicalDbg): 2^13 reads of its records and reverse complements with
    one transversion each, with CIGARs and score-only. Checks: >= 99 %
    score 195 with one X and spell the unmutated read, score-only agrees,
    pallas_dp launched; on a 2^18-code primary graph built on each
    device, 512 such reads align identically on CUDA and on the CPU."""
    import torch
    from metagraph_tpu_torch.align.aligner import Aligner
    from metagraph_tpu_torch.graph.boss_construct import build_boss_from_codes
    from metagraph_tpu_torch.graph.canonical import CanonicalDbg
    from metagraph_tpu_torch.graph.dbg_succinct import DbgSuccinct
    n = 1 << 13
    reads, wants = primary_reads(records, n, rng)
    al = Aligner(graph)
    t0 = time.time()
    al.align_batch(reads[:512])                    # warm: adjacency tables
    al.align_batch(reads[:512], with_cigar=False)
    torch.cuda.synchronize()
    log(f"3e primary align warm-up (adjacency tables of "
        f"{graph.num_nodes()} virtual nodes, 512 reads twice): "
        f"{time.time() - t0:.2f} s")
    out = {}
    for with_cigar in (True, False):
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        out[with_cigar] = al.align_batch(reads, with_cigar=with_cigar)
        torch.cuda.synchronize()
        dt = time.time() - t0
        launches = read_launches()
        what = "with CIGARs" if with_cigar else "score-only"
        log(f"3e primary align_batch {what}: {n} reads in {dt:.3f} s = "
            f"{n / dt:.1f} reads/s; launches {launches}")
    check_launched(launches, ("pallas_dp",), "the primary score-only "
                   "alignment")
    ok = sum(1 for res, w in zip(out[True], wants) if res
             and res[0].score == 195 and res[0].cigar.count("X") == 1
             and res[0].sequence == w)
    fast_ok = sum(1 for res, w in zip(out[False], wants) if res
                  and res[0].score == 195 and res[0].sequence == w)
    if ok < 0.99 * n or fast_ok < 0.99 * n:
        raise AssertionError(f"primary align: {ok} / {fast_ok} of {n} reads "
                             f"as expected")
    for i, (a, b) in enumerate(zip(out[True], out[False])):
        if a and b and (a[0].score, a[0].sequence, a[0].query_begin,
                        a[0].query_end) != (b[0].score, b[0].sequence,
                                            b[0].query_begin, b[0].query_end):
            raise AssertionError(f"primary align read {i}: score-only "
                                 f"differs from the CIGAR run")
    log(f"3e primary align: {ok} (CIGARs) and {fast_ok} (score-only) of {n} "
        f"reads score 195 with one X and spell their unmutated read; "
        f"score-only equals the CIGAR run")
    small = np.random.default_rng(SEED + 6).integers(
        1, 5, 1 << 18).astype(np.uint8)
    s_reads, _ = primary_reads(split_records(small, 16), 512,
                               np.random.default_rng(SEED + 7))
    als = {d: Aligner(CanonicalDbg(base=DbgSuccinct.from_boss(
        build_boss_from_codes(small, 31, mode="primary", device=d),
        mode="primary"))) for d in (dev, "cpu")}
    for with_cigar in (True, False):
        got, want = (als[d].align_batch(s_reads, with_cigar=with_cigar)
                     for d in (dev, "cpu"))
        _same_alignments(got, want, f"primary align CUDA vs CPU "
                                    f"(with_cigar={with_cigar})")
    log("3e primary align at 2^18 codes: CUDA results equal the CPU results "
        "in every field on 512 reads, with CIGARs and score-only")


# ---------------------------------------------------------------------------
# phase 3f: the other alphabets (DNA5, DNACaseSent, Protein)
# ---------------------------------------------------------------------------

def alphabet_build(codes, K, alphabet, mode, dev, what):
    """One build on the card with the launch counts zeroed just before and
    read just after; the three build kernels must have launched. Returns
    (boss, seconds, peak GiB, launches, radix digit passes)."""
    import torch
    from metagraph_tpu_torch.common import merge
    from metagraph_tpu_torch.graph.boss_construct import build_boss_from_codes
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    boss = build_boss_from_codes(codes, K, alphabet, mode=mode, device=dev)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = read_launches()
    check_launched(launches, BUILD_KERNELS, what)
    return (boss, dt, torch.cuda.max_memory_allocated() / 2**30, launches,
            merge.sort_digit_passes)


def check_prefix(codes, K, alphabet, mode, dev, what):
    """The card's build of a 2^18-code prefix, with 8-bit counts, equals
    the port's CPU build, array for array."""
    from metagraph_tpu_torch.graph.boss_construct import build_boss_from_codes
    a, b = (build_boss_from_codes(codes[:1 << 18], K, alphabet, mode=mode,
                                  bits_per_count=8, device=d)
            for d in (dev, "cpu"))
    same_boss(a, b, f"{what}, 2^18-code prefix, CUDA against CPU")


def validate(boss, alphabet, mode, what):
    from metagraph_tpu_torch.cli.main import validate_graph
    from metagraph_tpu_torch.graph.dbg_succinct import DbgSuccinct
    t0 = time.time()
    errs = validate_graph(DbgSuccinct.from_boss(boss, alphabet, mode))
    if errs:
        raise AssertionError(f"{what}: stats --validate: {errs}")
    return time.time() - t0


def protein_align_reads(records, n, rng, b62, tbl, rl=100):
    """``n`` reads of ``rl`` residues cut from the records, each with one
    substitution at a position in [10, 90) by another of the twenty
    amino acids; with each read its source window and the BLOSUM62 score
    of the window with that one X."""
    letters = np.frombuffer(PROTEIN_LETTERS, np.uint8)
    reads, wins, want = [], [], []
    for _ in range(n):
        rec = records[int(rng.integers(0, len(records)))]
        off = int(rng.integers(0, len(rec) - rl + 1))
        win = rec[off:off + rl]
        q = int(rng.integers(10, 90))
        sub = letters[letters != win[q]][int(rng.integers(0, 19))]
        r = bytearray(win)
        r[q] = sub
        c = tbl[np.frombuffer(win, np.uint8)]
        want.append(int(b62[c, c].sum() - b62[c[q], c[q]]
                        + b62[tbl[sub], c[q]]))
        reads.append(bytes(r))
        wins.append(win)
    return reads, wins, want


def phase_protein(dev):
    """3f. Protein at k = 31 (eight lanes), basic: 2^25 residues drawn
    uniformly from the twenty amino acids as 1000 records. Random 31-mers
    over 20 letters do not repeat, so the real edges must number the
    valid windows exactly; stats --validate passes; the card's build of
    the first 2^18 codes equals the CPU build. Then the 1000 records
    annotated (label_{i % 10}), 2^15 reads of 100 residues queried, and
    2^13 reads with one substitution aligned with CIGARs and score-only
    (BLOSUM62, the DP at sigma = 27). Returns the build's and the
    score-only run's launch counts."""
    import torch
    from metagraph_tpu_torch.align.aligner import Aligner, blosum62_matrix
    from metagraph_tpu_torch.engine.annotated_dbg import (
        AnnotatedDbg, BatchQuery, annotate_sequences)
    from metagraph_tpu_torch.graph.dbg_succinct import DbgSuccinct
    from metagraph_tpu_torch.kmer import packing
    from metagraph_tpu_torch.kmer.alphabets import PROTEIN
    from metagraph_tpu_torch.kmer.extractor import encode_sequences
    K = 31
    rng = np.random.default_rng(SEED + 20)
    letters = np.frombuffer(PROTEIN_LETTERS, np.uint8)
    res = letters[rng.integers(0, 20, N_CODES)]
    cuts = np.linspace(0, N_CODES, 1001).astype(np.int64)
    records = [res[cuts[i]:cuts[i + 1]].tobytes() for i in range(1000)]
    codes = encode_sequences(records, PROTEIN)
    boss, dt, peak, launches, passes = alphabet_build(
        codes, K, PROTEIN, "basic", dev, "the Protein build")
    real = int((~packing.contains_sentinel(boss.edge_lanes, K, 8)).sum())
    gold = sum(len(r) - K + 1 for r in records)
    if real != gold:
        raise AssertionError(f"Protein k=31: {real} real edges, not the "
                             f"{gold} valid windows")
    t_val = validate(boss, PROTEIN, "basic", "Protein k=31")
    log(f"3f build Protein k=31 basic (8 lanes), 2^25 residues in 1000 "
        f"records: {boss.num_edges} edges, {real} real = the valid windows; "
        f"{dt:.3f} s (first Protein build of the run) = "
        f"{gold / dt / 1e6:.2f} M k-mers/s; peak device memory {peak:.1f} "
        f"GiB; launches {launches}; {passes} radix digit passes in its "
        f"sorts; stats --validate OK in {t_val:.2f} s")
    check_prefix(codes, K, PROTEIN, "basic", dev, "Protein k=31")
    graph = DbgSuccinct.from_boss(boss, PROTEIN, "basic")
    labels = [f"label_{i % 10}" for i in range(len(records))]
    t0 = time.time()
    ann = annotate_sequences(graph, [(s, [lab]) for s, lab in
                                     zip(records, labels)]).finalize()
    torch.cuda.synchronize()
    log(f"3f annotate Protein: 1000 records, {ann.matrix.nnz} relations in "
        f"{time.time() - t0:.2f} s")
    n_reads, rl = 1 << 15, 100
    which = rng.integers(0, len(records), n_reads // 2)
    reads = []
    for r in which:
        off = int(rng.integers(0, len(records[r]) - rl + 1))
        reads.append(records[r][off:off + rl])
    reads += [letters[rng.integers(0, 20, rl)].tobytes()
              for _ in range(n_reads - len(reads))]
    bq = BatchQuery(AnnotatedDbg(graph=graph, annotation=ann))
    bq.get_labels_batch(reads[:256], 0.7)
    torch.cuda.synchronize()
    t0 = time.time()
    got = bq.get_labels_batch(reads, 0.7)
    dt = time.time() - t0
    bad = [i for i, r in enumerate(which) if labels[r] not in got[i]]
    if bad:
        raise AssertionError(f"Protein query: {len(bad)} sampled reads miss "
                             f"their label, e.g. read {bad[0]}")
    log(f"3f query Protein: {n_reads} reads of {rl} residues in {dt:.3f} s "
        f"= {n_reads / dt:.0f} reads/s; every sampled read carries its "
        f"record's label")
    del bq, ann
    b62 = blosum62_matrix(PROTEIN)
    tbl = PROTEIN.encode_table()
    n = 1 << 13
    aln_reads, wins, want = protein_align_reads(records, n, rng, b62, tbl)
    al = Aligner(graph)
    al.align_batch(aln_reads[:256])
    al.align_batch(aln_reads[:256], with_cigar=False)
    out, rates = {}, {}
    for with_cigar in (True, False):
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        out[with_cigar] = al.align_batch(aln_reads, with_cigar=with_cigar)
        torch.cuda.synchronize()
        rates[with_cigar] = n / (time.time() - t0)
    align_launches = read_launches()
    check_launched(align_launches, ("pallas_dp",), "the Protein score-only "
                   "alignment")
    ok = sum(1 for res, w, s in zip(out[True], wins, want) if res
             and res[0].score == s and res[0].cigar.count("X") == 1
             and res[0].sequence == w)
    if ok < 0.99 * n:
        raise AssertionError(f"Protein align: {ok} of {n} reads score the "
                             f"BLOSUM62 sum of their window with one X")
    for i, (a, b) in enumerate(zip(out[True], out[False])):
        if bool(a) != bool(b) or a and (
                a[0].score, a[0].sequence, a[0].query_begin,
                a[0].query_end) != (b[0].score, b[0].sequence,
                                    b[0].query_begin, b[0].query_end):
            raise AssertionError(f"Protein align read {i}: score-only "
                                 f"differs from the CIGAR run")
    log(f"3f align Protein (BLOSUM62): {n} reads of 100 residues, "
        f"{rates[True]:.1f} reads/s with CIGARs, {rates[False]:.1f} "
        f"score-only; {ok} score the BLOSUM62 sum of their window with one "
        f"X and spell it; score-only equals the CIGAR run; score-only "
        f"launches {align_launches}")
    del graph, boss, al
    torch.cuda.empty_cache()
    return launches, align_launches


def phase_alphabets(dev):
    """3f. Protein (above); DNA5 at k = 31 canonical over the 2^25
    main-path codes with 1 % set to N; DNACaseSent at k = 31 primary over
    the same codes with alternate runs of 1000 bases in lower case (an N
    there becomes n, which the reference leaves unmapped: a read break).
    For both: stats --validate at full size, the card's build of a
    2^18-code prefix equal to the CPU build, edges and peak memory.
    Returns the launch counts of the builds and of the score-only
    alignment, summed."""
    import torch
    from metagraph_tpu_torch.kmer.alphabets import DNA5, DNA_CASE_SENT
    launches, align_launches = phase_protein(dev)
    rng = np.random.default_rng(SEED)
    codes = rng.integers(1, 5, N_CODES).astype(np.uint8)   # bench_capacity
    codes[np.random.default_rng(SEED + 21).random(N_CODES) < 0.01] = 5
    lower = (np.arange(N_CODES) // 1000) % 2 == 1
    cs = codes.copy()
    cs[lower] = np.where(codes[lower] == 5, 255, codes[lower] + 5)
    for alphabet, mode, c in ((DNA5, "canonical", codes),
                              (DNA_CASE_SENT, "primary", cs)):
        what = f"{alphabet.name} k=31 {mode}"
        boss, dt, peak, lc, passes = alphabet_build(c, 31, alphabet, mode,
                                                    dev, f"the {what} build")
        t_val = validate(boss, alphabet, mode, what)
        log(f"3f build {what}, 2^25 codes: {boss.num_edges} edges; "
            f"{dt:.3f} s (first {alphabet.name} build of the run) = "
            f"{(N_CODES - 30) / dt / 1e6:.2f} M windows/s; peak device "
            f"memory {peak:.1f} GiB; launches {lc}; {passes} radix digit "
            f"passes; stats --validate OK in {t_val:.2f} s")
        for name in BUILD_KERNELS:
            launches[name] += lc[name]
        del boss
        torch.cuda.empty_cache()
        check_prefix(c, 31, alphabet, mode, dev, what)
    log("3f DNA5 and DNACaseSent: the card's builds of the 2^18-code "
        "prefixes equal the CPU builds, array for array")
    return launches, align_launches


# ---------------------------------------------------------------------------
# phase 4: the CLI
# ---------------------------------------------------------------------------

class _StdinList(io.StringIO):
    """A file list piped to stdin (not a terminal)."""

    def isatty(self):
        return False


def cli_in_process(device, zlib=True):
    """A runner of the CLI's ``main`` in this process on ``device``:
    returns its stdout; a non-zero exit raises. Without ``zlib`` its
    .npz files are stored uncompressed (``stored_uncompressed``)."""
    from metagraph_tpu_torch.cli.main import main as cli

    def run(*argv, stdin=None):
        buf, old = io.StringIO(), sys.stdin
        try:
            if stdin is not None:
                sys.stdin = _StdinList(stdin)
            with contextlib.redirect_stdout(buf), (
                    contextlib.nullcontext() if zlib
                    else stored_uncompressed()):
                cli([*argv, "--device", device])
        except SystemExit as e:
            if e.code not in (0, None):
                raise AssertionError(f"CLI {' '.join(argv)} exited {e.code}")
        finally:
            sys.stdin = old
        return buf.getvalue()

    return run


def cli_surface(tmp, names, seqs, gp, both_fa, device):
    """Phase 4, the flags of the rest of the surface, through the CLI's
    ``main`` in this process: builds from two files (with the global and
    parity flags), from a stdin list, with --fwd-and-reverse and from
    count sidecars; stats --validate --count-dummy --print
    --print-internal and --print-col-names; annotate's header flags;
    query --query-counts, --count-quantiles, --print-signature
    --fwd-and-reverse; align and query --align on the primary graph."""
    import torch
    from metagraph_tpu_torch.graph.io import load_graph
    from metagraph_tpu_torch.seqio.fasta import ExtendedFastaWriter

    run = cli_in_process(device)

    def path(name):
        return os.path.join(tmp, name)

    acgt = np.frombuffer(b"ACGT", np.uint8)
    codes = [np.searchsorted(acgt, np.frombuffer(s.encode(), np.uint8)) + 1
             for s in seqs]
    half = len(names) // 2
    for fname, lo, hi in (("a.fa", 0, half), ("b.fa", half, len(names))):
        with open(path(fname), "w") as f:
            for name, seq in zip(names[lo:hi], seqs[lo:hi]):
                f.write(f">{name}|grp{int(name[3:]) % 3} cmt\n{seq}\n")
    t0 = time.time()
    run("build", "-k", "31", "-o", path("g2"), path("a.fa"), path("b.fa"),
        "-v", "-p", "4", "--mask-dummy", "--clear-dummy", "--threads", "2")
    gold = len(np.unique(np.concatenate([fwd_kmer_ints(c, 31)
                                         for c in codes])))
    g2 = load_graph(path("g2"), device=device)
    if g2.num_nodes() != gold:
        raise AssertionError(f"CLI build of two files: not {gold} nodes")
    run("build", "-k", "31", "-o", path("gstdin"),
        stdin=f"{path('a.fa')}\n\n{path('b.fa')}\n")
    g_in = load_graph(path("gstdin"), device=device)
    if not (torch.equal(g_in.boss.edge_lanes, g2.boss.edge_lanes)
            and torch.equal(g_in.boss.W, g2.boss.W)):
        raise AssertionError("CLI build from a stdin list differs from the "
                             "build of the named files")
    run("build", "-k", "31", "--fwd-and-reverse", "-o", path("gfr"),
        path("a.fa"), path("b.fa"))
    fwd = np.concatenate([fwd_kmer_ints(c, 31) for c in codes])
    rc = np.concatenate([rc_kmer_ints(c, 31) for c in codes])
    closure = len(np.unique(np.concatenate([fwd, rc])))
    if load_graph(path("gfr"), device=device).num_nodes() != closure:
        raise AssertionError(f"CLI build --fwd-and-reverse: not {closure} "
                             f"nodes")
    rng = np.random.default_rng(SEED + 8)
    counts = [rng.integers(1, 301, len(c) - 30) for c in codes]
    with ExtendedFastaWriter(path("ctg"), 31) as w:
        for name, seq, n in zip(names, seqs, counts):
            w.write(seq, n, name=name)
    run("build", "-k", "31", "--mode", "canonical", "--count-kmers", "-o",
        path("gsc"), path("ctg.fasta.gz"))
    gk, gw = weighted_gold(codes, counts, 31)
    key, wt = graph_keys_weights(load_graph(path("gsc"), device=device).boss,
                                 31)
    if not (np.array_equal(key, gk) and np.array_equal(wt, gw)):
        raise AssertionError("CLI build from count sidecars: weights differ "
                             "from the numpy gold")
    out = run("stats", "--validate", "--count-dummy", "--print",
              "--print-internal", path("gfr"))
    m = load_graph(path("gfr"), device=device).boss.num_edges
    if "validation: OK" not in out or "dummy sink edges" not in out or \
            out.count("\n") < 2 * m:
        raise AssertionError(f"CLI stats flags output wrong:\n{out[:300]}")
    # labels per record: its name, its group and the header's comment
    run("build", "-k", "31", "--mode", "canonical", "-o", path("gc"),
        path("a.fa"), path("b.fa"))
    one, two = (load_graph(path(x), device=device).boss for x in ("g", "gc"))
    if not all(torch.equal(getattr(one, a), getattr(two, a))
               for a in ("edge_lanes", "W", "F")) or not torch.equal(
                   one.last_rank.words, two.last_rank.words):
        raise AssertionError("CLI build of one file (native codec) differs "
                             "from the build of its records in two files")
    run("annotate", "-i", path("gc"), "--anno-header", "--header-delimiter",
        "|", "--header-comment-delim", "|", "--count-kmers", "--separately",
        "-o", path("anno"), path("a.fa"), path("b.fa"))
    anno = path("anno.column.annodbg.npz")
    cols = run("stats", "--print-col-names", anno)
    if not all(f"<{x}>" in cols for x in ("rec0", "grp2", "cmt")):
        raise AssertionError(f"CLI annotate header flags: labels {cols}")
    fa = path("in.fa")
    lines = run("query", "--query-counts", "-i", path("gc"), "-a", anno,
                fa).splitlines()
    for line, name, seq in zip(lines, names, seqs):
        want = f"<{name}>:{len(seq) - 30}"
        if want not in line.split("\t"):
            raise AssertionError(f"CLI query --query-counts: {line[:200]}")
    lines = run("query", "--count-quantiles", "0 0.5 1", "-i", path("gc"),
                "-a", anno, fa).splitlines()
    if len(lines) != len(names) or any(
            f"<{name}>:1:1:1" not in line.split("\t")
            for line, name in zip(lines, names)):
        raise AssertionError(f"CLI query --count-quantiles: {lines[:2]}")
    lines = run("query", "--print-signature", "--fwd-and-reverse", "-i",
                path("gc"), "-a", anno, fa).splitlines()
    for i, line in enumerate(lines):
        n = len(seqs[i // 2]) - 30
        want = f"<{names[i // 2]}>:{n}:{'1' * n}:"
        if not any(x.startswith(want) for x in line.split("\t")[2:]):
            raise AssertionError(f"CLI query --print-signature "
                                 f"--fwd-and-reverse: {line[:200]}")
    if len(lines) != 2 * len(names):
        raise AssertionError("CLI query --fwd-and-reverse: line count")
    both = [(n, s) for n in names for s in (seqs[names.index(n)],
                                            revcomp(seqs[names.index(n)]
                                                    .encode()).decode())]
    rows = [line.split("\t") for line in
            run("align", "-i", gp, both_fa).splitlines()]
    if [r[0] for r in rows] != [n for n, _ in both] or any(
            r[1:] != [s, "+", s, str(2 * len(s)), str(len(s)), f"{len(s)}=",
                      "0"] for r, (_, s) in zip(rows, both)):
        raise AssertionError(f"CLI align on the primary graph: {rows[:2]}")
    out = run("query", "--align", "-i", gp, "-a",
              gp + ".column.annodbg.npz", both_fa)
    if out.splitlines() != [f"{i}\t{n}\t{n}" for i, (n, _) in
                            enumerate(both)]:
        raise AssertionError(f"CLI query --align on the primary graph: "
                             f"{out.splitlines()[:3]}")
    log(f"CLI (in process, --device {device}, {time.time() - t0:.1f} s): "
        f"build of two files with -v -p 4 --mask-dummy --clear-dummy "
        f"--threads = {gold} nodes (numpy), from a stdin list = the same "
        f"graph, --fwd-and-reverse = {closure} nodes (numpy closure), the "
        f"canonical build of the two files = phase 4's one-file build "
        f"through the native codec, from "
        f"count sidecars = numpy weights; stats --validate --count-dummy "
        f"--print --print-internal OK; annotate --header-delimiter "
        f"--header-comment-delim --count-kmers labels; query --query-counts "
        f"/ --count-quantiles / --print-signature --fwd-and-reverse report "
        f"every record's k-mers; align and query --align on the primary "
        f"graph: every record and reverse complement aligned in full and "
        f"labelled")


def cli_anno(tmp, run, fa, names, seqs, g):
    """Phase 4, the annotation commands through the CLI's main in this
    process, on the canonical k = 31 graph of the records: transform_anno
    of its record annotation to row_diff, row_diff_brwt, brwt, rb_brwt,
    of a count annotation to int_row_diff and row_diff_int_brwt, and of
    a coordinate one (coordinate --anno-header) to row_diff_coord;
    relax_brwt and merge_anno. Each file's query (labels, --query-counts
    or --query-coords) prints what its column form prints, every record's
    coordinates are its window offsets, and stats names the form."""
    col = g + ".column.annodbg.npz"
    run("annotate", "-i", g, "-o", g + "_cnt", "--anno-header",
        "--count-kmers", fa)
    run("coordinate", "-i", g, "-o", g + "_crd", "--anno-header", fa)
    cnt, crd = g + "_cnt.column.annodbg.npz", g + "_crd.coord.annodbg.npz"
    want = {(): run("query", "-i", g, "-a", col, fa),
            ("--query-counts",): run("query", "--query-counts", "-i", g,
                                     "-a", cnt, fa),
            ("--query-coords",): "".join(
                f"{i}\t{n}\t<{n}>" + "".join(
                    f":{w}" for w in range(len(s) - 30)) + "\n"
                for i, (n, s) in enumerate(zip(names, seqs)))}
    if run("query", "--query-coords", "-i", g, "-a", crd, fa) != \
            want[("--query-coords",)]:
        raise AssertionError("CLI query --query-coords: not each record's "
                             "window offsets")
    files = []
    for t, src, mode in (("row_diff", col, ()), ("row_diff_brwt", col, ()),
                         ("brwt", col, ()), ("rb_brwt", col, ()),
                         ("int_row_diff", cnt, ("--query-counts",)),
                         ("row_diff_int_brwt", cnt, ("--query-counts",)),
                         ("row_diff_coord", crd, ("--query-coords",))):
        base = os.path.join(tmp, f"x_{t}")
        run("transform_anno", "--anno-type", t, "-i", g, "-o", base, src)
        files.append((f"{base}.{t}.annodbg.npz", mode))
    run("relax_brwt", "--relax-arity", "4", "-o",
        os.path.join(tmp, "relaxed"), files[2][0])
    run("merge_anno", "-o", os.path.join(tmp, "merged"), col, cnt)
    files += [(os.path.join(tmp, "relaxed.brwt.annodbg.npz"), ()),
              (os.path.join(tmp, "merged.column.annodbg.npz"), ())]
    for path, mode in files:
        if run("query", *mode, "-i", g, "-a", path, fa) != want[mode]:
            raise AssertionError(f"CLI query {' '.join(mode)} over {path} "
                                 f"differs from the column form's")
        if "representation:" not in run("stats", path):
            raise AssertionError(f"CLI stats of {path} wrong")
    log(f"CLI transform_anno (row_diff, row_diff_brwt, brwt, rb_brwt, "
        f"int_row_diff, row_diff_int_brwt, row_diff_coord), relax_brwt, "
        f"merge_anno, coordinate: each file's query equals its column "
        f"form's; query --query-coords gives each of the {len(names)} "
        f"records its window offsets; stats of each")


def cli_scaleout(tmp, run, fa, seqs, env):
    """Phase 4, the scale-out commands at a small size, on the card and
    (in this process) on the CPU: build --suffix-len 1 --parts-total 2
    --part-idx 0/1 then concatenate; build --disk-swap; build
    --num-shards 4; merge --num-shards 2 of the records' halves;
    coordinator with two worker processes (card only); build --reference
    from a VCF of SNPs, indels and a multi-allelic site, and from its
    .vcf.gz. Every exit code is 0, and each graph's stats equals the
    direct build's on the card and on the CPU."""
    import gzip
    import socket
    import threading
    run_cpu = cli_in_process("cpu")

    def p(name):
        return os.path.join(tmp, name)

    write_fasta(p("so_h1.fa"), [s.encode() for s in seqs[:100]])
    write_fasta(p("so_h2.fa"), [s.encode() for s in seqs[100:]])
    run("build", "-k", "31", "-o", p("so_g"), fa)
    want = run("stats", p("so_g"))
    if run_cpu("stats", p("so_g")) != want:
        raise AssertionError("CLI stats of the direct build: card != CPU")
    flows = {
        "parts + concatenate": [
            ["build", "-k", "31", "--suffix-len", "1", "--parts-total", "2",
             "--part-idx", str(i), "-o", "@p", fa] for i in (0, 1)]
        + [["concatenate", "-i", "@p", "--len-suffix", "1", "-o", "@out"]],
        "disk-swap": [["build", "-k", "31", "--disk-swap", tmp,
                       "--mem-cap-gb", "0.001", "-o", "@out", fa]],
        "num-shards": [["build", "-k", "31", "--num-shards", "4", "-o",
                        "@out", fa]],
        "merge --num-shards": [
            ["build", "-k", "31", "-o", "@h1", p("so_h1.fa")],
            ["build", "-k", "31", "-o", "@h2", p("so_h2.fa")],
            ["merge", "--num-shards", "2", "-o", "@out", "@h1", "@h2"]],
    }
    for name, cmds in flows.items():
        for r, tag in ((run, "cuda"), (run_cpu, "cpu")):
            for argv in cmds:
                r(*[p(f"so_{tag}_{x[1:]}") if x.startswith("@") else x
                    for x in argv])
            if r("stats", p(f"so_{tag}_out")) != want:
                raise AssertionError(f"CLI {name} on {tag}: stats differ "
                                     f"from the direct build's")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    coord = threading.Thread(target=run, args=(
        "coordinator", "-k", "31", "--suffix-len", "1", "--port", str(port),
        "-o", p("so_coord"), fa))
    coord.start()
    deadline = time.time() + 120         # a worker must find it bound
    while True:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            break
        except OSError:
            if not coord.is_alive() or time.time() > deadline:
                raise AssertionError("CLI coordinator did not bind its port")
            time.sleep(0.05)
    workers = [subprocess.Popen(
        [sys.executable, "-m", "metagraph_tpu_torch.cli.main", "worker",
         "--server", f"http://127.0.0.1:{port}", "--name", f"w{i}"],
        env=env, cwd=tmp) for i in range(2)]
    try:
        coord.join(timeout=600)
    finally:
        codes = [w.wait(timeout=120) for w in workers]
    if coord.is_alive() or codes != [0, 0]:
        raise AssertionError(f"CLI coordinator / workers failed: {codes}")
    if run("stats", p("so_coord")) != want:
        raise AssertionError("CLI coordinator: stats differ from the direct "
                             "build's")
    # VCF: SNPs, indels, a multi-allelic site, a symbolic allele (skipped)
    rng = np.random.default_rng(SEED + 11)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    chrom = rng.choice(acgt, 3000).tobytes()
    with open(p("ref.fa"), "wb") as f:
        f.write(b">chr1\n" + chrom + b"\n")
    rows = []
    for pos in range(40, 2960, 37):
        ref_c = chr(chrom[pos - 1])
        other = "ACGT"[("ACGT".index(ref_c) + 1) % 4]
        alt = [other, ref_c + "GAT", other + "," + ref_c + "T,<DEL>"][
            pos % 3]
        ref_a = ref_c if pos % 5 else chrom[pos - 1:pos + 2].decode()
        rows.append(f"chr1\t{pos}\t.\t{ref_a}\t{alt}\t.\tPASS\t.\n")
    text = "##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL" \
        "\tFILTER\tINFO\n" + "".join(rows)
    with open(p("v.vcf"), "w") as f:
        f.write(text)
    with gzip.open(p("v.vcf.gz"), "wt") as f:
        f.write(text)
    from metagraph_tpu_torch.seqio.vcf import vcf_to_sequences
    write_fasta(p("v_alleles.fa"),
                vcf_to_sequences(p("v.vcf"), p("ref.fa"), 31))
    run("build", "-k", "31", "-o", p("v_direct"), p("v_alleles.fa"))
    want_v = run("stats", p("v_direct"))
    for r, tag in ((run, "cuda"), (run_cpu, "cpu")):
        for vcf in ("v.vcf", "v.vcf.gz"):
            out = p(f"v_{tag}_{vcf.replace('.', '_')}")
            r("build", "-k", "31", "--reference", p("ref.fa"), "-o", out,
              p(vcf))
            if r("stats", out) != want_v:
                raise AssertionError(f"CLI build {vcf} on {tag}: stats "
                                     f"differ from the alleles' build")
    log(f"CLI scale-out: build --parts-total 2 + concatenate, --disk-swap, "
        f"--num-shards 4, merge --num-shards 2 (card and CPU), coordinator "
        f"with two worker processes: exit 0, stats equal to the direct "
        f"build's; build --reference from a VCF of {len(rows)} sites and "
        f"its .vcf.gz (card and CPU): stats equal to the build of its "
        f"alleles' FASTA")


def cli_alphabets_small(tmp, run, rng, fa, names, seqs, gb):
    """Phase 4, 3f's commands, through the CLI's ``main`` in this process
    (``run``): build --alphabet Protein (basic), DNA5
    (canonical) and DNACaseSent (primary) at k = 31, each followed by
    stats, annotate, query (every record labelled with its own name) and
    align (on Protein and DNACaseSent every record aligned whole: score
    the sum of its matrix's diagonal, CIGAR len=); build --state small, whose stats --print, query and align
    print as the fast graph's do."""
    from metagraph_tpu_torch.align.aligner import AlignerConfig
    from metagraph_tpu_torch.kmer.alphabets import ALPHABETS
    acgt = np.frombuffer(b"ACGT", np.uint8)
    inputs = {
        "Protein": [np.frombuffer(PROTEIN_LETTERS, np.uint8)[
            rng.integers(0, 20, int(rng.integers(200, 1000)))].tobytes()
            for _ in names],
        "DNA5": [], "DNACaseSent": []}
    for _ in names:
        s = acgt[rng.integers(0, 4, int(rng.integers(200, 1000)))]
        s[rng.random(len(s)) < 0.01] = ord("N")
        inputs["DNA5"].append(s.tobytes())
        lo = (np.arange(len(s)) // 100) % 2 == 1
        inputs["DNACaseSent"].append(np.where(lo & (s != ord("N")), s | 0x20,
                                              s).astype(np.uint8).tobytes())
    for name, mode in (("Protein", "basic"), ("DNA5", "canonical"),
                       ("DNACaseSent", "primary")):
        afa = os.path.join(tmp, f"{name}.fa")
        with open(afa, "wb") as f:
            for n, s in zip(names, inputs[name]):
                f.write(b">%s\n%s\n" % (n.encode(), s))
        g = os.path.join(tmp, f"g{name}")
        run("build", "-k", "31", "--alphabet", name, "--mode", mode, "-o", g,
            afa)
        stats = run("stats", "--validate", g)
        if f"mode: {mode}" not in stats or "validation: OK" not in stats:
            raise AssertionError(f"CLI stats of the {name} graph wrong")
        run("annotate", "-i", g, "--anno-header", afa)
        out = run("query", "-i", g, "-a", g + ".column.annodbg.npz", afa)
        if out.splitlines() != [f"{i}\t{n}\t{n}" for i, n in
                                enumerate(names)]:
            raise AssertionError(f"CLI query of the {name} graph wrong: "
                                 f"{out.splitlines()[:3]}")
        rows = [line.split("\t") for line in
                run("align", "-i", g, afa).splitlines()]
        if [r[0] for r in rows] != names:
            raise AssertionError(f"CLI align on the {name} graph: rows "
                                 f"{[r[0] for r in rows[:3]]}")
        if name == "DNA5":
            # a canonical graph spells paths without node orientation (kept
            # for parity), so the spelling and its score are not checked
            continue
        # a record aligns whole as one exact seed, scored by the
        # diagonal of the alphabet's matrix (BLOSUM62's; for DNACaseSent
        # the DNA matrix's, whose diagonal scores N and lower case as
        # mismatches: a fault of the reference, ROADMAP §3.4)
        alph = ALPHABETS[name]
        diag = np.diagonal(AlignerConfig().score_matrix(alph))
        for r, s in zip(rows, inputs[name]):
            score = int(diag[alph.encode_table()[
                np.frombuffer(s, np.uint8)]].sum())
            if r[2:7] != ["+", s.decode(), str(score), str(len(s)),
                          f"{len(s)}="]:
                raise AssertionError(f"CLI align on the {name} graph wrong: "
                                     f"{r[:2]} {r[2:]}")
    gs = os.path.join(tmp, "gsmall")
    run("build", "-k", "31", "--state", "small", "-o", gs, fa)

    def body(out):
        return [ln for ln in out.splitlines() if not ln.startswith(
            ("state:", "index bytes:", "bytes/edge:", "indexed suffix"))]

    small, fast = run("stats", "--print", gs), run("stats", "--print", gb)
    if "state: small" not in small or body(small) != body(fast):
        raise AssertionError("CLI stats --print of the small graph differs "
                             "from the fast graph's")
    run("annotate", "-i", gs, "--anno-header", fa)
    if run("query", "-i", gs, "-a", gs + ".column.annodbg.npz", fa) != \
            run("query", "-i", gb, "-a", gb + ".column.annodbg.npz", fa):
        raise AssertionError("CLI query of the small graph differs")
    if run("align", "-i", gs, fa) != run("align", "-i", gb, fa):
        raise AssertionError("CLI align on the small graph differs")
    if os.path.getsize(gs + ".dbg.npz") >= os.path.getsize(gb + ".dbg.npz"):
        raise AssertionError("CLI build --state small: the file is not "
                             "smaller than the fast graph's")
    log("CLI (in process) build --alphabet Protein / DNA5 --mode canonical / DNACaseSent "
        "--mode primary at k = 31, each with stats --validate, annotate, "
        "query and align: exit 0, every record labelled with its name and "
        "aligned whole; build --state small: stats --print, query and "
        "align equal the fast graph's")


def cli_serve(tmp, g, fa, want, env, device, run):
    """Phase 4, the server: server_query on the canonical graph in a
    process of its own; query --address against it prints each record
    with its own label, as query -i -a does; and build -v prints the
    construct and serialize spans on stderr."""
    import socket
    from metagraph_tpu_torch.server.client import GraphClient
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.time()
    with open(os.path.join(tmp, "server.log"), "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "metagraph_tpu_torch.cli.main",
             "server_query", "-i", g, "-a", g + ".column.annodbg.npz",
             "--port", str(port), "--device", device], env=env, cwd=tmp,
            stdout=subprocess.DEVNULL, stderr=err)
        try:
            client = GraphClient("127.0.0.1", port)
            while not client.ready():
                if proc.poll() is not None or time.time() - t0 > 300:
                    raise AssertionError("CLI server_query did not serve")
                time.sleep(0.2)
            t_ready = time.time() - t0
            out = run("query", "--address", f"127.0.0.1:{port}", fa)
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    if out.splitlines() != want:
        raise AssertionError(f"CLI query --address output wrong: "
                             f"{out.splitlines()[:3]}")
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        run("build", "-v", "-k", "31", "-o", os.path.join(tmp, "gv"), fa)
    spans = [line.split(":")[0] for line in buf.getvalue().splitlines()
             if line.startswith("[span] ")]
    if spans != ["[span] construct", "[span] serialize"]:
        raise AssertionError(f"CLI build -v spans wrong: {spans}")
    log(f"CLI server_query (its own process, serving after {t_ready:.1f} "
        f"s) and query --address: every record labelled with its own name; "
        f"build -v printed the construct and serialize spans")


def phase_cli(device):
    from metagraph_tpu_torch.graph.io import load_graph
    rng = np.random.default_rng(SEED + 2)
    letters = np.frombuffer(b"ACGT", np.uint8)
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory() as tmp:
        fa = os.path.join(tmp, "in.fa")
        names = [f"rec{i}" for i in range(200)]
        seqs = [letters[rng.integers(0, 4, int(rng.integers(
            200, 1000)))].tobytes().decode() for _ in names]
        with open(fa, "w") as f:
            for name, seq in zip(names, seqs):
                f.write(f">{name}\n{seq}\n")
        g = os.path.join(tmp, "g")

        def run_proc(*argv):
            """The CLI in a process of its own, as a user runs it."""
            res = subprocess.run(
                [sys.executable, "-m", "metagraph_tpu_torch.cli.main", *argv,
                 "--device", device], capture_output=True, text=True,
                env=env, cwd=tmp, timeout=600)
            if res.returncode != 0:
                raise AssertionError(f"CLI {argv[0]} exited "
                                     f"{res.returncode}:\n{res.stderr}")
            return res

        # each process takes ~8 s to reach the card: three commands run in
        # processes of their own, the rest in this one
        run = cli_in_process(device)
        # canonical for query and stats; basic for the alignments (the
        # aligner spells canonical nodes without their orientation, as the
        # JAX package does, so a canonical path's spelling is not the read)
        gb = os.path.join(tmp, "gb")
        # one file: the native codec's read (cli_surface holds the graph
        # against the build of the same records from two files)
        err = run_proc("build", "-k", "31", "--mode", "canonical", "-o", g,
                       fa).stderr
        if "M chars (native codec)" not in err:
            raise AssertionError(f"CLI build of one file did not read "
                                 f"through the native codec:\n{err}")
        run("build", "-k", "31", "--mode", "basic", "-o", gb, fa)
        want = [f"{i}\t{n}\t{n}" for i, n in enumerate(names)]
        for graph, extra in ((g, ()), (gb, ("--align",))):
            run("annotate", "-i", graph, "--anno-header", fa)
            out = run("query", *extra, "-i", graph, "-a",
                      graph + ".column.annodbg.npz", fa)
            if out.splitlines() != want:
                raise AssertionError(f"CLI query {' '.join(extra)} output "
                                     f"wrong: {out.splitlines()[:3]}")
        cli_serve(tmp, g, fa, want, env, device, run)
        stats = run_proc("stats", g).stdout
        if "mode: canonical" not in stats:
            raise AssertionError(f"CLI stats output wrong:\n{stats}")
        seqs = {n: s for n, s in zip(names, seqs)}
        rows = [line.split("\t") for line in
                run_proc("align", "-i", gb, fa).stdout.splitlines()]
        if [r[0] for r in rows] != names or any(
                r[2:] != ["+", seqs[r[0]], str(2 * len(seqs[r[0]])),
                          str(len(seqs[r[0]])), f"{len(seqs[r[0]])}=", "0"]
                for r in rows):
            raise AssertionError(f"CLI align output wrong: {rows[:2]}")
        recs = [json.loads(line) for line in
                run("align", "--json", "-i", gb, fa).splitlines()]
        if [r["name"] for r in recs] != names or any(
                (r["score"], r["cigar"], r["sequence"]) !=
                (2 * len(seqs[r["name"]]), f"{len(seqs[r['name']])}=",
                 seqs[r["name"]]) for r in recs):
            raise AssertionError(f"CLI align --json output wrong: {recs[:2]}")
        # primary: build, stats, annotate, query the records and their
        # reverse complements through the wrapper
        gp = os.path.join(tmp, "gp")
        run("build", "-k", "31", "--mode", "primary", "-o", gp, fa)
        if "mode: primary" not in run("stats", gp):
            raise AssertionError("CLI stats of the primary graph wrong")
        run("annotate", "-i", gp, "--anno-header", fa)
        both_fa = os.path.join(tmp, "both.fa")
        with open(both_fa, "w") as f:
            for name, seq in seqs.items():
                f.write(f">{name}\n{seq}\n>{name}\n"
                        f"{revcomp(seq.encode()).decode()}\n")
        out = run("query", "-i", gp, "-a", gp + ".column.annodbg.npz",
                  both_fa)
        if out.splitlines() != [f"{i}\t{n}\t{n}" for i, n in
                                enumerate(n for n in names for _ in "fr")]:
            raise AssertionError(f"CLI query of the primary graph wrong:"
                                 f" {out.splitlines()[:3]}")
        # a KMC database of the records' k-mers with counts 1-3
        acgt = np.frombuffer(b"ACGT", np.uint8)
        ints = np.unique(np.concatenate([fwd_kmer_ints(np.searchsorted(
            acgt, np.frombuffer(seq.encode(), np.uint8)) + 1, 31)
            for seq in seqs.values()]))
        counts = rng.integers(1, 4, len(ints))
        db = write_kmc2(os.path.join(tmp, "db"), ints, counts, 31)
        gk = os.path.join(tmp, "gk")
        run("build", "-k", "31", "--min-count", "2", "-o", gk,
            db + ".kmc_pre")
        gold = int((counts >= 2).sum())
        if load_graph(gk, device=device).num_nodes() != gold:
            raise AssertionError(f"CLI build from KMC: not {gold} nodes")
        cli_surface(tmp, names, list(seqs.values()), gp, both_fa, device)
        cli_alphabets_small(tmp, cli_in_process(device), rng, fa, names,
                            seqs, gb)
        cli_anno(tmp, run, fa, names, list(seqs.values()), g)
        cli_scaleout(tmp, run, fa, list(seqs.values()), env)
    log(f"CLI build/annotate/query/query --align/align/align --json/stats "
        f"--device {device}: exit 0; the one-file build read through the "
        f"native codec; each of {len(names)} records labelled "
        f"with its own name and aligned to its graph with score 2*len and "
        f"CIGAR len=; primary build/stats/annotate/query: every record and "
        f"its reverse complement labelled with its name; build from a KMC "
        f"database --min-count 2: {gold} nodes = numpy gold")


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
    print(smi, flush=True)        # as nvidia-smi prints it

    t_start = t0 = time.time()
    _cuda.lib()
    log(f"kernels built with nvcc from {_cuda.CSRC} and loaded in "
        f"{time.time() - t0:.2f} s")

    def timed(phase, *args):
        t = time.time()
        out = phase(*args)
        log(f"{phase.__name__}: {time.time() - t:.1f} s")
        return out

    summary = timed(phase_kernels, dev)
    build_launches, (align_launches, _), main_results, surface = timed(
        phase_main_path, dev)
    wide_launches = timed(phase_wide_build, dev)
    primary_launches = timed(phase_primary, dev)
    timed(phase_kmc, dev)
    timed(phase_sidecar, dev)
    alph_launches, alph_align = timed(phase_alphabets, dev)
    graph_launches = timed(phase_graph, dev)
    scale_launches = timed(phase_scaleout, dev, main_results)
    dist_launches = timed(phase_distributed, main_results)
    rd_launches = main_results.pop("3i row_diff")["launches"]
    del main_results
    timed(phase_cli, "cuda")

    kernels = []
    for kname, src, rep, launches in (
            ("partition_compact", "metagraph_tpu_torch/csrc/partition.cu",
             "metagraph_tpu/common/merge.py:634", build_launches),
            ("merge_sorted", "metagraph_tpu_torch/csrc/merge.cu",
             "metagraph_tpu/common/merge.py:333", build_launches),
            ("sort_packed", "metagraph_tpu_torch/csrc/sort.cu",
             "metagraph_tpu/common/merge.py:450", primary_launches),
            ("pallas_dp", "metagraph_tpu_torch/csrc/align_dp.cu",
             "metagraph_tpu/align/pallas_dp.py:185", align_launches)):
        err, ms, plain, lib_ms, (bound_ms, bound_by) = summary[kname]
        # the main path's runs, phase 3f's (its builds and its
        # score-only Protein alignment), phase 3g's, 3h's, 3i's, the
        # k = 65 build's, the server's and 3j's (every rank's)
        n_launch = (launches[kname] + (alph_align if kname == "pallas_dp"
                                       else alph_launches)[kname]
                    + graph_launches[kname]
                    + surface["graph launches"][kname]
                    + surface["anno launches"][kname]
                    + scale_launches[kname] + rd_launches[kname]
                    + wide_launches[kname] + dist_launches[kname]
                    + surface["serve launches"][kname])
        kernels.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": rep, "launches": n_launch,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": lib_ms})
    log(f"chip_smoke total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
