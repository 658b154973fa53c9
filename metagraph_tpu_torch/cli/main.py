"""The ``metagraph`` CLI of the port: build, annotate, query, align and
stats, on basic, canonical and primary graphs over the DNA, DNA5,
DNACaseSent and Protein alphabets, in the fast or the small state; and
the graph algorithms: assemble (unitigs, contigs, GFA, differential
assembly by label masks), clean, transform, compare, extend, merge and
align -o *.gfa; and the annotation forms: transform_anno (every
--anno-type of the JAX CLI), relax_brwt, merge_anno, coordinate /
annotate --coordinates and query --query-coords. Every command that
reads an annotation takes every form. The scale-out builds: build
--suffix-len / --suffix / --parts-total with concatenate, coordinator
and worker (suffix-sharded chunks), --disk-swap (streamed collect),
--num-shards (out-of-core), merge --num-shards and transform_anno
--disk-swap; and VCF input (build --reference ref.fa variants.vcf).
The query server: server_query (HTTP, server/http_server.py) and query
--address (its client).

PyTorch counterpart of ``metagraph_tpu/cli/main.py`` for the subset the
port covers; stdout is byte for byte that of the JAX CLI. Every command
takes ``--device`` (default ``cuda``; ``cpu`` runs the plain versions of
the kernels), the global ``-v`` and ``--debug`` (the telemetry spans on
stderr; ``METAGRAPH_TPU_TRACE_DIR`` set: a ``torch.profiler`` trace of
the command there, which also turns on the library's spans, so the
build's and the label query's stages are ranges of it), ``-p``, and the
JAX CLI's inert reference options (a warning names each one set). Any
other flag exits non-zero with "not yet ported".

    python -m metagraph_tpu_torch.cli.main build -k 31 -o graph a.fa b.fa
    find . -name "*.fa" | python -m metagraph_tpu_torch.cli.main build -k 31
    python -m metagraph_tpu_torch.cli.main build -k 31 --mode primary -o g reads.fa
    python -m metagraph_tpu_torch.cli.main build -k 31 --alphabet Protein -o g p.fa
    python -m metagraph_tpu_torch.cli.main build -k 31 --state small -o g reads.fa
    python -m metagraph_tpu_torch.cli.main build -k 31 --min-count 2 -o g db.kmc_pre
    python -m metagraph_tpu_torch.cli.main build -k 31 --count-kmers -o g contigs.fasta.gz
    python -m metagraph_tpu_torch.cli.main annotate -i graph --anno-header reads.fa
    python -m metagraph_tpu_torch.cli.main query -i graph -a graph.column.annodbg.npz q.fa
    python -m metagraph_tpu_torch.cli.main query --count-quantiles "0 0.5 1" \
        -i graph -a graph.column.annodbg.npz q.fa
    python -m metagraph_tpu_torch.cli.main align -i graph reads.fa
    python -m metagraph_tpu_torch.cli.main query --align -i graph \
        -a graph.column.annodbg.npz q.fa
    python -m metagraph_tpu_torch.cli.main stats --validate --count-dummy graph
    python -m metagraph_tpu_torch.cli.main assemble -i graph --unitigs -o u
    python -m metagraph_tpu_torch.cli.main assemble -i graph --unitigs \
        -a graph.column.annodbg.npz --label-mask-in A --label-mask-out B -o d
    python -m metagraph_tpu_torch.cli.main clean -i graph --prune-tips 62 \
        --prune-unitigs 0 --to-fasta -o cleaned
    python -m metagraph_tpu_torch.cli.main transform -i graph --to-gfa -o g
    python -m metagraph_tpu_torch.cli.main extend -i graph -o ext more.fa
    python -m metagraph_tpu_torch.cli.main merge -o merged g1 g2
    python -m metagraph_tpu_torch.cli.main align -i graph -o paths.gfa q.fa
    python -m metagraph_tpu_torch.cli.main transform_anno --anno-type row_diff \
        -i graph -o rd graph.column.annodbg.npz
    python -m metagraph_tpu_torch.cli.main transform_anno --anno-type brwt \
        --relax-arity 8 -o b graph.column.annodbg.npz
    python -m metagraph_tpu_torch.cli.main coordinate -i graph --anno-header in.fa
    python -m metagraph_tpu_torch.cli.main build -k 31 --num-shards 8 -o g reads.fa
    python -m metagraph_tpu_torch.cli.main build -k 31 --disk-swap /tmp \
        --mem-cap-gb 4 -o g reads.fa
    python -m metagraph_tpu_torch.cli.main build -k 31 --suffix-len 2 \
        --parts-total 4 --part-idx 0 -o parts reads.fa
    python -m metagraph_tpu_torch.cli.main concatenate -i parts --len-suffix 2 -o g
    python -m metagraph_tpu_torch.cli.main coordinator -k 31 --suffix-len 1 \
        --port 8900 -o g reads.fa
    python -m metagraph_tpu_torch.cli.main worker --server http://127.0.0.1:8900
    python -m metagraph_tpu_torch.cli.main merge --num-shards 8 -o m g1 g2
    python -m metagraph_tpu_torch.cli.main transform_anno --anno-type row_diff \
        --disk-swap /tmp --mem-cap-gb 1 -i graph -o rd graph.column.annodbg.npz
    python -m metagraph_tpu_torch.cli.main build -k 31 --reference ref.fa \
        -o v variants.vcf.gz
    python -m metagraph_tpu_torch.cli.main query --query-coords -i graph \
        -a graph.coord.annodbg.npz q.fa
    python -m metagraph_tpu_torch.cli.main server_query -i graph \
        -a graph.column.annodbg.npz --port 5555
    python -m metagraph_tpu_torch.cli.main query --address 127.0.0.1:5555 q.fa
    python -m metagraph_tpu_torch.cli.main build -v -k 65 --mode canonical \
        -o g reads.fa
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import List, Optional, Sequence

import numpy as np

from ..common import telemetry


# reference options the JAX CLI accepts on every subcommand with no
# effect; setting one logs a warning naming it
_PARITY_INERT = [
    ("--threads", dict(type=int, default=None)),
    ("--parallel-nodes", dict(type=int, default=None)),
    ("--bins-per-thread", dict(type=int, default=None)),
    ("--sequentially", dict(action="store_true")),
    ("--cache", dict(type=int, default=None)),
    ("--cache-size", dict(type=int, default=None)),
    ("--disk-cap-gb", dict(type=int, default=None)),
    ("--bloom-bpk", dict(type=float, default=None)),
    ("--bloom-max-num-hash-functions", dict(type=int, default=None)),
    ("--dynamic", dict(action="store_true")),
    ("--complete", dict(action="store_true")),
    ("--sparse", dict(action="store_true")),
    ("--num-kmers-in-seq", dict(type=int, default=None)),
    ("--frequency", dict(type=int, default=None)),
    ("--distance", dict(type=int, default=None)),
    ("--coord-binsize", dict(type=int, default=None)),
    ("--align-length", dict(type=int, default=None)),
    ("--filter-by-kmer", dict(action="store_true")),
    ("--intersected-anno", dict(default=None)),
    ("--annotator", dict(default=None)),
]
_INERT_ATTRS = [(f.lstrip("-").replace("-", "_"), f)
                for f, _ in _PARITY_INERT]
_REVCOMP = bytes.maketrans(b"ACGTacgt", b"TGCAtgca")


def log(msg: str):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def _load_graph(path, device, wrap_primary: bool = True):
    """Load a graph; a primary graph comes wrapped in ``CanonicalDbg``
    unless ``wrap_primary`` is false."""
    from ..graph.io import load_graph, load_query_graph
    return (load_query_graph if wrap_primary else load_graph)(
        path, device=device)


def cmd_build(args):
    import torch
    from ..graph import io as graph_io
    from ..graph.dbg_succinct import DbgSuccinct
    from ..kmer.alphabets import ALPHABETS
    from ..seqio.fasta import kmer_counts_sidecar

    if not args.fnames and not sys.stdin.isatty():
        # `find . -name "*.fa" | metagraph build ...`: the input file list
        # comes from stdin
        args.fnames = [ln.strip() for ln in sys.stdin if ln.strip()]
    if not args.fnames:
        raise SystemExit("build: no input files (arguments or a stdin list)")
    alphabet = ALPHABETS[args.alphabet]
    bits_per_count = args.count_width if args.count_kmers else 0
    vcf = any(f.endswith((".vcf", ".vcf.gz")) for f in args.fnames)
    t0 = time.time()
    valid = None
    from_sequences = False
    if any(f.endswith((".kmc_pre", ".kmc_suf")) for f in args.fnames):
        if len(args.fnames) != 1:
            raise SystemExit("build: one KMC database per build")
        boss = _build_from_kmc(args, bits_per_count)
        if boss is None:                 # --suffix: a chunk file
            return
    elif (args.count_kmers and not vcf
          and all(kmer_counts_sidecar(f) for f in args.fnames)):
        boss = _build_weighted_from_sidecars(args, alphabet, bits_per_count)
    elif args.suffix or args.parts_total > 1:
        _build_chunks(args, alphabet)
        return
    else:
        boss, valid = _build_from_sequences(args, alphabet, bits_per_count,
                                            vcf)
        from_sequences = True
    log(f"Graph construction: {time.time() - t0:.2f} s")
    # the JAX CLI spans the serialization of sequence builds only
    with (telemetry.span("serialize") if from_sequences
          else contextlib.nullcontext()):
        if valid is not None:
            valid = torch.from_numpy(valid).to(boss.device)
        graph = DbgSuccinct.from_boss(boss, alphabet, args.mode, valid=valid)
        out = graph_io.save_graph(args.outfile_base, graph, args.state)
    log(f"Serialized to {out}")


def _read_sequences(args) -> list:
    """Every input record (the alleles of VCF inputs in their k-flanked
    reference context, which needs ``--reference``), with the reverse
    complements under ``--fwd-and-reverse``."""
    from ..seqio.fasta import parse_records
    seqs = []
    for f in args.fnames:
        if f.endswith((".vcf", ".vcf.gz")):
            from ..seqio.vcf import vcf_to_sequences
            if not args.reference:
                raise SystemExit("build: --reference is required for VCF "
                                 "input")
            seqs.extend(vcf_to_sequences(f, args.reference, args.k))
        else:
            seqs.extend(r.seq for r in parse_records(f))
    if args.fwd_and_reverse:
        # each sequence also counts as its reverse complement
        seqs.extend(s.translate(_REVCOMP)[::-1] for s in list(seqs))
    log(f"Read {len(seqs)} sequences "
        f"({sum(map(len, seqs)) / 1e6:.1f} Mbp)")
    return seqs


def _stream_sequences(fnames):
    """The records of ``fnames`` parsed ahead on a thread, in batches of
    1024 (an out-of-core or disk-swap build reads its input once)."""
    from ..seqio.fasta import BatchFeeder, parse_records

    def batches():
        batch = []
        for f in fnames:
            for r in parse_records(f):
                batch.append(r.seq)
                if len(batch) >= 1024:
                    yield batch
                    batch = []
        if batch:
            yield batch

    return (s for chunk in BatchFeeder(batches(), depth=8) for s in chunk)


def _build_from_sequences(args, alphabet, bits_per_count: int, vcf: bool):
    """FASTA / FastQ / VCF input: the streamed collect (``--disk-swap``),
    the out-of-core build (``--num-shards`` in basic mode), the
    suffix-sharded build (``--suffix-len``, or ``--num-shards`` in the
    other modes), the single-shard build of one file's codes (read by
    ``read_and_encode``: the native codec, under the JAX CLI's
    conditions) or of the parsed records. Returns (Boss, the real-edge
    mask of an out-of-core build or None)."""
    from ..graph.boss_construct import build_boss, build_boss_from_codes
    if (len(args.fnames) == 1 and not vcf and not args.disk_swap
            and args.suffix_len == 0 and args.num_shards == 1
            and not args.fwd_and_reverse):
        from ..seqio import fasta
        codes = fasta.read_and_encode(args.fnames[0], alphabet)
        log(f"Encoded {len(codes) / 1e6:.1f} M chars ({fasta.last_route})")
        with telemetry.span("construct", items=len(codes), unit="chars"):
            return build_boss_from_codes(
                codes, args.k, alphabet=alphabet, mode=args.mode,
                bits_per_count=bits_per_count, device=args.device), None
    streamed = ((args.disk_swap or (args.num_shards > 1
                                    and args.mode == "basic"))
                and not vcf and not args.fwd_and_reverse
                and args.suffix_len == 0)
    seqs = (_stream_sequences(args.fnames) if streamed
            else _read_sequences(args))
    # the spans of the JAX CLI: construct_ooc and construct, counting the
    # input characters where they are known before the build
    if args.disk_swap:
        from ..parallel.streaming import build_boss_streaming
        # a directory engages the on-disk run tier; --mem-cap-gb bounds
        # the collect's window (16 bytes a character)
        chunk = min(max(int(args.mem_cap_gb * (1 << 30) / 16), 1 << 20),
                    1 << 26)
        return build_boss_streaming(
            seqs, args.k, alphabet=alphabet, mode=args.mode,
            bits_per_count=bits_per_count, chunk_codes=chunk,
            disk_dir=(args.disk_swap if os.path.isdir(args.disk_swap)
                      else None), device=args.device), None
    if args.num_shards > 1 and args.mode == "basic":
        from ..parallel.outofcore import build_boss_out_of_core
        with telemetry.span("construct_ooc",
                            items=0 if streamed else sum(map(len, seqs)),
                            unit="chars"):
            return build_boss_out_of_core(
                seqs, args.k, alphabet=alphabet, n_shards=args.num_shards,
                bits_per_count=bits_per_count,
                keep_kmer_index=args.state != "small", verbose=args.verbose,
                return_valid=True, device=args.device)
    if args.suffix_len > 0 or args.num_shards > 1:
        from ..parallel.sharded_build import build_boss_sharded
        return build_boss_sharded(
            seqs, args.k, alphabet=alphabet, mode=args.mode,
            bits_per_count=bits_per_count,
            suffix_len=max(args.suffix_len, 1), device=args.device), None
    with telemetry.span("construct", items=sum(map(len, seqs)),
                        unit="chars"):
        return build_boss(seqs, args.k, alphabet=alphabet, mode=args.mode,
                          bits_per_count=bits_per_count,
                          device=args.device), None


def _suffix_codes(args, alphabet):
    """``--suffix`` as character codes; '$' (the sentinel) is code 0."""
    try:
        return tuple(alphabet.letters.index(ch) for ch in args.suffix)
    except ValueError:
        raise SystemExit(f"build: --suffix {args.suffix!r} holds a letter "
                         f"outside {alphabet.name}") from None


def _build_chunks(args, alphabet):
    """``--suffix S``: the chunk file of one node-suffix bucket;
    ``--parts-total P --part-idx p``: the chunks of buckets p, p + P, ...
    of ``--suffix-len``. ``concatenate`` builds the graph of the chunks
    (reference build.cpp:103-155, the --part-idx workflow)."""
    from ..common import packed
    from ..parallel.sharded_build import (bucket_name, build_shard_kmers,
                                          save_chunk, suffix_buckets)
    seqs = _read_sequences(args)
    canonical = args.mode in ("canonical", "primary")
    if args.suffix:
        buckets = [_suffix_codes(args, alphabet)]
    else:
        if args.suffix_len <= 0:
            raise SystemExit("build: --parts-total needs --suffix-len")
        buckets = suffix_buckets(alphabet, args.suffix_len)[
            args.part_idx::args.parts_total]
    for sfx in buckets:
        if 0 in sfx:       # the '$' bucket: dummies come at the finish
            lanes = np.zeros((packed.num_lanes(args.k,
                                               alphabet.bits_per_char), 0),
                             np.uint32)
            counts = np.zeros((0,), np.int32)
        else:
            lanes, counts, _ = build_shard_kmers(
                seqs, args.k, sfx, alphabet, canonical=canonical,
                device=args.device)
        out = f"{args.outfile_base}.{bucket_name(alphabet, sfx)}.chunk.npz"
        save_chunk(out, lanes, counts, args.k, alphabet.name, sfx)
        log(f"Serialized chunk to {out}")


def sidecar_kmers(fnames: Sequence[str], k: int, alphabet):
    """The k-mers of contigs with count sidecars as ((n, k) uint8 codes,
    (n,) uint32 counts): every window of a record with its count, those
    holding a byte outside the alphabet dropped."""
    from ..seqio.fasta import iter_weighted_records
    tbl = alphabet.encode_table()
    chars_parts, count_parts = [], []
    for f in fnames:
        for rec, counts in iter_weighted_records(f):
            if len(rec.seq) < k:
                continue
            codes = tbl[np.frombuffer(rec.seq, np.uint8)]
            win = np.lib.stride_tricks.sliding_window_view(codes, k)
            valid = (win != 255).all(axis=1)
            chars_parts.append(win[valid])
            count_parts.append(counts[valid])
    if not chars_parts:
        return np.zeros((0, k), np.uint8), np.zeros((0,), np.uint32)
    return np.concatenate(chars_parts), np.concatenate(count_parts)


def _build_weighted_from_sidecars(args, alphabet, bits_per_count: int):
    """Contigs with per-k-mer count sidecars: each k-mer contributes its
    count, duplicates summed, weights saturated at ``--count-width``
    bits."""
    chars, counts = sidecar_kmers(args.fnames, args.k, alphabet)
    log(f"Weighted input: {len(chars)} k-mers from count sidecars")
    return _build_counted(chars, counts, args, bits_per_count, alphabet)


def _build_from_kmc(args, bits_per_count: int):
    """A KMC database's k-mers, count-filtered, as a graph. They build
    over DNA whatever ``--alphabet`` names, as in the JAX CLI (the graph
    is labelled with that alphabet). With ``--suffix`` the k-mers whose
    node suffix (after the canonical fold) is that suffix go to a chunk
    file instead, and None is returned."""
    from ..kmer.alphabets import DNA
    from ..seqio.kmc import read_kmers
    chars, counts, hdr = read_kmers(args.fnames[0], min_count=args.min_count,
                                    max_count=args.max_count)
    log(f"KMC database: {len(chars)} k-mers, k={hdr.kmer_length}")
    if args.k != hdr.kmer_length:
        raise SystemExit(f"build: -k {args.k} != KMC k {hdr.kmer_length}")
    if args.suffix:
        _kmc_chunk(args, chars, counts)
        return None
    return _build_counted(chars, counts, args, bits_per_count, DNA)


def _kmc_chunk(args, chars, counts):
    """One suffix bucket of a KMC database as a chunk file (the
    reference's test_build.py:270-330 workflow); the '$' bucket is empty
    (dummies are made at the finish). The bucket takes the k-mers whose
    node characters K-s..K-1 of the packed (canonical) k-mer equal the
    suffix, as in the JAX CLI."""
    from ..common import merge as pmerge
    from ..common import packed
    from ..graph.boss_construct import collect_counted_kmers
    from ..kmer.alphabets import ALPHABETS, DNA
    from ..parallel.sharded_build import bucket_name, save_chunk
    alphabet = ALPHABETS[args.alphabet]
    sfx = _suffix_codes(args, alphabet)
    B = DNA.bits_per_char
    if 0 in sfx:
        comp = np.zeros((packed.num_lanes(args.k, B), 0), np.uint32)
        ccomp = np.zeros((0,), np.int32)
    else:
        lanes, cnts, n = collect_counted_kmers(
            chars, counts, args.k, canonical=args.mode != "basic",
            device=args.device)
        keep = packed.valid_mask(lanes.shape[1], n, lanes.device)
        for i, c in enumerate(sfx):
            keep &= packed.get_field(lanes, args.k - len(sfx) + i, B) == c
        comp_d, nc, (cc,) = pmerge.partition_compact(lanes, keep,
                                                     lanes.shape[1], cnts)
        nc = int(nc)
        comp, ccomp = comp_d[:, :nc], cc[:nc]
    out = f"{args.outfile_base}.{bucket_name(alphabet, sfx)}.chunk.npz"
    save_chunk(out, comp, ccomp, args.k, alphabet.name, sfx)
    log(f"Serialized chunk to {out}")


def _build_counted(chars, counts, args, bits_per_count: int, alphabet):
    """Counted k-mers ((n, k) codes, (n,) counts) as a graph over
    ``alphabet``. Canonical and primary both build the canonical
    closure, as the JAX CLI does; the graph is then labelled with the
    requested mode."""
    from ..graph.boss_construct import (build_boss_from_kmers,
                                        collect_counted_kmers)
    mode = "basic" if args.mode == "basic" else "canonical"
    lanes, cnts, n = collect_counted_kmers(
        chars, counts, args.k, alphabet, canonical=mode == "canonical",
        device=args.device)
    return build_boss_from_kmers(lanes, cnts, n, args.k, alphabet, mode=mode,
                                 bits_per_count=bits_per_count)


def _is_annotation_file(path) -> bool:
    if path.endswith(".annodbg.npz"):
        return True
    try:
        with np.load(path if path.endswith(".npz") else path + ".dbg.npz",
                     allow_pickle=False) as d:
            return "labels" in d
    except (OSError, ValueError):
        return False


def _print_annotation_stats(f, device, print_col_names: bool = False):
    from ..anno.annotator import Annotation
    ann = Annotation.load(f, device=device)
    log(f"Statistics for annotation '{f}'")
    print("=================== ANNOTATION STATS ===================")
    print(f"labels:  {ann.num_labels}")
    if print_col_names:
        for label in ann.encoder.labels:
            print(f"<{label}>")
    print(f"objects: {ann.matrix.num_rows}")
    density = ann.matrix.nnz / max(ann.matrix.num_rows, 1) \
        / max(ann.num_labels, 1)
    print(f"density: {density:.6g}")
    rep = {"rowsparse": "column", "rowdiff": "row_diff"}.get(
        ann.representation, ann.representation)
    print(f"representation: {rep}")
    if rep == "brwt":
        print("=================== Multi-BRWT STATS ===================")
        print(f"num nodes: {ann.matrix.num_nodes()}")
        print(f"avg arity: {ann.matrix.avg_arity()}")
    print("========================================================")


def cmd_stats(args):
    for f in args.fnames:
        if _is_annotation_file(f):
            _print_annotation_stats(f, args.device, args.print_col_names)
            continue
        g = _load_graph(f, args.device, wrap_primary=False)
        log(f"Statistics for graph '{f}'")
        _print_graph_stats(g, args)


def _print_graph_stats(g, args):
    from ..graph.io import index_bytes
    print("====================== GRAPH STATS =====================")
    print(f"k: {g.k}")
    print(f"nodes (k): {g.num_nodes()}")
    print(f"mode: {g.mode}")
    boss = g.boss
    if boss.weights is not None:
        w = boss.weights.cpu().numpy()
        nnz = int((w != 0).sum())
        print(f"nnz weights: {nnz}")
        # %.6g: C++ std::cout default double formatting
        print(f"avg weight: {w.sum() / max(nnz, 1):.6g}")
    nbytes = index_bytes(g)
    print(f"index bytes: {nbytes}")
    print(f"bytes/edge: {nbytes / max(boss.num_edges, 1):.3g}")
    print("========================================================")
    print("====================== BOSS STATS ======================")
    print(f"k: {boss.k + 1}")
    print(f"nodes (k-1): {int(boss.num_nodes())}")
    print(f"edges ( k ): {boss.num_edges}")
    print(f"state: {'fast' if boss.edge_lanes is not None else 'small'}")
    counts = boss.char_counts_W().cpu().numpy()
    letters = g.alphabet.letters
    pairs = ", ".join(f"'{letters[i]}': {int(counts[i])}"
                      for i in range(boss.alph_size))
    print("W stats: {" + pairs + "}")
    if args.print_internal:
        # the reference's BOSS::print_internal_representation
        W = boss.W.cpu().numpy()
        last = boss.last_rank.bits_host()
        print("F:", " ".join(str(int(x)) for x in boss.F.cpu().numpy()))
        sys.stdout.write("".join(f"{i}\t{int(last[i])}\t{int(W[i])}\n"
                                 for i in range(1, boss.num_edges + 1)))
    if args.print_graph:
        _print_boss_table(boss, letters)
    F = boss.F.cpu().numpy()
    fparts = [f"'{letters[i - 1]}': {int(F[i] - F[i - 1])}"
              for i in range(1, boss.alph_size)]
    fparts.append(f"'{letters[-1]}': {boss.num_edges - int(F[-1])}")
    print("F stats: {" + ", ".join(fparts) + "}")
    if args.count_dummy and boss.edge_lanes is not None:
        nsrc, nsink = (int(x) for x in boss.num_dummy_edges())
        print(f"dummy source edges: {nsrc}")
        print(f"dummy sink edges: {nsink}")
        print(f"real edges: {boss.num_edges - nsrc - nsink}")
    # the top-16-bit search table plays the role of the reference's
    # index_suffix_ranges
    suf_chars = (16 // boss.bits_per_char) if boss.lut is not None else 0
    print(f"indexed suffix length: {suf_chars}")
    if args.validate:
        errs = validate_graph(g)
        print(f"validation: {'OK' if not errs else 'FAILED'}")
        for e in errs:
            print(f"  invariant violated: {e}")
        if errs:
            sys.exit(1)
    print("========================================================")


def _print_boss_table(boss, letters: str):
    """The reference's BOSS::print: per edge its index, source node (the
    edge k-mer less its label), W char (minus-flagged ones lower case)
    and last bit."""
    from ..kmer.packing import unpack_to_chars
    W = boss.W.cpu().numpy()
    last = boss.last_rank.bits_host()
    sigma = boss.alph_size
    if boss.edge_lanes is not None:
        chars = unpack_to_chars(boss.edge_lanes, boss.k + 1,
                                boss.bits_per_char).cpu().numpy()
    else:
        # small state: the rank/select bwd-walk decode, in chunks of rows
        import torch
        step = 1 << 22
        chars = np.concatenate([np.zeros((0, boss.k + 1), np.int32)] + [
            boss.node_chars_ranksel(torch.arange(
                lo, min(lo + step, boss.num_edges + 1),
                device=boss.device)).cpu().numpy()
            for lo in range(1, boss.num_edges + 1, step)])
    nodes = np.frombuffer(letters.encode(), np.uint8)[chars[:, :-1]]
    wchar = ["$"] + [letters[w % sigma].lower() if w >= sigma else letters[w]
                     for w in range(1, 2 * sigma)]
    print("index\tnode\tW\tlast")
    sys.stdout.write("".join(
        f"{i}\t{nodes[i - 1].tobytes().decode()}\t{wchar[W[i]]}"
        f"\t{int(last[i])}\n" for i in range(1, boss.num_edges + 1)))


def validate_graph(g) -> list:
    """BOSS structural invariants (stats --validate), batched on the
    graph's device; returns the violations. F nondecreasing from 0, W in
    [0, 2 sigma), one last bit per node; on up to 1024 edges sampled with
    ``default_rng(0)``, fwd lands on a node ending in the edge's label
    and bwd stays in range; every edge k-mer maps back to its own row."""
    import torch
    errs = []
    boss = g.boss
    dev = boss.device
    m = boss.num_edges
    F = boss.F.cpu().numpy()
    if not (np.diff(F) >= 0).all() or F[0] != 0:
        errs.append(f"F not nondecreasing from 0: {F.tolist()}")
    W = boss.W[1:m + 1].cpu().numpy()
    if W.size and (W < 0).any() or (W >= 2 * boss.alph_size).any():
        errs.append("W values outside [0, 2*sigma)")
    n_nodes = int(boss.num_nodes())
    n_last = int(boss.last_rank.bits_host()[1:m + 1].sum())
    if n_last != n_nodes:
        errs.append(f"last popcount {n_last} != num_nodes {n_nodes}")
    rng = np.random.default_rng(0)
    sample = np.unique(rng.integers(1, m + 1, min(1024, m)))
    Ws = boss.get_W(torch.from_numpy(sample).to(dev)).cpu().numpy()
    real = (Ws % boss.alph_size) != 0
    if real.any():
        c = (Ws[real] % boss.alph_size).astype(np.int32)
        tgt = boss.fwd(torch.from_numpy(sample[real].astype(np.int32)).to(dev),
                       torch.from_numpy(c).to(dev))
        back = boss.bwd(tgt).cpu().numpy()
        ok = boss.get_node_last_value(tgt).cpu().numpy() == c
        if not ok.all():
            errs.append(f"fwd label mismatch on {int((~ok).sum())} of "
                        f"{len(ok)} sampled edges")
        if (back < 1).any() or (back > m).any():
            errs.append("bwd out of range on sampled edges")
    if boss.edge_lanes is not None:
        rows = boss.map_to_edges(boss.edge_lanes)
        want = torch.arange(1, rows.shape[0] + 1, device=rows.device)
        bad = int(torch.sum(rows != want))
        if bad:
            errs.append(f"map_to_edges not identity on {bad} rows")
    return errs


def cmd_annotate(args):
    """annotate, and coordinate (annotate with --coordinates on): a column
    annotation (``.column.annodbg.npz``) or a coordinate one
    (``.coord.annodbg.npz``: each window's offset in its label's
    sequences)."""
    from ..anno.coords import annotate_coordinates
    from ..engine.annotated_dbg import annotate_sequences
    from ..seqio.fasta import parse_records

    g = _load_graph(args.infile_base, args.device)
    items = []
    for f in args.fnames:
        for rec in parse_records(f):
            labels: List[str] = []
            if args.anno_filename:
                labels.append(f)
            if args.anno_header:
                name = rec.name.decode()
                if args.header_comment_delim and rec.comment:
                    # the header's comment joins its name first
                    name = (name + args.header_comment_delim
                            + rec.comment.decode())
                if args.header_delimiter:
                    # one label per non-empty field
                    labels.extend(x for x in name.split(args.header_delimiter)
                                  if x)
                else:
                    labels.append(name)
            labels.extend(args.anno_label or [])
            items.append((rec.seq, labels))
    if args.coordinates:
        ann = annotate_coordinates(g, items).finalize()
    else:
        ann = annotate_sequences(g, items,
                                 with_counts=args.count_kmers).finalize()
    out = args.outfile_base or args.infile_base
    if not out.endswith(".annodbg.npz"):
        out = out + (".coord.annodbg.npz" if args.coordinates
                     else ".column.annodbg.npz")
    ann.save(out)
    log(f"Serialized annotation to {out} "
        f"({ann.num_labels} labels, {ann.matrix.nnz} relations)")


def _query_mode(args):
    """The query mode the flags select, in the JAX CLI's order
    (signature, coordinates, quantiles, k-mer counts, label counts,
    labels): the name of ``AnnotatedDbg``'s per-sequence method
    (``BatchQuery``'s batch method is the name with ``_batch``), its
    arguments after the reads, and ``fields(adbg, result)``: one read's
    output fields after its index and name."""
    top, ratio = args.num_top_labels, args.discovery_fraction
    if args.print_signature:
        return "get_top_label_signatures", (top, ratio), lambda adbg, res: \
            "".join(f"\t<{label}>:{int(mask.sum())}:"
                    f"{(mask.astype(np.uint8) + 48).tobytes().decode()}:"
                    f"{adbg.score_kmer_presence_mask(mask)}"
                    for label, mask in res)
    if args.query_coords:
        # per label one field per window: its coordinates, comma-joined
        return "get_kmer_coordinates", (top, ratio), lambda adbg, res: \
            "".join(f"\t<{label}>" + "".join(":" + ",".join(map(str, c))
                                              for c in tuples)
                    for label, tuples in res)
    if args.count_quantiles:
        qs = [float(x) for x in args.count_quantiles.split()]
        return "get_label_count_quantiles", (top, ratio, qs), \
            lambda adbg, res: "".join(
                f"\t<{label}>:" + ":".join(str(q) for q in quants)
                for label, quants in res)
    if args.count_labels or args.query_counts:
        return "get_top_labels", (top, ratio, args.query_counts), \
            lambda adbg, res: "".join(f"\t<{label}>:{c}" for label, c in res)
    return "get_labels", (ratio,), lambda adbg, res: \
        "\t" + args.anno_labels_delimiter.join(res)


def _query_batch(bq, seqs, args):
    """One batch through the query mode the flags select: per read its
    result (empty when unlabeled) and its output fields after the read's
    index and name."""
    method, call_args, fields = _query_mode(args)
    try:
        results = getattr(bq, method + "_batch")(seqs, *call_args)
    except ValueError as e:
        if not args.query_coords:
            raise
        # --query-coords over an annotation without coordinates
        raise SystemExit(f"query --query-coords: {e}") from e
    return results, lambda res: fields(bq.adbg, res)


def format_query_result(idx: int, name: str, adbg, seq: bytes,
                        args) -> str:
    """One sequence's output line as ``query`` prints it, through
    ``AnnotatedDbg``'s per-sequence method of the mode ``args`` selects
    (raising where it raises); "" when the sequence is unlabeled and
    ``args.suppress_unlabeled`` is set."""
    method, call_args, fields = _query_mode(args)
    res = getattr(adbg, method)(seq, *call_args)
    if not res and args.suppress_unlabeled:
        return ""
    return f"{idx}\t{name}{fields(adbg, res)}\n"


def _query_address(args):
    """query --address HOST:PORT (client mode): each batch of reads goes
    to a running server_query as one POST /search; one line per read,
    its labels as the server ranks them."""
    from ..seqio.fasta import iter_batches
    from ..server.client import GraphClient
    unsupported = [f for f, v in [
        ("--count-labels", args.count_labels),
        ("--count-kmers/--query-counts", args.query_counts),
        ("--print-signature", args.print_signature),
        ("--query-coords", args.query_coords),
        ("--count-quantiles", args.count_quantiles),
        ("--fwd-and-reverse", args.fwd_and_reverse)] if v]
    if unsupported:
        raise SystemExit("not supported with --address: "
                         + " ".join(unsupported))
    host, _, port = args.address.rpartition(":")
    client = GraphClient(host or "127.0.0.1", int(port))
    idx = 0
    for batch in iter_batches(args.fnames, batch_bytes=args.batch_size):
        raw, _ = client._json.search(
            [r.seq.decode() for r in batch],
            top_labels=min(args.num_top_labels, 2 ** 31 - 1),
            discovery_threshold=args.discovery_fraction,
            align=args.align or args.batch_align)
        by_desc = {}
        for entry in raw:
            by_desc.setdefault(entry["seq_description"],
                               [r["sample"] for r in entry.get("results",
                                                               [])])
        for i, rec in enumerate(batch):
            labels = (by_desc.get(f"{i}", [])
                      or by_desc.get(rec.name.decode(), []))
            if labels or not args.suppress_unlabeled:
                sys.stdout.write(
                    f"{idx}\t{rec.name.decode()}\t"
                    + args.anno_labels_delimiter.join(labels) + "\n")
            idx += 1


def cmd_query(args):
    if args.address:                # no index here: no tensors, no torch
        _query_address(args)
        return
    from ..anno.annotator import Annotation
    from ..engine.annotated_dbg import AnnotatedDbg, BatchQuery
    from ..seqio.fasta import BatchFeeder, SeqRecord, iter_batches

    if not (args.infile_base and args.annotation):
        raise SystemExit("query needs -i and -a (or --address for client "
                         "mode)")
    g = _load_graph(args.infile_base, args.device)
    ann = Annotation.load(args.annotation, device=args.device)
    bq = BatchQuery(AnnotatedDbg(graph=g, annotation=ann))
    aligner = None
    if args.align or args.batch_align:
        from ..align.aligner import Aligner, AlignerConfig
        aligner = Aligner(g, AlignerConfig(
            min_exact_match=args.align_min_exact_match))
    t0 = time.time()
    n = idx = 0
    out = sys.stdout
    # prefetch: host parsing of the next batch overlaps device work
    for batch in BatchFeeder(iter_batches(args.fnames,
                                          batch_bytes=args.batch_size)):
        if args.fwd_and_reverse:
            # every record is queried forward and as its reverse
            # complement, one output line each
            batch = [r for rec in batch for r in (rec, SeqRecord(
                name=rec.name, seq=rec.seq.translate(_REVCOMP)[::-1]))]
        if aligner is not None:
            # reference query --align / --batch-align: each read is
            # replaced by its best path spelling (score-only alignment)
            all_res = _align_or_exit(aligner, [rec.seq for rec in batch],
                                     "query --align", with_cigar=False)
            for rec, res in zip(batch, all_res):
                if res:
                    rec.seq = res[0].sequence
        results, fields = _query_batch(bq, [r.seq for r in batch], args)
        for rec, res in zip(batch, results):
            if not res and args.suppress_unlabeled:
                idx += 1
                continue
            out.write(f"{idx}\t{rec.name.decode()}{fields(res)}\n")
            idx += 1
            n += 1
    dt = max(time.time() - t0, 1e-9)
    log(f"Queried {n} sequences in {dt:.2f} s ({n / dt:.0f} reads/s)")


def _align_or_exit(aligner, seqs, what: str, **kw):
    """``aligner.align_batch``; a read that needs suffix seeds on a
    primary graph exits non-zero, as the reference does there."""
    from ..align.aligner import SuffixSeedsOnPrimaryGraph
    try:
        return aligner.align_batch(seqs, **kw)
    except SuffixSeedsOnPrimaryGraph as e:
        raise SystemExit(f"{what}: {e}") from e


def cmd_align(args):
    from ..align.aligner import Aligner, AlignerConfig
    from ..seqio.fasta import parse_records

    g = _load_graph(args.infile_base, args.device)
    if args.outfile_base and args.outfile_base.endswith(".gfa"):
        # the GFA path mode (align.cpp gfa_map_files): each read's nodes
        # as a P line
        _align_gfa_paths(g, args)
        return
    cfg = AlignerConfig(
        match_score=args.match_score,
        mm_transition_penalty=args.mm_transition_penalty,
        mm_transversion_penalty=args.mm_transversion_penalty,
        gap_opening_penalty=args.gap_opening_penalty,
        gap_extension_penalty=args.gap_extension_penalty,
        xdrop=args.align_xdrop,
        min_seed_length=args.align_min_seed_length or g.k,
        max_seed_length=args.align_max_seed_length,
        min_exact_match=args.align_min_exact_match,
        max_seeds_per_locus=args.align_max_num_seeds_per_locus,
        min_cell_score=args.align_min_cell_score,
        max_ram_mb=args.align_max_ram,
    )
    if args.align_max_nodes_per_seq_char:
        # the beam width is the expanded-nodes-per-query-char bound here
        cfg.beam_width = max(int(args.align_max_nodes_per_seq_char), 1)
    if args.align_edit_distance:
        # unit scoring matrix and unit gap costs
        cfg.score_matrix_type = "unit"
        cfg.match_score = 1
        cfg.mm_transition_penalty = 1
        cfg.mm_transversion_penalty = 1
        cfg.gap_opening_penalty = 1
        cfg.gap_extension_penalty = 1
    aligner = Aligner(g, cfg)
    out = open(args.outfile_base, "w") if args.outfile_base else sys.stdout
    recs = []
    for f in args.fnames:
        recs.extend(parse_records(f))
    if args.map_only or args.query_presence:
        for rec in recs:
            name = rec.name.decode()
            nodes = np.asarray(g.map_to_nodes(rec.seq))
            n_disc = int((nodes > 0).sum())
            if args.query_presence:
                # 0/1 presence per read; with --filter-present the present
                # reads as FASTA. A read with no full k-mer is absent
                n_k = len(nodes)
                min_disc = n_k - int(n_k * (1 - args.discovery_fraction))
                found = n_k > 0 and n_disc >= min_disc
                if args.filter_present:
                    if found:
                        out.write(f">{name}\n{rec.seq.decode()}\n")
                else:
                    out.write(f"{int(found)}\n")
            elif args.count_kmers:
                # name \t discovered/total/unique
                n_uniq = len(np.unique(nodes[nodes > 0]))
                out.write(f"{name}\t{n_disc}/{len(nodes)}/{n_uniq}\n")
            else:
                for i, v in enumerate(nodes):
                    out.write(f"{rec.seq[i:i + g.k].decode()}: {int(v)}\n")
        if out is not sys.stdout:
            out.close()
        return
    t0 = time.time()
    with telemetry.span("align_batch", items=len(recs), unit="reads"):
        all_results = _align_or_exit(
            aligner, [r.seq for r in recs], "align",
            both_strands=args.align_both_strands,
            num_alternative_paths=args.num_alternative_paths)
    dt = max(time.time() - t0, 1e-9)
    log(f"Aligned {len(recs)} reads in {dt:.2f} s ({len(recs) / dt:.0f} "
        f"reads/s)")
    for rec, results in zip(recs, all_results):
        name = rec.name.decode()
        if args.align_min_path_score:
            results = [r for r in results
                       if r.score >= args.align_min_path_score]
        if args.json:
            for r in results:
                out.write(json.dumps(r.to_json(name)) + "\n")
            continue
        # header \t query [\t +/- \t seq \t score \t matches \t cigar
        # \t offset]...
        row = f"{name}\t{rec.seq.decode()}"
        if not results:
            row += "\t*\t*\t0\t*\t*\t*"
        else:
            for r in results:
                strand = "-" if r.orientation else "+"
                row += (f"\t{strand}\t{r.sequence.decode()}\t{r.score}"
                        f"\t{r.num_matches}\t{r.cigar}\t0")
        out.write(row + "\n")
    if out is not sys.stdout:
        out.close()


# ---------------------------------------------------------------------------
# assemble / clean
# ---------------------------------------------------------------------------

def cmd_assemble(args):
    from ..graph.traversal import contig_sequences, unitig_sequences
    from ..seqio.fasta import FastaWriter

    g = _load_graph(args.infile_base or args.fnames[0], args.device)
    if args.label_mask_in or args.label_mask_out:
        if not args.unitigs:
            # the JAX CLI hands label_other_fraction to the node-level mask,
            # which takes no such argument (metagraph_tpu/cli/main.py:836,
            # TypeError): a fault of the reference, matched
            raise SystemExit(
                "assemble: label masks need --unitigs (the node-level mask "
                "fails in the reference: mask_nodes_by_node_label takes no "
                "label_other_fraction)")
        from ..anno.annotator import Annotation
        from ..engine.annotated_dbg import AnnotatedDbg
        from ..engine.diff_assembly import differential_assembly
        ann = Annotation.load(args.annotation, device=args.device)
        g = differential_assembly(
            AnnotatedDbg(graph=g, annotation=ann),
            args.label_mask_in or [], args.label_mask_out or [],
            label_mask_in_fraction=args.label_mask_in_fraction,
            label_mask_out_fraction=args.label_mask_out_fraction,
            label_other_fraction=args.label_other_fraction)
    if args.to_gfa:
        if not args.unitigs:
            log("Flag '--unitigs' must be set for GFA output")
            sys.exit(1)
        _write_gfa(g, args.outfile_base + ".gfa", compacted=args.compacted)
        log(f"Wrote GFA to {args.outfile_base}.gfa")
    seqs = (unitig_sequences(g, min_length=args.min_length) if args.unitigs
            else contig_sequences(g))
    with FastaWriter(args.outfile_base + ".fasta.gz", header="",
                     enumerate_sequences=True) as w:
        for s in seqs:
            w.write(s)
    log(f"Assembled {len(seqs)} sequences -> {args.outfile_base}.fasta.gz")


def _count_quantile(sorted_counts: np.ndarray, q: float) -> int:
    """The count at quantile q of sorted counts: the smallest count
    whose cumulative share reaches q (utils::get_quantile)."""
    idx = min(int(np.ceil(q * len(sorted_counts))), len(sorted_counts) - 1)
    return int(sorted_counts[idx])


def cmd_clean(args):
    """Cleaned contigs or unitigs, with a count sidecar on weighted
    graphs (reference cli/clean.cpp:28-200): the node min / max-count
    mask, then unitig-level tip pruning and the median-abundance filter;
    canonical graphs are written in single (primary) form, so that a
    canonical rebuild gives back the node set and counts."""
    from ..graph.cleaning import (clean_node_mask,
                                  estimate_min_kmer_abundance, node_weights)
    from ..graph.masked import MaskedDbg
    from ..graph.traversal import (contig_sequences, single_form_mask,
                                   unitig_sequences)
    from ..seqio.fasta import ExtendedFastaWriter, FastaWriter

    g = _load_graph(args.infile_base or args.fnames[0], args.device,
                    wrap_primary=False)
    has_weights = g.boss.weights is not None
    node_w = node_weights(g) if has_weights else None
    node_w_h = node_w.cpu().numpy() if has_weights else None
    if args.min_count_q > 0 or args.max_count_q < 1:
        # count thresholds from quantiles of the nonzero node counts
        if not has_weights:
            raise SystemExit("clean: --min/max-count-q need k-mer counts")
        w = np.sort(node_w_h[node_w_h > 0])
        if args.min_count_q > 0:
            args.min_count = max(args.min_count,
                                 _count_quantile(w, args.min_count_q))
        if args.max_count_q < 1:
            mc = _count_quantile(w, args.max_count_q)
            args.max_count = mc if args.max_count is None \
                else min(args.max_count, mc)
        log(f"count thresholds from quantiles: min {args.min_count} "
            f"max {args.max_count}")
    prune_unitigs = args.prune_unitigs
    if prune_unitigs == 0 or args.min_count_auto:
        # --prune-unitigs 0: the automatic threshold (clean.cpp:76-100)
        est = estimate_min_kmer_abundance(g, args.num_singletons)
        if est < 0:
            if args.fallback < 0:
                log("Cannot estimate expected minimum k-mer abundance "
                    "and fallback is disabled (--fallback -1). Terminating.")
                sys.exit(129)
            log("Cannot estimate expected minimum k-mer abundance. "
                f"Using fallback value: {args.fallback}")
            prune_unitigs = args.fallback
        else:
            prune_unitigs = est
            log(f"Threshold for median k-mer abundance in unitigs: {est}")

    unitig_mode = (args.unitigs or args.prune_tips > 1 or prune_unitigs > 1
                   or args.smoothing_window > 1)
    filtered = (args.min_count > 1 or args.max_count is not None
                or prune_unitigs > 1 or args.prune_tips > 1)
    if filtered and not has_weights:
        # the JAX package's clean_node_mask reads the node weights even
        # for tip pruning alone (AssertionError in graph/cleaning.py
        # node_weights): a fault of the reference, matched
        raise SystemExit("clean: count or tip filters need a graph built "
                         "with --count-kmers (as in the reference)")
    mask = clean_node_mask(g, min_count=args.min_count,
                           max_count=args.max_count,
                           prune_unitigs=prune_unitigs,
                           min_tip_size=args.prune_tips, node_w=node_w) \
        if filtered else None
    single_form = g.mode == "canonical"
    if single_form:
        sf = single_form_mask(g)
        mask = sf if mask is None else (mask & sf)
    sub = MaskedDbg(base=g, mask=mask) if mask is not None else g
    if unitig_mode and not (single_form or mask is not None):
        seqs, paths = unitig_sequences(sub, return_paths=True)
    else:
        # contigs, also after masking, where the unitigs of the masked
        # graph are the kept paths and kept fragments
        seqs, paths = contig_sequences(sub, return_paths=True)
    out = args.outfile_base
    for suf in (".gz", ".fasta"):
        if out.endswith(suf):
            out = out[:-len(suf)]
    csq = [float(x) for x in args.count_slice_quantiles.split()]
    if csq != [0.0, 1.0]:
        # abundance-binned output (clean.cpp:196-291): per quantile pair,
        # count thresholds from the cleaned nodes' counts, one FASTA per
        # slice named <out>.<qa>.<qb>.fasta.gz
        if not has_weights:
            raise SystemExit("clean: --count-slice-quantiles needs k-mer "
                             "counts")
        if not all(a < b for a, b in zip(csq, csq[1:])):
            raise SystemExit("clean: quantiles must increase")
        kept_nodes = np.concatenate(paths) if paths else \
            np.zeros(0, np.int64)
        counts_kept = np.sort(node_w_h[kept_nodes])

        def quantile(q):
            return _count_quantile(counts_kept, q) if len(counts_kept) else 1

        for qa, qb in zip(csq, csq[1:]):
            min_c = quantile(qa) if qa > 0 else 1
            max_c = quantile(qb) if qb < 1 else (1 << 62)
            log(f"k-mer count thresholds: min (including): {min_c} "
                f"max (excluding): {max_c}")
            m2 = np.zeros(g.num_nodes() + 1, bool)
            m2[kept_nodes] = (node_w_h[kept_nodes] >= min_c) \
                & (node_w_h[kept_nodes] < max_c)
            sseqs = contig_sequences(MaskedDbg(base=g, mask=m2))
            fb = f"{out}.{qa:g}.{qb:g}"
            with FastaWriter(fb + ".fasta.gz", header=args.header) as w:
                for s in sseqs:
                    w.write(s)
            log(f"Slice [{qa:g}, {qb:g}): {len(sseqs)} sequences "
                f"-> {fb}.fasta.gz")
        return
    if has_weights:
        with ExtendedFastaWriter(out, g.k, header=args.header) as w:
            for s, p in zip(seqs, paths):
                counts = node_w_h[p]
                if args.smoothing_window > 1:
                    counts = _smooth_counts(counts, args.smoothing_window)
                w.write(s, counts)
    else:
        with FastaWriter(out + ".fasta.gz", header=args.header) as w:
            for s in seqs:
                w.write(s)
    kept = int(mask[1:].sum()) if mask is not None else g.num_nodes()
    log(f"Cleaned graph: kept {kept}/{g.num_nodes()} nodes, "
        f"{len(seqs)} sequences -> {out}.fasta.gz")


def _smooth_counts(counts, window: int):
    """Sliding-window mean smoothing (utils::smooth_vector)."""
    c = np.asarray(counts, np.float64)
    half = window // 2
    cum = np.concatenate([[0], np.cumsum(c)])
    n = len(c)
    lo = np.maximum(np.arange(n) - half, 0)
    hi = np.minimum(np.arange(n) + half + 1, n)
    return ((cum[hi] - cum[lo]) / (hi - lo)).astype(np.uint32)


# ---------------------------------------------------------------------------
# GFA output
# ---------------------------------------------------------------------------

def _write_gfa(g, path, compacted: bool = True):
    """GFA as the reference's assemble.cpp:118-155 writes it: compacted
    segments are whole unitigs named by their last node id, with one L
    line per incoming edge of each unitig's first node; non-compacted
    writes every node as a segment, plus the links inside unitigs."""
    import torch
    from ..graph.traversal import unitig_decomposition, unitig_sequences
    u = unitig_decomposition(g)
    seqs, paths = unitig_sequences(g, u, return_paths=True)
    k = g.k
    overlap = k - 1
    starts = np.array([p[0] for p in paths], np.int64)
    preds = g.predecessors(torch.from_numpy(starts).to(g.device)).cpu() \
        .numpy() if len(starts) else np.zeros((0, 0), np.int64)
    lines = ["H\tVN:Z:1.0\n"]
    for s, p, pr in zip(seqs, paths, preds):
        links = "".join(f"L\t{v}\t+\t{p[0] if not compacted else p[-1]}"
                        f"\t+\t{overlap}M\n" for v in pr if v > 0)
        if compacted:
            lines.append(f"S\t{p[-1]}\t{s.decode()}\n" + links)
            continue
        text = s.decode()
        lines.extend(f"S\t{v}\t{text[i:i + k]}\n" + (
            f"L\t{p[i - 1]}\t+\t{v}\t+\t{overlap}M\n" if i else "")
            for i, v in enumerate(p))
        lines.append(links)
    with open(path, "w") as fh:
        fh.write("".join(lines))


def _align_gfa_paths(g, args):
    """<base>.path.gfa with one P line per input read (align.cpp
    sequence_to_gfa_path + gfa_map_files): the read's nodes, or with
    --compacted only those that end a unitig, the last one walked forward
    to the end of its unitig. Inside a unitig every node's first
    successor is the next node of its chain, so the JAX CLI's walk (one
    successor lookup a step) ends at the chain's last node: one gather
    here."""
    from ..graph.traversal import unitig_decomposition, unitig_ends
    from ..seqio.fasta import parse_records
    u = unitig_decomposition(g)
    ends = unitig_ends(g, u)
    end_of = ends[u.chain_id].cpu().numpy()
    end_of[0] = 0                 # an absent k-mer has no successor
    is_end = np.zeros(len(end_of), bool)
    is_end[ends.cpu().numpy()] = True
    base = args.outfile_base
    for suf in (".gfa", ".path"):
        if base.endswith(suf):
            base = base[:-len(suf)]
    k = g.k
    with open(base + ".path.gfa", "w") as f:
        seq_id = 0
        for fn in args.fnames:
            for rec in parse_records(fn):
                seq_id += 1
                path = g.map_to_nodes(rec.seq)
                head, last = path[:-1], int(path[-1])
                if args.compacted:
                    head = head[is_end[head]]
                    last = int(end_of[last])
                nodes_str = [f"{v}+" for v in head.tolist()] + [f"{last}+"]
                f.write(f"P\t{seq_id}\t{','.join(nodes_str)}\t"
                        f"{','.join([f'{k - 1}M'] * len(head))}\n")


# ---------------------------------------------------------------------------
# graph operations: extend, merge, compare, transform
# ---------------------------------------------------------------------------

def _real_edges(g, weighted: bool):
    """The real edge k-mers of a fast-state graph, compacted by the
    partition kernel, with their weights (ones when not ``weighted``):
    ((L, n) lanes, (n,) int32 counts)."""
    import torch
    from ..common import merge as pmerge
    from ..kmer import packing
    lanes = g.boss.edge_lanes
    if lanes is None:
        raise SystemExit("a small-state graph has no edge k-mers to "
                         "rebuild from (transform --state fast needs a "
                         "rebuild as well)")
    real = ~packing.contains_sentinel(lanes, g.k, g.alphabet.bits_per_char)
    # weights are (m,) with slot 0 the sentinel row; edge_lanes (L, m - 1)
    w = (g.boss.weights[1:].to(torch.int32) if weighted else
         torch.ones((lanes.shape[1],), dtype=torch.int32,
                    device=lanes.device))
    comp, cnt, (wc,) = pmerge.partition_compact(lanes, real, lanes.shape[1],
                                                w)
    n = int(cnt)
    return comp[:, :n], wc[:n]


def _rebuild(lanes_parts, count_parts, k: int, alphabet, **kw):
    """Sort-unique the union of k-mer sets (counts summed), then build."""
    import torch
    from ..graph.boss_construct import (_sort_unique_stage,
                                        build_boss_from_kmers)
    merged = torch.cat(lanes_parts, dim=1)
    counts = torch.cat(count_parts)
    u, uc, n_u = _sort_unique_stage(merged, counts, merged.shape[1])
    n_u = int(n_u)
    return build_boss_from_kmers(u, uc, n_u, k, alphabet, **kw), n_u


def cmd_extend(args):
    """Add sequences to a graph (reference cli/augment.cpp) by a static
    rebuild of the union of the k-mer sets."""
    from ..graph import io as graph_io
    from ..graph.boss_construct import collect_kmers
    from ..graph.dbg_succinct import DbgSuccinct
    from ..seqio.fasta import parse_records

    g = _load_graph(args.infile_base, args.device, wrap_primary=False)
    weighted = g.boss.weights is not None
    old, old_w = _real_edges(g, weighted)
    new, new_c, n_new, _ = collect_kmers(
        [r.seq for f in args.fnames for r in parse_records(f)], g.k,
        g.alphabet,
        canonical=g.mode in ("canonical", "primary"), device=args.device,
        with_bounds=False)
    boss, n_u = _rebuild(
        [old, new[:, :n_new]], [old_w, new_c[:n_new]], g.k, g.alphabet,
        mode="canonical" if g.mode == "canonical" else "basic",
        bits_per_count=args.count_width if weighted else 0)
    out = graph_io.save_graph(args.outfile_base or args.infile_base,
                              DbgSuccinct.from_boss(boss, g.alphabet, g.mode))
    log(f"Extended graph -> {out} ({n_u} k-mers)")


def _boss(g, what: str):
    """The BOSS table of a graph. The JAX CLI loads the graphs of merge
    and compare wrapped, and a primary graph's wrapper has none
    (AttributeError in metagraph_tpu/cli/main.py cmd_merge, cmd_compare):
    a fault of the reference, matched by a non-zero exit."""
    if not hasattr(g, "boss"):
        raise SystemExit(f"{what}: primary graphs fail in the reference "
                         f"(CanonicalDbg has no BOSS table)")
    return g.boss


def cmd_merge(args):
    """The union of graphs' real edge k-mers, rebuilt in memory; weighted
    inputs sum their counts per k-mer, widened to 31 bits."""
    from ..graph import io as graph_io
    from ..graph.dbg_succinct import DbgSuccinct

    graphs = [_load_graph(f, args.device) for f in args.fnames]
    weighted = all(_boss(g, "merge").weights is not None for g in graphs)
    if args.num_shards > 1:
        # the graphs' sorted edge sets through the out-of-core finish:
        # device working set O(total / num_shards)
        import torch
        from ..parallel.outofcore import merge_boss_graphs_out_of_core
        try:
            boss, valid = merge_boss_graphs_out_of_core(
                graphs, n_shards=args.num_shards,
                keep_kmer_index=args.state != "small", verbose=args.verbose,
                return_valid=True, device=args.device)
        except ValueError as e:
            raise SystemExit(f"merge: {e}") from e
        g0 = graphs[0]
        out = graph_io.save_graph(
            args.outfile_base,
            DbgSuccinct.from_boss(boss, g0.alphabet, g0.mode,
                                  valid=torch.from_numpy(valid).to(
                                      boss.device)), state=args.state)
        log(f"Merged {len(graphs)} graphs (streaming, {args.num_shards} "
            f"shards) -> {out}")
        return
    parts = [_real_edges(g, weighted) for g in graphs]
    g0 = graphs[0]
    boss, _ = _rebuild([p[0] for p in parts], [p[1] for p in parts], g0.k,
                       g0.alphabet, bits_per_count=31 if weighted else 0)
    out = graph_io.save_graph(args.outfile_base,
                              DbgSuccinct.from_boss(boss, g0.alphabet,
                                                    g0.mode))
    log(f"Merged {len(graphs)} graphs -> {out}")


def cmd_compare(args):
    """Equal k, node count, W and last (the JAX CLI's check)."""
    import torch
    g1, g2 = (_load_graph(f, args.device) for f in args.fnames)
    same = (g1.k == g2.k and g1.num_nodes() == g2.num_nodes()
            and torch.equal(_boss(g1, "compare").W.cpu(),
                            _boss(g2, "compare").W.cpu())
            and np.array_equal(g1.boss.last_rank.bits_host(),
                               g2.boss.last_rank.bits_host()))
    print("Graphs are identical" if same else "Graphs are not identical")


def cmd_transform(args):
    from ..graph.traversal import contig_sequences
    g = _load_graph(args.infile_base or args.fnames[0], args.device,
                    wrap_primary=False)
    if args.initialize_bloom:
        # batched membership has uniform hit / miss cost: the Bloom
        # prefilter flags are accepted and do nothing
        log("Bloom filter subsumed by batched membership; nothing to do")
        return
    if args.state:
        # BOSS state switching: small drops the edge k-mers
        from ..graph import io as graph_io
        if args.state == "fast" and g.boss.edge_lanes is None:
            log("small -> fast state restore is not supported yet; rebuild")
            sys.exit(1)
        out = graph_io.save_graph(args.outfile_base, g, state=args.state)
        log(f"Serialized {args.state}-state graph to {out}")
        return
    if args.to_fasta:
        from ..seqio.fasta import FastaWriter
        if args.primary_kmers:
            # one orientation per rc pair: contigs of the graph masked to
            # the smaller packed form
            from ..graph.masked import MaskedDbg
            from ..graph.traversal import single_form_mask
            g = MaskedDbg(base=g, mask=single_form_mask(g))
        out = args.outfile_base
        if not out.endswith(".fasta.gz"):
            out = out + ".fasta.gz"
        with FastaWriter(out) as w:
            for s in contig_sequences(g):
                w.write(s)
        log(f"Wrote contigs to {out}")
    elif args.to_gfa:
        _write_gfa(g, args.outfile_base + ".gfa", compacted=args.compacted)
        log(f"Wrote GFA to {args.outfile_base}.gfa")
    elif args.to_adj_list:
        import torch
        from ..graph.traversal import in_chunks
        succ = in_chunks(g.successors, torch.arange(
            1, g.num_nodes() + 1, device=g.device)).cpu().numpy()
        with open(args.outfile_base + ".adjlist", "w") as fh:
            fh.write("".join(
                f"{i}\t" + " ".join(str(t) for t in row if t > 0) + "\n"
                for i, row in enumerate(succ.tolist(), start=1)))
        log(f"Wrote adjacency list to {args.outfile_base}.adjlist")


# ---------------------------------------------------------------------------
# annotation conversions: transform_anno, relax_brwt, merge_anno
# ---------------------------------------------------------------------------

def cmd_merge_anno(args):
    """One column annotation of several over the same rows."""
    from ..anno.annotator import Annotation
    parts = [Annotation.load(f, device=args.device) for f in args.fnames]
    merged = Annotation.merge(parts, max(p.matrix.num_rows for p in parts),
                              device=args.device)
    path = args.outfile_base + ".column.annodbg.npz"
    merged.save(path)
    log(f"Merged {len(parts)} annotations -> {path} "
        f"({merged.num_labels} labels)")


def _accumulate(path: str, key: str, arr: np.ndarray):
    """Add ``arr`` into the artifact at ``path`` (the staged conversion's
    column batches sum their row counts and reductions), then save."""
    import os
    if os.path.exists(path):
        old = np.load(path)[key]
        acc = np.zeros(max(len(old), len(arr)), np.int64)
        acc[:len(old)] += old
        acc[:len(arr)] += arr
        arr = acc
    np.savez_compressed(path, **{key: arr})


def _load_rd_artifacts(outfile_base: str):
    """The stage-0 / stage-1 artifacts next to the output base, if there."""
    import os
    found = []
    for suffix, key in ((".row_count.npz", "row_count"),
                        (".row_reduction.npz", "row_reduction")):
        p = outfile_base + suffix
        found.append(np.load(p)[key] if os.path.exists(p) else None)
    return found


def _row_diff_stage(args, rs, target: str):
    """Stage 0 (labels per row) or stage 1 (the reduction of each row
    under the path anchors; needs the graph) of the reference's staged
    RowDiff conversion, accumulated into ``<out>.row_count.npz`` /
    ``<out>.row_reduction.npz`` across calls."""
    import os
    from ..anno import row_diff as rd
    if args.row_diff_stage == 0:
        path = args.outfile_base + ".row_count.npz"
        _accumulate(path, "row_count",
                    rd.compute_row_counts(rs).cpu().numpy())
        log(f"row_diff stage 0: accumulated label counts for "
            f"{rs.num_cols} columns -> {path}")
        return
    if not args.infile_base:
        raise SystemExit("transform_anno: row_diff stage 1 needs the graph "
                         "(-i)")
    g = _load_graph(args.infile_base, args.device)
    cpath = args.outfile_base + ".row_count.npz"
    row_counts = (np.load(cpath)["row_count"] if os.path.exists(cpath)
                  else None)
    fn = (rd.compute_row_reduction_int
          if target.startswith("int_row_diff") and rs.values is not None
          else rd.compute_row_reduction)
    red = fn(rs, g, max_length=args.max_path_length, row_counts=row_counts)
    path = args.outfile_base + ".row_reduction.npz"
    _accumulate(path, "row_reduction", red.cpu().numpy())
    log(f"row_diff stage 1: accumulated row reductions -> {path}")


def _read_linkage(path: str):
    """Rows '<c1> <c2> <dist> <merged>' of a linkage file."""
    out = []
    with open(path) as fh:
        for line in fh:
            ps = line.split()
            if len(ps) == 4:
                out.append((int(ps[0]), int(ps[1]), float(ps[2]),
                            int(ps[3])))
    return out


def _convert(args, mat, target: str):
    """The ``--anno-type`` conversion of a loaded matrix."""
    from ..anno import brwt, coords, int_brwt, row_diff, unique_row

    def graph():
        if not args.infile_base:
            raise SystemExit(f"transform_anno: {target} needs the graph (-i)")
        return _load_graph(args.infile_base, args.device)

    def counts(rs):
        if rs.values is None:
            raise SystemExit(f"transform_anno: {target} needs a count "
                             f"annotation (annotate --count-kmers)")
        return rs

    if target in ("column_coord", "row_diff_coord", "tuple_row_diff"):
        if not isinstance(mat, coords.CoordMatrix):
            raise SystemExit(f"transform_anno: {target} needs a coordinate "
                             f"annotation input (annotate --coordinates)")
        if target == "column_coord":
            return mat
        return coords.build_tuple_row_diff(mat, graph(),
                                           args.max_path_length)
    rs = mat.to_row_sparse()
    if target in ("column", "row", "row_sparse", "flat"):
        return rs
    if target in ("brwt", "bin_rel_wt", "bin_rel_wt_sdsl"):
        # bin_rel_wt*: the binary-relation wavelet tree's role, stored as a
        # BRWT (the same query surface), as in the JAX package
        linkage = (_read_linkage(args.linkage_file)
                   if target == "brwt" and args.linkage_file else None)
        out = brwt.build_brwt(rs, subsample=args.num_rows_subsampled,
                              linkage=linkage)
        if target == "brwt" and args.relax_arity > 2:
            out = brwt.relax_brwt(out, args.relax_arity)
        return out
    if target in ("unique_row", "rbfish"):
        return unique_row.UniqueRow.from_row_sparse(rs)
    if target == "rb_brwt":
        return unique_row.UniqueRow.from_row_sparse(rs).with_brwt_distinct(
            subsample=args.num_rows_subsampled)
    if target == "int_brwt":
        return int_brwt.build_int_brwt(counts(rs),
                                       subsample=args.num_rows_subsampled)
    g = graph()
    if g.num_nodes() != rs.num_rows:
        # a primary graph's wrapper walks 2N virtual nodes over N rows; the
        # JAX package fails on the mismatch (ValueError): matched
        raise SystemExit(f"transform_anno: {target} of a graph with "
                         f"{g.num_nodes()} nodes and an annotation of "
                         f"{rs.num_rows} rows fails in the reference "
                         f"(primary graphs)")
    if target == "row_diff_brwt":
        return row_diff.build_row_diff_brwt(
            rs, g, max_length=args.max_path_length,
            subsample=args.num_rows_subsampled)
    rc, rr = _load_rd_artifacts(args.outfile_base)
    kw = dict(max_length=args.max_path_length, row_counts=rc,
              row_reduction=rr)
    if target in ("row_diff", "row_diff_sparse"):
        # row_diff_sparse: RowDiff over a RowSparse diff matrix, which is
        # the row_diff form here
        return row_diff.build_row_diff(rs, g, **kw)
    if target == "int_row_diff":
        return row_diff.build_int_row_diff(counts(rs), g, **kw)
    return int_brwt.build_int_row_diff_brwt(      # row_diff_int_brwt
        counts(rs), g, subsample=args.num_rows_subsampled, **kw)


def cmd_transform_anno(args):
    """Convert an annotation to another representation (``--anno-type``),
    or: rename its labels first (``--rename-cols``); aggregate columns
    into one mask column (``--aggregate-columns``); write the column
    linkage only (``--linkage``); dump its columns as text
    (``--dump-text-anno``); run stage 0 or 1 of a staged RowDiff
    conversion (``--row-diff-stage``)."""
    import math
    from ..anno.annotator import Annotation, LabelEncoder
    from ..anno.matrix import RowSparse

    ann = Annotation.load(args.fnames[0], device=args.device)
    if args.rename_cols:
        # whitespace-separated "<old> <new>" pairs
        with open(args.rename_cols) as fh:
            toks = fh.read().split()
        if len(toks) % 2:
            raise SystemExit(f"{args.rename_cols}: odd token count in "
                             "rename rules")
        rename = dict(zip(toks[::2], toks[1::2]))
        enc = LabelEncoder([rename.get(label, label)
                            for label in ann.encoder.labels])
        if len(enc) != len(ann.encoder.labels):
            raise SystemExit("rename rules collapse distinct labels")
        ann = Annotation(matrix=ann.matrix, encoder=enc)
    if args.aggregate_columns:
        # one "mask" column: the rows set in [min, max] of all input columns
        parts = [ann] + [Annotation.load(f, device=args.device)
                         for f in args.fnames[1:]]
        num_columns = sum(p.num_labels for p in parts)
        num_rows = max(p.matrix.num_rows for p in parts)
        counts = np.zeros(num_rows, np.int64)
        for p in parts:
            np.add.at(counts, p.matrix.to_row_sparse().rows.cpu().numpy(), 1)
        min_cols = max(math.ceil(num_columns * args.min_fraction),
                       args.min_count)
        max_cols = min(math.floor(num_columns * args.max_fraction),
                       args.max_count if args.max_count is not None
                       else num_columns)
        keep = np.nonzero((counts >= min_cols) & (counts <= max_cols))[0]
        out = Annotation(matrix=RowSparse.from_coo(
            keep, np.zeros(len(keep), np.int64), num_rows, 1,
            device=args.device), encoder=LabelEncoder([args.anno_label
                                                       or "mask"]))
        path = args.outfile_base + ".column.annodbg.npz"
        out.save(path)
        log(f"Aggregated {num_columns} columns ({min_cols} <= * <= "
            f"{max_cols}) -> {path} ({len(keep)} rows set)")
        return
    if args.compute_linkage:
        from ..anno.brwt import compute_linkage
        rs = ann.matrix.to_row_sparse()
        path = args.outfile_base + ".linkage"
        with open(path, "w") as fh:
            fh.write("".join(f"{c1} {c2} {dist:g} {m}\n" for c1, c2, dist, m
                             in compute_linkage(
                                 rs, subsample=args.num_rows_subsampled)))
        log(f"Linkage of {rs.num_cols} columns -> {path}")
        return
    if args.dump_text_anno:
        # per column "<set bits>" then one row id a line
        rs = ann.matrix.to_row_sparse()
        rows, cols = rs.rows.cpu().numpy(), rs.cols.cpu().numpy()
        for ci, label in enumerate(ann.encoder.labels):
            rset = np.sort(rows[cols == ci])
            path = f"{args.outfile_base}.{ci}.text.annodbg"
            with open(path, "w") as fh:
                fh.write(f"{len(rset)}\n" + "".join(f"{r}\n"
                                                    for r in rset.tolist()))
            log(f"Dumped column '{label}' -> {path}")
        return
    target = args.anno_type
    if target.startswith(("row_diff", "int_row_diff", "tuple_row_diff")) \
            and args.row_diff_stage < 2:
        _row_diff_stage(args, ann.matrix.to_row_sparse(), target)
        return
    if args.disk_swap and target in ("row_diff", "int_row_diff"):
        _row_diff_disk_swap(args, target)
        return
    out_mat = _convert(args, ann.matrix, target)
    if target == "int_row_diff_brwt":
        target = "row_diff_int_brwt"
    path = args.outfile_base + f".{target}.annodbg.npz"
    Annotation(matrix=out_mat, encoder=ann.encoder).save(path)
    log(f"Serialized {target} annotation to {path}")


def _row_diff_disk_swap(args, target: str):
    """The out-of-core staged conversion of every input file
    (``anno/row_diff_disk.py``): spill runs in ``--disk-swap``, bounded by
    ``--mem-cap-gb`` of buffer."""
    from ..anno import row_diff_disk
    if not args.infile_base:
        raise SystemExit(f"transform_anno: {target} needs the graph (-i)")
    g = _load_graph(args.infile_base, args.device)
    build = (row_diff_disk.build_int_row_diff_staged
             if target == "int_row_diff"
             else row_diff_disk.build_row_diff_staged)
    try:
        out = build(args.fnames, g, swap_dir=args.disk_swap,
                    mem_cap_mb=int(args.mem_cap_gb * 1024),
                    max_length=args.max_path_length)
    except ValueError as e:
        raise SystemExit(f"transform_anno: {e}") from e
    path = args.outfile_base + f".{target}.annodbg.npz"
    out.save(path)
    log(f"Serialized {target} annotation to {path}")


def cmd_concatenate(args):
    """The graph of a chunked build's chunk files (reference concatenate,
    build.cpp:359-456): the files named, or ``-i BASE``'s
    ``BASE.<suffix>.chunk.npz`` in bucket colex order. The JAX CLI looks
    for DNA's buckets whatever the chunks' alphabet, so it drops every
    bucket of another alphabet's letters; here the buckets are those of
    the alphabet the chunks record (ROADMAP §3.5)."""
    import glob
    from ..kmer.alphabets import ALPHABETS
    from ..parallel.sharded_build import (bucket_name, concatenate_chunks,
                                          suffix_buckets)
    files = list(args.fnames)
    if not files and args.infile_base:
        found = sorted(glob.glob(glob.escape(args.infile_base)
                                 + ".*.chunk.npz"))
        if found:
            with np.load(found[0]) as d:
                alphabet = ALPHABETS[str(d["alphabet"])]
            for sfx in suffix_buckets(alphabet, args.len_suffix):
                p = f"{args.infile_base}.{bucket_name(alphabet, sfx)}.chunk.npz"
                if os.path.exists(p):
                    files.append(p)
    if not files:
        raise SystemExit("concatenate: no chunk files")
    concatenate_chunks(files, args.outfile_base, mode=args.mode,
                       bits_per_count=args.count_width if args.count_kmers
                       else 0, device=args.device)
    log(f"Concatenated {len(files)} chunks -> {args.outfile_base}")


def cmd_coordinator(args):
    """Serve a work queue of per-suffix chunk builds, wait for workers to
    drain it, then concatenate the chunks (the reference's cloud work
    queue, scripts/cloud/server.py:88-230). Each job runs on the
    coordinator's ``--device``."""
    from ..kmer.alphabets import DNA
    from ..parallel.coordinator import serve_queue
    from ..parallel.sharded_build import (bucket_name, concatenate_chunks,
                                          suffix_buckets)
    jobs, chunk_files = [], []
    for sfx in suffix_buckets(DNA, args.suffix_len):
        name = bucket_name(DNA, sfx)
        jobs.append({"argv": ["build", "-k", str(args.k), "--mode", args.mode,
                              "--suffix", name, "-o", args.outfile_base,
                              "--device", args.device]
                     + (["--count-kmers"] if args.count_kmers else [])
                     + args.fnames})
        chunk_files.append(f"{args.outfile_base}.{name}.chunk.npz")
    httpd, queue = serve_queue(jobs, host=args.host, port=args.port)
    log(f"Coordinator: {len(jobs)} jobs on "
        f"http://{httpd.server_address[0]}:{httpd.server_address[1]}")
    try:
        while not queue.finished():
            time.sleep(0.5)
    finally:
        httpd.shutdown()
    concatenate_chunks(chunk_files, args.outfile_base, mode=args.mode,
                       bits_per_count=args.count_width if args.count_kmers
                       else 0, device=args.device)
    log(f"Distributed build complete -> {args.outfile_base}")


def cmd_worker(args):
    """Pull and run a coordinator's jobs until its queue drains (the
    reference's cloud worker, scripts/cloud/client.py)."""
    from ..parallel.coordinator import Worker
    Worker(args.server, name=args.name).run_until_empty()
    log("Worker done: queue drained")


def cmd_server_query(args):
    """server_query: serve a graph and its annotation over HTTP
    (server/http_server.py) until interrupted."""
    from ..server.http_server import run_server
    run_server(args)


def cmd_relax_brwt(args):
    """Widen a BRWT's nodes up to ``--relax-arity`` children."""
    from ..anno.annotator import Annotation
    from ..anno.brwt import Brwt, relax_brwt
    ann = Annotation.load(args.fnames[0], device=args.device)
    if not isinstance(ann.matrix, Brwt):
        raise SystemExit("relax_brwt: the input must be a BRWT annotation")
    path = args.outfile_base + ".brwt.annodbg.npz"
    Annotation(matrix=relax_brwt(ann.matrix, args.relax_arity),
               encoder=ann.encoder).save(path)
    log(f"Serialized relaxed BRWT to {path}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="metagraph",
                                description="MetaGraph on PyTorch (port)")
    sub = p.add_subparsers(dest="command", required=True)

    def add(name, func):
        sp = sub.add_parser(name)
        sp.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "kernels' plain versions)")
        # the JAX CLI's global flags: -v / --debug turn on the telemetry
        # spans (stderr); -p, its thread count, has no effect here
        # (PyTorch sizes its own pools)
        sp.add_argument("-v", "--verbose", action="store_true")
        sp.add_argument("-p", "--parallel", type=int, default=1)
        sp.add_argument("--debug", action="store_true")
        for flag, fkw in _PARITY_INERT:
            sp.add_argument(flag, **fkw)
        sp.set_defaults(func=func)
        return sp

    sp = add("build", cmd_build)
    sp.add_argument("-k", "--kmer-length", dest="k", type=int, required=True)
    sp.add_argument("--mode", choices=["basic", "canonical", "primary"],
                    default="basic")
    sp.add_argument("--count-kmers", action="store_true")
    sp.add_argument("--count-width", type=int, default=8)
    sp.add_argument("--min-count", type=int, default=1,
                    help="KMC input: drop k-mers counted fewer times")
    sp.add_argument("--max-count", type=int, default=None,
                    help="KMC input: drop k-mers counted more times")
    # dummy edges are always masked and erased, and the top-16-bit search
    # table plays the role of --index-ranges: accepted for the
    # reference's workflows, no effect
    sp.add_argument("--mask-dummy", action="store_true")
    sp.add_argument("--clear-dummy", action="store_true")
    sp.add_argument("--no-postprocessing", action="store_true")
    sp.add_argument("--index-ranges", type=int, default=None)
    sp.add_argument("--graph", default="succinct")
    sp.add_argument("--reference", default=None,
                    help="reference FASTA for VCF inputs")
    sp.add_argument("--alphabet", default="DNA",
                    choices=["DNA", "DNA5", "DNACaseSent", "Protein"])
    sp.add_argument("--fwd-and-reverse", action="store_true",
                    help="also build from each sequence's reverse "
                         "complement")
    sp.add_argument("--state", choices=["fast", "small"], default="fast")
    # the scale-out builds (parallel/)
    sp.add_argument("--suffix-len", type=int, default=0,
                    help="suffix-sharded build over this node-suffix length")
    sp.add_argument("--suffix", default=None,
                    help="build only this node suffix's chunk file")
    sp.add_argument("--num-shards", type=int, default=1,
                    help="basic mode: the out-of-core build over this many "
                         "shards; other modes: a suffix-sharded build")
    sp.add_argument("--disk-swap", default="",
                    help="streamed collect; a directory holds its runs")
    sp.add_argument("--mem-cap-gb", type=float, default=1.0,
                    help="--disk-swap: the collect window (16 bytes a "
                         "character)")
    sp.add_argument("--parts-total", type=int, default=1,
                    help="split the suffix buckets across this many build "
                         "invocations")
    sp.add_argument("--part-idx", type=int, default=0,
                    help="which bucket subset this invocation builds")
    sp.add_argument("-o", "--outfile-base", default="graph")
    sp.add_argument("fnames", nargs="*")

    sp = add("concatenate", cmd_concatenate)
    sp.add_argument("-o", "--outfile-base", default="graph")
    sp.add_argument("-i", "--infile-base", default=None)
    sp.add_argument("--len-suffix", type=int, default=1)
    sp.add_argument("--mode", choices=["basic", "canonical", "primary"],
                    default="basic")
    sp.add_argument("--count-kmers", action="store_true")
    sp.add_argument("--count-width", type=int, default=8)
    sp.add_argument("fnames", nargs="*")

    sp = add("coordinator", cmd_coordinator)
    sp.add_argument("-k", "--kmer-length", dest="k", type=int, required=True)
    sp.add_argument("--mode", choices=["basic", "canonical", "primary"],
                    default="basic")
    sp.add_argument("--count-kmers", action="store_true")
    sp.add_argument("--count-width", type=int, default=8)
    sp.add_argument("--suffix-len", type=int, default=1)
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=0)
    sp.add_argument("-o", "--outfile-base", default="graph")
    sp.add_argument("fnames", nargs="+")

    sp = add("worker", cmd_worker)
    sp.add_argument("--server", required=True)
    sp.add_argument("--name", default="worker")

    sp = add("stats", cmd_stats)
    sp.add_argument("--count-dummy", action="store_true")
    sp.add_argument("--print", dest="print_graph", action="store_true",
                    help="print the decoded BOSS table")
    sp.add_argument("--print-internal", action="store_true",
                    help="print the internal W / last / F representation")
    sp.add_argument("--print-col-names", action="store_true")
    sp.add_argument("--validate", action="store_true",
                    help="check the BOSS structural invariants")
    sp.add_argument("-a", "--annotation", default=None)
    sp.add_argument("fnames", nargs="+")

    sp = add("annotate", cmd_annotate)
    sp.add_argument("-i", "--infile-base", required=True)
    sp.add_argument("-o", "--outfile-base", default=None)
    sp.add_argument("--anno-filename", action="store_true")
    sp.add_argument("--anno-header", action="store_true")
    sp.add_argument("--header-delimiter", default="",
                    help="split sequence headers into several labels")
    sp.add_argument("--header-comment-delim", default="",
                    help="join a header with its comment by this "
                         "delimiter before taking labels")
    sp.add_argument("--anno-label", action="append")
    sp.add_argument("--count-kmers", action="store_true")
    sp.add_argument("--coordinates", action="store_true",
                    help="annotate k-mer coordinates (.coord.annodbg.npz)")
    # one annotation over all inputs either way (as the JAX CLI)
    sp.add_argument("--separately", action="store_true")
    sp.add_argument("fnames", nargs="+")

    # annotate with coordinates on; the JAX CLI's parser for it lacks
    # --header-comment-delim, so its --anno-header fails there
    # (AttributeError): a fault of the reference, repaired here
    sp = add("coordinate", cmd_annotate)
    sp.add_argument("-i", "--infile-base", required=True)
    sp.add_argument("-o", "--outfile-base", default=None)
    sp.add_argument("--anno-filename", action="store_true")
    sp.add_argument("--anno-header", action="store_true")
    sp.add_argument("--header-delimiter", default="")
    sp.add_argument("--anno-label", action="append")
    sp.set_defaults(count_kmers=False, coordinates=True, separately=False,
                    header_comment_delim="")
    sp.add_argument("fnames", nargs="+")

    sp = add("query", cmd_query)
    sp.add_argument("-i", "--infile-base", default=None)
    sp.add_argument("-a", "--annotation", default=None)
    sp.add_argument("--address", default="",
                    help="HOST:PORT of a running server_query: send the "
                         "reads there instead of loading an index")
    sp.add_argument("--count-labels", action="store_true")
    sp.add_argument("--count-kmers", "--query-counts", dest="query_counts",
                    action="store_true",
                    help="report per label the sum of the annotation's "
                         "k-mer counts")
    sp.add_argument("--count-quantiles", default=None,
                    help="space-separated quantiles in [0, 1]")
    sp.add_argument("--print-signature", action="store_true")
    sp.add_argument("--query-coords", action="store_true",
                    help="per label, the coordinates of every k-mer")
    sp.add_argument("--suppress-unlabeled", action="store_true")
    sp.add_argument("--num-top-labels", type=int, default=2 ** 62)
    sp.add_argument("--discovery-fraction", type=float, default=0.7)
    sp.add_argument("--fwd-and-reverse", action="store_true")
    sp.add_argument("--labels-delimiter", dest="anno_labels_delimiter",
                    default=":")
    sp.add_argument("--batch-size", type=int, default=100 << 20)
    sp.add_argument("--align", action="store_true")
    sp.add_argument("--batch-align", action="store_true")
    # the reference's hull bounds (--max-hull-depth/--max-hull-forks) and
    # --fast are accepted so its command lines run unchanged: the batch
    # path aligns against the full graph
    sp.add_argument("--max-hull-depth", type=int, default=None)
    sp.add_argument("--max-hull-forks", type=int, default=None)
    sp.add_argument("--align-min-exact-match", type=float, default=0.7)
    sp.add_argument("--fast", action="store_true")
    sp.add_argument("fnames", nargs="+")

    sp = add("align", cmd_align)
    sp.add_argument("-i", "--infile-base", required=True)
    sp.add_argument("-o", "--outfile-base", default=None)
    sp.add_argument("--map", dest="map_only", action="store_true")
    sp.add_argument("--count-kmers", action="store_true")
    sp.add_argument("--query-presence", action="store_true",
                    help="test reads for presence, report 0/1")
    sp.add_argument("--filter-present", action="store_true",
                    help="with --query-presence: emit present reads as "
                         "FASTA")
    sp.add_argument("--discovery-fraction", type=float, default=1.0)
    sp.add_argument("--align-both-strands", action="store_true")
    sp.add_argument("--align-edit-distance", action="store_true")
    sp.add_argument("--align-min-exact-match", type=float, default=0.7)
    sp.add_argument("--compacted", action="store_true")
    sp.add_argument("--align-min-seed-length", type=int, default=0)
    sp.add_argument("--align-max-seed-length", type=int, default=0,
                    help="clamp exact-match anchors to this length")
    sp.add_argument("--align-max-num-seeds-per-locus", type=int,
                    default=16)
    sp.add_argument("--align-max-nodes-per-seq-char", type=float,
                    default=0.0,
                    help="bounds the beam width (expanded nodes per "
                         "query char)")
    # scoring flags take both the short and the reference's --align-*
    # spellings
    sp.add_argument("--match-score", "--align-match-score",
                    dest="match_score", type=int, default=2)
    sp.add_argument("--mm-transition-penalty",
                    "--align-mm-transition-penalty",
                    dest="mm_transition_penalty", type=int, default=3)
    sp.add_argument("--mm-transversion-penalty",
                    "--align-mm-transversion-penalty",
                    dest="mm_transversion_penalty", type=int, default=3)
    sp.add_argument("--gap-opening-penalty", "--align-gap-open-penalty",
                    dest="gap_opening_penalty", type=int, default=5)
    sp.add_argument("--gap-extension-penalty",
                    "--align-gap-extension-penalty",
                    dest="gap_extension_penalty", type=int, default=2)
    sp.add_argument("--align-xdrop", type=int, default=27)
    sp.add_argument("--align-min-cell-score", type=int, default=None,
                    help="prune beam entries whose best DP cell falls "
                         "below this")
    sp.add_argument("--align-max-ram", type=float, default=None,
                    help="approximate per-batch DP memory budget in MB; "
                         "caps the extension sub-batch size")
    sp.add_argument("--align-min-path-score", type=int, default=0,
                    help="drop alignments scoring below this")
    sp.add_argument("--num-alternative-paths",
                    "--align-alternative-alignments",
                    dest="num_alternative_paths", type=int, default=1)
    sp.add_argument("--json", action="store_true")
    sp.add_argument("fnames", nargs="+")

    sp = add("assemble", cmd_assemble)
    sp.add_argument("-i", "--infile-base", default=None)
    sp.add_argument("fnames", nargs="*")
    sp.add_argument("--enumerate", action="store_true",
                    help="number output sequences (always on here)")
    sp.add_argument("-o", "--outfile-base", default="graph")
    sp.add_argument("--unitigs", action="store_true")
    sp.add_argument("--to-gfa", action="store_true")
    sp.add_argument("--compacted", action="store_true")
    sp.add_argument("--min-length", type=int, default=0)
    sp.add_argument("-a", "--annotation", default=None)
    sp.add_argument("--label-mask-in", action="append")
    sp.add_argument("--label-mask-out", action="append")
    sp.add_argument("--label-mask-in-fraction", type=float, default=1.0)
    sp.add_argument("--label-mask-out-fraction", type=float, default=0.0)
    sp.add_argument("--label-other-fraction", type=float, default=1.0)

    sp = add("clean", cmd_clean)
    sp.add_argument("-i", "--infile-base", default=None)
    sp.add_argument("fnames", nargs="*")
    sp.add_argument("-o", "--outfile-base", default="graph")
    sp.add_argument("--min-count", type=int, default=1)
    sp.add_argument("--max-count", type=int, default=None)
    sp.add_argument("--min-count-q", type=float, default=0.0,
                    help="min k-mer abundance quantile")
    sp.add_argument("--max-count-q", type=float, default=1.0,
                    help="max k-mer abundance quantile")
    sp.add_argument("--min-count-auto", action="store_true")
    sp.add_argument("--prune-tips", type=int, default=1)
    sp.add_argument("--prune-unitigs", type=int, default=1)
    sp.add_argument("--fallback", type=int, default=5)
    sp.add_argument("--num-singletons", type=int, default=0,
                    help="override the count-1 bin of the abundance "
                         "histogram for threshold estimation")
    sp.add_argument("--smoothing-window", type=int, default=1)
    sp.add_argument("--count-slice-quantiles", "--count-bins-q",
                    dest="count_slice_quantiles", default="0 1",
                    help="space-separated quantiles; one fasta per "
                         "adjacent pair, binned by k-mer count")
    sp.add_argument("--to-fasta", action="store_true")
    sp.add_argument("--unitigs", action="store_true")
    sp.add_argument("--header", default="",
                    help="prefix for the output sequence headers")

    sp = add("extend", cmd_extend)
    sp.add_argument("-i", "--infile-base", required=True)
    sp.add_argument("-o", "--outfile-base", default=None)
    sp.add_argument("--count-width", type=int, default=8)
    sp.add_argument("fnames", nargs="+")

    sp = add("compare", cmd_compare)
    sp.add_argument("fnames", nargs=2)

    sp = add("transform", cmd_transform)
    sp.add_argument("-i", "--infile-base", default=None)
    sp.add_argument("fnames", nargs="*")
    sp.add_argument("--enumerate", action="store_true",
                    help="number output sequences (always on here)")
    sp.add_argument("-o", "--outfile-base", default="graph")
    sp.add_argument("--to-fasta", action="store_true")
    sp.add_argument("--primary-kmers", action="store_true")
    sp.add_argument("--to-gfa", action="store_true")
    sp.add_argument("--compacted", action="store_true")
    sp.add_argument("--to-adj-list", action="store_true")
    sp.add_argument("--state", choices=["fast", "small"], default=None)
    sp.add_argument("--initialize-bloom", action="store_true")
    sp.add_argument("--bloom-fpp", type=float, default=None)

    sp = add("merge", cmd_merge)
    sp.add_argument("-o", "--outfile-base", default="graph")
    sp.add_argument("fnames", nargs="+")
    sp.add_argument("--num-shards", type=int, default=0,
                    help="merge through the out-of-core finish over this "
                         "many shards")
    sp.add_argument("--state", choices=["fast", "small"], default="fast")

    sp = add("merge_anno", cmd_merge_anno)
    sp.add_argument("-o", "--outfile-base", required=True)
    sp.add_argument("fnames", nargs="+")

    sp = add("transform_anno", cmd_transform_anno)
    sp.add_argument("-o", "--outfile-base", required=True)
    sp.add_argument("-i", "--infile-base", default=None,
                    help="graph (for the row_diff forms)")
    sp.add_argument("--anno-type", default="column",
                    choices=["column", "row", "row_sparse", "flat", "brwt",
                             "bin_rel_wt", "bin_rel_wt_sdsl",
                             "row_diff", "row_diff_sparse", "int_row_diff",
                             "unique_row", "rbfish", "rb_brwt",
                             "row_diff_brwt", "int_brwt",
                             "row_diff_int_brwt", "int_row_diff_brwt",
                             "column_coord", "row_diff_coord",
                             "tuple_row_diff"])
    sp.add_argument("--max-path-length", type=int, default=64)
    # the bottom-up build pairs columns greedily whatever the arity, as in
    # the JAX package: accepted for the reference's command lines
    sp.add_argument("--arity", type=int, default=2)
    sp.add_argument("--relax-arity", type=int, default=2)
    sp.add_argument("--num-rows-subsampled", "--subsample",
                    dest="num_rows_subsampled", type=int, default=1000000)
    sp.add_argument("--disk-swap", default="",
                    help="directory of the out-of-core staged row_diff / "
                         "int_row_diff conversion")
    sp.add_argument("--mem-cap-gb", type=float, default=1.0,
                    help="spill buffer cap of --disk-swap conversions")
    sp.add_argument("--row-diff-stage", type=int, default=2,
                    help="0 / 1: accumulate the staged conversion's "
                         "artifacts; 2: the whole conversion")
    sp.add_argument("--rename-cols", default="",
                    help="file with '<old> <new>' label rename pairs")
    sp.add_argument("--dump-text-anno", action="store_true",
                    help="dump each column as a text file of set row ids")
    sp.add_argument("--linkage", dest="compute_linkage",
                    action="store_true",
                    help="only compute the column linkage file")
    sp.add_argument("--greedy", action="store_true",
                    help="greedy column pairing (the only strategy)")
    sp.add_argument("--linkage-file", default="",
                    help="guide the BRWT tree with this linkage file")
    sp.add_argument("--aggregate-columns", action="store_true")
    sp.add_argument("--min-count", type=int, default=1)
    sp.add_argument("--max-count", type=int, default=None)
    sp.add_argument("--min-fraction", type=float, default=0.0)
    sp.add_argument("--max-fraction", type=float, default=1.0)
    sp.add_argument("--anno-label", default="",
                    help="label of the aggregated column")
    sp.add_argument("fnames", nargs="+")

    sp = add("server_query", cmd_server_query)
    sp.add_argument("-i", "--infile-base", required=True)
    sp.add_argument("-a", "--annotation", required=True)
    sp.add_argument("--port", type=int, default=5555)
    sp.add_argument("--host", default="127.0.0.1")

    sp = add("relax_brwt", cmd_relax_brwt)
    sp.add_argument("-o", "--outfile-base", required=True)
    sp.add_argument("--relax-arity", type=int, default=8)
    sp.add_argument("fnames", nargs="+")
    return p


def main(argv: Optional[Sequence[str]] = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args, unknown = build_parser().parse_known_args(argv)
    if unknown:
        raise SystemExit(f"metagraph {args.command}: "
                         f"{' '.join(unknown)}: not yet ported")
    args.verbose = args.verbose or args.debug
    for attr, flag in _INERT_ATTRS:
        if getattr(args, attr) not in (None, False):
            log(f"WARNING: {flag} is accepted for reference-script "
                f"compatibility but has no effect in this implementation")
    # -v turns the spans on for this command (the JAX CLI leaves them on
    # for the rest of the process); METAGRAPH_TPU_TRACE_DIR traces it
    verbose = telemetry.VERBOSE
    telemetry.VERBOSE = verbose or args.verbose
    try:
        with telemetry.device_trace():
            args.func(args)
    finally:
        telemetry.VERBOSE = verbose


if __name__ == "__main__":
    main()
