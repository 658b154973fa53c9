"""The ``metagraph`` CLI of the port: build, annotate, query, align and
stats, on basic, canonical and primary DNA graphs.

PyTorch counterpart of ``metagraph_tpu/cli/main.py`` for the subset the
port covers; stdout is byte for byte that of the JAX CLI. Every command
takes ``--device`` (default ``cuda``; ``cpu`` runs the plain versions of
the kernels). Any other subcommand or flag exits non-zero with "not yet
ported".

    python -m metagraph_tpu_torch.cli.main build -k 31 -o graph reads.fa
    python -m metagraph_tpu_torch.cli.main build -k 31 --mode primary -o g reads.fa
    python -m metagraph_tpu_torch.cli.main build -k 31 --min-count 2 -o g db.kmc_pre
    python -m metagraph_tpu_torch.cli.main annotate -i graph --anno-header reads.fa
    python -m metagraph_tpu_torch.cli.main query -i graph -a graph.column.annodbg.npz q.fa
    python -m metagraph_tpu_torch.cli.main align -i graph reads.fa
    python -m metagraph_tpu_torch.cli.main query --align -i graph \
        -a graph.column.annodbg.npz q.fa
    python -m metagraph_tpu_torch.cli.main stats graph
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional, Sequence

import numpy as np

# the JAX CLI's other subcommands
_NOT_PORTED = ("clean", "extend", "merge", "concatenate", "compare",
               "transform", "transform_anno", "relax_brwt", "assemble",
               "merge_anno", "server_query", "coordinate", "coordinator",
               "worker")


def log(msg: str):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def _load_graph(path, device, wrap_primary: bool = True):
    """Load a graph; a primary graph comes wrapped in ``CanonicalDbg``
    unless ``wrap_primary`` is false."""
    from ..graph.io import load_graph
    g = load_graph(path, device=device)
    if wrap_primary and g.mode == "primary":
        from ..graph.canonical import CanonicalDbg
        return CanonicalDbg(base=g)
    return g


def cmd_build(args):
    from ..graph import io as graph_io
    from ..graph.boss_construct import build_boss_from_codes
    from ..graph.dbg_succinct import DbgSuccinct
    from ..kmer.alphabets import DNA
    from ..seqio.fasta import read_and_encode

    if len(args.fnames) != 1:
        raise SystemExit("build: exactly one input file (more is not yet "
                         "ported)")
    bits_per_count = args.count_width if args.count_kmers else 0
    t0 = time.time()
    if args.fnames[0].endswith((".kmc_pre", ".kmc_suf")):
        boss = _build_from_kmc(args, bits_per_count)
    elif args.fnames[0].endswith((".vcf", ".vcf.gz")):
        raise SystemExit("build: VCF input is not yet ported")
    else:
        codes = read_and_encode(args.fnames[0], DNA)
        log(f"Encoded {len(codes) / 1e6:.1f} M chars")
        t0 = time.time()
        boss = build_boss_from_codes(codes, args.k, alphabet=DNA,
                                     mode=args.mode,
                                     bits_per_count=bits_per_count,
                                     device=args.device)
    log(f"Graph construction: {time.time() - t0:.2f} s")
    graph = DbgSuccinct.from_boss(boss, DNA, args.mode)
    log(f"Serialized to {graph_io.save_graph(args.outfile_base, graph)}")


def _build_from_kmc(args, bits_per_count: int):
    """A KMC database's k-mers, count-filtered, as a graph. Canonical and
    primary both build the canonical closure, as the JAX CLI does; the
    graph is then labelled with the requested mode."""
    from ..graph.boss_construct import (build_boss_from_kmers,
                                        collect_counted_kmers)
    from ..seqio.kmc import read_kmers
    chars, counts, hdr = read_kmers(args.fnames[0], min_count=args.min_count,
                                    max_count=args.max_count)
    log(f"KMC database: {len(chars)} k-mers, k={hdr.kmer_length}")
    if args.k != hdr.kmer_length:
        raise SystemExit(f"build: -k {args.k} != KMC k {hdr.kmer_length}")
    mode = "basic" if args.mode == "basic" else "canonical"
    lanes, cnts, n = collect_counted_kmers(
        chars, counts, args.k, canonical=mode == "canonical",
        device=args.device)
    return build_boss_from_kmers(lanes, cnts, n, args.k, mode=mode,
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


def _print_annotation_stats(f, device):
    from ..anno.annotator import Annotation
    ann = Annotation.load(f, device=device)
    log(f"Statistics for annotation '{f}'")
    print("=================== ANNOTATION STATS ===================")
    print(f"labels:  {ann.num_labels}")
    print(f"objects: {ann.matrix.num_rows}")
    density = ann.matrix.nnz / max(ann.matrix.num_rows, 1) \
        / max(ann.num_labels, 1)
    print(f"density: {density:.6g}")
    print("representation: column")
    print("========================================================")


def cmd_stats(args):
    from ..graph.io import index_bytes
    for f in args.fnames:
        if _is_annotation_file(f):
            _print_annotation_stats(f, args.device)
            continue
        g = _load_graph(f, args.device, wrap_primary=False)
        log(f"Statistics for graph '{f}'")
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
        F = boss.F.cpu().numpy()
        fparts = [f"'{letters[i - 1]}': {int(F[i] - F[i - 1])}"
                  for i in range(1, boss.alph_size)]
        fparts.append(f"'{letters[-1]}': {boss.num_edges - int(F[-1])}")
        print("F stats: {" + ", ".join(fparts) + "}")
        suf_chars = (16 // boss.bits_per_char) if boss.lut is not None else 0
        print(f"indexed suffix length: {suf_chars}")
        print("========================================================")


def cmd_annotate(args):
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
                labels.append(rec.name.decode())
            labels.extend(args.anno_label or [])
            items.append((rec.seq, labels))
    ann = annotate_sequences(g, items, with_counts=args.count_kmers).finalize()
    out = args.outfile_base or args.infile_base
    if not out.endswith(".annodbg.npz"):
        out = out + ".column.annodbg.npz"
    ann.save(out)
    log(f"Serialized annotation to {out} "
        f"({ann.num_labels} labels, {ann.matrix.nnz} relations)")


def cmd_query(args):
    from ..anno.annotator import Annotation
    from ..engine.annotated_dbg import AnnotatedDbg, BatchQuery
    from ..graph.canonical import CanonicalDbg
    from ..seqio.fasta import BatchFeeder, iter_batches

    g = _load_graph(args.infile_base, args.device)
    ann = Annotation.load(args.annotation, device=args.device)
    bq = BatchQuery(AnnotatedDbg(graph=g, annotation=ann))
    aligner = None
    if args.align or args.batch_align:
        if isinstance(g, CanonicalDbg):
            raise SystemExit("query --align: primary graphs are not yet "
                             "ported")
        from ..align.aligner import Aligner, AlignerConfig
        aligner = Aligner(g, AlignerConfig(
            min_exact_match=args.align_min_exact_match))
    t0 = time.time()
    n = idx = 0
    out = sys.stdout
    # prefetch: host parsing of the next batch overlaps device work
    for batch in BatchFeeder(iter_batches(args.fnames,
                                          batch_bytes=args.batch_size)):
        if aligner is not None:
            # reference query --align / --batch-align: each read is
            # replaced by its best path spelling (score-only alignment)
            all_res = aligner.align_batch([rec.seq for rec in batch],
                                          with_cigar=False)
            for rec, res in zip(batch, all_res):
                if res:
                    rec.seq = res[0].sequence
        seqs = [r.seq for r in batch]
        if args.count_labels:
            results = bq.get_top_labels_batch(seqs, args.num_top_labels,
                                              args.discovery_fraction)
        else:
            results = bq.get_labels_batch(seqs, args.discovery_fraction)
        for rec, res in zip(batch, results):
            if not res and args.suppress_unlabeled:
                idx += 1
                continue
            head = f"{idx}\t{rec.name.decode()}"
            if args.count_labels:
                out.write("\t".join([head] + [f"<{l}>:{c}" for l, c in res])
                          + "\n")
            else:
                out.write(head + "\t" + args.anno_labels_delimiter.join(res)
                          + "\n")
            idx += 1
            n += 1
    dt = max(time.time() - t0, 1e-9)
    log(f"Queried {n} sequences in {dt:.2f} s ({n / dt:.0f} reads/s)")


def cmd_align(args):
    from ..align.aligner import Aligner, AlignerConfig
    from ..graph.io import load_graph
    from ..seqio.fasta import parse_records

    if args.outfile_base and args.outfile_base.endswith(".gfa"):
        raise SystemExit("align: the GFA path mode (-o *.gfa) is not yet "
                         "ported")
    g = load_graph(args.infile_base, device=args.device)
    if g.mode == "primary":
        raise SystemExit("align: primary graphs are not yet ported")
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
    all_results = aligner.align_batch(
        [r.seq for r in recs], both_strands=args.align_both_strands,
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="metagraph",
                                description="MetaGraph on PyTorch (port)")
    sub = p.add_subparsers(dest="command", required=True)

    def add(name, func):
        sp = sub.add_parser(name)
        sp.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "kernels' plain versions)")
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
    sp.add_argument("-o", "--outfile-base", default="graph")
    sp.add_argument("fnames", nargs="*")

    sp = add("stats", cmd_stats)
    sp.add_argument("fnames", nargs="+")

    sp = add("annotate", cmd_annotate)
    sp.add_argument("-i", "--infile-base", required=True)
    sp.add_argument("-o", "--outfile-base", default=None)
    sp.add_argument("--anno-filename", action="store_true")
    sp.add_argument("--anno-header", action="store_true")
    sp.add_argument("--anno-label", action="append")
    sp.add_argument("--count-kmers", action="store_true")
    sp.add_argument("fnames", nargs="+")

    sp = add("query", cmd_query)
    sp.add_argument("-i", "--infile-base", required=True)
    sp.add_argument("-a", "--annotation", required=True)
    sp.add_argument("--count-labels", action="store_true")
    sp.add_argument("--suppress-unlabeled", action="store_true")
    sp.add_argument("--num-top-labels", type=int, default=2 ** 62)
    sp.add_argument("--discovery-fraction", type=float, default=0.7)
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
    return p


def main(argv: Optional[Sequence[str]] = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in _NOT_PORTED:
        raise SystemExit(f"metagraph: '{argv[0]}' is not yet ported")
    args, unknown = build_parser().parse_known_args(argv)
    if unknown:
        raise SystemExit(f"metagraph {args.command}: "
                         f"{' '.join(unknown)}: not yet ported")
    args.func(args)


if __name__ == "__main__":
    main()
