"""Suffix-sharded BOSS construction.

Counterpart of ``metagraph_tpu/parallel/sharded_build.py``. The
reference bounds build memory by partitioning the k-mer space on a node
suffix of length s and running sigma^s passes, each emitting a chunk that
is later concatenated (cli/build.cpp:103-155, 359-456;
kmer_extractor.hpp:89). Suffix buckets are contiguous ranges of the BOSS
sort order (the suffix characters are the most significant compare
fields), so per-bucket sorted unique k-mer sets concatenate, in bucket
colex order, into the globally sorted set. Each pass filters its bucket's
windows with the partition kernel (``extract_packed_kmers(suffix=)``)
before it sorts, so a pass sorts about 1/sigma^s of the windows.

A canonical (or primary) bucket holds the canonical forms of the windows
whose forward node suffix matches, which need not match the suffix
themselves: the JAX package concatenates such buckets as if they were
sorted and disjoint, which holds on its CPU fallback's sorting merge
unless a k-mer's two orientations fall in two buckets. Here the union of
canonical buckets is sorted and deduplicated (``_sort_unique_stage``,
counts summed), so the graph equals the single-shard build; and primary
mode builds the primary graph, where the JAX package builds the
canonical closure (ROADMAP §3.5).
"""

from __future__ import annotations

import itertools
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import device as devmod
from ..common import packed
from ..graph.boss import Boss
from ..graph.boss_construct import (MODE_BASIC, MODE_CANONICAL, MODE_PRIMARY,
                                    _sort_unique_stage, build_boss_from_kmers,
                                    collect_kmers)
from ..kmer.alphabets import ALPHABETS, Alphabet, DNA


def suffix_buckets(alphabet: Alphabet, suffix_len: int
                   ) -> List[Tuple[int, ...]]:
    """Every real-character suffix of the given length in colex order
    (last character first), the BOSS compare order, so that the buckets
    concatenate sorted."""
    combos = list(itertools.product(range(1, alphabet.size),
                                    repeat=suffix_len))
    combos.sort(key=lambda t: tuple(reversed(t)))
    return combos


def bucket_name(alphabet: Alphabet, suffix: Tuple[int, ...]) -> str:
    """A bucket's file-name part: its letters, '$' written as 'S'."""
    return "".join(alphabet.letters[c] for c in suffix).replace("$", "S")


def build_shard_kmers(seqs: Sequence[bytes], K: int, suffix: Tuple[int, ...],
                      alphabet: Alphabet = DNA, canonical: bool = False,
                      device="cuda"):
    """The sorted unique k-mers of one suffix bucket and their counts:
    (lanes (L, n), counts (n,), n)."""
    real, counts, n, _ = collect_kmers(seqs, K, alphabet, canonical=canonical,
                                       device=device, with_bounds=False,
                                       suffix=suffix)
    return real[:, :n], counts[:n], n


def input_fingerprint(seqs: Sequence[bytes], k: int, canonical: bool) -> int:
    """The JAX package's cheap input stamp: a resumed build folds in only
    chunks of the same input count and length, k and mode."""
    return ((len(seqs) * 1000003 + sum(len(s) for s in seqs)) % (1 << 62)
            ^ (k << 8) ^ int(canonical))


def save_chunk(path: str, lanes, counts, K: int, alphabet_name: str,
               suffix: Tuple[int, ...], canonical: bool = False,
               input_fp: int = 0):
    """A ``.chunk.npz`` with the JAX package's keys (uint32 lanes, int32
    counts), so either package loads the other's chunks."""
    lanes_np = (packed.lanes_to_numpy(lanes) if isinstance(lanes, torch.Tensor)
                else np.asarray(lanes, np.uint32))
    counts_np = (counts.cpu().numpy() if isinstance(counts, torch.Tensor)
                 else np.asarray(counts)).astype(np.int32)
    np.savez_compressed(path, lanes=lanes_np, counts=counts_np, k=np.array(K),
                        alphabet=np.array(alphabet_name),
                        suffix=np.array(suffix),
                        canonical=np.array(int(canonical)),
                        input_fp=np.array(int(input_fp)))


def load_chunk(path: str, device):
    """(lanes (L, n), counts (n,), metadata: k, alphabet, input_fp) of a
    chunk file; its valid entries are the prefix with counts > 0."""
    with np.load(path) as d:
        counts = d["counts"]
        n = int((counts > 0).sum())
        meta = {key: d[key] for key in ("k", "alphabet", "input_fp")
                if key in d}
        lanes = packed.lanes_from_numpy(d["lanes"][:, :n], device)
        cnts = torch.from_numpy(counts[:n].astype(np.int32)).to(device)
    return lanes, cnts, meta


def _finish(parts, cparts, K: int, alphabet: Alphabet, mode: str,
            bits_per_count: int, device) -> Boss:
    """The buckets' union as one graph: basic buckets concatenate sorted;
    canonical and primary ones are sorted and deduplicated first."""
    L = packed.num_lanes(K, alphabet.bits_per_char)
    real = (torch.cat(parts, dim=1) if parts
            else packed.full_pad(0, L, device))
    counts = (torch.cat(cparts) if cparts
              else torch.zeros((0,), dtype=torch.int32, device=device))
    total = int(real.shape[1])
    if mode != MODE_BASIC:
        if total:
            real, counts, n = _sort_unique_stage(real, counts, total)
            total = int(n)
            real, counts = real[:, :total], counts[:total]
    if total == 0:                  # one PAD column, as collect_kmers has
        real = packed.full_pad(1, L, device)
        counts = torch.zeros((1,), dtype=torch.int32, device=device)
    return build_boss_from_kmers(
        real, counts, total, K, alphabet,
        mode=MODE_CANONICAL if mode == MODE_CANONICAL else MODE_BASIC,
        bits_per_count=bits_per_count)


def build_boss_sharded(seqs: Sequence[bytes], k: int,
                       alphabet: Alphabet = DNA, mode: str = MODE_BASIC,
                       bits_per_count: int = 0, suffix_len: int = 1,
                       chunk_dir: Optional[str] = None,
                       device="cuda") -> Boss:
    """sigma^suffix_len passes over the input, each keeping only its
    bucket's k-mers, so a pass's working set shrinks by about
    sigma^suffix_len; the buckets' union then goes through one finish.
    With ``chunk_dir`` each pass writes its chunk file, and a chunk there
    of the same input fingerprint, k and alphabet is read back instead of
    recomputed (a resumed build)."""
    dev = devmod.resolve(device)
    canonical = mode in (MODE_CANONICAL, MODE_PRIMARY)
    input_fp = input_fingerprint(seqs, k, canonical)
    parts, cparts = [], []
    for suffix in suffix_buckets(alphabet, suffix_len):
        path = None
        if chunk_dir:
            os.makedirs(chunk_dir, exist_ok=True)
            path = os.path.join(chunk_dir,
                                f"chunk_{bucket_name(alphabet, suffix)}.npz")
            if os.path.exists(path):
                lanes, counts, meta = load_chunk(path, dev)
                if (int(meta["k"]) == k
                        and str(meta["alphabet"]) == alphabet.name
                        and "input_fp" in meta
                        and int(meta["input_fp"]) == input_fp):
                    parts.append(lanes)
                    cparts.append(counts)
                    continue
        lanes, counts, _ = build_shard_kmers(seqs, k, suffix, alphabet,
                                             canonical=canonical, device=dev)
        if path:
            save_chunk(path, lanes, counts, k, alphabet.name, suffix,
                       canonical=canonical, input_fp=input_fp)
        parts.append(lanes)
        cparts.append(counts)
    return _finish(parts, cparts, k, alphabet, mode, bits_per_count, dev)


def concatenate_chunks(chunk_files: Sequence[str], outfile_base: str,
                       mode: str = MODE_BASIC, bits_per_count: int = 0,
                       device="cuda") -> str:
    """Build the graph of per-suffix chunk files (reference
    ``concatenate``, build.cpp:359-456), passed in bucket colex order
    (``suffix_buckets``), and save it; returns the graph file's path."""
    from ..graph import io as graph_io
    from ..graph.dbg_succinct import DbgSuccinct
    dev = devmod.resolve(device)
    parts, cparts = [], []
    K, alphabet = None, DNA
    for f in chunk_files:
        lanes, counts, meta = load_chunk(f, dev)
        parts.append(lanes)
        cparts.append(counts)
        if "k" in meta:
            K = int(meta["k"])
            alphabet = ALPHABETS[str(meta["alphabet"])]
    if K is None:
        raise ValueError("concatenate: no chunk carries k (metadata missing "
                         "or no chunk files)")
    boss = _finish(parts, cparts, K, alphabet, mode, bits_per_count, dev)
    return graph_io.save_graph(outfile_base,
                               DbgSuccinct.from_boss(boss, alphabet, mode))
