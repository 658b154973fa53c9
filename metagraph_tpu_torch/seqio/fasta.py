"""Host-side FASTA/FastQ reading and writing.

Copied from ``metagraph_tpu/seqio/fasta.py`` (that package imports JAX
at its root, so the port cannot import it). The record parser is pure
Python. ``read_and_encode`` (the single-file ``build``'s read) encodes a
whole file through the native C codec (``native/``) as the JAX package's
does, and falls back to the Python parser and numpy, which give the same
codes, only where the codec returns None (no C compiler on the machine,
or bytes that are neither FASTA nor FastQ); ``last_route`` names the
route the last call took. ``ExtendedFastaWriter`` writes contigs with
a per-k-mer count sidecar (``<base>.kmer_counts.gz``, one line of
space-separated counts per record) and ``iter_weighted_records`` reads
them back, in the JAX package's format.
"""

from __future__ import annotations

import gzip
import os
import queue
import threading
from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np


def _open_maybe_gz(path: str):
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


@dataclass
class SeqRecord:
    name: bytes
    seq: bytes
    qual: Optional[bytes] = None
    comment: bytes = b""


def parse_records(path_or_handle) -> Iterator[SeqRecord]:
    """Parse FASTA or FastQ (auto-detected by leading '>' / '@')."""
    is_path = isinstance(path_or_handle, (str, os.PathLike))
    handle = _open_maybe_gz(path_or_handle) if is_path else path_or_handle
    try:
        first = handle.readline()
        while first and not first.strip():
            first = handle.readline()
        if not first:
            return
        if first.startswith(b">"):
            yield from _parse_fasta(handle, first)
        elif first.startswith(b"@"):
            yield from _parse_fastq(handle, first)
        else:
            raise ValueError("not a FASTA/FastQ stream")
    finally:
        if is_path:
            handle.close()


def _split_header(line: bytes) -> Tuple[bytes, bytes]:
    h = line[1:].strip()
    if b" " in h:
        name, comment = h.split(b" ", 1)
        return name, comment
    return h, b""


def _parse_fasta(handle, first: bytes) -> Iterator[SeqRecord]:
    name, comment = _split_header(first)
    chunks: List[bytes] = []
    for line in handle:
        if line.startswith(b">"):
            yield SeqRecord(name, b"".join(chunks), None, comment)
            name, comment = _split_header(line)
            chunks = []
        else:
            chunks.append(line.strip())
    yield SeqRecord(name, b"".join(chunks), None, comment)


def _parse_fastq(handle, first: bytes) -> Iterator[SeqRecord]:
    line = first
    while line:
        name, comment = _split_header(line)
        seq = handle.readline().strip()
        handle.readline()  # '+'
        qual = handle.readline().strip()
        yield SeqRecord(name, seq, qual, comment)
        line = handle.readline()
        while line and not line.strip():
            line = handle.readline()


def read_sequences(path: str) -> List[bytes]:
    return [r.seq for r in parse_records(path)]


# the route of the last ``read_and_encode`` call: "native codec" or
# "Python parser"
last_route: Optional[str] = None


def read_and_encode(path: str, alphabet) -> np.ndarray:
    """File -> encoded code array with an INVALID separator after each
    record: the native codec in one pass over the file's bytes, else the
    Python parser (see the module note). Sets ``last_route``."""
    global last_route
    from ..kmer.extractor import encode_sequences
    from ..native import fasta_encode_native
    with _open_maybe_gz(path) as f:
        data = f.read()
    res = fasta_encode_native(data, alphabet.encode_table())
    if res is not None:
        last_route = "native codec"
        return res[0]
    last_route = "Python parser"
    return encode_sequences(read_sequences(path), alphabet)


def iter_batches(paths: Sequence[str], batch_bytes: int = 100 << 20
                 ) -> Iterator[List[SeqRecord]]:
    """Yield record batches of ~batch_bytes of sequence."""
    batch: List[SeqRecord] = []
    size = 0
    for path in paths:
        for rec in parse_records(path):
            batch.append(rec)
            size += len(rec.seq)
            if size >= batch_bytes:
                yield batch
                batch, size = [], 0
    if batch:
        yield batch


class BatchFeeder:
    """Background-thread prefetcher: overlap host parsing with device work."""

    _DONE = object()

    def __init__(self, it: Iterable, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None

        def run():
            try:
                for item in it:
                    self._q.put(item)
            except BaseException as e:  # re-raised in the consumer
                self._err = e
            finally:
                self._q.put(self._DONE)

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._DONE:
                self._t.join()
                if self._err is not None:
                    raise self._err
                return
            yield item


# zlib's default level: level 9 (gzip's) takes ~6x as long on sequence
# text for ~2.5 % smaller files; the decompressed bytes are the same
GZIP_LEVEL = 6


class FastaWriter:
    """Plain or gzipped FASTA writer (reference FastaWriter)."""

    def __init__(self, path: str, header: str = "",
                 enumerate_sequences: bool = True,
                 gzip_out: Optional[bool] = None, width: int = 80):
        if gzip_out is None:
            gzip_out = path.endswith(".gz")
        self._f = (gzip.open(path, "wb", compresslevel=GZIP_LEVEL)
                   if gzip_out else open(path, "wb"))
        self._header = header
        self._count = 0
        self._enumerate = enumerate_sequences
        self._width = width

    def write(self, seq: bytes | str, name: Optional[str] = None):
        if isinstance(seq, str):
            seq = seq.encode()
        self._count += 1
        if name is None:
            name = (f"{self._header}{self._count}" if self._enumerate
                    else self._header)
        w = self._width
        self._f.write(b">" + name.encode() + b"\n" + b"".join(
            seq[i:i + w] + b"\n" for i in range(0, len(seq), w)))

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ExtendedFastaWriter(FastaWriter):
    """FASTA writer with a per-k-mer count sidecar: sequences go to
    ``<base>.fasta.gz``, counts to ``<base>.kmer_counts.gz``, one text
    line of space-separated counts per record, in record order."""

    def __init__(self, base: str, k: int, header: str = "",
                 enumerate_sequences: bool = True):
        for suf in (".gz", ".fasta"):
            if base.endswith(suf):
                base = base[:-len(suf)]
        super().__init__(base + ".fasta.gz", header, enumerate_sequences)
        self.k = k
        self._cf = gzip.open(base + ".kmer_counts.gz", "wb",
                             compresslevel=GZIP_LEVEL)

    def write(self, seq, counts=None, name: Optional[str] = None):
        super().write(seq, name)
        n_kmers = len(seq) - self.k + 1
        if counts is None:
            counts = np.ones(n_kmers, np.int64)
        counts = np.asarray(counts)
        if len(counts) != n_kmers:
            raise ValueError(f"{len(counts)} counts for {n_kmers} k-mers")
        self._cf.write(" ".join(map(str, counts.astype(np.int64).tolist()))
                       .encode() + b"\n")

    def close(self):
        super().close()
        self._cf.close()


def kmer_counts_sidecar(path: str) -> Optional[str]:
    """Path of the ``.kmer_counts.gz`` sidecar of a FASTA file, if any."""
    base = path
    for suf in (".gz", ".fasta", ".fa"):
        if base.endswith(suf):
            base = base[:-len(suf)]
    side = base + ".kmer_counts.gz"
    return side if os.path.exists(side) else None


def iter_weighted_records(path: str) -> Iterator[Tuple[SeqRecord, np.ndarray]]:
    """(record, per-k-mer uint32 counts) pairs from a FASTA file and its
    sidecar; numpy parses each count line (the same values, and the same
    errors on out-of-range ones, as converting each token by ``int``)."""
    side = kmer_counts_sidecar(path)
    if side is None:
        raise FileNotFoundError(f"no .kmer_counts.gz sidecar for {path}")
    with gzip.open(side, "rb") as cf:
        for rec, line in zip(parse_records(path), cf):
            yield rec, np.array(line.split(), dtype=np.uint32)
