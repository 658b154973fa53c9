"""Host-side FASTA/FastQ reading.

Copied from ``metagraph_tpu/seqio/fasta.py`` (that package imports JAX
at its root, so the port cannot import it). The parser is pure Python;
the JAX package's C codec (``native/fasta_codec.c``) is not ported yet,
so ``read_and_encode`` parses in Python and encodes with numpy — the
same codes the codec gives.
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


def read_and_encode(path: str, alphabet) -> np.ndarray:
    """File -> encoded code array with INVALID separators."""
    from ..kmer.extractor import encode_sequences
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
