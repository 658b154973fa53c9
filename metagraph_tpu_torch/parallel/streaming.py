"""Streaming collection: sorted runs spilled to host RAM or disk.

Counterpart of ``metagraph_tpu/parallel/streaming.py``. The reference
bounds memory with SortedSetDisk: fill a buffer, sort, spill chunks to
disk, k-way merge them (sorted_set_disk_base.hpp:34,
elias_fano_merger.hpp:188). Here:

  input chunks -> device collect (extract, sort, unique, count) -> runs
  on the host (RAM, or ``.npy`` files in a swap directory) -> pairwise
  merges of the runs, counts summed -> one finish on the device

Each device pass works on a window of ``chunk_codes`` characters, so the
collect's device memory is bounded whatever the input size. Disk runs
hold DNA at 2 bits a character (``_pack_run``; the order is kept, so
merges compare the compact keys) and merge block by block, so host RAM
stays bounded too. Each block pair merges on the card (``merge_sorted``,
duplicates summed by one ``index_add_``) where the JAX package sorts the
runs' structured view in numpy.
"""

from __future__ import annotations

import os
import tempfile
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import device as devmod
from ..common import merge as pmerge
from ..common import packed
from ..graph.boss import Boss
from ..graph.boss_construct import (MODE_CANONICAL, MODE_PRIMARY, MODE_BASIC,
                                    build_boss_from_kmers, collect_kmers)
from ..kmer.alphabets import Alphabet, DNA, INVALID_CODE
from .outofcore import h_get_field, rec_view


def code_chunks(seqs, alphabet: Alphabet, chunk_codes: int, K: int
                ) -> Iterator[np.ndarray]:
    """The input's codes in windows of at most ``chunk_codes`` characters,
    records separated by one INVALID code; a record that crosses a window
    boundary repeats its last K - 1 characters in the next window, so no
    k-mer is lost at the seam. ``seqs`` yields bytes or code arrays."""
    tbl = alphabet.encode_table()
    buf = np.full(chunk_codes, INVALID_CODE, np.uint8)
    fill = 0
    for s in seqs:
        codes = (s if isinstance(s, np.ndarray)
                 else tbl[np.frombuffer(bytes(s), np.uint8)])
        pos = 0
        while pos < len(codes):
            space = chunk_codes - fill - 1
            if space < K:              # no room for a whole window
                if fill:
                    yield buf[:fill]
                    buf = np.full(chunk_codes, INVALID_CODE, np.uint8)
                fill, space = 0, chunk_codes - 1
            take = min(space, len(codes) - pos)
            buf[fill:fill + take] = codes[pos:pos + take]
            fill += take + 1           # one INVALID separator
            pos += take
            if pos < len(codes):
                pos = max(0, pos - (K - 1))
    if fill:
        yield buf[:fill]


def _repack_bits(K: int, B: int, alph_size: int) -> int:
    """Narrowest spill width: real chars 1..alph_size-1 stored as c - 1 in
    the smallest divisor of 32 bits that holds them (2 for DNA, the
    reference's Elias-Fano spill role, elias_fano.hpp:165); the working
    width when none is narrower."""
    need = max((alph_size - 2).bit_length(), 1)
    for b2 in (1, 2, 4, 8, 16):
        if b2 >= need:
            return b2 if b2 < B else B
    return B


def _pack_run(lanes: np.ndarray, K: int, B: int, B2: int) -> np.ndarray:
    """(L, n) working-form lanes -> (L2, n) compact lanes (c -> c - 1 in
    B2-bit fields); the field order and so the colex order is kept."""
    n = lanes.shape[1]
    L2 = max(-(-K // (32 // B2)), 1)
    out = np.zeros((L2, n), np.uint32)
    for slot in range(K):
        c = (h_get_field(lanes, slot, B) - 1).astype(np.uint32)
        out[L2 - 1 - (slot * B2) // 32] |= c << np.uint32((slot * B2) % 32)
    return out


def _unpack_run(packed_l: np.ndarray, K: int, B: int, B2: int) -> np.ndarray:
    """Inverse of ``_pack_run``: the working-form (L, n) lanes."""
    n = packed_l.shape[1]
    L = packed.num_lanes(K, B)
    out = np.zeros((L, n), np.uint32)
    mask2 = np.uint32((1 << B2) - 1)
    for slot in range(K):
        lane2 = packed_l.shape[0] - 1 - (slot * B2) // 32
        c = ((packed_l[lane2] >> np.uint32((slot * B2) % 32)) & mask2) + 1
        out[L - 1 - (slot * B) // 32] |= (c.astype(np.uint32)
                                          << np.uint32((slot * B) % 32))
    return out


def _merge_block(a: np.ndarray, ac: np.ndarray, b: np.ndarray,
                        bc: np.ndarray, dev) -> Tuple[np.ndarray, np.ndarray]:
    """Two sorted unique blocks merged on the card (``merge_sorted``,
    each entry's position riding along), equal keys' counts summed in
    int64, the group heads compacted (``partition_compact``)."""
    na, nb = a.shape[1], b.shape[1]
    pos = torch.arange(na + nb, dtype=torch.int32, device=dev)
    m, (src,) = pmerge.merge_sorted(packed.lanes_from_numpy(a, dev),
                                    packed.lanes_from_numpy(b, dev),
                                    (pos[:na],), (pos[na:],))
    first = packed.neighbor_ne(m)
    gid = torch.cumsum(first, 0) - 1
    cnt = torch.from_numpy(np.concatenate([ac, bc]).astype(np.int64)).to(dev)
    n_groups = int(gid[-1]) + 1
    agg = torch.zeros((n_groups,), dtype=torch.int64, device=dev).index_add_(
        0, gid, cnt[src.long()])
    heads, _, _ = pmerge.partition_compact(m, first, n_groups)
    return packed.lanes_to_numpy(heads), agg.cpu().numpy()


class DiskChunkStore:
    """Sorted unique (lanes, counts) runs, merged pairwise block by block
    with bounded memory. With a directory the runs are ``.npy`` memmaps
    in a new swap folder under it (the reference's chunk files and k-way
    merger, elias_fano_merger.hpp:188; the OS page cache buffers them);
    without one they stay in host RAM."""

    def __init__(self, directory: Optional[str], L: int):
        self.dir = (tempfile.mkdtemp(prefix="mtg_swap_", dir=directory)
                    if directory is not None else None)
        self.L = L
        self._runs: list = []      # (lanes, counts, n): paths or arrays
        self._seq = 0

    @property
    def num_runs(self) -> int:
        return len(self._runs)

    def _alloc(self, n: int):
        """Output arrays for a merge of at most ``n`` entries."""
        if self.dir is None:
            return (np.empty((self.L, n), np.uint32), np.empty(n, np.int64))
        lp = os.path.join(self.dir, f"run{self._seq}.lanes.npy")
        cp = os.path.join(self.dir, f"run{self._seq}.counts.npy")
        self._seq += 1
        return (np.lib.format.open_memmap(lp, mode="w+", dtype=np.uint32,
                                          shape=(self.L, n)),
                np.lib.format.open_memmap(cp, mode="w+", dtype=np.int64,
                                          shape=(n,)))

    def spill(self, lanes: np.ndarray, counts: np.ndarray):
        """Keep one sorted unique run (written to disk with a directory)."""
        out_l, out_c = self._alloc(lanes.shape[1])
        out_l[:] = lanes
        out_c[:] = counts
        self._runs.append(self._close(out_l, out_c, lanes.shape[1]))

    def _close(self, out_l, out_c, n: int):
        if self.dir is None:
            return out_l, out_c, n
        out_l.flush()
        out_c.flush()
        run = (out_l.filename, out_c.filename, n)
        del out_l, out_c
        return run

    def _load(self, run):
        lanes, counts, n = run
        if self.dir is not None:
            lanes = np.load(lanes, mmap_mode="r")
            counts = np.load(counts, mmap_mode="r")
        return lanes[:, :n], counts[:n]

    def _drop(self, run):
        if self.dir is not None:
            os.remove(run[0])
            os.remove(run[1])

    def merge_all(self, device, block: int = 1 << 22
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Cascaded pairwise merges, each block pair on ``device``
        (``_merge_block``); the final (lanes, counts)."""
        while len(self._runs) > 1:
            nxt = []
            for i in range(0, len(self._runs) - 1, 2):
                nxt.append(self._merge_two(self._runs[i], self._runs[i + 1],
                                           block, device))
                self._drop(self._runs[i])
                self._drop(self._runs[i + 1])
            if len(self._runs) % 2:
                nxt.append(self._runs[-1])
            self._runs = nxt
        if not self._runs:
            return np.zeros((self.L, 0), np.uint32), np.zeros((0,), np.int64)
        return self._load(self._runs[0])

    def _merge_two(self, ra, rb, block: int, device):
        """Merge two runs a block of each at a time. A key is emitted once
        every copy of it is loaded: below the block tail of each run that
        has entries past its block (all of a run whose block reaches its
        end); a round that can emit nothing widens the blocks."""
        a_l, a_c = self._load(ra)
        b_l, b_c = self._load(rb)
        na, nb = a_l.shape[1], b_l.shape[1]
        out_l, out_c = self._alloc(na + nb)
        i = j = w = 0
        while i < na or j < nb:
            ab, bb = np.asarray(a_l[:, i:i + block]), np.asarray(
                b_l[:, j:j + block])
            tails = [rec_view(x[:, -1:])[0] for x, end, n in
                     ((ab, i + block, na), (bb, j + block, nb))
                     if end < n]
            if tails:
                bound = np.array([min(tuple(t) for t in tails)],
                                 dtype=tails[0].dtype)
                ta = int(np.searchsorted(rec_view(ab), bound)[0])
                tb = int(np.searchsorted(rec_view(bb), bound)[0])
            else:
                ta, tb = ab.shape[1], bb.shape[1]
            if ta == 0 and tb == 0:
                block *= 2
                continue
            u, agg = _merge_block(ab[:, :ta], np.asarray(a_c[i:i + ta]),
                                  bb[:, :tb], np.asarray(b_c[j:j + tb]),
                                  device)
            out_l[:, w:w + u.shape[1]] = u
            out_c[w:w + u.shape[1]] = agg
            w += u.shape[1]
            i += ta
            j += tb
        del a_l, a_c, b_l, b_c
        return self._close(out_l, out_c, w)


def collect_kmers_streaming(seqs: Sequence[bytes], K: int,
                            alphabet: Alphabet = DNA, canonical: bool = False,
                            chunk_codes: int = 1 << 22,
                            disk_dir: Optional[str] = None, device="cuda"
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """The sorted unique k-mers and their counts of an input of any size,
    collected ``chunk_codes`` characters at a time on the device; returns
    host arrays (lanes (L, n) uint32, counts (n,) int64). With
    ``disk_dir`` the runs spill to files there (``--disk-swap``)."""
    dev = devmod.resolve(device)
    B = alphabet.bits_per_char
    L = packed.num_lanes(K, B)
    B2 = _repack_bits(K, B, alphabet.size) if disk_dir else B
    L2 = max(-(-K // (32 // B2)), 1) if B2 < B else L
    store = DiskChunkStore(disk_dir, L2)
    for codes in code_chunks(seqs, alphabet, chunk_codes, K):
        ulanes, ucounts, n, _ = collect_kmers(
            (), K, alphabet, canonical=canonical, extra_codes=codes,
            device=dev, with_bounds=False)
        run = packed.lanes_to_numpy(ulanes[:, :n])
        counts = ucounts[:n].cpu().numpy().astype(np.int64)
        if B2 < B:
            run = _pack_run(run, K, B, B2)
        store.spill(run, counts)
    lanes, counts = store.merge_all(dev)
    if B2 < B:
        lanes = _unpack_run(np.asarray(lanes), K, B, B2)
    return lanes, counts


def build_boss_streaming(seqs: Sequence[bytes], k: int,
                         alphabet: Alphabet = DNA, mode: str = MODE_BASIC,
                         bits_per_count: int = 0, chunk_codes: int = 1 << 22,
                         disk_dir: Optional[str] = None, device="cuda"
                         ) -> Boss:
    """The whole build with a streamed collect (``disk_dir``: the on-disk
    run tier, ``--disk-swap``), then one finish on the device. Primary
    mode collects canonical forms and builds the basic graph of them."""
    dev = devmod.resolve(device)
    canonical = mode in (MODE_CANONICAL, MODE_PRIMARY)
    lanes_np, counts_np = collect_kmers_streaming(
        seqs, k, alphabet, canonical=canonical, chunk_codes=chunk_codes,
        disk_dir=disk_dir, device=dev)
    n = lanes_np.shape[1]
    lanes = packed.lanes_from_numpy(np.asarray(lanes_np), dev)
    counts = torch.from_numpy(np.minimum(np.asarray(counts_np), (1 << 31) - 1)
                              .astype(np.int32)).to(dev)
    if n == 0:                      # one PAD column, as collect_kmers has
        lanes = packed.full_pad(1, lanes.shape[0], dev)
        counts = torch.zeros((1,), dtype=torch.int32, device=dev)
    return build_boss_from_kmers(
        lanes, counts, n, k, alphabet,
        mode=MODE_CANONICAL if mode == MODE_CANONICAL else MODE_BASIC,
        bits_per_count=bits_per_count)
