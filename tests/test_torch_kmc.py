"""The port's KMC input path against the JAX package, bit for bit.

A synthetic KMC2 database (written per the format of ``seqio/kmc.py``)
is read by both packages' ``read_kmers`` and built by both packages'
``collect_counted_kmers`` + ``build_boss_from_kmers`` (the port on the
CPU, where its kernels take their plain versions): basic and canonical,
count filters, single- and both-strand databases. Integer data: exact.
"""

import struct

import numpy as np
import pytest
import torch

from metagraph_tpu.graph.boss_construct import (
    build_boss_from_kmers as jbuild_kmers)
from metagraph_tpu.graph.boss_construct import (
    collect_counted_kmers as jcollect)
from metagraph_tpu.seqio.kmc import read_kmers as jread_kmers
from metagraph_tpu_torch.graph import boss_construct as tbc
from metagraph_tpu_torch.seqio.kmc import read_header, read_kmers
from test_torch_build import assert_same_boss

torch.set_num_threads(2)


def write_kmc2(base, kmers: np.ndarray, counts: np.ndarray, k: int, p: int,
               sig_len: int, n_bins: int, both_strands_byte: int = 1):
    """Write a KMC2 .kmc_pre/.kmc_suf pair (the writer of
    ``tests/test_kmc.py``, vectorized). ``kmers``: (n, k) uint8 2-bit
    codes A=0..T=3; records go to bins by their first char (mod n_bins),
    sorted by (bin, k-mer), the KMC2 record order."""
    n = len(kmers)
    bins = kmers[:, 0].astype(np.int64) % n_bins
    order = np.lexsort([kmers[:, j] for j in range(k - 1, -1, -1)] + [bins])
    kmers, counts, bins = kmers[order], counts[order], bins[order]
    prefixes = np.zeros(n, np.int64)
    for j in range(p):
        prefixes = prefixes * 4 + kmers[:, j]
    lut = np.searchsorted(bins * 4 ** p + prefixes,
                          np.arange(n_bins * 4 ** p))
    s_len, counter_size = k - p, 2
    s_bytes = (s_len + 3) // 4
    recs = np.zeros((n, s_bytes + counter_size), np.uint8)
    for j in range(s_len):
        recs[:, j // 4] |= (kmers[:, p + j] << (2 * (3 - j % 4))).astype(
            np.uint8)
    for b in range(counter_size):
        recs[:, s_bytes + b] = (counts >> (8 * b)) & 0xFF
    hdr = struct.pack("<9I", k, 0, counter_size, p, sig_len, 1,
                      1_000_000_000, n, 0)
    hdr += bytes([both_strands_byte])
    hdr += b"\0" * (64 - len(hdr) - 4) + struct.pack("<I", 0x200)
    sig_map = np.zeros(4 ** sig_len + 1, np.uint32)
    with open(base + ".kmc_pre", "wb") as f:
        f.write(b"KMCP" + lut.astype("<u8").tobytes() + sig_map.tobytes()
                + hdr + struct.pack("<I", len(hdr)) + b"KMCP")
    with open(base + ".kmc_suf", "wb") as f:
        f.write(b"KMCS" + recs.tobytes() + b"KMCS")
    return base


def counted_kmers(rng, k, n_codes=3000, canonical=False):
    """Distinct k-mers (2-bit codes) of random reads with their counts;
    ``canonical`` stores each pair's smaller orientation, as a both-strand
    KMC count does."""
    codes = rng.integers(0, 4, n_codes).astype(np.uint8)
    codes[rng.integers(0, n_codes, 40)] = codes[:40]   # some repeats
    win = np.lib.stride_tricks.sliding_window_view(codes, k)
    win = np.concatenate([win, win[:300]])              # counts > 1
    if canonical:
        rc = 3 - win[:, ::-1]
        take = np.array([tuple(r) < tuple(w) for r, w in zip(rc, win)])
        win = np.where(take[:, None], rc, win)
    kmers, counts = np.unique(win, axis=0, return_counts=True)
    return kmers.astype(np.uint8), counts.astype(np.int64)


@pytest.fixture(scope="module", params=[(11, 1), (11, 0), (31, 1), (31, 0)],
                ids=["k11-single", "k11-both", "k31-single", "k31-both"])
def db(request, tmp_path_factory):
    k, strands = request.param
    rng = np.random.default_rng(k + strands)
    kmers, counts = counted_kmers(rng, k, canonical=strands == 0)
    base = str(tmp_path_factory.mktemp("kmc") / "db")
    return write_kmc2(base, kmers, counts, k, 4, 5, 3, strands), k


@pytest.mark.parametrize("min_count,max_count", [(1, None), (2, None),
                                                 (1, 1), (2, 3)])
def test_read_kmers_matches_jax(db, min_count, max_count):
    base, k = db
    got = read_kmers(base + ".kmc_suf", min_count, max_count)
    want = jread_kmers(base + ".kmc_suf", min_count, max_count)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert vars(got[2]) == vars(want[2])
    assert read_header(base + ".kmc_pre").kmer_length == k


@pytest.mark.parametrize("min_count,max_count", [(1, None), (2, None),
                                                 (1, 2)])
@pytest.mark.parametrize("mode", ["basic", "canonical"])
def test_kmc_build_matches_jax(db, mode, min_count, max_count):
    base, k = db
    chars, counts, _ = jread_kmers(base, min_count, max_count)
    canonical = mode == "canonical"
    jl, jc, jn = jcollect(chars, counts, k, canonical=canonical)
    tl, tc, tn = tbc.collect_counted_kmers(chars, counts, k,
                                           canonical=canonical, device="cpu")
    assert tn == jn
    np.testing.assert_array_equal(tl[:, :tn].numpy().view(np.uint32),
                                  np.asarray(jl)[:, :jn])
    np.testing.assert_array_equal(tc[:tn].numpy(), np.asarray(jc)[:jn])
    jb = jbuild_kmers(jl, jc, jn, k, mode=mode, bits_per_count=8)
    tb = tbc.build_boss_from_kmers(tl, tc, tn, k, mode=mode,
                                   bits_per_count=8)
    assert_same_boss(jb, tb, True)


def test_kmc_build_empty_and_huge_counts():
    """No k-mer left after the count filter; counts past 2^31 - 1 clamp."""
    k = 9
    chars = np.ones((0, k), np.uint8)
    counts = np.zeros((0,), np.int64)
    for c, n in ((chars, counts),
                 (np.array([[1, 2, 3, 4, 1, 2, 3, 4, 1]] * 2, np.uint8),
                  np.array([3 << 30, 5], np.int64))):
        jl, jc, jn = jcollect(c, n, k)
        tl, tc, tn = tbc.collect_counted_kmers(c, n, k, device="cpu")
        assert tn == jn
        np.testing.assert_array_equal(tc[:tn].numpy(), np.asarray(jc)[:jn])
        jb = jbuild_kmers(jl, jc, jn, k, bits_per_count=31)
        tb = tbc.build_boss_from_kmers(tl, tc, tn, k, bits_per_count=31)
        assert_same_boss(jb, tb, True)
