"""KMC k-mer counter database reader.

The port's copy of ``metagraph_tpu/seqio/kmc.py`` (numpy only).
Replaces the reference's KMC-api-based parser
(metagraph/src/seq_io/kmc_parser.hpp). Reads KMC1 and KMC2 databases
(.kmc_pre/.kmc_suf pair) directly and fully vectorized:

  .kmc_pre (KMC1):
             "KMCP" + uint64 LUT[4^prefix_len] (record index of the
             first k-mer with each prefix) + 64-byte header + uint32
             header_offset + "KMCP"
  .kmc_pre (KMC2, version field 0x200):
             "KMCP" + uint64 LUT[num_bins * 4^prefix_len] (per
             signature-mapped bin, concatenated in record order)
             + uint32 signature_map[4^signature_len + 1]
             + header + uint32 header_offset + "KMCP"
  .kmc_suf:  "KMCS" + total_kmers records of
             (suffix_len/4 bytes packed suffix, counter_size counter)

The header's final uint32 is the KMC version (0 = KMC1, 0x200 = KMC2);
KMC2 inserts a ``signature_len`` field after ``lut_prefix_length``.
K-mers use 2-bit codes A=0 C=1 G=2 T=3, most-significant-first; records
are sorted by the full k-mer integer (within each signature bin for
KMC2 — immaterial here, since the build pipeline re-sorts). Decoding
expands LUT prefixes with np.repeat (prefix = LUT bucket mod 4^p) and
unpacks suffix bytes with shifts — no per-k-mer loops. The signature
map is only needed for point lookups, which we never do.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class KmcHeader:
    kmer_length: int
    mode: int
    counter_size: int
    lut_prefix_length: int
    min_count: int
    max_count: int
    total_kmers: int
    both_strands: bool
    version: int = 0             # 0 = KMC1, 0x200 = KMC2
    signature_len: int = 0       # KMC2 only
    num_lut_entries: int = 0     # total uint64 LUT entries stored


def read_header(pre_path: str) -> KmcHeader:
    with open(pre_path, "rb") as f:
        data = f.read()
    if data[:4] != b"KMCP" or data[-4:] != b"KMCP":
        raise ValueError(f"{pre_path}: not a KMC .kmc_pre file")
    hdr_off = struct.unpack("<I", data[-8:-4])[0]
    if hdr_off + 8 > len(data) or hdr_off < 36:
        raise ValueError(f"{pre_path}: malformed KMC header "
                         f"(header_offset {hdr_off}, file {len(data)} B)")
    hdr = data[len(data) - 8 - hdr_off:len(data) - 8]
    version = struct.unpack("<I", hdr[-4:])[0]
    if version == 0x200:  # KMC2: signature_len follows lut_prefix_length
        (k, mode, counter_size, lut_prefix_length, signature_len,
         min_count, max_count, total_lo, total_hi) = \
            struct.unpack("<9I", hdr[:36])
        both_strands = hdr[36] == 0
        sig_map_bytes = ((4 ** signature_len) + 1) * 4
        lut_bytes = len(data) - 4 - sig_map_bytes - hdr_off - 8
        per_bin = (4 ** lut_prefix_length) * 8
        if lut_bytes <= 0 or lut_bytes % per_bin:
            raise ValueError(
                f"{pre_path}: malformed KMC2 layout (LUT area {lut_bytes} B"
                f" is not a multiple of the {per_bin} B per-bin LUT)")
        n_lut = lut_bytes // 8
    else:
        (k, mode, counter_size, lut_prefix_length, min_count, max_count,
         total_lo, total_hi) = struct.unpack("<8I", hdr[:32])
        both_strands = hdr[32] == 0  # 0 = canonical ("both strands")
        signature_len = 0
        n_lut = 4 ** lut_prefix_length
        expected = 4 + n_lut * 8 + hdr_off + 8
        if expected != len(data):
            raise ValueError(
                f"{pre_path}: unrecognized KMC layout (size {len(data)} != "
                f"KMC1 layout {expected}, header version {version:#x})")
    return KmcHeader(k, mode, counter_size, lut_prefix_length, min_count,
                     max_count, total_lo | (total_hi << 32), both_strands,
                     version=version, signature_len=signature_len,
                     num_lut_entries=n_lut)


def read_kmers(
    file_base: str,
    min_count: int = 1,
    max_count: Optional[int] = None,
    call_both_from_canonical: bool = True,
) -> Tuple[np.ndarray, np.ndarray, KmcHeader]:
    """Returns ((n, k) uint8 char codes in OUR sentinel alphabet
    (A=1..T=4), (n,) counts, header). Filters by count bounds; when the
    database stores canonical k-mers, emits each record's reverse
    complement too (reference kmc_parser.cpp:55-60 semantics)."""
    base = file_base
    for suf in (".kmc_pre", ".kmc_suf"):
        if base.endswith(suf):
            base = base[: -len(suf)]
    hdr = read_header(base + ".kmc_pre")
    with open(base + ".kmc_pre", "rb") as f:
        data = f.read()
    n_pref = 4 ** hdr.lut_prefix_length
    # KMC1: one LUT of 4^p entries. KMC2: num_bins LUTs of 4^p entries
    # concatenated in record order; record prefix = bucket mod 4^p.
    lut = np.frombuffer(data, "<u8", count=hdr.num_lut_entries,
                        offset=4).astype(np.int64)
    with open(base + ".kmc_suf", "rb") as f:
        suf_data = f.read()
    if suf_data[:4] != b"KMCS":
        raise ValueError("bad .kmc_suf marker")
    suffix_len = hdr.kmer_length - hdr.lut_prefix_length
    suffix_bytes = (suffix_len + 3) // 4
    rec = suffix_bytes + hdr.counter_size
    n = hdr.total_kmers
    recs = np.frombuffer(suf_data, np.uint8, count=n * rec,
                         offset=4).reshape(n, rec)
    # counts (little-endian, counter_size bytes)
    counts = np.zeros(n, np.int64)
    for b in range(hdr.counter_size):
        counts |= recs[:, suffix_bytes + b].astype(np.int64) << (8 * b)
    # prefix of each record: LUT is the running start index per bucket
    bounds = np.append(lut, n)
    # bucket of record i = index b with bounds[b] <= i < bounds[b+1];
    # the k-mer prefix is the bucket id within its bin's LUT
    buckets = np.repeat(np.arange(len(lut), dtype=np.int64),
                        np.diff(bounds).clip(min=0))[:n]
    prefix_ids = buckets % n_pref
    # decode prefix chars (most significant char first)
    k = hdr.kmer_length
    out = np.empty((n, k), np.uint8)
    for j in range(hdr.lut_prefix_length):
        shift = 2 * (hdr.lut_prefix_length - 1 - j)
        out[:, j] = (prefix_ids >> shift) & 3
    # decode suffix chars from packed bytes (msb-first within byte)
    for j in range(suffix_len):
        byte = j // 4
        shift = 2 * (3 - (j % 4))
        out[:, hdr.lut_prefix_length + j] = \
            (recs[:, byte] >> shift) & 3
    out += 1  # to sentinel alphabet codes A=1..T=4
    sel = counts >= max(min_count, 1)
    if max_count is not None:
        sel &= counts <= max_count
    out, counts = out[sel], counts[sel]
    if call_both_from_canonical and hdr.both_strands:
        rc = (5 - out[:, ::-1])
        not_pal = ~(rc == out).all(axis=1)
        out = np.concatenate([out, rc[not_pal]])
        counts = np.concatenate([counts, counts[not_pal]])
    return out, counts, hdr


def kmc_to_sequences(file_base: str, min_count: int = 1,
                     max_count: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """The k-mers as one code array, each followed by an INVALID
    separator (each k-mer its own sequence, for the extraction path),
    and their counts in that order."""
    from ..kmer.alphabets import INVALID_CODE
    chars, counts, _ = read_kmers(file_base, min_count, max_count)
    n, k = chars.shape
    joined = np.full((n, k + 1), INVALID_CODE, np.uint8)
    joined[:, :k] = chars
    return joined.reshape(-1), counts
