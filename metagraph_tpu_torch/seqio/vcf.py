"""VCF variant expansion (reference: metagraph/src/seq_io/vcf_parser.hpp).

Counterpart of ``metagraph_tpu/seqio/vcf.py``. For each VCF record, each
alternate allele becomes the sequence ``reference[pos-k:pos] + ALT +
reference[pos+len(REF):pos+len(REF)+k]``: the k-flanked window whose
k-mers cover the variant (the reference fetches the same flanks through
htslib's faidx, vcf_parser.cpp:150-175). Flanks are clipped at the
sequence ends; symbolic alleles (``<...>``) and records whose CHROM the
reference lacks are skipped.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

from .fasta import _open_maybe_gz, parse_records


def _load_reference(fasta_path: str) -> Dict[str, bytes]:
    return {rec.name.decode(): rec.seq for rec in parse_records(fasta_path)}


def parse_vcf(vcf_path: str, reference_fasta: str, k: int
              ) -> Iterator[bytes]:
    """One k-flanked sequence per alternate allele (plain or gzipped
    VCF)."""
    ref = _load_reference(reference_fasta)
    with _open_maybe_gz(vcf_path) as handle:
        for raw in handle:
            line = raw.decode().rstrip("\n")
            if not line or line.startswith("#"):
                continue
            cols = line.split("\t")
            chrom, pos, ref_allele, alts = (cols[0], int(cols[1]) - 1,
                                            cols[3], cols[4])
            if chrom not in ref:
                continue
            seq = ref[chrom]
            prefix = seq[max(0, pos - k):pos]
            end = pos + len(ref_allele)
            suffix = seq[end:end + k]
            for alt in alts.split(","):
                if not alt.startswith("<"):
                    yield prefix + alt.encode() + suffix


def vcf_to_sequences(vcf_path: str, reference_fasta: str, k: int
                     ) -> List[bytes]:
    return list(parse_vcf(vcf_path, reference_fasta, k))
