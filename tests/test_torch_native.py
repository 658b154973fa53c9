"""The port's native FASTA/FastQ codec against the JAX package's, byte
for byte: codes and record offsets of FASTA, FastQ, \r\n noise and
invalid characters, and the 2-bit block pack."""

import numpy as np
import pytest

from conftest import random_dna
from metagraph_tpu.native import loader as jnative
from metagraph_tpu_torch.kmer.alphabets import DNA, DNA5, PROTEIN
from metagraph_tpu_torch.kmer.extractor import encode_sequences
from metagraph_tpu_torch.native import loader as tnative


@pytest.fixture(autouse=True)
def need_compilers():
    if not tnative.native_available():
        pytest.skip("no C compiler: the native codec is not built")
    if not jnative.native_available():
        pytest.skip("no C compiler: the JAX package's codec is not built")


def records(rng):
    return [random_dna(rng, n) for n in (80, 200, 1, 61)]


def fasta(seqs, eol=b"\n", width=60):
    out = []
    for i, s in enumerate(seqs):
        out.append(b">rec%d comment here" % i + eol)
        out += [s[j:j + width] + eol for j in range(0, len(s), width)]
    return b"".join(out)


def fastq(seqs, eol=b"\n"):
    return b"".join(b"@r%d" % i + eol + s + eol + b"+" + eol
                    + b"I" * len(s) + eol for i, s in enumerate(seqs))


CASES = {
    "fasta": lambda rng: fasta(records(rng)),
    "fastq": lambda rng: fastq(records(rng)),
    "crlf": lambda rng: b"\n\r\n" + fasta(records(rng), eol=b"\r\n",
                                          width=17),
    "fastq_crlf": lambda rng: fastq(records(rng), eol=b"\r\n"),
    "invalid": lambda rng: (b">a\nACGTNNACGT\n>b\nTT-TT x\tGG\n>c\n\n"
                            b">d\nacgt\n"),
    "not_a_file": lambda rng: b"ACGT\n",
    "blank": lambda rng: b" \n\t\n",
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("alphabet", [DNA, DNA5, PROTEIN],
                         ids=lambda a: a.name)
def test_fasta_encode_equals_jax(case, alphabet):
    data = CASES[case](np.random.default_rng(len(case)))
    tbl = alphabet.encode_table()
    got = tnative.fasta_encode_native(data, tbl)
    want = jnative.fasta_encode_native(data, tbl)
    if want is None:
        assert got is None
        return
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_fasta_codes_equal_python_encoder():
    """Without \\r\\n noise the codes equal the Python encoder's."""
    seqs = records(np.random.default_rng(1))
    codes, offsets = tnative.fasta_encode_native(fasta(seqs),
                                                 DNA.encode_table())
    np.testing.assert_array_equal(codes, encode_sequences(seqs, DNA))
    np.testing.assert_array_equal(
        offsets, np.cumsum([0] + [len(s) + 1 for s in seqs[:-1]]))


@pytest.mark.parametrize("max_inval", [0, 3, 100])
def test_pack2_equals_jax(max_inval):
    rng = np.random.default_rng(max_inval)
    codes = rng.integers(1, 5, 16 * 37).astype(np.uint8)
    codes[rng.choice(codes.shape[0], 5, replace=False)] = 255
    codes[7] = 0
    got = tnative.pack2_codes_native(codes, max_inval)
    want = jnative.pack2_codes_native(codes, max_inval)
    if want is None:
        assert got is None
        return
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
