"""VCF input of the port against the JAX package.

A VCF written into tmp_path (SNPs, indels, a multi-allelic ALT, a
symbolic ``<DEL>`` allele, a CHROM the reference lacks, variants whose
k-flanks are clipped at the sequence ends) and its ``.vcf.gz``: the
port's ``parse_vcf`` / ``vcf_to_sequences`` yield the JAX package's
sequences, and ``build --reference ref.fa`` through both CLIs gives the
same ``stats`` stdout and graph arrays; a graph file of either package
loads in the other.
"""

import gzip

import numpy as np
import pytest
import torch

from metagraph_tpu.cli.main import main as jmain
from metagraph_tpu.graph.io import load_graph as jload
from metagraph_tpu.seqio.vcf import vcf_to_sequences as jvcf
from metagraph_tpu_torch.cli.main import main as tmain
from metagraph_tpu_torch.graph.io import load_graph
from metagraph_tpu_torch.seqio.vcf import parse_vcf, vcf_to_sequences
from test_torch_graph_cli import run

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def vcf_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vcf")
    rng = np.random.default_rng(7)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    chr1 = bytes(rng.choice(acgt, 400))
    chr2 = bytes(rng.choice(acgt, 150))
    with open(tmp / "ref.fa", "wb") as f:
        f.write(b">chr1 first\n" + chr1 + b"\n>chr2\n" + chr2 + b"\n")

    def alt(seq, pos):                       # a base other than the ref's
        return "ACGT"[("ACGT".index(chr(seq[pos - 1])) + 1) % 4]

    rows = [
        ("chr1", 3, chr(chr1[2]), alt(chr1, 3)),            # left clip
        ("chr1", 50, chr(chr1[49]), alt(chr1, 50)),         # SNP
        ("chr1", 120, chr1[119:122].decode(), chr(chr1[119])),   # deletion
        ("chr1", 200, chr(chr1[199]), chr(chr1[199]) + "GATTACA"),  # ins
        ("chr1", 300, chr(chr1[299]),
         alt(chr1, 300) + "," + chr(chr1[299]) + "TT,<DEL>"),  # multi
        ("chrX", 10, "A", "G"),                              # no such CHROM
        ("chr2", 148, chr(chr2[147]), alt(chr2, 148)),       # right clip
        ("chr2", 70, chr(chr2[69]), "<INS>"),                # symbolic only
    ]
    text = ("##fileformat=VCFv4.2\n##contig=<ID=chr1>\n"
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\n"
            + "".join(f"{c}\t{p}\t.\t{r}\t{a}\t50\tPASS\t.\tGT\t0|1\n"
                      for c, p, r, a in rows))
    (tmp / "v.vcf").write_text(text)
    with gzip.open(tmp / "v.vcf.gz", "wt") as f:
        f.write(text)
    return tmp


@pytest.mark.parametrize("name", ["v.vcf", "v.vcf.gz"])
@pytest.mark.parametrize("k", [5, 11, 31])
def test_vcf_sequences_identical(vcf_dir, name, k):
    ref = str(vcf_dir / "ref.fa")
    got = vcf_to_sequences(str(vcf_dir / name), ref, k)
    assert got == jvcf(str(vcf_dir / name), ref, k)
    assert got == list(parse_vcf(str(vcf_dir / name), ref, k))
    # 1 + 1 + 1 + 1 + 2 (the <DEL> skipped) + 1 alleles; chrX skipped
    assert len(got) == 7
    assert len(got[0]) == 2 + 1 + k                  # clipped left flank


@pytest.mark.parametrize("flags", [["--mode", "basic"],
                                   ["--mode", "canonical"],
                                   ["--mode", "primary"],
                                   ["--count-kmers"],
                                   ["--mode", "canonical", "--count-kmers"]])
@pytest.mark.parametrize("name", ["v.vcf", "v.vcf.gz"])
def test_vcf_build_identical(vcf_dir, name, flags):
    outs = {}
    for pkg, main, extra in (("j", jmain, []),
                             ("t", tmain, ["--device", "cpu"])):
        base = str(vcf_dir / f"{pkg}_{name}_{'_'.join(flags)}")
        _, code = run(main, ["build", "-k", "11", "--reference",
                             str(vcf_dir / "ref.fa"), "-o", base,
                             str(vcf_dir / name)] + flags + extra)
        assert code in (0, None)
        outs[pkg], code = run(main, ["stats", base] + extra)
        assert code in (0, None)
        outs[pkg + "base"] = base
    assert outs["j"] == outs["t"]
    a = load_graph(outs["jbase"], device="cpu")
    b = jload(outs["tbase"])
    np.testing.assert_array_equal(a.boss.W.numpy(), np.asarray(b.boss.W))
    np.testing.assert_array_equal(a.boss.last.numpy(),
                                  np.asarray(b.boss.last))
    if "--count-kmers" in flags:
        np.testing.assert_array_equal(a.boss.weights.numpy(),
                                      np.asarray(b.boss.weights))


def test_vcf_with_fasta_input_identical(vcf_dir):
    """VCF alleles next to a FASTA file in one build."""
    outs = {}
    for pkg, main, extra in (("j", jmain, []),
                             ("t", tmain, ["--device", "cpu"])):
        base = str(vcf_dir / f"{pkg}_mixed")
        run(main, ["build", "-k", "11", "--reference", str(vcf_dir / "ref.fa"),
                   "-o", base, str(vcf_dir / "v.vcf"),
                   str(vcf_dir / "ref.fa")] + extra)
        outs[pkg], _ = run(main, ["stats", base] + extra)
    assert outs["j"] == outs["t"] and "nodes (k)" in outs["t"]


def test_vcf_needs_reference(vcf_dir):
    _, code = run(tmain, ["build", "-k", "11", "-o", str(vcf_dir / "nr"),
                          str(vcf_dir / "v.vcf"), "--device", "cpu"])
    assert code not in (0, None) and "--reference" in str(code)
    with pytest.raises(AssertionError):
        jmain(["build", "-k", "11", "-o", str(vcf_dir / "jnr"),
               str(vcf_dir / "v.vcf")])
