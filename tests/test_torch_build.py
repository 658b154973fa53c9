"""The port's BOSS construction against the JAX package, bit for bit.

``build_boss`` runs on the same sequences in both packages (the port on
``device="cpu"``, where its kernel wrappers take the plain versions);
W, last, F, NF, weights, edge_lanes and the node count must be identical,
in modes basic and canonical (the finish over boundary candidates) and
primary (the finish over sorts of all real edges).
"""

import numpy as np
import pytest
import torch

from conftest import random_dna
from metagraph_tpu.graph.boss_construct import build_boss as jbuild
from metagraph_tpu.graph.boss_construct import (
    build_boss_from_codes as jbuild_codes)
from metagraph_tpu.kmer.alphabets import DNA
from metagraph_tpu_torch.common import packed as tpk
from metagraph_tpu_torch.graph import boss_construct as tbc
from metagraph_tpu_torch.kmer.alphabets import DNA5 as TDNA5
from metagraph_tpu_torch.seqio.fasta import read_and_encode

torch.set_num_threads(2)


def assert_same_boss(jb, tb, with_weights):
    np.testing.assert_array_equal(tb.W.numpy(), np.asarray(jb.W))
    np.testing.assert_array_equal(tb.last.numpy(), np.asarray(jb.last))
    np.testing.assert_array_equal(tb.F.numpy(), np.asarray(jb.F))
    np.testing.assert_array_equal(tb.NF.numpy(), np.asarray(jb.NF))
    np.testing.assert_array_equal(tpk.lanes_to_numpy(tb.edge_lanes),
                                  np.asarray(jb.edge_lanes))
    assert int(tb.num_nodes()) == int(jb.num_nodes())
    assert tb.num_edges == jb.num_edges
    assert tb.lut_steps == jb.lut_steps
    np.testing.assert_array_equal(tb.lut.numpy(), np.asarray(jb.lut))
    if with_weights:
        np.testing.assert_array_equal(tb.weights.numpy(),
                                      np.asarray(jb.weights))
    else:
        assert tb.weights is None and jb.weights is None


def random_reads(seed):
    rng = np.random.default_rng(seed)
    return [random_dna(rng, int(rng.integers(5, 160))) for _ in range(24)]


@pytest.mark.parametrize("bits_per_count", [0, 8])
@pytest.mark.parametrize("mode", ["basic", "canonical"])
@pytest.mark.parametrize("k", [11, 16, 20, 31])
def test_build_random_dna(k, mode, bits_per_count):
    seqs = random_reads(k)
    seqs.append(seqs[0])                       # duplicate k-mers get counted
    jb = jbuild(seqs, k, mode=mode, bits_per_count=bits_per_count)
    tb = tbc.build_boss(seqs, k, mode=mode, bits_per_count=bits_per_count,
                        device="cpu")
    assert_same_boss(jb, tb, bits_per_count > 0)


@pytest.mark.parametrize("bits_per_count", [0, 8])
@pytest.mark.parametrize("k", [9, 11, 16, 20, 31])
def test_build_primary_random_dna(k, bits_per_count):
    seqs = random_reads(k)
    seqs.append(seqs[1])
    jb = jbuild(seqs, k, mode="primary", bits_per_count=bits_per_count)
    tb = tbc.build_boss(seqs, k, mode="primary",
                        bits_per_count=bits_per_count, device="cpu")
    assert_same_boss(jb, tb, bits_per_count > 0)


ADVERSARIAL = {
    "homopolymer": [b"A" * 80, b"C" * 40],
    "repeated_read": [b"ACGTTGCAAGGCTTACCGATAG"] * 12,
    "shorter_than_k": [b"ACG", b"TTGCA", b"G" * 10, b"ACGTACGTACGTAC"],
    "split_by_N": [b"ACGTNNACGGTTACNGATTACAGATTACANNNNCCGGTTAACCGGTTAACCA"
                   b"N" + b"TGCA" * 9],
    "palindromes": [b"ACGTACGT" * 6, b"AATT" * 12, b"GCGC" * 12],
}


@pytest.mark.parametrize("mode", ["basic", "canonical", "primary"])
@pytest.mark.parametrize("case", sorted(ADVERSARIAL))
def test_build_adversarial(case, mode):
    seqs = ADVERSARIAL[case]
    for k in (11, 20):
        jb = jbuild(seqs, k, mode=mode, bits_per_count=8)
        tb = tbc.build_boss(seqs, k, mode=mode, bits_per_count=8,
                            device="cpu")
        assert_same_boss(jb, tb, True)


def test_build_from_codes_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    fa = tmp_path / "in.fa"
    fa.write_bytes(b"".join(b">r%d\n%s\n" % (i, random_dna(rng, 90))
                            for i in range(12)) + b">lower\nacgtnacgtacgtaa\n")
    codes = read_and_encode(str(fa), tbc.DNA)
    jb = jbuild_codes(codes, 15, DNA, mode="canonical", bits_per_count=4)
    tb = tbc.build_boss_from_codes(codes, 15, mode="canonical",
                                   bits_per_count=4, device="cpu")
    assert_same_boss(jb, tb, True)


def test_build_primary_from_codes_matches_jax(tmp_path):
    rng = np.random.default_rng(6)
    fa = tmp_path / "in.fa"
    fa.write_bytes(b"".join(b">r%d\n%s\n" % (i, random_dna(rng, 70))
                            for i in range(9)) + b">n\nACGTNNACGTAC\n")
    codes = read_and_encode(str(fa), tbc.DNA)
    jb = jbuild_codes(codes, 13, DNA, mode="primary", bits_per_count=6)
    tb = tbc.build_boss_from_codes(codes, 13, mode="primary",
                                   bits_per_count=6, device="cpu")
    assert_same_boss(jb, tb, True)


def test_count_saturation():
    """Counts saturate at emit: 2^bits - 1 for heavily repeated k-mers,
    palindromes doubled first (canonical)."""
    seqs = [b"ACGTACGTAC"] * 40
    jb = jbuild(seqs, 5, mode="canonical", bits_per_count=5)
    tb = tbc.build_boss(seqs, 5, mode="canonical", bits_per_count=5,
                        device="cpu")
    assert_same_boss(jb, tb, True)
    assert int(tb.weights.max()) == 31


def wide_collect(pkg, path):
    """One collect of k = 65 DNA5 (9 lanes) through ``path``: the
    pre-counted one (KMC and count sidecars), a suffix bucket's, or the
    plain one; (lanes as uint32, counts, n) on the host."""
    from metagraph_tpu.graph import boss_construct as jbc
    from metagraph_tpu.kmer.alphabets import DNA5 as JDNA5
    from metagraph_tpu.parallel import sharded_build as jsb
    from metagraph_tpu_torch.parallel import sharded_build as tsb
    rng = np.random.default_rng(65)
    seqs = [bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8), 300,
                             p=[0.24] * 4 + [0.04])) for _ in range(3)]
    chars = rng.integers(1, 6, (200, 65)).astype(np.uint8)
    chars[:20] = chars[20:40]                      # duplicates sum
    counts = rng.integers(1, 9, 200)
    jax_side = pkg == "jax"
    alph = JDNA5 if jax_side else TDNA5
    dev = {} if jax_side else {"device": "cpu"}
    if path == "counted":
        lanes, cnts, n = (jbc if jax_side else tbc).collect_counted_kmers(
            chars, counts, 65, alph, canonical=True, **dev)
    elif path == "suffix":
        lanes, cnts, n = (jsb if jax_side else tsb).build_shard_kmers(
            seqs, 65, (2,), alph, **dev)
    else:
        lanes, cnts, n = (jbc if jax_side else tbc).collect_kmers(
            seqs, 65, alph, **dev)[:3]
    n = int(n)
    lanes = (np.asarray(lanes) if jax_side
             else tpk.lanes_to_numpy(lanes))[:, :n]
    return lanes, np.asarray(cnts)[:n], n


@pytest.mark.parametrize("path", ["counted", "suffix", "plain"])
def test_unported_options_raise(path):
    """Collects past the kernels' 8 lanes (65 chars of 4 bits) were once
    refused; they run in lane groups now and equal the JAX package's."""
    want = wide_collect("jax", path)
    got = wide_collect("port", path)
    assert got[2] == want[2] > 50
    assert want[0].shape[0] == 9
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
