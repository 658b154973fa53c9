"""The port's builds over the DNA5, DNACaseSent and Protein alphabets
against the JAX package's, on the CPU.

Each alphabet in every mode it allows (Protein has no complement, so it
builds basic graphs only) at small k and at the full-lane k (31 chars of
4 bits in four lanes, of 8 bits in eight): the ``Boss`` arrays ``W``,
``last``, ``F``, ``weights`` and ``edge_lanes`` bit for bit; count
sidecars over each alphabet; the CLI flows ``build``, ``stats``,
``annotate``, ``query`` and ``align`` byte for byte, each package's
``.dbg.npz`` loading in the other (the JAX package's
``tests/test_cli.py`` DNA5 and Protein flows among them); builds past
the kernels' 8 lanes (lane groups), through the API and the CLI; and the
primary finish of
DNACaseSent, whose ``g`` and ``t`` codes set their field's top bit,
against a numpy gold at the k where node keys fill their lanes.
"""

import numpy as np
import pytest
import torch

from metagraph_tpu.cli.main import main as jmain
from metagraph_tpu.graph.boss_construct import build_boss as jbuild
from metagraph_tpu.kmer.alphabets import ALPHABETS as JALPH
from metagraph_tpu.seqio.fasta import ExtendedFastaWriter
from metagraph_tpu_torch.cli.main import main as tmain
from metagraph_tpu_torch.common import packed
from metagraph_tpu_torch.graph import boss_construct as tbc
from metagraph_tpu_torch.kmer import packing
from metagraph_tpu_torch.kmer.alphabets import ALPHABETS

torch.set_num_threads(2)

PROTEIN_LETTERS = b"ACDEFGHIKLMNPQRSTVWY"


def records(rng, name: str, n: int, length: int) -> list:
    """Random records over an alphabet's letters: Protein's twenty amino
    acids; DNA5 with N one base in twenty; DNACaseSent in runs of upper
    and lower case (N and n among them), so that k = 31 windows exist."""
    if name == "Protein":
        return [bytes(rng.choice(np.frombuffer(PROTEIN_LETTERS, np.uint8),
                                 length)) for _ in range(n)]
    out = []
    for _ in range(n):
        s = rng.choice(np.frombuffer(b"ACGT", np.uint8), length)
        s[rng.random(length) < 0.05] = ord("N")
        if name == "DNACaseSent":
            run = np.cumsum(rng.random(length) < 0.05) % 2 == 1
            s = np.where(run, s | 0x20, s)       # lower case
        out.append(bytes(s.astype(np.uint8)))
    return out


def same_boss(tb, jb, what):
    for name in ("W", "last", "F", "weights"):
        want, got = getattr(jb, name), getattr(tb, name)
        if want is None:
            assert got is None, (what, name)
            continue
        np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want),
                                      err_msg=f"{what} {name}")
    np.testing.assert_array_equal(packed.lanes_to_numpy(tb.edge_lanes),
                                  np.asarray(jb.edge_lanes),
                                  err_msg=f"{what} edge_lanes")


CASES = [(a, m, k) for a in ("DNA5", "DNACaseSent")
         for m in ("basic", "canonical", "primary") for k in (7, 31)]
CASES += [("Protein", "basic", 3), ("Protein", "basic", 31),
          ("Protein", "basic", 32), ("DNA", "basic", 64)]


@pytest.mark.parametrize("name,mode,k", CASES)
def test_boss_identical(name, mode, k):
    rng = np.random.default_rng(k * 7 + len(name) + len(mode))
    seqs = records(rng, name, 4, 160) if name != "DNA" else [
        bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 160))
        for _ in range(3)]
    bits = 8 if k == 7 else 0
    want = jbuild(seqs, k, JALPH[name], mode, bits_per_count=bits)
    got = tbc.build_boss(seqs, k, ALPHABETS[name], mode, bits_per_count=bits,
                         device="cpu")
    assert got.num_edges > 1
    same_boss(got, want, f"{name} {mode} k={k}")


@pytest.mark.parametrize("name,mode,k", [
    ("DNA", "canonical", 65), ("DNA5", "basic", 80), ("Protein", "basic", 48),
    ("DNA", "primary", 65)])
def test_past_eight_lanes_refused(name, mode, k, tmp_path):
    """Builds past the kernels' 8 lanes were once refused; they run in
    lane groups now (9, 10, 12 and 9 lanes here) and equal the JAX
    package's, through the API and through the CLI."""
    from metagraph_tpu_torch.graph.io import load_graph
    alphabet = ALPHABETS[name]
    assert packed.num_lanes(k, alphabet.bits_per_char) > 8
    rng = np.random.default_rng(k + len(name))
    seqs = records(rng, name, 3, 300) if name != "DNA" else [
        bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 300))
        for _ in range(3)]
    want = jbuild(seqs, k, JALPH[name], mode, bits_per_count=8)
    got = tbc.build_boss(seqs, k, alphabet, mode, bits_per_count=8,
                         device="cpu")
    assert got.num_edges > 600
    same_boss(got, want, f"{name} {mode} k={k}")
    fa = tmp_path / "in.fa"
    fa.write_bytes(b"".join(b">r%d\n%s\n" % (i, s)
                            for i, s in enumerate(seqs)))
    tmain(["build", "-k", str(k), "--alphabet", name, "--mode", mode,
           "--count-kmers", "-o", str(tmp_path / "g"), str(fa),
           "--device", "cpu"])
    same_boss(load_graph(str(tmp_path / "g"), device="cpu").boss, want,
              f"CLI {name} {mode} k={k}")


def test_collect_bbit_extract_and_bounds():
    """The B-bit collect: extract_packed_kmers compacts the valid windows
    in order, and the boundary candidates are the node keys of each
    valid run's last window's successor and of its first window."""
    from metagraph_tpu_torch.kmer.extractor import (encode_sequences,
                                                    extract_packed_kmers)
    rng = np.random.default_rng(3)
    alph = ALPHABETS["Protein"]
    seqs = records(rng, "Protein", 3, 40) + [b"ACDX*EFGHIK"]
    K = 5
    codes_np = encode_sequences(seqs, alph)
    codes = torch.from_numpy(codes_np)
    lanes, count = extract_packed_kmers(codes, K, 8)
    win = np.lib.stride_tricks.sliding_window_view(codes_np, K)
    ok = ((win != 255) & (win != 0)).all(axis=1)
    assert int(count) == ok.sum()
    want = packing.pack_from_chars(torch.from_numpy(win[ok].copy()), K, 8)
    assert torch.equal(lanes[:, :int(count)], want)
    assert bool(packed.top_bit_set(lanes[0, int(count):]).all())
    inval = np.flatnonzero((codes_np == 255) | (codes_np == 0))
    end_pos, start_pos = (p.numpy() for p in tbc.boundary_windows(
        torch.from_numpy(inval), len(codes_np), K))
    _, _, n_u, (sink_c, src_c) = tbc.collect_kmers(seqs, K, alph,
                                                   device="cpu")
    assert n_u == len({w.tobytes() for w in win[ok]})
    ends = packing.pack_from_chars(torch.from_numpy(win[end_pos].copy()),
                                   K, 8)
    assert torch.equal(sink_c, packing.node_key(
        packing.to_next(ends, K, 8, 0), 8))
    starts = packing.pack_from_chars(torch.from_numpy(win[start_pos].copy()),
                                     K, 8)
    assert torch.equal(src_c, packing.node_key(starts, 8))


def _key(e):
    """BOSS order of an edge (e_1..e_K): source node colex, then label."""
    return tuple(e[-2::-1]) + (e[-1],)


@pytest.mark.parametrize("k", [7, 8, 9])
def test_case_sent_primary_top_field_gold(k):
    """DNACaseSent's g and t (codes 8, 9) set their 4-bit field's top bit.
    At k = 8 the edge k-mers fill two lanes and the node keys of the
    finish without probes (primary mode: ``_sink_candidates``,
    ``_source_candidates``) hold such a field right below the one-bit tag
    shift; at k = 9 the node keys fill two lanes themselves. The real
    edges, dummy sinks and dummy-1 sources must equal a numpy gold, and
    the JAX package's build."""
    rng = np.random.default_rng(40 + k)
    # runs rich in g and t, so nodes end in them
    seqs = [bytes(rng.choice(np.frombuffer(b"gtgtacGTAC", np.uint8), 90))
            for _ in range(4)]
    name = "DNACaseSent"
    alph = ALPHABETS[name]
    got = tbc.build_boss(seqs, k, alph, "primary", device="cpu")
    same_boss(got, jbuild(seqs, k, JALPH[name], "primary"),
              f"primary k={k}")
    tbl = alph.encode_table()
    comp = alph.complement
    real = set()
    for s in seqs:
        cs = tbl[np.frombuffer(s, np.uint8)]
        for i in range(len(cs) - k + 1):
            e = tuple(int(c) for c in cs[i:i + k])
            rc = tuple(comp[c] for c in e[::-1])
            real.add(min(e, rc, key=_key))
    assert any(e[-2] in (8, 9) for e in real)
    rows = packing.unpack_to_chars(got.edge_lanes, k, 4).numpy()
    rows = [tuple(int(c) for c in r) for r in rows]
    assert [_key(r) for r in rows] == sorted(_key(r) for r in rows)
    assert {r for r in rows if 0 not in r} == real
    nodes = {e[:-1] for e in real}
    targets = {e[1:] for e in real}
    sinks = {t + (0,) for t in targets - nodes}
    assert {r for r in rows if r[-1] == 0 and r[0] != 0} == sinks
    src1 = {(0,) + s[:-1] + (s[-1],) for s in nodes - targets}
    assert {r for r in rows if r[0] == 0 and r[1] != 0} == src1


def run(capsys, main, argv):
    capsys.readouterr()
    code = 0
    try:
        main(argv)
    except SystemExit as e:
        code = e.code
    return capsys.readouterr().out, code


def both(capsys, tmp, argv):
    """``argv`` through both CLIs ('@' stands for each package's file
    prefix); stdout and exit codes must be equal. Returns the stdout."""
    want = run(capsys, jmain, [a.replace("@", str(tmp / "j")) for a in argv])
    got = run(capsys, tmain, [a.replace("@", str(tmp / "t")) for a in argv]
              + ["--device", "cpu"])
    assert got == want, argv
    assert want[1] in (0, None), argv
    return want[0]


def write_fasta(path, seqs, names=None):
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b">%s\n%s\n" % ((names[i] if names else "seq%d" % i)
                                    .encode(), s))


def test_build_dna5_flow(tmp_path, capsys):
    """The JAX package's tests/test_cli.py DNA5 flow: N-holding 5-mers
    are real nodes."""
    rng = np.random.default_rng(9)
    s = b"ACGTNNACGTACGTN" + bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8),
                                              200))
    write_fasta(tmp_path / "n5.fa", [s])
    both(capsys, tmp_path, ["build", "-k", "5", "--alphabet", "DNA5", "-o",
                            "@g5", str(tmp_path / "n5.fa")])
    out = both(capsys, tmp_path, ["stats", "@g5"])
    nodes = int(out.splitlines()[2].split(": ")[1])
    assert nodes == len({s[i:i + 5] for i in range(len(s) - 4)})


FLOWS = [("Protein", "basic", 7), ("Protein", "basic", 31),
         ("DNA5", "canonical", 11), ("DNA5", "primary", 11),
         ("DNACaseSent", "basic", 9), ("DNACaseSent", "primary", 13)]


@pytest.mark.parametrize("name,mode,k", FLOWS)
def test_cli_flow_identical(tmp_path, capsys, name, mode, k):
    """build, stats (--validate --count-dummy), annotate, query (labels,
    counts, --align) and align (TSV and --map), as in the JAX package's
    tests/test_cli.py Protein flow: queried and aligned reads are
    fragments of the records (with one substitution in some), so each
    has a full-k seed."""
    rng = np.random.default_rng(k + len(name))
    seqs = records(rng, name, 4, 90)
    write_fasta(tmp_path / "in.fa", seqs)
    reads, names = [], []
    for i, s in enumerate(seqs):
        r = bytearray(s[10:70])
        if i % 2:
            r[55] = ord("W") if name == "Protein" else ord("A")
        reads.append(bytes(r))
        names.append(f"r{i}")
    write_fasta(tmp_path / "q.fa", reads, names)
    g = "@g"
    both(capsys, tmp_path, ["build", "-k", str(k), "--alphabet", name,
                            "--mode", mode, "-o", g, str(tmp_path / "in.fa")])
    out = both(capsys, tmp_path, ["stats", "--validate", "--count-dummy", g])
    assert "validation: OK" in out and f"mode: {mode}" in out
    # the .dbg.npz files cross-load both ways
    jfile, tfile = str(tmp_path / "jg"), str(tmp_path / "tg")
    assert run(capsys, jmain, ["stats", tfile])[0] == \
        run(capsys, jmain, ["stats", jfile])[0]
    assert run(capsys, tmain, ["stats", jfile, "--device", "cpu"])[0] == \
        run(capsys, tmain, ["stats", tfile, "--device", "cpu"])[0]
    both(capsys, tmp_path, ["annotate", "-i", g, "-o", g, "--anno-header",
                            str(tmp_path / "in.fa")])
    anno = g + ".column.annodbg.npz"
    out = both(capsys, tmp_path, ["query", "-i", g, "-a", anno,
                                  "--discovery-fraction", "0.5",
                                  str(tmp_path / "q.fa")])
    assert out.count("\n") == len(reads)
    both(capsys, tmp_path, ["query", "--count-labels", "-i", g, "-a", anno,
                            str(tmp_path / "q.fa")])
    both(capsys, tmp_path, ["query", "--align", "-i", g, "-a", anno,
                            str(tmp_path / "q.fa")])
    out = both(capsys, tmp_path, ["align", "-i", g, str(tmp_path / "q.fa")])
    assert "\t+\t" in out
    both(capsys, tmp_path, ["align", "--map", "--count-kmers", "-i", g,
                            str(tmp_path / "q.fa")])


@pytest.mark.parametrize("name,mode", [("DNA5", "canonical"),
                                       ("DNACaseSent", "primary"),
                                       ("Protein", "basic")])
def test_sidecar_build_identical(tmp_path, capsys, monkeypatch, name, mode):
    """Count-sidecar builds (contigs with .kmer_counts.gz, written by the
    JAX package's ExtendedFastaWriter) over each alphabet: stdout and
    the .dbg.npz arrays equal."""
    k = 9
    rng = np.random.default_rng(len(name))
    monkeypatch.chdir(tmp_path)
    with ExtendedFastaWriter(str(tmp_path / "sc"), k) as w:
        for s in records(rng, name, 5, 60) * 2:
            w.write(s, rng.integers(1, 301, len(s) - k + 1))
    both(capsys, tmp_path, ["build", "-k", str(k), "--alphabet", name,
                            "--mode", mode, "--count-kmers", "-o", "@sc",
                            "sc.fasta.gz"])
    out = both(capsys, tmp_path, ["stats", "--count-dummy", "--validate",
                                  "@sc"])
    assert "nnz weights" in out
    with np.load(tmp_path / "jsc.dbg.npz") as x, \
            np.load(tmp_path / "tsc.dbg.npz") as y:
        assert sorted(x.files) == sorted(y.files)
        for key in x.files:
            np.testing.assert_array_equal(x[key], y[key], err_msg=key)
