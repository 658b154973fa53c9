"""The port's out-of-core and streaming builds against the JAX package.

``build_boss_out_of_core`` (n_shards 1, 3 and 8, with and without counts,
tiny pass-1 chunks; k = 65 past the kernels' 8 lanes), ``merge_boss_graphs_out_of_core``, the key
transforms of its queries against the JAX package's host ones and the
target-key routing balance, and ``build_boss_streaming`` /
``collect_kmers_streaming`` (runs in RAM or on disk), all bit for bit
against the JAX package's builds; the CLI's ``build --num-shards``, ``build
--disk-swap`` and ``merge --num-shards`` give the JAX CLI's ``stats``
and graphs that load in either package. The port runs on the CPU.
"""

import numpy as np
import pytest
import torch

from metagraph_tpu.cli.main import main as jmain
from metagraph_tpu.graph.boss_construct import build_boss as jbuild
from metagraph_tpu.graph.dbg_succinct import DbgSuccinct as JDbg
from metagraph_tpu.graph.io import load_graph as jload
from metagraph_tpu.kmer.alphabets import DNA as JDNA
from metagraph_tpu.parallel import outofcore as joc
from metagraph_tpu.parallel import streaming as jst
from metagraph_tpu_torch.cli.main import main as tmain
from metagraph_tpu_torch.common import packed as tpk
from metagraph_tpu_torch.graph import boss_construct as tbc
from metagraph_tpu_torch.graph.dbg_succinct import DbgSuccinct
from metagraph_tpu_torch.graph.io import load_graph
from metagraph_tpu_torch.kmer import packing as tpack
from metagraph_tpu_torch.kmer.alphabets import DNA
from metagraph_tpu_torch.parallel import outofcore as toc
from metagraph_tpu_torch.parallel import streaming as tst
from test_torch_graph_cli import run
from test_torch_sharded import seqs_of, write_fasta

torch.set_num_threads(2)


def same_arrays(jb, tb, weights=False, lanes=False):
    np.testing.assert_array_equal(tb.W.numpy(), np.asarray(jb.W))
    np.testing.assert_array_equal(tb.last.numpy(), np.asarray(jb.last))
    np.testing.assert_array_equal(tb.F.numpy(), np.asarray(jb.F))
    assert tb.num_edges == jb.num_edges
    if weights:
        np.testing.assert_array_equal(tb.weights.numpy(),
                                      np.asarray(jb.weights))
    if lanes:
        np.testing.assert_array_equal(tpk.lanes_to_numpy(tb.edge_lanes),
                                      np.asarray(jb.edge_lanes))


@pytest.mark.parametrize("K", [9, 11, 20, 31])
def test_host_transforms(K):
    """The port's query transforms on the device (``_Keys``) equal the
    JAX package's host ones (``h_*``): keys, owners and target-key
    owners, per-owner groups and sorts; the group key too."""
    B = 4
    rng = np.random.default_rng(K)
    chars = rng.integers(1, 5, (257, K)).astype(np.uint8)
    t = tpack.pack_from_chars(torch.from_numpy(chars), K, B)
    x = tpk.lanes_to_numpy(t)
    sp = np.sort(x[:, ::37], axis=1)[:, :5]
    sp = sp[:, np.argsort(toc.rec_view(sp), kind="stable")]
    keys = toc._Keys(sp, K, B, "cpu")
    for dev, jhost in (
            (keys.node_key(t), joc.h_node_key(x, B)),
            (keys.target_key(t), joc.h_target_key(x, B)),
            (keys.to_next(t), joc.h_to_next(x, K, B)),
            (keys.to_prev(t), joc.h_to_prev(x, K, B))):
        np.testing.assert_array_equal(tpk.lanes_to_numpy(dev), jhost)
    np.testing.assert_array_equal(toc.h_group_key(x, B),
                                  joc.h_group_key(x, B))
    own = keys.owner(t)
    np.testing.assert_array_equal(own.numpy(), joc.h_owner(x, sp, B))
    np.testing.assert_array_equal(keys.owner(t, True).numpy(),
                                  joc.h_owner_tkey(x, sp, B))
    idx = torch.arange(x.shape[1])
    for (g, gi), (jg, ji) in zip(
            keys.split(t, own, idx),
            joc._bucket_by_owner(x, joc.h_owner(x, sp, B), keys.S,
                                 np.arange(x.shape[1]))):
        np.testing.assert_array_equal(g, jg)
        np.testing.assert_array_equal(gi, ji)
    np.testing.assert_array_equal(
        keys.sort(x), x[:, np.argsort(toc.rec_view(x), kind="stable")])


@pytest.mark.parametrize("n_shards", [1, 3, 8])
@pytest.mark.parametrize("bits", [0, 8])
def test_out_of_core_identical(n_shards, bits):
    """Bit-identical to the JAX out-of-core build and to the in-core
    build."""
    seqs = seqs_of(100 + n_shards, 6, 200, 500)
    seqs.append(seqs[0][50:250])                 # counts above one
    jb = joc.build_boss_out_of_core(seqs, 9, n_shards=n_shards,
                                    bits_per_count=bits, chunk_codes=1 << 10,
                                    keep_kmer_index=True)
    tb = toc.build_boss_out_of_core(
        seqs, 9, n_shards=n_shards, bits_per_count=bits, chunk_codes=1 << 10,
        keep_kmer_index=True, device="cpu")
    same_arrays(jb, tb, weights=bits > 0, lanes=True)
    incore = tbc.build_boss(seqs, 9, bits_per_count=bits, device="cpu")
    same_arrays(jbuild(seqs, 9, bits_per_count=bits), incore, bits > 0)
    assert torch.equal(incore.W, tb.W)


def test_out_of_core_past_eight_lanes():
    """k = 65 (9 lanes: sorts and compactions in lane groups, the
    co-rank merge's plain version) equals the JAX out-of-core build."""
    seqs = seqs_of(65, 3, 250, 300)
    kw = dict(n_shards=3, bits_per_count=8, chunk_codes=1 << 9,
              keep_kmer_index=True)
    jb = joc.build_boss_out_of_core(seqs, 65, **kw)
    tb = toc.build_boss_out_of_core(seqs, 65, device="cpu", **kw)
    assert tb.edge_lanes.shape[0] == 9
    same_arrays(jb, tb, weights=True, lanes=True)


def test_out_of_core_small_state_and_valid():
    """The default small state (no edge k-mers) with its real-edge mask
    equals the JAX package's; the graph maps reads, walks included."""
    seqs = seqs_of(111, 3, 400, 600)
    jb, jv = joc.build_boss_out_of_core(seqs, 9, n_shards=4,
                                        chunk_codes=1 << 10,
                                        return_valid=True)
    tb, tv = toc.build_boss_out_of_core(seqs, 9, n_shards=4,
                                        chunk_codes=1 << 10,
                                        return_valid=True, device="cpu")
    assert tb.edge_lanes is None
    same_arrays(jb, tb)
    np.testing.assert_array_equal(tv, jv)
    g = DbgSuccinct.from_boss(tb, DNA, "basic", valid=torch.from_numpy(tv))
    jg = JDbg.from_boss(jb, JDNA, "basic", valid=jv)
    sub = {65: 67, 67: 71, 71: 84, 84: 65}
    reads = [seqs[0][10:110], b"T" * 80, seqs[1][5:60], b"ACGTACG"]
    r = bytearray(seqs[2][100:200])
    r[40] = sub[r[40]]
    reads.append(bytes(r))
    for read, got in zip(reads, g.map_read_batch(reads)):
        np.testing.assert_array_equal(np.asarray(got),
                                      np.asarray(jg.map_to_nodes(read)))
    assert (np.asarray(g.map_to_nodes(seqs[0])) > 0).all()


def test_out_of_core_empty_shards():
    """More shards than distinct group keys: the splitters dedupe and
    some shards are empty (the JAX package uploads a zero counts array
    for one, harmless; the port skips them)."""
    seqs = [b"ACGTACGTAAACCCGGGTTT" * 3, b"GGGGGGGGGGGGGG"]
    jb = joc.build_boss_out_of_core(seqs, 5, n_shards=8, bits_per_count=8,
                                    chunk_codes=64, keep_kmer_index=True)
    tb = toc.build_boss_out_of_core(seqs, 5, n_shards=8, bits_per_count=8,
                                    chunk_codes=64, keep_kmer_index=True,
                                    device="cpu")
    same_arrays(jb, tb, weights=True, lanes=True)


def test_runs_with_and_without_counts_repaired():
    """Runs with and without counts: the JAX package misaligns the counts
    (a fault of the reference); the port counts each k-mer of an
    uncounted run once, which equals the JAX build of the same runs with
    explicit unit counts."""
    seqs = seqs_of(121, 4)
    ones = []
    for part in (seqs[:2], seqs[2:]):
        lanes, counts, n, _ = tbc.collect_kmers(part, 9, device="cpu",
                                                with_bounds=False)
        ones.append((tpk.lanes_to_numpy(lanes[:, :n]),
                     counts[:n].numpy().astype(np.int32)))
    mixed = [ones[0], (ones[1][0], None)]
    unit = [ones[0], (ones[1][0], np.ones(ones[1][0].shape[1], np.int32))]
    jb = joc.build_boss_out_of_core((), 9, n_shards=3, bits_per_count=8,
                                    runs=unit, keep_kmer_index=True)
    tb = toc.build_boss_out_of_core((), 9, n_shards=3, bits_per_count=8,
                                    runs=mixed, keep_kmer_index=True,
                                    device="cpu")
    same_arrays(jb, tb, weights=True, lanes=True)


@pytest.mark.parametrize("weighted", [False, True])
def test_streaming_merge_identical(weighted):
    """merge_boss_graphs_out_of_core equals the JAX package's and the
    in-core rebuild of the union (weights summed at 31 bits)."""
    s1 = seqs_of(131, 2, 300, 400)
    s2 = [s1[0][100:300]] + seqs_of(132, 1, 300, 350)
    bits = 8 if weighted else 0
    jg = [JDbg.from_boss(jbuild(s, 9, bits_per_count=bits), JDNA, "basic")
          for s in (s1, s2)]
    tg = [DbgSuccinct.from_boss(tbc.build_boss(s, 9, bits_per_count=bits,
                                               device="cpu"))
          for s in (s1, s2)]
    jm, jv = joc.merge_boss_graphs_out_of_core(jg, n_shards=4,
                                               return_valid=True,
                                               keep_kmer_index=True)
    tm, tv = toc.merge_boss_graphs_out_of_core(tg, n_shards=4,
                                               return_valid=True,
                                               keep_kmer_index=True,
                                               device="cpu")
    same_arrays(jm, tm, weights=weighted, lanes=True)
    np.testing.assert_array_equal(tv, jv)
    ref = tbc.build_boss(s1 + s2, 9, bits_per_count=31 if weighted else 0,
                         device="cpu")
    assert torch.equal(ref.W, tm.W)


def test_tkey_routing_balance():
    """Target keys spread across the shards like edges once shifted one
    field; routed raw, every one lands on shard 0."""
    K, B = 20, 4
    codes = np.random.default_rng(3).integers(1, 5, 200_000).astype(np.uint8)
    real = tpk.lanes_to_numpy(tpack.pack_windows(torch.from_numpy(codes), K,
                                                 B))
    real = real[:, np.argsort(toc.rec_view(toc.h_group_key(real, B)),
                              kind="stable")]
    store = toc._RunStore(None)
    store.add(real, None)
    S = 8
    sp = toc._sample_splitters_from_runs(store, real.shape[0], B, S)
    jstore = joc._RunStore(None)
    jstore.add(real, None)
    np.testing.assert_array_equal(
        sp, joc._sample_splitters_from_runs(jstore, real.shape[0], B, S))
    store.cleanup()
    jstore.cleanup()
    keys = toc._Keys(sp, K, B, "cpu")
    tk = keys.target_key(tpk.lanes_from_numpy(real, "cpu"))
    owners = keys.owner(tk, True).numpy()
    np.testing.assert_array_equal(
        owners, joc.h_owner_tkey(tpk.lanes_to_numpy(tk), sp, B))
    counts = np.bincount(owners, minlength=S)
    assert counts.max() < 2.5 * counts.mean(), counts
    raw = keys.owner(tk).numpy()
    assert np.bincount(raw, minlength=S).max() == len(raw)


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["basic", "canonical", "primary"])
def test_streaming_build_identical(mode, tmp_path):
    """build_boss_streaming (tiny chunks; runs in RAM or on disk)
    equals the JAX package's."""
    seqs = seqs_of(141, 4, 300, 700)
    jb = jst.build_boss_streaming(seqs, 11, mode=mode, bits_per_count=8,
                                  chunk_codes=512)
    for disk in (None, str(tmp_path)):
        tb = tst.build_boss_streaming(seqs, 11, mode=mode, bits_per_count=8,
                                      chunk_codes=512, disk_dir=disk,
                                      device="cpu")
        same_arrays(jb, tb, weights=True, lanes=True)


def test_disk_swap_collect_identical(tmp_path):
    """The spilled runs' merge equals the in-RAM one and the JAX
    package's, counts included."""
    seqs = seqs_of(151, 20, 400, 600)
    jl, jc = jst.collect_kmers_streaming(seqs, 13, chunk_codes=2048,
                                         disk_dir=str(tmp_path))
    for disk in (None, str(tmp_path)):
        tl, tc = tst.collect_kmers_streaming(seqs, 13, chunk_codes=2048,
                                             disk_dir=disk, device="cpu")
        np.testing.assert_array_equal(np.asarray(tl), np.asarray(jl))
        np.testing.assert_array_equal(np.asarray(tc), np.asarray(jc))


def test_disk_merge_small_blocks(tmp_path):
    """Blocks far smaller than the runs: each round emits only keys whose
    every copy is loaded; equal to the JAX package's one host merge,
    with the runs in RAM and on disk."""
    rng = np.random.default_rng(161)
    runs = []
    for _ in range(5):
        x = np.unique(rng.integers(0, 3000, 700).astype(np.uint32))
        runs.append((np.stack([x // 1000, x]).astype(np.uint32),
                     rng.integers(1, 5, len(x)).astype(np.int64)))
    want = jst._merge_sorted_chunks(runs, 2)
    for directory in (None, str(tmp_path)):
        store = tst.DiskChunkStore(directory, 2)
        for lanes, counts in runs:
            store.spill(lanes, counts)
        got = store.merge_all("cpu", block=37)
        np.testing.assert_array_equal(np.asarray(got[0]), want[0])
        np.testing.assert_array_equal(np.asarray(got[1]), want[1])


@pytest.mark.parametrize("K", [16, 20, 31])
def test_spill_pack_roundtrip(K):
    """The compact spill form keeps the order and round-trips; it is the
    JAX package's, lane for lane."""
    B = 4
    B2 = tst._repack_bits(K, B, DNA.size)
    assert B2 == jst._repack_bits(K, B, JDNA.size) == 2
    rng = np.random.default_rng(K)
    chars = rng.integers(1, 5, (500, K)).astype(np.uint8)
    lanes = tpk.lanes_to_numpy(tpack.pack_from_chars(torch.from_numpy(chars),
                                                     K, B))
    lanes = lanes[:, np.argsort(toc.rec_view(lanes), kind="stable")]
    packed_l = tst._pack_run(lanes, K, B, B2)
    np.testing.assert_array_equal(packed_l, jst._pack_run(lanes, K, B, B2))
    assert packed_l.shape[0] < lanes.shape[0]
    o2 = np.argsort(toc.rec_view(packed_l), kind="stable")
    assert (o2 == np.arange(len(o2))).all()
    np.testing.assert_array_equal(tst._unpack_run(packed_l, K, B, B2), lanes)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flow", ["num_shards", "num_shards_small",
                                  "disk_swap", "disk_swap_ram",
                                  "merge_num_shards"])
def test_cli_out_of_core_identical(tmp_path, flow):
    seqs = seqs_of(171, 6, 200, 500)
    fa = str(tmp_path / "in.fa")
    write_fasta(fa, seqs)
    for half, part in (("h1", seqs[:3]), ("h2", seqs[2:])):
        write_fasta(str(tmp_path / f"{half}.fa"), part)
    outs = {}
    for pkg, main, extra in (("j", jmain, []),
                             ("t", tmain, ["--device", "cpu"])):
        def p(name):
            return str(tmp_path / f"{pkg}_{name}")
        if flow.startswith("num_shards"):
            # the JAX CLI's out-of-core build collects 2^25-code chunks,
            # about a minute on the CPU: its single-shard build of the
            # same graph stands in for it
            state = (["--state", "small"] if flow.endswith("small") else [])
            shards = ["--num-shards", "4"] if pkg == "t" else []
            argvs = [["build", "-k", "11", "--count-kmers", "-o", p("g"), fa]
                     + shards + state]
        elif flow.startswith("disk_swap"):
            where = str(tmp_path) if flow == "disk_swap" else "nodir"
            argvs = [["build", "-k", "11", "--mode", "canonical",
                      "--disk-swap", where, "--mem-cap-gb", "0.0001", "-o",
                      p("g"), fa]]
        else:
            argvs = [["build", "-k", "11", "--count-kmers", "-o", p("a"),
                      str(tmp_path / "h1.fa")],
                     ["build", "-k", "11", "--count-kmers", "-o", p("b"),
                      str(tmp_path / "h2.fa")],
                     ["merge", "--num-shards", "2", "-o", p("g"), p("a"),
                      p("b")]]
        for argv in argvs:
            _, code = run(main, argv + extra)
            assert code in (0, None), (pkg, argv)
        outs[pkg], code = run(main, ["stats", p("g")] + extra)
        assert code in (0, None)
    assert outs["j"] == outs["t"]
    a = load_graph(str(tmp_path / "j_g"), device="cpu")   # cross-loading
    b = jload(str(tmp_path / "t_g"))
    np.testing.assert_array_equal(a.boss.W.numpy(), np.asarray(b.boss.W))
    direct = tbc.build_boss(seqs, 11, device="cpu",
                            mode="canonical" if flow.startswith("disk")
                            else "basic")
    if flow != "merge_num_shards":
        assert torch.equal(a.boss.W, direct.W)
