"""The port's suffix-sharded builds against the JAX package, bit for bit.

The node-suffix filter of ``extract_packed_kmers``, one bucket's sorted
k-mers (``build_shard_kmers``), the whole sharded build
(``build_boss_sharded``, its chunk-file resume), chunk files loading
across the packages, ``build --suffix`` / ``--parts-total`` +
``concatenate`` through both CLIs (graph files and ``stats`` stdout),
and the work-queue coordinator (in process, and once with two worker
processes). The port runs on the CPU, where its kernels take their plain
versions. Two faults of the reference are repaired here (ROADMAP §3.5):
a sharded primary build makes the canonical closure, and ``concatenate
-i`` looks for DNA's buckets whatever the chunks' alphabet.
"""

import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error

import numpy as np
import pytest
import torch

from metagraph_tpu.cli.main import main as jmain
from metagraph_tpu.graph.boss_construct import build_boss as jbuild
from metagraph_tpu.kmer import extractor as jext
from metagraph_tpu.kmer.alphabets import ALPHABETS as JALPHABETS
from metagraph_tpu.parallel import sharded_build as jsb
from metagraph_tpu_torch.cli.main import main as tmain
from metagraph_tpu_torch.common import packed as tpk
from metagraph_tpu_torch.graph import boss_construct as tbc
from metagraph_tpu_torch.graph.io import load_graph
from metagraph_tpu_torch.kmer import extractor as text
from metagraph_tpu_torch.kmer.alphabets import ALPHABETS
from metagraph_tpu_torch.parallel import coordinator as tco
from metagraph_tpu_torch.parallel import sharded_build as tsb
from test_torch_build import assert_same_boss
from test_torch_graph_cli import run

torch.set_num_threads(2)

LETTERS = {"DNA": b"ACGT", "DNA5": b"ACGTN",
           "Protein": b"ACDEFGHIKLMNPQRSTVWY"}


def seqs_of(seed, n=5, lo=60, hi=300, letters=b"ACGT"):
    rng = np.random.default_rng(seed)
    pool = np.frombuffer(letters, np.uint8)
    return [bytes(rng.choice(pool, size=int(rng.integers(lo, hi))))
            for _ in range(n)]


def write_fasta(path, seqs):
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b">s%d\n%s\n" % (i, s))


@pytest.mark.parametrize("alphabet,K,suffix", [
    ("DNA", 6, (2, 3)), ("DNA", 11, (4,)), ("DNA", 20, (1, 2, 3)),
    ("DNA5", 9, (5, 2)), ("Protein", 5, (7,)), ("DNA", 2, (3,))])
def test_extractor_suffix_filter(alphabet, K, suffix):
    """Every window whose node suffix matches, in order, as JAX keeps
    them; the kept windows' node characters K-s..K-1 are the suffix."""
    seqs = seqs_of(K, 4, letters=LETTERS[alphabet])
    codes = jext.encode_sequences(seqs, JALPHABETS[alphabet])
    B = JALPHABETS[alphabet].bits_per_char
    jl, jn = jext.extract_packed_kmers(__import__("jax").numpy.asarray(codes),
                                       K, B, suffix=suffix)
    tl, tn = text.extract_packed_kmers(torch.from_numpy(codes), K, B, suffix)
    n = int(tn)
    assert n == int(jn) and n > 0
    np.testing.assert_array_equal(tpk.lanes_to_numpy(tl),
                                  np.asarray(jl))
    from metagraph_tpu_torch.kmer.packing import unpack_to_chars
    chars = unpack_to_chars(tl[:, :n], K, B).numpy()
    s = len(suffix)
    for i, c in enumerate(suffix):
        np.testing.assert_array_equal(chars[:, K - 1 - s + i], c)


@pytest.mark.parametrize("suffix_len", [1, 2])
@pytest.mark.parametrize("mode", ["basic", "canonical"])
def test_build_shard_kmers_identical(mode, suffix_len):
    seqs = seqs_of(3 + suffix_len)
    canonical = mode == "canonical"
    buckets = tsb.suffix_buckets(ALPHABETS["DNA"], suffix_len)
    assert buckets == jsb.suffix_buckets(JALPHABETS["DNA"], suffix_len)
    for sfx in buckets[::3]:
        jl, jc, jn = jsb.build_shard_kmers(seqs, 11, sfx, canonical=canonical)
        tl, tc, tn = tsb.build_shard_kmers(seqs, 11, sfx, canonical=canonical,
                                           device="cpu")
        assert tn == jn
        np.testing.assert_array_equal(tpk.lanes_to_numpy(tl), np.asarray(jl))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("mode,bits,suffix_len", [
    ("basic", 0, 1), ("basic", 8, 1), ("basic", 8, 2), ("canonical", 0, 2),
    ("canonical", 8, 1), ("canonical", 8, 2)])
def test_build_boss_sharded_identical(mode, bits, suffix_len):
    """Basic: equal to the JAX sharded build. Canonical: equal to the
    JAX single-shard build (the JAX sharded build of canonical mode
    double-counts a k-mer whose two orientations occur in two buckets,
    test_sharded_canonical_both_orientations). Both: equal to the port's
    single-shard build."""
    seqs = seqs_of(10 + suffix_len) * 2          # counts above one
    tb = tsb.build_boss_sharded(seqs, 11, mode=mode, bits_per_count=bits,
                                suffix_len=suffix_len, device="cpu")
    jb = (jsb.build_boss_sharded(seqs, 11, mode=mode, bits_per_count=bits,
                                 suffix_len=suffix_len) if mode == "basic"
          else jbuild(seqs, 11, mode=mode, bits_per_count=bits))
    assert_same_boss(jb, tb, bits > 0)
    direct = tbc.build_boss(seqs, 11, mode=mode, bits_per_count=bits,
                            device="cpu")
    assert torch.equal(direct.W, tb.W) and torch.equal(direct.F, tb.F)


@pytest.mark.parametrize("name,mode", [("DNA5", "basic"),
                                       ("DNA5", "canonical"),
                                       ("Protein", "basic")])
def test_sharded_other_alphabets_identical(name, mode):
    """Basic: the JAX sharded build; canonical: the JAX single-shard
    build (see test_build_boss_sharded_identical)."""
    seqs = seqs_of(7, letters=LETTERS[name])
    tb = tsb.build_boss_sharded(seqs, 7, alphabet=ALPHABETS[name],
                                mode=mode, suffix_len=1, device="cpu")
    jb = (jsb.build_boss_sharded(seqs, 7, alphabet=JALPHABETS[name],
                                 mode=mode, suffix_len=1) if mode == "basic"
          else jbuild(seqs, 7, alphabet=JALPHABETS[name], mode=mode))
    assert_same_boss(jb, tb, False)


def test_sharded_primary_repaired():
    """The JAX sharded build of primary mode makes the canonical closure
    (a fault of the reference); the port's equals the single-shard
    primary build of both packages."""
    seqs = seqs_of(21)
    jp = jbuild(seqs, 11, mode="primary")
    tp = tsb.build_boss_sharded(seqs, 11, mode="primary", suffix_len=1,
                                device="cpu")
    assert_same_boss(jp, tp, False)
    jfault = jsb.build_boss_sharded(seqs, 11, mode="primary", suffix_len=1)
    assert jfault.num_edges != jp.num_edges


def test_sharded_canonical_both_orientations():
    """A record and its reverse complement put one canonical k-mer in two
    buckets: the JAX sharded build keeps both copies (more edges than its
    single-shard build, a fault of the reference); the port sorts and
    deduplicates the union, so its graph and counts equal the
    single-shard build's."""
    seqs = seqs_of(22, 3)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    seqs = seqs + [seqs[0].translate(comp)[::-1]]
    jb = jbuild(seqs, 11, mode="canonical", bits_per_count=8)
    tb = tsb.build_boss_sharded(seqs, 11, mode="canonical", bits_per_count=8,
                                suffix_len=1, device="cpu")
    assert_same_boss(jb, tb, True)
    jfault = jsb.build_boss_sharded(seqs, 11, mode="canonical",
                                    bits_per_count=8, suffix_len=1)
    assert jfault.num_edges > jb.num_edges


def test_sharded_resume(tmp_path, monkeypatch):
    """A finished bucket's chunk file is its checkpoint: a second build
    with the same input reads every bucket back (from the port's chunks
    and from the JAX package's alike); another input does not reuse
    them."""
    seqs = seqs_of(31, 3)
    fresh = tsb.build_boss_sharded(seqs, 11, suffix_len=1, device="cpu")
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jsb.build_boss_sharded(seqs, 11, suffix_len=1, chunk_dir=jdir)
    first = tsb.build_boss_sharded(seqs, 11, suffix_len=1, chunk_dir=tdir,
                                   device="cpu")
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))

    def boom(*a, **kw):
        raise AssertionError("bucket recomputed despite valid chunks")
    monkeypatch.setattr(tsb, "build_shard_kmers", boom)
    resumed = [tsb.build_boss_sharded(seqs, 11, suffix_len=1, chunk_dir=d,
                                      device="cpu") for d in (tdir, jdir)]
    monkeypatch.undo()
    for b in [first] + resumed:
        assert torch.equal(fresh.W, b.W) and torch.equal(fresh.F, b.F)
    other = seqs_of(32, 2)
    rebuilt = tsb.build_boss_sharded(other, 11, suffix_len=1, chunk_dir=tdir,
                                     device="cpu")
    want = tsb.build_boss_sharded(other, 11, suffix_len=1, device="cpu")
    assert torch.equal(rebuilt.W, want.W)


def test_chunk_files_cross_load(tmp_path):
    """The same keys and arrays in both packages' chunk files, and each
    package's concatenate builds the same graph from the other's."""
    seqs = seqs_of(41)
    jfiles, tfiles = [], []
    for sfx in tsb.suffix_buckets(ALPHABETS["DNA"], 1):
        name = tsb.bucket_name(ALPHABETS["DNA"], sfx)
        jl, jc, _ = jsb.build_shard_kmers(seqs, 13, sfx)
        tl, tc, _ = tsb.build_shard_kmers(seqs, 13, sfx, device="cpu")
        jfiles.append(str(tmp_path / f"j.{name}.chunk.npz"))
        tfiles.append(str(tmp_path / f"t.{name}.chunk.npz"))
        jsb.save_chunk(jfiles[-1], jl, jc, 13, "DNA", sfx)
        tsb.save_chunk(tfiles[-1], tl, tc, 13, "DNA", sfx)
        with np.load(jfiles[-1]) as a, np.load(tfiles[-1]) as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                np.testing.assert_array_equal(a[key], b[key])
                assert a[key].dtype == b[key].dtype
    tsb.concatenate_chunks(jfiles, str(tmp_path / "tj"), device="cpu")
    jsb.concatenate_chunks(tfiles, str(tmp_path / "jt"))
    a = load_graph(str(tmp_path / "tj"), device="cpu")
    from metagraph_tpu.graph.io import load_graph as jload
    b = jload(str(tmp_path / "jt"))
    want = jbuild(seqs, 13)
    for g in (a.boss.W.numpy(), np.asarray(b.boss.W)):
        np.testing.assert_array_equal(g, np.asarray(want.W))


def _both_cli(tmp_path, argvs, out):
    """Run each argv through both CLIs (``@x`` names ``j_x`` / ``t_x``
    under tmp_path); returns the two graphs' stats stdout."""
    stats = []
    for pkg, main in (("j", jmain), ("t", tmain)):
        for argv in argvs:
            argv = [str(tmp_path / f"{pkg}_{a[1:]}") if a.startswith("@")
                    else a for a in argv]
            _, code = run(main, argv + (["--device", "cpu"] if pkg == "t"
                                        else []))
            assert code in (0, None), (pkg, argv)
        s, code = run(main, ["stats", str(tmp_path / f"{pkg}_{out}")]
                      + (["--device", "cpu"] if pkg == "t" else []))
        assert code in (0, None)
        stats.append(s)
    return stats


@pytest.mark.parametrize("flow", ["parts", "suffix", "suffix_len",
                                  "canonical_parts", "counts"])
def test_cli_chunked_builds_identical(tmp_path, flow):
    seqs = seqs_of(51)
    fa = str(tmp_path / "in.fa")
    write_fasta(fa, seqs)
    if flow == "suffix_len":
        argvs = [["build", "-k", "11", "--suffix-len", "2", "-o", "@g", fa]]
    elif flow == "suffix":
        argvs = [["build", "-k", "11", "--suffix", c, "-o", "@p", fa]
                 for c in "ACGT$"]
        argvs.append(["concatenate", "-i", "@p", "--len-suffix", "1",
                      "-o", "@g"])
    else:
        mode = ["--mode", "canonical"] if flow == "canonical_parts" else []
        cnt = ["--count-kmers"] if flow == "counts" else []
        argvs = [["build", "-k", "11", "--suffix-len", "1", "--parts-total",
                  "2", "--part-idx", str(p), "-o", "@p", fa] + mode + cnt
                 for p in range(2)]
        argvs.append(["concatenate", "-i", "@p", "--len-suffix", "1", "-o",
                      "@g"] + mode + cnt)
    js, ts = _both_cli(tmp_path, argvs, "g")
    assert js == ts
    tg = load_graph(str(tmp_path / "t_g"), device="cpu")
    from metagraph_tpu.graph.io import load_graph as jload
    jg = jload(str(tmp_path / "j_g"))
    np.testing.assert_array_equal(tg.boss.W.numpy(), np.asarray(jg.boss.W))
    np.testing.assert_array_equal(tg.boss.last.numpy(),
                                  np.asarray(jg.boss.last))
    if flow == "counts":
        np.testing.assert_array_equal(tg.boss.weights.numpy(),
                                      np.asarray(jg.boss.weights))
    # and the files cross-load
    jmain(["compare", str(tmp_path / "t_g"), str(tmp_path / "j_g")])


def test_cli_kmc_suffix_chunks_identical(tmp_path):
    from test_torch_kmc import counted_kmers, write_kmc2
    rng = np.random.default_rng(61)
    kmers, counts = counted_kmers(rng, 11)
    db = write_kmc2(str(tmp_path / "db"), kmers, counts, 11, 4, 5, 3, 1)
    for c in "ACGT$":
        for pkg, main, extra in (("j", jmain, []), ("t", tmain,
                                                     ["--device", "cpu"])):
            _, code = run(main, ["build", "-k", "11", "--suffix", c, "-o",
                                 str(tmp_path / pkg), db + ".kmc_pre"]
                          + extra)
            assert code in (0, None)
        name = c.replace("$", "S")
        with np.load(str(tmp_path / f"j.{name}.chunk.npz")) as a, \
                np.load(str(tmp_path / f"t.{name}.chunk.npz")) as b:
            for key in a.files:
                np.testing.assert_array_equal(a[key], b[key])


def test_concatenate_other_alphabet_repaired(tmp_path):
    """A DNA5 chunked build has an N bucket; the JAX CLI's concatenate -i
    looks only for A, C, G and T and drops it. The port reads the
    alphabet off the chunks and equals the single-shard build."""
    seqs = seqs_of(71, letters=LETTERS["DNA5"])
    fa = str(tmp_path / "in.fa")
    write_fasta(fa, seqs)
    for pkg, main, extra in (("j", jmain, []),
                             ("t", tmain, ["--device", "cpu"])):
        for p in range(2):
            run(main, ["build", "-k", "9", "--alphabet", "DNA5",
                       "--suffix-len", "1", "--parts-total", "2",
                       "--part-idx", str(p), "-o", str(tmp_path / pkg), fa]
                + extra)
        run(main, ["concatenate", "-i", str(tmp_path / pkg), "-o",
                   str(tmp_path / f"{pkg}_g")] + extra)
    assert os.path.exists(str(tmp_path / "t.N.chunk.npz"))
    tg = load_graph(str(tmp_path / "t_g"), device="cpu")
    want = jbuild(seqs, 9, alphabet=JALPHABETS["DNA5"])
    np.testing.assert_array_equal(tg.boss.W.numpy(), np.asarray(want.W))
    from metagraph_tpu.graph.io import load_graph as jload
    assert jload(str(tmp_path / "j_g")).num_nodes() < tg.num_nodes()


# ---------------------------------------------------------------------------
# the work queue
# ---------------------------------------------------------------------------

def test_queue_ack_nack_retry():
    q = tco.WorkQueue([{"n": i} for i in range(3)], max_attempts=2)
    j1, j2 = q.acquire("w1"), q.acquire("w2")
    assert {j1.payload["n"], j2.payload["n"]} == {0, 1}
    assert q.ack(j1.job_id) and not q.ack(j1.job_id)
    assert q.nack(j2.job_id)
    j3 = q.acquire("w1")
    assert j3.payload["n"] == 2
    j2b = q.acquire("w1")
    assert j2b.payload == j2.payload and j2b.attempts == 2
    assert q.nack(j2b.job_id)
    st = q.status()
    assert st["failed"] == 1 and st["done"] == 1
    q.ack(j3.job_id)
    assert q.finished()


def test_lease_expiry_requeues():
    q = tco.WorkQueue([{"n": 0}], lease_seconds=0.0)
    q.acquire("w1")
    st = q.status()
    assert st["pending"] == 1 and st["active"] == 0


def test_http_workers_flaky_execution():
    httpd, queue = tco.serve_queue([{"x": i} for i in range(8)],
                                   max_attempts=3)
    port = httpd.server_address[1]
    failed_once, done, lock = set(), [], threading.Lock()

    def execute(payload):
        with lock:
            if payload["x"] % 3 == 0 and payload["x"] not in failed_once:
                failed_once.add(payload["x"])
                raise RuntimeError("transient")
            done.append(payload["x"])
        return {"x": payload["x"]}

    workers = [tco.Worker(f"http://127.0.0.1:{port}", f"w{i}")
               for i in range(3)]
    threads = [threading.Thread(target=w.run_until_empty, args=(execute, 0.05))
               for w in workers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    httpd.shutdown()
    st = queue.status()
    assert st["done"] == 8 and st["failed"] == 0
    assert sorted(done) == list(range(8))


def test_sharded_build_via_queue(tmp_path):
    """Per-suffix chunks as queue jobs run in process, then concatenate:
    the JAX package's graph."""
    seqs = seqs_of(81, 3)
    jobs = [{"suffix": list(s)} for s in tsb.suffix_buckets(ALPHABETS["DNA"],
                                                            1)]
    httpd, queue = tco.serve_queue(jobs)
    chunks = {}

    def execute(payload):
        sfx = tuple(payload["suffix"])
        lanes, counts, _ = tsb.build_shard_kmers(seqs, 9, sfx, device="cpu")
        path = str(tmp_path / f"chunk_{tsb.bucket_name(ALPHABETS['DNA'], sfx)}"
                   ".npz")
        tsb.save_chunk(path, lanes, counts, 9, "DNA", sfx)
        chunks[sfx] = path
        return {"path": path}

    tco.Worker(f"http://127.0.0.1:{httpd.server_address[1]}").run_until_empty(
        execute, 0.05)
    httpd.shutdown()
    assert queue.finished()
    out = tsb.concatenate_chunks(
        [chunks[s] for s in tsb.suffix_buckets(ALPHABETS["DNA"], 1)],
        str(tmp_path / "full"), device="cpu")
    got = load_graph(out, device="cpu")
    np.testing.assert_array_equal(got.boss.W.numpy(),
                                  np.asarray(jbuild(seqs, 9).W))


def wait_listening(port, seconds=60.0):
    """Block until something accepts connections on the local port."""
    end = time.time() + seconds
    while True:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            if time.time() > end:
                raise
            time.sleep(0.05)


def test_worker_without_coordinator_fails():
    """A worker that never reaches its coordinator (none bound at the
    address) raises and its command exits non-zero, where one whose
    coordinator closes after answering stops quietly."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    w = tco.Worker(f"http://127.0.0.1:{port}")
    with pytest.raises(urllib.error.URLError):
        w.run_until_empty(lambda payload: {}, 0.05)
    assert not w.reached
    with pytest.raises(urllib.error.URLError):
        tmain(["worker", "--server", f"http://127.0.0.1:{port}",
               "--device", "cpu"])
    httpd, queue = tco.serve_queue([{"x": 0}])
    w = tco.Worker(f"http://127.0.0.1:{httpd.server_address[1]}")

    def execute(payload):
        httpd.shutdown()
        httpd.server_close()
        return {}

    w.run_until_empty(execute, 0.05)
    assert w.reached


def test_coordinator_two_worker_processes(tmp_path):
    """``coordinator`` (in a thread of this process) and two ``worker``
    processes of the port's CLI, on the CPU: the graph equals the JAX
    package's direct build."""
    seqs = seqs_of(91, 4)
    fa = str(tmp_path / "in.fa")
    write_fasta(fa, seqs)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = str(tmp_path / "dg")
    err = []

    def coordinate():
        try:
            tmain(["coordinator", "-k", "11", "--suffix-len", "1", "--port",
                   str(port), "-o", base, fa, "--device", "cpu"])
        except BaseException as e:                  # noqa: BLE001
            err.append(e)

    t = threading.Thread(target=coordinate)
    t.start()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    wait_listening(port)
    workers = [subprocess.Popen(
        [sys.executable, "-m", "metagraph_tpu_torch.cli.main", "worker",
         "--server", f"http://127.0.0.1:{port}", "--name", f"w{i}",
         "--device", "cpu"], env=env) for i in range(2)]
    try:
        t.join(timeout=300)
    finally:
        for w in workers:
            w.wait(timeout=120)
    assert not t.is_alive() and not err, err
    assert all(w.returncode == 0 for w in workers)
    got = load_graph(base, device="cpu")
    want = jbuild(seqs, 11)
    np.testing.assert_array_equal(got.boss.W.numpy(), np.asarray(want.W))
    np.testing.assert_array_equal(got.boss.last.numpy(),
                                  np.asarray(want.last))


@pytest.mark.parametrize("entry", [
    "build_boss_sharded", "build_shard_kmers", "concatenate_chunks",
    "build_boss_streaming", "collect_kmers_streaming",
    "build_boss_out_of_core", "cli_num_shards", "cli_disk_swap",
    "cli_suffix_len", "cli_parts"])
def test_new_entries_raise_without_gpu(tmp_path, monkeypatch, entry):
    """Without a card and without device="cpu" every new entry raises:
    nothing moves to the CPU quietly."""
    from metagraph_tpu_torch.parallel import outofcore as toc
    from metagraph_tpu_torch.parallel import streaming as tst
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seqs = seqs_of(301, 2)
    fa = str(tmp_path / "in.fa")
    write_fasta(fa, seqs)
    chunk = str(tmp_path / "c.A.chunk.npz")
    tsb.save_chunk(chunk, np.zeros((3, 0), np.uint32), np.zeros(0, np.int32),
                   11, "DNA", (1,))
    out = str(tmp_path / "g")
    calls = {
        "build_boss_sharded": lambda: tsb.build_boss_sharded(seqs, 11),
        "build_shard_kmers": lambda: tsb.build_shard_kmers(seqs, 11, (1,)),
        "concatenate_chunks": lambda: tsb.concatenate_chunks([chunk], out),
        "build_boss_streaming": lambda: tst.build_boss_streaming(seqs, 11),
        "collect_kmers_streaming": lambda: tst.collect_kmers_streaming(
            seqs, 11),
        "build_boss_out_of_core": lambda: toc.build_boss_out_of_core(seqs,
                                                                     11),
        "cli_num_shards": lambda: tmain(["build", "-k", "11",
                                         "--num-shards", "2", "-o", out, fa]),
        "cli_disk_swap": lambda: tmain(["build", "-k", "11", "--disk-swap",
                                        str(tmp_path), "-o", out, fa]),
        "cli_suffix_len": lambda: tmain(["build", "-k", "11", "--suffix-len",
                                         "1", "-o", out, fa]),
        "cli_parts": lambda: tmain(["build", "-k", "11", "--suffix-len", "1",
                                    "--parts-total", "2", "-o", out, fa]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
