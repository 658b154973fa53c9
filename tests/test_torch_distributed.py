"""The port's distributed builds and steps against the JAX package.

Ranks are gloo processes on the CPU that import the port only (never
JAX): one group of 8 ranks, and one of 4 whose subgroups of 1 and 2
ranks come from ``make_mesh``. Each rank writes what it built to a
scratch directory, and this process, which builds the JAX package's
golds meanwhile (``build_boss``, and ``build_boss_distributed_full`` on
the 8-device CPU mesh of ``conftest.py``), compares bit for bit: W,
last, F, weights and the edge k-mers of ``build_boss_distributed`` and
``build_boss_distributed_full`` at widths 1, 2, 4 and 8 in modes basic
and canonical on every rank, primary, adversarial inputs (a
homopolymer, one tandem repeat, all-identical reads, one record longer
than a slab), the routes' balance, and the count and query steps.
"""

import json
import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_dna
from metagraph_tpu.graph.boss_construct import build_boss as jbuild
from metagraph_tpu.kmer.alphabets import DNA as JDNA, INVALID_CODE
from metagraph_tpu.parallel import distributed as jd
from metagraph_tpu_torch.common import packed as tpk
from metagraph_tpu_torch.kmer import packing as tpack
from metagraph_tpu_torch.kmer.alphabets import DNA
from metagraph_tpu_torch.parallel import distributed as td
from metagraph_tpu_torch.parallel import multihost
from metagraph_tpu_torch.parallel.outofcore import _Keys, h_group_key

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("W", "last", "F", "weights", "edge_lanes")
MODES = ("basic", "canonical")
K = 11
WAIT_S = 120

# one process of a group: builds every case its width's mesh holds
_WORKER = r"""
import json, os, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
torch.set_num_threads(1)
from metagraph_tpu_torch.parallel import distributed as td, multihost


def main(spec, rank):
    assert multihost.initialize(spec["addr"], spec["world"], rank,
                                device="cpu", timeout_s=60)
    meshes = {w: td.make_mesh(w, device="cpu") for w in spec["widths"]}
    builds = {"dist": td.build_boss_distributed,
              "full": td.build_boss_distributed_full}
    for case in spec["cases"]:
        mesh = meshes[case["width"]]
        if mesh.rank < 0:
            continue
        mesh.routes.clear()
        g = builds[case["fn"]](case["seqs"], case["k"], mesh,
                               mode=case["mode"], bits_per_count=8)
        np.savez(os.path.join(spec["out"],
                              f"{case['name']}.r{mesh.rank}.npz"),
                 W=g.W.numpy(), last=g.last.numpy(), F=g.F.numpy(),
                 weights=g.weights.numpy(),
                 edge_lanes=g.edge_lanes.numpy().view(np.uint32),
                 routes=json.dumps(mesh.routes))
    mesh = meshes[spec["world"]]
    res = {}
    if "count" in spec:
        step = td.build_distributed_count_step(mesh, spec["count"]["k"])
        res["count"] = step(np.array(spec["count"]["slabs"][rank],
                                     np.uint8))
    if "query" in spec:
        q = spec["query"]
        step = td.build_distributed_query_step(mesh, q["num_rows"],
                                               q["num_cols"])
        res["query"] = step(
            np.array(q["rows"]).reshape(mesh.size, -1)[rank],
            np.array(q["cols"]).reshape(mesh.size, -1)[rank],
            np.array(q["q"]), np.array(q["w"])).tolist()
    res["jax_imported"] = "jax" in sys.modules
    res["transport"] = mesh.transport
    with open(os.path.join(spec["out"], f"steps.r{rank}.json"), "w") as f:
        json.dump(res, f)


with open(sys.argv[2]) as f:
    main(json.load(f), int(sys.argv[3]))
# no mesh outlives the group: one left to interpreter exit can abort it
torch.distributed.destroy_process_group()
"""


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class Group:
    """``world`` worker processes over gloo, started at once; ``wait``
    fails on a non-zero exit or a child past the time limit."""

    def __init__(self, out, world, widths, cases, **steps):
        os.makedirs(out)
        self.out = str(out)
        spec = dict(addr=f"127.0.0.1:{free_port()}", world=world,
                    widths=widths, cases=cases, out=self.out, **steps)
        path = os.path.join(self.out, "spec.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("JAX_", "XLA_")) and k != "PYTHONPATH"}
        # niced: the JAX golds' compiles meanwhile set this file's time
        self.procs = [subprocess.Popen(
            ["nice", "-n", "10", sys.executable, "-c", _WORKER, REPO, path,
             str(r)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for r in range(world)]
        self.done = False

    def wait(self):
        if not self.done:
            try:
                for p in self.procs:
                    out, _ = p.communicate(timeout=WAIT_S)
                    assert p.returncode == 0, out.decode()[-3000:]
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            self.done = True
        return self

    def boss(self, name, rank):
        with np.load(os.path.join(self.out, f"{name}.r{rank}.npz")) as z:
            return {f: z[f] for f in FIELDS}, json.loads(str(z["routes"]))

    def steps(self, rank):
        with open(os.path.join(self.out, f"steps.r{rank}.json")) as f:
            return json.load(f)


def seqs_of(seed, n, length):
    rng = np.random.default_rng(seed)
    return [random_dna(rng, length) for _ in range(n)]


# inputs of about 5000 codes each: the JAX golds share one capacity class
RAND = seqs_of(5, 10, 500)
BIG = seqs_of(6, 24, 1000)              # the balance input
ADVERSARIAL = {
    "homopolymer": [b"A" * 5000],
    "repeat": [b"ACGTTGCA" * 625],
    "identical": [seqs_of(7, 1, 100)[0]] * 50,
    "long": seqs_of(8, 1, 5000),        # longer than one slab at width 4
}


def case(name, fn, width, mode, seqs):
    return dict(name=name, fn=fn, width=width, mode=mode, k=K,
                seqs=[s.decode() for s in seqs])


def count_input(rng):
    """8 slabs of 1024 codes, each a random read and one INVALID (JAX
    ``tests/test_distributed.py::test_distributed_kmer_count``)."""
    tbl = JDNA.encode_table()
    codes = np.full((8, 1 << 10), INVALID_CODE, np.uint8)
    for i in range(8):
        s = random_dna(rng, (1 << 10) - 1)
        codes[i, :len(s)] = tbl[np.frombuffer(s, np.uint8)]
    return codes


def query_input(rng):
    num_rows, num_cols = 200, 16
    dense = rng.random((num_rows, num_cols)) < 0.15
    r, c = np.nonzero(dense)
    rows, cols = jd.shard_annotation_coo(r.astype(np.int32),
                                         c.astype(np.int32), num_rows,
                                         num_cols, 8)
    q = np.sort(rng.choice(num_rows, size=32, replace=False)).astype(np.int32)
    w = rng.integers(1, 4, size=32).astype(np.int32)
    return dict(rows=rows.tolist(), cols=cols.tolist(), q=q.tolist(),
                w=w.tolist(), num_rows=num_rows, num_cols=num_cols)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Both process groups, started before the JAX golds are built."""
    out = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(9)
    cases8 = [case(f"{fn}-{m}", fn, 8, m, RAND)
              for fn in ("dist", "full") for m in MODES + ("primary",)]
    cases8 += [case(f"big-{m}", "full", 8, m, BIG) for m in MODES]
    cases4 = [case(f"{fn}-{m}-w{w}", fn, w, m, RAND)
              for w in (1, 2, 4) for fn in ("dist", "full") for m in MODES]
    cases4 += [case(f"{fn}-primary", fn, 4, "primary", RAND)
               for fn in ("dist", "full")]
    cases4 += [case(f"{a}-{fn}-{m}-w{w}", fn, w, m, s)
               for a, s in ADVERSARIAL.items() for w in (2, 4)
               for fn in ("dist", "full") for m in MODES]
    cases4 += [case(f"big-{m}", "full", 4, m, BIG) for m in MODES]
    count = count_input(rng)
    query = query_input(rng)
    g8 = Group(out / "w8", 8, [8], cases8,
               count=dict(k=8, slabs=count.tolist()), query=query)
    g4 = Group(out / "w4", 4, [1, 2, 4], cases4)
    yield dict(w8=g8, w4=g4, count=count, query=query)
    for g in (g8, g4):
        for p in g.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def jax_golds():
    """The JAX package's single-device builds of every input."""
    gold = {}
    for m in MODES + ("primary",):
        gold["rand", m] = jbuild(RAND, K, mode=m, bits_per_count=8)
    for a, s in ADVERSARIAL.items():
        for m in MODES:
            gold[a, m] = jbuild(s, K, mode=m, bits_per_count=8)
    return gold


@pytest.fixture(scope="module")
def jax_side(groups):
    """The JAX builds, four at a time in threads (their compiles take
    most of this file's time): the golds, and the fully sharded build of
    each mode (primary on 2 devices)."""
    with ThreadPoolExecutor(4) as pool:
        futures = {m: pool.submit(
            jd.build_boss_distributed_full, RAND, K,
            jd.make_mesh(2 if m == "primary" else 8), mode=m,
            bits_per_count=8) for m in MODES + ("primary",)}
        futures["gold"] = pool.submit(jax_golds)
        yield futures


@pytest.fixture(scope="module")
def jgold(jax_side):
    return jax_side["gold"].result()


def same(got, want, what):
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)),
                                      err_msg=f"{what}: {f}")


def every_rank(group, name, width, want):
    for r in range(width):
        same(group.boss(name, r)[0], want, f"{name} rank {r}")


@pytest.mark.parametrize("width", [1, 2, 4, 8])
@pytest.mark.parametrize("fn", ["dist", "full"])
@pytest.mark.parametrize("mode", MODES)
def test_builds_equal_jax_build_boss(groups, jgold, width, fn, mode):
    if width == 8:
        g, name = groups["w8"].wait(), f"{fn}-{mode}"
    else:
        g, name = groups["w4"].wait(), f"{fn}-{mode}-w{width}"
    every_rank(g, name, width, jgold["rand", mode])


@pytest.mark.parametrize("mode", MODES)
def test_full_equals_jax_full_at_width_8(groups, jax_side, mode):
    want = jax_side[mode].result()
    every_rank(groups["w8"].wait(), f"full-{mode}", 8, want)


def test_primary_repaired(groups, jgold, jax_side):
    """Primary mode builds the basic graph of the canonical forms, equal
    to JAX ``build_boss(mode="primary")``. JAX
    ``build_boss_distributed_full`` sets ``canonical`` for primary
    (``metagraph_tpu/parallel/distributed.py:503``) and builds the
    canonical closure instead (a fault of the reference);
    ``build_boss_distributed`` (``:181``, ``:213``) builds it right."""
    want = jgold["rand", "primary"]
    for fn in ("dist", "full"):
        every_rank(groups["w8"].wait(), f"{fn}-primary", 8, want)
        every_rank(groups["w4"].wait(), f"{fn}-primary", 4, want)
    jfault = jax_side["primary"].result()
    same({f: np.asarray(getattr(jfault, f)) for f in FIELDS},
         jgold["rand", "canonical"], "JAX full build, mode primary")
    assert jfault.num_edges != want.num_edges


@pytest.mark.parametrize("width", [2, 4])
@pytest.mark.parametrize("adv", sorted(ADVERSARIAL))
def test_adversarial_inputs(groups, jgold, adv, width):
    """Everything on one rank, or one record over every slab: every route
    and join takes ranks that receive nothing, rank 0 still emits the
    sentinel."""
    g = groups["w4"].wait()
    for fn in ("dist", "full"):
        for m in MODES:
            every_rank(g, f"{adv}-{fn}-{m}-w{width}", width, jgold[adv, m])


def test_long_record_jax_fault():
    """JAX packs whole records into slabs (``_bucket(total / n + 64)``
    codes) and fails on a record longer than one
    (``metagraph_tpu/parallel/distributed.py:518``); the port cuts the
    record across slabs (``test_adversarial_inputs[long-*]``) and its
    slabs hold every window once."""
    with pytest.raises(ValueError, match="broadcast"):
        jd.build_boss_distributed_full(ADVERSARIAL["long"], K,
                                       jd.make_mesh(4))
    seq = ADVERSARIAL["long"][0]
    windows = sorted(seq[i:i + K] for i in range(len(seq) - K + 1))
    got = []
    for r in range(4):
        slab = td.code_slab(ADVERSARIAL["long"], DNA, r, 4, K)
        got += [bytes(b"$ACGT"[c] for c in slab[i:i + K])
                for i in range(len(slab) - K + 1)
                if (slab[i:i + K] != INVALID_CODE).all()]
    assert sorted(got) == windows


@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("mode", MODES)
def test_route_balance(groups, width, mode):
    """On random input every splitter route (the collect, the rc route,
    the sink route, both target-key routes) gives no rank more than 2.5x
    the mean of its received rows (JAX ``tests/test_outofcore.py:186``)."""
    g = groups[f"w{width}"].wait()
    logs = [g.boss(f"big-{mode}", r)[1] for r in range(width)]
    names = ["collect", "sink", "src_ref", "src_query"] + (
        ["rc"] if mode == "canonical" else [])
    for name in names:
        rows = np.array([log[name][1] for log in logs], np.float64)
        assert rows.max() < 2.5 * rows.mean(), (name, rows)


def test_count_step_width_8(groups):
    """Distinct k-mers over 8 ranks (JAX's count step on the same slabs)."""
    g = groups["w8"].wait()
    step = jd.build_distributed_count_step(jd.make_mesh(8), 8,
                                           codes_per_device=1 << 10)
    total, per_shard = step(jnp.asarray(groups["count"].reshape(-1)))
    got = [g.steps(r)["count"] for r in range(8)]
    assert all(t == int(total) for t, _ in got)
    np.testing.assert_array_equal([u for _, u in got],
                                  np.asarray(per_shard))


def test_query_step_width_8(groups):
    q = groups["query"]
    step = jd.build_distributed_query_step(
        jd.make_mesh(8), q["num_rows"], q["num_cols"],
        nnz_cap=len(q["rows"]) // 8, query_cap=32)
    want = np.asarray(step(*(jnp.asarray(np.array(q[x], np.int32))
                             for x in ("rows", "cols", "q", "w"))))
    g = groups["w8"].wait()
    for r in range(8):
        steps = g.steps(r)
        np.testing.assert_array_equal(steps["query"], want)
        assert not steps["jax_imported"]
        assert steps["transport"] == "gloo"


def test_host_helpers():
    """Splitters, group keys, owners and the COO sharding equal the JAX
    package's (the splitter owner is the out-of-core build's
    ``_Keys.owner``)."""
    B = 4
    for n in (1, 3, 8):
        np.testing.assert_array_equal(td.sample_splitters(BIG, K, n),
                                      jd.sample_splitters(BIG, K, n))
    rng = np.random.default_rng(3)
    chars = rng.integers(1, 5, (300, K)).astype(np.uint8)
    x = tpack.pack_from_chars(torch.from_numpy(chars), K, B)
    xn = tpk.lanes_to_numpy(x)
    np.testing.assert_array_equal(h_group_key(xn, B),
                                  np.asarray(jd.group_key(jnp.asarray(xn),
                                                          B)))
    for n in (1, 2, 5, 8):
        np.testing.assert_array_equal(
            td._owner_of(x, K, B, n).numpy(),
            np.asarray(jd._owner_of(jnp.asarray(xn), K, B, n)))
        sp = td.sample_splitters(BIG, K, n)
        np.testing.assert_array_equal(
            _Keys(sp[:, :n - 1], K, B, "cpu").owner(x).numpy(),
            np.asarray(jd._owner_split(jnp.asarray(xn), jnp.asarray(sp), B,
                                       n)))
    r = rng.integers(0, 50, 90).astype(np.int32)
    c = rng.integers(0, 13, 90).astype(np.int32)
    for got, want in zip(td.shard_annotation_coo(r, c, 50, 13, 4),
                         jd.shard_annotation_coo(r, c, 50, 13, 4)):
        np.testing.assert_array_equal(got, want)


def test_one_process_without_group(jgold):
    """No process group: a one-rank mesh whose routes are local."""
    mesh = multihost.global_mesh("cpu")
    assert (mesh.size, mesh.rank, mesh.transport) == (1, 0,
                                                      "none (one process)")
    for fn in (td.build_boss_distributed, td.build_boss_distributed_full):
        g = fn(RAND, K, mesh, mode="canonical", bits_per_count=8)
        same({f: (tpk.lanes_to_numpy(getattr(g, f)) if f == "edge_lanes"
                  else getattr(g, f).numpy()) for f in FIELDS},
             jgold["rand", "canonical"], fn.__name__)
