"""The port's query server and client against the JAX package's, on the
CPU.

The JAX server and the port's run side by side in threads on free
ports, over the same files: a basic k = 11 graph written by the JAX CLI,
its column annotation (with k-mer counts) written by the port, that
annotation's row_diff_brwt form written by the JAX CLI, and a primary
graph written by the port and annotated by the JAX CLI. Every endpoint
(``/search`` plain, ``with_signature``, ``abundance_sum`` and ``align``;
``/align``, ``/stats``, ``/column_labels``) answers byte for byte alike;
each package's client talks to the other's server; ``query --address``
prints what the JAX CLI prints; concurrent requests answer as sequential
ones. Two faults of the JAX server are repaired, each shown here: a
request's ``min_exact_match`` leaks into later requests, and a primary
graph is served unwrapped, so its /align answers differ from
``align``'s.
"""

import concurrent.futures
import json
import socket
import sys
import urllib.request

import numpy as np
import pytest
import torch

from conftest import random_dna
from metagraph_tpu.align.aligner import Aligner as JAligner
from metagraph_tpu.anno.annotator import Annotation as JAnnotation
from metagraph_tpu.cli.main import main as jmain
from metagraph_tpu.engine.annotated_dbg import AnnotatedDbg as JAdbg
from metagraph_tpu.graph import io as jgraph_io
from metagraph_tpu.server import client as jclient
from metagraph_tpu.server.http_server import serve as jserve
from metagraph_tpu_torch.align.aligner import Aligner
from metagraph_tpu_torch.anno.annotator import Annotation
from metagraph_tpu_torch.cli.main import main as tmain
from metagraph_tpu_torch.engine.annotated_dbg import AnnotatedDbg
from metagraph_tpu_torch.graph.io import load_query_graph
from metagraph_tpu_torch.server import client as tclient
from metagraph_tpu_torch.server.http_server import serve

torch.set_num_threads(2)
K = 11


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run(capsys, main, argv) -> str:
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out


def serve_jax(graph, anno):
    """The JAX server as its ``run_server`` loads it (unwrapped)."""
    g = jgraph_io.load_graph(graph)
    adbg = JAdbg(graph=g, annotation=JAnnotation.load(anno))
    aligner = JAligner(g)
    port = free_port()
    return jserve(adbg, aligner, port=port, background=True), port, aligner


def serve_port(graph, anno):
    """The port's server as ``server_query --device cpu`` loads it."""
    g = load_query_graph(graph, device="cpu")
    adbg = AnnotatedDbg(graph=g, annotation=Annotation.load(anno, "cpu"))
    port = free_port()
    return serve(adbg, Aligner(g), port=port, background=True), port


def raw(port, endpoint, payload=None) -> bytes:
    """The response body of GET (no payload) or POST /endpoint."""
    url = f"http://127.0.0.1:{port}/{endpoint}"
    req = (url if payload is None else urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}))
    with urllib.request.urlopen(req) as r:
        assert r.status == 200
        return r.read()


def fasta_of(named) -> str:
    return "\n".join(f">{n}\n{s}" for n, s in named)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("server")
    rng = np.random.default_rng(12)
    recs = [random_dna(rng, 200) for _ in range(3)]
    fa = tmp / "in.fa"
    fa.write_bytes(b"".join(b">sample_%d\n%s\n" % (i, s)
                            for i, s in enumerate(recs)))
    g, gp = str(tmp / "g"), str(tmp / "gp")
    jmain(["build", "-k", str(K), "-o", g, str(fa)])
    tmain(["annotate", "-i", g, "--anno-header", "--count-kmers", str(fa),
           "--device", "cpu"])
    col = g + ".column.annodbg.npz"
    jmain(["transform_anno", "--anno-type", "row_diff_brwt", "-i", g,
           "-o", str(tmp / "rd"), col])
    tmain(["build", "-k", str(K), "--mode", "primary", "-o", gp, str(fa),
           "--device", "cpu"])
    jmain(["annotate", "-i", gp, "--anno-header", str(fa)])
    servers = {}
    for form, anno in (("column", col),
                       ("row_diff_brwt",
                        str(tmp / "rd.row_diff_brwt.annodbg.npz")),
                       ("primary", gp + ".column.annodbg.npz")):
        graph = gp if form == "primary" else g
        jhttpd, jport, jaligner = serve_jax(graph, anno)
        thttpd, tport = serve_port(graph, anno)
        servers[form] = dict(jax=jport, port=tport, jaligner=jaligner,
                             httpd=(jhttpd, thttpd), graph=graph, anno=anno)
    # reads: record slices, reads of k - 1, k and k + 1 characters, a
    # substitution, an N, a random read (four lengths: the JAX package
    # compiles its per-read paths for each)
    reads = []
    for i, s in enumerate(recs):
        s = s.decode()
        reads += [(f"slice{i}", s[20:90]), (f"km1_{i}", s[5:5 + K - 1]),
                  (f"k{i}", s[30:30 + K]), (f"kp1_{i}", s[60:60 + K + 1])]
    mut = list(recs[1][40:110].decode())
    mut[35] = "A" if mut[35] != "A" else "C"
    with_n = list(recs[2][10:80].decode())
    with_n[20] = "N"
    reads += [("mutated", "".join(mut)), ("with_n", "".join(with_n)),
              ("random", random_dna(rng, 70).decode())]
    # aligned reads: each has a full-k seed (the JAX aligner searches
    # suffix seeds per read, slowly, on the CPU)
    aln = [(n, s) for n, s in reads if n in ("slice0", "slice1", "mutated")]
    qfa = tmp / "q.fa"
    qfa.write_text("".join(f">{n}\n{s}\n" for n, s in reads))
    yield dict(servers=servers, reads=reads, aln=aln, qfa=str(qfa),
               recs=recs, tmp=tmp)
    for s in servers.values():
        for httpd in s["httpd"]:
            httpd.shutdown()


SEARCHES = {
    "plain": dict(discovery_fraction=0.7, num_labels=100),
    "zero_discovery_top1": dict(discovery_fraction=0.0, num_labels=1),
    "with_signature": dict(discovery_fraction=0.5, num_labels=100,
                           with_signature=True),
    "abundance_sum": dict(discovery_fraction=0.7, num_labels=100,
                          abundance_sum=True),
    "defaults": {},
}


@pytest.mark.parametrize("form", ["column", "row_diff_brwt"])
@pytest.mark.parametrize("kind", sorted(SEARCHES))
def test_search_identical(world, form, kind):
    s = world["servers"][form]
    payload = dict(SEARCHES[kind], FASTA=fasta_of(world["reads"]))
    want = raw(s["jax"], "search", payload)
    assert json.loads(want)
    assert raw(s["port"], "search", payload) == want


@pytest.mark.parametrize("form", ["column", "row_diff_brwt"])
def test_get_endpoints_identical(world, form):
    s = world["servers"][form]
    for endpoint in ("stats", "column_labels"):
        want = raw(s["jax"], endpoint)
        assert raw(s["port"], endpoint) == want
    assert json.loads(raw(s["port"], "column_labels")) == [
        "sample_0", "sample_1", "sample_2"]


def test_align_endpoints_identical(world):
    s = world["servers"]["column"]
    fasta = fasta_of(world["aln"])
    for endpoint, payload in (
            ("align", dict(FASTA=fasta)),
            ("align", dict(FASTA=fasta, max_alternative_alignments=2)),
            ("search", dict(FASTA=fasta, align=True, num_labels=100,
                            discovery_fraction=0.7))):
        want = raw(s["jax"], endpoint, payload)
        assert raw(s["port"], endpoint, payload) == want
    out = json.loads(raw(s["port"], "align", dict(FASTA=fasta)))
    assert out[0]["alignments"][0]["cigar"] == "70="
    assert out[-1]["alignments"][0]["cigar"] == "35=1X34="


def test_unknown_endpoint_and_bad_request(world):
    s = world["servers"]["column"]
    for port in (s["jax"], s["port"]):
        for req in (f"http://127.0.0.1:{port}/nothing",
                    urllib.request.Request(
                        f"http://127.0.0.1:{port}/search", data=b"{}")):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req)
            code, body = e.value.code, e.value.read()
            assert code in (404, 500) and b"error" in body
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{s['port']}/search", data=b"{}"))
    assert e.value.read() == b'{"error": "\'FASTA\'"}'


def test_min_exact_match_leak_repaired(world):
    """The JAX server writes a /search request's min_exact_match into its
    shared aligner config: a later /align (which sends none) inherits
    it. Sequences that send the default answer alike; after a strict
    request the JAX server drops the substitution read's alignment, the
    port's keeps it."""
    s = world["servers"]["column"]
    mutated = fasta_of([r for r in world["aln"] if r[0] == "mutated"])
    try:
        for payload in (dict(FASTA=mutated, align=True, num_labels=100),
                        dict(FASTA=mutated, align=True, num_labels=100,
                             min_exact_match=0.7)):
            assert raw(s["port"], "search", payload) == raw(
                s["jax"], "search", payload)
            assert raw(s["port"], "align", dict(FASTA=mutated)) == raw(
                s["jax"], "align", dict(FASTA=mutated))
        strict = dict(FASTA=mutated, align=True, num_labels=100,
                      min_exact_match=0.99)
        # the strict request itself answers alike: 69 of 70 matches
        # fall short of 0.99, so neither aligns the read
        assert raw(s["port"], "search", strict) == raw(
            s["jax"], "search", strict)
        jax_after = json.loads(raw(s["jax"], "align", dict(FASTA=mutated)))
        port_after = json.loads(raw(s["port"], "align",
                                    dict(FASTA=mutated)))
        assert jax_after[0]["alignments"] == []          # the leak
        assert port_after[0]["alignments"][0]["cigar"] == "35=1X34="
    finally:
        s["jaligner"].config.min_exact_match = 0.7


def test_primary_graph_served_as_align(world, capsys, tmp_path):
    """JAX serves a primary graph unwrapped, where its CLI wraps it in
    CanonicalDbg: labels come out alike (the unwrapped graph folds each
    window too), but /align walks the stored orientation only and
    answers other paths than ``align``. The port serves it wrapped: its
    /align answers what ``align --json`` prints, and ``query --address``
    what ``query`` prints; /stats reports the stored graph (mode
    primary, its stored nodes) like the JAX server."""
    s = world["servers"]["primary"]
    q = world["qfa"]
    want = run(capsys, jmain, ["query", "-i", s["graph"], "-a", s["anno"],
                               q])
    assert want.count("sample_") >= 3
    for port in (s["port"], s["jax"]):
        assert run(capsys, tmain, ["query", "--address",
                                   f"127.0.0.1:{port}", q]) == want
    rc = world["recs"][0][20:90][::-1].translate(
        bytes.maketrans(b"ACGT", b"TGCA")).decode()
    named = world["aln"][:1] + [("rc", rc)]
    aln_fa = tmp_path / "aln.fa"
    aln_fa.write_text("".join(f">{n}\n{seq}\n" for n, seq in named))
    want = [json.loads(line) for line in run(
        capsys, jmain, ["align", "--json", "-i", s["graph"],
                        str(aln_fa)]).splitlines()]
    assert len(want) == len(named)

    def served(port):
        out = json.loads(raw(port, "align", dict(FASTA=fasta_of(named))))
        return [a for entry in out for a in entry["alignments"]]

    assert served(s["port"]) == want
    assert served(s["jax"]) != want                      # the fault
    stats = raw(s["port"], "stats")
    assert stats == raw(s["jax"], "stats")
    st = json.loads(stats)["graph"]
    assert st["mode"] == "primary"
    assert f"nodes (k): {st['nodes']}" in run(capsys, jmain,
                                              ["stats", s["graph"]])


@pytest.mark.parametrize("form", ["column", "row_diff_brwt"])
def test_query_address_identical(world, capsys, form):
    """query --address prints the JAX CLI's client-mode stdout against
    either server, and the JAX CLI's query -i -a stdout."""
    s = world["servers"][form]
    q = world["qfa"]
    for flags in ([], ["--discovery-fraction", "0.3", "--labels-delimiter",
                       ",", "--suppress-unlabeled"],
                  ["--num-top-labels", "1", "--discovery-fraction", "0"]):
        want = run(capsys, jmain, ["query", "--address",
                                   f"127.0.0.1:{s['jax']}", *flags, q])
        assert want
        assert run(capsys, tmain, ["query", "--address",
                                   f"127.0.0.1:{s['jax']}", *flags,
                                   q]) == want
        assert run(capsys, tmain, ["query", "--address",
                                   f"127.0.0.1:{s['port']}", *flags,
                                   q]) == want
        if not flags:
            assert run(capsys, jmain, ["query", "-i", s["graph"], "-a",
                                       s["anno"], q]) == want


def test_query_address_refuses_alike(world, capsys):
    s = world["servers"]["column"]
    argv = ["query", "--address", f"127.0.0.1:{s['port']}", "--count-labels",
            "--print-signature", "--fwd-and-reverse", world["qfa"]]
    with pytest.raises(SystemExit) as want:
        jmain(argv)
    with pytest.raises(SystemExit) as got:
        tmain(argv)
    assert str(got.value.code) == str(want.value.code)
    assert "not supported with --address" in str(got.value.code)
    with pytest.raises(SystemExit) as e:
        tmain(["query", world["qfa"], "--device", "cpu"])
    assert "--address" in str(e.value.code)


def test_clients_interoperate(world):
    """Each package's client against each server: the same records."""
    s = world["servers"]["column"]
    seqs = [seq for _, seq in world["reads"]]
    answers = []
    for mod in (jclient, tclient):
        for port in (s["jax"], s["port"]):
            c = mod.GraphClient("127.0.0.1", port)
            assert c.ready()
            answers.append((
                c.search(seqs, discovery_threshold=0.5),
                c.search(seqs[:4], with_signature=True, top_labels=2),
                c._json.search(seqs, abundance_sum=True)[0],
                c.align([seq for _, seq in world["aln"]]),
                c.column_labels(), c.stats()))
    assert all(a == answers[0] for a in answers[1:])
    assert any(r["sample"] == "sample_0" for r in answers[0][0])
    mc = tclient.MultiGraphClient()
    mc.add_graph("127.0.0.1", s["jax"], "jax")
    mc.add_graph("127.0.0.1", s["port"], "port")
    assert mc.list_graphs() == {"jax": ("127.0.0.1", s["jax"]),
                                "port": ("127.0.0.1", s["port"])}
    out = mc.search(seqs, discovery_threshold=0.5)
    assert out["jax"] == out["port"] == answers[0][0]
    assert mc.column_labels()["port"] == answers[0][4]
    assert not tclient.GraphClient("127.0.0.1", free_port()).ready()


def test_concurrent_requests(world):
    """8 requests at once (threads switching often) each answer as they
    do alone."""
    s = world["servers"]["row_diff_brwt"]
    reads = world["reads"]
    payloads = [dict(SEARCHES[kind], FASTA=fasta_of(reads[i:i + 6]))
                for i, kind in enumerate(["plain", "with_signature",
                                          "abundance_sum", "plain"] * 2)]
    want = [raw(s["port"], "search", p) for p in payloads]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            got = list(pool.map(lambda p: raw(s["port"], "search", p),
                                payloads, timeout=120))
    finally:
        sys.setswitchinterval(interval)
    assert got == want


def test_client_mode_needs_no_torch(world):
    """query --address loads no index, so it imports no torch: a client
    machine needs the package and the standard library alone."""
    import os
    import subprocess
    s = world["servers"]["column"]
    code = ("import sys\n"
            "from metagraph_tpu_torch.cli.main import main\n"
            f"main(['query', '--address', '127.0.0.1:{s['port']}', "
            f"{world['qfa']!r}])\n"
            "assert 'torch' not in sys.modules\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "sample_1" in res.stdout
