"""HTTP JSON query server (``server_query``).

PyTorch counterpart of ``metagraph_tpu/server/http_server.py`` (the
reference's Simple-Web-Server, metagraph/src/cli/server.cpp:328-414): a
stdlib ``ThreadingHTTPServer`` with POST /search, POST /align,
GET /column_labels and GET /stats, answering with the JSON the JAX
package's server writes, byte for byte (the same ``json.dumps``), so
either package's client talks to either server.

Two faults of the JAX server are repaired here:

  * it writes a request's ``min_exact_match`` into the aligner's shared
    config, so later requests that send none inherit it (and threads
    race on it); here each request's value is passed to its own
    ``align_batch`` call and the shared config is never written;
  * ``run_server`` loads a primary graph unwrapped, so reads whose
    k-mers are stored in the other orientation go unlabelled and
    unaligned where ``query`` and ``align`` find them; here the server
    loads as ``query`` does (``graph.io.load_query_graph``:
    ``CanonicalDbg`` around a primary graph), and
    its answers are those of ``query``. ``/stats`` reports the stored
    graph, as the JAX server and ``stats`` do: mode ``primary`` and its
    stored nodes.

Requests run on the device the graph lives on; with a CUDA graph the
kernels are built and loaded before the first request is accepted.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..engine.annotated_dbg import BatchQuery


class QueryService:
    """The shared, read-only graph and annotation, and each endpoint's
    answer as a JSON-ready object."""

    def __init__(self, adbg, aligner=None):
        self.adbg = adbg
        self.aligner = aligner
        self.batch_query = BatchQuery(adbg)

    def _align(self, seqs, **kw):
        return self.aligner.align_batch([s.encode() for s in seqs], **kw)

    def search(self, payload: dict) -> list:
        """POST /search (reference process_search_request,
        server.cpp:126-193): top labels with their k-mer counts (or
        ``abundance_sum``: the annotation's counts summed), optionally
        after aligning each read (``align``: the read is replaced by its
        best path's spelling) and with per-label presence signatures
        (``with_signature``)."""
        discovery = float(payload.get("discovery_fraction", 0.7))
        num_labels = int(payload.get("num_labels", 2 ** 32))
        with_counts = bool(payload.get("abundance_sum", False))
        with_signature = bool(payload.get("with_signature", False))
        records = list(_parse_fasta_string(payload["FASTA"]))
        aligned = [None] * len(records)
        if payload.get("align", False) and self.aligner is not None:
            min_exact = float(payload.get(
                "min_exact_match", self.aligner.config.min_exact_match))
            batches = self._align([seq for _, seq in records],
                                  min_exact_match=min_exact)
            for i, res in enumerate(batches):
                if res:
                    aligned[i] = res[0]
                    records[i] = (records[i][0], res[0].sequence.decode())
        seqs = [seq.encode() for _, seq in records]
        if with_signature:
            tops_all = self.batch_query.get_top_label_signatures_batch(
                seqs, num_labels, discovery)
            results_of = _signature_results
        else:
            tops_all = self.batch_query.get_top_labels_batch(
                seqs, num_labels, discovery, with_kmer_counts=with_counts)
            results_of = _count_results
        results = []
        for (name, seq), tops, aln in zip(records, tops_all, aligned):
            entry = {"seq_description": name, "results": results_of(tops)}
            if aln is not None:
                entry["sequence"] = seq
                entry["score"] = int(aln.score)
                entry["cigar"] = aln.cigar
            results.append(entry)
        return results

    def align(self, payload: dict) -> list:
        """POST /align: each read's alignments (``to_json``), at most
        ``max_alternative_alignments`` of them."""
        records = list(_parse_fasta_string(payload["FASTA"]))
        if self.aligner is not None:
            batches = self._align(
                [seq for _, seq in records],
                num_alternative_paths=int(
                    payload.get("max_alternative_alignments", 1)))
        else:
            batches = [[] for _ in records]
        return [{
            "seq_description": name,
            "alignments": [a.to_json(name) for a in alignments],
        } for (name, _seq), alignments in zip(records, batches)]

    def column_labels(self) -> list:
        return self.adbg.annotation.encoder.labels

    def stats(self) -> dict:
        # the stored graph: a primary graph's wrapper reports the base's
        # mode and nodes, as the JAX server (which serves it unwrapped)
        g = getattr(self.adbg.graph, "base", self.adbg.graph)
        return {
            "graph": {
                "k": g.k,
                "nodes": int(g.num_nodes()),
                "mode": g.mode,
            },
            "annotation": {
                "labels": self.adbg.num_labels,
                "objects": self.adbg.annotation.matrix.num_rows,
                "relations": self.adbg.annotation.matrix.nnz,
            },
        }


def _count_results(tops) -> list:
    return [{"sample": label, "kmer_count": int(count)}
            for label, count in tops]


def _signature_results(tops) -> list:
    return [{"sample": label, "kmer_count": int(mask.sum()),
             "signature": "".join("1" if b else "0" for b in mask)}
            for label, mask in tops]


def _parse_fasta_string(s: str):
    """(name, sequence) of each record of a FASTA string."""
    name, chunks = None, []
    for line in s.splitlines():
        if line.startswith(">"):
            if name is not None:
                yield name, "".join(chunks)
            name, chunks = line[1:].strip(), []
        else:
            chunks.append(line.strip())
    if name is not None:
        yield name, "".join(chunks)


def make_handler(service: QueryService):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            try:
                if self.path == "/column_labels":
                    self._send(service.column_labels())
                elif self.path == "/stats":
                    self._send(service.stats())
                else:
                    self._send({"error": "not found"}, 404)
            except Exception as e:     # as the reference: report, serve on
                self._send({"error": str(e)}, 500)

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/search":
                    self._send(service.search(payload))
                elif self.path == "/align":
                    self._send(service.align(payload))
                else:
                    self._send({"error": "not found"}, 404)
            except Exception as e:
                self._send({"error": str(e)}, 500)

        def log_message(self, fmt, *args):     # no access log
            pass

    return Handler


def serve(adbg, aligner=None, host="127.0.0.1", port=5555,
          background=False) -> Optional[ThreadingHTTPServer]:
    """Serve ``adbg`` (and ``aligner``) on host:port (0: any free port):
    forever, or with ``background`` from a daemon thread, returning the
    server (its ``server_address``; stop it with ``shutdown()``)."""
    service = QueryService(adbg, aligner)
    if adbg.graph.device.type == "cuda":
        # every kernel built and loaded before the first request, so two
        # first requests cannot both build them
        from ..common import _cuda
        _cuda.lib()
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    if background:
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        return httpd
    httpd.serve_forever()
    return None


def run_server(args):
    """``server_query -i GRAPH -a ANNOTATION --host --port --device``."""
    from ..align.aligner import Aligner
    from ..anno.annotator import Annotation
    from ..engine.annotated_dbg import AnnotatedDbg
    from ..graph.io import load_query_graph

    g = load_query_graph(args.infile_base, device=args.device)
    ann = Annotation.load(args.annotation, device=args.device)
    print(f"[{time.strftime('%H:%M:%S')}] Serving {args.infile_base} at "
          f"http://{args.host}:{args.port}", file=sys.stderr, flush=True)
    serve(AnnotatedDbg(graph=g, annotation=ann), Aligner(g),
          host=args.host, port=args.port)
