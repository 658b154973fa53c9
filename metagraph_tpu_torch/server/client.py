"""Python client of the query server (stdlib only: no tensors).

Counterpart of ``metagraph_tpu/server/client.py`` (the reference's
Python client, metagraph/api/python/metagraph/client.py:21-215):
``GraphClientJson`` returns the raw JSON, ``GraphClient`` flat records,
``MultiGraphClient`` fans out over several servers. It speaks the
server's wire format, so it talks to the JAX package's server as to the
port's, and the JAX package's client to the port's server.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Dict, Iterable, List, Tuple, Union

DEFAULT_DISCOVERY_FRACTION = 0.7


def _to_fasta(sequences: Union[str, Iterable[str]]) -> str:
    if isinstance(sequences, str):
        sequences = [sequences]
    return "\n".join(f">{i}\n{s}" for i, s in enumerate(sequences))


class GraphClientJson:
    """Raw JSON client (reference client.py:21): each call returns
    (decoded JSON, HTTP status)."""

    def __init__(self, host: str, port: int, name: str = "",
                 api_path: str = ""):
        self.host = host
        self.port = port
        self.name = name if name else f"{host}:{port}"
        self.server = f"http://{host}:{port}{api_path or ''}"

    def _post(self, endpoint: str, payload: dict):
        req = urllib.request.Request(
            f"{self.server}/{endpoint}",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as r:
            return json.loads(r.read()), r.status

    def _get(self, endpoint: str):
        with urllib.request.urlopen(f"{self.server}/{endpoint}") as r:
            return json.loads(r.read()), r.status

    def search(self, sequence: Union[str, Iterable[str]],
               top_labels: int = 100,
               discovery_threshold: float = DEFAULT_DISCOVERY_FRACTION,
               with_signature: bool = False,
               abundance_sum: bool = False,
               query_coords: bool = False,
               align: bool = False) -> Tuple[list, int]:
        payload = {
            "FASTA": _to_fasta(sequence),
            "num_labels": top_labels,
            "discovery_fraction": discovery_threshold,
            "with_signature": with_signature,
            "abundance_sum": abundance_sum,
            "query_coords": query_coords,
            "align": align,
        }
        return self._post("search", payload)

    def align(self, sequence: Union[str, Iterable[str]],
              min_exact_match: float = 0.7,
              max_alternative_alignments: int = 1) -> Tuple[list, int]:
        payload = {
            "FASTA": _to_fasta(sequence),
            "min_exact_match": min_exact_match,
            "max_alternative_alignments": max_alternative_alignments,
        }
        return self._post("align", payload)

    def column_labels(self) -> Tuple[list, int]:
        return self._get("column_labels")

    def stats(self) -> Tuple[dict, int]:
        return self._get("stats")

    def ready(self) -> bool:
        try:
            self.stats()
            return True
        except Exception:
            return False


class GraphClient:
    """Record-shaped client (reference client.py:136 returns DataFrames;
    here lists of flat dicts, one per result, which
    ``pandas.DataFrame(records)`` takes as they are)."""

    def __init__(self, host: str, port: int, name: str = "",
                 api_path: str = ""):
        self._json = GraphClientJson(host, port, name, api_path)
        self.name = self._json.name

    def search(self, sequence, **kwargs) -> List[dict]:
        raw, _ = self._json.search(sequence, **kwargs)
        records = []
        for entry in raw:
            for res in entry.get("results", []):
                rec = dict(res)
                rec["seq_description"] = entry["seq_description"]
                records.append(rec)
        return records

    def align(self, sequence, **kwargs) -> List[dict]:
        raw, _ = self._json.align(sequence, **kwargs)
        records = []
        for entry in raw:
            for aln in entry.get("alignments", []):
                rec = dict(aln)
                rec["seq_description"] = entry["seq_description"]
                records.append(rec)
        return records

    def column_labels(self) -> List[str]:
        return self._json.column_labels()[0]

    def stats(self) -> dict:
        return self._json.stats()[0]

    def ready(self) -> bool:
        return self._json.ready()


class MultiGraphClient:
    """Fan-out client over several graph servers (reference client.py:172)."""

    def __init__(self):
        self.graphs: Dict[str, GraphClient] = {}

    def add_graph(self, host: str, port: int, name: str = "",
                  api_path: str = ""):
        client = GraphClient(host, port, name, api_path)
        self.graphs[client.name] = client

    def list_graphs(self) -> Dict[str, Tuple[str, int]]:
        return {name: (c._json.host, c._json.port)
                for name, c in self.graphs.items()}

    def search(self, sequence, **kwargs) -> Dict[str, List[dict]]:
        return {name: c.search(sequence, **kwargs)
                for name, c in self.graphs.items()}

    def align(self, sequence, **kwargs) -> Dict[str, List[dict]]:
        return {name: c.align(sequence, **kwargs)
                for name, c in self.graphs.items()}

    def column_labels(self) -> Dict[str, List[str]]:
        return {name: c.column_labels()
                for name, c in self.graphs.items()}
