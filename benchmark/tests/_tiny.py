"""Sizes at which a cell runs on the CPU in a test."""

import json
import os

from benchmark import harness

ROOT = harness.ROOT
CONFIG = {"collection": {"kind": "strain_clusters", "species": 4,
                         "strains_per_species": 5, "record_bases": 800,
                         "strain_divergence": 0.01},
          "annotation": {"labels": "rec", "form": "row_diff_brwt",
                         "max_length": 64, "subsample": 1000}}
TRAFFIC = {"code_pool": {"pool": 3, "warm_calls": 1},
           "read_requests": {"reads_per_request": 64, "pool_requests": 3,
                             "warm_requests": 1}}
WORKLOAD = {"trace_calls": 2, "check_within": 2}
CELLS = ("build.dna31-primary", "query.dna31-canonical-rdbrwt")
SEED = (1 << 31) + 77


def tiny(cell, root=ROOT):
    """The overrides that cut ``cell`` to a test's size."""
    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    traffic = {w["name"]: w["traffic"] for w in spec["workloads"]}[cell]
    kind = json.load(open(os.path.join(root, "benchmark", "traffic",
                                       traffic + ".json")))["kind"]
    return {"config": CONFIG, "traffic": TRAFFIC.get(kind, {}),
            "workload": WORKLOAD}


def run(cell, seconds=1.0, trace=False, root=ROOT, seed=SEED):
    return harness.run_cell(cell, seed, seconds, trace, device="cpu",
                            root=root, overrides=tiny(cell, root),
                            log=lambda m: None)


def bench_files(root=ROOT):
    out = []
    for d, _, files in os.walk(os.path.join(root, "benchmark")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)
