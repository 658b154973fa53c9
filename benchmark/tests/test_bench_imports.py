"""Nothing the benchmark runs loads JAX or the JAX package: no module
under benchmark/ imports one (top-level names compared whole, since the
port's name begins with the JAX package's), and a run of a cell leaves
none of them in sys.modules."""

import ast
import json
import os
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests._tiny import ROOT, bench_files

FORBIDDEN = {"jax", "jaxlib", "flax", "metagraph_tpu"}


def _top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", bench_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not set(_top_level_imports(path)) & FORBIDDEN


def test_names_compared_whole():
    assert "metagraph_tpu_torch".split(".")[0] not in FORBIDDEN
    assert set(harness.FORBIDDEN) == FORBIDDEN


def test_probe_targets_are_the_port():
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for m in spec["per_layer"]:
        for p in getattr(harness.Cell(m["workloads"][0], ROOT).metric(
                m["name"]), "PROBES", ()):
            target = p.get("target") or p["counter"]
            assert target.split(".")[0].split(":")[0] == "metagraph_tpu_torch"


def test_a_run_loads_neither():
    code = ("import sys, json; sys.path.insert(0, %r)\n"
            "from benchmark import harness\n"
            "from benchmark.tests._tiny import run\n"
            "r = run('query.dna31-canonical-rdbrwt', trace=True)\n"
            "print(json.dumps([r['correct'], harness.forbidden_modules()]))"
            % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, []]


def test_run_py_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
         "--workload", "build.dna31-primary", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout == ""
