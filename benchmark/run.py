#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the machine's CUDA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Prints the numbers compared with the reference, each beside its limit,
as the last lines of standard error, and the result as one JSON object on
the last line of standard output. Exits non-zero, printing no result,
without the CUDA cards the cell asks for, or when JAX or the JAX package
was loaded. Build and kernel caches stay inside the checkout.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args()

    for var, sub in (("CUDA_CACHE_PATH", "nv"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(CACHE, sub)
    sys.path.insert(0, ROOT)
    from benchmark import harness
    cell = harness.Cell(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available():
        sys.exit("benchmark: no CUDA device; the benchmark runs on the card")
    if torch.cuda.device_count() < cell.chips:
        sys.exit(f"benchmark: {args.workload} needs {cell.chips} CUDA "
                 f"devices, {torch.cuda.device_count()} present")
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda", root=ROOT,
                              t_process=T_PROCESS)
    bad = harness.forbidden_modules()
    if bad:
        sys.exit(f"benchmark: the run loaded {', '.join(bad)}")
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
