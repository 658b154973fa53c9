#!/usr/bin/env python3
"""Read the control of a cell: the plain reference with one guarantee
of the configuration broken, put in the program's place on the cell's
own traffic, judged by the cell's own comparison. It has to come out not
correct; its smallest readings over the seeds are the upper readings
that the limits lie below.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3
        [--device cuda]

Prints one JSON line per seed: the numbers compared, each with its
limit.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--requests", type=int, default=None,
                   help="requests of a query cell (default: its pool)")
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    from benchmark import harness
    cell = harness.Cell(args.workload, ROOT)
    entry = cell.entry()
    log = lambda m: print(m, file=sys.stderr, flush=True)  # noqa: E731
    for seed in (int(x) for x in args.seeds.split(",")):
        kw = {"requests": args.requests} if args.requests else {}
        checks = entry.control(cell, seed, args.device, log, **kw)
        failed = [k for k, c in checks.items() if c["value"] > c["limit"]]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": not failed, "checks": checks}),
              flush=True)


if __name__ == "__main__":
    main()
