#!/usr/bin/env python3
"""Time the distributed build (``chip_smoke.py`` phase 3j) on its own.

    python scripts/time_torch_distributed.py [--runs 1:nccl,4:gloo]
                                             [--no-native]

Builds 3a's graphs first (2^25 random ACGT codes, numpy default_rng(0);
k = 31 canonical and k = 20 basic, in core, cold then warm): they are
the reference every distributed graph must equal. Then runs
``chip_smoke.phase_distributed`` at each width:backend of ``--runs``
(default: width 1 over NCCL, width 4 over gloo on one card, and width 4
over NCCL one card a rank where there are four cards), with its log
lines (warm and cold walls, edges and peak memory per rank, bytes and
host seconds per route, launches per rank), and, unless
``--no-native``, the native codec's parse against ``seqio/fasta.py``.
Prints the card's name and power limit first. Needs one NVIDIA GPU per
NCCL rank.
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", default=None,
                    help="width:backend pairs, comma separated")
    ap.add_argument("--no-native", action="store_true")
    args = ap.parse_args()
    import torch
    from metagraph_tpu_torch.common import _cuda
    if not torch.cuda.is_available():
        raise SystemExit("time_torch_distributed: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    cs.log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
           f"{torch.cuda.device_count()} card(s)")
    t0 = time.time()
    _cuda.lib()
    cs.log(f"kernels built and loaded in {time.time() - t0:.1f} s")
    codes = np.random.default_rng(cs.SEED).integers(
        1, 5, cs.N_CODES).astype(np.uint8)
    ref = {}
    for K, mode in cs.DIST_BUILDS:
        boss, _ = cs.timed_build(codes, K, mode, "cuda")
        del boss
        boss, warm = cs.timed_build(codes, K, mode, "cuda")
        ref[K, "ref"] = cs.host_boss(boss)
        ref[K, "warm"] = warm
        cs.log(f"in-core k={K} {mode}: {boss.num_edges} edges, warm "
               f"{warm:.3f} s")
        del boss
        torch.cuda.empty_cache()
    runs = None
    if args.runs:
        runs = [(int(w), b) for w, b in
                (r.split(":") for r in args.runs.split(","))]
    launches = cs.phase_distributed(ref, runs,
                                    native=not args.no_native)
    cs.log(f"launches over every rank: {launches}")


if __name__ == "__main__":
    main()
