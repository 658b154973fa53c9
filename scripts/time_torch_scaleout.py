#!/usr/bin/env python3
"""Time the scale-out builds' passes and finishes on one GPU.

    python scripts/time_torch_scaleout.py [--log2-n 25] [--out FILE]

On 2^log2-n random ACGT codes (numpy default_rng(0), chip_smoke.py's
main-path input):

  * the finish of ``build_boss_from_kmers`` at k = 20 with the collect's
    boundary candidates (the in-core build) and without them (the finish
    of the sharded and streaming builds): seconds and peak device bytes;
  * ``build_boss_out_of_core`` at k = 20, 8 shards, 2^23-code pass-1
    chunks, twice, with the end of each pass from its log;
  * ``build_boss_streaming`` at k = 31 canonical, 2^22-code chunks, runs
    spilled to disk and in RAM, in turns, twice each.

Each result must equal the in-core build's W and last. Prints the card's
name and power limit, then one JSON line per run (wall seconds, closed by
a synchronize; the out-of-core build's pass timings from its log), and
writes them to FILE when given.
"""

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--log2-n", type=int, default=25)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_torch_scaleout: needs one NVIDIA GPU")
    sys.path.insert(0, ROOT)
    from metagraph_tpu_torch.graph.boss_construct import (
        build_boss_from_codes, build_boss_from_kmers, collect_kmers)
    from metagraph_tpu_torch.parallel.outofcore import build_boss_out_of_core
    from metagraph_tpu_torch.parallel.streaming import build_boss_streaming
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    codes = np.random.default_rng(0).integers(
        1, 5, 1 << args.log2_n).astype(np.uint8)
    rows = []

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t0

    def check(boss, ref, what):
        if not (torch.equal(boss.W.cpu(), ref.W.cpu())
                and torch.equal(boss.last, ref.last)):
            raise AssertionError(f"{what}: differs from the in-core build")

    # the whole-graph finish the sharded and streaming builds end in
    # (no boundary candidates) against the in-core build's probe finish
    for bounds in (True, False):
        ul, uc, n, bd = collect_kmers((), 20, extra_codes=codes,
                                      device="cuda", with_bounds=bounds)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        boss, secs = timed(lambda: build_boss_from_kmers(ul, uc, n, 20,
                                                         bounds=bd))
        peak = torch.cuda.max_memory_allocated() - base
        rows.append(dict(what="finish k=20 basic", candidates=bounds,
                         seconds=secs, peak_gib=peak / 2**30))
        print(json.dumps(rows[-1]), flush=True)
        del ul, uc, bd, boss
    ref = build_boss_from_codes(codes, 20, device="cuda")
    for rep in range(2):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            boss, secs = timed(lambda: build_boss_out_of_core(
                [codes], 20, n_shards=8, chunk_codes=(1 << 23) + 64,
                verbose=True, device="cuda"))
        check(boss, ref, "out-of-core")
        passes = {m.group(2): float(m.group(1)) for m in re.finditer(
            r"\+\s*([\d.]+)s\] (\w+)", err.getvalue())}
        rows.append(dict(what="out_of_core k=20", rep=rep, seconds=secs,
                         pass_end_s=passes))
        print(json.dumps(rows[-1]), flush=True)
        del boss
    del ref
    ref = build_boss_from_codes(codes, 31, mode="canonical", device="cuda")
    for rep in range(2):
        for disk in (True, False):
            with tempfile.TemporaryDirectory(dir=ROOT) as swap:
                boss, secs = timed(lambda: build_boss_streaming(
                    [codes], 31, mode="canonical", chunk_codes=1 << 22,
                    disk_dir=swap if disk else None, device="cuda"))
            check(boss, ref, "streaming")
            rows.append(dict(what="streaming k=31 canonical", rep=rep,
                             disk=disk, seconds=secs))
            print(json.dumps(rows[-1]), flush=True)
            del boss
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in rows))


if __name__ == "__main__":
    main()
