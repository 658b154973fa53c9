#!/usr/bin/env python3
"""Where the time of the PyTorch port's alignment goes, on one GPU.

    python scripts/profile_torch_align.py [--log2-codes 25] [--reads 8192]
        [--out profile_out]

Builds a k = 20 basic graph from 2^log2-codes random ACGT codes (numpy
default_rng(0), as chip_smoke.py does) with metagraph_tpu_torch on
device "cuda", cuts reads of 100 bp with chip_smoke.py's mix (3/4 one
transversion, 1/8 an indel, 1/8 random), then, for align_batch with
CIGARs and score-only:
  * the warm wall time and reads/s, closed by torch.cuda.synchronize();
  * the wall time per aligner stage (seeding map, suffix seeds, beam
    extension, DP ends / CIGARs, spelling), each closed by a synchronize;
  * a torch.profiler trace of one more warm run: device time by kernel
    (top 25), device busy time (union of kernel intervals) against the
    wall time, and a Chrome trace in --out.
Prints the card's name and power limit first.
"""

import argparse
import collections
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--log2-codes", type=int, default=25)
    p.add_argument("--reads", type=int, default=1 << 13)
    p.add_argument("--out", default=os.path.join(ROOT, "profile_out"),
                   help="directory for the Chrome traces")
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_align: needs a CUDA device")
    from chip_smoke import align_reads
    from metagraph_tpu_torch.align import aligner as aligner_mod
    from metagraph_tpu_torch.graph.boss_construct import build_boss_from_codes
    from metagraph_tpu_torch.graph.dbg_succinct import DbgSuccinct
    from profile_torch_build import busy_ms

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    rng = np.random.default_rng(0)
    codes = rng.integers(1, 5, 1 << args.log2_codes).astype(np.uint8)
    graph = DbgSuccinct.from_boss(build_boss_from_codes(
        codes, 20, mode="basic", device="cuda"), mode="basic")
    reads, _, _ = align_reads(codes, args.reads, rng)
    al = aligner_mod.Aligner(graph)

    # per-stage wall time: wrap the aligner's stages with synchronized
    # timers (module function and bound methods of this instance only)
    stage_s = collections.defaultdict(float)

    def timed(name, fn):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            stage_s[name] += time.time() - t0
            return out
        return wrapper

    aligner_mod._map_batch_nodes = timed("seed map",
                                         aligner_mod._map_batch_nodes)
    for name, attr in (("suffix seeds", "_suffix_seeds_batch"),
                       ("beam extension", "_extend"),
                       ("DP ends / CIGARs", "_dp_ends"),
                       ("spelling", "_spell_batch")):
        setattr(al, attr, timed(name, getattr(al, attr)))

    os.makedirs(args.out, exist_ok=True)
    summary = {}
    for with_cigar in (True, False):
        what = "cigar" if with_cigar else "score_only"
        al.align_batch(reads, with_cigar=with_cigar)          # warm
        stage_s.clear()
        torch.cuda.synchronize()
        t0 = time.time()
        al.align_batch(reads, with_cigar=with_cigar)
        torch.cuda.synchronize()
        wall = time.time() - t0
        stage_ms = {k: v * 1e3 for k, v in stage_s.items()}
        stages = ", ".join(f"{k} {v:.1f} ms" for k, v in stage_ms.items())
        print(f"\n== align_batch {what}: {len(reads)} reads in "
              f"{wall * 1e3:.1f} ms = {len(reads) / wall:.1f} reads/s; "
              f"stages: {stages}; rest "
              f"{wall * 1e3 - sum(stage_ms.values()):.1f} ms", flush=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            al.align_batch(reads, with_cigar=with_cigar)
            torch.cuda.synchronize()
            pwall = (time.time() - t0) * 1e3
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = busy_ms(kern)
        dp_ms = sum(e.time_range.end - e.time_range.start for e in kern
                    if "align_kernel" in e.name) / 1e3
        print(f"profiled wall {pwall:.1f} ms, device busy {busy:.1f} ms, "
              f"idle share {1 - busy / pwall:.3f}; pallas_dp kernel "
              f"(csrc/align_dp.cu) {dp_ms:.3f} ms")
        print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                        row_limit=25,
                                        max_name_column_width=60))
        prof.export_chrome_trace(os.path.join(args.out, f"align_{what}.json"))
        summary[what] = {"wall_ms": wall * 1e3,
                         "reads_per_s": len(reads) / wall,
                         "stage_ms": stage_ms,
                         "profiled_wall_ms": pwall, "device_busy_ms": busy,
                         "dp_kernel_ms": dp_ms}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
