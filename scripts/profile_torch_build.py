#!/usr/bin/env python3
"""Where the time of the PyTorch port's build and query goes, on one GPU.

    python scripts/profile_torch_build.py [--k 20]
        [--mode basic|canonical|primary]
        [--log2-codes 25] [--reads 32768] [--out profile_out]

Builds a graph from 2^log2-codes random ACGT codes (numpy
default_rng(0), the input of bench.py's capacity cell) with
metagraph_tpu_torch on device "cuda", then:
  * host wall time per stage of a warm build (collect, finish, from_finish)
    and of a warm query batch, each closed by torch.cuda.synchronize();
  * a torch.profiler trace of one more build and one query batch: the
    device time by kernel (top 25), the device busy time (union of kernel
    intervals) against the wall time, and a Chrome trace in --out.
Prints the card's name and power limit first.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def busy_ms(events):
    """Union length of the device kernel intervals, in ms."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--mode", default="basic")
    p.add_argument("--log2-codes", type=int, default=25)
    p.add_argument("--reads", type=int, default=1 << 15)
    p.add_argument("--out", default=os.path.join(ROOT, "profile_out"),
                   help="directory for the Chrome traces")
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_build: needs a CUDA device")
    from metagraph_tpu_torch.anno.annotator import ColumnAnnotator
    from metagraph_tpu_torch.engine.annotated_dbg import (AnnotatedDbg,
                                                          BatchQuery)
    from metagraph_tpu_torch.graph import boss_construct as bc
    from metagraph_tpu_torch.graph.canonical import CanonicalDbg
    from metagraph_tpu_torch.graph.dbg_succinct import DbgSuccinct

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = "cuda"
    n = 1 << args.log2_codes
    rng = np.random.default_rng(0)
    codes = rng.integers(1, 5, n).astype(np.uint8)
    K, mode = args.k, args.mode

    def build():
        t = {}
        torch.cuda.synchronize()
        t0 = time.time()
        # primary: canonical forms, then the basic finish without
        # boundary candidates (the sorts over all real edges)
        real, counts, n_u, bounds = bc.collect_kmers(
            [], K, canonical=mode != "basic", extra_codes=codes,
            device=dev, with_bounds=mode != "primary")
        torch.cuda.synchronize()
        t["collect"] = time.time() - t0
        t0 = time.time()
        boss = bc.build_boss_from_kmers(
            real, counts, n_u, K,
            mode="basic" if mode == "primary" else mode, bounds=bounds)
        torch.cuda.synchronize()
        t["finish+from_finish"] = time.time() - t0
        return boss, t

    build()                                             # warm
    boss, t = build()
    total = sum(t.values())
    print(f"build k={K} {mode} 2^{args.log2_codes} codes, warm: "
          + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in t.items())
          + f"; total {total * 1e3:.1f} ms = "
          f"{(n - K + 1) / total / 1e6:.2f} M k-mers/s", flush=True)

    graph = DbgSuccinct.from_boss(boss, mode=mode)
    if mode == "primary":
        graph = CanonicalDbg(base=graph)
    # one label per 1/16 of the input, all rows: the query's matrix shape
    ann = ColumnAnnotator(graph.num_anno_rows(), device=dev)
    rows = np.arange(graph.num_anno_rows(), dtype=np.int64)
    for c, part in enumerate(np.array_split(rows, 16)):
        ann.add(part, f"label_{c}")
    bq = BatchQuery(AnnotatedDbg(graph=graph, annotation=ann.finalize()))
    letters = np.frombuffer(b"ACGT", np.uint8)
    starts = rng.integers(0, n - 100, args.reads // 2)
    reads = [letters[codes[s:s + 100] - 1].tobytes() for s in starts]
    reads += [letters[rng.integers(0, 4, 100)].tobytes()
              for _ in range(args.reads - len(reads))]
    bq.get_labels_batch(reads, 0.7)                    # warm
    tq = {}
    torch.cuda.synchronize()
    t0 = time.time()
    bq._map_batch(reads)
    torch.cuda.synchronize()
    tq["map (encode, device map, host slicing)"] = time.time() - t0
    t0 = time.time()
    bq.get_labels_batch(reads, 0.7)
    torch.cuda.synchronize()
    tq["get_labels_batch (all)"] = time.time() - t0
    print(f"query {args.reads} reads of 100 bp, warm: "
          + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in tq.items())
          + f"; {args.reads / tq['get_labels_batch (all)']:.0f} reads/s",
          flush=True)

    os.makedirs(args.out, exist_ok=True)
    summary = {}
    for name, fn in (("build", lambda: build()),
                     ("query", lambda: bq.get_labels_batch(reads, 0.7))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            wall = (time.time() - t0) * 1e3
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = busy_ms(kern)
        print(f"\n== {name}: wall {wall:.1f} ms (profiled), device busy "
              f"{busy:.1f} ms, idle share {1 - busy / wall:.3f}")
        print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                        row_limit=25, max_name_column_width=60))
        # the hand-written kernels' share (sort_packed: its histogram and
        # pass kernels)
        for label, keys in (("sort_packed", ("radix_hist_kernel",
                                             "radix_pass_kernel")),
                            ("partition_compact", ("partition_kernel",)),
                            ("merge_sorted", ("splits_kernel", "merge_kernel"))):
            ev = [e for e in kern if any(k in e.name for k in keys)]
            ms = sum(e.time_range.end - e.time_range.start
                     for e in ev) / 1e3
            print(f"{label}: {len(ev)} kernels, {ms:.1f} ms device, "
                  f"{ms / busy:.3f} of device busy time")
        prof.export_chrome_trace(os.path.join(args.out, f"{name}_k{K}_"
                                              f"{mode}.json"))
        summary[name] = {"wall_ms": wall, "device_busy_ms": busy}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
