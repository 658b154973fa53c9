#!/usr/bin/env python3
"""Time partition_compact and merge_sorted past 8 lanes on one GPU.

    python scripts/time_torch_wide_lanes.py [--root DIR] [--label NAME]
        [--lanes 9,12,16] [--log2-n 25] [--build] [--json PATH]

Imports ``metagraph_tpu_torch`` from ``--root`` (default: this checkout),
so that two checkouts can be timed in turns in one process each on the
same card. At 2^log2-n entries (torch generator, seed 0; high lanes of
few values and 1 % PAD columns, as ``chip_smoke.py`` phase 2 makes them)
it checks each call bit for bit against the plain version, then prints
the median of 10 (CUDA events, after a warm-up) of:

  * ``partition_compact`` at each L, keep 0.5, one payload, beside
    ``stacked[:, keep]`` (the library yardstick, which writes no PAD
    tail) and the bytes bound;
  * ``merge_sorted`` at each L, one payload a side, |A| = 2^log2-n with
    |B| = 2^12 and |B| = |A|, beside the bytes bound;
  * with ``--build``: the k = 65 canonical build of 2^25 random ACGT
    codes (``default_rng(0)``, ``chip_smoke.py`` 3a-wide's), one cold and
    three warm host walls closed by a synchronize, and the warm build's
    launches.

Prints the card's name and power limit first; with ``--json`` appends
one JSON object of every number to PATH.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12


def median_ms(fn, reps=10):
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def bound_ms(nbytes):
    return nbytes / HBM_BYTES_PER_S * 1e3


def wide_lanes(gen, n, L):
    import torch
    from metagraph_tpu_torch.common import packed
    x = torch.randint(-2**31, 2**31, (L, n), generator=gen,
                      dtype=torch.int64, device="cuda").to(torch.int32)
    x[: L // 2] &= 3
    x[:, torch.rand(n, generator=gen, device="cuda") < 0.01] = \
        packed.PAD_LANE
    return x


def same(got, want):
    import torch
    return all(torch.equal(g, w) for g, w in zip(got, want))


def time_partition(gen, n, L):
    import torch
    from metagraph_tpu_torch.common import merge
    x = wide_lanes(gen, n, L)
    keep = torch.rand(n, generator=gen, device="cuda") < 0.5
    ex = torch.arange(n, dtype=torch.int32, device="cuda")
    got = merge.partition_compact(x, keep, n, ex)
    want = merge.partition_compact_plain(x, keep, n, ex)
    ok = same([got[0], got[1], *got[2]], [want[0], want[1], *want[2]])
    p0 = merge.partition_launches
    merge.partition_compact(x, keep, n, ex)
    launches = merge.partition_launches - p0
    ms = median_ms(lambda: merge.partition_compact(x, keep, n, ex))
    stacked = torch.cat([x, ex[None]])
    lib_ms = median_ms(lambda: stacked[:, keep])
    nbytes = (4 * (L + 1) + 1) * n + 4 * (L + 1) * n + 4
    return {"L": L, "ok": ok, "launches_per_call": launches, "ms": ms,
            "library_ms": lib_ms, "bound_ms": bound_ms(nbytes)}


def time_merge(gen, n, nb, L):
    import torch
    from metagraph_tpu_torch.common import merge
    a, _ = merge.sort_packed_plain(wide_lanes(gen, n, L))
    b, _ = merge.sort_packed_plain(wide_lanes(gen, nb, L))
    ea = (torch.arange(n, dtype=torch.int32, device="cuda"),)
    eb = (torch.arange(n, n + nb, dtype=torch.int32, device="cuda"),)
    got, (gp,) = merge.merge_sorted(a, b, ea, eb)
    want, (wp,) = merge.merge_sorted_plain(a, b, ea, eb)
    ok = same([got, gp], [want, wp])
    del got, gp, want, wp
    ms = median_ms(lambda: merge.merge_sorted(a, b, ea, eb))
    return {"L": L, "nb": nb, "ok": ok, "ms": ms,
            "bound_ms": bound_ms(2 * 4 * (L + 1) * (n + nb))}


def time_build():
    import torch
    from metagraph_tpu_torch.common import merge
    from metagraph_tpu_torch.graph.boss_construct import build_boss_from_codes
    codes = np.random.default_rng(0).integers(1, 5, 1 << 25).astype(np.uint8)

    def run():
        torch.cuda.synchronize()
        t = time.perf_counter()
        boss = build_boss_from_codes(codes, 65, mode="canonical",
                                     device="cuda")
        torch.cuda.synchronize()
        return time.perf_counter() - t, boss.num_edges

    cold, edges = run()
    warm = []
    for _ in range(3):
        merge.partition_launches = merge.merge_launches = 0
        merge.sort_launches = 0
        t, _ = run()
        warm.append(t)
        torch.cuda.empty_cache()
    return {"edges": int(edges), "cold_s": cold, "warm_s": warm,
            "launches": {"partition_compact": merge.partition_launches,
                         "merge_sorted": merge.merge_launches,
                         "sort_packed": merge.sort_launches}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--label", default="")
    ap.add_argument("--lanes", default="9,12,16")
    ap.add_argument("--log2-n", type=int, default=25)
    ap.add_argument("--build", action="store_true")
    ap.add_argument("--json")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_torch_wide_lanes: needs a CUDA device")
    from metagraph_tpu_torch.common import _cuda
    import metagraph_tpu_torch
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(f"[{args.label}] package {metagraph_tpu_torch.__file__}",
          flush=True)
    _cuda.lib()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    n = 1 << args.log2_n
    res = {"label": args.label, "device": torch.cuda.get_device_name(0),
           "partition": [], "merge": []}
    for L in (int(v) for v in args.lanes.split(",")):
        r = time_partition(gen, n, L)
        res["partition"].append(r)
        print(f"[{args.label}] partition_compact L={L} N=2^{args.log2_n} "
              f"keep=0.5 E=1: bit-exact {r['ok']}, "
              f"{r['launches_per_call']} launches a call, {r['ms']:.4f} ms, "
              f"x[:, keep] {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms", flush=True)
        for nb in (1 << 12, n):
            r = time_merge(gen, n, nb, L)
            res["merge"].append(r)
            print(f"[{args.label}] merge_sorted L={L} |A|=2^{args.log2_n} "
                  f"|B|={nb}: bit-exact {r['ok']}, {r['ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms", flush=True)
        torch.cuda.empty_cache()
    if args.build:
        r = res["build"] = time_build()
        print(f"[{args.label}] build k=65 canonical 2^25 codes: "
              f"{r['edges']} edges, cold {r['cold_s']:.4f} s, warm "
              f"{', '.join(f'{t:.4f}' for t in r['warm_s'])} s, launches "
              f"{r['launches']}", flush=True)
    if args.json:
        with open(args.json, "a") as f:
            f.write(json.dumps(res) + "\n")
    if not all(r["ok"] for r in res["partition"] + res["merge"]):
        raise SystemExit("time_torch_wide_lanes: a kernel differs from "
                         "its plain version")


if __name__ == "__main__":
    main()
