#!/usr/bin/env python3
"""Time the build kernels at wide keys, and the builds that sort them,
on one GPU.

    python scripts/time_torch_wide_lanes.py [--root DIR] [--label NAME]
        [--lanes 9,12,16] [--log2-n 25] [--kernels sort,partition,merge]
        [--routes] [--build] [--json PATH]

Imports ``metagraph_tpu_torch`` from ``--root`` (default: this checkout),
so that two checkouts can be timed in turns in one process each on the
same card. At 2^log2-n entries (torch generator, seed 0) it checks each
call bit for bit against the plain version, then prints the median of
10 (CUDA events, after a warm-up) of:

  * ``sort_packed`` at each L, 0-2 payloads, on two inputs: "random"
    (every lane random, 1 % PAD columns: all 4 L digits run) and "wide"
    (the high half of the lanes of 2-bit values, as ``chip_smoke.py``
    phase 2 makes them past 8 lanes), beside the plain version, the
    bytes bound, the digit passes and the launches a call;
  * ``partition_compact`` at each L, keep 0.5, one payload, beside
    ``stacked[:, keep]`` (the library yardstick, which writes no PAD
    tail) and the bytes bound;
  * ``merge_sorted`` at each L, one payload a side, |A| = 2^log2-n with
    |B| = 2^12 and |B| = |A|, beside the bytes bound;
  * with ``--routes`` (this checkout's port only): the sort's two routes
    at each L and 0-2 payloads on the random input, whatever
    ``merge.sort_route`` picks (the lanes route up to its widest, 3),
    and each pass kernel's resident blocks per SM;
  * with ``--build``: the k = 65 canonical build of 2^25 random ACGT
    codes (``default_rng(0)``, ``chip_smoke.py`` 3a-wide's), the Protein
    k = 31 basic build of 2^25 residues in 1000 records
    (``default_rng(20)``, 3f's) and the k = 31 primary build of the
    2^25 codes (3c's): one cold and three warm host walls each, closed
    by a synchronize, and the warm build's launches.

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
PROTEIN_LETTERS = b"ACDEFGHIKLMNPQRSTVWY"


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


def random_lanes(gen, n, L):
    import torch
    from metagraph_tpu_torch.common import packed
    x = torch.randint(-2**31, 2**31, (L, n), generator=gen,
                      dtype=torch.int64, device="cuda").to(torch.int32)
    x[:, torch.rand(n, generator=gen, device="cuda") < 0.01] = \
        packed.PAD_LANE
    return x


def payloads(gen, n, E):
    import torch
    return [torch.randint(-2**31, 2**31, (n,), generator=gen,
                          dtype=torch.int64, device="cuda").to(torch.int32)
            for _ in range(E)]


def same(got, want):
    import torch
    return all(torch.equal(g, w) for g, w in zip(got, want))


def time_sort(x, extras, fn=None, plain=False):
    """The sort by ``fn`` (default ``sort_packed``) against the plain
    version: bit-exact, launches and digit passes a call, ms (and the
    plain version's ms)."""
    import torch
    from metagraph_tpu_torch.common import merge
    fn = fn or merge.sort_packed
    L, n = x.shape
    s0, p0 = merge.sort_launches, merge.sort_digit_passes
    got, ge = fn(x, *extras)
    launches = merge.sort_launches - s0
    passes = merge.sort_digit_passes - p0
    want, we = merge.sort_packed_plain(x, *extras)
    ok = same([got, *ge], [want, *we])
    del got, ge, want, we
    torch.cuda.empty_cache()
    r = {"L": L, "E": len(extras), "ok": ok, "launches_per_call": launches,
         "digit_passes": passes, "ms": median_ms(lambda: fn(x, *extras)),
         "bound_ms": bound_ms(2 * 4 * (L + len(extras)) * n)}
    if plain:
        r["plain_ms"] = median_ms(lambda: merge.sort_packed_plain(x, *extras))
    return r


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


def sort_rows(label, gen, n, lanes, log2_n, res):
    import torch
    for L in lanes:
        for kind, make in (("random", random_lanes), ("wide", wide_lanes)):
            x = make(gen, n, L)
            for E in (0, 1, 2):
                r = time_sort(x, payloads(gen, n, E), plain=True)
                r["input"] = kind
                res["sort"].append(r)
                print(f"[{label}] sort_packed L={L} E={E} N=2^{log2_n} "
                      f"({kind}): bit-exact {r['ok']}, "
                      f"{r['launches_per_call']} launch a call, "
                      f"{r['digit_passes']} digit passes, {r['ms']:.4f} ms, "
                      f"plain {r['plain_ms']:.4f} ms, bound "
                      f"{r['bound_ms']:.4f} ms", flush=True)
            del x
            torch.cuda.empty_cache()


def route_rows(label, gen, n, lanes, log2_n, res):
    """Both sort routes on random lanes, whichever ``merge.sort_route``
    picks (the lanes route up to its widest)."""
    import torch
    from metagraph_tpu_torch.common import _cuda, merge
    lib = _cuda.lib()
    occ = {"index": lib.mg_sort_blocks_per_sm(0, 0)}
    print(f"[{label}] index pass kernel: {occ['index']} blocks of 256 "
          f"threads an SM, tile {lib.mg_sort_tile()}", flush=True)
    for L in lanes:
        x = random_lanes(gen, n, L)
        for E in (0, 1, 2):
            ex = payloads(gen, n, E)
            routes = ["index"]
            if L <= lib.mg_sort_lanes_route_max():
                routes.append("lanes")
                occ[f"lanes L={L} E={E}"] = lib.mg_sort_blocks_per_sm(L, E)
            for route in routes:
                r = time_sort(x, ex, lambda *a, route=route:
                              merge._sort_cuda(a[0], list(a[1:]), route))
                r["route"] = route
                res["routes"].append(r)
                print(f"[{label}] route {route} L={L} E={E} N=2^{log2_n} "
                      f"(random; sort_route picks "
                      f"{merge.sort_route(L, E)}): bit-exact {r['ok']}, "
                      f"{r['digit_passes']} digit passes, {r['ms']:.4f} ms, "
                      f"bound {r['bound_ms']:.4f} ms"
                      + (f", lanes kernel {occ[f'lanes L={L} E={E}']} "
                         f"blocks an SM" if route == "lanes" else ""),
                      flush=True)
        del x
        torch.cuda.empty_cache()
    res["blocks_per_sm"] = occ


def protein_codes():
    from metagraph_tpu_torch.kmer.alphabets import PROTEIN
    from metagraph_tpu_torch.kmer.extractor import encode_sequences
    rng = np.random.default_rng(20)
    letters = np.frombuffer(PROTEIN_LETTERS, np.uint8)
    res = letters[rng.integers(0, 20, 1 << 25)]
    cuts = np.linspace(0, 1 << 25, 1001).astype(np.int64)
    return encode_sequences([res[cuts[i]:cuts[i + 1]].tobytes()
                             for i in range(1000)], PROTEIN)


def time_build(codes, k, mode, alphabet=None):
    import torch
    from metagraph_tpu_torch.common import merge
    from metagraph_tpu_torch.graph.boss_construct import build_boss_from_codes
    kw = {} if alphabet is None else {"alphabet": alphabet}

    def run():
        torch.cuda.synchronize()
        t = time.perf_counter()
        boss = build_boss_from_codes(codes, k, mode=mode, device="cuda",
                                     **kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t, boss.num_edges

    cold, edges = run()
    warm = []
    for _ in range(3):
        torch.cuda.empty_cache()
        merge.partition_launches = merge.merge_launches = 0
        merge.sort_launches = merge.sort_digit_passes = 0
        t, _ = run()
        warm.append(t)
    torch.cuda.empty_cache()
    return {"k": k, "mode": mode, "edges": int(edges), "cold_s": cold,
            "warm_s": warm,
            "launches": {"partition_compact": merge.partition_launches,
                         "merge_sorted": merge.merge_launches,
                         "sort_packed": merge.sort_launches},
            "digit_passes": merge.sort_digit_passes}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--label", default="")
    ap.add_argument("--lanes", default="9,12,16")
    ap.add_argument("--log2-n", type=int, default=25)
    ap.add_argument("--kernels", default="sort,partition,merge")
    ap.add_argument("--routes", action="store_true")
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
    lanes = [int(v) for v in args.lanes.split(",")]
    kernels = args.kernels.split(",") if args.kernels else []
    res = {"label": args.label, "device": torch.cuda.get_device_name(0),
           "sort": [], "partition": [], "merge": [], "routes": []}
    if "sort" in kernels:
        sort_rows(args.label, gen, n, lanes, args.log2_n, res)
    if args.routes:
        route_rows(args.label, gen, n, lanes, args.log2_n, res)
    for L in lanes:
        if "partition" in kernels:
            r = time_partition(gen, n, L)
            res["partition"].append(r)
            print(f"[{args.label}] partition_compact L={L} "
                  f"N=2^{args.log2_n} keep=0.5 E=1: bit-exact {r['ok']}, "
                  f"{r['launches_per_call']} launches a call, "
                  f"{r['ms']:.4f} ms, x[:, keep] {r['library_ms']:.4f} ms, "
                  f"bound {r['bound_ms']:.4f} ms", flush=True)
        if "merge" in kernels:
            for nb in (1 << 12, n):
                r = time_merge(gen, n, nb, L)
                res["merge"].append(r)
                print(f"[{args.label}] merge_sorted L={L} "
                      f"|A|=2^{args.log2_n} |B|={nb}: bit-exact {r['ok']}, "
                      f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms",
                      flush=True)
        torch.cuda.empty_cache()
    if args.build:
        from metagraph_tpu_torch.kmer.alphabets import PROTEIN
        codes = np.random.default_rng(0).integers(1, 5, 1 << 25).astype(
            np.uint8)
        res["build"] = [time_build(codes, 65, "canonical"),
                        time_build(protein_codes(), 31, "basic", PROTEIN),
                        time_build(codes, 31, "primary")]
        for r, what in zip(res["build"], ("k=65 canonical 2^25 codes",
                                          "Protein k=31 basic 2^25 residues",
                                          "k=31 primary 2^25 codes")):
            print(f"[{args.label}] build {what}: {r['edges']} edges, cold "
                  f"{r['cold_s']:.4f} s, warm "
                  f"{', '.join(f'{t:.4f}' for t in r['warm_s'])} s, "
                  f"launches {r['launches']}, {r['digit_passes']} digit "
                  f"passes", flush=True)
    if args.json:
        with open(args.json, "a") as f:
            f.write(json.dumps(res) + "\n")
    if not all(r["ok"] for r in res["sort"] + res["routes"] +
               res["partition"] + res["merge"]):
        raise SystemExit("time_torch_wide_lanes: a kernel differs from "
                         "its plain version")


if __name__ == "__main__":
    main()
