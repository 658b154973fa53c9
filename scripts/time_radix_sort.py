#!/usr/bin/env python3
"""Time the radix sort's parts and the one-launch partition on one GPU.

    python scripts/time_radix_sort.py [--log2-n 25]

On 2^log2-n random keys (torch generator, seed 0) at the shapes of
chip_smoke.py phase 2 (L = 2, L = 4, L = 4 with one payload), prints the
median time (CUDA events, 20 launches after a warm-up) of: the histogram
launch alone, one digit pass alone (the first pass, which tests every
lane for PAD, and a later one), the whole ``sort_packed`` and the stable
``torch.sort`` of the fused key (L = 2); then ``partition_compact`` at
L = 2, keep 0.5, one payload, beside ``stacked[:, keep]``. Each result is
checked bit for bit against the plain version. Prints the card's name
and power limit first.
"""

import argparse
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def median_ms(fn, reps=20):
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


def time_sort(lib, x, extras):
    import torch
    from metagraph_tpu_torch.common import _cuda, merge
    L, n = x.shape
    stream = torch.cuda.current_stream().cuda_stream
    hist = torch.empty((4 * L * 256 + 1,), dtype=torch.int64, device="cuda")
    tile = lib.mg_sort_tile(L)
    status = torch.empty((-(-n // tile) * 257 + 1,), dtype=torch.int64,
                         device="cuda")
    out = torch.empty_like(x)
    eouts = [torch.empty_like(e) for e in extras]

    def hist_only():
        _cuda.check(lib.mg_sort_hist(x.data_ptr(), n, L, hist.data_ptr(),
                                     stream), "hist")

    def one_pass(first):
        _cuda.check(lib.mg_sort_pass(
            x.data_ptr(), n, L, *merge._pad_ptrs(extras), len(extras),
            out.data_ptr(), *merge._pad_ptrs(eouts), hist.data_ptr(), 3,
            first, status.data_ptr(), stream), "pass")

    t_hist = median_ms(hist_only)
    t_first = median_ms(lambda: one_pass(1))
    t_later = median_ms(lambda: one_pass(0))
    got = merge.sort_packed(x, *extras)
    want = merge.sort_packed_plain(x, *extras)
    same = all(torch.equal(g, w) for g, w in
               zip([got[0], *got[1]], [want[0], *want[1]]))
    t_sort = median_ms(lambda: merge.sort_packed(x, *extras))
    print(f"sort_packed: L={L} E={len(extras)} tile={tile}: histogram "
          f"{t_hist:.4f} ms, first pass {t_first:.4f} ms, later pass "
          f"{t_later:.4f} ms, sort_packed {t_sort:.4f} ms ({4 * L} "
          f"passes), bit-exact {same}", flush=True)
    return same


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--log2-n", type=int, default=25)
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_radix_sort: needs a CUDA device")
    from metagraph_tpu_torch.common import _cuda, merge, packed
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    n = 1 << args.log2_n
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def rand(*shape):
        return torch.randint(-2**31, 2**31, shape, generator=gen,
                             dtype=torch.int64, device="cuda").to(torch.int32)

    lib = _cuda.lib()
    ok = True
    for L, E in ((2, 0), (4, 0), (4, 1)):
        x = rand(L, n)
        extras = [rand(n) for _ in range(E)]
        ok &= time_sort(lib, x, extras)
        if L == 2:
            (key,) = packed._sort_keys(x)
            t = median_ms(lambda: torch.sort(key, stable=True))
            print(f"torch.sort of the fused key, stable: {t:.4f} ms")
        del x, extras
    x = rand(2, n)
    keep = torch.rand(n, generator=gen, device="cuda") < 0.5
    pay = torch.arange(n, dtype=torch.int32, device="cuda")
    got = merge.partition_compact(x, keep, n, pay, extra_fill=-3)
    want = merge.partition_compact_plain(x, keep, n, pay, extra_fill=-3)
    same = all(torch.equal(g, w) for g, w in zip(
        [got[0], got[1], *got[2]], [want[0], want[1], *want[2]]))
    ok &= same
    t = median_ms(lambda: merge.partition_compact(x, keep, n, pay))
    stacked = torch.cat([x, pay[None]])
    t_lib = median_ms(lambda: stacked[:, keep])
    print(f"partition_compact L=2 E=1 keep=0.5: {t:.4f} ms, bit-exact "
          f"{same}; stacked[:, keep] {t_lib:.4f} ms")
    if not ok:
        raise SystemExit("time_radix_sort: a kernel differs from its plain "
                         "version")


if __name__ == "__main__":
    main()
