#!/usr/bin/env python3
"""Time the radix sort's parts and the one-launch partition on one GPU.

    python scripts/time_radix_sort.py [--log2-n 25] [--index-lanes 4,8,16]

On 2^log2-n random keys (torch generator, seed 0) at the lanes route's
shapes (L = 2, L = 3, L = 3 with one payload), prints the median time
(CUDA events, 20 launches after a warm-up) of: the histogram launch
alone, one digit pass alone (the first pass, which tests every lane for
PAD, and a later one), the whole ``sort_packed`` and the stable
``torch.sort`` of the fused key (L = 2). Then the index route at each
of ``--index-lanes`` with 0 and 2 payloads (1 % PAD): the histogram
with its PAD mask and row copy of the keys, each kind of pass alone
(the sort's first, which reads its lane and the mask; a lane's first,
which reads the lane through the index; a later one, which the lanes
route's kernel runs on the (value, index) pairs), the final gather, and
the whole ``sort_packed``. Then ``partition_compact`` at L = 2, keep
0.5, one payload, beside ``stacked[:, keep]``. Each result is checked
bit for bit against the plain version. Prints the card's name and power
limit first.
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
    tile = lib.mg_sort_tile()
    status = torch.empty((-(-n // tile) * 257 + 1,), dtype=torch.int64,
                         device="cuda")
    out = torch.empty_like(x)
    eouts = [torch.empty_like(e) for e in extras]

    def hist_only():
        _cuda.check(lib.mg_sort_hist(x.data_ptr(), n, L, hist.data_ptr(),
                                     None, None, stream), "hist")

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


def time_index_route(lib, x, extras):
    import torch
    from metagraph_tpu_torch.common import _cuda, merge
    L, n = x.shape
    stream = torch.cuda.current_stream().cuda_stream
    hist = torch.empty((4 * L * 256 + 1,), dtype=torch.int64, device="cuda")
    status = torch.empty((-(-n // lib.mg_sort_tile()) * 257 + 1,),
                         dtype=torch.int64, device="cuda")
    mask = torch.empty((n,), dtype=torch.uint8, device="cuda")
    rows = torch.empty((n * lib.mg_sort_row_words(L),), dtype=torch.int32,
                       device="cuda")
    v0, i0, v1, i1 = (torch.empty((n,), dtype=torch.int32, device="cuda")
                      for _ in range(4))
    out = torch.empty_like(x)
    eouts = [torch.empty_like(e) for e in extras]
    p = merge._ptr

    def hist_mask():
        _cuda.check(lib.mg_sort_hist(x.data_ptr(), n, L, hist.data_ptr(),
                                     mask.data_ptr(), rows.data_ptr(),
                                     stream), "hist")

    def first_pass(iin, vout, iout, digit, padmask=None):
        _cuda.check(lib.mg_sort_index_pass(
            x.data_ptr(), n, L, p(iin), p(vout), iout.data_ptr(),
            hist.data_ptr(), digit, p(padmask), status.data_ptr(), stream),
            "index pass")

    def later_pass():
        _cuda.check(lib.mg_sort_pass(
            v0.data_ptr(), n, 1, i0.data_ptr(), None, 1, v1.data_ptr(),
            i1.data_ptr(), None, hist.data_ptr(), 1, 0, status.data_ptr(),
            stream), "lanes pass")

    def gather():
        _cuda.check(lib.mg_sort_gather(
            rows.data_ptr(), n, L, i0.data_ptr(), *merge._pad_ptrs(extras),
            len(extras), out.data_ptr(), *merge._pad_ptrs(eouts), stream),
            "gather")

    t = {"histogram + mask + rows": median_ms(hist_mask)}
    t["sort's first pass"] = median_ms(
        lambda: first_pass(None, v0, i0, 0, mask))
    t["lane's first pass (through the index)"] = median_ms(
        lambda: first_pass(i0, v1, i1, 4))
    t["later pass (lanes kernel, the index as payload)"] = median_ms(
        later_pass)
    t["final gather"] = median_ms(gather)
    got = merge.sort_packed(x, *extras)
    want = merge.sort_packed_plain(x, *extras)
    same = all(torch.equal(g, w) for g, w in
               zip([got[0], *got[1]], [want[0], *want[1]]))
    t["sort_packed"] = median_ms(lambda: merge.sort_packed(x, *extras))
    print(f"index route: L={L} E={len(extras)}: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in t.items()) + f", bit-exact {same}",
        flush=True)
    return same


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--log2-n", type=int, default=25)
    p.add_argument("--index-lanes", default="4,8,16")
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
    for L, E in ((2, 0), (3, 0), (3, 1)):
        x = rand(L, n)
        extras = [rand(n) for _ in range(E)]
        ok &= time_sort(lib, x, extras)
        if L == 2:
            (key,) = packed._sort_keys(x)
            t = median_ms(lambda: torch.sort(key, stable=True))
            print(f"torch.sort of the fused key, stable: {t:.4f} ms")
        del x, extras
    for L in (int(v) for v in args.index_lanes.split(",") if v):
        x = rand(L, n)
        x[:, torch.rand(n, generator=gen, device="cuda") < 0.01] = \
            packed.PAD_LANE
        for E in (0, 2):
            ok &= time_index_route(lib, x, [rand(n) for _ in range(E)])
        del x
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
