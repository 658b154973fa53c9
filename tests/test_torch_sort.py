"""The port's ``sort_packed`` against the JAX package, on the CPU.

On a CPU tensor the wrapper runs its plain version (stable ``torch.sort``
passes); the CUDA kernel is held to that plain version bit for bit in
``tests/test_torch_gpu.py``. Here the port's sort must give the keys of
the JAX ``sort_packed`` (run as the JAX tests run it: its Pallas merge
levels in interpret mode) and, within each run of equal keys, the same
payloads as a multiset, since the TPU kernel is unstable; against the
JAX package's stable ``packed.sort`` the payload order must match too.
Integer data: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metagraph_tpu.common import merge as jmerge
from metagraph_tpu.common import packed as jpacked
from metagraph_tpu_torch.common import merge, packed

torch.set_num_threads(2)

# (n_valid, cap, L, leaf) of the JAX package's own sort_packed cases
SORT_CASES = [
    (4000, 4096, 2, 1024),
    (8192, 8192, 2, 1024),
    (5000, 6144, 3, 2048),
    (900, 1024, 2, 1024),
    (10000, 10240, 1, 1024),
]


def _lanes(rng, n, cap, L, hi):
    lanes = np.full((L, cap), 0xFFFFFFFF, np.uint32)
    for j in range(L):
        lanes[j, :n] = rng.integers(0, hi, n).astype(np.uint32)
    return lanes


def _run_multisets(keys, pay, n):
    """Payloads sorted within each run of equal keys, over the first n."""
    order = np.lexsort([pay[:n]] + [keys[j][:n] for j in
                                    range(keys.shape[0] - 1, -1, -1)])
    return pay[:n][order]


@pytest.mark.parametrize("n,cap,L,leaf", SORT_CASES)
def test_sort_packed_matches_jax_kernel(n, cap, L, leaf):
    rng = np.random.default_rng(n + cap + L)
    lanes = _lanes(rng, n, cap, L, 50)              # many duplicates
    pay = rng.integers(0, 1 << 30, cap).astype(np.int32)
    want, (wp,) = jmerge.sort_packed(jnp.asarray(lanes), jnp.asarray(pay),
                                     chunk=1024, leaf=leaf, interpret=True,
                                     force_pallas=True)
    got, (gp,) = merge.sort_packed(packed.lanes_from_numpy(lanes, "cpu"),
                                   torch.from_numpy(pay))
    gk, wk = packed.lanes_to_numpy(got), np.asarray(want)
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(_run_multisets(gk, gp.numpy(), n),
                                  _run_multisets(wk, np.asarray(wp), n))


def test_sort_packed_matches_jax_kernel_large():
    """50 000 mostly distinct keys in 50 leaf runs: 6 ragged levels."""
    rng = np.random.default_rng(77)
    n, cap = 50000, 51200
    v = rng.integers(0, 1 << 62, n).astype(np.uint64)
    lanes = np.full((2, cap), 0xFFFFFFFF, np.uint32)
    lanes[0, :n] = (v >> 32).astype(np.uint32)
    lanes[1, :n] = (v & 0xFFFFFFFF).astype(np.uint32)
    want, _ = jmerge.sort_packed(jnp.asarray(lanes), chunk=1024, leaf=1024,
                                 interpret=True, force_pallas=True)
    got, _ = merge.sort_packed(packed.lanes_from_numpy(lanes, "cpu"))
    np.testing.assert_array_equal(packed.lanes_to_numpy(got),
                                  np.asarray(want))


@pytest.mark.parametrize("L,E,hi", [(1, 1, 3), (2, 2, 7), (4, 1, 2),
                                    (3, 0, 1 << 32)])
def test_sort_packed_stable_like_jax_sort(L, E, hi):
    """Equal keys keep their input order, payloads included: the port
    equals the JAX package's stable ``packed.sort`` bit for bit."""
    rng = np.random.default_rng(L * 10 + E)
    n = 20011
    lanes = _lanes(rng, n, n, L, hi)
    lanes[:, rng.random(n) < 0.1] = 0xFFFFFFFF       # PAD mixed in
    pays = [rng.integers(-2**31, 2**31, n).astype(np.int32) for _ in range(E)]
    want, wps = jpacked.sort(jnp.asarray(lanes),
                             *[jnp.asarray(p) for p in pays])
    got, gps = merge.sort_packed(packed.lanes_from_numpy(lanes, "cpu"),
                                 *[torch.from_numpy(p) for p in pays])
    np.testing.assert_array_equal(packed.lanes_to_numpy(got),
                                  np.asarray(want))
    for g, w in zip(gps, wps):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sort_packed_empty_and_one():
    for n in (0, 1):
        x = packed.full_pad(n, 2, "cpu")
        got, (gp,) = merge.sort_packed(x, torch.arange(n, dtype=torch.int32))
        assert got.shape == (2, n) and gp.shape == (n,)


def _radix_emulation(lanes, pays):
    """The CUDA sort's algorithm on the host: the histogram of every
    8-bit digit over the non-PAD keys, ``merge.radix_passes`` for the
    digits to run, then per digit one stable sort by bin, PAD as bin
    256. Returns (lanes, payloads, digits run)."""
    L, n = lanes.shape
    pad = np.all(lanes == 0xFFFFFFFF, axis=0)
    digits = np.stack([(lanes[L - 1 - d // 4] >> np.uint32(8 * (d % 4)))
                       & np.uint32(0xFF) for d in range(4 * L)])
    hist = np.stack([np.bincount(digits[d][~pad], minlength=256)
                     for d in range(4 * L)])
    passes = merge.radix_passes(hist, int(pad.sum()))
    perm = np.arange(n)
    for d in passes:
        bins = np.where(pad[perm], 256, digits[d][perm]).astype(np.int64)
        perm = perm[torch.sort(torch.from_numpy(bins), stable=True)
                    .indices.numpy()]
    return lanes[:, perm], [p[perm] for p in pays], passes


def _index_emulation(lanes, pays):
    """The CUDA sort's index route on the host: the same histograms and
    digits, then per digit one stable sort of (lane value, index) pairs
    by bin, PAD as bin 256 (tested on the lanes in the first pass, known
    by position after it), a lane's values read through the index in its
    first pass, and one gather at the end. Returns (lanes, payloads,
    digits run, lanes read)."""
    L, n = lanes.shape
    pad = np.all(lanes == 0xFFFFFFFF, axis=0)
    n_pad = int(pad.sum())
    hist = np.stack([np.bincount(
        (lanes[L - 1 - d // 4][~pad] >> np.uint32(8 * (d % 4))) & 0xFF,
        minlength=256) for d in range(4 * L)])
    passes = merge.radix_passes(hist, n_pad)
    idx = np.arange(n)
    read = []
    for i, (d, first, _) in enumerate(merge.index_pass_plan(passes)):
        if first:
            val = lanes[L - 1 - d // 4][idx]
            read.append(L - 1 - d // 4)
        is_pad = pad if i == 0 else np.arange(n) >= n - n_pad
        bins = np.where(is_pad, 256, (val >> np.uint32(8 * (d % 4))) & 0xFF)
        order = torch.sort(torch.from_numpy(bins.astype(np.int64)),
                           stable=True).indices.numpy()
        idx, val = idx[order], val[order]
    return lanes[:, idx], [p[idx] for p in pays], passes, read


def _radix_input(kind, L, n, rng):
    """Keys of one shape the pass plan must handle, and the digits it
    must run (None: not checked)."""
    lanes = rng.integers(0, 1 << 32, (L, n), dtype=np.uint64).astype(
        np.uint32)
    want = list(range(4 * L))
    if kind == "collect":            # k = 20 in 2 bits: 40 bits in 64
        lanes[0] &= 0xFF
        want = [0, 1, 2, 3, 4]
    elif kind == "top-constant":     # long constant prefix, PAD mixed in
        lanes[:-1] = 0x01020304
        lanes[-1] &= 0x00FF00FF
        lanes[:, rng.random(n) < 0.1] = 0xFFFFFFFF
        want = [0, 2]
    elif kind == "equal":
        lanes[:] = 77
        want = []
    elif kind == "pad":
        lanes[:] = 0xFFFFFFFF
        want = []
    elif kind == "equal+pad":        # no digit left, PAD interleaved
        lanes[:] = 5
        lanes[:, rng.random(n) < 0.3] = 0xFFFFFFFF
        want = [0]
    elif kind == "ff-key":           # a non-PAD key reads 0xFF on every
        lanes[:-1] = 0               # digit that runs, PADs around it
        lanes[-1] = rng.integers(0, 3, n).astype(np.uint32) * 0x7F7F7F7F
        lanes[-1, rng.random(n) < 0.2] = 0xFFFFFFFF
        lanes[:, rng.random(n) < 0.2] = 0xFFFFFFFF
        want = [0, 1, 2, 3]
    elif kind == "random+pad":
        lanes[:, rng.random(n) < 0.1] = 0xFFFFFFFF
    elif kind == "middle-constant":  # a middle lane no digit reads
        lanes[L // 2] = 0xFFFFFFFF
        lanes[:, rng.random(n) < 0.1] = 0xFFFFFFFF
        want = [d for d in want if d // 4 != L - 1 - L // 2]
    return lanes, want


RADIX_CASES = [
    # kind, L, payloads
    ("random", 1, 0), ("random", 2, 1), ("random+pad", 3, 2),
    ("random+pad", 4, 1), ("collect", 2, 0), ("collect", 2, 2),
    ("top-constant", 4, 1), ("top-constant", 3, 0), ("equal", 2, 1),
    ("equal", 4, 0), ("pad", 1, 2), ("pad", 3, 1), ("equal+pad", 2, 2),
    ("equal+pad", 1, 0), ("ff-key", 2, 1), ("ff-key", 4, 2),
    # the index route's lane counts
    ("random+pad", 5, 1), ("random+pad", 9, 2), ("random+pad", 16, 0),
    ("top-constant", 8, 2), ("top-constant", 9, 1), ("equal", 5, 2),
    ("equal", 16, 1), ("pad", 8, 0), ("pad", 9, 1), ("equal+pad", 4, 1),
    ("equal+pad", 16, 2), ("ff-key", 3, 2), ("ff-key", 9, 0),
    ("middle-constant", 3, 1), ("middle-constant", 5, 0),
    ("middle-constant", 9, 2), ("middle-constant", 16, 1),
]


@pytest.mark.parametrize("kind,L,E", RADIX_CASES)
def test_radix_pass_plan_matches_jax_sort(kind, L, E):
    """The radix sort's plan (``merge.radix_passes`` over the digit
    histograms, PAD as bin 256) run as stable sorts by bin, by both
    routes (every lane and payload a pass; (value, index) pairs a lane
    at a time, then one gather), equals the JAX package's stable
    ``packed.sort`` bit for bit, payloads included, and runs exactly the
    digits on which the keys differ; the index route reads only the
    lanes with a digit to run."""
    rng = np.random.default_rng(sum(map(ord, kind)) + 10 * L + E)
    n = 3001
    lanes, want_passes = _radix_input(kind, L, n, rng)
    pays = [rng.integers(-2**31, 2**31, n).astype(np.int32) for _ in range(E)]
    want, wps = jpacked.sort(jnp.asarray(lanes),
                             *[jnp.asarray(p) for p in pays])
    got, gps, passes = _radix_emulation(lanes, pays)
    got_i, gps_i, passes_i, read = _index_emulation(lanes, pays)
    assert passes == passes_i == want_passes
    assert read == sorted({L - 1 - d // 4 for d in passes}, reverse=True)
    for g, gp in ((got, gps), (got_i, gps_i)):
        np.testing.assert_array_equal(g, np.asarray(want))
        for a, w in zip(gp, wps):
            np.testing.assert_array_equal(a, np.asarray(w))


def test_sort_route_rule():
    """The lanes route below the measured crossover, the index route
    from it on, for any lane count; a lane's first and last pass in the
    index route's plan."""
    for E in (0, 1, 2):
        for L in (1, 2):
            assert merge.sort_route(L, E) == "lanes"
        for L in (4, 5, 8, 9, 13, 16, 64, 1000):
            assert merge.sort_route(L, E) == "index"
    assert merge.sort_route(3, 0) == merge.sort_route(3, 1) == "lanes"
    assert merge.sort_route(3, 2) == "index"
    assert merge.index_pass_plan([0, 1, 3, 6, 12, 13]) == [
        (0, True, False), (1, False, False), (3, False, True),
        (6, True, True), (12, True, False), (13, False, True)]
    assert merge.index_pass_plan([]) == []


@pytest.mark.parametrize("n", [0, 1])
def test_radix_pass_plan_tiny(n):
    """No key or one key: nothing to run, the sort is a copy."""
    hist = np.zeros((8, 256), np.int64)
    if n:
        hist[:, 0] = 1
    assert merge.radix_passes(hist, 0) == []
    assert merge.radix_passes(np.zeros((8, 256), np.int64), n) == []
