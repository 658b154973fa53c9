"""Parity of the port's partition_compact and merge_sorted with the JAX
package, on the CPU (where the port's wrappers run the plain versions).

References: the JAX Pallas kernels run as ``tests/test_merge.py`` runs
them (``interpret=True, force_pallas=True, chunk=1024``) and the JAX
fallbacks (``packed.compact``, ``_merge_fallback``). Keys must match
exactly; payloads exactly against the stable fallback, and as multisets
within equal-key runs against the unstable interpret-mode merge. Past 8
lanes: the sort's lane groups against the plain versions, the partition
against the JAX package's, and the merge kernel's tiled merge path,
emulated in numpy at tiles of a few keys.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metagraph_tpu.common import merge as jmerge
from metagraph_tpu.common import packed as jpk
from metagraph_tpu_torch.common import device as tdevice
from metagraph_tpu_torch.common import merge as tmerge
from metagraph_tpu_torch.common import packed as tpk

torch.set_num_threads(2)


def T(a):
    return tpk.lanes_from_numpy(np.asarray(a), "cpu")


def _sorted_lanes(rng, n_valid, cap, L, hi=1 << 63):
    if L == 1:
        hi = min(hi, 1 << 31)
    v = rng.integers(0, hi, n_valid, dtype=np.uint64)
    v = ((v >> np.uint64(33)) << np.uint64(32)) | (v & np.uint64(0xFFFFFFFF))
    v.sort()
    lanes = np.full((L, cap), 0xFFFFFFFF, np.uint32)
    if n_valid:
        lanes[:, :n_valid] = 0
        lanes[L - 1, :n_valid] = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        if L > 1:
            lanes[L - 2, :n_valid] = (v >> np.uint64(32)).astype(np.uint32)
    return lanes


PART_CASES = [
    (1024, 1024, 0.5, 2),
    (4096, 4096, 0.3, 2),
    (3000, 3000, 0.5, 2),       # not a chunk multiple
    (2048, 512, 0.7, 2),        # capacity < count: truncation + true count
    (1500, 8192, 0.4, 3),       # capacity > n: PAD / fill tail
    (2048, 2048, 1.0, 2),
    (2048, 2048, 0.0, 2),
    (1024, 1024, 0.01, 1),
]


@pytest.mark.parametrize("n,capacity,frac,L", PART_CASES)
def test_partition_matches_jax(n, capacity, frac, L):
    rng = np.random.default_rng(n * 7 + capacity + L)
    lanes = rng.integers(0, 1 << 32, (L, n), dtype=np.uint64).astype(
        np.uint32)
    lanes[:, ::97] = 0xFFFFFFFF
    keep = rng.random(n) < frac
    p_i32 = rng.integers(-2**31, 2**31, n).astype(np.int32)
    p_u32 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    got, gcount, (gi, gu) = tmerge.partition_compact(
        T(lanes), torch.from_numpy(keep), capacity, torch.from_numpy(p_i32),
        T(p_u32), extra_fill=7)
    for ref in (
            jmerge.partition_compact(
                jnp.asarray(lanes), jnp.asarray(keep), capacity,
                jnp.asarray(p_i32), jnp.asarray(p_u32), extra_fill=7,
                chunk=1024, interpret=True, force_pallas=True),
            jpk.compact(jnp.asarray(lanes), jnp.asarray(keep), capacity,
                        jnp.asarray(p_i32), jnp.asarray(p_u32),
                        extra_fill=7)):
        want, wcount, (wi, wu) = ref
        assert int(gcount) == int(wcount)
        np.testing.assert_array_equal(tpk.lanes_to_numpy(got),
                                      np.asarray(want))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(tpk.lanes_to_numpy(gu),
                                      np.asarray(wu).astype(np.uint32))


def test_partition_stable():
    n = 2048
    rng = np.random.default_rng(13)
    lanes = rng.integers(0, 17, (2, n)).astype(np.uint32)
    keep = rng.random(n) < 0.6
    _, count, (idx,) = tmerge.partition_compact(
        T(lanes), torch.from_numpy(keep), n,
        torch.arange(n, dtype=torch.int32))
    np.testing.assert_array_equal(idx.numpy()[:int(count)],
                                  np.flatnonzero(keep))


MERGE_CASES = [
    (100, 200, 8192, 8192, 2),
    (8192, 8192, 8192, 8192, 2),
    (5000, 9000, 8192, 16384, 3),
    (0, 50, 8192, 8192, 2),
    (300, 0, 1024, 512, 1),
    (7000, 7000, 8192, 8192, 2),
    (9000, 40, 9000, 1024, 4),     # |B| << |A|, as the dummy merge
]


def _check_merge(a, b, pa, pb, L):
    got, (gp,) = tmerge.merge_sorted(T(a), T(b), (torch.from_numpy(pa),),
                                     (torch.from_numpy(pb),))
    gk, gp = tpk.lanes_to_numpy(got), gp.numpy()
    # the stable fallback: keys and payloads exact
    want, (wp,) = jmerge._merge_fallback(
        jnp.asarray(a), jnp.asarray(b), (jnp.asarray(pa),),
        (jnp.asarray(pb),))
    np.testing.assert_array_equal(gk, np.asarray(want))
    np.testing.assert_array_equal(gp, np.asarray(wp))
    # the (unstable) Pallas kernel in interpret mode: keys exact, payloads
    # as multisets within equal-key runs
    want, (wp,) = jmerge.merge_sorted(
        jnp.asarray(a), jnp.asarray(b), (jnp.asarray(pa),),
        (jnp.asarray(pb),), chunk=1024, interpret=True, force_pallas=True)
    wk, wp = np.asarray(want), np.asarray(wp)
    np.testing.assert_array_equal(gk, wk)
    nv = int(np.sum(~np.all(gk == 0xFFFFFFFF, axis=0)))
    gz = np.lexsort([gp[:nv]] + [gk[j][:nv] for j in range(L)])
    wz = np.lexsort([wp[:nv]] + [wk[j][:nv] for j in range(L)])
    np.testing.assert_array_equal(gp[:nv][gz], wp[:nv][wz])


@pytest.mark.parametrize("na,nb,ca,cb,L", MERGE_CASES)
def test_merge_matches_jax(na, nb, ca, cb, L):
    rng = np.random.default_rng(na * 31 + nb)
    a, b = _sorted_lanes(rng, na, ca, L), _sorted_lanes(rng, nb, cb, L)
    pa = rng.integers(0, 1 << 30, ca).astype(np.int32)
    pb = rng.integers(0, 1 << 30, cb).astype(np.int32)
    _check_merge(a, b, pa, pb, L)


def test_merge_duplicate_heavy():
    rng = np.random.default_rng(7)
    a = np.full((2, 8192), 0xFFFFFFFF, np.uint32)
    b = np.full((2, 8192), 0xFFFFFFFF, np.uint32)
    a[0, :4096], b[0, :4096] = 0, 0
    a[1, :4096] = np.sort(rng.integers(0, 37, 4096))
    b[1, :4096] = np.sort(rng.integers(0, 37, 4096))
    _check_merge(a, b, np.arange(8192, dtype=np.int32),
                 np.arange(8192, 16384, dtype=np.int32), 2)


def test_merge_zero_width_sides():
    rng = np.random.default_rng(2)
    a = _sorted_lanes(rng, 100, 1024, 2)
    empty = np.full((2, 0), 0xFFFFFFFF, np.uint32)
    for x, y in ((a, empty), (empty, a)):
        got, _ = tmerge.merge_sorted(T(x), T(y))
        np.testing.assert_array_equal(tpk.lanes_to_numpy(got), a)


def test_wrappers_dispatch_on_device_only():
    x = tpk.full_pad(4, 2, "meta")
    keep = torch.ones(4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        tmerge.partition_compact(x, keep, 4)
    with pytest.raises(ValueError):
        tmerge.merge_sorted(x, x)
    # a CPU tensor takes the plain version and launches nothing
    p0, m0 = tmerge.partition_launches, tmerge.merge_launches
    tmerge.partition_compact(tpk.full_pad(4, 2, "cpu"),
                             torch.ones(4, dtype=torch.bool), 4)
    tmerge.merge_sorted(tpk.full_pad(4, 2, "cpu"), tpk.full_pad(4, 2, "cpu"))
    assert (tmerge.partition_launches, tmerge.merge_launches) == (p0, m0)


def test_cuda_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.resolve("cuda")
    assert tdevice.resolve("cpu") == torch.device("cpu")


def _wide_keys(rng, L, n, dup=True, pad=0.1):
    """(L, n) uint32 keys with equal keys (few values in the low lanes),
    keys equal but for their last lane, and PAD columns."""
    x = rng.integers(0, 1 << 32, (L, n), dtype=np.uint64).astype(np.uint32)
    if dup:
        x[: L - 2] = rng.integers(0, 3, (L - 2, n))
        x[L - 2] = rng.integers(0, 5, n)
    x[:, rng.random(n) < pad] = 0xFFFFFFFF
    return x


@pytest.mark.parametrize("L", [3, 4, 5, 8, 9, 10, 16])
@pytest.mark.parametrize("E", [0, 2])
def test_sort_packed_any_lane_count(L, E):
    """sort_packed and lex_order at any lane count (one route, one
    launch on the card): the plain sort's order, stable, PAD last, the
    payloads in the same order; the JAX package's sort of the same
    lanes."""
    rng = np.random.default_rng(L * 3 + E)
    x = T(_wide_keys(rng, L, 3001))
    extras = [torch.arange(3001, dtype=torch.int32), torch.from_numpy(
        rng.integers(-9, 9, 3001).astype(np.int32))][:E]
    got, ge = tmerge.sort_packed(x, *extras)
    want, we = tpk.sort(x, *extras)
    assert torch.equal(got, want)
    for g, w in zip(ge, we):
        assert torch.equal(g, w)
    order = tmerge.lex_order(x)
    assert torch.equal(x[:, order], want)
    # the JAX package's sort of the same lanes
    jl, _ = jpk.sort(jnp.asarray(tpk.lanes_to_numpy(x)))
    np.testing.assert_array_equal(tpk.lanes_to_numpy(got), np.asarray(jl))


@pytest.mark.parametrize("L", [9, 16])
def test_partition_lane_groups(L):
    """Past 8 lanes partition_compact compacts every lane and both
    payloads at once (one launch on the card): the JAX package's
    partition_compact (its CPU fallback) and the plain version, at a
    capacity equal to, below and above the count of entries."""
    rng = np.random.default_rng(L)
    n = 2500
    lanes = _wide_keys(rng, L, n, dup=False)
    x = T(lanes)
    keep_np = rng.random(n) < 0.4
    keep = torch.from_numpy(keep_np)
    extras = [torch.arange(n, dtype=torch.int32),
              torch.from_numpy(rng.integers(0, 99, n).astype(np.int32))]
    for cap in (n, 600, n + 77):
        got, count, ge = tmerge.partition_compact(x, keep, cap, *extras,
                                                  extra_fill=-5)
        want, wcount, we = tpk.compact(x, keep, cap, *extras, extra_fill=-5)
        assert int(count) == int(wcount) == int(keep.sum())
        assert torch.equal(got, want)
        for g, w in zip(ge, we):
            assert torch.equal(g, w)
        jl, jcount, je = jmerge.partition_compact(
            jnp.asarray(lanes), jnp.asarray(keep_np), cap,
            *(jnp.asarray(e.numpy()) for e in extras), extra_fill=-5)
        assert int(jcount) == int(count)
        np.testing.assert_array_equal(tpk.lanes_to_numpy(got),
                                      np.asarray(jl))
        for g, j in zip(ge, je):
            np.testing.assert_array_equal(g.numpy(), np.asarray(j))


def _le(a, i, b, j):
    """Key a[:, i] <= key b[:, j], lexicographically (lane 0 first)."""
    return tuple(a[:, i].tolist()) <= tuple(b[:, j].tolist())


def _diagonal(a, a0, na, b, b0, nb, d):
    """How many of the first d outputs of merge(a[:, a0:a0+na],
    b[:, b0:b0+nb]) come from A: the merge-path binary search, ties to
    A (merge_tile.cuh merge_path)."""
    lo, hi = max(0, d - nb), min(d, na)
    while lo < hi:
        m = (lo + hi) // 2
        if _le(a, a0 + m, b, b0 + d - m - 1):
            lo = m + 1
        else:
            hi = m
    return lo


def tiled_merge(a: np.ndarray, b: np.ndarray, ea, eb, tile: int,
                items: int):
    """The merge kernel of csrc/merge.cu in numpy: splits at every tile
    boundary by the diagonal search over the whole arrays, then each
    tile's merge as one block runs it: a tile fed by one side is a copy;
    otherwise each of its tile / items threads finds its sub-diagonal in
    the tile's windows and takes ``items`` outputs, A first on ties."""
    na, nb = a.shape[1], b.shape[1]
    ntot = na + nb
    g = -(-ntot // tile)
    splits = [_diagonal(a, 0, na, b, 0, nb, min(t * tile, ntot))
              for t in range(g + 1)]
    out = np.zeros((a.shape[0], ntot), np.uint32)
    eo = np.zeros(ntot, np.int64)
    for t in range(g):
        d0, d1 = t * tile, min((t + 1) * tile, ntot)
        a0, na_t = splits[t], splits[t + 1] - splits[t]
        b0, nb_t = d0 - a0, d1 - d0 - na_t
        # (side, index) of each output of the tile
        if nb_t == 0 or na_t == 0:
            src = ([(0, a0 + p) for p in range(na_t)]
                   + [(1, b0 + p) for p in range(nb_t)])
        else:
            src = [None] * (d1 - d0)
            for th in range(tile // items):
                diag = min(th * items, d1 - d0)
                ai = _diagonal(a, a0, na_t, b, b0, nb_t, diag)
                bi = diag - ai
                for k in range(min(items, d1 - d0 - diag)):
                    take_a = bi >= nb_t or (
                        ai < na_t and _le(a, a0 + ai, b, b0 + bi))
                    src[diag + k] = (0, a0 + ai) if take_a else (1, b0 + bi)
                    ai, bi = (ai + 1, bi) if take_a else (ai, bi + 1)
        for p, (side, i) in enumerate(src):
            out[:, d0 + p] = (a, b)[side][:, i]
            eo[d0 + p] = (ea, eb)[side][i]
    return out, eo


@pytest.mark.parametrize("L,na,nb", [(9, 3000, 40), (9, 1500, 1500),
                                     (16, 700, 900), (12, 0, 50),
                                     (33, 400, 350)])
def test_merge_tiles_match_plain(L, na, nb):
    """The merge kernel's tiled merge path (numpy emulation) at tiles of
    a few keys, so that tile and thread boundaries fall inside runs of
    equal keys and inside the PAD tails, and at its 1024-key tile: the
    plain merge, bit for bit (sorted, stable, ties to A, A's PAD tail
    before B's); the wrapper's merge on the CPU and the JAX package's
    merge_sorted equal both."""
    rng = np.random.default_rng(L + na)
    a = tpk.lanes_to_numpy(tpk.sort(T(_wide_keys(rng, L, na)))[0])
    b = tpk.lanes_to_numpy(tpk.sort(T(_wide_keys(rng, L, nb)))[0])
    ea, eb = np.arange(na), np.arange(na, na + nb)
    pa, pb = ((torch.from_numpy(e.astype(np.int32)),) for e in (ea, eb))
    want, (wp,) = tmerge.merge_sorted_plain(T(a), T(b), pa, pb)
    for tile, items in ((8, 2), (1024, 4)):
        out, eo = tiled_merge(a, b, ea, eb, tile, items)
        np.testing.assert_array_equal(out, tpk.lanes_to_numpy(want))
        np.testing.assert_array_equal(eo, wp.numpy())
    got, (gp,) = tmerge.merge_sorted(T(a), T(b), pa, pb)
    assert torch.equal(got, want) and torch.equal(gp, wp)
    jl, (jp,) = jmerge.merge_sorted(jnp.asarray(a), jnp.asarray(b),
                                    (jnp.asarray(ea.astype(np.int32)),),
                                    (jnp.asarray(eb.astype(np.int32)),))
    np.testing.assert_array_equal(np.asarray(jl), tpk.lanes_to_numpy(want))
    np.testing.assert_array_equal(np.asarray(jp), wp.numpy())
