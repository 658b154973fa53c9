"""Parity of the port's packed-lane helpers with the JAX package.

Every helper of ``metagraph_tpu_torch.common.packed`` and
``metagraph_tpu_torch.kmer.packing`` runs on the same numpy inputs as its
``metagraph_tpu`` counterpart, including PAD, all-T and top-bit values;
results must be bit-identical (integer data: the tolerance is exact).
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metagraph_tpu.common import packed as jpk
from metagraph_tpu.common import ranksel as jranksel
from metagraph_tpu.kmer import extractor as jext
from metagraph_tpu.kmer import packing as jpack
from metagraph_tpu.kmer.alphabets import DNA
from metagraph_tpu_torch.common import packed as tpk
from metagraph_tpu_torch.common import ranksel as tranksel
from metagraph_tpu_torch.kmer import extractor as text
from metagraph_tpu_torch.kmer import packing as tpack

torch.set_num_threads(2)


def T(a):
    return tpk.lanes_from_numpy(a, "cpu")


def U(t):
    """A port result as numpy with the JAX package's dtype for lanes."""
    return tpk.lanes_to_numpy(t) if t.dtype == torch.int32 else t.numpy()


def same(jax_out, torch_out):
    j = np.asarray(jax_out)
    t = U(torch_out) if isinstance(torch_out, torch.Tensor) else \
        np.asarray(torch_out)
    if j.dtype == np.uint32 or t.dtype == np.uint32:
        j, t = j.astype(np.uint32), t.astype(np.uint32)
    np.testing.assert_array_equal(t, j)


def lanes_with_specials(rng, L, n):
    """Random lanes plus PAD, all-T (0x4444...), top-bit and zero rows."""
    x = rng.integers(0, 1 << 32, (L, n), dtype=np.uint64).astype(np.uint32)
    x[:, 0] = 0xFFFFFFFF
    x[:, 1] = 0x44444444
    x[:, 2] = 0x80000000
    x[:, 3] = 0
    x[:, 4] = 0x7FFFFFFF
    return x


@pytest.mark.parametrize("nbits", [0, 1, 4, 8, 31, 32, 33, 60, 64])
def test_shifts(nbits):
    x = lanes_with_specials(np.random.default_rng(nbits), 3, 64)
    same(jpk.shift_right(jnp.asarray(x), nbits), tpk.shift_right(T(x), nbits))
    same(jpk.shift_left(jnp.asarray(x), nbits), tpk.shift_left(T(x), nbits))


@pytest.mark.parametrize("B,slots", [(4, 8), (4, 20), (2, 16), (8, 4)])
def test_fields(B, slots):
    rng = np.random.default_rng(B * 100 + slots)
    L = jpk.num_lanes(slots, B)
    x = lanes_with_specials(rng, L, 32)
    jx, tx = jnp.asarray(x), T(x)
    for s in range(slots):
        same(jpk.get_field(jx, s, B), tpk.get_field(tx, s, B))
        v = rng.integers(0, 1 << B, 32).astype(np.uint32)
        same(jpk.set_field(jx, s, jnp.asarray(v), B),
             tpk.set_field(tx, s, torch.from_numpy(v.astype(np.int32)), B))
    f = jpk.to_fields(jx, slots, B)
    same(f, tpk.to_fields(tx, slots, B))
    same(jpk.from_fields(f, B, lanes=L),
         tpk.from_fields(torch.from_numpy(np.asarray(f).astype(np.int32)),
                         B, lanes=L))


@pytest.mark.parametrize("L", [1, 2, 3, 4])
def test_compare_and_neighbors(L):
    rng = np.random.default_rng(L)
    a = lanes_with_specials(rng, L, 200)
    b = a.copy()
    b[:, ::3] = lanes_with_specials(rng, L, 200)[:, ::3][:, ::-1]
    b[L - 1, 1::5] ^= 1
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), T(a), T(b)
    same(jpk.eq(ja, jb), tpk.eq(ta, tb))
    same(jpk.lt(ja, jb), tpk.lt(ta, tb))
    same(jpk.le(ja, jb), tpk.le(ta, tb))
    s = np.sort(a[L - 1])[None].repeat(L, 0)
    same(jpk.neighbor_ne(jnp.asarray(s)), tpk.neighbor_ne(T(s)))


def test_unsigned_helpers():
    x = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0x44444444],
                 np.uint32)
    t = T(x)
    for n in (0, 1, 16, 31, 32):
        want = x >> n if n < 32 else np.zeros_like(x)
        np.testing.assert_array_equal(U(tpk.srl(t, n)), want)
    np.testing.assert_array_equal(
        tpk.ult(t[:, None], t[None, :]).numpy(), x[:, None] < x[None, :])
    np.testing.assert_array_equal(tpk.top_bit_set(t).numpy(),
                                  x >= 0x80000000)
    rnd = np.random.default_rng(3).integers(0, 1 << 32, 1000,
                                            dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        tpk.popcount32(T(np.concatenate([x, rnd]))).numpy(),
        np.bitwise_count(np.concatenate([x, rnd])))
    np.testing.assert_array_equal(
        U(tpk.from_uint(tpk.as_uint(T(x)))), x)


@pytest.mark.parametrize("L,n,dups", [(1, 500, False), (2, 700, True),
                                      (3, 1000, True), (4, 300, False)])
def test_sort_stable(L, n, dups):
    rng = np.random.default_rng(L * n)
    x = lanes_with_specials(rng, L, n)
    if dups:
        x[:, n // 2:] = x[:, :n - n // 2]
        x &= np.uint32(0x80000003)
    pay = np.arange(n, dtype=np.int32)
    js, (jp,) = jpk.sort(jnp.asarray(x), jnp.asarray(pay))
    ts, (tp,) = tpk.sort(T(x), torch.from_numpy(pay))
    same(js, ts)
    same(jp, tp)


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("L", [1, 2, 3])
def test_searchsorted(side, L):
    rng = np.random.default_rng(L + len(side))
    keys = np.asarray(jpk.sort(jnp.asarray(
        lanes_with_specials(rng, L, 300) & np.uint32(0x8000000F)))[0])
    q = np.concatenate([keys[:, ::7], lanes_with_specials(rng, L, 50)
                        & np.uint32(0x8000000F)], axis=1)
    same(jpk.searchsorted(jnp.asarray(keys), jnp.asarray(q), side=side),
         tpk.searchsorted(T(keys), T(q), side=side))
    # narrowed ranges with a fixed number of rounds (the LUT form)
    lo = rng.integers(0, 100, q.shape[1]).astype(np.int32)
    hi = lo + rng.integers(0, 200, q.shape[1]).astype(np.int32)
    same(jpk.searchsorted(jnp.asarray(keys), jnp.asarray(q), side=side,
                          lo0=jnp.asarray(lo), hi0=jnp.asarray(hi), steps=8),
         tpk.searchsorted(T(keys), T(q), side=side,
                          lo0=torch.from_numpy(lo), hi0=torch.from_numpy(hi),
                          steps=8))


@pytest.mark.parametrize("K", [11, 16, 20, 31, 32])
def test_expand2to4(K):
    rng = np.random.default_rng(K)
    L2 = jpk.num_lanes(K, 2)
    x = rng.integers(0, 1 << 32, (L2, 64), dtype=np.uint64).astype(np.uint32)
    if (2 * K) % 32:
        x[0] &= np.uint32((1 << ((2 * K) % 32)) - 1)
    x[:, 0] = 0xFFFFFFFF                       # PAD (garbled, as in JAX)
    same(jpk.expand2to4(jnp.asarray(x), K), tpk.expand2to4(T(x), K))


@pytest.mark.parametrize("n,capacity,frac", [(100, 100, 0.5), (100, 30, 0.8),
                                             (100, 250, 0.3), (64, 64, 0.0),
                                             (64, 64, 1.0)])
def test_compact(n, capacity, frac):
    rng = np.random.default_rng(n + capacity)
    x = lanes_with_specials(rng, 2, n)
    keep = rng.random(n) < frac
    p = rng.integers(-2**31, 2**31, n).astype(np.int32)
    jl, jc, (jp,) = jpk.compact(jnp.asarray(x), jnp.asarray(keep), capacity,
                                jnp.asarray(p), extra_fill=-5)
    tl, tc, (tp,) = tpk.compact(T(x), torch.from_numpy(keep), capacity,
                                torch.from_numpy(p), extra_fill=-5)
    same(jl, tl)
    assert int(jc) == int(tc)
    same(jp, tp)


def test_pad_mask_scans():
    rng = np.random.default_rng(9)
    x = lanes_with_specials(rng, 3, 20)
    same(jpk.pad_to(jnp.asarray(x), 33), tpk.pad_to(T(x), 33))
    same(jpk.full_pad(7, 2), tpk.full_pad(7, 2, "cpu"))
    same(jpk.valid_mask(40, jnp.int32(13)),
         tpk.valid_mask(40, torch.tensor(13, dtype=torch.int32)))
    v = rng.integers(-50, 50, 20000).astype(np.int32)
    same(jpk.blocked_cumsum(jnp.asarray(v), block=1024),
         tpk.blocked_cumsum(torch.from_numpy(v)))
    same(jpk.blocked_cummax(jnp.asarray(v), block=1024),
         tpk.blocked_cummax(torch.from_numpy(v)))


SCAN_SIZES = [0, 1, 8191, 8192, 8193, 3 * 8192 + 5, (1 << 20) + 13]


def _scan_input(rng, n, kind):
    if kind == "equal":
        return np.full(n, 7, np.int32)
    if kind == "negative":            # shows a pad or seed other than min
        v = rng.integers(-(1 << 31), 0, n).astype(np.int32)
        v[:1] = -(1 << 31)
        return v
    return rng.integers(-50, 50, n).astype(np.int32)


@pytest.mark.parametrize("kind", ["random", "equal", "negative"])
@pytest.mark.parametrize("n", SCAN_SIZES)
def test_blocked_scans(n, kind):
    """The two-level running maximum and the cumsum against the JAX
    package's blocked scans and numpy, across the 8192-entry rows."""
    v = _scan_input(np.random.default_rng(n + len(kind)), n, kind)
    got_sum = tpk.blocked_cumsum(torch.from_numpy(v))
    got_max = tpk.blocked_cummax(torch.from_numpy(v))
    assert got_sum.dtype == got_max.dtype == torch.int32
    np.testing.assert_array_equal(got_sum.numpy(),
                                  np.cumsum(v, dtype=np.int32))
    np.testing.assert_array_equal(got_max.numpy(), np.maximum.accumulate(v))
    if n:
        same(jpk.blocked_cumsum(jnp.asarray(v)), got_sum)
        same(jpk.blocked_cummax(jnp.asarray(v)), got_max)


@pytest.mark.parametrize("nb", [1, 7, (1 << 12) + 1])
def test_block_counts(nb):
    """Exclusive per-block symbol counts (the pad symbol not counted)
    against a numpy cumsum and the JAX SymbolRank's blocks."""
    sigma, bs = 10, tranksel._BS
    rng = np.random.default_rng(nb)
    seq = rng.integers(0, sigma + 1, nb * bs).astype(np.int8)
    seq[-5:] = sigma
    got = tranksel.block_counts(torch.from_numpy(seq), sigma, nb)
    hist = np.stack([(seq.reshape(nb, bs) == c).sum(1) for c in
                     range(sigma)], axis=1)
    want = np.concatenate([np.zeros((1, sigma), np.int64),
                           np.cumsum(hist, axis=0)])
    assert got.dtype == torch.int32 and got.shape == (nb + 1, sigma)
    np.testing.assert_array_equal(got.numpy(), want)
    n = nb * bs - 5
    jblocks = jranksel.SymbolRank.build(jnp.asarray(seq[:n]), sigma).blocks
    np.testing.assert_array_equal(got.numpy(), np.asarray(jblocks))


# ---------------------------------------------------------------------------
# kmer/packing.py and kmer/extractor.py
# ---------------------------------------------------------------------------

def _codes(rng, n, invalid_frac=0.05):
    c = rng.integers(1, 5, n).astype(np.uint8)
    c[rng.random(n) < invalid_frac] = 255
    c[:5] = 4                                  # an all-T stretch
    return c


@pytest.mark.parametrize("K", [11, 16, 20, 31])
def test_kmer_packing(K):
    B = DNA.bits_per_char
    rng = np.random.default_rng(K)
    codes = _codes(rng, 300)
    jl = jpack.pack_windows(jnp.asarray(codes), K, B)
    tl = tpack.pack_windows(torch.from_numpy(codes), K, B)
    same(jl, tl)
    same(jext.window_validity(jnp.asarray(codes), K),
         text.window_validity(torch.from_numpy(codes), K))
    for fn in (jpack.node_key, jpack.target_key, jpack.label,
               jpack.first_char):
        same(fn(jl, B), getattr(tpack, fn.__name__)(tl, B))
    same(jpack.top_char(jl, K, B), tpack.top_char(tl, K, B))
    for c in (0, 3):
        same(jpack.to_next(jl, K, B, c), tpack.to_next(tl, K, B, c))
        same(jpack.to_prev(jl, K, B, c), tpack.to_prev(tl, K, B, c))
    ok = np.array(jext.window_validity(jnp.asarray(codes), K))
    same(jpack.reverse_complement(jl, K, B, DNA.complement)[:, ok],
         tpack.reverse_complement(tl, K, B, DNA.complement)[:, ok])
    same(jpack.contains_sentinel(jl, K, B),
         tpack.contains_sentinel(tl, K, B))
    same(jpack.unpack_to_chars(jl, K, B), tpack.unpack_to_chars(tl, K, B))


def test_encode_sequences():
    seqs = [b"ACGTNacgt", "GGA", b"", b"$A"]
    np.testing.assert_array_equal(text.encode_sequences(seqs, DNA),
                                  jext.encode_sequences(seqs, DNA))


def test_port_never_imports_jax():
    """Importing every module of the port pulls in no JAX."""
    code = (
        "import sys, pkgutil, importlib, metagraph_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('metagraph_tpu.') or m == 'metagraph_tpu']\n"
        "assert not bad, bad\n")
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
