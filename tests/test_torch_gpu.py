"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. Run them on
a machine with a card (no JAX needed there) with:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Results must be bit-exact: the data are integers.
"""

import numpy as np
import pytest
import torch

from metagraph_tpu_torch.align import pallas_dp
from metagraph_tpu_torch.common import merge, packed

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _sorted_lanes(rng, n_valid, cap, L, hi_vals=1 << 62, dev="cpu"):
    if L == 1:
        hi_vals = min(hi_vals, 1 << 31)
    v = np.sort(rng.integers(0, hi_vals, n_valid, dtype=np.int64))
    lanes = np.full((L, cap), 0xFFFFFFFF, np.uint32)
    if n_valid:
        lanes[:, :n_valid] = 0
        lanes[L - 1, :n_valid] = (v & 0xFFFFFFFF).astype(np.uint32)
        if L > 1:
            lanes[L - 2, :n_valid] = (v >> 32).astype(np.uint32)
    return packed.lanes_from_numpy(lanes, dev)


def _same(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())


PART_CASES = [
    # n, capacity, keep fraction, L, payloads
    (5000, 5000, 0.5, 2, 1),
    (2048 * 7 + 13, 20000, 0.3, 3, 2),     # n off the tile, capacity > n
    (10000, 777, 0.6, 4, 1),               # capacity < count
    (4096, 4096, 0.0, 2, 0),               # nothing kept
    (4096, 4096, 1.0, 8, 2),               # everything kept, 8 lanes
    (0, 64, 0.5, 2, 1),                    # empty input
    (4096 * 5 + 9, 4096 * 5 + 9, 0.5, 1, 1),   # n not a multiple of 16
    (17, 40, 0.5, 2, 2),                   # one short tile, capacity > n
]


@pytest.mark.parametrize("n,capacity,frac,L,E", PART_CASES)
def test_partition_kernel_matches_plain(dev, n, capacity, frac, L, E):
    rng = np.random.default_rng(n + capacity + L)
    x = packed.lanes_from_numpy(
        rng.integers(0, 1 << 32, (L, n), dtype=np.uint64).astype(np.uint32),
        dev)
    keep = torch.from_numpy(rng.random(n) < frac).to(dev)
    extras = [torch.from_numpy(rng.integers(-2**31, 2**31, n)
                               .astype(np.int32)).to(dev) for _ in range(E)]
    got, gc, ge = merge.partition_compact(x, keep, capacity, *extras,
                                          extra_fill=-7)
    want, wc, we = merge.partition_compact_plain(x, keep, capacity, *extras,
                                                 extra_fill=-7)
    torch.cuda.synchronize()
    assert int(gc) == int(wc)
    _same([got, *ge], [want, *we])


MERGE_CASES = [
    # na, nb, L, payloads
    (50000, 300, 3, 1),          # few dummies into many real edges
    (30000, 29000, 4, 1),        # two halves of equal size
    (0, 5000, 2, 1),             # zero-width A
    (4000, 0, 2, 0),             # zero-width B
    (1, 1, 1, 2),
]


@pytest.mark.parametrize("na,nb,L,E", MERGE_CASES)
def test_merge_kernel_matches_plain(dev, na, nb, L, E):
    rng = np.random.default_rng(na * 3 + nb)
    a = _sorted_lanes(rng, na - na // 10, na, L, dev=dev)
    b = _sorted_lanes(rng, nb - nb // 7, nb, L, dev=dev)
    ea = [torch.arange(na, dtype=torch.int32, device=dev) for _ in range(E)]
    eb = [torch.arange(na, na + nb, dtype=torch.int32, device=dev)
          for _ in range(E)]
    got, ge = merge.merge_sorted(a, b, ea, eb)
    want, we = merge.merge_sorted_plain(a, b, ea, eb)
    torch.cuda.synchronize()
    _same([got, *ge], [want, *we])


def test_partition_kernel_unaligned_mask(dev):
    """A keep mask that starts off a 16-byte boundary (a view at offset
    1) takes the byte loads; the result is the same."""
    rng = np.random.default_rng(3)
    n = 4096 * 3 + 5
    x = packed.lanes_from_numpy(
        rng.integers(0, 1 << 32, (2, n), dtype=np.uint64).astype(np.uint32),
        dev)
    keep = torch.from_numpy(rng.random(n + 1) < 0.4).to(dev)[1:]
    got, gc, _ = merge.partition_compact(x, keep, n)
    want, wc, _ = merge.partition_compact_plain(x, keep, n)
    torch.cuda.synchronize()
    assert int(gc) == int(wc)
    _same([got], [want])


def test_merge_kernel_duplicates_and_pad(dev):
    """Heavy duplicates across both sides and all-PAD inputs: the stable
    A-first order must match the plain version's payloads exactly."""
    rng = np.random.default_rng(7)
    a = _sorted_lanes(rng, 20000, 20000, 2, hi_vals=37, dev=dev)
    b = _sorted_lanes(rng, 15000, 15000, 2, hi_vals=37, dev=dev)
    ea = [torch.arange(20000, dtype=torch.int32, device=dev)]
    eb = [torch.arange(20000, 35000, dtype=torch.int32, device=dev)]
    _same(merge.merge_sorted(a, b, ea, eb)[1],
          merge.merge_sorted_plain(a, b, ea, eb)[1])
    pad = packed.full_pad(3000, 3, dev)
    got, _ = merge.merge_sorted(pad, pad)
    want, _ = merge.merge_sorted_plain(pad, pad)
    _same([got], [want])


def test_kernels_count_launches(dev):
    x = packed.full_pad(100, 2, dev)
    keep = torch.ones(100, dtype=torch.bool, device=dev)
    p0, m0 = merge.partition_launches, merge.merge_launches
    merge.partition_compact(x, keep, 100)
    merge.merge_sorted(x, x)
    assert merge.partition_launches == p0 + 1
    assert merge.merge_launches == m0 + 1


def test_kernels_reject_bad_input(dev):
    """Malformed operands raise before a launch (9 lanes and more are
    taken: one partition launch, merge-path tiles sized by the lanes;
    past the widest merge tile the merge raises, naming the limit)."""
    keep = torch.ones(10, dtype=torch.bool, device=dev)
    x = packed.full_pad(10, 0, dev)                     # no lanes
    with pytest.raises(ValueError):
        merge.partition_compact(x, keep, 10)
    with pytest.raises(ValueError):
        merge.merge_sorted(x, x)
    wide = packed.full_pad(10, 9, dev)
    with pytest.raises(ValueError):                     # lane counts differ
        merge.merge_sorted(wide, packed.full_pad(10, 10, dev))
    with pytest.raises(ValueError):                     # three payloads
        merge.partition_compact(wide, keep, 10, *[keep.int()] * 3)
    limit = merge.merge_lane_limit(dev)
    assert limit >= 64
    widest = packed.full_pad(10, limit, dev)
    _same(merge.merge_sorted(widest, widest)[:1],
          merge.merge_sorted_plain(widest, widest)[:1])
    too_wide = packed.full_pad(10, limit + 1, dev)
    m0 = merge.merge_launches
    with pytest.raises(ValueError, match=f"at most {limit}"):
        merge.merge_sorted(too_wide, too_wide)
    assert merge.merge_launches == m0


def _keys(rng, n, L, hi, dev):
    """(L, n) random lanes, each lane below ``hi`` (few values: duplicates)."""
    return packed.lanes_from_numpy(
        rng.integers(0, hi, (L, n), dtype=np.uint64).astype(np.uint32), dev)


SORT_CASES = [
    # n (or a size in pass tiles), L, payloads, lane values below
    (0, 2, 1, 1 << 32),
    (1, 4, 2, 1 << 32),
    (2, 3, 1, 1 << 32),
    ("tile-1", 4, 1, 1 << 32),             # one partial tile
    ("tile", 2, 0, 1 << 32),               # one full tile
    ("tile+1", 3, 2, 7),                   # a last tile of one key
    ("5tile+100", 2, 1, 1 << 32),          # many tiles, ragged end
    (100_003, 4, 1, 5),                    # heavy duplicates
    ((1 << 20) + 13, 2, 0, 1 << 32),
    (5000, 8, 2, 3),                       # 8 lanes
] + [
    # every lane count of the index route up to 16, and 13: the widest
    # key the port's tests build (Protein k = 48: 49 8-bit characters)
    (n, L, E, hi)
    for L in (3, 4, 5, 8, 9, 12, 13, 16) for E in (0, 1, 2)
    for n, hi in (("tile-1", 1 << 32), ("tile", 5), ("tile+1", 1 << 32),
                  ("5tile+100", 3))
]


def _size(n):
    if isinstance(n, int):
        return n
    tile = merge._cuda.lib().mg_sort_tile()
    return {"tile-1": tile - 1, "tile": tile, "tile+1": tile + 1,
            "5tile+100": 5 * tile + 100}[n]


@pytest.mark.parametrize("n,L,E,hi", SORT_CASES)
def test_sort_kernel_matches_plain(dev, n, L, E, hi):
    n = _size(n)
    rng = np.random.default_rng(n + L)
    x = _keys(rng, n, L, hi, dev)
    x[:, rng.random(n) < 0.05] = packed.PAD_LANE
    extras = [torch.from_numpy(rng.integers(-2**31, 2**31, n)
                               .astype(np.int32)).to(dev) for _ in range(E)]
    n0 = merge.sort_launches
    got, ge = merge.sort_packed(x, *extras)
    want, we = merge.sort_packed_plain(x, *extras)
    torch.cuda.synchronize()
    assert merge.sort_launches == n0 + (1 if n else 0)
    _same([got, *ge], [want, *we])


@pytest.mark.parametrize("L", [1, 2, 3, 4, 5, 8, 9, 12, 13, 16, 40])
def test_sort_one_launch_per_call(dev, L):
    """sort_packed and lex_order count one sort launch per call at any
    lane count, with 0-2 payloads; lex_order is the plain order."""
    rng = np.random.default_rng(L)
    n = 20_011
    x = _keys(rng, n, L, 3, dev)
    x[:, rng.random(n) < 0.05] = packed.PAD_LANE
    extras = [torch.arange(n, dtype=torch.int32, device=dev)] * 2
    for E in (0, 1, 2):
        n0 = merge.sort_launches
        got, ge = merge.sort_packed(x, *extras[:E])
        assert merge.sort_launches == n0 + 1
        want, we = merge.sort_packed_plain(x, *extras[:E])
        _same([got, *ge], [want, *we])
    n0 = merge.sort_launches
    order = merge.lex_order(x)
    assert merge.sort_launches == n0 + 1
    assert order.dtype == torch.int64
    assert torch.equal(order.cpu(), packed.sort_order(x.cpu()))


SPECIAL_KINDS = {
    # kind: the digit passes the sort must run (None: not checked)
    "equal": 0, "pad": 0, "sorted": None, "reversed": None,
    "collect": 5,           # k = 20 in 2 bits: lane 0 < 256, 3 digits drop
    "ff-key": 4,            # keys 0xFF on every digit that runs, and PAD
    "middle-constant": None,  # a constant middle lane, never gathered
}


@pytest.mark.parametrize("L", [3, 9])
@pytest.mark.parametrize("kind", list(SPECIAL_KINDS))
def test_sort_kernel_special_inputs(dev, kind, L):
    """Stability on all-equal keys, all PAD, sorted and reversed input;
    constant digits skipped, a non-PAD key that reads 0xFF on every
    digit that runs kept before the PADs, and a constant middle lane
    that no pass reads."""
    n = 3 * 4096 + 777
    rng = np.random.default_rng(5)
    if kind == "equal":
        x = packed.lanes_from_numpy(np.full((L, n), 12345, np.uint32), dev)
    elif kind == "pad":
        x = packed.full_pad(n, L, dev)
    elif kind == "collect":
        lanes = np.zeros((L, n), np.uint32)
        lanes[-2:] = rng.integers(0, 1 << 32, (2, n), dtype=np.uint64)
        lanes[-2] &= 0xFF
        lanes[:, rng.random(n) < 0.1] = 0xFFFFFFFF
        x = packed.lanes_from_numpy(lanes, dev)
    elif kind == "ff-key":
        lanes = np.zeros((L, n), np.uint32)
        lanes[-1] = rng.integers(0, 3, n).astype(np.uint32) * 0x7F7F7F7F
        lanes[-1, rng.random(n) < 0.2] = 0xFFFFFFFF
        lanes[:, rng.random(n) < 0.2] = 0xFFFFFFFF
        x = packed.lanes_from_numpy(lanes, dev)
    elif kind == "middle-constant":
        lanes = rng.integers(0, 4, (L, n), dtype=np.uint64).astype(np.uint32)
        lanes[L // 2] = 0xDEADBEEF
        lanes[:, rng.random(n) < 0.1] = 0xFFFFFFFF
        x = packed.lanes_from_numpy(lanes, dev)
    else:
        x, _ = merge.sort_packed_plain(_keys(rng, n, L, 1 << 32, dev))
        if kind == "reversed":
            x = x.flip(1).contiguous()
    pay = torch.arange(n, dtype=torch.int32, device=dev)
    p0 = merge.sort_digit_passes
    got, (gp,) = merge.sort_packed(x, pay)
    want, (wp,) = merge.sort_packed_plain(x, pay)
    _same([got, gp], [want, wp])
    if SPECIAL_KINDS[kind] is not None:
        assert merge.sort_digit_passes - p0 == SPECIAL_KINDS[kind]
    if kind == "middle-constant":
        # one digit of each other lane (values 0-3); the constant lane
        # has none, so the index route never reads it
        assert merge.sort_digit_passes - p0 == L - 1


def test_sort_kernel_rejects_bad_input(dev):
    with pytest.raises(ValueError):                     # no lanes
        merge.sort_packed(packed.full_pad(10, 0, dev))
    for L in (2, 9):                # a payload that does not match the keys
        with pytest.raises(TypeError):
            merge.sort_packed(packed.full_pad(10, L, dev),
                              torch.zeros(9, dtype=torch.int32, device=dev))


def _pairs(rng, R, LQ, LR, dev):
    """Related (query, ref) pairs with random lengths and the edge rows:
    qlen 0, rlen 0, an identical pair and all-0 codes."""
    q = rng.integers(1, 5, (R, LQ)).astype(np.int32)
    r = rng.integers(1, 5, (R, LR)).astype(np.int32)
    n = min(LQ, LR)
    r[::2, :n] = q[::2, :n]
    ql = rng.integers(0, LQ + 1, R).astype(np.int32)
    rl = rng.integers(0, LR + 1, R).astype(np.int32)
    if R >= 5:
        ql[1], rl[2] = 0, 0
        r[3, :n] = q[3, :n]
        ql[3], rl[3] = n, n
        q[4], r[4] = 0, 0
    return [torch.from_numpy(x).to(dev) for x in (q, r, ql, rl)]


DP_CASES = [
    # R, LQ, LR, penalties (match, tpen, tvpen, open, ext)
    (1, 1, 1, (2, 3, 3, 5, 2)),
    (7, 33, 40, (2, 3, 3, 5, 2)),
    (33, 112, 128, (1, 1, 4, 3, 1)),
    (1000, 100, 120, (2, 3, 3, 5, 2)),
    (64, 3000, 3000, (2, 3, 3, 5, 2)),      # columns in the scratch buffer
    (9, 20, 23, (2, 1, 2, 1, 4)),           # open < ext
    # every band of the wave route (qlen + 1 = LQ + 1 on every other pair)
    # and the first query width of the long route, 257 rows
    (40, 31, 50, (2, 3, 3, 5, 2)),
    (40, 32, 50, (2, 3, 3, 5, 2)),
    (40, 63, 70, (2, 3, 3, 5, 2)),
    (40, 64, 70, (2, 1, 2, 1, 4)),
    (40, 127, 140, (2, 3, 3, 5, 2)),
    (40, 128, 140, (2, 3, 3, 5, 2)),
    (40, 255, 260, (2, 1, 2, 1, 4)),
    (40, 256, 260, (2, 3, 3, 5, 2)),
]


@pytest.mark.parametrize("R,LQ,LR,pen", DP_CASES)
def test_align_dp_kernel_matches_plain(dev, R, LQ, LR, pen):
    match, tpen, tvpen, open_p, ext_p = pen
    args = _pairs(np.random.default_rng(R + LQ), R, LQ, LR, dev)
    args[2][5::2] = LQ
    kw = dict(match=match, tpen=tpen, tvpen=tvpen, open_p=open_p,
              ext_p=ext_p)
    n0, long0 = pallas_dp.dp_launches, pallas_dp.dp_long_launches
    got = pallas_dp.batch_align_ends(*args, **kw)
    scores = pallas_dp.batch_align_scores(*args, **kw)
    torch.cuda.synchronize()
    assert pallas_dp.dp_launches == n0 + 2
    long_route = LQ + 1 > pallas_dp.WAVE_MAX_ROWS
    assert pallas_dp.dp_long_launches == long0 + 2 * long_route
    table = pallas_dp.score_table(match, tpen, tvpen, None, dev)
    want = pallas_dp.align_plain(*args, table, open_p, ext_p, True)
    _same([got, scores], [want, want[:, 0]])


def test_align_dp_routes_agree(dev):
    """The long route forced on pairs the wave route takes: both equal."""
    args = _pairs(np.random.default_rng(4), 300, 112, 128, dev)
    table = pallas_dp.score_table(2, 3, 3, None, dev)
    wave, long_ = (pallas_dp._align_cuda(*args, table, 5, 2, True, w)
                   for w in (True, False))
    _same([wave], [long_])


def test_scans_cuda_equal_cpu(dev):
    """The two-level running maximum, the cumsum and the block counts on
    the card equal their CPU results at 2^25 entries."""
    from metagraph_tpu_torch.common import ranksel
    gen = torch.Generator().manual_seed(0)
    for n in (1 << 25, (1 << 25) + 13):
        x = torch.randint(-(1 << 20), 1 << 20, (n,), dtype=torch.int32,
                          generator=gen)
        x[::1000] = torch.iinfo(torch.int32).min
        for fn in (packed.blocked_cummax, packed.blocked_cumsum):
            assert torch.equal(fn(x.to(dev)).cpu(), fn(x))
    nb = (1 << 25) // ranksel._BS
    seq = torch.randint(0, 11, (nb * ranksel._BS,), dtype=torch.int8,
                        generator=gen)
    assert torch.equal(ranksel.block_counts(seq.to(dev), 10, nb).cpu(),
                       ranksel.block_counts(seq, 10, nb))


def test_align_dp_kernel_unit_table(dev):
    unit = np.full((5, 5), -1, np.int32)
    np.fill_diagonal(unit, 1)
    unit[0, 0] = -1
    args = _pairs(np.random.default_rng(3), 50, 60, 70, dev)
    got = pallas_dp.batch_align_ends(*args, sub_tt=unit, open_p=1, ext_p=1)
    want = pallas_dp.align_plain(*args, torch.from_numpy(unit).to(dev),
                                 1, 1, True)
    _same([got], [want])


def test_align_dp_kernel_rejects_bad_input(dev):
    q, r, ql, rl = _pairs(np.random.default_rng(1), 4, 8, 8, dev)
    with pytest.raises(TypeError):
        pallas_dp.batch_align_ends(q.long(), r, ql, rl)
    with pytest.raises(ValueError):
        pallas_dp.batch_align_ends(q, r[:3], ql, rl)
    with pytest.raises(ValueError):
        pallas_dp.batch_align_ends(q, r, ql, rl,
                                   sub_tt=np.zeros((33, 33), np.int32))
    n0 = pallas_dp.dp_launches
    z = torch.zeros((0, 8), dtype=torch.int32, device=dev)
    e = torch.zeros((0,), dtype=torch.int32, device=dev)
    assert pallas_dp.batch_align_ends(z, z, e, e).shape == (0, 3)
    assert pallas_dp.dp_launches == n0


def test_aligner_cuda_equals_cpu(dev):
    """align_batch on the card equals the CPU run field for field, with
    and without CIGARs, on a graph the port builds on each device."""
    from metagraph_tpu_torch.align.aligner import Aligner
    from metagraph_tpu_torch.graph.boss_construct import build_boss_from_codes
    from metagraph_tpu_torch.graph.dbg_succinct import DbgSuccinct
    rng = np.random.default_rng(11)
    codes = rng.integers(1, 5, 5000).astype(np.uint8)
    letters = np.frombuffer(b"$ACGT", np.uint8)
    ref = letters[codes].tobytes()
    reads = []
    for i in range(64):
        p = int(rng.integers(0, len(ref) - 100))
        r = bytearray(ref[p:p + 100])
        r[int(rng.integers(10, 90))] = ord("A")
        reads.append(bytes(r) if i % 4 else ref[p:p + 11])
    graphs = [DbgSuccinct.from_boss(build_boss_from_codes(
        codes, 20, mode="basic", device=d), mode="basic")
        for d in (dev, "cpu")]
    for with_cigar in (True, False):
        got, want = (Aligner(g).align_batch(reads, with_cigar=with_cigar)
                     for g in graphs)
        for gs, ws in zip(got, want):
            assert len(gs) == len(ws)
            for a, b in zip(gs, ws):
                assert (a.score, a.cigar, a.query_begin, a.query_end,
                        a.sequence, a.orientation) == \
                    (b.score, b.cigar, b.query_begin, b.query_end,
                     b.sequence, b.orientation)
                assert np.array_equal(a.nodes, b.nodes)


def _same_boss(a, b):
    for name in ("W", "last", "F", "NF", "weights", "edge_lanes"):
        assert torch.equal(getattr(a, name).cpu(), getattr(b, name).cpu()), \
            name


@pytest.mark.parametrize("k", [11, 31])
def test_primary_build_cuda_equals_cpu(dev, k):
    """The finish over sorts of all real edges (primary mode) at 2^16
    codes with read breaks: the card's build equals the CPU build."""
    from metagraph_tpu_torch.graph.boss_construct import build_boss_from_codes
    rng = np.random.default_rng(k)
    codes = rng.integers(1, 5, 1 << 16).astype(np.uint8)
    codes[rng.integers(0, len(codes), 200)] = 255
    n0 = merge.sort_launches
    got, want = (build_boss_from_codes(codes, k, mode="primary",
                                       bits_per_count=8, device=d)
                 for d in (dev, "cpu"))
    assert merge.sort_launches > n0
    _same_boss(got, want)


@pytest.mark.parametrize("mode", ["basic", "canonical"])
def test_kmc_build_cuda_equals_cpu(dev, mode):
    """Pre-counted k-mers (the KMC path: _sort_unique_stage, then the
    finish without candidates) from 2^16 codes: card equals CPU."""
    from metagraph_tpu_torch.graph.boss_construct import (
        build_boss_from_kmers, collect_counted_kmers)
    k = 31
    codes = np.random.default_rng(7).integers(1, 5, 1 << 16).astype(np.uint8)
    win = np.lib.stride_tricks.sliding_window_view(codes, k)
    chars, counts = np.unique(np.concatenate([win, win[:5000]]), axis=0,
                              return_counts=True)
    bosses = []
    for d in (dev, "cpu"):
        lanes, cnts, n = collect_counted_kmers(
            chars, counts, k, canonical=mode == "canonical", device=d)
        bosses.append(build_boss_from_kmers(lanes, cnts, n, k, mode=mode,
                                            bits_per_count=8))
    _same_boss(*bosses)


@pytest.mark.parametrize("mode", ["basic", "primary"])
def test_boss_navigation_cuda_equals_cpu(dev, mode):
    """The BOSS navigation of stats --validate (rank / select over W and
    last, fwd, bwd, the dummy counts) on every row: card equals
    CPU, and the validation passes on the card."""
    from metagraph_tpu_torch.cli.main import validate_graph
    from metagraph_tpu_torch.graph.boss_construct import build_boss_from_codes
    from metagraph_tpu_torch.graph.dbg_succinct import DbgSuccinct
    codes = np.random.default_rng(3).integers(1, 5, 1 << 14).astype(np.uint8)
    got, want = (build_boss_from_codes(codes, 15, mode=mode, device=d)
                 for d in (dev, "cpu"))
    m, sigma = want.num_edges, 2 * want.alph_size
    rows = torch.arange(0, m + 1)
    i = rows.repeat(sigma)
    c = torch.arange(sigma).repeat_interleave(m + 1)
    r = torch.arange(1, int(want.num_nodes()) + 1)
    for name, args in (("get_W", (rows,)), ("rank_last", (rows,)),
                       ("select_last", (r,)),
                       ("get_node_last_value", (rows,)),
                       ("rank_W", (i, c)), ("bwd", (rows[1:],))):
        assert torch.equal(
            getattr(got, name)(*(a.to(dev) for a in args)).cpu(),
            getattr(want, name)(*args)), name
    # every occurrence of every symbol in W[1..m]
    totals = want.rank_W(torch.full((sigma,), m), torch.arange(sigma)).long()
    cs = torch.arange(sigma).repeat_interleave(totals)
    rs = torch.cat([torch.arange(1, int(t) + 1) for t in totals])
    assert torch.equal(got.select_W(rs.to(dev), cs.to(dev)).cpu(),
                       want.select_W(rs, cs))
    W = want.W[1:].long()
    real = (W % want.alph_size) != 0
    fi, fc = rows[1:][real], (W % want.alph_size)[real]
    assert torch.equal(got.fwd(fi.to(dev), fc.to(dev)).cpu(),
                       want.fwd(fi, fc))
    assert [int(x) for x in got.num_dummy_edges()] == \
        [int(x) for x in want.num_dummy_edges()]
    assert validate_graph(DbgSuccinct.from_boss(got, mode=mode)) == []


def test_query_modes_cuda_equal_cpu(dev):
    """--query-counts, --count-quantiles and --print-signature on a count
    annotation: the card's results equal the CPU's."""
    from metagraph_tpu_torch.engine.annotated_dbg import (
        AnnotatedDbg, BatchQuery, annotate_sequences)
    from metagraph_tpu_torch.graph.boss_construct import build_boss_from_codes
    from metagraph_tpu_torch.graph.dbg_succinct import DbgSuccinct
    rng = np.random.default_rng(9)
    codes = rng.integers(1, 5, 1 << 14).astype(np.uint8)
    letters = np.frombuffer(b"$ACGT", np.uint8)
    recs = [letters[codes[i:i + 512]].tobytes() for i in range(0, 1 << 14,
                                                               512)]
    reads = [r[a:a + 80] for r in recs for a in (0, 100, 300)]
    reads += [letters[rng.integers(1, 5, 80)].tobytes(), b"ACG"]
    out = []
    for d in (dev, "cpu"):
        g = DbgSuccinct.from_boss(build_boss_from_codes(codes, 21, device=d))
        ann = annotate_sequences(g, [(s, [f"L{i % 5}", f"R{i}"]) for i, s in
                                     enumerate(recs + recs[:4])],
                                 with_counts=True).finalize()
        bq = BatchQuery(AnnotatedDbg(graph=g, annotation=ann))
        out.append((bq.get_top_labels_batch(reads, 3, 0.5,
                                            with_kmer_counts=True),
                    bq.get_label_count_quantiles_batch(reads, 2 ** 62, 0.2,
                                                       (0, 0.5, 1)),
                    [[(lab, m.tolist()) for lab, m in res] for res in
                     bq.get_top_label_signatures_batch(reads, 2, 0.0)]))
    assert out[0] == out[1]


def test_primary_aligner_cuda_equals_cpu(dev):
    """Alignment on a primary graph (CanonicalDbg) on the card equals the
    CPU run field for field; a read that needs suffix seeds raises on
    the card as on the CPU."""
    from metagraph_tpu_torch.align.aligner import (Aligner,
                                                   SuffixSeedsOnPrimaryGraph)
    from metagraph_tpu_torch.graph.boss_construct import build_boss_from_codes
    from metagraph_tpu_torch.graph.canonical import CanonicalDbg
    from metagraph_tpu_torch.graph.dbg_succinct import DbgSuccinct
    rng = np.random.default_rng(12)
    codes = rng.integers(1, 5, 6000).astype(np.uint8)
    ref = np.frombuffer(b"$ACGT", np.uint8)[codes].tobytes()
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    reads = []
    for i in range(64):
        p = int(rng.integers(0, len(ref) - 100))
        r = bytearray(ref[p:p + 100])
        r[int(rng.integers(10, 90))] = ord("A")
        reads.append(bytes(r) if i % 2 else bytes(r).translate(comp)[::-1])
    aligners = [Aligner(CanonicalDbg(base=DbgSuccinct.from_boss(
        build_boss_from_codes(codes, 21, mode="primary", device=d),
        mode="primary"))) for d in (dev, "cpu")]
    for with_cigar in (True, False):
        got, want = (a.align_batch(reads, with_cigar=with_cigar)
                     for a in aligners)
        for gs, ws in zip(got, want):
            assert len(gs) == len(ws) == 1
            for a, b in zip(gs, ws):
                assert (a.score, a.cigar, a.query_begin, a.query_end,
                        a.sequence, a.orientation) == \
                    (b.score, b.cigar, b.query_begin, b.query_end,
                     b.sequence, b.orientation)
                assert np.array_equal(a.nodes, b.nodes)
    with pytest.raises(SuffixSeedsOnPrimaryGraph):
        aligners[0].align_batch([b"ACGTACGTAC"])


WIDE_CASES = [(L, E) for L in (5, 6, 7, 8) for E in (0, 1, 2)]


@pytest.mark.parametrize("L,E", WIDE_CASES)
def test_wide_lane_kernels_match_plain(dev, L, E):
    """The three build kernels at 5 to 8 lanes (DNA5 / DNACaseSent past
    k = 32, Protein past k = 16): sort_packed (a ragged last tile, PAD
    mixed in, Protein's 8-bit fields), partition_compact and
    merge_sorted with 0-2 payloads."""
    rng = np.random.default_rng(100 * L + E)
    tile = merge._cuda.lib().mg_sort_tile()
    n = 3 * tile + 101
    x = rng.integers(0, 27, (L, n, 4), dtype=np.uint32)   # Protein fields
    lanes = (x[..., 0] << 24) | (x[..., 1] << 16) | (x[..., 2] << 8) | x[..., 3]
    lanes[:, rng.random(n) < 0.05] = 0xFFFFFFFF
    xs = packed.lanes_from_numpy(lanes.astype(np.uint32), dev)
    extras = [torch.from_numpy(rng.integers(-2**31, 2**31, n)
                               .astype(np.int32)).to(dev) for _ in range(E)]
    p0 = merge.sort_digit_passes
    got, ge = merge.sort_packed(xs, *extras)
    want, we = merge.sort_packed_plain(xs, *extras)
    _same([got, *ge], [want, *we])
    # each 8-bit digit is one field of 27 values (its top three bits
    # always zero): no digit is constant, so all 4 L run
    assert merge.sort_digit_passes - p0 == 4 * L
    keep = torch.from_numpy(rng.random(n) < 0.5).to(dev)
    g = merge.partition_compact(xs, keep, n, *extras, extra_fill=-1)
    w = merge.partition_compact_plain(xs, keep, n, *extras, extra_fill=-1)
    assert int(g[1]) == int(w[1])
    _same([g[0], *g[2]], [w[0], *w[2]])
    b = _sorted_lanes(rng, 900, 1000, L, dev=dev)
    eb = [torch.arange(1000, dtype=torch.int32, device=dev)
          for _ in range(E)]
    gm = merge.merge_sorted(want, b, we, eb)
    wm = merge.merge_sorted_plain(want, b, we, eb)
    _same([gm[0], *gm[1]], [wm[0], *wm[1]])


@pytest.mark.parametrize("sigma", [27, 32])
@pytest.mark.parametrize("LQ", [100, 300])
def test_align_dp_kernel_wide_tables(dev, sigma, LQ):
    """pallas_dp with the Protein BLOSUM62 table (sigma = 27) and a full
    32 x 32 table, on the wave route (LQ + 1 <= 256) and the long one."""
    from metagraph_tpu_torch.align.aligner import blosum62_matrix
    from metagraph_tpu_torch.kmer.alphabets import PROTEIN
    rng = np.random.default_rng(sigma + LQ)
    tab = (blosum62_matrix(PROTEIN) if sigma == 27
           else rng.integers(-6, 7, (32, 32)).astype(np.int32))
    R = 200
    q = rng.integers(0, sigma, (R, LQ)).astype(np.int32)
    r = rng.integers(0, sigma, (R, LQ + 20)).astype(np.int32)
    r[::2, :LQ] = q[::2]
    ql = rng.integers(0, LQ + 1, R).astype(np.int32)
    rl = rng.integers(0, LQ + 21, R).astype(np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (q, r, ql, rl)]
    long0 = pallas_dp.dp_long_launches
    got = pallas_dp.batch_align_ends(*args, sub_tt=tab, open_p=11, ext_p=1)
    want = pallas_dp.align_plain(*args, torch.from_numpy(tab).to(dev), 11, 1,
                                 True)
    _same([got], [want])
    assert (pallas_dp.dp_long_launches > long0) == (
        LQ + 1 > pallas_dp.WAVE_MAX_ROWS)


def _alphabet_codes(rng, name, n):
    """n codes of an alphabet: Protein's twenty amino acids, DNA5 with N
    one code in a hundred, DNACaseSent in runs of upper and lower case;
    a read break every 1000 codes."""
    from metagraph_tpu_torch.kmer.alphabets import ALPHABETS
    alph = ALPHABETS[name]
    if name == "Protein":
        letters = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
        seq = rng.choice(letters, n)
    else:
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), n)
        seq[rng.random(n) < 0.01] = ord("N")
        if name == "DNACaseSent":
            seq = np.where((np.arange(n) // 1000) % 2 == 1, seq | 0x20, seq)
    codes = alph.encode_table()[seq]
    codes[999::1000] = 255
    return codes.astype(np.uint8)


@pytest.mark.parametrize("name,mode,k", [
    ("Protein", "basic", 31), ("Protein", "basic", 7),
    ("DNA5", "canonical", 31), ("DNA5", "basic", 13),
    ("DNACaseSent", "primary", 31), ("DNACaseSent", "canonical", 15)])
def test_alphabet_builds_cuda_equal_cpu(dev, name, mode, k):
    """The B-bit collect and the finish over each alphabet at 2^16 codes:
    the card's build equals the CPU build, array for array."""
    from metagraph_tpu_torch.graph.boss_construct import build_boss_from_codes
    from metagraph_tpu_torch.kmer.alphabets import ALPHABETS
    codes = _alphabet_codes(np.random.default_rng(k), name, 1 << 16)
    p0 = merge.partition_launches
    got, want = (build_boss_from_codes(codes, k, ALPHABETS[name], mode=mode,
                                       bits_per_count=8, device=d)
                 for d in (dev, "cpu"))
    assert merge.partition_launches > p0
    _same_boss(got, want)


def test_small_state_cuda_equals_cpu(dev, tmp_path):
    """A small-state graph on the card maps reads (the walk and its
    stragglers), finds suffix ranges and aligns as on the CPU."""
    from metagraph_tpu_torch.align.aligner import Aligner
    from metagraph_tpu_torch.graph import io as graph_io
    from metagraph_tpu_torch.graph.boss_construct import build_boss_from_codes
    from metagraph_tpu_torch.graph.dbg_succinct import DbgSuccinct
    rng = np.random.default_rng(21)
    codes = rng.integers(1, 5, 20000).astype(np.uint8)
    g = DbgSuccinct.from_boss(build_boss_from_codes(codes, 20, device="cpu"))
    p = graph_io.save_graph(str(tmp_path / "g"), g, state="small")
    gs = [graph_io.load_graph(p, device=d) for d in (dev, "cpu")]
    assert gs[0].boss.edge_lanes is None
    ref = np.frombuffer(b"$ACGT", np.uint8)[codes].tobytes()
    reads = []
    for i in range(200):
        a = int(rng.integers(0, len(ref) - 100))
        r = bytearray(ref[a:a + 100])
        if i % 3 == 0:
            r[int(rng.integers(0, 100))] = ord("A")
        reads.append(bytes(r) if i % 10 else bytes(
            rng.choice(np.frombuffer(b"ACGT", np.uint8), 100)))
    got, want = (x.map_read_batch(reads) for x in gs)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    pat = torch.from_numpy(rng.integers(1, 5, (300, 12)))
    for a, b in zip(gs[0].boss.suffix_range_ranksel(pat.to(dev)),
                    gs[1].boss.suffix_range_ranksel(pat)):
        assert torch.equal(a.cpu(), b)
    got, want = (Aligner(x).align_batch(reads[:40], with_cigar=False)
                 for x in gs)
    for gs_, ws in zip(got, want):
        assert [(a.score, a.cigar, a.sequence) for a in gs_] == \
            [(b.score, b.cigar, b.sequence) for b in ws]


@pytest.mark.parametrize("mode", ["basic", "canonical", "primary"])
def test_traversal_cuda_equals_cpu(dev, mode, tmp_path):
    """Unitig decomposition, unitigs and contigs of a 2^16-code graph
    with read breaks and repeats on the card equal the CPU port's, also
    on a masked graph and under clean_node_mask."""
    from metagraph_tpu_torch.graph import io as graph_io
    from metagraph_tpu_torch.graph import traversal as tt
    from metagraph_tpu_torch.graph.boss_construct import build_boss_from_codes
    from metagraph_tpu_torch.graph.canonical import CanonicalDbg
    from metagraph_tpu_torch.graph.cleaning import clean_node_mask
    from metagraph_tpu_torch.graph.dbg_succinct import DbgSuccinct
    from metagraph_tpu_torch.graph.masked import MaskedDbg
    rng = np.random.default_rng(40)
    codes = rng.integers(1, 5, 1 << 16).astype(np.uint8)
    codes[rng.integers(0, len(codes), 100)] = 255
    rep = codes[1000:1400].copy()
    for at in (9000, 30000, 51000):                  # branches
        codes[at:at + 400] = rep
    g = DbgSuccinct.from_boss(build_boss_from_codes(
        codes, 15, mode=mode, bits_per_count=8, device="cpu"),
        mode=mode)
    p = graph_io.save_graph(str(tmp_path / "g"), g)
    gs = [graph_io.load_graph(p, device=d) for d in (dev, "cpu")]
    if mode == "primary":
        gs = [CanonicalDbg(base=x) for x in gs]
    got, want = (tt.unitig_decomposition(x) for x in gs)
    for f in ("chain_id", "pos", "starts", "lengths", "is_cycle"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    a, b = (tt.contig_sequences(x, return_paths=True) for x in gs)
    assert a[0] == b[0] and len(a[1]) == len(b[1])
    assert all(np.array_equal(x, y) for x, y in zip(a[1], b[1]))
    assert tt.unitig_sequences(gs[0]) == tt.unitig_sequences(gs[1])
    mask = rng.random(gs[1].num_nodes() + 1) < 0.6
    ms = [MaskedDbg(base=x, mask=mask) for x in gs]
    assert tt.contig_sequences(ms[0]) == tt.contig_sequences(ms[1])
    if mode != "primary":
        assert torch.equal(tt.single_form_mask(gs[0]).cpu(),
                           tt.single_form_mask(gs[1]))
        got, want = (clean_node_mask(x, min_count=2, prune_unitigs=3,
                                     min_tip_size=30) for x in gs)
        assert torch.equal(got.cpu(), want)


ANNO_FORMS = ["row_diff", "int_row_diff", "row_diff_brwt", "brwt",
              "relaxed_brwt", "int_brwt", "row_diff_int_brwt", "unique_row",
              "rb_brwt", "coord", "tuple_row_diff"]


@pytest.mark.parametrize("form", ANNO_FORMS)
def test_anno_forms_cuda_equal_cpu(dev, form, tmp_path):
    """Every compressed and coordinate form of an annotation of a 2^15-code
    graph (read breaks, repeats) built on the card has the CPU build's
    arrays and answers the batched query alike; the row-diff builds
    launch the sort and partition kernels."""
    from metagraph_tpu_torch.anno import brwt, coords, int_brwt, row_diff
    from metagraph_tpu_torch.anno.unique_row import UniqueRow
    from metagraph_tpu_torch.engine.annotated_dbg import (
        AnnotatedDbg, BatchQuery, annotate_sequences)
    from metagraph_tpu_torch.graph import io as graph_io
    from metagraph_tpu_torch.graph.boss_construct import build_boss_from_codes
    from metagraph_tpu_torch.graph.dbg_succinct import DbgSuccinct
    rng = np.random.default_rng(50)
    codes = rng.integers(1, 5, 1 << 15).astype(np.uint8)
    codes[rng.integers(0, len(codes), 40)] = 255
    codes[9000:9300] = codes[1000:1300]
    g = DbgSuccinct.from_boss(build_boss_from_codes(codes, 15, device="cpu"))
    p = graph_io.save_graph(str(tmp_path / "g"), g)
    gs = [graph_io.load_graph(p, device=d) for d in (dev, "cpu")]
    text = np.frombuffer(b"$ACGT", np.uint8)[np.where(codes == 255, 0,
                                                      codes)].tobytes()
    recs = [text[i:i + 800] for i in range(0, len(text), 800)]
    items = [(r, [f"l{i % 5}"]) for i, r in enumerate(recs)]
    build = {
        "row_diff": lambda m, x: row_diff.build_row_diff(m, x, 16),
        "int_row_diff": lambda m, x: row_diff.build_int_row_diff(m, x, 16),
        "row_diff_brwt": lambda m, x: row_diff.build_row_diff_brwt(m, x, 16),
        "brwt": lambda m, x: brwt.build_brwt(m, subsample=5000),
        "relaxed_brwt": lambda m, x: brwt.relax_brwt(brwt.build_brwt(m), 4),
        "int_brwt": lambda m, x: int_brwt.build_int_brwt(m),
        "row_diff_int_brwt": lambda m, x: int_brwt.build_int_row_diff_brwt(
            m, x, 16),
        "unique_row": lambda m, x: UniqueRow.from_row_sparse(m),
        "rb_brwt": lambda m, x: UniqueRow.from_row_sparse(m)
        .with_brwt_distinct(),
        "coord": lambda m, x: m,
        "tuple_row_diff": lambda m, x: coords.build_tuple_row_diff(m, x, 16),
    }[form]
    anns = []
    for x in gs:
        if form in ("coord", "tuple_row_diff"):
            a = coords.annotate_coordinates(x, items).finalize()
        else:
            a = annotate_sequences(x, items,
                                   with_counts="int" in form).finalize()
        merge.sort_launches = merge.partition_launches = 0
        a.matrix = build(a.matrix, x)
        if x is gs[0] and ("row_diff" in form or form == "int_row_diff"):
            assert merge.sort_launches > 0 and merge.partition_launches > 0
        anns.append(a)
    want = anns[1].matrix.to_npz_dict()
    got = anns[0].matrix.to_npz_dict()
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert np.array_equal(got[key], want[key]), key
    reads = [recs[int(i)][50:150] for i in rng.integers(0, len(recs), 150)]
    reads += [bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 100))
              for _ in range(50)]
    bqs = [BatchQuery(AnnotatedDbg(graph=x, annotation=a))
           for x, a in zip(gs, anns)]
    assert bqs[0].get_top_labels_batch(reads, with_kmer_counts=True) == \
        bqs[1].get_top_labels_batch(reads, with_kmer_counts=True)
    if form in ("coord", "tuple_row_diff"):
        assert bqs[0].get_kmer_coordinates_batch(reads[:40]) == \
            bqs[1].get_kmer_coordinates_batch(reads[:40])


WALKED_FORMS = ["row_diff", "int_row_diff", "row_diff_brwt",
                "row_diff_int_brwt", "tuple_row_diff"]


@pytest.mark.parametrize("form", WALKED_FORMS)
def test_row_api_cuda_equals_cpu(dev, form):
    """The row API of a walked form (built on the CPU, loaded on the card
    from its arrays) on 2^12 rows, half without a bit, duplicates
    included: every call's answer on the card equals the CPU's, comes
    back on the card, and folds through the sort and partition
    kernels."""
    from metagraph_tpu_torch.anno import coords, int_brwt, row_diff
    from metagraph_tpu_torch.anno.annotator import annotation_from_numpy
    from metagraph_tpu_torch.engine.annotated_dbg import annotate_sequences
    from metagraph_tpu_torch.graph.boss_construct import build_boss_from_codes
    from metagraph_tpu_torch.graph.dbg_succinct import DbgSuccinct
    rng = np.random.default_rng(51)
    codes = rng.integers(1, 5, 1 << 15).astype(np.uint8)
    codes[9000:9300] = codes[1000:1300]
    g = DbgSuccinct.from_boss(build_boss_from_codes(codes, 15, device="cpu"))
    text = np.frombuffer(b"$ACGT", np.uint8)[codes].tobytes()
    items = [(text[i:i + 800], [f"l{(i // 800) % 5}"])
             for i in range(0, len(text) // 2, 800)]
    if form == "tuple_row_diff":
        m = coords.build_tuple_row_diff(
            coords.annotate_coordinates(g, items).finalize().matrix, g, 16)
    else:
        a = annotate_sequences(g, items, with_counts="int" in form).finalize()
        m = {"row_diff": row_diff.build_row_diff,
             "int_row_diff": row_diff.build_int_row_diff,
             "row_diff_brwt": row_diff.build_row_diff_brwt,
             "row_diff_int_brwt": int_brwt.build_int_row_diff_brwt}[form](
            a.matrix, g, 16)
    d = dict(m.to_npz_dict(), labels=np.array(["x"] * m.num_cols))
    cpu, card = (annotation_from_numpy(d, x).matrix for x in ("cpu", dev))
    n = m.num_rows
    rows = np.concatenate([rng.integers(0, n // 2, 1 << 11),
                           rng.integers(n // 2 + 2000, n, 1 << 11)])
    w = rng.integers(1, 6, len(rows))
    calls = [("get_rows_dense", (rows,)), ("sum_rows", (rows, w)),
             ("get_rows", (rows,))]
    if m.has_values:
        calls += [("get_row_values_dense", (rows,)),
                  ("sum_row_values", (rows, w)), ("row_values_list", (rows,))]
    for name, args in calls:
        merge.sort_launches = merge.partition_launches = 0
        got, want = (getattr(x, name)(*args) for x in (card, cpu))
        torch.cuda.synchronize()
        assert merge.sort_launches > 0 and merge.partition_launches > 0, name
        if name == "get_rows":
            assert got == want
            continue
        for g_, w_ in zip(*((x,) if isinstance(x, torch.Tensor) else x
                            for x in (got, want))):
            assert g_.device.type == "cuda"
            assert torch.equal(g_.cpu(), w_), name


def test_navigation_calls_cuda_equal_cpu(dev):
    """get_last, succ_last, succ_W (every symbol), rank0 and
    index_range_nodes on every row of a 2^14-code graph: card equals
    CPU."""
    from metagraph_tpu_torch.graph.boss_construct import build_boss_from_codes
    codes = np.random.default_rng(4).integers(1, 5, 1 << 14).astype(np.uint8)
    got, want = (build_boss_from_codes(codes, 15, device=d)
                 for d in (dev, "cpu"))
    m, sigma = want.num_edges, 2 * want.alph_size
    rows = torch.arange(-1, m + 3)
    i = torch.arange(0, m + 2).repeat(sigma)
    c = torch.arange(sigma).repeat_interleave(m + 2)
    for name, args in (("get_last", (rows,)), ("succ_last", (rows,)),
                       ("succ_W", (i, c))):
        assert torch.equal(
            getattr(got, name)(*(a.to(dev) for a in args)).cpu(),
            getattr(want, name)(*args)), name
    assert torch.equal(got.last_rank.rank0(rows.to(dev)).cpu(),
                       want.last_rank.rank0(rows))
    nodes = packed.set_field(want.edge_lanes, 0, torch.zeros(
        m, dtype=torch.int32), want.bits_per_char)
    _same(got.index_range_nodes(nodes.to(dev)),
          want.index_range_nodes(nodes))


# ---------------------------------------------------------------------------
# the scale-out builds (parallel/, anno/row_diff_disk.py)
# ---------------------------------------------------------------------------

def _scaleout_codes(seed=60, n=1 << 18):
    rng = np.random.default_rng(seed)
    codes = rng.integers(1, 5, n).astype(np.uint8)
    codes[rng.integers(0, n, 300)] = 255                   # read breaks
    codes[5000:9000] = codes[100000:104000]                # repeats
    text = np.frombuffer(b"$ACGT", np.uint8)[np.where(codes == 255, 0,
                                                      codes)].tobytes()
    return codes, [text[i:i + 4096] for i in range(0, len(text), 4096)]


def _same_small(got, want):
    for f in ("W", "last", "F", "weights"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a.cpu(), b.cpu()), f


@pytest.mark.parametrize("K,suffix", [(20, (1, 2)), (31, (4,))])
def test_suffix_filter_cuda_equals_cpu(dev, K, suffix):
    """The suffix filter through the partition kernel at 2^18 codes."""
    from metagraph_tpu_torch.kmer.extractor import extract_packed_kmers
    codes, _ = _scaleout_codes()
    t = torch.from_numpy(codes)
    n0 = merge.partition_launches
    got = extract_packed_kmers(t.to(dev), K, 4, suffix)
    assert merge.partition_launches == n0 + 1
    want = extract_packed_kmers(t, K, 4, suffix)
    assert int(got[1]) == int(want[1]) > 0
    assert torch.equal(got[0].cpu(), want[0])


@pytest.mark.parametrize("mode", ["basic", "canonical", "primary"])
def test_sharded_build_cuda_equals_cpu(dev, mode):
    from metagraph_tpu_torch.parallel.sharded_build import build_boss_sharded
    _, recs = _scaleout_codes(61)
    got, want = (build_boss_sharded(recs, 20, mode=mode, bits_per_count=8,
                                    suffix_len=2, device=d)
                 for d in (dev, "cpu"))
    _same_boss(got, want)


@pytest.mark.parametrize("disk", [False, True])
def test_streaming_build_cuda_equals_cpu(dev, tmp_path, disk):
    from metagraph_tpu_torch.parallel.streaming import build_boss_streaming
    _, recs = _scaleout_codes(62)
    kw = dict(mode="canonical", bits_per_count=8, chunk_codes=1 << 16,
              disk_dir=str(tmp_path) if disk else None)
    n0 = merge.merge_launches
    got = build_boss_streaming(recs, 31, device=dev, **kw)
    assert merge.merge_launches > n0 + 1          # the run merges
    _same_boss(got, build_boss_streaming(recs, 31, device="cpu", **kw))


@pytest.mark.parametrize("bits", [0, 8])
def test_out_of_core_cuda_equals_cpu(dev, bits):
    from metagraph_tpu_torch.parallel.outofcore import build_boss_out_of_core
    _, recs = _scaleout_codes(63)
    kw = dict(n_shards=8, bits_per_count=bits, chunk_codes=1 << 16,
              return_valid=True)
    (got, gv), (want, wv) = (
        build_boss_out_of_core(recs, 20, device=d, **kw)
        for d in (dev, "cpu"))
    _same_small(got, want)
    assert np.array_equal(gv, wv)


def test_out_of_core_merge_cuda_equals_cpu(dev):
    from metagraph_tpu_torch.graph.boss_construct import build_boss
    from metagraph_tpu_torch.graph.dbg_succinct import DbgSuccinct
    from metagraph_tpu_torch.parallel.outofcore import (
        merge_boss_graphs_out_of_core)
    _, recs = _scaleout_codes(64)
    out = []
    for d in (dev, "cpu"):
        gs = [DbgSuccinct.from_boss(build_boss(part, 31, bits_per_count=8,
                                               device=d))
              for part in (recs[:40], recs[30:])]
        out.append(merge_boss_graphs_out_of_core(gs, n_shards=4,
                                                 keep_kmer_index=True,
                                                 device=d))
    _same_boss(*out)


def test_out_of_core_peak_bound(dev):
    """The device working set: at 2^22 codes and 8 shards the
    out-of-core build peaks at most half the in-core build's bytes."""
    from metagraph_tpu_torch.graph.boss_construct import build_boss_from_codes
    from metagraph_tpu_torch.parallel.outofcore import build_boss_out_of_core
    codes = np.random.default_rng(65).integers(1, 5, 1 << 22).astype(np.uint8)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    incore = build_boss_from_codes(codes, 20, device=dev)
    peak_in = torch.cuda.max_memory_allocated() - base
    del incore
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build_boss_out_of_core([codes], 20, n_shards=8, chunk_codes=1 << 20,
                           device=dev)
    peak_ooc = torch.cuda.max_memory_allocated() - base
    assert peak_ooc <= peak_in // 2, (peak_ooc, peak_in)


@pytest.mark.parametrize("int_form", [False, True])
def test_row_diff_staged_cuda_equals_cpu(dev, tmp_path, int_form):
    from metagraph_tpu_torch.anno import row_diff_disk
    from metagraph_tpu_torch.engine.annotated_dbg import annotate_sequences
    from metagraph_tpu_torch.graph import io as graph_io
    from metagraph_tpu_torch.graph.boss_construct import build_boss_from_codes
    from metagraph_tpu_torch.graph.dbg_succinct import DbgSuccinct
    codes, recs = _scaleout_codes(66)
    g = DbgSuccinct.from_boss(build_boss_from_codes(codes, 20, device="cpu"))
    p = graph_io.save_graph(str(tmp_path / "g"), g)
    ann = annotate_sequences(g, [(r, [f"l{i % 7}"]) for i, r in
                                 enumerate(recs)],
                             with_counts=int_form).finalize()
    path = str(tmp_path / "a.column.annodbg.npz")
    ann.save(path)
    build = (row_diff_disk.build_int_row_diff_staged if int_form
             else row_diff_disk.build_row_diff_staged)
    got, want = (build([path], graph_io.load_graph(p, device=d),
                       swap_dir=str(tmp_path / d.__str__()), mem_cap_mb=1,
                       max_length=16).matrix.to_npz_dict()
                 for d in (dev, "cpu"))
    assert sorted(got) == sorted(want)
    for key in want:
        assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("L", [9, 10, 12, 16, 64])
def test_past_eight_lanes_match_plain(dev, L):
    """Past 8 lanes: sort_packed (0 and 2 payloads, one launch a call),
    partition_compact in one launch (one count), and the merge's
    merge-path tiles (|B| << |A| and |A| = |B|, ties and PAD); L = 12
    needs the merge's shared-memory opt-in, L = 64 a smaller tile."""
    rng = np.random.default_rng(L)
    n = 50_003
    lanes = rng.integers(0, 1 << 32, (L, n), dtype=np.uint64).astype(
        np.uint32)
    lanes[: L - 1] = rng.integers(0, 3, (L - 1, n))       # equal keys
    lanes[:, rng.random(n) < 0.05] = 0xFFFFFFFF
    xs = packed.lanes_from_numpy(lanes, dev)
    extras = [torch.arange(n, dtype=torch.int32, device=dev),
              torch.from_numpy(rng.integers(-2**31, 2**31, n)
                               .astype(np.int32)).to(dev)]
    s0, p0, m0 = (merge.sort_launches, merge.partition_launches,
                  merge.merge_launches)
    for E in (0, 2):
        got, ge = merge.sort_packed(xs, *extras[:E])
        want, we = merge.sort_packed_plain(xs, *extras[:E])
        _same([got, *ge], [want, *we])
    keep = torch.from_numpy(rng.random(n) < 0.5).to(dev)
    for cap in (n, 777):
        g = merge.partition_compact(xs, keep, cap, *extras, extra_fill=-1)
        w = merge.partition_compact_plain(xs, keep, cap, *extras,
                                          extra_fill=-1)
        assert int(g[1]) == int(w[1])
        _same([g[0], *g[2]], [w[0], *w[2]])
    a, (ea,) = merge.sort_packed_plain(xs, extras[0])
    for nb in (300, n):
        b, (eb,) = merge.sort_packed_plain(xs[:, :nb].flip(1).contiguous(),
                                           extras[1][:nb])
        gm = merge.merge_sorted(a, b, (ea,), (eb,))
        wm = merge.merge_sorted_plain(a, b, (ea,), (eb,))
        _same([gm[0], *gm[1]], [wm[0], *wm[1]])
    assert merge.sort_launches - s0 == 2
    assert merge.partition_launches - p0 == 2
    assert merge.merge_launches - m0 == 2


@pytest.mark.parametrize("L", [12, 64])
def test_past_eight_lanes_edge_cases(dev, L):
    """The one-launch partition and the merge-path tiles past 8 lanes at
    their edges, bit-exact against the plain versions: capacity below
    the count and above N, nothing kept, an empty input; an empty side,
    all-PAD operands, heavy duplicates across both sides (ties to A)."""
    rng = np.random.default_rng(100 + L)
    n = 20_011
    xs = packed.lanes_from_numpy(
        rng.integers(0, 1 << 32, (L, n), dtype=np.uint64).astype(np.uint32),
        dev)
    ex = [torch.arange(n, dtype=torch.int32, device=dev)]
    for cap, frac, m in ((500, 0.6, n), (n + 4099, 0.3, n), (n, 0.0, n),
                         (64, 0.5, 0)):
        keep = torch.from_numpy(rng.random(m) < frac).to(dev)
        g = merge.partition_compact(xs[:, :m], keep, cap,
                                    *[e[:m] for e in ex], extra_fill=9)
        w = merge.partition_compact_plain(xs[:, :m], keep, cap,
                                          *[e[:m] for e in ex], extra_fill=9)
        assert int(g[1]) == int(w[1])
        _same([g[0], *g[2]], [w[0], *w[2]])
    dup = rng.integers(0, 5, (L, n)).astype(np.uint32)   # few keys
    dup[:, rng.random(n) < 0.1] = 0xFFFFFFFF
    a, (ea,) = merge.sort_packed_plain(
        packed.lanes_from_numpy(dup[:, :12_000], dev), ex[0][:12_000])
    b, (eb,) = merge.sort_packed_plain(
        packed.lanes_from_numpy(dup[:, 12_000:], dev), ex[0][12_000:])
    empty = packed.full_pad(0, L, dev)
    none = torch.empty(0, dtype=torch.int32, device=dev)
    pad = packed.full_pad(7000, L, dev)
    for (x, ex_x), (y, ex_y) in (((a, ea), (b, eb)), ((empty, none), (b, eb)),
                                 ((a, ea), (empty, none)),
                                 ((pad, ex[0][:7000]), (pad, ex[0][:7000])),
                                 ((empty, none), (empty, none))):
        got, (gp,) = merge.merge_sorted(x, y, (ex_x,), (ex_y,))
        want, (wp,) = merge.merge_sorted_plain(x, y, (ex_x,), (ex_y,))
        _same([got, gp], [want, wp])


@pytest.mark.parametrize("name,mode,k", [("DNA", "canonical", 65),
                                         ("DNA5", "basic", 80),
                                         ("Protein", "basic", 48)])
def test_wide_builds_cuda_equal_cpu(dev, name, mode, k):
    """Builds of 9, 10 and 12 lanes at 2^16 codes: the card equals the
    CPU, array for array."""
    from metagraph_tpu_torch.graph.boss_construct import build_boss_from_codes
    from metagraph_tpu_torch.kmer.alphabets import ALPHABETS
    codes = (_alphabet_codes(np.random.default_rng(k), name, 1 << 16)
             if name != "DNA" else
             np.random.default_rng(k).integers(1, 5, 1 << 16).astype(
                 np.uint8))
    got, want = (build_boss_from_codes(codes, k, ALPHABETS[name], mode=mode,
                                       bits_per_count=8, device=d)
                 for d in (dev, "cpu"))
    _same_boss(got, want)


def test_server_cuda_equals_cpu(dev):
    """The query server over a graph on the card answers every endpoint
    as the same server over the graph on the CPU, byte for byte."""
    import json
    import urllib.request
    from metagraph_tpu_torch.align.aligner import Aligner
    from metagraph_tpu_torch.engine.annotated_dbg import (AnnotatedDbg,
                                                           annotate_sequences)
    from metagraph_tpu_torch.graph.boss_construct import build_boss
    from metagraph_tpu_torch.graph.dbg_succinct import DbgSuccinct
    from metagraph_tpu_torch.server.http_server import serve
    rng = np.random.default_rng(5)
    recs = [bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 300))
            for _ in range(8)]
    reads = "\n".join(f">r{i}\n{r[20:120].decode()}"
                      for i, r in enumerate(recs))
    bodies = []
    for d in (dev, "cpu"):
        g = DbgSuccinct.from_boss(build_boss(recs, 15, device=d))
        ann = annotate_sequences(g, [(r, [f"l{i % 3}"]) for i, r in
                                     enumerate(recs)]).finalize()
        httpd = serve(AnnotatedDbg(graph=g, annotation=ann), Aligner(g),
                      port=0, background=True)
        port = httpd.server_address[1]
        out = []
        for endpoint, payload in (
                ("search", dict(FASTA=reads)),
                ("search", dict(FASTA=reads, with_signature=True)),
                ("search", dict(FASTA=reads, align=True)),
                ("align", dict(FASTA=reads)), ("stats", None),
                ("column_labels", None)):
            url = f"http://127.0.0.1:{port}/{endpoint}"
            req = url if payload is None else urllib.request.Request(
                url, data=json.dumps(payload).encode())
            with urllib.request.urlopen(req) as r:
                out.append(r.read())
        httpd.shutdown()
        bodies.append(out)
    assert bodies[0] == bodies[1]
