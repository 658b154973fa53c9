"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. Run them on
a machine with a card (no JAX needed there) with:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Results must be bit-exact: the data are integers.
"""

import numpy as np
import pytest
import torch

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
    x = packed.full_pad(10, 9, dev)
    with pytest.raises(ValueError):
        merge.partition_compact(x, torch.ones(10, dtype=torch.bool,
                                              device=dev), 10)
    with pytest.raises(ValueError):
        merge.merge_sorted(x, x)
