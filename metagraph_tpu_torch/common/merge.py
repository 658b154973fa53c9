"""The three kernels of the construction path over packed lanes, each
beside its plain PyTorch version.

PyTorch counterpart of ``metagraph_tpu/common/merge.py``:

  * ``partition_compact`` — stable compaction of kept entries to the
    front (replaces the Pallas ``_partition_call``); hand-written CUDA in
    ``csrc/partition.cu``, one launch per call for any number of lanes
    (tiles in order, a one-bin decoupled look-back for the kept prefix,
    every lane and payload through two shared stages, the PAD tail
    written by the dropped entries); plain version ``packed.compact``.
  * ``merge_sorted`` — merge of two sorted lane arrays with payloads
    (replaces the Pallas ``_merge_call``); hand-written CUDA in
    ``csrc/merge.cu``: merge-path splits, then one block a tile of whole
    keys in dynamic shared memory, for any number of lanes up to what
    one tile holds (``merge_lane_limit``; the tile shrinks past 55 lanes
    on an H100); plain version a stable sort of the concatenation. Both
    versions are stable with A first on ties, where the TPU's bitonic
    kernel was not.
  * ``sort_packed`` — full sort of lanes with payloads (replaces the JAX
    ``sort_packed``: leaf sorts, then segmented ``_merge_call`` levels);
    hand-written CUDA in ``csrc/sort.cu``: an LSD radix sort over 8-bit
    digits, for any number of lanes. One launch counts every digit's
    histogram; the host copies them back (one small synchronising copy
    per sort) and ``radix_passes`` keeps the digits on which the keys
    differ; then one launch per such digit ranks each tile stably, finds
    its offsets by decoupled look-back (``csrc/lookback.cuh``, shared
    with the partition) and scatters. PAD is its own bin, after 0xFF.
    ``sort_route`` picks one of two routes by the number of lanes and
    payloads: the lanes route moves every lane and payload in every
    pass; the index route sorts (lane value, 32-bit index) pairs one
    lane at a time, least significant first, reads each lane through
    the index in its first pass (a lane with no digit to run is never
    read), then gathers the lanes and payloads once. ``lex_order`` is
    the index route without that gather. Plain version ``packed.sort``.
    Both are stable, where the TPU's was not, so the two agree bit for
    bit, payloads included.

Each wrapper dispatches on the device of the tensor it is given and on
nothing else: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel (or raises). ``partition_launches`` and
``merge_launches`` count kernel launches, one per wrapper call that
launched, so a run can show that its main path went through them;
``sort_launches`` counts ``sort_packed`` and ``lex_order`` calls that
launched, one each at any number of lanes, and ``sort_digit_passes``
the radix passes they ran in either route.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from . import _cuda, packed

partition_launches = 0
merge_launches = 0
sort_launches = 0
sort_digit_passes = 0

_MAX_EXTRAS = 2


def _check_cuda_args(what: str, lanes: Sequence[torch.Tensor],
                     extras: Sequence[torch.Tensor], n_extra: int):
    if n_extra > _MAX_EXTRAS:
        raise ValueError(f"{what}: {n_extra} payloads; the kernel takes "
                         f"at most {_MAX_EXTRAS}")
    dev = lanes[0].device
    for x in lanes:
        if x.dtype != packed.LANE_DTYPE or x.dim() != 2:
            raise TypeError(f"{what}: lanes must be (L, N) int32")
        if x.shape[0] < 1:
            raise ValueError(f"{what}: no lanes")
        if x.device != dev:
            raise ValueError(f"{what}: operands on different devices")
    for e in extras:
        if e.element_size() != 4 or e.dim() != 1 or e.device != dev:
            raise TypeError(f"{what}: payloads must be 1-D four-byte "
                            f"tensors on {dev}")


def _ptr(t) -> int:
    return t.data_ptr() if t is not None else None


def _pad_ptrs(ts, k=_MAX_EXTRAS):
    ts = list(ts) + [None] * (k - len(ts))
    return [_ptr(t) for t in ts]


# ---------------------------------------------------------------------------
# partition_compact
# ---------------------------------------------------------------------------

def partition_compact_plain(x: torch.Tensor, keep: torch.Tensor,
                            capacity: int, *extras: torch.Tensor,
                            extra_fill: int = 0):
    """The plain version: ``packed.compact`` (a stable sort on ~keep)."""
    return packed.compact(x, keep, capacity, *extras, extra_fill=extra_fill)


def _partition_cuda(x, keep, capacity, extras, extra_fill):
    global partition_launches
    _check_cuda_args("partition_compact", [x], extras, len(extras))
    L, n = x.shape
    dev = x.device
    if keep.shape != (n,) or keep.dtype != torch.bool or keep.device != dev:
        raise TypeError(f"partition_compact: keep must be (N,) bool on {dev}")
    x = x.contiguous()
    keep = keep.contiguous()
    extras = [e.contiguous() for e in extras]
    lib = _cuda.lib()
    out = torch.empty((L, capacity), dtype=packed.LANE_DTYPE, device=dev)
    eouts = [torch.empty((capacity,), dtype=e.dtype, device=dev)
             for e in extras]
    tile = lib.mg_partition_tile()
    # look-back status words, then the tile counter
    scratch = torch.empty((-(-n // tile) + 1,), dtype=torch.int64,
                          device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):          # the runtime launches on it
        status = lib.mg_partition(
            x.data_ptr(), L, n, keep.data_ptr(), *_pad_ptrs(extras),
            len(extras), out.data_ptr(), *_pad_ptrs(eouts), capacity,
            extra_fill & 0xFFFFFFFF, scratch.data_ptr(), count.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(status, "partition_compact")
    partition_launches += 1
    return out, count, tuple(eouts)


def partition_compact(x: torch.Tensor, keep: torch.Tensor, capacity: int,
                      *extras: torch.Tensor, extra_fill: int = 0):
    """Stable compaction: returns (lanes (L, capacity), TRUE count as a
    0-d int32 tensor, extras). Kept entries first in their original
    order; PAD / ``extra_fill`` past the count; entries past
    ``capacity`` dropped (the count still counts them). Any number of
    lanes; one launch on the card."""
    if x.device.type == "cpu":
        return partition_compact_plain(x, keep, capacity, *extras,
                                       extra_fill=extra_fill)
    if x.device.type != "cuda":
        raise ValueError(f"partition_compact: no kernel for {x.device}")
    return _partition_cuda(x, keep, capacity, extras, extra_fill)


# ---------------------------------------------------------------------------
# merge_sorted
# ---------------------------------------------------------------------------

def merge_sorted_plain(a: torch.Tensor, b: torch.Tensor,
                       a_extras: Sequence[torch.Tensor] = (),
                       b_extras: Sequence[torch.Tensor] = ()):
    """The plain version: a stable sort of concat(A, B) (the JAX
    package's ``_merge_fallback``)."""
    lanes = torch.cat([a, b], dim=1)
    extras = tuple(torch.cat([ea, eb]) for ea, eb in zip(a_extras, b_extras))
    return packed.sort(lanes, *extras)


def merge_lane_limit(device) -> int:
    """The widest keys (in lanes) the merge kernel takes on ``device``,
    a CUDA device: what the smallest tile's shared memory holds."""
    with torch.cuda.device(device):
        return _cuda.lib().mg_merge_max_lanes()


def _merge_cuda(a, b, a_extras, b_extras):
    """Merge-path splits, then one block a tile of whole keys in shared
    memory (the tile sized by the lane count)."""
    global merge_launches
    _check_cuda_args("merge_sorted", [a, b],
                     list(a_extras) + list(b_extras), len(a_extras))
    L, na = a.shape
    nb = b.shape[1]
    if b.shape[0] != L:
        raise ValueError("merge_sorted: lane counts differ")
    for ea, eb in zip(a_extras, b_extras):
        if ea.dtype != eb.dtype or ea.shape != (na,) or eb.shape != (nb,):
            raise TypeError("merge_sorted: payload i of A and B must share "
                            "a dtype and match their key counts")
    dev = a.device
    lib = _cuda.lib()
    with torch.cuda.device(dev):
        tile = lib.mg_merge_tile(L)
    if tile <= 0:
        raise ValueError(f"merge_sorted: {L} lanes; the merge kernel takes "
                         f"at most {merge_lane_limit(dev)} on {dev}")
    a, b = a.contiguous(), b.contiguous()
    a_extras = [e.contiguous() for e in a_extras]
    b_extras = [e.contiguous() for e in b_extras]
    ntot = na + nb
    out = torch.empty((L, ntot), dtype=packed.LANE_DTYPE, device=dev)
    eouts = [torch.empty((ntot,), dtype=e.dtype, device=dev)
             for e in a_extras]
    splits = torch.empty((-(-ntot // tile) + 1,), dtype=torch.int64,
                         device=dev)
    with torch.cuda.device(dev):
        status = lib.mg_merge(
            a.data_ptr(), na, b.data_ptr(), nb, L, *_pad_ptrs(a_extras),
            *_pad_ptrs(b_extras), len(a_extras), out.data_ptr(),
            *_pad_ptrs(eouts), splits.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(status, "merge_sorted")
    merge_launches += 1
    return out, tuple(eouts)


def merge_sorted(a: torch.Tensor, b: torch.Tensor,
                 a_extras: Sequence[torch.Tensor] = (),
                 b_extras: Sequence[torch.Tensor] = ()
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Merge two sorted (PAD-tailed) lane arrays with payloads. Returns
    (lanes (L, Na+Nb), extras), sorted ascending, PADs at the tail,
    equal keys in stable order with A's first."""
    a_extras, b_extras = tuple(a_extras), tuple(b_extras)
    if len(a_extras) != len(b_extras):
        raise ValueError("merge_sorted: A and B need the same payloads")
    if a.device.type == "cpu":
        return merge_sorted_plain(a, b, a_extras, b_extras)
    if a.device.type != "cuda":
        raise ValueError(f"merge_sorted: no kernel for {a.device}")
    return _merge_cuda(a, b, a_extras, b_extras)


# ---------------------------------------------------------------------------
# sort_packed
# ---------------------------------------------------------------------------

def sort_packed_plain(x: torch.Tensor, *extras: torch.Tensor):
    """The plain version: ``packed.sort`` (stable ``torch.sort`` passes
    over fused int64 keys)."""
    return packed.sort(x, *extras)


def radix_passes(hist, n_pad: int) -> list:
    """The digits a radix sort must run, least significant first.

    ``hist`` is (4 L, 256): row d counts the non-PAD keys by digit d
    (digit 0 = the low byte of the last lane); ``n_pad`` counts the PAD
    keys. A digit on which every non-PAD key falls in one bin leaves the
    order as it is and is dropped. PAD is a bin of its own after 0xFF in
    every pass, so when no digit is left but PADs and other keys are
    both present, one pass (digit 0) still moves the PADs last; with no
    digit left otherwise, the sorted array is a copy."""
    hist = np.asarray(hist)
    run = np.flatnonzero(np.count_nonzero(hist, axis=1) > 1).tolist()
    if not run and n_pad and hist[0].sum():
        run = [0]
    return run


def sort_route(L: int, E: int) -> str:
    """The route ``sort_packed`` takes on the card for L lanes and E
    payloads. "lanes" moves every lane and payload in every digit pass,
    8 (L + E) bytes a key a pass; "index" sorts (lane value, 32-bit
    index) pairs a lane at a time, 16 bytes a key a pass, reading each
    lane through the index in its first pass (a random 4-byte read),
    then gathers the lanes and payloads once. The crossover, measured on
    an H100 at 2^25 random keys with both routes in one process
    (PERF.md §6): the lanes route is faster up to 2 lanes and at 3 with
    at most one payload, the index route at 3 with two and from 4 on."""
    return "lanes" if L <= 2 or (L == 3 and E <= 1) else "index"


def index_pass_plan(passes) -> list:
    """The index route's launches for ``passes`` (digits, least
    significant first): (digit, first, last) per pass, where ``first``
    marks a lane's first pass (it reads the lane through the index) and
    ``last`` its last (no pass reads its values after it). A lane with
    no digit in ``passes`` is never read."""
    lanes = [d // 4 for d in passes]
    return [(d, i == 0 or lanes[i - 1] != lanes[i],
             i == len(passes) - 1 or lanes[i + 1] != lanes[i])
            for i, d in enumerate(passes)]


def _lanes_route(lib, x, extras, bufs, hist, passes, n_pad, status,
                 stream):
    """One launch per digit; every pass moves all lanes and payloads,
    ping-ponging between the two ``bufs`` so that the last pass lands in
    the first. Returns (lanes, payloads)."""
    L, n = x.shape
    src, src_e = x, extras
    for i, digit in enumerate(passes):
        dst, dst_e = bufs[(len(passes) - 1 - i) % 2]
        # the first pass tests every lane for PAD; later ones, and one
        # without PADs, know them by position
        _cuda.check(lib.mg_sort_pass(
            src.data_ptr(), n, L, *_pad_ptrs(src_e), len(extras),
            dst.data_ptr(), *_pad_ptrs(dst_e), hist.data_ptr(), digit,
            int(i == 0 and n_pad > 0), status.data_ptr(), stream),
            "sort_packed pass")
        src, src_e = dst, dst_e
    return src, tuple(src_e)


def _index_route(lib, x, bufs, hist, passes, mask, status, stream):
    """One launch per digit over (value, index) pairs, lane by lane,
    ping-ponging between ``bufs`` (two (value, index) pairs of (n,)
    int32): a lane's first pass reads the lane through the index
    (``mg_sort_index_pass``), its later ones are one-lane lanes-route
    passes with the index as the payload, on the lane's rows of the
    histograms. ``mask`` (n,) uint8 marks the PADs for the sort's first
    pass (None: no PAD). Returns the sorted order as (n,) int32 holding
    uint32 indices."""
    L, n = x.shape
    vin = iin = None
    row_bytes = 256 * hist.element_size()
    for i, (digit, first, last) in enumerate(index_pass_plan(passes)):
        vout, iout = bufs[i % 2]
        if first:
            if last:                      # no later pass reads the values
                vout = None
            _cuda.check(lib.mg_sort_index_pass(
                x.data_ptr(), n, L, _ptr(iin), _ptr(vout), iout.data_ptr(),
                hist.data_ptr(), digit, _ptr(mask) if i == 0 else None,
                status.data_ptr(), stream), "sort_packed index pass")
        else:
            _cuda.check(lib.mg_sort_pass(
                vin.data_ptr(), n, 1, iin.data_ptr(), None, 1,
                vout.data_ptr(), iout.data_ptr(), None,
                hist.data_ptr() + 4 * (digit // 4) * row_bytes, digit % 4, 0,
                status.data_ptr(), stream), "sort_packed index pass")
        vin, iin = vout, iout
    return iin


def _sort_cuda(x, extras, route):
    """The card's sort by ``route``: one histogram launch, ONE
    synchronising copy of the histograms, then the digit passes of the
    lanes or the index route; "order" is the index route without the
    final gather, which returns the order (int64) instead of the sorted
    keys."""
    global sort_launches, sort_digit_passes
    _check_cuda_args("sort_packed", [x], extras, len(extras))
    L, n = x.shape
    if any(e.shape != (n,) for e in extras):
        raise TypeError("sort_packed: payloads must match the key count")
    order_only = route == "order"
    if order_only:
        route = "index"
    if route == "index" and n >= 1 << 32:
        raise ValueError(f"sort_packed: {n} keys; the index route's index "
                         f"is 32-bit (at most 2^32 - 1 keys)")
    dev = x.device
    x = x.contiguous()
    extras = [e.contiguous() for e in extras]
    if n == 0:
        if order_only:
            return torch.zeros((0,), dtype=torch.int64, device=dev)
        return (torch.empty_like(x), tuple(torch.empty_like(e)
                                           for e in extras))
    lib = _cuda.lib()
    hist = torch.empty((4 * L * 256 + 1,), dtype=torch.int64, device=dev)
    # the passes' scratch, allocated before the synchronising copy so that
    # the first pass follows it at once: the ping-pong buffers (the
    # lanes route's first pair is its output), the index route's PAD
    # mask, row copy of the keys (one row a key, for the final gather)
    # and outputs, and the look-back status words with the tile counter
    # after them
    mask = rows = None
    if route == "lanes":
        bufs = [(torch.empty_like(x), [torch.empty_like(e) for e in extras])
                for _ in range(2)]
    else:
        bufs = [tuple(torch.empty((n,), dtype=torch.int32, device=dev)
                      for _ in range(2)) for _ in range(2)]
        mask = torch.empty((n,), dtype=torch.uint8, device=dev)
        if not order_only:
            rows = torch.empty((n * lib.mg_sort_row_words(L),),
                               dtype=torch.int32, device=dev)
            out = torch.empty_like(x)
            eouts = [torch.empty_like(e) for e in extras]
    with torch.cuda.device(dev):          # the runtime launches on it
        status = torch.empty((-(-n // lib.mg_sort_tile()) * 257 + 1,),
                             dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _cuda.check(lib.mg_sort_hist(x.data_ptr(), n, L, hist.data_ptr(),
                                     _ptr(mask), _ptr(rows), stream),
                    "sort_packed histogram")
        sort_launches += 1
        h = hist.cpu().numpy()            # the one synchronising copy
        n_pad = int(h[-1])
        passes = radix_passes(h[:-1].reshape(4 * L, 256), n_pad)
        sort_digit_passes += len(passes)
        if not passes:                    # already in order
            if order_only:
                return torch.arange(n, device=dev)
            return x.clone(), tuple(e.clone() for e in extras)
        if route == "lanes":
            return _lanes_route(lib, x, extras, bufs, hist, passes, n_pad,
                                status, stream)
        idx = _index_route(lib, x, bufs, hist, passes,
                           mask if n_pad else None, status, stream)
        if order_only:
            return packed.as_uint(idx)
        _cuda.check(lib.mg_sort_gather(
            rows.data_ptr(), n, L, idx.data_ptr(), *_pad_ptrs(extras),
            len(extras), out.data_ptr(), *_pad_ptrs(eouts), stream),
            "sort_packed gather")
    return out, tuple(eouts)


def lex_order(x: torch.Tensor) -> torch.Tensor:
    """Stable ascending order (int64 permutation) of (L, n) lanes of any
    L, PAD last: on the card one sort by the index route without the
    final gather (or, where ``sort_route`` keeps the lanes route, one
    sort carrying the identity as its payload); on the CPU
    ``packed.sort_order``."""
    if x.device.type == "cpu":
        return packed.sort_order(x)
    if x.device.type != "cuda":
        raise ValueError(f"lex_order: no kernel for {x.device}")
    L, n = x.shape
    if sort_route(L, 1) == "lanes":
        _, (perm,) = _sort_cuda(x, [torch.arange(n, dtype=torch.int32,
                                                 device=x.device)], "lanes")
        return perm.to(torch.int64)
    return _sort_cuda(x, [], "order")


def sort_packed(x: torch.Tensor, *extras: torch.Tensor
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Stable ascending sort of (L, N) lanes of any L (lane 0 most
    significant, unsigned; PAD last) with 0-2 four-byte payloads riding
    along. Returns (lanes, extras); equal keys keep their input order.
    One ``sort_launches`` per call on the card."""
    if x.device.type == "cpu":
        return sort_packed_plain(x, *extras)
    if x.device.type != "cuda":
        raise ValueError(f"sort_packed: no kernel for {x.device}")
    return _sort_cuda(x, extras, sort_route(x.shape[0], len(extras)))
