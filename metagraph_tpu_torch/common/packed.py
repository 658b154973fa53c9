"""Multi-lane packed big-integer tensors, the k-mer currency of the port.

PyTorch counterpart of ``metagraph_tpu/common/packed.py``. A batch of N
big integers is a lane-major ``(L, N)`` tensor: lane 0 holds the most
significant 32 bits, lane L-1 the least significant, and lexicographic
order over the lanes is integer order.

Lane dtype: ``torch.int32`` holding the SAME BITS as the JAX package's
``uint32`` lanes. PyTorch has no usable ``uint32`` (``>>`` and ``>`` on
it raise on the CPU), so the bits ride in ``int32`` and
``np.asarray(t).view(np.uint32)`` converts back. The price is that the
signed operators are wrong for the unsigned values in four places, and
every such operation lives in a helper of THIS module and nowhere else:

  * right shift: ``>>`` on int32 is arithmetic (``-1 >> 16 == -1``),
    so :func:`srl` masks the sign-extended bits off;
  * order: signed ``<`` puts PAD (0xFFFFFFFF == -1) first, so
    :func:`ult` flips the sign bit before comparing, and :func:`sort`
    builds sign-flipped int64 keys;
  * PAD tests: "top lane >= 0x80000000" is :func:`top_bit_set`;
  * popcount: PyTorch has none, :func:`popcount32` is a SWAR count.

Left shifts, ``&``, ``|``, ``^`` and wrapping adds give the same bits
on int32 as on uint32. int64 lanes would avoid the helpers but double
the bytes every pass moves, and the CUDA kernels take ``uint32_t*`` and
move exactly the bytes the TPU kernels moved.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

LANE_BITS = 32
LANE_DTYPE = torch.int32
# all-ones big integer: sorts after every valid k-mer (valid k-mers have
# zero top bits); the same bits as the JAX package's uint32 PAD
PAD_LANE = -1
_SIGN = -(1 << 31)


def to_i32(v: int) -> int:
    """A uint32 bit pattern as the int32 value with the same bits."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def lanes_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy lanes -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(np.asarray(a, np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def lanes_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 lanes tensor -> uint32 numpy with the same bits."""
    return t.detach().cpu().numpy().view(np.uint32)


def num_lanes(num_chars: int, bits_per_char: int) -> int:
    """Lanes needed for ``num_chars`` fields of ``bits_per_char`` bits."""
    assert LANE_BITS % bits_per_char == 0, "bits_per_char must divide 32"
    return max(1, -(-num_chars * bits_per_char // LANE_BITS))


def zeros(n: int, lanes: int, device) -> torch.Tensor:
    return torch.zeros((lanes, n), dtype=LANE_DTYPE, device=device)


def full_pad(n: int, lanes: int, device) -> torch.Tensor:
    return torch.full((lanes, n), PAD_LANE, dtype=LANE_DTYPE, device=device)


# ---------------------------------------------------------------------------
# unsigned helpers on int32 lanes
# ---------------------------------------------------------------------------

def srl(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical (unsigned) right shift of int32 lanes by a static count."""
    if n == 0:
        return x
    if n >= LANE_BITS:
        return torch.zeros_like(x)
    return (x >> n) & ((1 << (LANE_BITS - n)) - 1)


def ult(a: torch.Tensor, b) -> torch.Tensor:
    """Elementwise unsigned a < b of int32 lanes."""
    if isinstance(b, int):
        return (a ^ _SIGN) < (to_i32(b) ^ _SIGN)
    return (a ^ _SIGN) < (b ^ _SIGN)


def top_bit_set(x: torch.Tensor) -> torch.Tensor:
    """Unsigned x >= 0x80000000: the PAD test on a top lane."""
    return x < 0


def as_uint(x: torch.Tensor) -> torch.Tensor:
    """int32 lanes -> int64 holding the unsigned value."""
    return x.to(torch.int64) & 0xFFFFFFFF


def from_uint(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> int32 lanes holding their low 32 bits."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(LANE_DTYPE)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits per 32-bit word (SWAR), as int32. Takes int32 words (the
    uint32 bits) or int64 values below 2^32."""
    v = as_uint(x) if x.dtype == torch.int32 else x
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


# ---------------------------------------------------------------------------
# big-integer shifts
# ---------------------------------------------------------------------------

def shift_right(x: torch.Tensor, nbits: int) -> torch.Tensor:
    """Logical right shift of each big integer by a static bit count."""
    if nbits == 0:
        return x
    L = x.shape[0]
    whole, bits = divmod(nbits, LANE_BITS)
    parts = []
    for j in range(L):
        src = j - whole
        if src < 0:
            parts.append(torch.zeros_like(x[0]))
            continue
        v = srl(x[src], bits)
        if bits and src - 1 >= 0:
            v = v | (x[src - 1] << (LANE_BITS - bits))
        parts.append(v)
    return torch.stack(parts)


def shift_left(x: torch.Tensor, nbits: int) -> torch.Tensor:
    """Left shift of each big integer by a static bit count (drops overflow)."""
    if nbits == 0:
        return x
    L = x.shape[0]
    whole, bits = divmod(nbits, LANE_BITS)
    parts = []
    for j in range(L):
        src = j + whole
        if src >= L:
            parts.append(torch.zeros_like(x[0]))
            continue
        v = x[src] << bits if bits else x[src]
        if bits and src + 1 < L:
            v = v | srl(x[src + 1], LANE_BITS - bits)
        parts.append(v)
    return torch.stack(parts)


def mask_low_bits(lanes: int, nbits: int) -> list:
    """Per-lane int32 masks keeping the low ``nbits`` of the big integer."""
    out = []
    for j in range(lanes):
        lo_bit = (lanes - 1 - j) * LANE_BITS
        hi_bit = lo_bit + LANE_BITS
        if nbits >= hi_bit:
            out.append(PAD_LANE)
        elif nbits > lo_bit:
            out.append(to_i32((1 << (nbits - lo_bit)) - 1))
        else:
            out.append(0)
    return out


# ---------------------------------------------------------------------------
# character fields
# ---------------------------------------------------------------------------

def _field_pos(L: int, slot: int, bits_per_char: int):
    bit = slot * bits_per_char
    return L - 1 - bit // LANE_BITS, bit % LANE_BITS


def get_field(x: torch.Tensor, slot: int, bits_per_char: int) -> torch.Tensor:
    """Character field ``slot`` (0 = least significant) as (N,) int32."""
    lane, off = _field_pos(x.shape[0], slot, bits_per_char)
    return srl(x[lane], off) & ((1 << bits_per_char) - 1)


def set_field(x: torch.Tensor, slot: int, vals: torch.Tensor,
              bits_per_char: int) -> torch.Tensor:
    """A copy with field ``slot`` overwritten by ``vals`` (N,)."""
    lane, off = _field_pos(x.shape[0], slot, bits_per_char)
    mask = to_i32(((1 << bits_per_char) - 1) << off)
    out = x.clone()
    out[lane] = (x[lane] & ~mask) | ((vals.to(LANE_DTYPE) << off) & mask)
    return out


def from_fields(fields: torch.Tensor, bits_per_char: int,
                lanes: Optional[int] = None) -> torch.Tensor:
    """Pack ``(num_slots, N)`` fields (slot 0 least significant) into lanes."""
    num_slots, n = fields.shape
    L = lanes if lanes is not None else num_lanes(num_slots, bits_per_char)
    per_lane = LANE_BITS // bits_per_char
    rows = []
    for lane_from_lsb in range(L):
        acc = torch.zeros((n,), dtype=LANE_DTYPE, device=fields.device)
        for i in range(per_lane):
            slot = lane_from_lsb * per_lane + i
            if slot >= num_slots:
                break
            acc = acc | (fields[slot].to(LANE_DTYPE) << (i * bits_per_char))
        rows.append(acc)
    return torch.stack(rows[::-1])


def to_fields(x: torch.Tensor, num_slots: int,
              bits_per_char: int) -> torch.Tensor:
    """Unpack lanes into ``(num_slots, N)`` int32 fields."""
    return torch.stack([get_field(x, s, bits_per_char)
                        for s in range(num_slots)])


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------

def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.all(a == b, dim=0)


def lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic unsigned a < b over lanes, vectorized over N."""
    L = a.shape[0]
    res = ult(a[L - 1], b[L - 1])
    for j in range(L - 2, -1, -1):
        res = torch.where(a[j] == b[j], res, ult(a[j], b[j]))
    return res


def le(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ~lt(b, a)


def neighbor_ne(x: torch.Tensor) -> torch.Tensor:
    """mask[i] = (i == 0) or x[:, i] != x[:, i-1]."""
    n = x.shape[1]
    if n == 0:
        return torch.zeros((0,), dtype=torch.bool, device=x.device)
    diff = torch.any(x[:, 1:] != x[:, :-1], dim=0)
    return torch.cat([torch.ones((1,), dtype=torch.bool, device=x.device),
                      diff])


# ---------------------------------------------------------------------------
# sort / searchsorted
# ---------------------------------------------------------------------------

def _sort_keys(x: torch.Tensor) -> list:
    """int64 keys, least significant first, whose signed lexicographic
    order is the unsigned lane order: lanes fuse in pairs (high lane
    sign-flipped into the top half), a leftover top lane alone."""
    L = x.shape[0]
    keys = []
    j = L - 1
    while j >= 1:
        hi = (x[j - 1] ^ _SIGN).to(torch.int64) << 32
        keys.append(hi | as_uint(x[j]))
        j -= 2
    if j == 0:
        keys.append(as_uint(x[0]))
    return keys


def sort_order(x: torch.Tensor) -> torch.Tensor:
    """The stable ascending order (int64 permutation) of the big
    integers: stable ``torch.sort`` passes over fused int64 keys, last
    key first."""
    perm = None
    for key in _sort_keys(x):
        k = key if perm is None else key[perm]
        idx = torch.sort(k, stable=True).indices
        perm = idx if perm is None else perm[idx]
    if perm is None:                      # no lanes
        perm = torch.arange(x.shape[1], device=x.device)
    return perm


def sort(x: torch.Tensor, *extras: torch.Tensor
         ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Stable ascending sort of the big integers; co-sort ``extras``
    (the counterpart of ``lax.sort(..., is_stable=True)``)."""
    perm = sort_order(x)
    return x[:, perm], tuple(e[perm] for e in extras)


def searchsorted(keys: torch.Tensor, queries: torch.Tensor,
                 side: str = "left", lo0=None, hi0=None,
                 steps: Optional[int] = None) -> torch.Tensor:
    """Batched binary search of ``queries`` (L, Q) in sorted ``keys``
    (L, N). Returns (Q,) int64 insertion positions. ``lo0``/``hi0``
    narrow each query's range; ``steps`` is the number of rounds (None:
    enough for the whole array)."""
    n = keys.shape[1]
    q = queries.shape[1]
    dev = queries.device
    if n == 0:
        return torch.zeros((q,), dtype=torch.int64, device=dev)
    if steps is None:
        steps = max(1, int(np.ceil(np.log2(n + 1))))
    lo = (torch.zeros((q,), dtype=torch.int64, device=dev) if lo0 is None
          else lo0.to(torch.int64))
    hi = (torch.full((q,), n, dtype=torch.int64, device=dev) if hi0 is None
          else hi0.to(torch.int64))

    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) >> 1
        km = keys[:, torch.clamp(mid, max=n - 1)]
        go_right = lt(km, queries) if side == "left" else le(km, queries)
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def expand2to4(lanes2: torch.Tensor, K: int) -> torch.Tensor:
    """(L2, n) 2-bit-packed k-mers (chars stored as c-1) -> (L4, n)
    4-bit-packed (chars c), same field order. The map c-1 -> c is
    monotone, so the two forms sort alike."""
    L2 = lanes2.shape[0]
    L4 = (K * 4 + 31) // 32
    outs = []
    for i4 in range(L4):                  # least-significant lane first
        src = lanes2[L2 - 1 - i4 // 2]
        half = srl(src, 16 * (i4 % 2)) & 0xFFFF
        u = (half | (half << 8)) & 0x00FF00FF
        u = (u | (u << 4)) & 0x0F0F0F0F
        u = (u | (u << 2)) & 0x33333333
        m = min(8, K - 8 * i4)            # valid fields in this lane
        u = u + (0x11111111 & ((1 << (4 * m)) - 1))
        outs.append(u)
    return torch.stack(outs[::-1])


# ---------------------------------------------------------------------------
# scans. A 1D torch.cumsum on the card goes to CUB's device-wide scan, but
# torch.cummax has no such path: over a 1D tensor it runs in a single
# block. The running maximum therefore takes the reference's two-level
# form, per-row scans over (G, SCAN_BLOCK) rows and a scan of the G row
# maxima, which gives the card G rows to scan at once.
# ---------------------------------------------------------------------------

SCAN_BLOCK = 8192


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive 1D cumsum in the input's dtype."""
    return torch.cumsum(x, 0, dtype=x.dtype)


def blocked_cummax(x: torch.Tensor) -> torch.Tensor:
    """Inclusive 1D running maximum of an integer tensor."""
    n = x.shape[0]
    if n <= SCAN_BLOCK:
        return torch.cummax(x, 0).values if n else x
    G = -(-n // SCAN_BLOCK)
    lowest = torch.iinfo(x.dtype).min
    if G * SCAN_BLOCK == n:
        rows = x.view(G, SCAN_BLOCK)
    else:
        rows = torch.full((G * SCAN_BLOCK,), lowest, dtype=x.dtype,
                          device=x.device)
        rows[:n] = x
        rows = rows.view(G, SCAN_BLOCK)
    within = torch.cummax(rows, 1).values
    run = blocked_cummax(within[:, -1].contiguous())
    offs = torch.cat([run.new_full((1,), lowest), run[:-1]])
    torch.maximum(within, offs[:, None], out=within)
    return within.view(-1)[:n]


# ---------------------------------------------------------------------------
# compaction
# ---------------------------------------------------------------------------

def compact(x: torch.Tensor, keep: torch.Tensor, capacity: int,
            *extras: torch.Tensor, extra_fill: int = 0):
    """Move entries where ``keep`` to the front (order preserved), PAD-fill
    the rest, and clip to ``capacity``. Returns (lanes (L, capacity),
    TRUE count as a 0-d int32 tensor, extras). A stable sort on
    ``~keep``: the plain version of the partition kernel."""
    L, n = x.shape
    count = torch.sum(keep, dtype=torch.int32)
    perm = torch.sort((~keep).to(torch.uint8), stable=True).indices
    m = min(capacity, n)
    pos_ok = valid_mask(m, count, x.device)
    out_lanes = torch.where(pos_ok[None, :], x[:, perm[:m]], PAD_LANE)
    if capacity > n:
        out_lanes = pad_to(out_lanes, capacity)
    outs = []
    for e in extras:
        fill = torch.tensor(extra_fill, dtype=e.dtype, device=e.device)
        eo = torch.where(pos_ok, e[perm[:m]], fill)
        if capacity > n:
            eo = torch.cat([eo, fill.expand(capacity - n)])
        outs.append(eo)
    return out_lanes, count, tuple(outs)


def pad_to(x: torch.Tensor, capacity: int) -> torch.Tensor:
    """Pad (L, n) lanes with PAD up to (L, capacity)."""
    L, n = x.shape
    if n == capacity:
        return x
    assert n < capacity
    return torch.cat([x, full_pad(capacity - n, L, x.device)], dim=1)


def valid_mask(n_total: int, count, device=None) -> torch.Tensor:
    """(n_total,) bool mask of the first ``count`` positions."""
    if device is None:
        device = count.device
    return torch.arange(n_total, device=device) < count
