"""BOSS-ordered packed k-mer batches.

PyTorch counterpart of ``metagraph_tpu/kmer/packing.py``. For an edge
k-mer ``e_1 .. e_K`` (source node ``e_1..e_{K-1}``, label ``e_K``) the
character fields are laid out

    field 0      = e_K   (edge label, least significant)
    field j      = e_j   for j in 1..K-1  (e_{K-1} most significant)

so integer order over the lanes is BOSS order: colex by source node,
then by label. ``node_key(x) = x >> B`` is the source node;
``target_key(x)`` is ``(e_2..e_{K-1}, e_K)``, the target node plus label.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..common import packed


def label(x: torch.Tensor, B: int) -> torch.Tensor:
    """Edge label e_K (the BOSS W character before minus-flagging)."""
    return packed.get_field(x, 0, B)


def first_char(x: torch.Tensor, B: int) -> torch.Tensor:
    """e_1: zero iff the edge is a dummy source edge."""
    return packed.get_field(x, 1, B)


def top_char(x: torch.Tensor, K: int, B: int) -> torch.Tensor:
    """e_{K-1}: last char of the source node; drives the BOSS F offsets."""
    return packed.get_field(x, K - 1, B)


def node_key(x: torch.Tensor, B: int) -> torch.Tensor:
    """Source-node key; an order-preserving projection of BOSS order."""
    return packed.shift_right(x, B)


def target_key(x: torch.Tensor, B: int) -> torch.Tensor:
    """(e_2..e_{K-1}, e_K): the edge's target node plus its label."""
    out = packed.shift_left(packed.shift_right(x, 2 * B), B)
    out[-1] = out[-1] | label(x, B)
    return out


def _full(n: int, v: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full((n,), v, dtype=packed.LANE_DTYPE, device=like.device)


def to_next(x: torch.Tensor, K: int, B: int, new_label) -> torch.Tensor:
    """Successor edge k-mer (e_2..e_K, new_label) (KMerBOSS::to_next)."""
    lab = label(x, B)
    out = packed.shift_left(packed.shift_right(x, 2 * B), B)
    out = packed.set_field(out, K - 1, lab, B)
    if isinstance(new_label, int):
        if new_label:
            out = packed.set_field(out, 0, _full(x.shape[1], new_label, x), B)
    else:
        out = packed.set_field(out, 0, new_label, B)
    return out


def to_prev(x: torch.Tensor, K: int, B: int, new_first) -> torch.Tensor:
    """Predecessor edge k-mer (new_first, e_1..e_{K-2}) with label
    e_{K-1} (KMerBOSS::to_prev)."""
    L, n = x.shape
    top = top_char(x, K, B)
    masks = packed.mask_low_bits(L, (K - 1) * B)     # keep fields 0..K-2
    mid = torch.stack([x[j] & masks[j] for j in range(L)])
    # clear field 0 first so the old label does not leak into field 1
    mid = packed.set_field(mid, 0, torch.zeros_like(top), B)
    out = packed.set_field(packed.shift_left(mid, B), 0, top, B)
    if isinstance(new_first, int):
        if new_first:
            out = packed.set_field(out, 1, _full(n, new_first, x), B)
    else:
        out = packed.set_field(out, 1, new_first, B)
    return out


def pack_from_chars(chars: torch.Tensor, K: int, B: int) -> torch.Tensor:
    """Pack (N, K) char codes e_1..e_K into BOSS field layout -> (L, N)."""
    fields = torch.cat([chars[:, K - 1:K].T, chars[:, :K - 1].T])
    return packed.from_fields(fields.to(packed.LANE_DTYPE), B)


def unpack_to_chars(x: torch.Tensor, K: int, B: int) -> torch.Tensor:
    """Inverse of ``pack_from_chars`` -> (N, K) uint8 codes e_1..e_K."""
    fields = packed.to_fields(x, K, B)
    return torch.cat([fields[1:K], fields[0:1]]).T.to(torch.uint8)


def reverse_complement(x: torch.Tensor, K: int, B: int,
                       complement: Tuple[int, ...]) -> torch.Tensor:
    """Per-edge reverse complement: rc(e)_j = comp(e_{K+1-j})."""
    comp = torch.tensor(complement, dtype=packed.LANE_DTYPE, device=x.device)
    # fields above the table (PAD, invalid windows) clamp to its last
    # entry, as a JAX gather does; callers mask those columns anyway
    fields = torch.clamp(packed.to_fields(x, K, B), max=len(complement) - 1)
    e = [fields[j] for j in range(1, K)] + [fields[0]]   # e_1..e_K
    rc = [comp[e[K - 1 - j].long()] for j in range(K)]   # rc_1..rc_K
    return packed.from_fields(torch.stack([rc[K - 1]] + rc[:K - 1]), B,
                              lanes=x.shape[0])


def contains_sentinel(x: torch.Tensor, K: int, B: int) -> torch.Tensor:
    """(N,) bool: any character field equals 0, i.e. a dummy edge."""
    res = torch.zeros((x.shape[1],), dtype=torch.bool, device=x.device)
    for s in range(K):
        res = res | (packed.get_field(x, s, B) == 0)
    return res


def pack_windows(codes: torch.Tensor, K: int, B: int) -> torch.Tensor:
    """Pack every K-window of a code array into BOSS-layout lanes
    (field 0 = e_K, field j = e_j), accumulating per slot from contiguous
    slices without materializing the (K, N) field stack."""
    num_windows = codes.shape[0] - K + 1
    per_lane = packed.LANE_BITS // B
    L = packed.num_lanes(K, B)
    rows = []
    for lane_from_lsb in range(L):
        acc = torch.zeros((num_windows,), dtype=packed.LANE_DTYPE,
                          device=codes.device)
        for i in range(per_lane):
            slot = lane_from_lsb * per_lane + i
            if slot >= K:
                break
            off = K - 1 if slot == 0 else slot - 1
            acc |= codes[off:off + num_windows].to(packed.LANE_DTYPE) << (i * B)
        rows.append(acc)
    return torch.stack(rows[::-1])
