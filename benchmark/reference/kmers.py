"""k-mers as 2-bit integers: A = 0, C = 1, G = 2, T = 3, the first
character most significant (k <= 32). Codes are 1..4 for ACGT; any
other code ends a record."""

from __future__ import annotations

import torch


def kmer_ints(codes: torch.Tensor, K: int, reverse_complement=False):
    """(values, valid) of every K-window of a code array (1..4 = ACGT,
    anything else ends a record): int64 2-bit integers of the window, or
    of its reverse complement."""
    n = codes.shape[0] - K + 1
    if n <= 0:
        e = torch.zeros(0, dtype=torch.int64, device=codes.device)
        return e, e.bool()
    c = codes.to(torch.int64)
    bad = ((c < 1) | (c > 4)).to(torch.int32)
    pre = torch.cat([bad.new_zeros(1),
                     torch.cumsum(bad, 0, dtype=torch.int32)])
    valid = (pre[K:] - pre[:-K]) == 0
    v = torch.clamp(c - 1, 0, 3)
    return window_ints(v[None], K, reverse_complement)[0], valid


def reverse_digits(x: torch.Tensor, ndig: int) -> torch.Tensor:
    """Reverse the low ``ndig`` 2-bit digits of non-negative int64s."""
    y = x
    for shift, mask in ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
                        (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF)):
        y = ((y >> shift) & mask) | ((y & mask) << shift)
    y = ((y >> 32) & 0xFFFFFFFF) | (y << 32)
    sh = 2 * (32 - ndig)
    return (y >> sh) & ((1 << (64 - sh)) - 1) if sh else y


def window_ints(v: torch.Tensor, K: int, reverse_complement=False):
    """The k-mers of every K-window of each row of ``v`` ((R, n) int64
    digits 0..3): (R, n - K + 1) int64, or their reverse complements."""
    n = v.shape[1] - K + 1
    out = torch.zeros((v.shape[0], n), dtype=torch.int64, device=v.device)
    for j in range(K):
        d = v[:, j:j + n]
        if reverse_complement:
            out |= (3 - d) << (2 * j)
        else:
            out |= d << (2 * (K - 1 - j))
    return out
