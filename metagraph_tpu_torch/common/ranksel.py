"""Blocked rank/select over device tensors.

PyTorch counterpart of ``metagraph_tpu/common/ranksel.py``:

  * ``BitRank``: bits packed into 32-bit words (int32 tensors with the
    uint32 bits) plus one int32 exclusive rank per word. rank = gather +
    popcount; select = binary search over the word ranks + a 5-step
    in-word bisection.
  * ``SymbolRank``: the sequence byte-packed 4 per word, plus
    per-128-position per-symbol block counts. rank = block gather + a
    SWAR byte match over the block's 32 words; select = binary search
    over the block counts + in-block cumsum/argmax.

All queries are batched over (Q,) index tensors and return int64.
Word arithmetic runs on int64 copies of the unsigned words
(``packed.as_uint``), where no sign bit is in the way.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import packed

_BS = 128          # SymbolRank block size (positions)
_BS_LOG = 7
_WPB = _BS // 4    # words per block (4 chars per word)
# popcount masks for "first m bytes of a word": the 0x80 bit per byte
_BYTE_MASKS = (0x00000000, 0x00000080, 0x00008080, 0x00808080, 0x80808080)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(n,) bool -> (max(ceil(n/32), 1),) int32 words, little-endian."""
    n = bits.shape[0]
    nw = max((n + 31) // 32, 1)
    padded = torch.zeros((nw * 32,), dtype=torch.int64, device=bits.device)
    padded[:n] = bits.to(torch.int64)
    shifts = torch.arange(32, device=bits.device)
    words = torch.sum(padded.view(nw, 32) << shifts, dim=1)
    return packed.from_uint(words)


def _low_mask(b: torch.Tensor) -> torch.Tensor:
    """int64 mask of bits 0..b inclusive (b in [0, 31])."""
    return (torch.ones_like(b) << (b + 1)) - 1


def _in_word_select(word: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Position (0-based) of the r-th (1-based) set bit of each word
    (int64 words below 2^32)."""
    pos = torch.zeros_like(r)
    w, rr = word, r
    for width in (16, 8, 4, 2, 1):
        low = w & ((1 << width) - 1)
        cnt = packed.popcount32(low).to(rr.dtype)
        go_high = cnt < rr
        rr = torch.where(go_high, rr - cnt, rr)
        pos = torch.where(go_high, pos + width, pos)
        w = torch.where(go_high, w >> width, low)
    return pos


def _prefix_ranks(words: torch.Tensor):
    pops = packed.popcount32(words)
    brank = torch.cumsum(pops, 0, dtype=torch.int32) - pops
    return brank, brank[-1] + pops[-1]


@dataclass(frozen=True)
class BitRank:
    """Blocked rank/select over a boolean vector."""
    words: torch.Tensor   # (nw,) int32 (uint32 bits)
    brank: torch.Tensor   # (nw,) int32 exclusive rank before each word
    total: torch.Tensor   # () int32 number of set bits
    n: int

    @staticmethod
    def build(bits: torch.Tensor) -> "BitRank":
        words = pack_bits(bits)
        brank, total = _prefix_ranks(words)
        return BitRank(words=words, brank=brank, total=total,
                       n=int(bits.shape[0]))

    @property
    def num_set(self) -> torch.Tensor:
        return self.total

    def bit(self, i: torch.Tensor) -> torch.Tensor:
        """bits[i] as bool (False outside [0, n))."""
        ic = torch.clamp(i, 0, max(self.n - 1, 0)).to(torch.int64)
        w = packed.as_uint(self.words[ic >> 5])
        b = (w >> (ic & 31)) & 1
        return (b == 1) & (i >= 0) & (i < self.n)

    def rank1(self, i: torch.Tensor) -> torch.Tensor:
        """#ones in bits[0..i] (inclusive, like bit_vector::rank1)."""
        i = torch.clamp(i.to(torch.int64), -1, self.n - 1)
        ic = torch.clamp(i, min=0)
        wi = ic >> 5
        r = self.brank[wi].to(torch.int64) + packed.popcount32(
            packed.as_uint(self.words[wi]) & _low_mask(ic & 31))
        return torch.where(i < 0, 0, r)

    def rank0(self, i: torch.Tensor) -> torch.Tensor:
        """#zeros in bits[0..i] (inclusive)."""
        return i + 1 - self.rank1(i)

    def select1(self, r: torch.Tensor) -> torch.Tensor:
        """Position of the r-th one (1-based r), as bit_vector::select1."""
        r = r.to(torch.int32)
        wi = torch.searchsorted(self.brank, r, side="left") - 1
        wi = torch.clamp(wi, 0, max(self.words.shape[0] - 1, 0))
        rr = (r - self.brank[wi]).to(torch.int64)
        pos = _in_word_select(packed.as_uint(self.words[wi]), rr)
        return (wi << 5) + pos

    def next1(self, i: torch.Tensor) -> torch.Tensor:
        """Smallest j >= i with bits[j] set, else n."""
        r = self.rank1(i - 1) + 1
        return torch.where(r <= self.total, self.select1(r), self.n)

    def prev1(self, i: torch.Tensor) -> torch.Tensor:
        """Largest j <= i with bits[j] set, else n."""
        r = self.rank1(i)
        return torch.where(r > 0, self.select1(r), self.n)

    def bits_host(self) -> np.ndarray:
        """(n,) bool on the host."""
        w = packed.lanes_to_numpy(self.words)
        bits = np.unpackbits(w.view(np.uint8), bitorder="little")
        return bits[:self.n].astype(bool)

    def set_positions(self) -> torch.Tensor:
        """Sorted positions of the set bits, (num_set,) int64 on the
        words' device."""
        shifts = torch.arange(32, device=self.words.device)
        bits = ((packed.as_uint(self.words)[:, None] >> shifts) & 1).to(
            torch.bool).reshape(-1)[:self.n]
        return torch.nonzero(bits).squeeze(1)


def _match_bits(words: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """0x80 bit per byte of ``words`` (int64 < 2^32) equal to symbol
    ``c``: SWAR zero-byte detect, exact for byte values < 128."""
    x = words ^ (c.to(torch.int64) * 0x01010101)
    return (~((x + 0x7F7F7F7F) | x)) & 0x80808080


@dataclass(frozen=True)
class SymbolRank:
    """Per-symbol blocked rank/select over a small-alphabet sequence
    (the BOSS W array), byte-packed 4 per word."""
    seq_words: torch.Tensor  # (nb * _WPB,) int32, pad char = sigma
    blocks: torch.Tensor     # (nb + 1, sigma) int32 exclusive block counts
    sigma: int
    n_seq: int

    @staticmethod
    def pack_words(seq_pad: torch.Tensor) -> torch.Tensor:
        """(nb*_BS,) chars (all < 128) -> (nb*_WPB,) int32 words."""
        v = seq_pad.to(torch.int32).view(-1, 4)
        return v[:, 0] | (v[:, 1] << 8) | (v[:, 2] << 16) | (v[:, 3] << 24)

    @staticmethod
    def build(seq: torch.Tensor, sigma: int) -> "SymbolRank":
        n = int(seq.shape[0])
        nb = max((n + _BS - 1) // _BS, 1)
        pad = torch.full((nb * _BS,), sigma, dtype=torch.int8,
                         device=seq.device)
        pad[:n] = seq.to(torch.int8)
        return SymbolRank(seq_words=SymbolRank.pack_words(pad),
                          blocks=block_counts(pad, sigma, nb),
                          sigma=sigma, n_seq=n)

    @property
    def seq_pad(self) -> torch.Tensor:
        """(nb * _BS,) int8 unpacked words, the pad symbol included."""
        w = self.seq_words
        parts = torch.stack([(w >> (8 * b)) & 0xFF for b in range(4)], dim=1)
        return parts.reshape(-1).to(torch.int8)

    @property
    def seq(self) -> torch.Tensor:
        """(n_seq,) int8 view of the sequence."""
        return self.seq_pad[:self.n_seq]

    @property
    def n(self) -> int:
        return self.n_seq

    def __getitem__(self, i) -> torch.Tensor:
        """seq[i] as int32 (i a tensor of positions within [0, n))."""
        i = torch.as_tensor(i, device=self.seq_words.device).to(torch.int64)
        w = packed.as_uint(self.seq_words[i >> 2])
        return ((w >> ((i & 3) * 8)) & 0xFF).to(torch.int32)

    def _rows(self, blk: torch.Tensor) -> torch.Tensor:
        """(Q, _WPB) int64 words of the given blocks."""
        return packed.as_uint(self.seq_words.view(-1, _WPB)[blk])

    def rank(self, c, i) -> torch.Tensor:
        """#occurrences of symbol c in seq[0..i] (inclusive)."""
        dev = self.seq_words.device
        c, i = torch.broadcast_tensors(torch.as_tensor(c, device=dev),
                                       torch.as_tensor(i, device=dev))
        shape = c.shape
        c = c.reshape(-1).to(torch.int64)
        i = i.reshape(-1).to(torch.int64)
        p = torch.clamp(i + 1, 0, self.n)              # exclusive position
        blk = p >> _BS_LOG
        base = self.blocks.reshape(-1)[blk * self.sigma + c].to(torch.int64)
        rem = p & (_BS - 1)
        hz = _match_bits(self._rows(blk), c[:, None])
        # bytes of word j valid iff 4j + b < rem: clamp(rem - 4j, 0, 4)
        vj = torch.clamp(rem[:, None] - 4 * torch.arange(_WPB, device=dev),
                         0, 4)
        masks = torch.tensor(_BYTE_MASKS, dtype=torch.int64, device=dev)[vj]
        cnt = torch.sum(packed.popcount32(hz & masks), dim=1,
                        dtype=torch.int64)
        return (base + cnt).reshape(shape)

    def select(self, c, r) -> torch.Tensor:
        """Position of the r-th (1-based) occurrence of c."""
        dev = self.seq_words.device
        c, r = torch.broadcast_tensors(torch.as_tensor(c, device=dev),
                                       torch.as_tensor(r, device=dev))
        shape = c.shape
        c = c.reshape(-1).to(torch.int64)
        r = r.reshape(-1).to(torch.int64)
        nb = self.blocks.shape[0] - 1
        bflat = self.blocks.reshape(-1)
        steps = max(1, int(np.ceil(np.log2(nb + 2))))
        lo = torch.zeros_like(r)               # invariant: blocks[lo, c] < r
        hi = torch.full_like(r, nb)
        for _ in range(steps):
            mid = (lo + hi + 1) >> 1
            go_up = bflat[mid * self.sigma + c] < r
            lo = torch.where(go_up, mid, lo)
            hi = torch.where(go_up, hi, mid - 1)
        rr = r - bflat[lo * self.sigma + c]
        # r past the symbol's last occurrence (fwd / bwd on a damaged graph
        # under stats --validate) leaves lo = nb: its answer is meaningless,
        # but its gather must stay in bounds, as the JAX package's clamped
        # gather does
        hz = _match_bits(self._rows(torch.clamp(lo, max=nb - 1)), c[:, None])
        mcnt = packed.popcount32(hz).to(torch.int64)   # per word
        cum = torch.cumsum(mcnt, dim=1)
        j = torch.argmax((cum >= rr[:, None]).to(torch.int32), dim=1)
        q = torch.arange(cum.shape[0], device=dev)
        rr_w = rr - (cum[q, j] - mcnt[q, j])
        hz_w = hz[q, j]
        mb = torch.stack([(hz_w >> (8 * b + 7)) & 1 for b in range(4)], dim=1)
        cb = torch.cumsum(mb, dim=1)
        b = torch.argmax((cb >= rr_w[:, None]).to(torch.int32), dim=1)
        return ((lo << _BS_LOG) + 4 * j + b).reshape(shape)


def block_counts(seq_pad: torch.Tensor, sigma: int, nb: int) -> torch.Tensor:
    """(nb + 1, sigma) exclusive per-block symbol counts of a padded
    (nb * _BS,) sequence (the pad symbol ``sigma`` is not counted)."""
    blocks = seq_pad.view(nb, _BS)
    hist = torch.stack([torch.sum(blocks == c, dim=1, dtype=torch.int32)
                        for c in range(sigma)])                # (sigma, nb)
    # one 1D cumsum over the symbol-major histogram (a device-wide scan
    # on the card; a scan along dim 0 of (nb, sigma) gets sigma threads),
    # less each symbol's start. Its running total counts each non-pad
    # position once, so it stays below nb * _BS and fits int32 wherever
    # the counts do.
    flat = torch.cumsum(hist.view(-1), 0, dtype=torch.int32)
    ends = flat[nb - 1::nb]
    starts = torch.cat([ends.new_zeros((1,)), ends[:-1]])
    counts = flat.view(sigma, nb) - starts[:, None]
    return torch.cat([counts.new_zeros((1, sigma)), counts.T])
