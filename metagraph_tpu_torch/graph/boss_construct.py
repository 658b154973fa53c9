"""BOSS construction: sorted packed k-mer sets on the device.

PyTorch counterpart of ``metagraph_tpu/graph/boss_construct.py``, for
the single-shard build over every alphabet (modes ``basic``,
``canonical`` and ``primary``, with or without k-mer counts, from
sequences or from pre-counted k-mers; any number of lanes a k-mer):

  collect     upload the uint8 codes; pack every window (DNA in the
              2-bit domain, the other alphabets at their own B bits,
              extracted and compacted by the partition kernel), fold to
              canonical form, sort, dedupe and count
              (``_sort_unique_ones_body``: sort and partition kernels);
              for basic and canonical builds, gather the dummy-edge
              candidates at the per-run boundary windows, whose positions
              come from the invalid codes on the host. Pre-counted k-mers
              (KMC, count sidecars) take ``collect_counted_kmers`` /
              ``_sort_unique_stage``
  rc closure  canonical mode: append the reverse complements
              (``_add_rc_stage``: partition, sort and merge kernels)
  dummies     with boundary candidates, probe them against the sorted
              real edges (``_probe_dummies``); without (primary mode,
              KMC input), derive them from all real edges by sorts and
              membership merges (``_sink_candidates``,
              ``_source_candidates``); then the K-2 source levels
              (``_levels_phase``)
  emit        sort the dummies (sort kernel), merge them into the real
              edges (merge kernel) and derive W / last / F / weights
              (``_emit_body``; the finish without candidates also drops
              redundant sinks)

Primary mode keeps only the canonical form of each k-mer and builds the
basic graph over those. Sizes are dynamic (PyTorch runs eagerly), so
the JAX package's capacity classes, retry loops, staged large-input
finish and host code packing are gone; counts stay device tensors and
the host syncs only to size arrays: the collect's count, the dummy sets,
each of the K-2 levels (so the dummy side holds no PAD) and the finish
statistics.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..common import device as devmod
from ..common import merge as pmerge
from ..common import packed
from ..common import telemetry
from ..kmer import packing
from ..kmer.alphabets import Alphabet, DNA, INVALID_CODE
from ..kmer.extractor import (encode_sequences, extract_packed_kmers,
                              window_validity)
from .boss import Boss, _build_lut

MODE_BASIC = "basic"
MODE_CANONICAL = "canonical"
MODE_PRIMARY = "primary"
_PORTED_MODES = (MODE_BASIC, MODE_CANONICAL, MODE_PRIMARY)


def _i32(v, dev) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.int32, device=dev)


def _masked(lanes: torch.Tensor, n) -> torch.Tensor:
    """PAD every column at or past ``n``."""
    v = packed.valid_mask(lanes.shape[1], n, lanes.device)
    return torch.where(v[None, :], lanes, packed.PAD_LANE)


# ---------------------------------------------------------------------------
# collect
# ---------------------------------------------------------------------------

def host_boundary_windows(inval_sorted: np.ndarray, n: int, K: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Window positions of the per-run boundaries from the sorted
    invalid-code positions: a maximal valid run [a, b) of length >= K
    contributes its last window (sink candidate) and its first (source
    candidate)."""
    iv = np.concatenate([[-1], inval_sorted.astype(np.int64), [n]])
    a = iv[:-1] + 1
    b = iv[1:]
    ok = (b - a) >= K
    return (b[ok] - K).astype(np.int64), a[ok].astype(np.int64)


def _two_bit(alphabet: Alphabet) -> bool:
    """DNA (four letters and the sentinel, 4-bit fields) collects in the
    2-bit domain; every other alphabet at its own B bits."""
    return alphabet.bits_per_char == 4 and alphabet.size <= 5


def _collect(codes: torch.Tensor, K: int, B: int, canonical: bool,
             complement, bound_pos=None):
    """DNA: windows -> sorted unique k-mers + counts, plus (when
    ``bound_pos`` = (end_pos, start_pos) is given) the boundary dummy
    candidates gathered at those window positions.

    The big sort runs in the 2-BIT domain (chars stored as c-1): real
    k-mers never hold the sentinel, c -> c-1 is monotone, and for
    K <= 31 one int64 key carries a whole k-mer. The survivors expand to
    the 4-bit domain once (``packed.expand2to4``)."""
    assert B == 4
    nw = codes.shape[0] - K + 1
    ok = window_validity(codes, K)
    codes2 = (codes - 1) & 3                # uint8 wraps; invalid masked
    lanes2 = packing.pack_windows(codes2, K, 2)
    if (2 * K) % 32 == 0:
        # full top lane: an all-T k-mer would equal PAD; one zero top
        # lane keeps PAD strictly above every real key
        lanes2 = torch.cat([packed.zeros(nw, 1, codes.device), lanes2])
    L2 = lanes2.shape[0]
    low = L2 - packed.num_lanes(K, 2)

    bounds = None
    if bound_pos is not None:
        end_pos, start_pos = bound_pos

        def gather_nodes(pos, project):
            return project(packed.expand2to4(lanes2[low:, pos], K))

        bounds = (gather_nodes(end_pos, lambda w: packing.node_key(
                      packing.to_next(w, K, B, 0), B)),
                  gather_nodes(start_pos, lambda w: packing.node_key(w, B)))
    lanes = torch.where(ok[None, :], lanes2, packed.PAD_LANE)
    count = torch.sum(ok, dtype=torch.int32)
    if canonical:
        comp2 = tuple(complement[c + 1] - 1 for c in range(4))
        rc = packing.reverse_complement(lanes, K, 2, comp2)
        take_rc = packed.lt(rc, lanes) & ok
        lanes = torch.where(take_rc[None, :], rc, lanes)
    ulanes2, ucounts, ucount = _sort_unique_ones_body(lanes, count)
    ulanes = packed.expand2to4(ulanes2[low:], K)
    # expansion garbles the PAD tail: restore it positionally
    return _masked(ulanes, ucount), ucounts, ucount, bounds


def _collect_bbit(codes: torch.Tensor, K: int, B: int, canonical: bool,
                  complement, bound_pos=None, suffix=()):
    """Every alphabet but DNA, and every suffix-filtered collect, at B
    bits per char: extract and compact the valid windows (partition
    kernel; with ``suffix`` only those of that node suffix), fold each to
    canonical form, sort-unique; the boundary candidates are packed from
    the codes of the windows at ``bound_pos``. Returns what ``_collect``
    does.

    No key can equal PAD: codes stay below 2^B - 1 (at most 26 in 8
    bits, 9 in 4), so no field of a real k-mer is all ones."""
    lanes, count = extract_packed_kmers(codes, K, B, suffix)
    if suffix:
        # a bucket keeps about 1/sigma^s of the windows: sort those alone
        # (the compaction's PAD tail starts at the count)
        lanes = lanes[:, :max(int(count), 1)]
    if canonical:
        rc = packing.reverse_complement(lanes, K, B, complement)
        take_rc = packed.lt(rc, lanes) & packed.valid_mask(
            lanes.shape[1], count)
        lanes = torch.where(take_rc[None, :], rc, lanes)
    ulanes, ucounts, ucount = _sort_unique_ones_body(lanes, count)
    bounds = None
    if bound_pos is not None:
        offs = torch.arange(K, device=codes.device)

        def windows(pos):
            return packing.pack_from_chars(codes[pos[:, None] + offs], K, B)

        end_pos, start_pos = bound_pos
        bounds = (packing.node_key(packing.to_next(windows(end_pos), K, B, 0),
                                   B),
                  packing.node_key(windows(start_pos), B))
    return ulanes, ucounts, ucount, bounds


def _sort_unique_ones_body(lanes: torch.Tensor, count: torch.Tensor):
    """Sort-unique when every input k-mer has count 1: with unit counts
    the exclusive running sum is the position, so per-group counts are
    differences of the compacted group-first positions."""
    cap = lanes.shape[1]
    dev = lanes.device
    lanes_s, _ = pmerge.sort_packed(lanes)
    first = packed.neighbor_ne(lanes_s)
    umask = first & packed.valid_mask(cap, count)   # PADs sorted to the back
    excl = torch.arange(cap, dtype=torch.int32, device=dev)
    ulanes, ucount, (b,) = pmerge.partition_compact(lanes_s, umask, cap, excl)
    total = count.reshape(1)
    nxt = torch.cat([b[1:], total])
    pos_ok = packed.valid_mask(cap, ucount)
    nxt_ok = torch.cat([pos_ok[1:], torch.zeros((1,), dtype=torch.bool,
                                                  device=dev)])
    nxt = torch.where(nxt_ok, nxt, total)
    ucounts = torch.where(pos_ok, nxt - b, 0).to(torch.int32)
    return ulanes, ucounts, ucount


def _sort_unique_stage(lanes: torch.Tensor, counts: torch.Tensor, count):
    """Sort, dedupe and sum counts (saturated at emit). Per-group sums
    are differences of the exclusive running sum taken at consecutive
    group-first positions, which the compaction makes adjacent; int32
    sums wrap as the JAX package's do, and the differences undo it."""
    cap = lanes.shape[1]
    dev = lanes.device
    valid = packed.valid_mask(cap, count, dev)
    counts = torch.where(valid, counts, 0)
    lanes_s, (counts_s,) = pmerge.sort_packed(lanes, counts)
    umask = packed.neighbor_ne(lanes_s) & valid     # PADs sorted to the back
    csum = packed.blocked_cumsum(counts_s)
    excl = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev),
                      csum[:-1]])
    total = torch.sum(counts_s, dtype=torch.int32).reshape(1)
    ulanes, ucount, (b,) = pmerge.partition_compact(lanes_s, umask, cap, excl)
    pos_ok = packed.valid_mask(cap, ucount)
    nxt_ok = torch.cat([pos_ok[1:], torch.zeros((1,), dtype=torch.bool,
                                                  device=dev)])
    nxt = torch.where(nxt_ok, torch.cat([b[1:], total]), total)
    ucounts = torch.where(pos_ok, nxt - b, 0).to(torch.int32)
    return ulanes, ucounts, ucount


def collect_kmers(seqs: Sequence[bytes | str], K: int,
                  alphabet: Alphabet = DNA, canonical: bool = False,
                  extra_codes=None, device="cuda", with_bounds: bool = True,
                  suffix: Tuple[int, ...] = ()):
    """Extract, sort, dedupe and count all k-mers of the input (with
    ``suffix``, only the windows of that node suffix: one bucket of a
    suffix-sharded build, which has no boundary candidates).

    Returns (sorted unique lanes (L, max(n, 1)), counts, n, bounds), with
    ``bounds`` the (sink, source) dummy-candidate node keys, or None
    without ``with_bounds``."""
    with telemetry.span("collect", quiet=True):
        dev = devmod.resolve(device)
        suffix = tuple(suffix)
        with_bounds = with_bounds and not suffix
        codes_np = (encode_sequences(seqs, alphabet) if extra_codes is None
                    else np.asarray(extra_codes, np.uint8))
        if codes_np.shape[0] < K:
            codes_np = np.concatenate(
                [codes_np, np.full(K - codes_np.shape[0], INVALID_CODE,
                                   np.uint8)])
        bound_pos = None
        if with_bounds:
            # the codes window_validity rejects: INVALID and the sentinel
            inval = np.flatnonzero((codes_np == INVALID_CODE)
                                   | (codes_np == 0))
            bound_pos = tuple(
                torch.from_numpy(p).to(dev) for p in
                host_boundary_windows(inval, codes_np.shape[0], K))
        codes = torch.from_numpy(codes_np).to(dev)
        if suffix:
            ulanes, ucounts, ucount, bounds = _collect_bbit(
                codes, K, alphabet.bits_per_char, canonical,
                alphabet.complement, suffix=suffix)
        else:
            collect = _collect if _two_bit(alphabet) else _collect_bbit
            ulanes, ucounts, ucount, bounds = collect(
                codes, K, alphabet.bits_per_char, canonical,
                alphabet.complement, bound_pos)
        n_u = int(ucount)                   # the collect's one host sync
        cap = max(n_u, 1)
        return ulanes[:, :cap], ucounts[:cap], n_u, bounds


def collect_counted_kmers(chars: np.ndarray, counts: np.ndarray, K: int,
                          alphabet: Alphabet = DNA, canonical: bool = False,
                          device="cuda"):
    """Sorted unique k-mers from pre-counted input (KMC databases): (n, K)
    char codes and (n,) counts, clamped to 2^31 - 1. Returns (lanes
    (L, max(n_u, 1)), counts, n_u)."""
    dev = devmod.resolve(device)
    B = alphabet.bits_per_char
    n = chars.shape[0]
    lanes = packing.pack_from_chars(
        torch.from_numpy(np.ascontiguousarray(chars, np.uint8)).to(dev), K, B)
    cnts = torch.from_numpy(np.minimum(np.asarray(counts, np.int64),
                                       (1 << 31) - 1).astype(np.int32)).to(dev)
    if n == 0:                              # one PAD column, as collect has
        lanes = packed.full_pad(1, lanes.shape[0], dev)
        cnts = torch.zeros((1,), dtype=torch.int32, device=dev)
    if canonical:
        rc = packing.reverse_complement(lanes, K, B, alphabet.complement)
        take_rc = packed.lt(rc, lanes) & packed.valid_mask(lanes.shape[1], n,
                                                           dev)
        lanes = torch.where(take_rc[None, :], rc, lanes)
    ulanes, ucounts, ucount = _sort_unique_stage(lanes, cnts, n)
    n_u = int(ucount)
    cap = max(n_u, 1)
    return ulanes[:, :cap], ucounts[:cap], n_u


# ---------------------------------------------------------------------------
# finish
# ---------------------------------------------------------------------------

def _add_rc_stage(lanes, counts, count, K: int, B: int, complement):
    """Append the reverse complements of all (unique, canonical-form)
    k-mers; palindromes double their count (saturated at emit)."""
    cap = lanes.shape[1]
    valid = packed.valid_mask(cap, count, lanes.device)
    rc = packing.reverse_complement(lanes, K, B, complement)
    pal = packed.eq(rc, lanes) & valid
    counts = torch.where(pal, counts * 2, counts)
    add_mask = valid & ~pal
    n_add = torch.sum(add_mask, dtype=torch.int32)
    rc_comp, _, (rc_counts,) = pmerge.partition_compact(
        rc, add_mask, cap, counts)
    # sort only the rc half, then one linear merge with the sorted half
    rc_s, (rc_counts_s,) = pmerge.sort_packed(rc_comp, rc_counts)
    out_s, (counts_s,) = pmerge.merge_sorted(
        _masked(lanes, count), rc_s, (torch.where(valid, counts, 0),),
        (rc_counts_s,))
    return out_s, counts_s, count + n_add


def _rc_node(nk, K: int, B: int, complement):
    """Reverse complement of a node key (S_{j+1} at field j): a fieldwise
    reverse + complement."""
    comp = torch.tensor(complement, dtype=packed.LANE_DTYPE, device=nk.device)
    fields = packed.to_fields(nk, K - 1, B)
    top = len(complement) - 1
    rc = torch.stack([comp[torch.clamp(fields[K - 2 - j], max=top).long()]
                      for j in range(K - 1)])
    return packed.from_fields(rc, B, lanes=nk.shape[0])


def _probe_dummies(real_m, sink_cand, src_cand, K: int, B: int, sigma: int):
    """Dummy sink + dummy-1 source edges from the boundary candidates,
    all probes in ONE batched binary search over the real edges.

    Sinks: the outgoing edges of node T are the range [(T,0), (T,0xF)]
    of BOSS order; T has none iff both bounds land together. Sources:
    the incoming edges of node S are the <= sigma-1 k-mers
    (c, S_1..S_{K-1}); S has none iff no probe hits."""
    capk = sink_cand.shape[1]
    capr = src_cand.shape[1]
    dev = real_m.device
    ks, _ = packed.sort(sink_cand)
    first_k = packed.neighbor_ne(ks)
    pad_k = packed.top_bit_set(ks[0])
    lo_keys = packed.shift_left(ks, B)                # (T, $) sink edge
    hi_keys = lo_keys.clone()
    hi_keys[-1] |= (1 << B) - 1

    rs, _ = packed.sort(src_cand)
    first_r = packed.neighbor_ne(rs)
    pad_r = packed.top_bit_set(rs[0])
    # node-key layout: S_j at field j-1
    top = packed.get_field(rs, K - 2, B)              # S_{K-1}
    body = packed.set_field(rs, K - 2, torch.zeros_like(top), B)
    # S_1..S_{K-2} up to fields 2..K-1; f0 = label S_{K-1}; f1 = $/probe
    base = packed.set_field(packed.shift_left(body, 2 * B), 0, top, B)
    probes = [packed.set_field(base, 1, torch.full_like(top, c), B)
              for c in range(1, sigma)]

    queries = torch.cat([lo_keys, hi_keys] + probes, dim=1)
    pos = packed.searchsorted(real_m, queries, side="left")
    lo, hi = pos[:capk], pos[capk:2 * capk]
    keep_k = first_k & (hi == lo) & ~pad_k
    sinks, n_sinks, _ = packed.compact(lo_keys, keep_k, capk)

    n = real_m.shape[1]
    present = torch.zeros((capr,), dtype=torch.bool, device=dev)
    for ci in range(sigma - 1):
        sl = pos[2 * capk + ci * capr:2 * capk + (ci + 1) * capr]
        p = torch.clamp(sl, max=n - 1)
        present = present | packed.eq(real_m[:, p], probes[ci])
    keep_r = first_r & ~present & ~pad_r
    src, n_src, _ = packed.compact(base, keep_r, capr)
    src_s, _ = packed.sort(src)                       # PAD tail intact
    return sinks, n_sinks, src_s, n_src


def _levels_phase(src: torch.Tensor, K: int, B: int):
    """Dummy-source levels 2..K-1 from the sorted dummy-1 sources (no PAD
    tail): each level is the previous one's distinct source nodes stepped
    back one char, sorted. One host sync per level sizes it exactly: a
    primary build has about one source per two real edges, and most of
    its K - 2 levels stay that large, so PAD-filled slots of the first
    level's size would double the dummy side."""
    levels = []
    cur = src
    for _ in range(max(K - 2, 0)):
        node_first = packed.neighbor_ne(packing.node_key(cur, B))
        cand, n_cand, _ = packed.compact(packing.to_prev(cur, K, B, 0),
                                         node_first, cur.shape[1])
        cur, _ = pmerge.sort_packed(cand[:, :int(n_cand)])
        levels.append(cur)
    return levels


# Valid node / target keys have zero top bits (each char takes <= B
# bits and the tag shift adds one more); after the tag-bit left shift
# and the shift back, a PAD shows 0x7FFFFFFF in the top lane, above
# every valid key.
_PAD_TOP_AFTER_SHIFT = 0x7FFFFFFF


def _tag_lanes(keys, tag: int):
    """Shift a packed key left one bit and put ``tag`` in the new LSB, so
    that within a run of equal keys the tag-0 entries sort first."""
    out = packed.shift_left(keys, 1)
    out[-1] = out[-1] | tag
    return out


def _merge_membership(keys, queries):
    """Set membership of sorted ``queries`` in sorted ``keys`` (both
    (L, n) with PAD tails) by ONE merge (merge kernel). Returns, in
    merged order, which is sorted: (vals, is_q, present, is_pad,
    run_first), ``present`` marking entries whose run of equal values
    holds a key."""
    merged, _ = pmerge.merge_sorted(_tag_lanes(keys, 0),
                                    _tag_lanes(queries, 1))
    tagbit = merged[-1] & 1
    vals = packed.shift_right(merged, 1)
    is_pad = ~packed.ult(vals[0], _PAD_TOP_AFTER_SHIFT)   # unsigned >=
    is_q = (tagbit == 1) & ~is_pad
    is_key = ((tagbit == 0) & ~is_pad).to(torch.int32)
    keys_incl = packed.blocked_cumsum(is_key)
    run_first = packed.neighbor_ne(vals)
    # keys sort before queries within a run, so "my run has a key" = the
    # key count grew since the run started (forward-filled by a cummax)
    run_excl = packed.blocked_cummax(
        torch.where(run_first, keys_incl - is_key, 0))
    present = (keys_incl - run_excl) > 0
    return vals, is_q, present, is_pad, run_first


def _sink_candidates(real, n_real, K: int, B: int):
    """Dummy sink edges (node e_2..e_K, label $): the target nodes of
    real edges with no real outgoing edge, sorted and deduped. Returns
    (sinks (L, cap) with a PAD tail, count)."""
    cap = real.shape[1]
    valid = packed.valid_mask(cap, n_real, real.device)[None, :]
    # node_key preserves BOSS order: the masked keys are sorted
    keys = torch.where(valid, packing.node_key(real, B), packed.PAD_LANE)
    q_nodes = torch.where(valid, packing.node_key(
        packing.to_next(real, K, B, 0), B), packed.PAD_LANE)
    q_s, _ = pmerge.sort_packed(q_nodes)
    vals, is_q, present, is_pad, run_first = _merge_membership(keys, q_s)
    # each key-less run's first query once: duplicates are adjacent
    keep = is_q & ~present & ~is_pad & run_first
    nodes_out, n_out, _ = pmerge.partition_compact(vals, keep, cap)
    sinks = torch.where(packed.valid_mask(cap, n_out)[None, :],
                        packed.shift_left(nodes_out, B), packed.PAD_LANE)
    return sinks, n_out


def _source_candidates(real, n_real, K: int, B: int):
    """Dummy-1 source edges ($ e_1..e_{K-2}, label e_{K-1}) of the source
    nodes with no real incoming edge. The query key target_key(to_prev(e))
    = (e_1..e_{K-2}, e_{K-1}) identifies the candidate and sorts in the
    BOSS order of the dummy edge, so the compacted merged output is
    sorted. Returns (src (L, cap) with a PAD tail, count)."""
    cap = real.shape[1]
    valid = packed.valid_mask(cap, n_real, real.device)
    node_first = packed.neighbor_ne(packing.node_key(real, B)) & valid
    q_t = packing.target_key(packing.to_prev(real, K, B, 0), B)
    q_s, _ = pmerge.sort_packed(
        torch.where(node_first[None, :], q_t, packed.PAD_LANE))
    tk_s, _ = pmerge.sort_packed(
        torch.where(valid[None, :], packing.target_key(real, B),
                    packed.PAD_LANE))
    vals, is_q, present, is_pad, _ = _merge_membership(tk_s, q_s)
    keep = is_q & ~present & ~is_pad
    tk_out, n_src, _ = pmerge.partition_compact(vals, keep, cap)
    # rebuild the edge from its target key: e_1..e_{K-2} move up one
    # slot past the $ sentinel, e_{K-1} stays the label
    lab = packing.label(tk_out, B)
    body = packed.set_field(tk_out, 0, torch.zeros_like(lab), B)
    src = packed.set_field(packed.shift_left(body, B), 0, lab, B)
    src = torch.where(packed.valid_mask(cap, n_src)[None, :], src,
                      packed.PAD_LANE)
    return src, n_src


def _merge_emit_body(real, counts, n_real, dummy_parts, K: int, B: int,
                     alph_size: int, max_count: int,
                     skip_redundant_sinks: bool, with_sentinel: bool = True):
    """Sort the dummy side (``dummy_parts``: lane arrays without PAD; the
    list is emptied, so its arrays free once joined) with the $^K
    sentinel row (``with_sentinel``; an out-of-core build adds it on its
    first shard only), merge it into the sorted real side in one linear
    pass (merge kernel), then emit. Every dummy holds the sentinel and no
    real edge does, so no key appears on both sides."""
    L = real.shape[0]
    dev = real.device
    sent = [packed.zeros(1, L, dev)] if with_sentinel else []
    dummies = torch.cat(dummy_parts + sent + [packed.zeros(0, L, dev)], dim=1)
    dummy_parts.clear()
    n_dummies = dummies.shape[1]
    counts_m = torch.where(packed.valid_mask(real.shape[1], n_real, dev),
                           counts, 0)
    if n_dummies:
        dummies, _ = pmerge.sort_packed(dummies)
        merged, (mcounts,) = pmerge.merge_sorted(
            _masked(real, n_real), dummies, (counts_m,),
            (torch.zeros((n_dummies,), dtype=torch.int32, device=dev),))
    else:
        merged, mcounts = _masked(real, n_real), counts_m
    del dummies, counts_m
    n_total = n_real + n_dummies
    mcounts = torch.where(packed.valid_mask(merged.shape[1], n_total, dev),
                          mcounts, 0)
    return _emit_body(merged, mcounts, n_total, K, B, alph_size, max_count,
                      skip_redundant_sinks)


def _emit_body(merged, counts, n_total, K: int, B: int, alph_size: int,
               max_count: int, skip_redundant_sinks: bool):
    """The initialize_chunk scan, vectorized: redundant sinks (a dummy
    sink edge of a node that has a real outgoing edge) dropped by one
    partition, then last bits from neighbor node-key compares and minus
    flags from per-label first occurrences in each target block. The
    probe-based dummy sinks are exact, so that finish skips the drop."""
    cap = merged.shape[1]
    dev = merged.device
    no = torch.zeros((1,), dtype=torch.bool, device=dev)
    if skip_redundant_sinks:
        valid = packed.valid_mask(cap, n_total, dev)
        nodes = packing.node_key(merged, B)
        same_next = (torch.cat([packed.eq(nodes[:, :-1], nodes[:, 1:]), no])
                     & valid & torch.cat([valid[1:], no]))
        skip = (same_next & (packing.label(merged, B) == 0)
                & (packing.top_char(merged, K, B) != 0))
        kept, n_kept, (kcounts,) = pmerge.partition_compact(
            merged, valid & ~skip, cap, counts)
        del valid, nodes, same_next, skip
    else:
        kept, n_kept, kcounts = merged, n_total, counts
    kvalid = packed.valid_mask(cap, n_kept, dev)
    knodes = packing.node_key(kept, B)
    ksame_next = torch.cat([packed.eq(knodes[:, :-1], knodes[:, 1:]), no])
    del knodes
    next_valid = torch.cat([kvalid[1:], no])
    last = kvalid & ~(ksame_next & next_valid)

    klabels = packing.label(kept, B)
    ktopc = packing.top_char(kept, K, B)
    # minus flag: not the first (target node, label) in BOSS order. Edges
    # sharing a target key sit in one block of equal u_2..u_{K-1}; per
    # label c, "first c in my block" is a global cumsum of the label mask
    # minus its value at the block start (forward-filled by a cummax).
    block_first = packed.neighbor_ne(packed.shift_right(kept, 2 * B))
    minus = torch.zeros((cap,), dtype=torch.bool, device=dev)
    for c in range(1, alph_size):
        mask_c = (klabels == c) & kvalid
        mi = mask_c.to(torch.int32)
        cnt = packed.blocked_cumsum(mi)
        start_excl = packed.blocked_cummax(
            torch.where(block_first, cnt - mi, 0))
        minus = minus | (mask_c & ((cnt - start_excl) > 1))
    minus = minus & (klabels != 0) & kvalid

    W = torch.where(minus, klabels + alph_size, klabels)
    W = torch.where(kvalid, W, 0).to(torch.int32)
    # the top char is nondecreasing over the valid prefix: F is one
    # batched binary search
    tc = torch.where(kvalid, ktopc, alph_size).to(torch.int32)
    F = torch.searchsorted(tc, torch.arange(alph_size, dtype=torch.int32,
                                            device=dev),
                           side="left").to(torch.int32)
    kfirst = packing.first_char(kept, B)
    weights = torch.where(
        (kcounts > 0) & (klabels != 0) & (kfirst != 0),
        torch.clamp(kcounts, max=max_count), 0).to(torch.int32)
    return kept, n_kept, W, last, F, weights


def _finish_stage_bounds(real, counts, n_real, sink_cand, src_cand,
                         K: int, B: int, alph_size: int, canonical: bool,
                         complement):
    """The dummies with boundary candidates: rc closure (canonical), then
    the dummy probes. Returns (real, counts, n_real, sinks, n_sinks, src,
    n_src): the dummy sinks and dummy-1 sources each sorted, with a PAD
    tail."""
    if canonical:
        real, counts, n_real = _add_rc_stage(real, counts, n_real, K, B,
                                             complement)
    real_m = _masked(real, n_real)
    if canonical:
        def rc_masked(x):
            pad = packed.top_bit_set(x[0])
            return torch.where(pad[None, :], packed.PAD_LANE,
                               _rc_node(x, K, B, complement))
        tgt_c, src_c = sink_cand, src_cand
        sink_cand = torch.cat([tgt_c, rc_masked(src_c)], dim=1)
        src_cand = torch.cat([src_c, rc_masked(tgt_c)], dim=1)
    sinks, n_sinks, src, n_src = _probe_dummies(
        real_m, sink_cand, src_cand, K, B, alph_size)
    return real, counts, n_real, sinks, n_sinks, src, n_src


def _finish_stage(real, counts, n_real, K: int, B: int, canonical: bool,
                  complement):
    """The dummies without boundary candidates: rc closure (canonical),
    then the dummy sinks and sources from all real edges (redundant sinks
    are dropped at emit). Returns what ``_finish_stage_bounds`` does."""
    if canonical:
        real, counts, n_real = _add_rc_stage(real, counts, n_real, K, B,
                                             complement)
    sinks, n_sinks = _sink_candidates(real, n_real, K, B)
    src, n_src = _source_candidates(real, n_real, K, B)
    return real, counts, n_real, sinks, n_sinks, src, n_src


def _finish_tail(real, counts, n_real, parts, K: int, B: int,
                 alph_size: int, max_count: int, skip_redundant_sinks: bool):
    """Merge, emit and the search table from the dummy side (``parts``:
    the sinks, the dummy-1 sources and the levels, without PAD)."""
    kept, n_kept, W, last, F, weights = _merge_emit_body(
        real, counts, n_real, parts, K, B, alph_size, max_count,
        skip_redundant_sinks)
    lut, max_bucket = _build_lut(kept, n_kept)     # the search table
    stats = torch.stack([_i32(x, kept.device) for x in (n_kept, max_bucket)])
    return kept, W, last, F, weights, lut, stats


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _check_mode(mode: str, alphabet: Alphabet):
    if mode not in _PORTED_MODES:
        raise NotImplementedError(f"mode {mode!r} is not yet ported")
    if mode != MODE_BASIC and not alphabet.complement:
        raise ValueError(f"{mode} mode needs a complemented alphabet; "
                         f"{alphabet.name} has no complement table")


def build_boss_from_kmers(real, counts, n_real: int, K: int,
                          alphabet: Alphabet = DNA, mode: str = MODE_BASIC,
                          bits_per_count: int = 0,
                          bounds=None) -> Boss:
    """Generate the dummy edges, merge, and emit the BOSS arrays from
    sorted unique k-mers (``collect_kmers`` or ``collect_counted_kmers``).
    With ``bounds`` (``collect_kmers``' boundary candidates) the dummies
    come from probes of the candidates, else from sorts over all real
    edges. ``mode`` canonical adds the reverse-complement closure; any
    other mode builds the graph of the k-mers as given."""
    with telemetry.span("finish", quiet=True):
        _check_mode(mode, alphabet)
        B = alphabet.bits_per_char
        max_count = ((1 << bits_per_count) - 1 if bits_per_count
                     else (1 << 31) - 1)
        canonical = mode == MODE_CANONICAL
        with telemetry.span("finish.dummies", quiet=True):
            n = _i32(n_real, real.device)
            if bounds is None:
                real, counts, n, sinks, n_sinks, src, n_src = _finish_stage(
                    real, counts, n, K, B, canonical, alphabet.complement)
            else:
                real, counts, n, sinks, n_sinks, src, n_src = (
                    _finish_stage_bounds(real, counts, n, *bounds, K, B,
                                         alphabet.size, canonical,
                                         alphabet.complement))
            # one host sync sizes both sets: the dummy side carries no PAD
            ns, nr = torch.stack([n_sinks, n_src]).tolist()
        with telemetry.span("finish.levels", quiet=True):
            src = src[:, :nr]
            parts = [sinks[:, :ns], src] + _levels_phase(src, K, B)
        del sinks, src          # their buffers go once the emit joins them
        with telemetry.span("finish.emit", quiet=True):
            kept, W, last, F, weights, lut, stats = _finish_tail(
                real, counts, n, parts, K, B, alphabet.size, max_count,
                skip_redundant_sinks=bounds is None)
            stats = stats.cpu().numpy()      # the finish's last host sync
            return Boss.from_finish(
                k=K - 1, alph_size=alphabet.size, bits_per_char=B,
                kept=kept, W=W, last=last, F=F, n_kept=int(stats[0]),
                weights=weights if bits_per_count else None, lut=lut,
                max_bucket=int(stats[1]))


def build_boss_from_codes(codes_np: np.ndarray, k: int,
                          alphabet: Alphabet = DNA, mode: str = MODE_BASIC,
                          bits_per_count: int = 0, device="cuda") -> Boss:
    """Build from a pre-encoded code array (INVALID between records)."""
    return _build([], codes_np, k, alphabet, mode, bits_per_count, device)


def build_boss(seqs: Sequence[bytes | str], k: int,
               alphabet: Alphabet = DNA, mode: str = MODE_BASIC,
               bits_per_count: int = 0, suffix: Tuple[int, ...] = (),
               device="cuda") -> Boss:
    """End-to-end single-shard BOSS build for DBG k-mer size ``k`` (edge
    k-mers of k characters; BOSS node length k-1); with ``suffix``, the
    graph of that node-suffix bucket's k-mers alone."""
    return _build(seqs, None, k, alphabet, mode, bits_per_count, device,
                  suffix)


def _build(seqs, codes_np, k: int, alphabet: Alphabet, mode: str,
           bits_per_count: int, device, suffix=()) -> Boss:
    """Collect, then finish. Primary mode folds each k-mer to its
    canonical form and builds the basic graph over those; its boundary
    windows no longer bound the dummy sets, so it takes the finish
    without candidates (as does a suffix bucket)."""
    _check_mode(mode, alphabet)
    with telemetry.span("build", quiet=True):
        ulanes, ucounts, n_u, bounds = collect_kmers(
            seqs, k, alphabet, canonical=mode != MODE_BASIC,
            extra_codes=codes_np, device=device,
            with_bounds=mode != MODE_PRIMARY, suffix=suffix)
        return build_boss_from_kmers(
            ulanes, ucounts, n_u, k, alphabet,
            mode=MODE_CANONICAL if mode == MODE_CANONICAL else MODE_BASIC,
            bits_per_count=bits_per_count, bounds=bounds)
