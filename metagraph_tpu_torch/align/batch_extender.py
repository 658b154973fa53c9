"""Batched beam-search extension and batched DP scoring for the aligner.

PyTorch counterpart of ``metagraph_tpu/align/batch_extender.py``. The
whole read batch extends in lockstep on the device:

  * state: (B reads x W beam entries) DP columns H / D of width LQ+1;
  * per step: one batched successor lookup for all B*W frontier nodes
    (a gather from the adjacency table), an affine-DP column update for
    all B*W*(sigma-1) candidate edges, and a per-read top-W selection
    with x-drop pruning;
  * the walk records per-step (parent beam, character, node) choices,
    and a reverse walk over them recovers each read's winning path.

Each ``lax.scan`` of the JAX package is a Python loop over batched
tensor ops here. CIGARs come from one batched full DP (``_full_dp``)
plus a batched traceback (``_dp_traceback``); score-only ends come from
``pallas_dp.batch_align_ends`` (the CUDA kernel for CUDA tensors, its
plain version for CPU tensors). The batch and width padding the JAX
package used to bound its compiled shapes is gone; the short / long
sub-batch split, the tail trim and the scan length, which decide how far
the beam walks, are kept.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..common.device import resolve
from . import pallas_dp

NEG = -(10 ** 8)


def _cap_lin(n: int, step: int, lo: int) -> int:
    """``n`` (at least ``lo``) rounded up to a multiple of ``step``."""
    n = max(int(n), lo)
    return ((n + step - 1) // step) * step


def _subst(q, c, table):
    """Substitution scores of broadcast code tensors, gathered from the
    ``pallas_dp.score_table`` (the DNA table equals the JAX package's
    arithmetic transition / transversion formula)."""
    q, c = torch.broadcast_tensors(q, c)
    return table[q.long(), c.long()]


def _prefix_max(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix max along the last axis."""
    return torch.cummax(x, dim=-1).values


def _column_update(H, D, q, c, jj, table, open_p, ext_p):
    """One DP column step. H, D: (..., LQ+1); q: (..., LQ); c: (..., 1).
    Returns (H', Dn, I); Dn keeps the shape of H (it does not depend on
    the candidate character)."""
    subs = _subst(q, c, table)
    Dn = torch.maximum(H - open_p, D - ext_p)
    diag = H[..., :-1] + subs
    Dnb = Dn.expand(diag.shape[:-1] + (Dn.shape[-1],))
    Hn = torch.cat([Dnb[..., :1], torch.maximum(diag, Dnb[..., 1:])], dim=-1)
    jext = (jj * ext_p).to(torch.int32)
    run = _prefix_max(Hn + jext)
    pad = torch.full(Hn.shape[:-1] + (1,), NEG, dtype=torch.int32,
                     device=Hn.device)
    I = torch.cat([pad, run[..., :-1]], dim=-1) - jext - (open_p - ext_p)
    return torch.maximum(Hn, I), Dn, I


def _beam_scan(graph, start_nodes, tails, tlens, steps, beam, match, tpen,
               tvpen, open_p, ext_p, xdrop, backward, adj_tab=None,
               min_cell=NEG, sub_tt=None, sigma=5):
    """Run the batched beam extension on the tensors' device.

    Returns (best (B,), best_step (B,), best_beam (B,),
             parents (steps, B, W), chars (steps, B, W),
             nodes_hist (steps, B, W)), all int32 tensors."""
    B, LQ = tails.shape
    W = beam
    S = sigma - 1
    dev = tails.device
    i32 = torch.int32
    table = pallas_dp.score_table(match, tpen, tvpen, sub_tt, dev)
    jj = torch.arange(LQ + 1, dtype=i32, device=dev)
    j_valid = jj[None, :] <= tlens[:, None]                   # (B, LQ+1)
    H0 = torch.where(jj == 0, 0, -open_p - (jj - 1) * ext_p)[None, :]
    H0 = torch.where(j_valid, H0, NEG).to(i32)
    H = torch.full((B, W, LQ + 1), NEG, dtype=i32, device=dev)
    H[:, 0, :] = H0
    D = torch.full((B, W, LQ + 1), NEG, dtype=i32, device=dev)
    node = torch.zeros((B, W), dtype=i32, device=dev)
    node[:, 0] = start_nodes
    alive = torch.zeros((B, W), dtype=torch.bool, device=dev)
    alive[:, 0] = start_nodes > 0
    best = torch.where(start_nodes > 0, 0, NEG).to(i32)
    best_step = torch.full((B,), -1, dtype=i32, device=dev)
    best_beam = torch.zeros((B,), dtype=i32, device=dev)
    qb = tails.to(i32)[:, None, None, :]
    c = torch.arange(1, S + 1, dtype=i32, device=dev)[None, None, :, None]
    jmask = j_valid[:, None, None, :]
    bidx = torch.arange(B, device=dev)[:, None]
    # the top-W pick must break ties as lax.top_k does (lower index
    # first): a key unique per candidate makes any top-k give that order
    rank = (W * S - 1 - torch.arange(W * S, dtype=torch.int64, device=dev))
    parents, chars, nodes_hist = [], [], []
    for t in range(steps):
        flat = node.reshape(-1)
        if adj_tab is not None:
            adj = adj_tab[flat.long()]
        else:
            adj = (graph.predecessors(flat) if backward
                   else graph.successors(flat))
        succ = adj.reshape(B, W, S).to(i32)
        Hn, Dn, _ = _column_update(H[:, :, None, :], D[:, :, None, :], qb,
                                   c, jj, table, open_p, ext_p)
        Hn = torch.where(jmask, Hn, NEG)                      # (B,W,S,LQ+1)
        valid = alive[:, :, None] & (succ > 0)
        colmax = torch.where(valid, Hn.amax(dim=-1), NEG)     # (B, W, S)
        key = colmax.reshape(B, W * S).to(torch.int64) * (W * S) + rank
        top_idx = torch.topk(key, W, dim=1).indices           # (B, W)
        top_score = torch.gather(colmax.reshape(B, W * S), 1, top_idx)
        pw = top_idx // S
        H = Hn.reshape(B, W * S, LQ + 1)[bidx, top_idx]
        D = Dn[:, :, 0, :][bidx, pw]
        node = succ.reshape(B, W * S)[bidx, top_idx]
        step_best = top_score[:, 0]
        improved = step_best > best
        best = torch.maximum(best, step_best)
        best_step = torch.where(improved, t, best_step)
        best_beam = torch.where(improved, 0, best_beam)
        alive = (top_score > NEG // 2) & (top_score >= best[:, None] - xdrop)
        if min_cell > NEG:        # reference --align-min-cell-score
            alive &= top_score >= min_cell
        parents.append(pw.to(i32))
        chars.append((top_idx % S + 1).to(i32))
        nodes_hist.append(node)
    return (best, best_step, best_beam, torch.stack(parents),
            torch.stack(chars), torch.stack(nodes_hist))


def beam_extend_batch(graph, start_nodes: np.ndarray, tails: np.ndarray,
                      tlens: np.ndarray, cfg, beam: int = 8,
                      backward: bool = False, adj_tab=None, sub_tt=None
                      ) -> Tuple[np.ndarray, List[np.ndarray],
                                 List[np.ndarray]]:
    """Extend every read's seed through the graph at once, on the
    graph's device.

    Returns (best_scores (B,), per-read char-code paths, per-read
    node-id paths), the paths truncated at the best step. Short tails
    run in their own sub-batch with a shorter scan when the batch mixes
    them with long ones."""
    B = tails.shape[0]
    if B == 0:
        return np.zeros(0, np.int64), [], []
    max_ram = getattr(cfg, "max_ram_mb", None)
    if max_ram:
        # reference --align-max-ram: bound the live DP footprint, the
        # (B, W, S, LQ+1) candidate columns (x3 for H/D/I) in int32
        LQ1 = tails.shape[1] + 1
        per_row = beam * 4 * LQ1 * 4 * 3
        cap = max(int(max_ram * 1e6 / per_row), 8)
        if B > cap:
            scores = np.zeros(B, np.int64)
            chars = [None] * B
            nodes = [None] * B
            for lo in range(0, B, cap):
                hi = min(lo + cap, B)
                s, c, n = beam_extend_batch(
                    graph, start_nodes[lo:hi], tails[lo:hi], tlens[lo:hi],
                    cfg, beam, backward, adj_tab, sub_tt)
                scores[lo:hi] = s
                chars[lo:hi] = c
                nodes[lo:hi] = n
            return scores, chars, nodes
    SHORT = 32
    long_mask = np.asarray(tlens) > SHORT
    if B >= 32 and long_mask.any() and (~long_mask).sum() >= B // 4:
        scores = np.zeros(B, np.int64)
        chars: List[np.ndarray] = [None] * B
        nodes: List[np.ndarray] = [None] * B
        for idx in (np.nonzero(~long_mask)[0], np.nonzero(long_mask)[0]):
            if idx.size == 0:
                continue
            w = min(int(tlens[idx].max()), tails.shape[1])
            s, c, n = _beam_extend_group(
                graph, start_nodes[idx], tails[idx, :max(w, 1)],
                tlens[idx], cfg, beam, backward, adj_tab, sub_tt)
            for o, i in enumerate(idx):
                scores[i] = s[o]
                chars[i] = c[o]
                nodes[i] = n[o]
        return scores, chars, nodes
    return _beam_extend_group(graph, start_nodes, tails, tlens, cfg,
                              beam, backward, adj_tab, sub_tt)


def _beam_extend_group(graph, start_nodes, tails, tlens, cfg, beam,
                       backward, adj_tab=None, sub_tt=None):
    B, LQ = tails.shape
    dev = graph.device
    true_max = int(tlens.max()) if B else 1
    # the columns follow the longest real tail, not the array width
    LQp = min(_cap_lin(max(true_max, 1), 16, 16), _cap_lin(LQ, 16, 16))
    if LQp < LQ:
        tails = tails[:, :LQp]
    # walk length: the longest tail plus indel slack
    steps = _cap_lin(true_max + max(4, true_max // 4), 16, 16)
    best, best_step, best_beam, parents, chars, nodes_hist = _beam_scan(
        graph,
        torch.from_numpy(np.asarray(start_nodes, np.int32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(tails, np.int32)).to(dev),
        torch.from_numpy(np.asarray(tlens, np.int32)).to(dev),
        steps=steps, beam=beam,
        match=cfg.match_score, tpen=cfg.mm_transition_penalty,
        tvpen=cfg.mm_transversion_penalty,
        open_p=cfg.gap_opening_penalty, ext_p=cfg.gap_extension_penalty,
        xdrop=cfg.xdrop, backward=backward, adj_tab=adj_tab,
        min_cell=(cfg.min_cell_score
                  if getattr(cfg, "min_cell_score", None) is not None
                  else NEG),
        sub_tt=sub_tt, sigma=graph.alphabet.size)
    out_chars, out_nodes = _traceback_scan(parents, chars, nodes_hist,
                                           best_step, best_beam)
    best = best.cpu().numpy()
    best_step = best_step.cpu().numpy()
    out_chars = out_chars.cpu().numpy()
    out_nodes = out_nodes.cpu().numpy()
    char_paths = [out_chars[b, :best_step[b] + 1] for b in range(B)]
    node_paths = [out_nodes[b, :best_step[b] + 1] for b in range(B)]
    return best.astype(np.int64), char_paths, node_paths


def _traceback_scan(parents, chars, nodes_hist, best_step, best_beam):
    """(B, steps) winning char / node paths from the per-step (parent,
    char, node) histories, walked backward from each read's best step."""
    steps, B, W = parents.shape
    bidx = torch.arange(B, device=parents.device)
    cur = best_beam.long()
    cs, ns = [], []
    for t in range(steps - 1, -1, -1):
        active = best_step >= t
        cs.append(torch.where(active, chars[t, bidx, cur], 0))
        ns.append(torch.where(active, nodes_hist[t, bidx, cur], 0))
        cur = torch.where(active, parents[t, bidx, cur].long(), cur)
    if not cs:
        empty = torch.zeros((B, 0), dtype=torch.int32, device=parents.device)
        return empty, empty
    return torch.stack(cs[::-1], dim=1), torch.stack(ns[::-1], dim=1)


# ---------------------------------------------------------------------------
# batched full DP for CIGAR recovery
# ---------------------------------------------------------------------------

def _full_dp(q, r, qlens, rlens, table, open_p, ext_p):
    """(B, LR+1, LQ+1) H / D / I matrices of the affine semi-global DP,
    the same semantics as ``aligner.affine_semiglobal``, batched."""
    B, LQ = q.shape
    LR = r.shape[1]
    dev = q.device
    q = q.to(torch.int32)
    jj = torch.arange(LQ + 1, dtype=torch.int32, device=dev)
    j_valid = jj[None, :] <= qlens[:, None]
    H0 = torch.where(jj == 0, 0, -open_p - (jj - 1) * ext_p)[None, :]
    H0 = torch.where(j_valid, H0, NEG).to(torch.int32)
    I0 = torch.where(jj == 0, NEG, H0).to(torch.int32)
    D0 = torch.full((B, LQ + 1), NEG, dtype=torch.int32, device=dev)
    Hs, Ds, Is = [H0], [D0], [I0]
    H, D = H0, D0
    for t in range(LR):
        c = r[:, t:t + 1].to(torch.int32)
        Hn, Dn, In = _column_update(H, D, q, c, jj, table, open_p, ext_p)
        Hn = torch.where(j_valid, Hn, NEG)
        t_ok = (t < rlens)[:, None]
        H = torch.where(t_ok, Hn, H)
        D = torch.where(t_ok, Dn, D)
        Hs.append(H)
        Ds.append(D)
        Is.append(torch.where(t_ok, In, NEG))
    return (torch.stack(Hs, dim=1), torch.stack(Ds, dim=1),
            torch.stack(Is, dim=1))


def _masked_argmax(H, qlens, rlens):
    """[best, t, j] per pair: the first max in row-major order over the
    cells t <= rlen, j <= qlen (np.argmax's tie rule)."""
    B, LR1, LQ1 = H.shape
    tt = torch.arange(LR1, device=H.device)[None, :, None]
    jjj = torch.arange(LQ1, device=H.device)[None, None, :]
    mask = (tt <= rlens[:, None, None]) & (jjj <= qlens[:, None, None])
    flat = torch.where(mask, H, NEG).reshape(B, -1)
    pos = torch.argmax(flat, dim=1)
    best = torch.gather(flat, 1, pos[:, None])[:, 0]
    return best, pos // LQ1, pos % LQ1


def _full_dp_ends(q, r, qlens, rlens, match, tpen, tvpen, open_p, ext_p,
                  sub_tt=None):
    """(B, 3) [score, r_end, q_end] from the full DP and a masked argmax
    (row-major first max, the same tie rule as np.argmax)."""
    table = pallas_dp.score_table(match, tpen, tvpen, sub_tt, q.device)
    H, _, _ = _full_dp(q, r, qlens, rlens, table, open_p, ext_p)
    best, t, j = _masked_argmax(H, qlens, rlens)
    return torch.stack([best, t, j], dim=1).to(torch.int32)


def _dp_traceback(q, r, qlens, rlens, match, tpen, tvpen, open_p, ext_p,
                  sub_tt=None):
    """Batched traceback: (B, 3) ends + (steps, B) op codes.

    Replays ``aligner.affine_semiglobal``'s host traceback as a per-read
    state machine (phase 0 = main, 1 = D-run, 2 = I-run; op codes 0 none
    / 1 '=' / 2 'X' / 3 'D' / 4 'I'), the same branch order and run
    semantics."""
    table = pallas_dp.score_table(match, tpen, tvpen, sub_tt, q.device)
    H, D, I = _full_dp(q, r, qlens, rlens, table, open_p, ext_p)
    B, LR1, LQ1 = H.shape
    dev = H.device
    best, t, j = _masked_argmax(H, qlens, rlens)
    ends = torch.stack([best, t, j], dim=1).to(torch.int32)
    Hf, Df, If = H.reshape(B, -1), D.reshape(B, -1), I.reshape(B, -1)
    q = q.to(torch.int32)
    r = r.to(torch.int32)

    def cell(Mf, t, j):
        idx = torch.clamp(t, 0, LR1 - 1) * LQ1 + torch.clamp(j, 0, LQ1 - 1)
        return torch.gather(Mf, 1, idx[:, None])[:, 0]

    def at(x, i):
        return torch.gather(x, 1, torch.clamp(i - 1, 0, x.shape[1] - 1)
                            [:, None])[:, 0]

    phase = torch.zeros((B,), dtype=torch.int64, device=dev)
    ops = []
    # every step moves t or j down by one until the walk is done, so
    # rlen + qlen steps finish it (more only append zero op codes)
    for _ in range(int(rlens.max()) + int(qlens.max()) + 2):
        done = (t <= 0) & (j <= 0) & (phase == 0)
        Htj = cell(Hf, t, j)
        Hdg = cell(Hf, t - 1, j - 1)
        Dtj = cell(Df, t, j)
        Dup = cell(Df, t - 1, j)
        Itj = cell(If, t, j)
        Ile = cell(If, t, j - 1)
        qc, rc = at(q, j), at(r, t)
        main = (phase == 0) & ~done
        diag = main & (t > 0) & (j > 0) & (
            Htj == Hdg + _subst(qc, rc, table))
        dment = main & ~diag & (t > 0) & (Htj == Dtj)
        iment = main & ~diag & ~dment & (j > 0)
        i_run = iment & (Htj == Itj)
        deg = main & ~diag & ~dment & ~iment        # t > 0, j == 0
        inD = (phase == 1) | dment
        inI = (phase == 2) | iment
        dcont = inD & (t > 0) & (Dtj == Dup - ext_p)
        icont = ((phase == 2) | i_run) & (j > 0) & (Itj == Ile - ext_p)
        op = torch.where(diag, torch.where(qc == rc, 1, 2),
                         torch.where(inD | deg, 3, torch.where(inI, 4, 0)))
        ops.append(torch.where(done, 0, op).to(torch.int8))
        t2 = torch.where(~done & (diag | inD | deg), t - 1, t)
        j2 = torch.where(~done & (diag | inI), j - 1, j)
        phase2 = torch.where(dcont, 1, torch.where(icont, 2, 0))
        phase = torch.where(done, phase, phase2)
        t, j = t2, j2
    return ends, torch.stack(ops)


def _pair_tensors(q, r, qlens, rlens, device):
    """Host pair arrays as int32 device tensors (at least one column, so
    that a batch of empty sequences still has a width)."""
    dev = resolve(device)
    B = len(q)
    q = np.asarray(q, np.int32).reshape(B, -1)
    r = np.asarray(r, np.int32).reshape(B, -1)
    if q.shape[1] == 0:
        q = np.zeros((B, 1), np.int32)
    if r.shape[1] == 0:
        r = np.zeros((B, 1), np.int32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
    return t(q), t(r), t(qlens), t(rlens)


def batched_ends(q: np.ndarray, r: np.ndarray, qlens: np.ndarray,
                 rlens: np.ndarray, open_p: int, ext_p: int, match: int,
                 tpen: int, tvpen: int, sub_tt=None,
                 device="cuda") -> np.ndarray:
    """(B, 3) [score, r_end, q_end]: the score-only alignment engine,
    ``pallas_dp.batch_align_ends`` on ``device`` (the CUDA kernel, or its
    plain version on the CPU)."""
    B = len(q)
    if B == 0:
        return np.zeros((0, 3), np.int32)
    qt, rt, qlt, rlt = _pair_tensors(q, r, qlens, rlens, device)
    out = pallas_dp.batch_align_ends(qt, rt, qlt, rlt, match=match,
                                     tpen=tpen, tvpen=tvpen, open_p=open_p,
                                     ext_p=ext_p, sub_tt=sub_tt)
    return out.cpu().numpy()


def batched_cigars(q: np.ndarray, r: np.ndarray, qlens: np.ndarray,
                   rlens: np.ndarray, open_p: int, ext_p: int, match: int,
                   tpen: int, tvpen: int, sub_tt=None, device="cuda"
                   ) -> List[Tuple[int, int, int, np.ndarray]]:
    """Batched (score, q_end, r_end, op codes): the whole DP and the
    traceback run on ``device``; only the op codes and ends come back.
    The scores come from the penalties or ``sub_tt``."""
    B = len(q)
    if B == 0:
        return []
    qt, rt, qlt, rlt = _pair_tensors(q, r, qlens, rlens, device)
    ends_d, ops_d = _dp_traceback(qt, rt, qlt, rlt, match, tpen, tvpen,
                                  open_p, ext_p, sub_tt)
    ends = ends_d.cpu().numpy()
    ops_arr = ops_d.cpu().numpy()                     # (steps, B)
    out = []
    for b in range(B):
        col = ops_arr[:, b]
        nz = col[col != 0][::-1]                      # op CODES 1..4
        out.append((int(ends[b, 0]), int(ends[b, 2]), int(ends[b, 1]),
                    nz.astype(np.int8)))
    return out
