"""Batched semi-global affine-gap alignment scoring: the CUDA counterpart
of ``metagraph_tpu/align/pallas_dp.py``.

For R (query, ref) pairs at once, the best cell of the affine-gap DP
(query prefix against ref prefix, free ends), and with
``batch_align_ends`` the cell's ``[r_end, q_end]`` by np.argmax's
row-major first-max rule. The kernel is hand-written CUDA C++ in
``csrc/align_dp.cu`` (it replaces the Pallas ``_score_kernel``); beside
it is its plain PyTorch version, a column sweep over all pairs as
batched tensor ops. The wrappers dispatch on the device of the tensors
they are given: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel (or raises). The kernel has two routes, chosen by
the query width: up to ``WAVE_MAX_ROWS`` query rows (LQ + 1) the lane
wavefront over register-held bands, beyond it the one-warp column sweep
with shared-memory or scratch columns. ``dp_launches`` counts launches,
``dp_long_launches`` those of the long route.

Substitution scores come from a ``(sigma, sigma)`` table: ``sub_tt``
when given (unit or BLOSUM62 scoring), else the DNA table built from
the penalties, equal to the TPU kernel's arithmetic ``_subst`` on codes
0..4 (match on equal nonzero codes, ``-tpen`` for ``|q - c| == 2``,
``-tvpen`` otherwise and for any 0). Codes must lie in ``[0, sigma)``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common import _cuda
from ..common import device as devmod

NEG = -(10 ** 8)
# int32 operations per DP cell that the function needs, for the bound
# of a launch (cells * this): Dn = max(H - open, D - ext) 3, Hn = max(diag
# + sub, Dn) 2, hn + j*ext 1 (shared by the prefix max and the argmax
# key), the prefix max 1, I = run - j*ext - (open - ext) 2, H = max(Hn, I)
# 1, the first-max compare 1. csrc/align_dp.cu performs more: it indexes
# the table and selects on the argmax, and its long route computes
# hn + j*ext and a running max twice.
OPS_PER_CELL = 11
MAX_SIGMA = 32
# query rows (LQ + 1) the wave route takes: 32 lanes x 8 rows
# (kWaveRows in csrc/align_dp.cu)
WAVE_MAX_ROWS = 256

dp_launches = 0
dp_long_launches = 0


def dna_table(match: int, tpen: int, tvpen: int, size: int = 5
              ) -> np.ndarray:
    """(size, size) int32 table equal to the arithmetic DNA ``_subst``
    over codes 0..size-1 (5 for DNA; 6 and 10 for DNA5 and DNACaseSent,
    whose codes past T score by the same formula, as in the JAX
    package)."""
    q, c = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    diff = np.abs(q - c)
    s = np.where(diff == 0, match, np.where(diff == 2, -tpen, -tvpen))
    return np.where((q == 0) | (c == 0), -tvpen, s).astype(np.int32)


def score_table(match: int, tpen: int, tvpen: int, sub_tt=None,
                device="cuda") -> torch.Tensor:
    """The substitution table the kernel and its plain version read, on
    ``device`` (the card unless the caller names another)."""
    tab = (dna_table(match, tpen, tvpen) if sub_tt is None
           else np.asarray(sub_tt, np.int32))
    if tab.ndim != 2 or tab.shape[0] != tab.shape[1] \
            or not 1 <= tab.shape[0] <= MAX_SIGMA:
        raise ValueError(f"substitution table of shape {tab.shape}: square, "
                         f"1 to {MAX_SIGMA} codes")
    return torch.from_numpy(np.ascontiguousarray(tab)).to(
        devmod.resolve(device))


def dp_cells(qlens: torch.Tensor, rlens: torch.Tensor, LQ: int,
             LR: int) -> int:
    """Cells the DP of these pairs needs: sum of rlen * (qlen + 1)."""
    q = torch.clamp(qlens.to(torch.int64), 0, LQ)
    r = torch.clamp(rlens.to(torch.int64), 0, LR)
    return int(torch.sum(r * (q + 1)))


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _first_argmax(H: torch.Tensor, mask: torch.Tensor):
    """(R,) row max over the masked cells and the smallest j attaining it."""
    Hm = torch.where(mask, H, NEG)
    j = torch.argmax(Hm, dim=1)            # the first maximum
    return torch.gather(Hm, 1, j[:, None])[:, 0], j.to(torch.int32)


def align_plain(queries: torch.Tensor, refs: torch.Tensor,
                qlens: torch.Tensor, rlens: torch.Tensor,
                table: torch.Tensor, open_p: int, ext_p: int,
                with_ends: bool) -> torch.Tensor:
    """The column sweep of the kernel over all R pairs as tensor ops:
    ``torch.cummax`` along j is the insertion prefix max; a running best,
    bt and bj replace the (R, LR, LQ) matrix."""
    R, LQ = queries.shape
    LR = refs.shape[1]
    dev = queries.device
    q = queries.to(torch.int64)
    qlens = torch.clamp(qlens.to(torch.int32), 0, LQ)
    rlens = torch.clamp(rlens.to(torch.int32), 0, LR)
    jj = torch.arange(LQ + 1, dtype=torch.int32, device=dev)
    j_valid = jj[None, :] <= qlens[:, None]
    H = torch.where(jj == 0, 0, -open_p - (jj - 1) * ext_p)[None, :]
    H = torch.where(j_valid, H, NEG).to(torch.int32)
    D = torch.full((R, LQ + 1), NEG, dtype=torch.int32, device=dev)
    best, bj = _first_argmax(H, j_valid)
    bt = torch.zeros((R,), dtype=torch.int32, device=dev)
    tab = table.to(torch.int32)
    sigma = tab.shape[0]
    pad = torch.full((R, 1), NEG, dtype=torch.int32, device=dev)
    jext = jj * ext_p
    steps = int(rlens.max()) if R else 0
    for t in range(steps):
        c = refs[:, t].to(torch.int64)
        subs = tab.reshape(-1)[q * sigma + c[:, None]]           # (R, LQ)
        Dn = torch.maximum(H - open_p, D - ext_p)
        diag = H[:, :-1] + subs
        Hn = torch.cat([Dn[:, :1], torch.maximum(diag, Dn[:, 1:])], dim=1)
        run = torch.cummax(Hn + jext, dim=1).values
        I = torch.cat([pad, run[:, :-1]], dim=1) - jext - (open_p - ext_p)
        Hn = torch.where(j_valid, torch.maximum(Hn, I), NEG)
        t_valid = (t < rlens)[:, None]
        H = torch.where(t_valid, Hn, H)
        D = torch.where(t_valid, Dn, D)
        m, j = _first_argmax(Hn, j_valid & t_valid)
        upd = m > best
        best = torch.where(upd, m, best)
        bt = torch.where(upd, t + 1, bt)
        bj = torch.where(upd, j, bj)
    if with_ends:
        return torch.stack([best, bt, bj], dim=1).to(torch.int32)
    return best.to(torch.int32)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _align_cuda(queries, refs, qlens, rlens, table, open_p, ext_p,
                with_ends, wave):
    global dp_launches, dp_long_launches
    dev = queries.device
    R, LQ = queries.shape
    LR = refs.shape[1]
    out = torch.empty((R, 3) if with_ends else (R,), dtype=torch.int32,
                      device=dev)
    if R == 0:
        return out
    lib = _cuda.lib()
    n_scratch = 0 if wave else int(lib.mg_align_dp_scratch_ints(R, LQ))
    scratch = (torch.empty((n_scratch,), dtype=torch.int32, device=dev)
               if n_scratch else None)
    with torch.cuda.device(dev):
        status = lib.mg_align_dp(
            queries.data_ptr(), refs.data_ptr(), qlens.data_ptr(),
            rlens.data_ptr(), R, LQ, LR, table.data_ptr(), table.shape[0],
            open_p, ext_p, int(with_ends), int(wave), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(status, "batch_align")
    dp_launches += 1
    if not wave:
        dp_long_launches += 1
    return out


def _check(queries, refs, qlens, rlens, table):
    dev = queries.device
    for name, x, dim in (("queries", queries, 2), ("refs", refs, 2),
                         ("qlens", qlens, 1), ("rlens", rlens, 1),
                         ("table", table, 2)):
        if x.dtype != torch.int32 or x.dim() != dim or x.device != dev:
            raise TypeError(f"batch_align: {name} must be a {dim}-D int32 "
                            f"tensor on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"batch_align: {name} must be contiguous")
    R = queries.shape[0]
    if refs.shape[0] != R or qlens.shape != (R,) or rlens.shape != (R,):
        raise ValueError("batch_align: queries, refs, qlens and rlens need "
                         "one row per pair")


def _align(queries, refs, qlens, rlens, match, tpen, tvpen, open_p, ext_p,
           sub_tt, with_ends):
    dev = queries.device
    table = score_table(match, tpen, tvpen, sub_tt, dev)
    if dev.type == "cpu":
        return align_plain(queries, refs, qlens, rlens, table, open_p, ext_p,
                           with_ends)
    if dev.type != "cuda":
        raise ValueError(f"batch_align: no kernel for {dev}")
    _check(queries, refs, qlens, rlens, table)
    return _align_cuda(queries, refs, qlens, rlens, table, open_p, ext_p,
                       with_ends, queries.shape[1] + 1 <= WAVE_MAX_ROWS)


def batch_align_scores(queries: torch.Tensor, refs: torch.Tensor,
                       qlens: torch.Tensor, rlens: torch.Tensor,
                       match: int = 2, tpen: int = 3, tvpen: int = 3,
                       open_p: int = 5, ext_p: int = 2,
                       sub_tt=None) -> torch.Tensor:
    """(R,) best semi-global affine scores for R (query, ref) pairs.

    queries (R, LQ) / refs (R, LR): 0-padded int32 codes; qlens / rlens
    the true lengths. On a CUDA tensor the kernel takes int32 contiguous
    tensors and raises on anything else."""
    return _align(queries, refs, qlens, rlens, match, tpen, tvpen, open_p,
                  ext_p, sub_tt, with_ends=False)


def batch_align_ends(queries: torch.Tensor, refs: torch.Tensor,
                     qlens: torch.Tensor, rlens: torch.Tensor,
                     match: int = 2, tpen: int = 3, tvpen: int = 3,
                     open_p: int = 5, ext_p: int = 2,
                     sub_tt=None) -> torch.Tensor:
    """(R, 3) int32 ``[best score, r_end, q_end]`` per pair, the ends by
    np.argmax's row-major first-max rule over the full H matrix (the
    score-only alignment engine)."""
    return _align(queries, refs, qlens, rlens, match, tpen, tvpen, open_p,
                  ext_p, sub_tt, with_ends=True)


def batch_align_scores_reference(queries, refs, qlens, rlens, match=2,
                                 tpen=3, tvpen=3, open_p=5,
                                 ext_p=2) -> np.ndarray:
    """Pure-numpy gold (Gotoh over the final H, per pair) for testing."""
    from .aligner import AlignerConfig, affine_semiglobal
    cfg = AlignerConfig(match_score=match, mm_transition_penalty=tpen,
                        mm_transversion_penalty=tvpen,
                        gap_opening_penalty=open_p,
                        gap_extension_penalty=ext_p)
    sub = cfg.score_matrix()
    out = []
    for i in range(len(queries)):
        q = np.asarray(queries[i][:qlens[i]], np.int32)
        r = np.asarray(refs[i][:rlens[i]], np.int32)
        score, _, _, _ = affine_semiglobal(q, r, sub, open_p, ext_p)
        out.append(score)
    return np.array(out)
