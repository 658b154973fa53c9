"""Sequence-to-graph alignment: seed and extend.

PyTorch counterpart of ``metagraph_tpu/align/aligner.py``, for graphs
of every alphabet (Protein scores by BLOSUM62) in either state. Seeding
maps every read's k-windows with one ``map_codes_to_nodes`` over the
reads joined by separators; reads with no full-k seed take suffix seeds
(nodes whose k-mer suffix equals the longest possible read prefix),
found for all such reads at once, one batched search per suffix length.
Extension is the lockstep beam DP of ``align/batch_extender.py`` on the
graph's device; CIGARs come from the batched full DP and traceback, and
the score-only path (``with_cigar=False``) takes its ends from the
``pallas_dp`` kernel.
A primary graph aligns through ``CanonicalDbg`` (virtual node ids, so a
read's reverse complement aligns as a forward read); suffix seeds there
fail as in the JAX package (``SuffixSeedsOnPrimaryGraph``). A
small-state graph seeds and walks by rank/select alone: its suffix
ranges come from ``Boss.suffix_range_ranksel`` and its neighbours are
looked up as the beam needs them.

The scoring tables, ``affine_semiglobal``, ``_compress_ops_codes`` and
``GraphAlignment`` are pure numpy, copied from the JAX package (the port
does not import it).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import packed as pk
from . import pallas_dp

NEG = -(10 ** 9)

# BLOSUM62 substitution scores (standard public matrix; the reference
# embeds the same table, aligner_config.cpp:174-219). Row/col order:
_BLOSUM62_ORDER = "ARNDCQEGHILKMFPSTWYVBZX"
_BLOSUM62 = """
 4 -1 -2 -2  0 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -3 -2  0 -2 -1  0
-1  5  0 -2 -3  1  0 -2  0 -3 -2  2 -1 -3 -2 -1 -1 -3 -2 -3 -1  0 -1
-2  0  6  1 -3  0  0  0  1 -3 -3  0 -2 -3 -2  1  0 -4 -2 -3  3  0 -1
-2 -2  1  6 -3  0  2 -1 -1 -3 -4 -1 -3 -3 -1  0 -1 -4 -3 -3  4  1 -1
 0 -3 -3 -3  9 -3 -4 -3 -3 -1 -1 -3 -1 -2 -3 -1 -1 -2 -2 -1 -3 -3 -2
-1  1  0  0 -3  5  2 -2  0 -3 -2  1  0 -3 -1  0 -1 -2 -1 -2  0  3 -1
-1  0  0  2 -4  2  5 -2  0 -3 -3  1 -2 -3 -1  0 -1 -3 -2 -2  1  4 -1
 0 -2  0 -1 -3 -2 -2  6 -2 -4 -4 -2 -3 -3 -2  0 -2 -2 -3 -3 -1 -2 -1
-2  0  1 -1 -3  0  0 -2  8 -3 -3 -1 -2 -1 -2 -1 -2 -2  2 -3  0  0 -1
-1 -3 -3 -3 -1 -3 -3 -4 -3  4  2 -3  1  0 -3 -2 -1 -3 -1  3 -3 -3 -1
-1 -2 -3 -4 -1 -2 -3 -4 -3  2  4 -2  2  0 -3 -2 -1 -2 -1  1 -4 -3 -1
-1  2  0 -1 -3  1  1 -2 -1 -3 -2  5 -1 -3 -1  0 -1 -3 -2 -2  0  1 -1
-1 -1 -2 -3 -1  0 -2 -3 -2  1  2 -1  5  0 -2 -1 -1 -1 -1  1 -3 -1 -1
-2 -3 -3 -3 -2 -3 -3 -3 -1  0  0 -3  0  6 -4 -2 -2  1  3 -1 -3 -3 -1
-1 -2 -2 -1 -3 -1 -1 -2 -2 -3 -3 -1 -2 -4  7 -1 -1 -4 -3 -2 -2 -1 -2
 1 -1  1  0 -1  0  0  0 -1 -2 -2  0 -1 -2 -1  4  1 -3 -2 -2  0  0  0
 0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  1  5 -2 -2  0 -1 -1  0
-3 -3 -4 -4 -2 -2 -3 -2 -2 -3 -2 -3 -1  1 -4 -3 -2 11  2 -3 -4 -3 -2
-2 -2 -2 -3 -2 -1 -2 -3  2 -1 -1 -2 -1  3 -3 -2 -2  2  7 -1 -3 -2 -1
 0 -3 -3 -3 -1 -2 -2 -3 -3  3  1 -2  1 -1 -2 -2  0 -3 -1  4 -3 -2 -1
-2 -1  3  4 -3  0  1 -1  0 -3 -4  0 -3 -3 -2  0 -1 -4 -3 -3  4  1 -1
-1  0  0  1 -3  3  4 -2  0 -3 -3  1 -1 -3 -1  0 -1 -3 -2 -2  1  4 -1
 0 -1 -1 -1 -2 -1 -1 -1 -1 -1 -1 -1 -1 -1 -2  0  0 -2 -1 -1 -1 -1 -1
"""


def blosum62_matrix(alphabet) -> np.ndarray:
    """(size, size) BLOSUM62 scores over an alphabet's code space
    (reference DBGAlignerConfig::score_matrix_blosum62). Letters outside
    the 23-symbol BLOSUM set (J, O, U and the sentinel) score -4 against
    everything and +1 against themselves, the reference's fill rule."""
    vals = np.array(_BLOSUM62.split(), np.int32).reshape(23, 23)
    pos = {ch: i for i, ch in enumerate(_BLOSUM62_ORDER)}
    size = alphabet.size
    s = np.full((size, size), -4, np.int32)
    np.fill_diagonal(s, 1)
    for a, ca in enumerate(alphabet.letters):
        for b, cb in enumerate(alphabet.letters):
            ia, ib = pos.get(ca.upper()), pos.get(cb.upper())
            if ia is not None and ib is not None:
                s[a, b] = vals[ia, ib]
    s[0, :] = -4
    s[:, 0] = -4
    return s


def unit_matrix(alphabet, match_score: int = 1) -> np.ndarray:
    """Edit-distance scoring: +match on identical real letters, -match
    otherwise (reference unit_scoring_matrix)."""
    size = alphabet.size
    s = np.full((size, size), -match_score, np.int32)
    for c in range(1, size):
        s[c, c] = match_score
    return s


@dataclass
class AlignerConfig:
    match_score: int = 2
    mm_transition_penalty: int = 3
    mm_transversion_penalty: int = 3
    gap_opening_penalty: int = 5      # positive penalties, subtracted
    gap_extension_penalty: int = 2
    xdrop: int = 27
    min_seed_length: int = 0
    max_seed_length: int = 0           # 0 = unbounded
    min_exact_match: float = 0.7
    min_cell_score: Optional[int] = None  # prune beam entries below this
    max_ram_mb: Optional[float] = None    # extension sub-batch cap
    beam_width: int = 4                # beam entries per read
    max_seeds_per_read: int = 4        # anchors extended per read/strand
    max_seeds_per_locus: int = 16      # suffix-seed candidates per locus
    # "auto" = DNA matrix for DNA alphabets / BLOSUM62 for Protein;
    # "unit" = edit distance (--align-edit-distance)
    score_matrix_type: str = "auto"

    def score_matrix(self, alphabet=None) -> np.ndarray:
        """(size, size) substitution scores over alphabet codes. DNA
        default: transition/transversion matrix; Protein: BLOSUM62;
        "unit": edit distance. With no alphabet, the (5, 5) DNA matrix."""
        kind = self.score_matrix_type
        if kind == "auto":
            kind = ("blosum62" if alphabet is not None
                    and alphabet.name == "Protein" else "dna")
        if kind == "unit":
            from ..kmer.alphabets import DNA
            return unit_matrix(alphabet or DNA, 1)
        if kind == "blosum62":
            if alphabet is None:
                from ..kmer.alphabets import PROTEIN
                alphabet = PROTEIN
            return blosum62_matrix(alphabet)
        size = alphabet.size if alphabet is not None else 5
        s = np.full((size, size), -self.mm_transversion_penalty, np.int32)
        for a, b in [(1, 3), (3, 1), (2, 4), (4, 2)]:  # A<->G, C<->T
            if a < size and b < size:
                s[a, b] = -self.mm_transition_penalty
        for c in range(1, min(5, size)):
            s[c, c] = self.match_score
        s[0, :] = -self.mm_transversion_penalty
        s[:, 0] = -self.mm_transversion_penalty
        return s

    def uses_table_scoring(self, alphabet) -> bool:
        """True when the DP reads the matrix instead of the arithmetic
        DNA transition/transversion formula."""
        kind = self.score_matrix_type
        if kind == "auto":
            kind = "blosum62" if alphabet.name == "Protein" else "dna"
        return kind != "dna"


@dataclass
class GraphAlignment:
    score: int
    cigar: str
    query_begin: int
    query_end: int                     # exclusive
    sequence: bytes                    # matched path spelling
    nodes: List[int]
    orientation: bool = False          # True = reverse complement

    @property
    def num_matches(self) -> int:
        """Number of '=' positions in the cigar."""
        return sum(int(n) for n, op in re.findall(r"(\d+)([=XIDS])",
                                                  self.cigar) if op == "=")

    def to_json(self, name: str = "") -> dict:
        return {
            "name": name,
            "score": int(self.score),
            "cigar": self.cigar,
            "query_begin": self.query_begin,
            "query_end": self.query_end,
            "sequence": self.sequence.decode(),
            "orientation": "-" if self.orientation else "+",
        }


_OP_CHARS = np.array(["", "=", "X", "D", "I"])
_EQ = np.int8(1)


def _compress_ops_codes(a: np.ndarray) -> str:
    """RLE cigar from an int op-code array (1 = '=', 2 = 'X', 3 = 'D',
    4 = 'I')."""
    if len(a) == 0:
        return ""
    b = np.nonzero(np.diff(a))[0]
    starts = np.concatenate([[0], b + 1])
    lens = np.diff(np.concatenate([starts, [len(a)]]))
    return "".join(f"{l}{_OP_CHARS[a[s]]}" for s, l in zip(starts, lens))


def affine_semiglobal(query: np.ndarray, ref: np.ndarray, sub: np.ndarray,
                      open_p: int, ext_p: int
                      ) -> Tuple[int, int, int, List[str]]:
    """Affine-gap DP: query prefix vs ref prefix, free ends (best cell
    anywhere). Returns (score, q_end, r_end, ops)."""
    Lq, Lr = len(query), len(ref)
    H = np.full((Lr + 1, Lq + 1), NEG, np.int64)
    I = np.full_like(H, NEG)   # gap in ref (consumes query)
    D = np.full_like(H, NEG)   # gap in query (consumes ref)
    H[0, 0] = 0
    for j in range(1, Lq + 1):
        I[0, j] = -open_p - (j - 1) * ext_p
        H[0, j] = I[0, j]
    for t in range(1, Lr + 1):
        D[t, 0] = max(H[t - 1, 0] - open_p, D[t - 1, 0] - ext_p)
        H[t, 0] = D[t, 0]
        subs = sub[query, ref[t - 1]]
        for j in range(1, Lq + 1):
            D[t, j] = max(H[t - 1, j] - open_p, D[t - 1, j] - ext_p)
            I[t, j] = max(H[t, j - 1] - open_p, I[t, j - 1] - ext_p)
            H[t, j] = max(H[t - 1, j - 1] + subs[j - 1], D[t, j], I[t, j])
    t, j = np.unravel_index(np.argmax(H), H.shape)
    best = int(H[t, j])
    ops: List[str] = []
    while t > 0 or j > 0:
        if t > 0 and j > 0 and H[t, j] == H[t - 1, j - 1] \
                + sub[query[j - 1], ref[t - 1]]:
            ops.append("=" if query[j - 1] == ref[t - 1] else "X")
            t -= 1
            j -= 1
        elif t > 0 and H[t, j] == D[t, j]:
            while t > 0 and D[t, j] == D[t - 1, j] - ext_p:
                ops.append("D")
                t -= 1
            ops.append("D")
            t -= 1
        elif j > 0:
            if H[t, j] == I[t, j]:
                while j > 0 and I[t, j] == I[t, j - 1] - ext_p:
                    ops.append("I")
                    j -= 1
            ops.append("I")
            j -= 1
        else:
            ops.append("D")
            t -= 1
    r_end, q_end = np.unravel_index(np.argmax(H), H.shape)
    return best, int(q_end), int(r_end), ops[::-1]


class SuffixSeedsOnPrimaryGraph(NotImplementedError):
    """A read needs suffix seeds on a primary graph (``CanonicalDbg``),
    where the reference aligner fails; the port fails with it."""


class Aligner:
    """Seed and extend against a DbgSuccinct, or a primary graph wrapped
    in ``CanonicalDbg`` (reference DBGAligner), on the graph's device.
    On a primary graph the reads with a full-k seed align as in the JAX
    package; a read that needs suffix seeds raises
    ``SuffixSeedsOnPrimaryGraph``."""

    def __init__(self, graph, config: Optional[AlignerConfig] = None):
        self.graph = graph
        self.config = config or AlignerConfig()
        self.sub = self.config.score_matrix(graph.alphabet)
        # non-DNA scoring (BLOSUM62 / unit): the DP reads the matrix; DNA5
        # and DNACaseSent score by the arithmetic DNA formula over all
        # their codes, as a table of their size
        cfg = self.config
        if cfg.uses_table_scoring(graph.alphabet):
            tab = self.sub
        elif graph.alphabet.size != 5:
            tab = pallas_dp.dna_table(cfg.match_score,
                                      cfg.mm_transition_penalty,
                                      cfg.mm_transversion_penalty,
                                      graph.alphabet.size)
        else:
            tab = None
        self._sub_tt = (None if tab is None else
                        tuple(tuple(int(v) for v in row) for row in tab))
        self.max_seeds_per_read = self.config.max_seeds_per_read
        # per-code exact-match scores (BLOSUM62's diagonal varies by
        # letter; for DNA this is match_score everywhere)
        self._diag = np.diagonal(self.sub).astype(np.int64)
        self._tbl = graph.alphabet.encode_table()
        self._adj = {}          # lazy per-direction adjacency tables

    @property
    def device(self) -> torch.device:
        return self.graph.device

    def _adjacency_table(self, backward: bool):
        """(N+1, sigma-1) int32 node table for one walk direction, built
        lazily in node-range chunks: each beam step then costs one gather
        instead of sigma-1 edge searches. On a card it is kept only while
        it fits in a quarter of the free device memory (the scan then
        looks neighbours up on the fly); the CPU keeps it always. A
        small-state graph keeps none: its table would cost a
        rank/select navigation (k - 2 bwd steps backward) for every node,
        far more than the beam's own lookups."""
        if backward not in self._adj:
            g = self.graph
            N = int(g.num_nodes())
            sig1 = g.alphabet.size - 1
            nbytes = (N + 1) * sig1 * 4
            boss = getattr(g, "base", g).boss   # primary: the base graph's
            if boss.edge_lanes is None or self.device.type == "cuda" and \
                    nbytes > torch.cuda.mem_get_info(self.device)[0] // 4:
                self._adj[backward] = None
            else:
                fn = g.predecessors if backward else g.successors
                chunk = 1 << 22
                tab = torch.empty((N + 1, sig1), dtype=torch.int32,
                                  device=self.device)
                for lo in range(0, N + 1, chunk):
                    n = min(chunk, N + 1 - lo)
                    tab[lo:lo + n] = fn(torch.arange(
                        lo, lo + n, dtype=torch.int64, device=self.device))
                self._adj[backward] = tab
        return self._adj[backward]

    # -- seeding -----------------------------------------------------------

    def _exact_runs(self, nodes: np.ndarray) -> List[Tuple[int, int]]:
        """Maximal runs [start, end) of consecutive present windows."""
        present = np.asarray(nodes) > 0
        if not present.size:
            return []
        d = np.diff(present.astype(np.int8))
        starts = np.nonzero(d == 1)[0] + 1
        ends = np.nonzero(d == -1)[0] + 1
        if present[0]:
            starts = np.concatenate([[0], starts])
        if present[-1]:
            ends = np.concatenate([ends, [present.size]])
        return list(zip(starts.tolist(), ends.tolist()))

    def _suffix_seeds(self, codes: np.ndarray, max_seeds: int = 0
                      ) -> Tuple[List[int], int]:
        """Seeds shorter than k for one read (reference SuffixSeeder)."""
        return self._suffix_seeds_batch([codes], max_seeds)[0]

    def _suffix_seeds_batch(self, codes_l: Sequence[np.ndarray],
                            max_seeds: int = 0
                            ) -> List[Tuple[List[int], int]]:
        """Suffix seeds of many reads: nodes whose k-mer suffix equals the
        longest possible read prefix. Node suffixes are contiguous ranges
        of the BOSS order (the suffix chars are the most significant
        fields), so each suffix length is one batched binary search over
        every read still unresolved, longest first. Per read the same as
        searching its lengths one by one."""
        if not max_seeds:
            max_seeds = self.config.max_seeds_per_locus
        g = self.graph
        if not codes_l:
            return []
        if not hasattr(g, "boss"):
            raise SuffixSeedsOnPrimaryGraph(
                "a read without a full k-mer seed needs suffix seeds, which "
                "the reference aligner does not search on primary graphs "
                "(metagraph_tpu/align/aligner.py:337, _suffix_seeds, reads "
                "graph.boss, which CanonicalDbg lacks: AttributeError)")
        K = g.k
        B = g.alphabet.bits_per_char
        lanes_all = g.boss.edge_lanes
        dev = self.device
        min_len = max(self.config.min_seed_length or 1, 1)
        out: List[Tuple[List[int], int]] = [([], 0)] * len(codes_l)
        todo = set(range(len(codes_l)))
        width = 4 * max_seeds
        for s in range(K - 1, min_len - 1, -1):
            rows = [i for i in sorted(todo) if len(codes_l[i]) >= s
                    and not (codes_l[i][:s] == 0).any()]
            if not rows:
                continue
            pat = torch.from_numpy(np.stack(
                [codes_l[i][:s] for i in rows]).astype(np.int32)).to(dev)
            if lanes_all is None:
                # small state: rank/select range tightening (the
                # reference's partial index_range)
                ok, lo_i, hi_i = g.boss.suffix_range_ranksel(pat)
                hi_i = torch.where(ok, hi_i, lo_i - 1)
            else:
                lo_i, hi_i = _suffix_range_lanes(lanes_all, pat, K, B)
            cand = lo_i[:, None] + torch.arange(width, device=dev)
            ok = cand <= torch.minimum(hi_i, lo_i + width - 1)[:, None]
            nodes = torch.where(ok, g.edge_to_node(cand), 0).cpu().numpy()
            for q, i in enumerate(rows):
                found = nodes[q][nodes[q] > 0][:max_seeds]
                if len(found):
                    out[i] = ([int(x) for x in found], s)
                    todo.discard(i)
        return out

    # -- top level ---------------------------------------------------------

    def align(self, sequence: bytes, num_alternative_paths: int = 1,
              both_strands: bool = False) -> List[GraphAlignment]:
        """One read: a batch of one. Forward only by default; the reverse
        complement only under ``both_strands``."""
        return self.align_batch(
            [sequence], both_strands=both_strands,
            num_alternative_paths=num_alternative_paths)[0]

    def align_batch(self, seqs: Sequence[bytes],
                    both_strands: bool = False,
                    num_alternative_paths: int = 1,
                    with_cigar: bool = True,
                    min_exact_match: Optional[float] = None
                    ) -> List[List[GraphAlignment]]:
        """Batched alignment (reference DBGAligner::align_batch): seeding,
        beam extension and the CIGAR DP run batched on the graph's device.

        ``with_cigar=False`` is the score-only path (query --align): ends
        come from the ``pallas_dp`` kernel; the min_exact_match filter
        uses the lower bound score / match_score <= num_matches, so it
        keeps a subset of the CIGAR path's results. ``min_exact_match``
        overrides the config's for this call only (a server's request)."""
        if min_exact_match is None:
            min_exact_match = self.config.min_exact_match
        orientations = [(False, list(seqs))]
        if both_strands:
            orientations.append((True, [_revcomp(s) for s in seqs]))
        per_read: List[List[GraphAlignment]] = [[] for _ in seqs]
        for orientation, oseqs in orientations:
            results = self._align_batch_oriented(oseqs, orientation,
                                                 with_cigar=with_cigar)
            for i, r in enumerate(results):
                per_read[i].extend(r)
        out = []
        match = max(self.config.match_score, 1)
        for i, rs in enumerate(per_read):
            n = max(len(seqs[i]), 1)
            if with_cigar:
                rs = [a for a in rs if a.num_matches >= min_exact_match * n]
            else:
                rs = [a for a in rs
                      if a.score / match >= min_exact_match * n]
            rs.sort(key=lambda a: -a.score)
            # alternative seeds can converge on the same alignment: dedupe
            seen, uniq = set(), []
            for a in rs:
                key = (a.query_begin, a.query_end, a.cigar, a.orientation,
                       tuple(a.nodes))
                if key not in seen:
                    seen.add(key)
                    uniq.append(a)
            out.append(uniq[:num_alternative_paths])
        return out

    def _dp_ends(self, q, r, ql, rl, with_cigar: bool):
        """Per pair (score, q_end, r_end, op codes or None)."""
        from .batch_extender import batched_cigars, batched_ends
        cfg = self.config
        dp_args = (cfg.gap_opening_penalty, cfg.gap_extension_penalty,
                   cfg.match_score, cfg.mm_transition_penalty,
                   cfg.mm_transversion_penalty)
        if with_cigar:
            return batched_cigars(q, r, ql, rl, *dp_args,
                                  sub_tt=self._sub_tt, device=self.device)
        e = batched_ends(q, r, ql, rl, *dp_args, sub_tt=self._sub_tt,
                         device=self.device)
        return [(int(s), int(j), int(t), None) for s, t, j in e]

    def _extend(self, starts, tails, lens, backward: bool):
        from .batch_extender import beam_extend_batch
        return beam_extend_batch(
            self.graph, starts, tails, lens, self.config,
            beam=self.config.beam_width, backward=backward,
            adj_tab=self._adjacency_table(backward), sub_tt=self._sub_tt)

    def _align_batch_oriented(self, seqs, orientation,
                              with_cigar: bool = True):
        g = self.graph
        k = g.k
        B = len(seqs)
        results: List[List[GraphAlignment]] = [[] for _ in range(B)]
        # 1) batched seeding: one device call maps every read's windows
        codes_l, runs_l = [], []
        for s in seqs:
            codes = self._tbl[np.frombuffer(s, np.uint8)].astype(np.int32)
            codes_l.append(np.where(codes == 255, 0, codes))
        nodes_l = _map_batch_nodes(g, seqs)
        seeded = []
        for i, s in enumerate(seqs):
            if len(s) < k:
                runs_l.append([])
                continue
            nodes = nodes_l[i]
            runs = self._exact_runs(nodes)
            runs_l.append(runs)
            if runs:
                # extend every seed, ranked by run length, up to
                # max_seeds_per_read anchors
                runs.sort(key=lambda r: (r[1] - r[0]), reverse=True)
                for run in runs[:self.max_seeds_per_read]:
                    seeded.append((i, nodes, run))
        # reads without full-k seeds: suffix-seeded, every candidate one
        # row of one forward extension batch
        fb_reads = [i for i, s in enumerate(seqs)
                    if not (len(s) >= k and runs_l[i])]
        fb_entries = []
        seeds = self._suffix_seeds_batch([codes_l[i] for i in fb_reads])
        for i, (cand, s_len) in zip(fb_reads, seeds):
            for node in cand:
                fb_entries.append((i, node, s_len))
        if fb_entries:
            self._extend_suffix_seeded(seqs, codes_l, fb_entries,
                                       orientation, results, with_cigar)
        if not seeded:
            return results
        # 2) batched forward + backward beam extension
        Lmax = max(len(seqs[i]) for i, _, _ in seeded)
        nb = len(seeded)
        fwd_tails = np.zeros((nb, Lmax), np.int32)
        fwd_lens = np.zeros(nb, np.int32)
        fwd_start = np.zeros(nb, np.int32)
        bwd_tails = np.zeros((nb, Lmax), np.int32)
        bwd_lens = np.zeros(nb, np.int32)
        bwd_start = np.zeros(nb, np.int32)
        seed_info = []
        for bi, (i, nodes, (rs, re_)) in enumerate(seeded):
            if self.config.max_seed_length:
                # reference --align-max-seed-length: clamp the anchor
                re_ = min(re_, rs + max(self.config.max_seed_length
                                        - (k - 1), 1))
            seed_len = (re_ - rs) + k - 1
            qb, qe = rs, rs + seed_len
            fwd = codes_l[i][qe:]
            bwd = codes_l[i][:qb][::-1]
            fwd_tails[bi, :len(fwd)] = fwd
            fwd_lens[bi] = len(fwd)
            fwd_start[bi] = nodes[re_ - 1]
            bwd_tails[bi, :len(bwd)] = bwd
            bwd_lens[bi] = len(bwd)
            bwd_start[bi] = nodes[rs]
            seed_info.append((i, nodes, rs, re_, seed_len, qb, qe))
        f_scores, f_chars, f_nodes = self._extend(fwd_start, fwd_tails,
                                                  fwd_lens, backward=False)
        b_scores, b_chars, b_nodes = self._extend(bwd_start, bwd_tails,
                                                  bwd_lens, backward=True)
        # 3) batched CIGARs (or score-only ends) over the winning paths
        fr, frl = _pack_paths(f_chars)
        br, brl = _pack_paths(b_chars)
        f_cig = self._dp_ends(fwd_tails, fr, fwd_lens, frl, with_cigar)
        b_cig = self._dp_ends(bwd_tails, br, bwd_lens, brl, with_cigar)
        finals = []
        for bi, (i, nodes, rs, re_, seed_len, qb, qe) in enumerate(seed_info):
            seq = seqs[i]
            score = int(self._diag[codes_l[i][qb:qe]].sum())
            ops = [np.full(seed_len, _EQ, np.int8)]
            parts = [np.asarray(nodes[rs:re_], np.int64)]
            if fwd_lens[bi] and f_scores[bi] > 0:
                s2, q_end, r_end, dops = f_cig[bi]
                score += s2
                parts.append(np.asarray(f_nodes[bi][:r_end], np.int64))
                if dops is not None:
                    ops.append(dops)
                qe += q_end
            if bwd_lens[bi] and b_scores[bi] > 0:
                s2, q_end, r_end, dops = b_cig[bi]
                score += s2
                parts.insert(0, np.asarray(b_nodes[bi][:r_end],
                                           np.int64)[::-1])
                if dops is not None:
                    ops.insert(0, dops[::-1])
                qb -= q_end
            path = np.concatenate(parts) if len(parts) > 1 else parts[0]
            if with_cigar:
                cig = _compress_ops_codes(np.concatenate(ops))
            else:
                # aligned-span placeholder (the score-only path's
                # consumers read .sequence / .score, never the cigar)
                cig = f"{qe - qb}M"
            if qb > 0:
                cig = f"{qb}S" + cig
            if qe < len(seq):
                cig = cig + f"{len(seq) - qe}S"
            finals.append((i, score, cig, qb, qe, path))
        # 4) one device call spells every winning path
        spells = self._spell_batch([f[5] for f in finals])
        for (i, score, cig, qb, qe, path), spelled in zip(finals, spells):
            results[i].append(GraphAlignment(
                score=int(score), cigar=cig, query_begin=qb, query_end=qe,
                sequence=spelled, nodes=path, orientation=orientation))
        return results

    def _extend_suffix_seeded(self, seqs, codes_l, entries, orientation,
                              results, with_cigar: bool):
        """Forward extension of suffix-seeded reads: every (read,
        candidate node) pair is one batch row; the best-scoring candidate
        per read is kept."""
        nb = len(entries)
        Lmax = max(len(seqs[i]) for i, _, _ in entries)
        tails = np.zeros((nb, Lmax), np.int32)
        lens = np.zeros(nb, np.int32)
        starts = np.zeros(nb, np.int32)
        for bi, (i, node, s_len) in enumerate(entries):
            fwd = codes_l[i][s_len:]
            tails[bi, :len(fwd)] = fwd
            lens[bi] = len(fwd)
            starts[bi] = node
        scores, chars_l, nodes_l = self._extend(starts, tails, lens,
                                                backward=False)
        r, rl = _pack_paths(chars_l)
        cig = self._dp_ends(tails, r, lens, rl, with_cigar)
        finals = []
        for bi, (i, node, s_len) in enumerate(entries):
            seq = seqs[i]
            score = int(self._diag[codes_l[i][:s_len]].sum())
            ops = [np.full(s_len, _EQ, np.int8)]
            path = np.asarray([node], np.int64)
            qe = s_len
            if lens[bi] and scores[bi] > 0:
                s2, q_end, r_end, dops = cig[bi]
                score += s2
                path = np.concatenate([path,
                                       np.asarray(nodes_l[bi][:r_end],
                                                  np.int64)])
                if dops is not None:
                    ops.append(dops)
                qe += q_end
            cs = (_compress_ops_codes(np.concatenate(ops))
                  if with_cigar else f"{qe}M")
            if qe < len(seq):
                cs = cs + f"{len(seq) - qe}S"
            finals.append((i, score, cs, qe, path, s_len))
        spells = self._spell_batch([f[4] for f in finals])
        best_per_read = {}
        for (i, score, cs, qe, path, s_len), spelled in zip(finals, spells):
            a = GraphAlignment(
                score=int(score), cigar=cs, query_begin=0, query_end=qe,
                sequence=spelled[-(s_len + len(path) - 1):], nodes=path,
                orientation=orientation)
            cur = best_per_read.get(i)
            if cur is None or a.score > cur.score:
                best_per_read[i] = a
        for i, a in best_per_read.items():
            results[i].append(a)

    def _spell_batch(self, paths: Sequence[np.ndarray]) -> List[bytes]:
        """Spell many paths with one ``node_kmers_chars`` call: all path
        nodes decoded at once, sliced back per path."""
        g = self.graph
        flat = np.concatenate(
            [np.asarray(p, np.int64) for p in paths if len(p)]
            or [np.zeros(0, np.int64)])
        if len(flat) == 0:
            return [b"" for _ in paths]
        chars = g.node_kmers_chars(flat)
        letters = np.frombuffer(g.alphabet.letters.encode(), np.uint8)
        out, off = [], 0
        for p in paths:
            if not len(p):
                out.append(b"")
                continue
            c = chars[off:off + len(p)]
            off += len(p)
            out.append(bytes(letters[c[0]]) + bytes(letters[c[1:, -1]]))
        return out


def _suffix_range_lanes(lanes_all: torch.Tensor, pat: torch.Tensor, K: int,
                        B: int):
    """The inclusive 1-based rows [lo, hi] of the edges whose source node
    ends in each (Q, s) pattern: two batched binary searches over the
    sorted edge k-mers."""
    Q, s = pat.shape
    L = lanes_all.shape[0]
    dev = lanes_all.device
    lo = pk.zeros(Q, L, dev)
    # pattern char j sits at field K-s+j (suffix of the node)
    for j in range(s):
        lo = pk.set_field(lo, K - s + j, pat[:, j], B)
    # exclusive upper bound: +1 at the least significant constrained
    # field (carry-free: field values <= alph size)
    unit = pk.set_field(pk.zeros(Q, L, dev), K - s,
                        torch.ones((Q,), dtype=torch.int32, device=dev), B)
    return (pk.searchsorted(lanes_all, lo, side="left") + 1,
            pk.searchsorted(lanes_all, lo + unit, side="left"))


def _pack_paths(chars: Sequence[np.ndarray]):
    """(nb, LR) 0-padded ref codes of the winning paths and their lengths."""
    nb = len(chars)
    LR = max([len(c) for c in chars] + [1])
    r = np.zeros((nb, LR), np.int32)
    rl = np.zeros(nb, np.int32)
    for bi, c in enumerate(chars):
        r[bi, :len(c)] = c
        rl[bi] = len(c)
    return r, rl


def _map_batch_nodes(g, seqs: Sequence[bytes]) -> List[np.ndarray]:
    """Every read's k-window node ids from one ``map_codes_to_nodes``
    over the reads joined by INVALID separators (a window across a
    boundary is invalid), sliced back per read. Equal to per-read
    ``g.map_to_nodes(s)``."""
    from ..kmer.extractor import encode_sequences
    k = g.k
    codes = encode_sequences(seqs, g.alphabet)       # trailing sep per read
    if len(codes) < k:
        return [np.zeros(max(0, len(s) - k + 1), np.int32) for s in seqs]
    out = g.map_codes_to_nodes(
        torch.from_numpy(codes).to(g.device)).cpu().numpy().astype(np.int32)
    nodes_l, off = [], 0
    for s in seqs:
        ln = len(s)
        nodes_l.append(out[off:off + max(0, ln - k + 1)]
                       if ln >= k else np.zeros(0, np.int32))
        off += ln + 1                                # +1 for the separator
    return nodes_l


_COMP = bytes.maketrans(b"ACGTacgt", b"TGCAtgca")


def _revcomp(seq: bytes) -> bytes:
    return seq.translate(_COMP)[::-1]
