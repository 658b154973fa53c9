"""Out-of-core staged RowDiff conversion.

Counterpart of ``metagraph_tpu/anno/row_diff_disk.py``. The reference
converts column annotations to RowDiff in disk-backed stages, so that
annotations larger than memory can be transformed
(row_diff_builder.cpp:322-688). Here:

  Stage 0  read only the ``labels`` member of every input file: the
           merged label dictionary.
  Stage 2a stream the files one at a time, spilling their entries as
           sorted ``col * num_rows + row`` int64 runs (``_RunSpiller``)
           and counting labels per row.
  Stage 1  successors and anchors on the graph's device
           (``row_diff.assign_successors_and_anchors``, forks routed to
           the successor with the most labels) and the inverted
           successor index (one stable sort).
  Stage 2b merge the raw runs block by block into one column-major
           stream (``_merge_runs``, memmaps), then walk it column by
           column: each column's rows go to the device, where its diff
           rows are found by sorted-set searches (anchors keep their
           bits, other rows store row XOR successor); a first walk
           counts the per-row reduction, rows whose diff grows become
           anchors, a second walk spills the diffs as sorted
           ``row * num_cols + col`` runs.
  Stage 3  the diff runs merged the same way, decoded into the RowDiff.

Host memory is bounded by one input file, ``mem_cap_mb`` of spill buffer
and the final diffs; the device holds the graph, the successor index and
one column. The result equals the in-memory ``build_row_diff`` (and
``build_int_row_diff``, whose values are summed where files repeat a
(label, row) pair).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from .annotator import Annotation, LabelEncoder
from .matrix import RowSparse, expand_ranges
from .row_diff import (DEFAULT_MAX_LENGTH, IntRowDiff, RowDiff,
                       assign_successors_and_anchors)


def _isin_sorted(sorted_arr: torch.Tensor, vals: torch.Tensor
                 ) -> torch.Tensor:
    """Membership of ``vals`` in a sorted tensor."""
    if sorted_arr.numel() == 0:
        return torch.zeros(vals.shape, dtype=torch.bool, device=vals.device)
    idx = torch.clamp(torch.searchsorted(sorted_arr, vals),
                      max=sorted_arr.numel() - 1)
    return sorted_arr[idx] == vals


class _SuccIndex:
    """The successor forest inverted: the rows whose successor is v are
    ``order[lo(v):hi(v)]`` (rows without a successor left out)."""

    def __init__(self, succ: torch.Tensor):
        s, order = torch.sort(succ, stable=True)
        nneg = int(torch.searchsorted(s, torch.zeros((1,), dtype=s.dtype,
                                                     device=s.device)))
        self.sorted, self.order = s[nneg:], order[nneg:]

    def preds(self, R: torch.Tensor) -> torch.Tensor:
        """The predecessors of every row of R."""
        _, flat = expand_ranges(
            torch.searchsorted(self.sorted, R, side="left"),
            torch.searchsorted(self.sorted, R, side="right"))
        return self.order[flat]


def _diff_column(R, anchor, succ, inv: _SuccIndex):
    """The diff rows of one column (R: its sorted rows): anchors in R;
    other rows of R whose successor is not in R; rows outside R, not
    anchors, whose successor is in R (row_diff.hpp:153's inverse)."""
    if R.numel() == 0:
        return R
    aR = anchor[R]
    na = R[~aR]
    sv = succ[na]
    keep1 = na[~((sv >= 0) & _isin_sorted(R, sv))]
    preds = inv.preds(R)
    keep2 = preds[~anchor[preds] & ~_isin_sorted(R, preds)]
    return torch.sort(torch.cat([R[aR], keep1, keep2])).values


def _diff_column_int(R, V, anchor, succ, inv: _SuccIndex):
    """Integer diff of one column: anchors keep their value, others store
    value - successor's value (0 when absent); zero deltas drop."""
    if R.numel() == 0:
        return R, V

    def val_at(q):
        idx = torch.clamp(torch.searchsorted(R, q), max=R.numel() - 1)
        return torch.where((R[idx] == q) & (q >= 0), V[idx], 0)

    aR = anchor[R]
    na = R[~aR]
    d1 = V[~aR] - val_at(succ[na])
    preds = inv.preds(R)
    p2 = preds[~anchor[preds] & ~_isin_sorted(R, preds)]
    rows = torch.cat([R[aR], na, p2])
    vals = torch.cat([V[aR], d1, -val_at(succ[p2])])
    keep = vals != 0
    rows, vals = rows[keep], vals[keep]
    order = torch.sort(rows, stable=True).indices
    return rows[order], vals[order]


class _RunSpiller:
    """int64 keys (optionally with int64 values) gathered in memory and
    spilled as sorted ``.npy`` runs of ``cap_keys`` each: an input larger
    than the cap is cut into several runs, so the buffer never holds
    more than the cap."""

    def __init__(self, swap_dir: str, cap_keys: int, prefix: str = "rd",
                 with_vals: bool = False):
        self.swap_dir, self.prefix = swap_dir, prefix
        self.with_vals = with_vals
        self.cap = max(int(cap_keys), 1 << 16)
        self.buf: List[np.ndarray] = []
        self.vbuf: List[np.ndarray] = []
        self.n_buf = 0
        self.runs: List[str] = []

    def add(self, keys: np.ndarray, vals: Optional[np.ndarray] = None):
        pos = 0
        while pos < keys.size:
            take = min(self.cap - self.n_buf, keys.size - pos)
            self.buf.append(keys[pos:pos + take])
            if self.with_vals:
                self.vbuf.append(np.asarray(vals[pos:pos + take], np.int64))
            self.n_buf += take
            pos += take
            if self.n_buf >= self.cap:
                self.flush()

    def flush(self):
        if not self.n_buf:
            return
        arr = np.concatenate(self.buf)
        path = os.path.join(self.swap_dir,
                            f"{self.prefix}_run_{len(self.runs)}.npy")
        if self.with_vals:
            order = np.argsort(arr, kind="stable")
            np.save(path, arr[order])
            np.save(_vpath(path), np.concatenate(self.vbuf)[order])
        else:
            arr.sort()
            np.save(path, arr)
        self.runs.append(path)
        self.buf, self.vbuf, self.n_buf = [], [], 0


def _vpath(kpath: str) -> str:
    return kpath[:-4] + ".vals.npy"


def _merge_two(a, b, out_path: str, block: int, av=None, bv=None) -> str:
    """Blockwise merge of two sorted key arrays (and their co-sorted
    values) into a new sorted memmap, O(block) resident."""
    with_vals = av is not None
    n = a.size + b.size
    out = np.lib.format.open_memmap(out_path, mode="w+", dtype=np.int64,
                                    shape=(n,))
    outv = (np.lib.format.open_memmap(_vpath(out_path), mode="w+",
                                      dtype=np.int64, shape=(n,))
            if with_vals else None)
    ia = ib = io = 0
    while ia < a.size and ib < b.size:
        ablk = np.asarray(a[ia:ia + block])
        bblk = np.asarray(b[ib:ib + block])
        # merge only the span both blocks cover
        top = min(ablk[-1], bblk[-1])
        ahi = int(np.searchsorted(ablk, top, side="right"))
        bhi = int(np.searchsorted(bblk, top, side="right"))
        m = np.concatenate([ablk[:ahi], bblk[:bhi]])
        if with_vals:
            mv = np.concatenate([np.asarray(av[ia:ia + ahi]),
                                 np.asarray(bv[ib:ib + bhi])])
            order = np.argsort(m, kind="stable")
            m = m[order]
            outv[io:io + m.size] = mv[order]
        else:
            m.sort()
        out[io:io + m.size] = m
        io += m.size
        ia += ahi
        ib += bhi
    for src, vsrc, i in ((a, av, ia), (b, bv, ib)):
        while i < src.size:
            blk = np.asarray(src[i:i + block])
            out[io:io + blk.size] = blk
            if with_vals:
                outv[io:io + blk.size] = np.asarray(vsrc[i:i + blk.size])
            io += blk.size
            i += blk.size
    out.flush()
    if with_vals:
        outv.flush()
    return out_path


def _merge_runs(run_paths: List[str], swap_dir: str, block: int = 1 << 22,
                with_vals: bool = False):
    """Pairwise merges of sorted runs, repeated down to one; returns its
    memmap (with the values': a pair). Duplicates are kept."""
    if not run_paths:
        z = np.zeros(0, np.int64)
        return (z, z.copy()) if with_vals else z
    gen = 0
    paths = list(run_paths)
    base = os.path.basename(paths[0]).split("_run_")[0]
    while len(paths) > 1:
        nxt = []
        for i in range(0, len(paths) - 1, 2):
            out = os.path.join(swap_dir, f"{base}_merge_{gen}_{i}.npy")
            a = np.load(paths[i], mmap_mode="r")
            b = np.load(paths[i + 1], mmap_mode="r")
            if with_vals:
                av = np.load(_vpath(paths[i]), mmap_mode="r")
                bv = np.load(_vpath(paths[i + 1]), mmap_mode="r")
                _merge_two(a, b, out, block, av, bv)
                del av, bv
                os.unlink(_vpath(paths[i]))
                os.unlink(_vpath(paths[i + 1]))
            else:
                _merge_two(a, b, out, block)
            del a, b
            os.unlink(paths[i])
            os.unlink(paths[i + 1])
            nxt.append(out)
        if len(paths) % 2:
            nxt.append(paths[-1])
        paths = nxt
        gen += 1
    keys = np.load(paths[0], mmap_mode="r")
    if with_vals:
        return keys, np.load(_vpath(paths[0]), mmap_mode="r")
    return keys


def _unlink_maps(*arrays):
    for arr in arrays:
        if isinstance(arr, np.memmap):
            os.unlink(arr.filename)


def _staged_convert(paths, graph, swap_dir, mem_cap_mb, max_length,
                    with_vals: bool, spilled: Optional[dict] = None):
    """The staged pipeline (module docstring). Returns (encoder, succ,
    anchor, diff keys ``row * num_cols + col`` as a host int64 array,
    their values or None, num_rows, num_cols). ``spilled``, when given,
    receives the number of raw and of diff runs written."""
    os.makedirs(swap_dir, exist_ok=True)
    dev = graph.device
    # Stage 0: the merged label dictionary
    enc = LabelEncoder()
    file_codes: List[np.ndarray] = []
    for p in paths:
        with np.load(p, allow_pickle=False) as d:
            labels = [str(x) for x in d["labels"]]
        file_codes.append(np.array([enc.insert(lab) for lab in labels],
                                   np.int64))
    num_cols = max(len(enc), 1)
    num_rows = int(graph.num_nodes())
    cap_keys = (mem_cap_mb << 20) // (16 if with_vals else 8)

    # Stage 2a: every file's entries spilled as column-major keys; labels
    # per row counted on the way (the stage-0 row_count artifact)
    row_counts = np.zeros(num_rows, np.int64)
    raw = _RunSpiller(swap_dir, cap_keys, prefix="raw", with_vals=with_vals)
    for p, codes in zip(paths, file_codes):
        mat = Annotation.load(p, device="cpu").matrix.to_row_sparse()
        if with_vals and mat.values is None:
            raise ValueError(f"{p}: int_row_diff needs a count annotation")
        if mat.num_rows != num_rows:
            raise ValueError(f"{p}: {mat.num_rows} rows != graph "
                             f"{num_rows}")
        rows = mat.rows.numpy().astype(np.int64)
        row_counts += np.bincount(rows, minlength=num_rows)
        raw.add(codes[mat.cols.numpy().astype(np.int64)] * num_rows + rows,
                mat.values.numpy().astype(np.int64) if with_vals else None)
        del mat, rows
    raw.flush()
    if spilled is not None:
        spilled["raw_runs"] = len(raw.runs)

    # Stage 1: successors, anchors and the inverted successor index
    succ, base_anchor = assign_successors_and_anchors(graph, max_length,
                                                      row_counts)
    inv = _SuccIndex(succ)

    # Stage 2b: the columns united on disk, then walked twice
    merged = _merge_runs(raw.runs, swap_dir, with_vals=with_vals)
    raw_keys, raw_vals = merged if with_vals else (merged, None)

    def columns():
        lo = 0
        for gcol in range(num_cols):
            hi = int(np.searchsorted(raw_keys, (gcol + 1) * num_rows))
            if hi > lo:
                kk = torch.from_numpy(np.array(raw_keys[lo:hi])).to(dev) \
                    - gcol * num_rows
                R, inv_idx = torch.unique_consecutive(kk, return_inverse=True)
                V = None
                if with_vals:           # files may repeat a (label, row)
                    V = torch.zeros(R.shape, dtype=torch.int64,
                                    device=dev).index_add_(
                        0, inv_idx, torch.from_numpy(
                            np.array(raw_vals[lo:hi])).to(dev))
                yield gcol, R, V
            lo = hi

    def diff(R, V, anchor):
        if with_vals:
            return _diff_column_int(R, V, anchor, succ, inv)
        return _diff_column(R, anchor, succ, inv), None

    reduction = torch.zeros((num_rows,), dtype=torch.int64, device=dev)
    for _, R, V in columns():
        D, _ = diff(R, V, base_anchor)
        reduction += torch.bincount(R, minlength=num_rows)
        reduction -= torch.bincount(D, minlength=num_rows)
    anchor = base_anchor | (reduction < 0)
    del reduction

    spiller = _RunSpiller(swap_dir, cap_keys, prefix="diff",
                          with_vals=with_vals)
    for gcol, R, V in columns():
        D, DV = diff(R, V, anchor)
        spiller.add((D * num_cols + gcol).cpu().numpy(),
                    DV.cpu().numpy() if with_vals else None)
    spiller.flush()
    if spilled is not None:
        spilled["diff_runs"] = len(spiller.runs)
    del merged
    _unlink_maps(raw_keys, raw_vals)
    del raw_keys, raw_vals

    # Stage 3: the diff runs merged and copied out
    merged = _merge_runs(spiller.runs, swap_dir, with_vals=with_vals)
    kept, kvals = merged if with_vals else (merged, None)
    keys = np.array(kept)
    vals = np.array(kvals) if with_vals else None
    del merged
    _unlink_maps(kept, kvals)
    return enc, succ, anchor, keys, vals, num_rows, num_cols


def build_row_diff_staged(paths: Sequence[str], graph, swap_dir: str,
                          mem_cap_mb: int = 1024,
                          max_length: int = DEFAULT_MAX_LENGTH,
                          spilled: Optional[dict] = None) -> Annotation:
    """Out-of-core RowDiff conversion of one or more column annotation
    files over the graph's rows; the annotation lives on the graph's
    device. ``spilled``, when given, receives the runs written
    (``raw_runs``, ``diff_runs``)."""
    enc, succ, anchor, keys, _, num_rows, num_cols = _staged_convert(
        paths, graph, swap_dir, mem_cap_mb, max_length, with_vals=False,
        spilled=spilled)
    keys = torch.from_numpy(keys).to(graph.device)
    diffs = RowSparse(rows=(keys // num_cols).to(torch.int32),
                      cols=(keys % num_cols).to(torch.int32),
                      num_rows=num_rows, num_cols=num_cols)
    return Annotation(matrix=RowDiff(diffs=diffs, anchor=anchor, succ=succ,
                                     max_length=max_length), encoder=enc)


def build_int_row_diff_staged(paths: Sequence[str], graph, swap_dir: str,
                              mem_cap_mb: int = 1024,
                              max_length: int = DEFAULT_MAX_LENGTH,
                              spilled: Optional[dict] = None
                              ) -> Annotation:
    """Out-of-core IntRowDiff conversion of count annotation files: the
    binary staging with the values sorted alongside the keys."""
    enc, succ, anchor, keys, vals, num_rows, num_cols = _staged_convert(
        paths, graph, swap_dir, mem_cap_mb, max_length, with_vals=True,
        spilled=spilled)
    keys = torch.from_numpy(keys).to(graph.device)
    return Annotation(
        matrix=IntRowDiff(rows=keys // num_cols,
                          cols=(keys % num_cols).to(torch.int32),
                          vals=torch.from_numpy(vals).to(graph.device),
                          anchor=anchor, succ=succ, max_length=max_length,
                          num_rows=num_rows, num_cols=num_cols),
        encoder=enc)
