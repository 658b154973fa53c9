"""Label dictionary, the column annotator and the annotation container.

PyTorch counterpart of ``metagraph_tpu/anno/annotator.py``. Labels
accumulate as (row, label) COO batches on the host and are finalized
into a sorted ``RowSparse`` on the device in one sort. The
``.annodbg.npz`` container is the JAX package's, for every
representation (column, Multi-BRWT, RowDiff and their integer,
unique-row and coordinate forms): a file written by either package
loads in the other, and the container's keys say which form it holds.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..common.device import resolve
from .matrix import RowSparse

class LabelEncoder:
    def __init__(self, labels: Sequence[str] = ()):
        self._labels: List[str] = []
        self._index: Dict[str, int] = {}
        for label in labels:
            self.insert(label)

    def insert(self, label: str) -> int:
        if label not in self._index:
            self._index[label] = len(self._labels)
            self._labels.append(label)
        return self._index[label]

    def encode(self, label: str) -> int:
        return self._index[label]

    def decode(self, code: int) -> str:
        return self._labels[code]

    def __contains__(self, label: str) -> bool:
        return label in self._index

    def __len__(self) -> int:
        return len(self._labels)

    @property
    def labels(self) -> List[str]:
        return list(self._labels)


class ColumnAnnotator:
    """Construction-time annotator: accumulate (row, label) pairs, then
    finalize into a RowSparse matrix (deduped; values summed)."""

    def __init__(self, num_rows: int, device="cuda"):
        self.num_rows = num_rows
        self.device = resolve(device)
        self.encoder = LabelEncoder()
        self._rows: List[np.ndarray] = []
        self._cols: List[np.ndarray] = []
        self._vals: List[np.ndarray] = []
        self._has_values = False

    def add(self, rows: np.ndarray, label: str,
            values: Optional[np.ndarray] = None):
        code = self.encoder.insert(label)
        rows = np.asarray(rows, np.int32)
        self._rows.append(rows)
        self._cols.append(np.full(rows.shape, code, np.int32))
        if values is not None:
            self._has_values = True
            self._vals.append(np.asarray(values, np.int32))
        elif self._has_values:
            self._vals.append(np.ones(rows.shape, np.int32))

    def finalize(self) -> "Annotation":
        if self._rows:
            rows = np.concatenate(self._rows)
            cols = np.concatenate(self._cols)
            vals = np.concatenate(self._vals) if self._has_values else None
        else:
            rows = np.zeros((0,), np.int32)
            cols = np.zeros((0,), np.int32)
            vals = None
        mat = RowSparse.from_coo(rows, cols, self.num_rows,
                                 max(len(self.encoder), 1), values=vals,
                                 device=self.device)
        return Annotation(matrix=mat, encoder=self.encoder)


@dataclass
class Annotation:
    """A finalized annotation: matrix (any representation of ``anno/``)
    + label dictionary."""
    matrix: object
    encoder: LabelEncoder

    @property
    def num_labels(self) -> int:
        return len(self.encoder)

    @property
    def representation(self) -> str:
        return type(self.matrix).__name__.lower()

    def save(self, path: str):
        d = self.matrix.to_npz_dict()
        # fixed-width unicode: loadable with allow_pickle=False
        d["labels"] = np.array(self.encoder.labels, dtype=np.str_)
        np.savez_compressed(path, **d)

    @staticmethod
    def load(path: str, device="cuda") -> "Annotation":
        with np.load(path, allow_pickle=False) as z:
            d = {key: z[key] for key in z.files}
        return annotation_from_numpy(d, device)

    @staticmethod
    def merge(parts: Sequence["Annotation"], num_rows: int,
              device="cuda") -> "Annotation":
        """Merge annotations over the same row space (merge_anno): the
        labels in first-seen order, their rows united, values summed
        (ones for a part without values when another has them)."""
        enc = LabelEncoder()
        mats = [p.matrix.to_row_sparse() for p in parts]
        has_vals = any(m.values is not None for m in mats)
        rows, cols, vals = [], [], []
        for p, m in zip(parts, mats):
            remap = np.array([enc.insert(label) for label in p.encoder.labels],
                             np.int32)
            r = m.rows.cpu().numpy()
            c = m.cols.cpu().numpy()
            rows.append(r)
            cols.append(remap[c] if len(remap) else c)
            if has_vals:
                vals.append(m.values.cpu().numpy() if m.values is not None
                            else np.ones_like(r))
        empty = [np.zeros((0,), np.int32)]
        mat = RowSparse.from_coo(np.concatenate(rows + empty),
                                 np.concatenate(cols + empty), num_rows,
                                 max(len(enc), 1),
                                 values=np.concatenate(vals + empty)
                                 if has_vals else None, device=device)
        return Annotation(matrix=mat, encoder=enc)


# the container's marker key of each representation, in the JAX
# package's order of tests (a file holding several takes the first)
_REPRESENTATIONS = [
    ("ur_codes", "unique_row", "UniqueRow"),
    ("irdb_anchor", "int_brwt", "IntRowDiffBrwt"),
    ("ibrwt_ptr", "int_brwt", "IntBrwt"),
    ("trd_anchor", "coords", "TupleRowDiff"),
    ("rdb_anchor", "row_diff", "RowDiffBrwt"),
    ("coord_shape", "coords", "CoordMatrix"),
    ("brwt_shape", "brwt", "Brwt"),
    ("rd_anchor_prefix", "row_diff", "RowDiff"),
    ("ird_rows", "row_diff", "IntRowDiff"),
]


def annotation_from_numpy(d, device="cuda") -> Annotation:
    """An annotation from its container's arrays (the dict of a
    ``.annodbg.npz``: ``labels`` and the matrix's keys), on ``device``.
    A column annotation may give ``num_rows`` in place of ``shape`` (one
    column per label)."""
    import importlib
    dev = resolve(device)
    labels = [str(x) for x in d["labels"]]
    for key, module, cls in _REPRESENTATIONS:
        if key in d:
            rep = getattr(importlib.import_module(f"{__package__}.{module}"),
                          cls)
            return Annotation(matrix=rep.from_npz_dict(d, dev),
                              encoder=LabelEncoder(labels))
    if "shape" not in d:
        d = dict(d, shape=np.array([int(d["num_rows"]),
                                    max(len(labels), 1)]))
    return Annotation(matrix=RowSparse.from_npz_dict(d, device=dev),
                      encoder=LabelEncoder(labels))
