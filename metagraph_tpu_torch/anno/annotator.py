"""Label dictionary, the column annotator and the annotation container.

PyTorch counterpart of ``metagraph_tpu/anno/annotator.py`` for the
column (``RowSparse``) representation. Labels accumulate as (row,
label) COO batches on the host and are finalized into a sorted
``RowSparse`` on the device in one sort. The ``.annodbg.npz`` container
is the JAX package's: a file written by either package loads in the
other.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..common.device import resolve
from .matrix import RowSparse

# keys that mark the JAX package's compressed representations
_OTHER_REPRESENTATIONS = ("ur_codes", "irdb_anchor", "ibrwt_ptr",
                          "trd_anchor", "rdb_anchor", "coord_shape",
                          "brwt_shape", "rd_anchor_prefix", "ird_rows")


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
    """A finalized annotation: matrix + label dictionary."""
    matrix: RowSparse
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


def annotation_from_numpy(d, device="cuda") -> Annotation:
    """An annotation from its arrays: ``rows``, ``cols``, optional
    ``values``, ``labels``, and the matrix ``shape`` (or ``num_rows``,
    with one column per label)."""
    dev = resolve(device)
    other = [key for key in _OTHER_REPRESENTATIONS if key in d]
    if other:
        raise NotImplementedError(
            f"annotation representation with {other[0]!r} is not yet ported "
            f"(column only)")
    labels = [str(x) for x in d["labels"]]
    if "shape" not in d:
        d = dict(d, shape=np.array([int(d["num_rows"]),
                                    max(len(labels), 1)]))
    return Annotation(matrix=RowSparse.from_npz_dict(d, device=dev),
                      encoder=LabelEncoder(labels))
