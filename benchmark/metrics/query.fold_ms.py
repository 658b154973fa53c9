"""query.fold_ms: the parity fold of the walks' hits
(``row_diff.fold_hits``: the sort and partition kernels), the program's
``anno.fold`` span, mean per request."""

from benchmark import program_spans


def read(win):
    return program_spans.ms_per_call(win, "anno.fold")
