"""query.sums_ms: the per-read label sums less the annotation's rows: the
self time of the program's ``sums`` span (``BatchQuery._read_sums``:
read ids up, ``index_add_``, the (reads x labels) count matrix to the
host), mean per request."""

from benchmark import program_spans


def read(win):
    return program_spans.ms_per_call(win, "sums", own=True)
