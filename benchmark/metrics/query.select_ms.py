"""query.select_ms: the host selection: the program's ``select`` spans
(``_selected``'s per-read loop and ``get_labels_batch``'s label lists),
mean per request."""

from benchmark import program_spans


def read(win):
    return program_spans.ms_per_call(win, "select")
