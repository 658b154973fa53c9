"""query.descent_ms: the Multi-BRWT descent of the walked rows
(``Brwt.row_hits``), the program's ``anno.descent`` span, mean per
request."""

from benchmark import program_spans


def read(win):
    return program_spans.ms_per_call(win, "anno.descent")
