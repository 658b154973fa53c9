"""clean.keep_ms: the clean's keep masks (the tips and the median
abundance a unitig, ``unitig_keep_mask``; the single form of a canonical
graph, ``single_form_mask``), the program's ``clean.keep`` spans, mean
per call."""

from benchmark import program_spans


def read(win):
    return program_spans.ms_per_call(win, "clean.keep")
