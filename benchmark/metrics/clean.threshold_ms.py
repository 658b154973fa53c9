"""clean.threshold_ms: the clean's threshold (``clean_graph``: the node
weights, their histogram to the host, the gamma-Poisson pick), the
program's ``clean.threshold`` span, mean per call."""

from benchmark import program_spans


def read(win):
    return program_spans.ms_per_call(win, "clean.threshold")
