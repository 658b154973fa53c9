"""clean.contigs_ms: the contigs of the kept nodes (``contig_walks`` of
the masked graph: its unitig decomposition, the greedy joins, a second
doubling; the spelling and its copy to the host; each path and its
counts split on the host), the program's ``clean.contigs`` span, mean
per call."""

from benchmark import program_spans


def read(win):
    return program_spans.ms_per_call(win, "clean.contigs")
