"""clean.unitigs_ms: the unitig decomposition of the graph inside the
count mask (``clean_node_mask``'s ``unitig_decomposition``: one
adjacency pass, pointer doubling), the program's ``clean.unitigs`` span,
mean per call."""

from benchmark import program_spans


def read(win):
    return program_spans.ms_per_call(win, "clean.unitigs")
