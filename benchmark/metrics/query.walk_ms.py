"""query.walk_ms: the anchor walks (``row_diff.walk_paths``: up to
max_length + 1 masked steps, each a round trip), the program's
``anno.walk`` span, mean per request."""

from benchmark import program_spans


def read(win):
    return program_spans.ms_per_call(win, "anno.walk")
