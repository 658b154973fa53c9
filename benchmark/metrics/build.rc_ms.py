"""build.rc_ms: the canonical finish's rc closure (``_add_rc_stage``: the
reverse complements compacted, sorted and merged into the real edges),
the program's ``finish.rc`` span, mean per call."""

from benchmark import program_spans


def read(win):
    return program_spans.ms_per_call(win, "finish.rc")
