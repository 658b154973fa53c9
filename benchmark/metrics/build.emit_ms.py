"""build.emit_ms: the finish's merge and emit (``_merge_emit_body``, the
search table, the statistics' copy, ``Boss.from_finish``), the program's
``finish.emit`` span, mean per build."""

from benchmark import program_spans


def read(win):
    return program_spans.ms_per_call(win, "finish.emit")
