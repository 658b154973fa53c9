"""build.levels_ms: the finish's K - 2 dummy-source levels
(``boss_construct._levels_phase``: a sort and a host sync a level), the
program's ``finish.levels`` span, mean per build."""

from benchmark import program_spans


def read(win):
    return program_spans.ms_per_call(win, "finish.levels")
