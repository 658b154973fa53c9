"""build.dummies_ms: the finish's dummy stage (the rc closure and the dummy
sinks and sources: sorts of all real edges and membership merges, or the
boundary probes; the host sync that sizes both sets), the program's
``finish.dummies`` span, mean per build."""

from benchmark import program_spans


def read(win):
    return program_spans.ms_per_call(win, "finish.dummies")
