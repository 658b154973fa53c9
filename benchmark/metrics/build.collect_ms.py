"""build.collect_ms: the collect (``boss_construct.collect_kmers``: host
invalid scan, upload, 2-bit pack, canonical fold, sort-unique, boundary
candidates), the program's ``collect`` span, mean per build."""

from benchmark import program_spans


def read(win):
    return program_spans.ms_per_call(win, "collect")
