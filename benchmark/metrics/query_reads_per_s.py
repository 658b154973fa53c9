"""query_reads_per_s: the reads answered in the window over the time from
its start to the last answer (host clock)."""


def read(win):
    return sum(c[2] for c in win.done) / win.elapsed()
