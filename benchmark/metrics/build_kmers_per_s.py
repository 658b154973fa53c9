"""build_kmers_per_s: the input k-mer windows of every build completed in
the window over the time from its start to the last completion (host
clock; each build ends in a synchronize)."""


def read(win):
    return sum(c[2] for c in win.done) / win.elapsed()
