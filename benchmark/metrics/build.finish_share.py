"""build.finish_share: the share of the window's build time spent in the
finish (``boss_construct.build_boss_from_kmers``: rc closure, dummies,
levels, merge, emit, ``Boss.from_finish``), both by synchronized host
timers; the rest of a build is the collect."""

PROBES = [{"name": "build.finish", "clock": "sync",
           "target": "metagraph_tpu_torch.graph.boss_construct:"
                     "build_boss_from_kmers"}]


def read(win):
    finish = win.spans.get("build.finish")
    if not finish:
        return None
    return 100.0 * sum(finish) / sum(c[1] - c[0] for c in win.done)
