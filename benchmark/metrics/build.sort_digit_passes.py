"""build.sort_digit_passes: radix digit passes run by the sort kernel per
build (``merge.sort_digit_passes``, an exact count)."""

PROBES = [{"name": "sort_digit_passes",
           "counter": "metagraph_tpu_torch.common.merge:sort_digit_passes"}]


def read(win):
    if "sort_digit_passes" not in win.counters:
        return None
    return win.counters["sort_digit_passes"] / len(win.done)
