"""query.map_host_ms: the host's share of the mapping: the self time of the
program's ``map`` span (``BatchQuery._map_batch``: encode, slicing,
``node_to_anno_row``, concatenation) less its ``map.search``, mean per
request."""

from benchmark import program_spans


def read(win):
    return program_spans.ms_per_call(win, "map", own=True)
