"""query.map_search_ms: the batched search of a request's windows
(``map_sequences``' ``map_codes_to_nodes`` call: codes up, the search,
nodes down), the program's ``map.search`` span, mean per request."""

from benchmark import program_spans


def read(win):
    return program_spans.ms_per_call(win, "map.search")
