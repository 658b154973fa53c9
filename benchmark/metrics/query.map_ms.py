"""query.map_ms: the mapping of a request's windows to graph nodes
(``BatchQuery._map_batch``: encode, ``map_sequences``, host slicing), by
a synchronized host timer, mean per request."""

PROBES = [{"name": "query.map", "clock": "sync",
           "target": "metagraph_tpu_torch.engine.annotated_dbg:"
                     "BatchQuery._map_batch"}]


def read(win):
    spans = win.spans.get("query.map")
    return 1e3 * sum(spans) / len(win.done) if spans else None
