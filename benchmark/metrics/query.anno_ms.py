"""query.anno_ms: the annotation's rows of a request's present windows
(``RowDiffBrwt.row_hits``: the anchor walks, the Multi-BRWT descent, the
sort and partition folds), by a synchronized host timer, mean per
request."""

PROBES = [{"name": "query.anno", "clock": "sync",
           "target": "metagraph_tpu_torch.anno.row_diff:RowDiffBrwt.row_hits"}]


def read(win):
    spans = win.spans.get("query.anno")
    return 1e3 * sum(spans) / len(win.done) if spans else None
