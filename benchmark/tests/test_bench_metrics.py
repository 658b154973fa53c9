"""The yardstick's arithmetic: rates and the tail over a whole window, the
sort's bound bytes, the union of device intervals; and the loops that
drive a window (closed with several clients, open at a rate)."""

import time

import pytest

from benchmark import harness, yardstick
from benchmark.tests._tiny import ROOT


def _window(calls, start=0.0):
    w = harness.Window()
    w.calls, w.start = calls, start
    return w


def _metric(name):
    return harness.Cell("query.dna31-canonical-rdbrwt", ROOT).metric(name)


def test_rate_over_the_whole_window_with_a_stalled_request():
    # three requests of 100 reads; the second stalls for 9 s
    calls = [(0.0, 0.5, 100, True), (0.5, 9.5, 100, True),
             (9.5, 10.0, 100, True), (10.0, 10.0, 100, False)]
    w = _window(calls)
    assert _metric("query_reads_per_s").read(w) == pytest.approx(30.0)
    assert _metric("build_kmers_per_s").read(w) == pytest.approx(30.0)


def test_p95_is_the_nearest_rank_of_every_request():
    lat = [0.1] * 19 + [2.0]                 # 20 requests, one stalled
    calls, t = [], 0.0
    for x in lat:
        calls.append((t, t + x, 1, True))
        t += x
    p95 = _metric("query_p95_ms").read(_window(calls))
    assert p95 == pytest.approx(100.0)       # rank 19 of 20
    calls.append((t, t + 3.0, 1, True))      # a 21st: rank 20 is the stall
    assert _metric("query_p95_ms").read(_window(calls)) == pytest.approx(
        2000.0)


@pytest.mark.parametrize("L,ms", [(2, 0.160), (4, 0.321), (8, 0.641),
                                  (16, 1.282)])
def test_sort_bound_equals_the_kernel_tables_bound(L, ms):
    # PERF.md's table of kernels: sort_packed at 2^25 keys, no payload
    t = yardstick.bound_seconds(yardstick.sort_bound_bytes(1 << 25, L, 0))
    assert round(t * 1e3, 3) == ms


def test_sort_roofline_reader_sums_bounds_over_times():
    w = _window([(0, 1, 1, True)])
    w.spans = {"sort_packed": [1e-3, 3e-3]}
    w.span_args = {"sort_packed": [[(2, 1 << 25)], [(4, 1 << 25), (1 << 25,)]]}
    bound = (yardstick.sort_bound_bytes(1 << 25, 2, 0)
             + yardstick.sort_bound_bytes(1 << 25, 4, 1)) / 3.35e12
    got = _metric("kernel.sort_roofline.build").read(w)
    assert got == pytest.approx(100 * bound / 4e-3)
    assert _metric("kernel.sort_roofline.query").read(_window([])) is None


def test_union_of_overlapping_intervals():
    iv = [(0, 4), (2, 6), (5, 7), (10, 11), (10.5, 10.7), (12, 12)]
    merged = yardstick.merged_intervals(iv)
    assert merged == [[0, 7], [10, 11], [12, 12]]
    assert sum(e - s for s, e in merged) == pytest.approx(8.0)
    assert yardstick.merged_intervals([]) == []


def test_idle_share_reads_nothing_without_a_trace():
    w = _window([(0, 1, 1, True)])
    assert _metric("device.idle_share.build").read(w) is None
    w.busy_s, w.traced_s = 0.25, 1.0
    assert _metric("device.idle_share.query").read(w) == pytest.approx(75.0)


class _Entry:
    """An entry whose calls take ``cost`` seconds and do 10 units of
    work."""

    def __init__(self, cost):
        self.cost = cost

    def items(self, state):
        return iter(range(10 ** 9))

    def call(self, state, item):
        time.sleep(self.cost)
        return item

    def work(self, state, item):
        return 10

    def keep(self, *a, **k):
        pass


class _Cell:
    def __init__(self, **mix):
        from benchmark import generator
        self.traffic = generator.mix(dict(
            {"kind": "read_requests", "reads_per_request": 1,
             "read_length": 1, "indexed_fraction": 1, "error_rate": 0,
             "pool_requests": 1}, **mix), "requests")


def _drive(cost, seconds, **mix):
    w = harness.Window()
    w.start = time.perf_counter()
    harness.drive(_Cell(**mix), _Entry(cost), None, 7, seconds, w,
                  lambda i: None, print)
    return w


def test_closed_loop_clients_queue_behind_one_server():
    w = _drive(0.02, 0.3, clients=3)
    lat = [c[1] - c[0] for c in w.calls]
    # three calls outstanding, answered in turn: each waits for two more
    assert len(w.calls) >= 6
    assert min(lat[3:]) >= 3 * 0.02 * 0.95
    assert all(c[0] <= c[1] for c in w.calls)


def test_open_loop_serves_every_arrival_from_its_arrival():
    from benchmark import generator
    mix = {"loop": "open", "rate_per_s": 40.0}
    at = generator.arrivals(7, _Cell(**mix).traffic, 0.5)
    assert 8 < len(at) < 40 and (at[1:] > at[:-1]).all()
    w = _drive(0.002, 0.5, **mix)
    assert len(w.calls) == len(at) and all(c[3] for c in w.calls)
    sent = [c[0] - w.start for c in w.calls]
    assert sent == pytest.approx(at.tolist(), abs=1e-9)
    assert all(c[1] >= c[0] + 0.002 for c in w.calls)
    # past capacity the queue grows: latency counts the wait
    w = _drive(0.1, 0.5, **mix)
    lat = [c[1] - c[0] for c in w.calls]
    assert len(w.calls) == len(at) and lat[-1] > 3 * lat[0]


@pytest.mark.parametrize("mix", [
    {"loop": "closed", "clients": 0}, {"loop": "closed", "rate_per_s": 5},
    {"loop": "open"}, {"loop": "open", "rate_per_s": 5, "clients": 2},
    {"loop": "open", "rate_per_s": 5, "arrivals": "uniform"},
    {"loop": "batch"}, {"reads_per_request": 1, "no_such_key": 1}])
def test_a_loop_the_harness_cannot_drive_is_refused(mix):
    with pytest.raises(ValueError):
        _Cell(**mix)
