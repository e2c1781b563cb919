"""Tails and rates over a whole window, device-trace arithmetic."""

import math

import pytest

from benchmark import devtrace, stats


def _rec(i, sent, done, ok=True, units=1.0):
    return stats.Record(i, 0, sent, done, ok, units)


def test_percentile_is_nearest_rank():
    v = list(range(1, 101))
    assert stats.percentile(v, 95) == 95
    assert stats.percentile(v, 100) == 100
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([5, 1, 4, 2, 3], 50) == 3


def test_tail_and_rate_over_the_whole_window():
    # 100 requests of 10 ms back to back from t = 0
    recs = [_rec(i, i * 0.01, (i + 1) * 0.01, units=30) for i in range(100)]
    assert stats.tail_ms(recs) == pytest.approx(10.0)
    assert stats.rate(recs, 0.0) == pytest.approx(3000.0)


def test_a_stall_stays_in_the_tail_and_the_rate():
    # 99 quick requests, then one that stalls 2 s: the tail of 100
    # samples at 95% is a quick one, but the rate pays the stall, and
    # six stalls put it in the tail
    recs = [_rec(i, i * 0.01, (i + 1) * 0.01) for i in range(99)]
    recs.append(_rec(99, 0.99, 2.99))
    assert stats.tail_ms(recs) == pytest.approx(10.0)
    assert stats.rate(recs, 0.0) == pytest.approx(100 / 2.99)
    stalls = recs[:94] + [_rec(100 + i, 0.94, 2.94) for i in range(6)]
    assert stats.tail_ms(stalls) == pytest.approx(2000.0)


def test_a_failed_request_counts_as_infinitely_late():
    recs = [_rec(i, 0.0, 0.01) for i in range(19)] + [_rec(19, 0, 0.01,
                                                           ok=False)]
    assert stats.tail_ms(recs, 95) == pytest.approx(10.0)
    recs.append(_rec(20, 0.0, 0.01, ok=False))
    assert math.isinf(stats.tail_ms(recs, 95))
    # failed work is not counted as done
    assert stats.rate(recs, 0.0) == pytest.approx(19 / 0.01)


def test_spread_uses_python_quartiles():
    assert stats.spread([10, 10, 10, 10]) == 0.0
    v = [98, 99, 100, 101, 102, 100]
    q1, med, q3 = __import__("statistics").quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / med)


def test_busy_is_the_union_of_intervals():
    ev = [("a", 0, 10), ("b", 5, 15), ("c", 20, 30), ("d", 22, 25)]
    assert devtrace.merged(ev) == [(0, 15), (20, 30)]
    assert devtrace.busy_s(ev) == pytest.approx(25e-9)
    assert devtrace.top_ops(ev, 2) == [["a", 10e-9], ["b", 10e-9]]


def test_idle_gaps_are_named_by_the_open_host_spans():
    ev = [("k", 10, 20), ("k", 40, 50)]
    spans = [("frame_repr", 0, 30), ("scores_from_repr", 30, 60)]
    # gaps: [0, 10) mid 5 in frame_repr; [20, 40) mid 30 in
    # scores_from_repr; [50, 100) mid 75 in none
    got = dict(map(tuple, devtrace.idle_by_host(ev, 0, 100, spans)))
    assert got == pytest.approx({"frame_repr": 10e-9,
                                 "scores_from_repr": 20e-9,
                                 "between requests": 50e-9})
    both = dict(map(tuple, devtrace.idle_by_host(
        [], 0, 10, [("a", 0, 10), ("b", 0, 10)])))
    assert both == pytest.approx({"a+b": 10e-9})
