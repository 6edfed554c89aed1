"""The harness's host arithmetic: whole-window rates, tails over every
request with failures as misses, spreads, and the open-loop schedule."""

import math
import statistics

import pytest

from perfbench.core import stats


def test_rate_is_all_the_work_over_all_the_time():
    assert stats.rate(1100, 20.0) == 55.0
    with pytest.raises(ValueError):
        stats.rate(10, 0.0)


def test_percentile_is_nearest_rank_over_every_value():
    values = list(range(1, 101))  # 1 .. 100
    assert stats.percentile(values, 95) == 95
    assert stats.percentile(values, 100) == 100
    assert stats.percentile([7.0], 95) == 7.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_failed_requests_count_as_missing_the_tail():
    sched = [float(i) for i in range(100)]
    done = [s + 0.010 for s in sched]
    for i in range(94, 100):  # six requests never answered
        done[i] = None
    lat = stats.latencies(sched, done)
    assert lat.count(math.inf) == 6
    assert stats.percentile(lat, 95) == math.inf
    assert stats.percentile(lat, 90) == pytest.approx(0.010)


def test_latency_runs_from_the_schedule_not_from_the_send():
    # A stalled generator sent late: the wait counts.
    assert stats.latencies([1.0], [1.5]) == [0.5]


def test_poisson_gaps_share_one_multiset_and_differ_in_order():
    a = stats.poisson_gaps(200.0, 4000, seed=1)
    b = stats.poisson_gaps(200.0, 4000, seed=2)
    assert sorted(a) == sorted(b)
    assert a != b
    assert statistics.mean(a) == pytest.approx(1 / 200.0, rel=0.02)
    # Exponential: the standard deviation equals the mean.
    assert statistics.pstdev(a) == pytest.approx(1 / 200.0, rel=0.05)
    assert stats.poisson_gaps(200.0, 4000, seed=1) == a


def test_schedule_is_the_running_sum_from_the_start():
    assert stats.schedule(10.0, [0.5, 0.25, 1.0]) == [10.5, 10.75, 11.75]


def test_balanced_choice_uses_every_item_evenly():
    picks = stats.balanced_choice(128, 1000, seed=3)
    counts = [picks.count(i) for i in range(128)]
    assert max(counts) - min(counts) <= 1
    assert picks != stats.balanced_choice(128, 1000, seed=4)


def test_generator_lateness_and_window_counts():
    med, worst = stats.lateness([1.0, 2.0, 3.0], [1.001, 2.003, 3.002])
    assert med == pytest.approx(0.002)
    assert worst == pytest.approx(0.003)
    assert stats.in_window([0.5, 1.0, 1.5, None, 2.0, 2.5], 1.0, 2.0) == 2
