"""The percentile, window-rate and spread arithmetic."""

import statistics

import numpy as np
import pytest

from benchmark.harness import stats


@pytest.mark.parametrize("q", [0, 5, 50, 95, 99, 100])
def test_percentile_matches_numpy_linear(q):
    xs = list(np.random.default_rng(3).exponential(30.0, size=257))
    assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)), rel=1e-12)


def test_percentile_of_one_and_of_none():
    assert stats.percentile([4.0], 95) == 4.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)
    with pytest.raises(ValueError):
        stats.percentile([1.0], 101)


def test_p95_is_the_tail_of_all_requests_not_of_chunk_medians():
    # 18 fast requests and two stalls in each of five chunks: medians of
    # chunks never see the stalls, the tail of all requests does.
    xs = ([10.0] * 18 + [100.0] * 2) * 5
    assert stats.percentile(xs, 95) == 100.0
    assert max(statistics.median(xs[i:i + 20]) for i in range(0, 100, 20)) == 10.0


def test_window_rate_counts_all_work_over_all_time():
    assert stats.window_rate(120, 10.0, 30.0) == 6.0
    with pytest.raises(ValueError):
        stats.window_rate(1, 5.0, 5.0)


def test_quartile_spread_uses_statistics_quantiles():
    xs = [100.0, 101.0, 99.0, 104.0, 98.0, 100.5]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.quartile_spread(xs) == pytest.approx((q3 - q1) / med)


def test_trimmed_drops_the_run_farthest_from_the_median():
    assert sorted(stats.trimmed([10.0, 10.2, 9.9, 14.0, 10.1])) == [9.9, 10.0, 10.1, 10.2]
