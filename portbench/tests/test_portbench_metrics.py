"""The arithmetic of the end-to-end and per-layer metrics."""
import math

import numpy as np
import pytest

from portbench.harness import cell, stats


def test_percentile_is_over_all_samples_by_nearest_rank():
    values = list(range(1, 101))          # 1..100
    assert stats.rank_percentile(values, 99) == 99
    assert stats.rank_percentile(values, 50) == 50
    assert stats.rank_percentile(values + [1000], 99) == 100
    assert math.isnan(stats.rank_percentile([], 99))


def test_an_unanswered_query_counts_beyond_every_limit():
    lat = [0.001] * 98 + [math.inf] * 2   # two never answered in 100
    assert stats.rank_percentile(lat, 99) == math.inf
    assert stats.rank_percentile(lat, 98) == 0.001


def test_a_stall_moves_the_tail_and_not_the_median():
    rng = np.random.default_rng(0)
    base = rng.exponential(0.002, 10_000)
    stalled = base.copy()
    # a 200 ms stall: every query due in it waits for its end
    due = np.sort(rng.random(10_000) * 10.0)
    in_stall = (due >= 5.0) & (due < 5.2)
    stalled[in_stall] += 5.2 - due[in_stall]
    assert stats.rank_percentile(stalled, 99) > \
        5 * stats.rank_percentile(base, 99)
    assert stats.rank_percentile(stalled, 50) == pytest.approx(
        stats.rank_percentile(base, 50), rel=0.05)


def test_bucket_percentile_reads_the_bound_of_its_bucket():
    cum = {"0.001": 10.0, "0.01": 90.0, "0.1": 99.0, "1": 100.0,
           "+Inf": 100.0}
    assert stats.bucket_percentile(cum, 50) == 0.01
    assert stats.bucket_percentile(cum, 99) == 0.1
    assert stats.bucket_percentile({"0.1": 0.0, "+Inf": 0.0}, 99) is None
    assert stats.bucket_percentile({"1": 90.0, "+Inf": 100.0}, 99) is None


def test_quartile_spread_is_statistics_quantiles():
    assert stats.quartile_spread([1, 2, 3, 4, 5, 6]) == pytest.approx(
        (5.25 - 1.75) / 3.5)


def delta(**kw):
    out = {"window_s": 10.0, "cpu": {"balancer": 9.5, "supervisor": 4.0,
                                     "worker0": 8.0, "worker1": 6.0},
           "workers": [{"completed": 1000.0, "zone_serves": 600.0,
                        "cache_hits": 350.0, "python_cache_hits": 50.0,
                        "native_install_buckets": {"0.01": 5.0,
                                                   "0.1": 100.0,
                                                   "+Inf": 100.0}},
                       {"completed": 1000.0, "zone_serves": 500.0,
                        "cache_hits": 300.0, "python_cache_hits": 0.0,
                        "native_install_buckets": {"0.01": 0.0,
                                                   "0.1": 100.0,
                                                   "+Inf": 100.0}}],
           "balancer": {"forwarded": 2000}, "gpu_util": [0.0, 2.0],
           "client": {"qps": 200.0, "p99_ms": 12.5,
                      "freshness_p99_ms": 80.0},
           "boot": {"serving_s": 14.5, "filled_s": 110.25}}
    out.update(kw)
    return out


@pytest.mark.parametrize("name, want", [
    ("balancer.busy.open", 0.95),
    ("balancer.cpu_us_per_query.open", 9.5e6 / 2000),
    ("workers.cpu_us_per_query.open", 14e6 / 2000),
    ("clane.share.open", (600 + 300 + 500 + 300) / 2000),
    ("workers.busy.open", 0.7),
    ("supervisor.busy.open", 0.4),
    ("propagation_p99_ms.open", 100.0),
    ("device.idle.open", 0.99),
    ("p99_ms.open", 12.5),
    ("freshness_p99_ms.open", 80.0),
    ("boot.serving_s", 14.5),
    ("boot.filled_s", 110.25),
])
def test_each_reader(name, want):
    assert cell.load_metric(name).read(delta()) == pytest.approx(want)


def test_propagation_past_the_last_bound_reads_that_bound():
    r = delta()
    for w in r["workers"]:
        w["native_install_buckets"] = {"0.1": 1.0, "1": 2.0, "+Inf": 100.0}
    assert cell.load_metric("propagation_p99_ms.open").read(r) == 1000.0


@pytest.mark.parametrize("name", [
    "balancer.busy.open", "balancer.cpu_us_per_query.open",
    "device.idle.open", "propagation_p99_ms.open", "clane.share.open",
    "p99_ms.open", "boot.serving_s", "boot.filled_s"])
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    empty = delta(cpu={}, balancer=None, gpu_util=[], boot=None,
                  client={"p99_ms": None},
                  workers=[{"completed": 0.0, "zone_serves": 0.0,
                            "cache_hits": 0.0, "python_cache_hits": 0.0,
                            "native_install_buckets": {}}])
    assert cell.load_metric(name).read(empty) is None
