"""Percentiles count failures as misses, rates count the window only."""

from __future__ import annotations

from benchmark import spec, stats


def test_percentile_with_misses():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 95) == 95
    # five misses above every value push the rank up by five
    assert stats.percentile(vals, 95, misses=5, miss_value=1e9) == 100
    assert stats.percentile([1.0] * 94, 95, misses=6, miss_value=7.0) == 7.0
    assert stats.percentile([], 95) is None


def _run(requests, seconds=10.0, drain=5.0, loop="open"):
    return {"requests": requests, "t0": 100.0, "t1": 100.0 + seconds,
            "seconds": seconds,
            "workload": {"loop": loop, "drain_s": drain}}


def _req(due, times, error=None):
    return {"due": due, "sent": due, "first": times[0] if times else None,
            "last": times[-1] if times else None, "times": times,
            "error": error, "cut": False}


def test_ttft_reader_counts_failures_as_misses():
    read = spec.metric_reader("ttft_p95_ms")
    ok = [_req(100.0 + k * 0.1, [100.0 + k * 0.1 + 0.2]) for k in range(19)]
    assert abs(read(_run(ok)) - 200.0) < 1e-6
    failed = ok + [_req(101.0, [], error="HTTP 500")]
    # 20 samples: the 19th rank is the last served one, the 20th the miss
    assert abs(read(_run(failed)) - 200.0) < 1e-6
    two = failed + [_req(102.0, [])]
    assert read(_run(two)) == (10.0 + 5.0) * 1e3


def test_tpot_and_throughput_readers():
    reqs = [_req(100.0, [100.5, 100.6, 100.7]), _req(101.0, [109.0, 111.0]),
            _req(102.0, [103.0])]
    tpot = spec.metric_reader("tpot_p95_ms")(_run(reqs))
    assert abs(tpot - 2000.0) < 1e-6
    rate = spec.metric_reader("output_tokens_per_s")(_run(reqs))
    # 111.0 falls after the window's close at 110.0
    assert rate == 5 / 10.0
