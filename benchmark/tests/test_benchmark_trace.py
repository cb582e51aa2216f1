"""The reduction of a trace to busy time and idle stretches."""
import pytest

from benchmark.harness import busy_and_gaps


def test_busy_is_the_union_and_gaps_go_to_the_innermost_span():
    dev = [("a", 10.0, 20.0), ("b", 15.0, 30.0), ("c", 40.0, 50.0),
           ("d", 42.0, 45.0)]
    host = [("stretch", 0.0, 60.0), ("chunk_issue", 28.0, 45.0)]
    busy, gaps = busy_and_gaps(dev, host)
    assert busy == 30.0                     # [10, 30] and [40, 50]
    # idle: [0, 10] and [50, 60] in the stretch, [30, 40] while issuing
    assert gaps == pytest.approx({"stretch": 20e-6, "chunk_issue": 10e-6})


def test_no_host_span_counts_only_the_gaps_between_operations():
    busy, gaps = busy_and_gaps([("a", 0.0, 1.0), ("b", 3.0, 4.0)], [])
    assert busy == 2.0 and gaps == pytest.approx({"outside": 2e-6})
