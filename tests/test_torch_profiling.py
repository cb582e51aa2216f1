"""``gravinv3dhmc_tpu_torch/profiling.py`` on the CPU: the timer registry
behaves as the JAX package's (``gravinv3dhmc_tpu/profiling.py``), the
trace context writes a Chrome trace of the block's operations, and the
memory report reads the host's resident set without ``psutil``."""
import json
import time

import pytest
import torch

from gravinv3dhmc_tpu import profiling as jprof
from gravinv3dhmc_tpu_torch import profiling as tprof


def test_timers_match_the_jax_registry():
    got, want = tprof.Timers(), jprof.Timers()
    for timers in (got, want):
        for _ in range(3):
            with timers("a"):
                time.sleep(0.002)
        with timers("b"):
            pass
        with pytest.raises(RuntimeError):
            with timers("c"):
                raise RuntimeError("the block's error passes through")
    s_t, s_j = got.summary(), want.summary()
    assert set(s_t) == set(s_j) == {"a", "b", "c"}
    for name in s_t:
        assert set(s_t[name]) == set(s_j[name])
        assert s_t[name]["count"] == s_j[name]["count"]
    assert s_t["a"]["count"] == 3 and s_t["a"]["total_s"] >= 0.006
    assert json.loads(got.report()) == s_t
    assert isinstance(tprof.timers, tprof.Timers)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(64, 64)
    with tprof.device_trace(str(tmp_path / "trace")) as path:
        (a @ a).sum()
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names
    assert path.startswith(str(tmp_path))


def test_memory_report_without_a_card():
    out = tprof.memory_report()
    assert out["host_rss_gb"] > 0 and out["host_total_gb"] > 0
    assert not [k for k in out if k.startswith("cuda")]


def test_memory_report_reads_each_card(monkeypatch):
    """With a card, each device reports its allocator's bytes in use and
    peak under ``cuda:<i>`` (stats patched in here)."""
    stats = {"allocated_bytes.all.current": 3 * 1024 ** 3,
             "allocated_bytes.all.peak": 5 * 1024 ** 3}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: stats)
    out = tprof.memory_report()
    assert out["cuda:0"] == out["cuda:1"] == {"bytes_in_use_gb": 3.0,
                                              "peak_gb": 5.0}
