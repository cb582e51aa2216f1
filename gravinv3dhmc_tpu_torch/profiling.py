"""Structured timing and device profiling.

The port of ``gravinv3dhmc_tpu/profiling.py``: the same timer registry
(:class:`Timers`, the process-wide :data:`timers`), a trace context on
``torch.profiler`` in place of ``jax.profiler`` (:func:`device_trace`:
CPU and, with a card, CUDA activities, written as a Chrome trace), and a
host and device memory snapshot (:func:`memory_report`) from
``/proc/self/status`` and ``torch.cuda.memory_stats``, since the card's
machine has no ``psutil``.
"""
from __future__ import annotations

import contextlib
import json
import os
import resource
import tempfile
import time
from collections import defaultdict

import torch


class Timers:
    """Named wall-clock accumulators with JSON export.

    >>> timers = Timers()
    >>> with timers("kernel_build"):
    ...     pass
    >>> "kernel_build" in timers.summary()
    True
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self):
        return {name: {"total_s": round(self.totals[name], 6),
                       "count": self.counts[name],
                       "mean_s": round(self.totals[name]
                                       / max(self.counts[name], 1), 6)}
                for name in self.totals}

    def report(self):
        return json.dumps(self.summary())


#: process-global default registry
timers = Timers()


@contextlib.contextmanager
def device_trace(logdir=None):
    """Trace a block of work with ``torch.profiler`` (CPU activities, and
    CUDA ones when a card is present) and write it as a Chrome trace
    (``chrome://tracing``, Perfetto) to ``<logdir>/trace.json``; yields
    that path, which holds the trace once the block has ended. ``logdir``
    defaults to ``torch-trace`` in the temporary directory."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def _host_rss_gb():
    """The process's resident set: ``VmRSS`` of ``/proc/self/status``, or
    the peak from ``resource`` where there is no ``/proc``."""
    try:
        with open("/proc/self/status") as f:
            for ln in f:
                if ln.startswith("VmRSS:"):
                    return int(ln.split()[1]) * 1024 / 1024 ** 3
    except FileNotFoundError:
        pass
    peak_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return peak_kb * 1024 / 1024 ** 3


def memory_report():
    """Host and device memory snapshot (the reference printed psutil RSS,
    example/uniformgrid/main_uniform.py:92-95): ``host_rss_gb``,
    ``host_total_gb`` and, for each CUDA device ``cuda:<i>``, the caching
    allocator's ``bytes_in_use_gb`` and ``peak_gb``."""
    out = {"host_rss_gb": round(_host_rss_gb(), 3),
           "host_total_gb": round(os.sysconf("SC_PAGE_SIZE")
                                  * os.sysconf("SC_PHYS_PAGES")
                                  / 1024 ** 3, 2)}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            out[f"cuda:{i}"] = {
                "bytes_in_use_gb": round(
                    stats.get("allocated_bytes.all.current", 0) / 1024 ** 3,
                    3),
                "peak_gb": round(
                    stats.get("allocated_bytes.all.peak", 0) / 1024 ** 3, 3),
            }
    return out
