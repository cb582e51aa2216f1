"""Structured timing, program spans and device profiling.

The port of ``gravinv3dhmc_tpu/profiling.py``: the same timer registry
(:class:`Timers`, the process-wide :data:`timers`), a trace context on
``torch.profiler`` in place of ``jax.profiler`` (:func:`device_trace`:
CPU and, with a card, CUDA activities, written as a Chrome trace), and a
host and device memory snapshot (:func:`memory_report`) from
``/proc/self/status`` and ``torch.cuda.memory_stats``, since the card's
machine has no ``psutil``.

**Program spans.** The fused sampler marks what the host does while the
card works (:func:`span`, kept in memory, ordered, bounded by
:data:`MAX_SPANS`): ``hmc.chunk`` (one ``run_chunk``), ``hmc.lengths``
(the host draw of the chunk's trajectory lengths), ``hmc.iteration``
(one iteration: its batch steps ``steps``, and where the card reached
it), ``hmc.store`` (the sample store, the stats row and the Welford
moments) and ``kernel.<name>`` (one call of a hand-written kernel: on the
card its issue, from the pointer checks to the C entry's return). Each
span holds its name, its start and end on ``time.time_ns()`` (the
profiler's own clock, so a span lies on the device trace's time line
without entering the profiler's event list), its parent's index, its
chunk index and its attributes; each also adds its time into
:data:`timers` (when the registry is read). Tracing is on while a ``torch.profiler`` session is
active (read once at each chunk's start) or after :func:`enable`, and
off otherwise: every site then costs one check of :data:`ON`.
:func:`spans` returns the buffer, :func:`counters` the kernels' launch
counts and the spans dropped, and :func:`device_trace` writes the spans
of its block into its trace beside the device rows. The spans are kept
by one host thread (the sampler's).

:func:`profile_run` profiles one chunk of a sampler and reduces its
trace: device busy time, device time by kernel, host self time by span,
and the device's idle time by the innermost span the host was in.
"""
from __future__ import annotations

import collections
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


class _ProcessTimers(Timers):
    """The process-wide registry: the program's closed spans are added in
    when it is read, so closing a span costs no dictionary update."""

    def summary(self):
        _fold()
        return super().summary()


#: process-global default registry
timers = _ProcessTimers()


# ------------------------------------------------------------ program spans

#: the most spans the buffer keeps; later ones are counted as dropped
MAX_SPANS = 1 << 20
#: True while spans are recorded: the one check every site makes
ON = False

#: one recorded span: ``start_ns``/``end_ns`` on ``time.time_ns()``
#: (``end_ns`` None while open), ``parent`` the index of the enclosing
#: span in :func:`spans` (-1 for none), ``chunk`` the sampler chunk it
#: belongs to (None outside one), ``attrs`` a dict
Span = collections.namedtuple(
    "Span", "name start_ns end_ns parent chunk attrs")

_mode = None        # enable(): True or False; None follows the profiler
_profiled = False   # a profiler session was active at the last chunk
_chunk = None       # the chunk index of the spans opened now
_buffer = []        # [name, start_ns, end_ns, parent, chunk, attrs]
_stack = []         # indices of the open spans, innermost last
_markers = []       # (index, CUDA event, host ns, device) unresolved
_dropped = 0
_folded = 0         # the spans before this index are in ``timers``


def enable(on=True):
    """Record spans everywhere (``True``; the buffer starts afresh when
    tracing was off), nowhere, even under a profiler (``False``), or while
    a ``torch.profiler`` session is active (``None``, the default)."""
    global ON, _mode
    if on and not ON:
        reset()
    _mode = None if on is None else bool(on)
    ON = bool(on)


def reset():
    """Empty the buffer (its closed spans stay in :data:`timers`), its
    unresolved markers and the dropped count."""
    global _dropped, _folded
    _fold()
    _buffer.clear()
    _stack.clear()
    _markers.clear()
    _dropped = 0
    _folded = 0


def _fold():
    """Add the closed spans not added yet into :data:`timers`, up to the
    first open one."""
    global _folded
    totals, counts = timers.totals, timers.counts
    i = _folded
    while i < len(_buffer) and _buffer[i][2] is not None:
        name, start, stop = _buffer[i][:3]
        totals[name] += (stop - start) * 1e-9
        counts[name] += 1
        i += 1
    _folded = i


def begin(name, attrs=None):
    """Open span ``name`` inside the innermost open one; returns its index,
    or None when the buffer is full (the span is counted as dropped).
    Callers check :data:`ON` first."""
    global _dropped
    if len(_buffer) >= MAX_SPANS:
        _dropped += 1
        return None
    index = len(_buffer)
    _buffer.append([name, time.time_ns(), None,
                    _stack[-1] if _stack else -1, _chunk, attrs])
    _stack.append(index)
    return index


def end(index):
    """Close span ``index`` and any span opened inside it that is still
    open. None and a span closed already are no-ops."""
    if index is None or index >= len(_buffer) \
            or _buffer[index][2] is not None:
        return
    t = time.time_ns()
    while _stack:
        j = _stack.pop()
        _buffer[j][2] = t
        if j == index:
            return


class _Span:
    __slots__ = ("name", "attrs", "index")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self.index = begin(self.name, self.attrs)
        return self.index

    def __exit__(self, *exc):
        end(self.index)
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name, **attrs):
    """A context that records span ``name`` with ``attrs`` while tracing
    is on; ``as`` gives its index (None when off or dropped). Off, it is a
    shared no-op."""
    return _Span(name, attrs or None) if ON else _OFF


def mark(index, device, **attrs):
    """Add ``attrs`` to span ``index`` and, on a CUDA ``device``, record a
    timing event on its current stream with the host time just before:
    :func:`spans` turns it into ``mark_ns`` (that host time) and
    ``device_ns`` (when the card reached the event, on the host clock)."""
    rec = _buffer[index]
    if attrs:
        rec[5] = dict(rec[5] or {}, **attrs)
    device = torch.device(device)
    if device.type == "cuda":
        event = torch.cuda.Event(enable_timing=True)
        host = time.time_ns()
        event.record(torch.cuda.current_stream(device))
        _markers.append((index, event, host, device))


class _Chunk:
    __slots__ = ("index", "name", "prev", "span")

    def __init__(self, index, name):
        self.index, self.name = index, name

    def __enter__(self):
        global ON, _chunk, _profiled
        self.prev = (ON, _chunk)
        if _mode is None and not _stack:
            profiled = torch._C._autograd._profiler_enabled()
            if profiled and not _profiled:
                # a profiler session began: the buffer holds its spans
                reset()
            _profiled = ON = profiled
        _chunk = self.index
        self.span = begin(self.name) if ON else None

    def __exit__(self, *exc):
        global ON, _chunk
        end(self.span)
        ON, _chunk = self.prev
        return False


def chunk(index, name="hmc.chunk"):
    """The context of one sampler chunk ``index``: it reads once whether
    a profiler session is active (tracing follows it unless
    :func:`enable` said otherwise), gives the spans inside it its index
    and records span ``name`` around it."""
    return _Chunk(index, name)


def _resolve_markers():
    """Each marker's card time on the host clock: after a synchronise, one
    final event (created beforehand) is recorded on the idle card just
    after a host reading, and each marker lies ``elapsed_time`` before
    it."""
    by_device = defaultdict(list)
    for index, event, host, device in _markers:
        by_device[device].append((index, event, host))
    _markers.clear()
    for device, marks in by_device.items():
        stream = torch.cuda.current_stream(device)
        final = torch.cuda.Event(enable_timing=True)
        final.record(stream)
        torch.cuda.synchronize(device)
        host_final = time.time_ns()
        final.record(stream)
        final.synchronize()
        for index, event, host in marks:
            rec = _buffer[index]
            ms = event.elapsed_time(final)
            rec[5] = dict(rec[5] or {}, mark_ns=host,
                          device_ns=host_final - round(ms * 1e6))


def spans():
    """The recorded spans, in the order they opened (:class:`Span`), with
    the iteration markers resolved to the host clock (once, after the
    work: this synchronises the card)."""
    if _markers:
        _resolve_markers()
    return [Span(*rec) for rec in _buffer]


def counters():
    """The hand-written kernels' launch counts (``launch_counts()`` of
    ``ops._cuda``) and the spans the full buffer dropped."""
    from .ops._cuda import launch_counts

    return {"launches": launch_counts(), "spans_dropped": _dropped}


def _chrome_events(closed, base_ns):
    """The spans ``closed`` as Chrome trace complete events on a trace
    whose ``ts`` counts microseconds from ``base_ns``, on a row of their
    own in this process."""
    pid, tid = os.getpid(), 0
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": "program spans"}}]
    for s in closed:
        args = {"chunk": s.chunk, **(s.attrs or {})}
        out.append({"ph": "X", "cat": "program_span", "name": s.name,
                    "pid": pid, "tid": tid,
                    "ts": (s.start_ns - base_ns) / 1e3,
                    "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    return out


@contextlib.contextmanager
def device_trace(logdir=None):
    """Trace a block of work with ``torch.profiler`` (CPU activities, and
    CUDA ones when a card is present) and write it as a Chrome trace
    (``chrome://tracing``, Perfetto) to ``<logdir>/trace.json``; yields
    that path, which holds the trace once the block has ended. The
    program spans recorded in the block go into it as complete events
    (category ``program_span``) on the trace's own time base
    (``baseTimeNanoseconds``). ``logdir`` defaults to ``torch-trace`` in
    the temporary directory."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    t0 = time.time_ns()
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    closed = [s for s in spans() if s.start_ns >= t0
              and s.end_ns is not None]
    if closed:
        with open(path) as f:
            trace = json.load(f)
        trace["traceEvents"] += _chrome_events(
            closed, int(trace.get("baseTimeNanoseconds", 0)))
        with open(path, "w") as f:
            json.dump(trace, f, default=str)


# ------------------------------------------------------- trace reductions

def device_intervals(prof):
    """(name, start_us, end_us) of every kernel or copy the profiler saw
    on a GPU; the device-side copies of user annotations
    (``record_function`` ranges) are not operations and are left out."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)]


def ms_by_name(intervals):
    """``[name, ms, count]`` of ``(name, start_us, end_us)`` intervals,
    the longest first."""
    out = {}
    for name, a, b in intervals:
        ms, n = out.get(name, (0.0, 0))
        out[name] = (ms + (b - a) / 1e3, n + 1)
    return sorted(([k, ms, n] for k, (ms, n) in out.items()),
                  key=lambda r: -r[1])


def is_port_kernel(name):
    """Whether a device operation's name is one of the port's hand-written
    kernels (``csrc/*.cu``, all in an anonymous namespace at the top, some
    templates printed with ``void`` first); PyTorch's own kernels sit in
    anonymous namespaces under ``at::``."""
    return name.removeprefix("void ").startswith("(anonymous namespace)::")


def _merged(intervals):
    """The union of ``(start, end)`` pairs as sorted disjoint pairs."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def union_us(intervals):
    """The length of the union of ``(name, start, end)`` intervals."""
    return sum(b - a for a, b in _merged([(a, b) for _, a, b in intervals]))


def host_self_by_span(closed):
    """``{name: (self_ns, count)}`` of ``closed`` (:class:`Span`s of one
    buffer, in order): each span's time less its direct children's."""
    child = defaultdict(int)
    for s in closed:
        child[s.parent] += s.end_ns - s.start_ns
    out = {}
    for i, s in enumerate(closed):
        t, n = out.get(s.name, (0, 0))
        out[s.name] = (t + s.end_ns - s.start_ns - child.get(i, 0), n + 1)
    return out


def idle_by_span(busy, closed):
    """``{name: idle_ns}``: the stretches of the longest span of
    ``closed`` in which the device was not busy (``busy``: (start_ns,
    end_ns) pairs of its operations), each under the innermost span that
    holds its midpoint (spans nest, as one thread records them)."""
    if not closed:
        return {}
    outer = max(closed, key=lambda s: s.end_ns - s.start_ns)
    lo, hi = outer.start_ns, outer.end_ns
    gaps, at = [], lo
    for a, b in _merged(busy):
        if b <= lo or a >= hi:
            continue
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if at < hi:
        gaps.append((at, hi))
    # sweep the midpoints in order against the spans' opens and closes
    edges = sorted([(s.start_ns, 1, i) for i, s in enumerate(closed)]
                   + [(s.end_ns, 0, i) for i, s in enumerate(closed)])
    out, stack, k = {}, [], 0
    for a, b in gaps:
        mid = 0.5 * (a + b)
        while k < len(edges) and edges[k][0] <= mid:
            _, opens, i = edges[k]
            if opens:
                stack.append(i)
            elif i in stack:
                del stack[stack.index(i):]
            k += 1
        name = closed[stack[-1]].name if stack else "outside"
        out[name] = out.get(name, 0) + (b - a)
    return out


def _trace_start_ns(prof):
    """The profiler's time base: event times count microseconds from it
    (None where this PyTorch does not expose it)."""
    try:
        return int(prof.profiler.kineto_results.trace_start_ns())
    except AttributeError:
        return None


def profile_run(run_chunk, carry, seed, device, chunk_idx=1):
    """Chunk ``chunk_idx`` of ``run_chunk`` under ``torch.profiler`` after
    a warm chunk 0: ``(summary, profiler)`` with the host wall time, the
    device busy time, device time by kernel, the wrappers' launches, the
    host's self time by program span (``host_ms_by_span``: name, ms,
    count) and the device's idle time inside the chunk by the innermost
    program span the host was in (``idle_ms_by_span``; None without a
    card)."""
    from torch.profiler import ProfilerActivity, profile

    from . import _device
    from .ops import leapfrog

    device = torch.device(device)
    carry, _ = run_chunk(carry, seed, 0)
    _device.sync(device)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    leapfrog.reset_launch_counts()
    t_ns = time.time_ns()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        carry, stats = run_chunk(carry, seed, chunk_idx)
        _device.sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = leapfrog.launch_counts()
    dev = device_intervals(prof)
    by_kernel = ms_by_name(dev)
    busy_ms = union_us(dev) / 1e3 if dev else None
    # device time by owner: the port's kernels, device-to-device copies,
    # and PyTorch's own kernels (the eager ops around them)
    owners = dict.fromkeys(("port", "memcpy", "torch"), 0.0)
    for name, ms, _ in by_kernel:
        owners["port" if is_port_kernel(name) else
               "memcpy" if name.startswith("Memcpy") else "torch"] += ms
    # the chunk's spans (the buffer's last ones), indexed among themselves
    every = spans()
    first = next((i for i, s in enumerate(every) if s.start_ns >= t_ns),
                 len(every))
    closed = [s._replace(parent=s.parent - first if s.parent >= first
                         else -1) for s in every[first:]]
    host = host_self_by_span(closed)
    start = _trace_start_ns(prof)
    idle = None
    if dev and start is not None:
        idle = idle_by_span([(start + a * 1e3, start + b * 1e3)
                             for _, a, b in dev], closed)
    return {
        "iterations": stats.shape[0], "chains": stats.shape[1],
        "steps": int(stats[:, 0, 4].sum().item()),
        # potential evaluations of the chain batch: an iteration runs to
        # its longest L (all of them equal under a shared L)
        "batch_steps": int(stats[..., 4].max(dim=1).values.sum().item()),
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "busy_share": None if busy_ms is None else busy_ms / wall_ms,
        "device_ms_by_owner": owners if busy_ms else None,
        "share_of_busy_by_owner": ({k: v / busy_ms for k, v in owners.items()}
                                   if busy_ms else None),
        "launches": launches,
        "by_kernel": by_kernel,
        "host_ms_by_span": sorted(([k, t / 1e6, n] for k, (t, n)
                                   in host.items()), key=lambda r: -r[1]),
        "idle_ms_by_span": (None if idle is None else sorted(
            ([k, t / 1e6] for k, t in idle.items()), key=lambda r: -r[1])),
    }, prof


# ------------------------------------------------------------------ memory

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
