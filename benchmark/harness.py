"""The harness: finds a cell's parts by name, times its set-up, runs its
window, reads its metrics, checks its outputs and prints the result line.

Everything that belongs to one configuration, traffic mix or metric lives
in a file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``benchmark/configs/<config>.json`` (the path in ``configs[].file``):
  the deployment's sizes and the name of its ``problem`` builder
  (``benchmark/problems/<problem>.py``);
* ``benchmark/traffic/<traffic>.json``: the run's parameters and the
  name of its ``driver`` (``benchmark/drivers/<driver>.py``), which
  drives the program through its public entry points;
* ``benchmark/metrics/<metric>.py``: a reader ``read(record)`` that takes
  one number from the run's record, or None when the run has nothing for
  it (the metric is then left out of the line).

A file is looked for under the checkout given as ``root`` first, then
beside this module, so a new part is a new file and nothing else.

The record a driver fills (all counts are exact, all times seconds):
``window_s``, ``work`` (the end-to-end rate's numerator), ``units``
(useful steps or iterations), ``batch_steps``, ``least_s`` (a unit's
least time, :mod:`.roofline`), ``accepts``/``proposals``, ``ess``,
``build_s``; a traced run adds ``prof_busy_s``, ``prof_wall_s``,
``prof_units``, ``prof_batch_steps`` and ``prof_launches``.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names a run may not load, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "gravinv3dhmc_tpu")
#: the prefix of the harness's own profiler spans
SPAN = "bench:"


def forbidden_modules(names=None):
    """The top-level names among ``names`` (``sys.modules`` by default)
    that are in :data:`FORBIDDEN`, each compared whole: the port's
    ``gravinv3dhmc_tpu_torch`` is not ``gravinv3dhmc_tpu``."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _part(root, kind, name, suffix):
    """The file of part ``name`` of ``kind`` (configs, traffic, metrics,
    drivers, problems): under ``root``'s benchmark/ first, then here."""
    for base in (Path(root) / "benchmark", HERE):
        path = base / kind / f"{name}{suffix}"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no {kind} part named {name!r} (looked for "
                            f"benchmark/{kind}/{name}{suffix})")


def load_code(root, kind, name):
    """The module of part ``name`` of ``kind``, loaded from its file."""
    path = _part(root, kind, name, ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(root, workload):
    """``(cell, config, traffic, end_to_end, per_layer)`` of ``workload``
    in ``root``'s BENCHMARK.json: the cell's entry, its configuration and
    traffic (dicts) and the metric entries it reports."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads(_part(root, "traffic", cell["traffic"],
                               ".json").read_text())

    def reported(m, e2e_names):
        if "workloads" in m:
            return workload in m["workloads"]
        return m.get("moves") in e2e_names if e2e_names else True

    e2e = [m for m in bench["end_to_end"] if reported(m, None)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reported(m, names)]
    return cell, config, traffic, e2e, per_layer


class Context:
    """What a driver is given: the cell's parts, the seed, the device,
    the phase clock and the record it fills."""

    def __init__(self, root, cell, config, traffic, seed, seconds, trace,
                 device, control=False, t_start=None):
        self.root = Path(root)
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.trace = int(seed), seconds, trace
        self.device = device
        self.control = control
        self.record = {}
        self.phases = []
        self._last = time.perf_counter() if t_start is None else t_start
        self._t_start = self._last

    def sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark(self, phase):
        """End set-up phase ``phase``: synchronise, then log its seconds."""
        self.sync()
        now = time.perf_counter()
        self.phases.append((phase, now - self._last))
        log(f"[setup] {phase}: {now - self._last:.4f} s")
        self._last = now

    @property
    def setup_s(self):
        return self._last - self._t_start

    def problem(self):
        """The configuration's problem builder module."""
        return load_code(self.root, "problems", self.config["problem"])


@contextlib.contextmanager
def span(name):
    """A harness span in the profiler's trace (a no-op cost otherwise)."""
    import torch
    with torch.profiler.record_function(SPAN + name):
        yield


def profile_stretch(ctx, fn):
    """Run ``fn()`` (which returns the stretch's ``(units, batch_steps)``)
    under ``torch.profiler`` and reduce its trace: the device's busy
    seconds (union of the intervals of every device operation), the
    stretch's wall seconds to a synchronise, the operations launched, and
    the breakdown: the ten device operations of most time and the ten
    longest idle stretches summed by the harness span the host was in."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if ctx.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    ctx.sync()
    with profile(activities=acts) as prof:
        with span("stretch"):
            t0 = time.perf_counter()
            units, batch_steps = fn()
            ctx.sync()
            wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.events():
        if e.name.startswith(SPAN):
            # a harness span: on the host, and its copy on the device's
            # timeline (a user annotation, not an operation)
            if e.device_type != cuda:
                host.append((e.name[len(SPAN):], e.time_range.start,
                             e.time_range.end))
        elif e.device_type == cuda:
            dev.append((e.name, e.time_range.start, e.time_range.end))
    rec = ctx.record
    rec.update(prof_wall_s=wall, prof_units=units,
               prof_batch_steps=batch_steps, prof_launches=len(dev))
    if not dev:
        return
    busy_us, gaps = busy_and_gaps(dev, host)
    rec["prof_busy_s"] = busy_us * 1e-6
    by_op = {}
    for name, a, b in dev:
        by_op[name] = by_op.get(name, 0.0) + (b - a) * 1e-6
    rec["breakdown"] = {
        "device_ops": [[n[:64], s] for n, s in
                       sorted(by_op.items(), key=lambda t: -t[1])[:10]],
        "idle_gaps": [[n, s] for n, s in
                      sorted(gaps.items(), key=lambda t: -t[1])[:10]]}


def busy_and_gaps(dev, host):
    """Busy microseconds of the device intervals ``dev`` ((name, start,
    end) each) and the idle seconds between them inside the outermost
    host span, summed by the innermost host span that holds each idle
    stretch's midpoint."""
    busy, end, merged = 0.0, None, []
    for _, a, b in sorted(dev, key=lambda t: t[1]):
        if end is not None and b <= end:
            continue
        start = a if end is None else max(a, end)
        busy += b - start
        if merged and a <= merged[-1][1]:
            merged[-1][1] = b
        else:
            merged.append([a, b])
        end = b
    outer = max(host, key=lambda t: t[2] - t[1]) if host else None
    edges = [outer[1]] if outer else []
    for a, b in merged:
        edges += [a, b]
    if outer:
        edges.append(outer[2])
    gaps = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        holders = [h for h in host if h[1] <= mid <= h[2]]
        name = (min(holders, key=lambda t: t[2] - t[1])[0] if holders
                else "outside")
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    return busy, gaps


def card_line():
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    None where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def read_metrics(root, entries, record):
    """``{name: {"value", "unit"}}`` of the metric entries whose reader
    finds something in ``record``."""
    out = {}
    for m in entries:
        value = load_code(root, "metrics", m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(root, workload, seed, seconds, trace, device=None,
             control=False, t_start=None, config_override=None,
             traffic_override=None, fault=None):
    """One run of ``workload``: set-up, window, (traced stretch), check.
    Returns the result line's dict with ``checks`` last. ``device`` is
    ``cuda:0`` by default; the tests pass ``"cpu"`` and small
    configurations (``config_override``/``traffic_override`` update the
    files' dicts) and plant faults (``fault(state)``, applied to the
    driver's state after set-up)."""
    import torch

    cell, config, traffic, e2e, per_layer = find_cell(root, workload)
    config = dict(config, **(config_override or {}))
    traffic = dict(traffic, **(traffic_override or {}))
    device = torch.device(device or "cuda:0")
    ctx = Context(root, cell, config, traffic, seed, seconds, trace, device,
                  control=control, t_start=t_start)
    driver = load_code(root, "drivers", traffic["driver"])
    state = driver.setup(ctx)
    if fault is not None:
        fault(state)
    rec = ctx.record
    rec["setup_s"] = ctx.setup_s
    rec["phases"] = dict(ctx.phases)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    driver.window(ctx, state, seconds)
    if trace:
        profile_stretch(ctx, lambda: driver.stretch(ctx, state))
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    checks = driver.check(ctx, state)
    del state
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = read_metrics(root, per_layer if trace else e2e, rec)
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": 1, "memory_peak_bytes": int(peak)}
    if trace and "prof_busy_s" in rec:
        info.update(busy_s=rec["prof_busy_s"], window_s=rec["prof_wall_s"])
    line = {"correct": bool(correct), "attempted": int(rec["attempted"]),
            "failed": int(rec["failed"]), "metrics": metrics,
            "device": info}
    if trace and "breakdown" in rec:
        line["breakdown"] = rec["breakdown"]
    line["checks"] = checks
    return line
