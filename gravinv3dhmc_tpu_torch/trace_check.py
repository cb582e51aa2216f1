"""The program's spans on the card: what they cost and whether their clock
is the profiler's.

On the bench's 600 x 6000 uniformgrid problem at 1024 chains, shared L in
[5, 20], through the fused iteration op (:func:`~.uniformgrid.
slice_sampler`; ``--matvec float32`` for the f32 matrix), each check
prints one JSON line:

* ``issue``: the host's seconds to issue one chunk of ``--chunk``
  iterations queued behind a spin of the card (``torch.cuda._sleep``), so
  the host never waits for the card, with Python's collector kept out of
  the timed chunk; ``spinning`` says the card was still
  in the spin when the chunk's last launch returned (else the launch queue
  was full and the time holds a wait). With tracing off, and on
  (:func:`~.profiling.enable`) where the program has spans; median of
  ``--chunks`` chunks after two warm ones, the same chunk indices in every
  run. It uses only entry points that earlier versions of the package
  have, so the same file measures another checkout's package.
* ``events``: the CUDA-typed events of ``torch.profiler`` for one chunk
  with the program's tracing off and on (same seed, same chunk index):
  the spans add none.
* ``clock``: one chunk in :func:`~.profiling.device_trace`: each
  hand-written kernel on the device (:func:`~.profiling.is_port_kernel`)
  is matched to its host launch by the trace's correlation id,
  the launch to the ``kernel.<name>`` span that holds it, and the kernel
  starts on the device no earlier than that span began.
* ``lead``: the first iteration's lead (``device_ns - mark_ns`` of its
  ``hmc.iteration`` span) issued behind a spin of known length (expected:
  the card's time from the spin's start to the marker, by CUDA events,
  less the host's from the spin's issue to the marker) and issued to an
  idle card (about zero).

``python -m gravinv3dhmc_tpu_torch.trace_check [issue events clock lead]
[--chunk 8] [--chunks 7] [--matvec bfloat16] [--out PATH]`` prints the
card's name and power limit first; it needs a card.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import tempfile
import time

import torch

from . import _device, profiling, uniformgrid

CHECKS = ("issue", "events", "clock", "lead")
#: the spin ahead of an issued chunk, in clock cycles a chunk iteration
#: (10 ms at 2 GHz, several times the host's issue of one iteration)
SPIN_CYCLES_PER_ITERATION = 20_000_000


def _sampler(problem, device, matvec, chunk, seed=0):
    chain = uniformgrid.slice_sampler(*problem, device, seed=seed,
                                      matvec=matvec, chunk=chunk)
    return chain.prepare(nsamples=chunk, ndraws=0)


def issue(problem, device, matvec, chunk, chunks, traced=False):
    """``{seconds, spinning}``: the host's seconds to issue each of
    ``chunks`` chunks (indices 2, 3, ...) behind a spin, after two warm
    ones; ``traced`` turns the program's tracing on for them."""
    run_chunk, carry = _sampler(problem, device, matvec, chunk)
    for k in range(2):
        carry, _ = run_chunk(carry, 0, k)
    torch.cuda.synchronize(device)
    done = torch.cuda.Event()
    seconds, spinning = [], []
    if traced:
        profiling.enable()
    try:
        for k in range(2, 2 + chunks):
            # the collector runs between the timed chunks, not in them
            gc.collect()
            gc.disable()
            torch.cuda._sleep(SPIN_CYCLES_PER_ITERATION * chunk)
            done.record()
            t0 = time.perf_counter()
            carry, _ = run_chunk(carry, 0, k)
            seconds.append(time.perf_counter() - t0)
            spinning.append(not done.query())
            gc.enable()
            torch.cuda.synchronize(device)
            if traced:
                profiling.reset()
    finally:
        gc.enable()
        if traced:
            profiling.enable(None)
    return {"seconds": seconds, "median_s": statistics.median(seconds),
            "spinning": all(spinning)}


def events(problem, device, matvec, chunk):
    """CUDA-typed profiler events of chunk 1 with the program's tracing
    off and on, from the same carry after a warm chunk 0."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    run_chunk, carry = _sampler(problem, device, matvec, chunk)
    carry, _ = run_chunk(carry, 0, 0)
    out = {}
    for name, mode in (("off", False), ("on", None)):
        profiling.enable(mode)
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run_chunk(carry, 0, 1)
            torch.cuda.synchronize(device)
        evs = prof.events()
        out[name] = {"cuda_events": sum(e.device_type == cuda for e in evs),
                     "device_intervals": len(profiling.device_intervals(
                         prof)),
                     "spans": len(profiling.spans())}
    profiling.enable(None)
    out["equal"] = out["off"]["cuda_events"] == out["on"]["cuda_events"]
    return out


def clock(problem, device, matvec, chunk):
    """Each hand-written kernel of one traced chunk against the
    ``kernel.<name>`` span that holds its host launch, on the Chrome
    trace's time base."""
    run_chunk, carry = _sampler(problem, device, matvec, chunk)
    carry, _ = run_chunk(carry, 0, 0)
    torch.cuda.synchronize(device)
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.device_trace(tmp) as path:
            run_chunk(carry, 0, 1)
        with open(path) as f:
            trace = json.load(f)
    evs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in evs
                    if e.get("cat") == "program_span"
                    and e["name"].startswith("kernel.")))
    launches = {}
    for e in evs:
        if e.get("cat") == "cuda_runtime" and "Launch" in e["name"]:
            launches[e.get("args", {}).get("correlation")] = e["ts"]
    kernels = [e for e in evs if e.get("cat") == "kernel"
               and profiling.is_port_kernel(e["name"])]
    starts = [a for a, _, _ in spans]
    margins, unmatched, outside = [], {}, {}
    for k in kernels:
        name = k["name"].split("::", 1)[1].split("(")[0]
        t = launches.get(k.get("args", {}).get("correlation"))
        if t is None:
            unmatched[name] = unmatched.get(name, 0) + 1
            continue
        # the latest kernel span that began at or before the launch
        lo, hi = 0, len(starts)
        while lo < hi:
            mid = (lo + hi) // 2
            if starts[mid] <= t:
                lo = mid + 1
            else:
                hi = mid
        if lo == 0 or spans[lo - 1][1] < t:
            # the launch outside every kernel span: how far past the
            # latest one's end, and which span that was
            past = t - spans[lo - 1][1] if lo else None
            n, worst, by = outside.get(name, (0, None, spans[lo - 1][2]
                                              if lo else None))
            outside[name] = (n + 1, past if worst is None or (
                past is not None and past > worst) else worst, by)
            continue
        margins.append(k["ts"] - spans[lo - 1][0])
    return {"base_ns": trace.get("baseTimeNanoseconds"),
            "kernel_spans": len(spans), "port_kernels": len(kernels),
            "matched": len(margins), "no_launch_event": unmatched,
            "launch_outside_spans": outside,
            "before_span": sum(m < 0 for m in margins),
            "min_margin_us": min(margins) if margins else None,
            "median_margin_us": (statistics.median(margins) if margins
                                 else None)}


def lead(problem, device, matvec, spin_ms=20.0):
    """The first iteration's lead issued behind a spin of about
    ``spin_ms`` (its expected lead: the card's time from the spin's start
    to the iteration's marker less the host's from the spin's issue to
    the marker) and issued to an idle card."""
    run_chunk, carry = _sampler(problem, device, matvec, 4)
    carry, _ = run_chunk(carry, 0, 0)
    out = {}
    profiling.enable()
    try:
        for name, spin in (("behind_spin", True), ("idle", False)):
            torch.cuda.synchronize(device)
            profiling.reset()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            b.record()
            torch.cuda.synchronize(device)
            t_spin = time.time_ns()
            if spin:
                a.record()
                torch.cuda._sleep(int(spin_ms * 2e6))
                b.record()
            carry, _ = run_chunk(carry, 0, 1)
            # the first iteration's marker, before spans() resolves it
            marker = profiling._markers[0][1]
            first = next(s for s in profiling.spans()
                         if s.name == "hmc.iteration")
            got = (first.attrs["device_ns"] - first.attrs["mark_ns"]) * 1e-6
            line = {"lead_ms": got}
            if spin:
                # the card's time from the spin's start to the marker
                # (the spin, then the chunk's padded copies), less the
                # host's from the spin's issue to the marker
                to_marker = a.elapsed_time(marker)
                want = to_marker - (first.attrs["mark_ns"] - t_spin) * 1e-6
                line.update(spin_ms=a.elapsed_time(b), to_marker_ms=to_marker,
                            expected_ms=want, error_ms=got - want)
            out[name] = line
    finally:
        profiling.enable(None)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checks", nargs="*", metavar="{issue,events,clock,lead}")
    ap.add_argument("--chunk", type=int, default=8,
                    help="iterations of an issued, counted or traced chunk")
    ap.add_argument("--chunks", type=int, default=7,
                    help="issued chunks timed, after two warm ones")
    ap.add_argument("--matvec", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--out", help="append the lines to this file")
    args = ap.parse_args(argv)
    checks = args.checks or list(CHECKS)
    if not set(checks) <= set(CHECKS):
        ap.error(f"choose checks from {CHECKS}")
    if not torch.cuda.is_available():
        raise SystemExit("trace_check: CUDA is not available")
    dev = torch.device("cuda", 0)
    card = _device.card()
    print(card, flush=True)
    matvec = getattr(torch, args.matvec)
    problem = uniformgrid.build_problem(device=dev)
    has_spans = hasattr(profiling, "spans")
    for name in checks:
        if name == "issue":
            res = {"off": issue(problem, dev, matvec, args.chunk,
                                args.chunks)}
            if has_spans:
                res["on"] = issue(problem, dev, matvec, args.chunk,
                                  args.chunks, traced=True)
        elif not has_spans:
            continue
        elif name == "events":
            res = events(problem, dev, matvec, args.chunk)
        elif name == "clock":
            res = clock(problem, dev, matvec, args.chunk)
        else:
            res = lead(problem, dev, matvec)
        line = json.dumps({"check": name, "card": card, "pid": os.getpid(),
                           "matvec": args.matvec, "chunk": args.chunk,
                           "torch": torch.__version__, **res})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
