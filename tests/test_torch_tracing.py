"""The program's spans (``gravinv3dhmc_tpu_torch/profiling.py``) over a
tiny fused ``run_chunk`` on the CPU, through the kernels' plain versions:
off they record nothing and read no clock; a ``torch.profiler`` session
turns them on by itself and adds nothing to its event list; they nest,
share the profiler's clock, go into ``device_trace``'s Chrome trace and
stay within their bound. Also the trace reductions of ``profile_run``."""
import json
import time
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gravinv3dhmc_tpu_torch import profiling, uniformgrid

torch.set_num_threads(2)

CHUNK = 3


@pytest.fixture(autouse=True)
def fresh():
    profiling.enable(None)
    profiling.reset()
    yield
    profiling.enable(None)
    profiling.reset()


@pytest.fixture(scope="module")
def sampler():
    """``(run_chunk, carry)`` of the fused iteration op at 8 chains x 384
    cells, chunks of :data:`CHUNK` iterations."""
    module, dobs = uniformgrid.build_problem(8, 12, 4, device="cpu")
    chain = uniformgrid.sampler(module, dobs, "cpu", 8, CHUNK, 0.01, (2, 4),
                                0.001, 0.001, torch.bfloat16, seed=2)
    run_chunk, carry = chain.prepare(nsamples=CHUNK, ndraws=0)
    assert chain._fused_mode == "iteration(bfloat16)"
    return run_chunk, carry


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_records_nothing_and_reads_no_clock(sampler, monkeypatch):
    run_chunk, carry = sampler

    def no_clock():
        raise AssertionError("a clock was read with tracing off")

    monkeypatch.setattr(time, "time_ns", no_clock)
    run_chunk(carry, 7, 1)
    with profiling.span("outside"):
        pass
    assert not profiling.ON
    assert profiling.spans() == []
    assert profiling.counters()["spans_dropped"] == 0


def test_the_profiler_turns_tracing_on_and_off(sampler):
    run_chunk, carry = sampler
    with _cpu_profile():
        run_chunk(carry, 7, 1)
        assert not profiling.ON        # on only inside the chunk
    names = [s.name for s in profiling.spans()]
    assert names[0] == "hmc.chunk" and names.count("hmc.iteration") == CHUNK
    n = len(names)
    run_chunk(carry, 7, 2)             # the session has ended
    assert len(profiling.spans()) == n
    with _cpu_profile():               # a new session starts afresh
        run_chunk(carry, 7, 3)
    assert {s.chunk for s in profiling.spans()} == {3}
    profiling.enable(False)            # off, even under a profiler
    with _cpu_profile():
        run_chunk(carry, 7, 4)
    assert {s.chunk for s in profiling.spans()} == {3}


def test_spans_nest_with_parents_and_chunk_indices(sampler):
    run_chunk, carry = sampler
    def chunks_timed():
        return profiling.timers.summary().get("hmc.chunk", {}).get("count",
                                                                   0)

    before = chunks_timed()
    profiling.enable()
    _, stats = run_chunk(carry, 7, 5)
    profiling.enable(None)
    spans = profiling.spans()
    assert all(s.chunk == 5 and s.end_ns >= s.start_ns for s in spans)
    for s in spans:
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert (spans[0].name, spans[0].parent) == ("hmc.chunk", -1)
    assert (spans[1].name, spans[1].parent) == ("hmc.lengths", 0)
    its = [i for i, s in enumerate(spans) if s.name == "hmc.iteration"]
    assert [spans[i].parent for i in its] == [0] * CHUNK
    # each iteration: refresh, L x (drift, residual, kick), traj_finish,
    # accept, then the store; its batch steps are its L
    for k, i in enumerate(its):
        L = int(stats[k, 0, 4])
        assert spans[i].attrs == {"steps": L}
        inner = [s.name for s in spans if s.parent == i]
        assert inner == (["kernel.refresh"]
                         + ["kernel.drift", "kernel.residual",
                            "kernel.kick"] * L
                         + ["kernel.traj_finish", "kernel.accept",
                            "hmc.store"])
    assert chunks_timed() == before + 1     # the spans reach the timers
    c = profiling.counters()
    assert c["spans_dropped"] == 0 and set(c["launches"]) >= {
        "refresh", "drift", "residual", "kick", "traj_finish", "accept"}


def test_spans_share_the_profilers_clock():
    """An ``aten::mm`` issued inside a span lies inside the span's
    interval among the profiler's events, once the trace's start is taken
    off the span's ``time.time_ns()`` stamps."""
    a = torch.randn(128, 128)
    profiling.enable()
    with _cpu_profile() as prof:
        with profiling.span("outer", tag=1) as index:
            a @ a
    s = profiling.spans()[index]
    assert s.attrs == {"tag": 1}
    start = prof.profiler.kineto_results.trace_start_ns()
    mm = [e for e in prof.events() if e.name == "aten::mm"]
    assert mm
    for e in mm:
        assert (s.start_ns - start) / 1e3 <= e.time_range.start
        assert e.time_range.end <= (s.end_ns - start) / 1e3


def test_the_profilers_event_list_holds_no_program_span(sampler):
    run_chunk, carry = sampler
    with _cpu_profile() as prof:
        run_chunk(carry, 7, 1)
    ours = {s.name for s in profiling.spans()}
    assert {"hmc.chunk", "hmc.iteration", "kernel.kick"} <= ours
    assert not ours & {e.name for e in prof.events()}


def test_device_trace_writes_the_spans_on_its_time_base(sampler,
                                                         tmp_path):
    run_chunk, carry = sampler
    with profiling.device_trace(str(tmp_path)) as path:
        run_chunk(carry, 7, 1)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ours = [e for e in events if e.get("cat") == "program_span"]
    assert len(ours) == len(profiling.spans())
    chunk = next(e for e in ours if e["name"] == "hmc.chunk")
    assert chunk["args"]["chunk"] == 1
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("name", "").startswith("aten::")]
    assert ops
    for e in ops:     # every operation of the block ran inside the chunk
        assert chunk["ts"] - 1 <= e["ts"]
        assert e["ts"] + e["dur"] <= chunk["ts"] + chunk["dur"] + 1
    residual = [e for e in ours if e["name"] == "kernel.residual"]
    mm = [e for e in ops if e["name"] == "aten::mm"]
    assert any(r["ts"] <= m["ts"] and m["ts"] + m["dur"]
               <= r["ts"] + r["dur"] for r in residual for m in mm)


def test_the_bounded_buffer_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 5)
    profiling.enable()
    with profiling.span("outer"):
        for _ in range(7):
            with profiling.span("inner") as index:
                pass
    assert index is None
    spans = profiling.spans()
    assert [s.name for s in spans] == ["outer"] + ["inner"] * 4
    assert [s.parent for s in spans] == [-1] + [0] * 4
    assert profiling.counters()["spans_dropped"] == 3
    profiling.reset()
    assert profiling.counters()["spans_dropped"] == 0


def test_an_exception_closes_the_spans_it_leaves():
    profiling.enable()
    with pytest.raises(RuntimeError):
        with profiling.span("outer"):
            profiling.begin("left open")
            raise RuntimeError("through")
    assert all(s.end_ns is not None for s in profiling.spans())
    with profiling.span("next"):
        pass
    assert profiling.spans()[-1].parent == -1


def _span(name, a, b, parent=-1):
    return profiling.Span(name, a, b, parent, 0, None)


def test_host_self_time_and_idle_by_innermost_span():
    closed = [_span("chunk", 0, 100), _span("it", 10, 60, 0),
              _span("kernel.k", 20, 30, 1), _span("store", 70, 90, 0)]
    host = profiling.host_self_by_span(closed)
    assert host == {"chunk": (100 - 50 - 20, 1), "it": (50 - 10, 1),
                    "kernel.k": (10, 1), "store": (20, 1)}
    # busy [0, 22] and [28, 75]: idle [22, 28] (midpoint 25, in the
    # kernel's issue) and [75, 100] (midpoint 87.5, in the store)
    idle = profiling.idle_by_span([(0, 22), (28, 40), (35, 75)], closed)
    assert idle == {"kernel.k": 6, "store": 25}
    assert profiling.idle_by_span([], []) == {}


def test_device_intervals_leave_out_user_annotations():
    cuda, cpu = (torch.autograd.DeviceType.CUDA,
                 torch.autograd.DeviceType.CPU)

    def ev(name, dev, a, b, note=False):
        return SimpleNamespace(name=name, device_type=dev,
                               time_range=SimpleNamespace(start=a, end=b),
                               is_user_annotation=note)

    prof = SimpleNamespace(events=lambda: [
        ev("kick", cuda, 0, 5), ev("bench:chunk_issue", cuda, 0, 50, True),
        ev("aten::mm", cpu, 0, 9), ev("drift", cuda, 4, 8)])
    got = profiling.device_intervals(prof)
    assert got == [("kick", 0, 5), ("drift", 4, 8)]
    assert profiling.union_us(got) == 8
    assert profiling.ms_by_name(got + [("drift", 9, 12)]) == [
        ["drift", 0.007, 2], ["kick", 0.005, 1]]


@pytest.mark.parametrize("name, ours", [
    ("(anonymous namespace)::kick_tc_kernel(CUtensorMap_st, float*)", True),
    ("void (anonymous namespace)::accept_kernel<256, 1, 4>(float*)", True),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>",
     False),
    ("void at::native::elementwise_kernel<128, 2>(int)", False),
    ("Memcpy DtoD (Device -> Device)", False)])
def test_the_ports_kernels_by_name(name, ours):
    assert profiling.is_port_kernel(name) is ours


def _warmup_chain():
    """The realdata stand-in's sampler at a 3-degree step (299 cells), 8
    chains, chunks of 4, a windowed warmup of 8 chunks."""
    from gravinv3dhmc_tpu_torch import realdata
    module, dobs = realdata.build_problem("cpu", step=3.0)
    return realdata.slice_sampler(module, dobs, "cpu", nchains=8, chunk=4,
                                  adapt_chunks=8, Lrange=(3, 6))


def _warmup_counts(chain, frozen):
    from gravinv3dhmc_tpu_torch.inversion.hmc import warmup_schedule
    W, _, switches = warmup_schedule(chain.adapt_chunks,
                                     chain.adapt_step_size, chain.adapt_mass)
    assert frozen.n_chunks == W
    return {"adapt_chunks": W, "metric_switches": len(switches),
            "adapt_grad_evals": frozen.grad_evals}


@pytest.mark.parametrize("on", [True, False])
def test_the_warmup_has_its_spans_and_counters(on):
    """``hmc.adapt`` (carrying its chunks) around the warmup's chunks and
    ``hmc.freeze`` inside it, once each; the counters equal the schedule's
    chunks and switches and the warmup's gradient evaluations, counted
    whether tracing is on or off; off, no span is recorded."""
    chain = _warmup_chain()
    profiling.enable(on)
    frozen = chain.adapt(4, 0)
    spans = profiling.spans()
    counts = profiling.counters()
    want = _warmup_counts(chain, frozen)
    assert {k: counts[k] for k in want} == want
    assert frozen.grad_evals > 0
    if not on:
        assert spans == []
        return
    names = [s.name for s in spans]
    assert names.count("hmc.adapt") == names.count("hmc.freeze") == 1
    adapt = names.index("hmc.adapt")
    assert spans[adapt].attrs == {"chunks": want["adapt_chunks"]}
    assert spans[adapt].parent == -1
    assert spans[names.index("hmc.freeze")].parent == adapt
    chunks = [s for s in spans if s.name == "hmc.chunk"]
    assert len(chunks) == want["adapt_chunks"]
    assert all(s.parent == adapt for s in chunks)
    assert all(s.end_ns is not None for s in spans)
    assert sum(s.name == "hmc.iteration" for s in spans) == \
        want["adapt_chunks"] * 4


def test_the_profiler_records_the_warmup():
    """Under a ``torch.profiler`` session the warmup's spans follow it, as
    a chunk's do, and end with it."""
    chain = _warmup_chain()
    with _cpu_profile():
        chain.adapt(4, 0)
    names = [s.name for s in profiling.spans()]
    assert names.count("hmc.adapt") == names.count("hmc.freeze") == 1
    assert not profiling.ON
