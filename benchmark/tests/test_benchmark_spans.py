"""The readers of the program's spans (``issue_lead_ms.hmc``,
``host_kernel_us_per_step.hmc``, ``host_sampler_us_per_step.hmc``): their
arithmetic on a buffer written here, nothing from a program without
spans, and a traced run on the CPU that reports both host metrics and no
lead (there is no card to mark)."""
import pytest

from benchmark import harness
from conftest import ROOT, run_tiny

READERS = ("issue_lead_ms.hmc", "host_kernel_us_per_step.hmc",
           "host_sampler_us_per_step.hmc")
REC = {"path": "hmc"}


def _read(name, rec=REC):
    return harness.load_code(ROOT, "metrics", name).read(rec)


def _buffer():
    """One chunk of two iterations (2 and 3 batch steps) on the card: the
    chunk spans 10,000 ns, its kernels 1,000 + 500 + 1,500 ns (one nested
    in another, counted once), the leads 0.5 ms and 0.1 ms."""
    from gravinv3dhmc_tpu_torch.profiling import Span

    def it(a, b, steps, lead_ms):
        return Span("hmc.iteration", a, b, 0, 4,
                    {"steps": steps, "mark_ns": a,
                     "device_ns": a + int(lead_ms * 1e6)})

    return [Span("hmc.chunk", 0, 10_000, -1, 4, None),
            Span("hmc.lengths", 100, 300, 0, 4, None),
            it(1_000, 4_000, 2, 0.5),
            Span("kernel.refresh", 1_100, 2_100, 2, 4, None),
            Span("kernel.kick", 2_500, 3_000, 2, 4, None),
            Span("kernel.inner", 2_600, 2_700, 4, 4, None),
            Span("hmc.store", 3_200, 3_900, 2, 4, None),
            it(5_000, 9_000, 3, 0.1),
            Span("kernel.drift", 5_100, 6_600, 7, 4, None)]


@pytest.fixture
def program(monkeypatch):
    from gravinv3dhmc_tpu_torch import profiling
    return lambda spans: monkeypatch.setattr(profiling, "spans",
                                             lambda: spans)


def test_the_readers_arithmetic(program):
    program(_buffer())
    assert _read("issue_lead_ms.hmc") == pytest.approx(0.3)
    # 3,000 ns of kernels over 5 batch steps; the rest of the chunk's
    # 10,000 ns is the sampler's
    assert _read("host_kernel_us_per_step.hmc") == pytest.approx(0.6)
    assert _read("host_sampler_us_per_step.hmc") == pytest.approx(1.4)


def test_no_marker_no_lead(program):
    program([s._replace(attrs={"steps": s.attrs["steps"]})
             if s.name == "hmc.iteration" else s for s in _buffer()])
    assert _read("issue_lead_ms.hmc") is None
    assert _read("host_kernel_us_per_step.hmc") == pytest.approx(0.6)


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read(name, program, monkeypatch):
    program([])                                     # no iteration
    assert _read(name) is None
    program(_buffer())
    assert _read(name, {"path": "cg"}) is None      # not the hmc path
    from gravinv3dhmc_tpu_torch import profiling
    monkeypatch.delattr(profiling, "spans")         # a program without
    assert _read(name) is None


def test_a_traced_run_reports_both_host_metrics_and_no_lead():
    line = run_tiny("uniformgrid-fused", trace=1)
    assert line["correct"]
    m = line["metrics"]
    assert m["host_kernel_us_per_step.hmc"]["value"] > 0
    assert m["host_sampler_us_per_step.hmc"]["value"] > 0
    assert m["host_kernel_us_per_step.hmc"]["unit"] == "us"
    assert "issue_lead_ms.hmc" not in m
