"""The rates are all the work of the window over all its seconds, and
its ESS is taken over every draw the window stored."""
import pytest
import torch

from benchmark import harness
from benchmark.reference import philox
from conftest import ROOT, TINY, run_tiny


def _context(workload, seed, seconds, root=ROOT):
    cell, config, traffic, _, _ = harness.find_cell(root, workload)
    cfg, tr = TINY[workload]
    return harness.Context(root, cell, dict(config, **cfg),
                           dict(traffic, **tr), seed, seconds, 0,
                           torch.device("cpu"))


def _window(seed=5, seconds=0.3):
    ctx = _context("uniformgrid-fused", seed, seconds)
    drv = harness.load_code(ROOT, "drivers", "hmc")
    s = drv.setup(ctx)
    drv.window(ctx, s, seconds)
    return ctx, drv, s


def test_hmc_window_counts_every_step_of_every_chain():
    ctx, _, s = _window()
    rec = ctx.record
    tr = ctx.traffic
    chunks = range(s.B, s.B + s.k_window)
    steps = sum(int(philox.lengths(5, k, tr["chunk"], *tr["L"]).sum())
                for k in chunks)
    assert s.k_window >= 1
    assert rec["work"] == tr["chains"] * steps
    assert rec["units"] == steps
    assert rec["proposals"] == tr["chains"] * tr["chunk"] * s.k_window
    rate = harness.load_code(ROOT, "metrics", "grad_evals_per_s").read(rec)
    assert rate == pytest.approx(rec["work"] / rec["window_s"])
    assert rec["window_s"] >= 0.3


def test_every_window_draw_reaches_the_ess():
    ctx, drv, s = _window()
    k = s.k_window
    assert ctx.record["draws"] == k * s.per
    # the last chunk's draws, still in the program's buffer, are the
    # sink's last, at every stored iteration and ESS cell
    last = s.carry[6][:, :, s.cells]
    assert torch.equal(s.window_sink.ess[k - 1], last)
    drv.check(ctx, s)
    ess = ctx.record["ess"]
    assert 0 < ess <= s.C * k * s.per
    assert harness.load_code(ROOT, "metrics", "ess_per_s.traced").read(
        ctx.record) == pytest.approx(ess / ctx.record["window_s"])


def test_a_window_that_outruns_its_buffers_fails_the_run():
    def one_chunk(s):
        s.sink = harness.load_code(ROOT, "drivers", "hmc").Sink(
            s, 1, False, torch.device("cpu"))
    with pytest.raises(RuntimeError, match="unstored"):
        run_tiny("uniformgrid-fused", seconds=0.5, fault=one_chunk)


def test_a_reader_with_nothing_to_read_is_left_out():
    rec = {"path": "other", "setup_s": 3.0, "window_s": 2.0}
    entries = [{"name": n, "unit": "x"} for n in
               ("grad_evals_per_s", "ess_per_s.traced", "step_mfu.hmc",
                "kernels_roofline.hmc", "setup_s")]
    assert harness.read_metrics(ROOT, entries, rec) == {
        "setup_s": {"value": 3.0, "unit": "x"}}
