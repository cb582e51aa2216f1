"""The ``realdata-fused`` cell on the CPU at a tiny size: the South China
stand-in at a 3-degree step (16 stations, 299 tesseroids), 16 chains,
chunks of 8, a warmup of 8 chunks.

A sound run is correct and its traced run reads the warmup's metrics;
the planted faults (a state unchanged, half the chains left out, the
metric dropped from the program's drift while the reference keeps it)
and the control (the program's bf16 path) are not; a program without
the frozen-kernel entry fails in set-up. The harness finds the cell's
parts by name.
"""
import json

import numpy as np
import pytest
import torch

from benchmark import harness
from conftest import ROOT

CELL = "realdata-fused"
TINY_CONFIG = {"step": 3.0}
TINY_TRAFFIC = {"chains": 16, "chunk": 8, "stride": 1, "check_iters": 4,
                "burn_in_chunks": 2, "trace_chunks": 1, "check_chains": 8,
                "check_spans": 4, "adapt_chunks": 8, "L": [5, 12]}


def run(seed=41, trace=0, control=False, fault=None, root=ROOT):
    return harness.run_cell(root, CELL, seed, 0.5, trace, device="cpu",
                            control=control, config_override=TINY_CONFIG,
                            traffic_override=TINY_TRAFFIC, fault=fault)


def test_sound_run_is_correct():
    line = run()
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == {"start_u_gap", "replay_gap_max",
                                   "draw_u_gap_median"}
    assert set(line["metrics"]) == {"setup_s", "grad_evals_per_s"}


def test_traced_run_reads_the_warmup():
    line = run(trace=1)
    assert line["correct"], line["checks"]
    m = line["metrics"]
    assert m["adapt_s"]["value"] > 0
    assert m["adapt_grad_evals_per_s"]["value"] > 0
    for name in ("build_s", "accept_ratio", "ess_per_s.traced",
                 "step_mfu.hmc", "host_kernel_us_per_step.hmc",
                 "host_sampler_us_per_step.hmc", "graph_iters_pct.hmc"):
        assert name in m, name


def _fault(kind):
    """Wraps the program's frozen chunk runner: ``unchanged`` keeps every
    chain's state (and stores it), ``half_batch`` keeps the second half of
    the chains', ``identity`` runs it under a unit metric in place of the
    frozen one (the reference keeps the frozen one)."""
    def plant(s):
        real = s.run_chunk
        winv = torch.as_tensor(s.module.wdiag_inv)
        if kind == "identity":
            s.run_chunk = lambda carry, seed, k: real.func(
                carry, seed, k, dt=real.keywords["dt"],
                inv_mass=torch.ones_like(real.keywords["inv_mass"]),
                store_base=0)
            return

        def run_chunk(carry, seed, k):
            x0, U0, g0 = (t.clone() for t in carry[:3])
            new, stats = real(carry, seed, k)
            x, U, g = new[:3]
            C = x.shape[0]
            keep = torch.zeros(C, dtype=torch.bool)
            keep[C // 2 if kind == "half_batch" else 0:] = True
            kk = keep[:, None]
            x, U, g = (torch.where(kk, x0, x), torch.where(keep, U0, U),
                       torch.where(kk, g0, g))
            new[6][keep] = (x0[keep] * winv.to(x0.dtype))[:, None]
            return (x, U, g) + tuple(new[3:]), stats

        s.run_chunk = run_chunk
    return plant


@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "identity"])
def test_planted_fault_is_not_correct(kind):
    line = run(fault=_fault(kind))
    assert not line["correct"], line["checks"]


def test_control_is_not_correct():
    line = run(control=True)
    assert not line["correct"], line["checks"]


def test_a_program_without_the_frozen_entry_fails_in_setup(monkeypatch):
    from gravinv3dhmc_tpu_torch.inversion import hmc
    monkeypatch.delattr(hmc.HamiltonianMC, "adapt")
    with pytest.raises(RuntimeError, match="adapt"):
        run()


def test_the_harness_finds_the_cells_parts():
    cell, config, traffic, e2e, per_layer = harness.find_cell(ROOT, CELL)
    assert cell["chips"] == 1 and config["problem"] == "tesseroid_region"
    assert traffic["driver"] == "hmc_frozen"
    problem = harness.load_code(ROOT, "problems", config["problem"])
    for name in ("make_inputs", "build_module", "reference_matrix"):
        assert callable(getattr(problem, name))
    driver = harness.load_code(ROOT, "drivers", traffic["driver"])
    for name in ("setup", "window", "stretch", "check"):
        assert callable(getattr(driver, name))
    names = {m["name"] for m in e2e + per_layer}
    assert {"setup_s", "grad_evals_per_s", "adapt_s",
            "adapt_grad_evals_per_s", "graph_iters_pct.hmc"} <= names
    for m in per_layer:
        assert harness.load_code(ROOT, "metrics", m["name"]).read({}) \
            is None, m["name"]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = {c["name"]: c for c in bench["configs"]}["realdata"]
    assert entry["reduced"] == []


def test_the_configuration_keeps_the_standins_cells():
    """Every seed gets the same topography, so the same 10,676 cells."""
    _, config, _, _, _ = harness.find_cell(ROOT, CELL)
    problem = harness.load_code(ROOT, "problems", config["problem"])
    from benchmark.reference import tesseroid
    a, b = (problem.make_inputs(config, seed, "cpu") for seed in (1, 2))
    assert np.array_equal(a["topo"], b["topo"])
    assert not np.array_equal(a["dobs"], b["dobs"])
    assert a["lon"].size == 576
    cells = tesseroid.region_cells(config["region"], config["step"],
                                   config["division"], config["dz"])
    keep = tesseroid.carve(cells, a["lon"], a["lat"], a["topo"])
    assert (cells.shape[0], int(keep.sum())) == (12096, 10676)
