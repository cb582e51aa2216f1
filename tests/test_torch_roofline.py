"""The sampler's roofline (``gravinv3dhmc_tpu_torch/roofline.py``) against
``tools/roofline.py``, and the card default of the three study modules.

* ``--device cpu`` at 8 chains on the 600 x 6000 uniformgrid problem runs
  all four layers on the plain versions (no kernel launched) and prints
  the tool's keys (read from its source) plus a ``*_device_s`` /
  ``*_wall_s`` pair for each item of layers 1-3: null device times and
  positive wall times on the CPU, where there is no device clock.
* The t(L) = a + b L fit recovers a and b from synthetic times, and the
  ``iter_budget`` arithmetic is the tool's (``tools/roofline.py:268-
  293``).
* ``bounded_map``, ``global_chees`` and ``roofline`` each raise without a
  card unless given ``--device`` (``_device.resolve``), before building
  anything.
"""
import ast
import json
import os

import numpy as np
import pytest
import torch

from gravinv3dhmc_tpu_torch import bounded_map, global_chees, roofline
from gravinv3dhmc_tpu_torch import uniformgrid
from gravinv3dhmc_tpu_torch.ops import leapfrog as tlf

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the CPU run: 8 chains, short wall loops, chunks of 4 iterations
CPU_RUN = dict(nchains=8, reps=2,
               chunk=dict(chunk_size=4, nsamples=2, n_timed=1))


@pytest.fixture(scope="module")
def line():
    problem = uniformgrid.build_problem(device="cpu")
    tlf.reset_launch_counts()
    out = roofline.run(device="cpu", problem=problem, **CPU_RUN)
    return out, tlf.launch_counts()


def _tool_keys():
    """The tool's ``out`` keys and its ``iter_budget`` keys."""
    with open(os.path.join(REPO, "tools", "roofline.py")) as f:
        tree = ast.parse(f.read())
    for n in ast.walk(tree):
        if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name) \
                and n.targets[0].id == "out" \
                and isinstance(n.value, ast.Dict):
            keys = [k.value for k in n.value.keys]
            budget = n.value.values[keys.index("iter_budget")]
            return set(keys), {k.value for k in budget.keys}
    raise AssertionError("no out = {...} in tools/roofline.py")


def test_cpu_run_has_the_tools_keys_and_both_clocks(line):
    out, launches = line
    keys, budget_keys = _tool_keys()
    assert "traj_per_step_s" in keys and "chunk_by_store_mode" in keys
    assert keys <= set(out), keys - set(out)
    assert set(out["iter_budget"]) == set(out["iter_budget_wall"]) \
        == budget_keys
    pairs = [k[:-len("_device_s")] for k in out if k.endswith("_device_s")]
    assert sorted(pairs) == sorted(
        ["matmul_pair", "traj_per_step", "traj_per_call_overhead",
         "traj_by_L", "rng_refresh", "rng_refresh_torch", "refresh",
         "accept_select"])
    for name in pairs:
        assert out[f"{name}_device_s"] is None, name
        wall = out[f"{name}_wall_s"]
        vals = wall.values() if isinstance(wall, dict) else [wall]
        assert all(np.isfinite(v) for v in vals), name
    assert set(out["traj_by_L_wall_s"]) == {"1", "4", "16", "48"}
    assert all(t > 0 for t in out["traj_by_L_wall_s"].values())
    # on the CPU the tool's keys carry the wall times
    assert out["traj_per_step_s"] == out["traj_per_step_wall_s"]
    assert out["accept_select_s_per_iter"] == out["accept_select_wall_s"]
    assert set(out["chunk_by_store_mode"]) == {"none", "chain", "accepted"}
    assert out["problem"] == [600, 6000] and out["padded"] == [640, 6016]
    assert out["nchains"] == 8 and out["device"] == "cpu"
    assert out["peak_bf16_tflops"] == 989.0 and out["matmul_tflops_sane"]
    assert out["tile_c"] is None
    json.dumps(out)
    # the plain versions ran: no kernel launched
    assert all(v == 0 for v in launches.values())


def test_fit_line_recovers_a_and_b():
    a, b = 1.5e-4, 1.28e-4
    Ls = roofline.LS
    rng = np.random.RandomState(0)
    ts = [a + b * L + 1e-9 * rng.randn() for L in Ls]
    got_a, got_b = roofline.fit_line(Ls, ts)
    assert got_a == pytest.approx(a, rel=1e-3)
    assert got_b == pytest.approx(b, rel=1e-4)
    assert roofline.fit_line([1, 2], [3.0, 5.0]) == pytest.approx((1.0, 2.0))


def test_iter_budget_arithmetic():
    chunk = {"none": {"s_per_iter": 2.0e-3},
             "chain": {"s_per_iter": 1.9e-3},
             "accepted": {"s_per_iter": 2.2e-3}}
    got = roofline.iter_budget(1e-4, 1e-4, chunk)
    assert got["trajectory(E[L]=12.5)"] == pytest.approx(1e-4 + 12.5e-4)
    assert got["wrapper(rng+accept+store+scan)"] == pytest.approx(
        1.9e-3 - 1.35e-3)
    assert got["accepted_mode_extra"] == pytest.approx(0.3e-3)
    assert roofline.EXPECTED_L == (5 + 20) / 2


@pytest.mark.parametrize("module", [bounded_map, global_chees, roofline])
def test_modules_raise_without_a_card(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_build(*args, **kwargs):
        raise AssertionError("built a problem before resolving the device")

    for name in ("build", "uniformgrid"):
        if hasattr(module, name):
            monkeypatch.setattr(module, name, no_build)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])
