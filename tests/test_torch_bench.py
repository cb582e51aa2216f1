"""The port's bench (``gravinv3dhmc_tpu_torch/bench.py``) at a tiny size on
the CPU: both stages run through the port, the printed JSON carries the
JAX bench's keys, and a failing stage fails the run.

The JAX bench's keys are read from its source
(``gravinv3dhmc_tpu/bench.py``: the dict ``main`` prints and the one
``realdata_stage`` returns), so the two cannot drift apart unnoticed.
"""
import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from gravinv3dhmc_tpu_torch import bench, realdata, uniformgrid
from gravinv3dhmc_tpu_torch.ops import leapfrog

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: keys the port leaves out: the d2h watchdog's count mode
DROPPED = {"grad_eval_count_mode"}
#: keys the port adds: each stage's kernel launches, the tesseroid backend
ADDED = {"launches"}
ADDED_REALDATA = {"launches", "tess_backend"}
TINY = dict(BENCH_NCHAINS="8", BENCH_CHUNK="4", BENCH_CHUNKS="2",
            BENCH_NSAMPLES="4", BENCH_REALDATA_NCHAINS="8",
            BENCH_REALDATA_CHUNK="4", BENCH_REALDATA_NSAMPLES="8",
            BENCH_REALDATA_ADAPT_CHUNKS="8", BENCH_REALDATA_LRANGE="3,5")


def _dict_keys(node):
    return {k.value for k in node.keys if isinstance(k, ast.Constant)}


def jax_bench_keys():
    """(top-level keys, detail keys, realdata keys) of the JAX bench."""
    with open(os.path.join(REPO, "gravinv3dhmc_tpu", "bench.py")) as f:
        tree = ast.parse(f.read())
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    result = next(n.value for n in ast.walk(funcs["main"])
                  if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", None) == "result")
    detail = next(v for k, v in zip(result.keys, result.values)
                  if k.value == "detail")
    ret = next(n.value for n in ast.walk(funcs["realdata_stage"])
               if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict))
    return (_dict_keys(result), _dict_keys(detail) | {"realdata"},
            _dict_keys(ret))


def _small_ug(device):
    return uniformgrid.build_problem(6, 8, 3, device=device)


def _small_rd(device):
    return realdata.build_problem(device, step=2.0)


@pytest.fixture
def tiny(monkeypatch):
    for k, v in TINY.items():
        monkeypatch.setenv(k, v)


def test_bench_keys_and_stages(tiny):
    # the bench reads the launch counts and never resets them, so a
    # caller counting around run() sees both stages
    leapfrog.KERNELS["draws"].launches = 5
    res = bench.run("cpu", _small_ug, _small_rd)
    assert leapfrog.KERNELS["draws"].launches == 5
    leapfrog.reset_launch_counts()
    top, detail, rd = jax_bench_keys()
    assert set(res) == top
    assert set(res["detail"]) == (detail - DROPPED) | ADDED
    assert set(res["detail"]["realdata"]) == rd | ADDED_REALDATA
    assert res["metric"] == "uniformgrid leapfrog grad-evals/s/chip"
    assert res["unit"] == "grad-evals/s" and res["value"] > 0
    d = res["detail"]
    assert d["fused_pallas_step"] == "iteration(bfloat16)"
    assert d["problem"] == [48, 144] and d["nchains"] == 8
    assert 0 < d["accept_ratio"] <= 1 and d["ess_median_total"] > 0
    r = d["realdata"]
    assert r["fused_pallas_step"] == "trajectory(float32)"
    assert r["adapted_mass"] and r["step_size"] > 0
    assert r["tess_backend"] == "native"
    assert r["reference_kernel"]["ess_per_sample"] > 0
    assert r["problem"][0] == 36 and r["Lrange"] == [3, 5]
    # the CPU runs the plain versions: no kernel launched
    assert d["launches"] == {} and r["launches"] == {}
    json.dumps(res)


def test_uniformgrid_stage_matrix_type(tiny, monkeypatch):
    """``BENCH_MATVEC_DTYPE`` sets the fused iteration op's matrix type,
    which the stage reports."""
    monkeypatch.setenv("BENCH_MATVEC_DTYPE", "float32")
    res = bench.uniformgrid_stage(torch.device("cpu"), lambda msg: None,
                                  _small_ug)
    assert res["detail"]["fused_pallas_step"] == "iteration(float32)"
    assert 0 < res["detail"]["accept_ratio"] <= 1


def test_failing_stage_fails_the_run(tiny):
    def broken(device):
        raise RuntimeError("realdata build failed")

    with pytest.raises(RuntimeError, match="realdata build failed"):
        bench.run("cpu", _small_ug, broken)


def test_realdata_can_be_skipped(tiny, monkeypatch):
    monkeypatch.setenv("BENCH_REALDATA", "0")
    res = bench.run("cpu", _small_ug, None)
    assert "realdata" not in res["detail"]


@pytest.mark.parametrize("mode,raises", [("1", True), ("0", False)])
def test_reference_kernel_modes(monkeypatch, mode, raises):
    monkeypatch.setenv("BENCH_REALDATA_REFKERNEL", mode)
    if raises:
        with pytest.raises(NotImplementedError, match="live f64"):
            bench.reference_kernel()
    else:
        assert bench.reference_kernel() is None


def test_main_without_a_card_exits_nonzero():
    """``python -m gravinv3dhmc_tpu_torch.bench`` needs a card and has no
    CPU fallback: without one it fails before printing a result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "gravinv3dhmc_tpu_torch.bench"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
