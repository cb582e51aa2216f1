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

import numpy as np
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


@pytest.mark.parametrize("mode,raises", [("1", False), ("0", False),
                                         ("2", True)])
def test_reference_kernel_modes(monkeypatch, mode, raises):
    """"1" is measured live after the stage's sampler (so the recorded
    file is not read), "0" is off, anything else is refused."""
    monkeypatch.setenv("BENCH_REALDATA_REFKERNEL", mode)
    if raises:
        with pytest.raises(ValueError, match="BENCH_REALDATA_REFKERNEL"):
            bench.reference_kernel()
    else:
        assert bench.reference_kernel() is None


def jax_reference_assignments():
    """The JAX bench's ``ref.<name> = <expr>`` assignments of its live
    reference run and its stored samples (``rS = <n>``), as AST nodes."""
    with open(os.path.join(REPO, "gravinv3dhmc_tpu", "bench.py")) as f:
        tree = ast.parse(f.read())
    stage = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                 and n.name == "realdata_stage")
    refs, samples = {}, None
    for n in ast.walk(stage):
        if not isinstance(n, ast.Assign):
            continue
        t = n.targets[0]
        if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                and t.value.id == "ref"):
            refs[t.attr] = n.value
        elif isinstance(t, ast.Name) and t.id == "rS":
            samples = ast.literal_eval(n.value)
    return refs, samples


def test_reference_settings_equal_the_jax_benchs():
    """Every literal setting of the JAX bench's live reference run is the
    port's (:data:`bench.REFKERNEL_SETTINGS`), its dtype is float64, and
    what it takes from the stage's sampler (``chain.<name>``) is what
    :func:`bench.reference_kernel_live` copies."""
    refs, samples = jax_reference_assignments()
    assert samples == bench.REFKERNEL_SAMPLES == 128
    from_chain = set()
    for name, node in refs.items():
        if isinstance(node, ast.Attribute) and getattr(
                node.value, "id", None) == "chain":
            from_chain.add(name)
            assert node.attr == name
        elif isinstance(node, ast.Attribute):   # jnp.float64
            assert name == "dtype" and node.attr == "float64"
            assert bench.REFKERNEL_SETTINGS[name] is torch.float64
        else:
            assert bench.REFKERNEL_SETTINGS[name] == ast.literal_eval(node), \
                name
    assert from_chain == {"verbose", "low", "high", "initial_model",
                          "aprior_model", "dobs"}
    assert set(refs) - from_chain == set(bench.REFKERNEL_SETTINGS)


def _f64_draws(seed, chunk_size, C, M, Lmin, Lmax):
    """The JAX sampler's own draws at float64 (shared L): for each
    iteration ``kL, kp, ku = split(key, 3)`` of ``split(fold_in(base_key,
    chunk), chunk_size)`` (``gravinv3dhmc_tpu/inversion/hmc.py``)."""
    from jax import random
    import jax.numpy as jnp

    base_key = random.fold_in(random.PRNGKey(seed), 0)
    cache = {}

    def draws(chunk_idx, i):
        if chunk_idx not in cache:
            rows = []
            for k in random.split(random.fold_in(base_key, chunk_idx),
                                  chunk_size):
                kL, kp, ku = random.split(k, 3)
                rows.append((int(random.randint(kL, (), Lmin, Lmax + 1)),
                             np.asarray(random.normal(kp, (C, M),
                                                      jnp.float64)),
                             np.asarray(random.uniform(ku, (C,),
                                                       jnp.float64))))
            cache[chunk_idx] = rows
        return cache[chunk_idx][i]

    return draws


def test_reference_kernel_live_matches_jax():
    """The live f64 reference run on a small spherical problem (the
    realdata stand-in at 2 degrees) equals the JAX bench's, set by its own
    ``ref.<name> = ...`` lines, with the JAX draws injected: identical
    accept flags, samples within 1e-10 of max|sample| (float64 sums in
    other orders), the same ESS per sample within 1e-8."""
    from gravinv3dhmc_tpu.inversion import hmc as jhmc
    from gravinv3dhmc_tpu.inversion.potential import GravMagModule as JModule
    import jax.numpy as jnp

    from test_torch_realdata import _args

    nsamples = 64
    args, kw = _args(step=2.0)
    tmod = realdata.GravMagModule(*args, **kw, device="cpu")
    jmod = JModule(*args, **kw)
    chain = realdata.slice_sampler(tmod, args[0], "cpu")
    got = bench.reference_kernel_live(
        tmod, chain, torch.device("cpu"), nsamples=nsamples,
        draws=_f64_draws(100, 32, 64, tmod.n_active, 5, 40))
    assert got["source"] == "measured live (f64)"
    assert got["dtype"] == {"x": "float64", "U": "float64"}
    assert got["fused_mode"] == "off"
    assert got["problem"] == [36, tmod.n_active]
    assert got["published_problem"] == [625, 10427]

    refs, _ = jax_reference_assignments()
    ref = jhmc.HamiltonianMC(jmod)
    for name, node in refs.items():
        value = eval(compile(ast.Expression(node), "bench.py", "eval"),
                     {"jnp": jnp, "chain": chain})
        setattr(ref, name, value)
    ref.transfer_samples = True       # the samples to the host here
    want = ref.sample(nsamples, 0)
    assert got["accept_ratio"] == round(want["accept_ratio"], 4)

    # the run again to read its samples (the function returns scalars)
    tref = bench.HamiltonianMC(tmod)
    for name, value in bench.REFKERNEL_SETTINGS.items():
        setattr(tref, name, value)
    tref.device = "cpu"
    for name in ("low", "high", "initial_model", "aprior_model", "dobs"):
        setattr(tref, name, getattr(chain, name))
    res = tref.sample(nsamples, 0, draws=_f64_draws(
        100, 32, 64, tmod.n_active, 5, 40))
    assert res["accepted"] == [int(v) for v in want["accepted"]]
    assert res["samples"].dtype == torch.float64
    w = np.asarray(want["samples"])
    np.testing.assert_allclose(res["samples"].numpy(), w, rtol=0,
                               atol=1e-10 * np.abs(w).max())
    ess_j = want["ess_per_s_median"] * want["elapsed_s"]
    assert got["ess_per_sample"] == pytest.approx(ess_j / (64 * nsamples),
                                                  rel=1e-8)


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
