"""The realdata deployment against the plain references of
``reference_torch/``, and the frozen kernel's entry.

- The port's tesseroid matrix of the South China stand-in (segments, the
  topography carve) against ``reference_torch/tesseroid.py``, at a
  3-degree step.
- One frozen-metric iteration of the fused trajectory op (its plain CPU
  versions) against ``reference_torch/hmc_metric.py`` in float64.
- The warmup's estimators (Stan's shrunk pooled variance, dual averaging)
  against ``inversion/nuts.py``'s.
- ``HamiltonianMC.sample`` equals :meth:`~HamiltonianMC.adapt` followed
  by the frozen chunks, bit for bit.
- The benchmark's copies of the references are byte-for-byte theirs, and
  the references import nothing of the port.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import hmc as ref_hmc
from gravinv3dhmc_tpu_torch import realdata
from gravinv3dhmc_tpu_torch.inversion import nuts
from gravinv3dhmc_tpu_torch.ops import philox
from gravinv3dhmc_tpu_torch.ops import tesseroid as port_tess
from reference_torch import hmc_metric
from reference_torch import tesseroid as ref_tess

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
STEP = 3.0


@pytest.fixture(scope="module")
def standin():
    """The stand-in at :data:`STEP` degrees: the port's module and data,
    and the stations' coordinates and topography."""
    module, dobs = realdata.build_problem("cpu", step=STEP)
    lon, lat, height, _, _, topo = realdata.standin(STEP)
    return module, dobs, (lon, lat, height, topo)


def _ref_cells(obs):
    lon, lat, _, topo = obs
    cells = ref_tess.region_cells(realdata.MRANGE, STEP, realdata.DIVISION,
                                  realdata.DZ)
    return cells, ref_tess.carve(cells, lon, lat, topo)


def test_the_carved_mesh_matches_the_reference(standin):
    module, _, obs = standin
    cells, keep = _ref_cells(obs)
    assert np.array_equal(keep, module.mesh.active)
    assert 0 < keep.sum() < keep.size
    np.testing.assert_array_equal(cells[keep],
                                  module.mesh.cell_bounds(only_active=True))


def test_the_tesseroid_matrix_matches_the_reference(standin):
    """The port's gz matrix (its vectorised host backend) within 1e-10 of
    the reference's, relative to the largest entry; the module's, built by
    the native engine, within 1e-7: its C library's trigonometry rounds
    differently, and ``r^2 + r'^2 - 2 r r' cos(psi)`` of a station 500 m
    over a cell's centre loses seven digits to cancellation."""
    module, _, obs = standin
    lon, lat, height, _ = obs
    cells, keep = _ref_cells(obs)
    ref = ref_tess.gz_matrix(lon, lat, height, cells[keep], "cpu").numpy()
    port = port_tess.tesseroid_kernel_matrix(
        "gz", lon, lat, height, cells[keep], backend="numpy")
    scale = np.abs(ref).max()
    assert np.abs(port - ref).max() / scale < 1e-10
    assert np.abs(module.A - ref).max() / scale < 1e-7
    Aw, w = ref_tess.weighting(torch.as_tensor(module.A))
    np.testing.assert_allclose(w.numpy(), module.wdiag, rtol=1e-13)
    np.testing.assert_allclose(Aw.numpy(), module.Aw, rtol=0,
                               atol=1e-13 * np.abs(module.Aw).max())


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_a_frozen_metric_iteration_matches_the_reference(standin, seed):
    """One iteration of the trajectory op on the CPU (float32, its kernels'
    plain versions) under a random positive per-cell metric, L in [5, 40]
    and a start near the box's walls, against the reference in float64
    from the same state and draws: the same accept decisions, the states
    within 1e-4 of how far the reference moved them, the potentials
    within 1e-5."""
    module, dobs, _ = standin
    rng = np.random.default_rng(seed)
    C, M = 12, module.n_active
    w = np.asarray(module.wdiag, np.float64)
    low, high = -0.5 * w, 0.5 * w
    op = realdata.trajectory_op(module, dobs, "cpu")
    pot = ref_hmc.Potential(
        torch.as_tensor(module.Aw), torch.as_tensor(dobs),
        torch.as_tensor(0.001 * w), torch.as_tensor(w * w), 0.05, 0.01,
        "Damping")
    m = torch.as_tensor(rng.uniform(0.2, 5.0, M) * 1e-2 * w * w,
                        dtype=torch.float32)
    x0 = torch.as_tensor(rng.uniform(-0.499, 0.499, (C, M)) * w,
                         dtype=torch.float32)
    U0, g0, ud0, um0 = (v.float() for v in pot(x0.double()))
    L = int(rng.integers(5, 41))
    n01 = torch.as_tensor(rng.standard_normal((C, M)), dtype=torch.float32)
    u = torch.as_tensor(rng.uniform(0, 1, C), dtype=torch.float32)
    eps = float(np.float32(1e-3))
    x1, U1, _, _, _, acc = op.iterate(x0, U0, g0, ud0, um0,
                                      (philox.salt_from_seed(seed), 0), L,
                                      eps, 0.05, inv_mass=m, n01=n01, u=u)
    xr, Ur, _, accr, prop = hmc_metric.iterate(
        pot, x0.double(), U0.double(), g0.double(), n01.double(),
        u.double(), torch.full((C,), L), eps, m.double(),
        torch.as_tensor(low), torch.as_tensor(high))
    # the trajectories reached the walls
    assert bool(((prop == torch.as_tensor(low))
                 | (prop == torch.as_tensor(high))).any())
    assert torch.equal(acc > 0.5, accr)
    assert 0 < int(accr.sum())
    moved = (prop - x0.double()).norm(dim=1)
    gap = (x1.double() - xr).norm(dim=1) / moved
    assert float(gap.max()) < 1e-4
    np.testing.assert_allclose(U1.double().numpy(), Ur.numpy(), rtol=1e-5)


def test_the_shrunk_pooled_variance_matches_the_port():
    """The reference's pooled variance of a window's draws against the
    port's: Welford moments per chain, pooled and shrunk as the warmup
    does it, in float64."""
    rng = np.random.default_rng(5)
    C, N, K = 6, 40, 9
    draws = torch.as_tensor(rng.normal(0.3, rng.uniform(0.01, 2.0, K),
                                       (C, N, K)))
    state = nuts.welford_init((C, K), torch.float64)
    for i in range(N):
        state = nuts.welford_update(state, draws[:, i])
    pooled = dict(m2=state["m2"].sum(0) / C, count=state["count"])
    var = nuts.shrink(nuts.welford_variance(pooled, regularize=False),
                      state["count"] * C)
    port = torch.clamp(var, min=1e-12)
    np.testing.assert_allclose(hmc_metric.pooled_variance(draws).numpy(),
                               port.numpy(), rtol=1e-12)


def test_dual_averaging_matches_the_port():
    rates = np.random.default_rng(6).uniform(0, 1, 15)
    state = nuts.dual_averaging_init(0.005, target=0.75)
    ref = hmc_metric.dual_averaging(0.005, rates, 0.75)
    for a, (log_eps, log_avg) in zip(rates, ref):
        state = nuts.dual_averaging_update(state, float(a))
        assert state["log_eps"] == pytest.approx(log_eps, rel=1e-14)
        assert state["log_eps_avg"] == pytest.approx(log_avg, rel=1e-14)


@pytest.mark.parametrize("store", ["chain", "accepted"])
def test_sample_is_adapt_then_the_frozen_chunks(standin, store):
    """``sample`` equals ``adapt`` followed by the frozen chunks as a
    caller issues them (``Frozen.run``, chunk W on, the storage counted
    from 0), bit for bit: the stored draws, the chains' last state, the
    accept counts and the frozen kernel."""
    module, dobs, _ = standin

    def chain():
        c = realdata.slice_sampler(module, dobs, "cpu", nchains=8, chunk=4,
                                   adapt_chunks=8, Lrange=(3, 6), seed=9)
        c.store_mode = store
        return c

    nsamples = 10
    res = chain().sample(nsamples, 0)
    fz = chain().adapt(nsamples, 0)
    carry, k, stored = fz.carry, fz.n_chunks, 0
    done = (lambda: stored >= nsamples) if store == "chain" else \
        (lambda: int(carry[5].min()) >= nsamples)
    while not done():
        carry, _ = fz.run(carry, k, store_base=stored)
        k, stored = k + 1, stored + 4
    assert fz.dt == res["step_size"]
    assert torch.equal(fz.inv_mass, res["inv_mass"])
    for name, got in (("samples", carry[6]), ("misfits", carry[7]),
                      ("x", carry[0]), ("U", carry[1])):
        assert torch.equal(got, res[name]), name
    assert carry[5].tolist() == res["accepted"]
    assert len(fz.carry) == 8


def test_adapt_needs_a_warmup(standin):
    module, dobs, _ = standin
    c = realdata.slice_sampler(module, dobs, "cpu", nchains=4, chunk=4)
    c.adapt_step_size = c.adapt_mass = False
    with pytest.raises(ValueError, match="warmup"):
        c.adapt(4, 0)


@pytest.mark.parametrize("name", ["tesseroid.py", "hmc_metric.py"])
def test_the_benchmark_copies_are_the_references(name):
    assert (ROOT / "benchmark" / "reference" / name).read_bytes() == \
        (ROOT / "reference_torch" / name).read_bytes()


def test_the_references_import_nothing_of_the_port():
    files = sorted((ROOT / "reference_torch").glob("*.py"))
    assert len(files) >= 3
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] in ("", "__future__", "math",
                                           "numpy", "torch"), (path, n)
