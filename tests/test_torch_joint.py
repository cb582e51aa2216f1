"""The port's joint gravity + magnetic module against the JAX package's.

On ``tests/test_joint.py``'s problem (a 3 x 8 x 6 prism mesh, 48
observations of gz and of the total field at inclination 60, declination
10, the magnetization twice the density): the matrices, weights and data
equal the JAX module's within 1e-12; the potential's value, gradient and
aux within 1e-10 relative in float64 (1e-5 in float32) for every
regularizer, with and without the cross-gradient, under 'mandatory' and
'logarithmic', on a vector and on a (3, 2M) batch. The cross-gradient's
own term is held alone too, since a padding off by one changes its value
without breaking finiteness. Then the JAX tests' checks on the port's
module, the spherical joint module, the refusals, and ``HMCSample`` with
the JAX sampler's draws injected: the same accept counts and samples.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from gravinv3dhmc_tpu import mesher, utils
from gravinv3dhmc_tpu.inversion import hmc as jhmc
from gravinv3dhmc_tpu.inversion.joint import JointModule as JJoint
from gravinv3dhmc_tpu.ops import prism
from gravinv3dhmc_tpu_torch.inversion import hmc as thmc
from gravinv3dhmc_tpu_torch.inversion.joint import JointModule

torch.set_num_threads(2)

BOUNDS = (0, 600, 0, 800, 0, 300)
SPACING = (100, 100, 100)
RTOL = {torch.float64: 1e-10, torch.float32: 1e-5}
REGS = ("MS", "Damping", "Smoothness", "TV")


@pytest.fixture(scope="module")
def problem():
    mesh = mesher.PrismMesh(BOUNDS, SPACING)
    rho3 = np.zeros(mesh.shape)
    rho3[0:2, 3:6, 2:4] = 0.5
    rho = rho3.ravel()
    mag = 2.0 * rho
    mesh.addprop("density", rho)
    xo, yo, zo = utils.regular((0, 600, 0, 800), (6, 8), z=-1.0)
    dgz, _ = prism.gz(xo, yo, zo, mesh)

    class MagMesh:
        def cell_bounds(self, only_active=False):
            return mesh.cell_bounds(only_active)
        props = {"magnetization": mag}
        active = mesh.active

    dtf, _ = prism.tf(xo, yo, zo, MagMesh(), inc=60.0, dec=10.0)
    args = (dgz, dtf, BOUNDS, SPACING, (xo, yo, zo))
    jm = JJoint(*args, mangle=(60.0, 10.0), dtype=jnp.float64, verbose=False)
    tm = JointModule(*args, mangle=(60.0, 10.0), dtype=torch.float64,
                     verbose=False, device="cpu")
    return jm, tm, rho, mag


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / max(
        np.abs(want).max(), 1e-300)


def test_module_matches_jax(problem):
    jm, tm, _, _ = problem
    for key in ("kernel_gz", "kernel_tf", "Awg", "Awt", "dobsw", "wdiag",
                "wdiag_inv"):
        assert _rel(getattr(tm, key), getattr(jm, key)) <= 1e-12, key
    assert abs(tm.wb_tf - jm.wb_tf) <= 1e-12 * abs(jm.wb_tf)
    assert (tm.M, tm.n_active, tm.mshape) == (jm.M, jm.n_active, jm.mshape)
    assert tm._active3d is None and jm._active3d is None
    np.testing.assert_array_equal(tm.A, jm.A)


def _inputs(tm, constraint, seed):
    w = tm.wdiag
    rng = np.random.RandomState(seed)
    args = (0.01 * w, -0.5 * w, 1.5 * w)
    if constraint == "logarithmic":
        x = rng.uniform(-2e-3, 2e-3, (3, tm.n_active))
    else:
        x = rng.uniform(0.0, 1.0, (3, tm.n_active)) * w
    return args, x


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("constraint", ["mandatory", "logarithmic"])
@pytest.mark.parametrize("cgw", [0.0, 1.0])
@pytest.mark.parametrize("reg", REGS)
def test_potential_matches_jax(problem, reg, cgw, constraint, dtype):
    """U, g and aux on a (3, 2M) batch and on one (2M,) vector."""
    jm, tm, _, _ = problem
    args, x = _inputs(tm, constraint, REGS.index(reg))
    kw = dict(constraint=constraint, regularization=reg, beta=0.01,
              cross_gradient_weight=cgw)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jp = jm.make_potential(*args, dtype=jdt, **kw)
    tp = tm.make_potential(*args, dtype=dtype, **kw)
    for xi in (x, x[0]):
        uj, gj, aj = jp(xi, 0.3)
        ut, gt, at = tp(torch.as_tensor(xi), 0.3)
        assert ut.dtype == gt.dtype == dtype
        assert gt.shape == xi.shape and ut.shape == xi.shape[:-1]
        for got, want in ((ut, uj), (gt, gj), *zip(at, aj)):
            assert _rel(got.numpy(), want) <= RTOL[dtype]


@pytest.mark.parametrize("reg", ["Damping", "Smoothness"])
def test_cross_gradient_term_matches_jax(problem, reg):
    """U(cgw = 1) - U(cgw = 0) and its gradient, the cross-gradient term
    alone, within 1e-10 of the JAX package's."""
    jm, tm, _, _ = problem
    args, x = _inputs(tm, "mandatory", 7)
    terms = []
    for mod, dt, conv in ((jm, jnp.float64, np.asarray),
                          (tm, torch.float64, torch.as_tensor)):
        out = [mod.make_potential(*args, regularization=reg, dtype=dt,
                                  cross_gradient_weight=c)(conv(x), 0.3)
               for c in (1.0, 0.0)]
        terms.append([np.asarray(a) - np.asarray(b)
                      for a, b in zip(out[0][:2], out[1][:2])])
    (uj, gj), (ut, gt) = terms
    assert np.abs(uj).min() > 1e-3 * np.abs(x).max() ** 2
    assert _rel(ut, uj) <= 1e-10 and _rel(gt, gj) <= 1e-10


def test_block_forward_matches_block_matrix(problem):
    _, tm, rho, mag = problem
    m = np.concatenate([rho, mag])
    np.testing.assert_allclose(tm.forward(m), tm.A @ m, rtol=1e-12)


def test_weighting_block_structure(problem):
    _, tm, _, _ = problem
    np.testing.assert_allclose(np.linalg.norm(tm.Awg, axis=0), 1.0,
                               rtol=1e-10)
    np.testing.assert_allclose(np.linalg.norm(tm.Awt, axis=0), tm.wb_tf,
                               rtol=1e-10)


@pytest.mark.parametrize("cgw", [0.0, 1.0])
def test_joint_gradient_finite_difference(problem, cgw):
    _, tm, _, _ = problem
    n = tm.n_active
    rng = np.random.RandomState(0)
    mw = rng.uniform(0.1, 0.5, n)
    pot = tm.make_potential(np.zeros(n), np.full(n, -10.0),
                            np.full(n, 10.0), regularization="Smoothness",
                            cross_gradient_weight=cgw, dtype=torch.float64)
    _, g, _ = pot(torch.as_tensor(mw), 0.3)
    eps = 1e-6
    for i in [0, n // 2, n - 1]:
        mp = mw.copy()
        mp[i] += eps
        mm = mw.copy()
        mm[i] -= eps
        fdg = (float(pot(torch.as_tensor(mp), 0.3)[0])
               - float(pot(torch.as_tensor(mm), 0.3)[0])) / (2 * eps)
        assert float(g[i]) == pytest.approx(fdg, rel=1e-5, abs=1e-6)


def test_cross_gradient_zero_for_parallel_structures(problem):
    _, tm, rho, mag = problem
    n = tm.n_active
    args = (np.zeros(n), np.full(n, -10.0), np.full(n, 10.0))
    pots = [tm.make_potential(*args, regularization="Damping",
                              cross_gradient_weight=c, dtype=torch.float64)
            for c in (1.0, 0.0)]
    mw = np.concatenate([tm.wdiag[: tm.M] * rho, tm.wdiag[tm.M:] * mag])
    u_cg, u_no = (float(p(torch.as_tensor(mw), 1.0)[0]) for p in pots)
    assert u_cg == pytest.approx(u_no, rel=1e-8)
    mw2 = mw.copy()
    mw2[tm.M:] = tm.wdiag[tm.M:] * np.random.RandomState(1).uniform(0, 1,
                                                                    tm.M)
    u2_cg, u2_no = (float(p(torch.as_tensor(mw2), 1.0)[0]) for p in pots)
    assert u2_cg > u2_no


def test_joint_module_spherical():
    """``tests/test_tesseroid_magnetic.py``'s spherical joint problem: both
    tesseroid kernels equal the JAX module's and the potential evaluates
    finite on a batch."""
    mrange = (-0.1, 0.1, -0.1, 0.1, 0.0, -6000.0)
    spacing = (-2000.0, 0.05, 0.05)
    lons, lats = np.meshgrid(np.linspace(-0.08, 0.08, 4),
                             np.linspace(-0.08, 0.08, 4))
    lons, lats = lons.ravel(), lats.ravel()
    hs = np.full(lons.size, 400.0)
    rng = np.random.RandomState(1)
    args = (rng.normal(0, 5, lons.size), rng.normal(0, 10, lons.size),
            mrange, spacing, (lons, lats, hs))
    kw = dict(coordinate="spherical", mangle=(50.0, 10.0), verbose=False)
    jm = JJoint(*args, **kw)
    tm = JointModule(*args, **kw, device="cpu")
    M = tm.M
    assert tm.kernel_gz.shape == tm.kernel_tf.shape == (lons.size, M)
    for key in ("kernel_gz", "kernel_tf", "Awg", "Awt", "wdiag"):
        assert _rel(getattr(tm, key), getattr(jm, key)) <= 1e-12, key
    w = tm.wdiag
    pot = tm.make_potential(w * np.zeros(2 * M), w * np.full(2 * M, -2.0),
                            w * np.full(2 * M, 2.0), dtype=torch.float64)
    U, g, _ = pot(torch.as_tensor((w * np.full(2 * M, 0.1))[None, :]), 1.0)
    assert torch.isfinite(U).all() and torch.isfinite(g).all()


def test_honest_modes_refused(problem):
    jm, tm, _, _ = problem
    n = tm.n_active
    args = (np.zeros(n), np.full(n, -1.0), np.full(n, 1.0))
    for kw in (dict(jacobian=True), dict(temperature=2.0)):
        for mod in (jm, tm):
            with pytest.raises(NotImplementedError):
                mod.make_potential(*args, constraint="logarithmic", **kw)


def _jax_draws(seed, chunk_size, C, M, Lmin, Lmax, dtype):
    """The JAX sampler's per-chain draws for run seed ``seed``."""
    base_key = random.fold_in(random.PRNGKey(seed), 0)
    cache = {}

    def draws(chunk_idx, i):
        if chunk_idx not in cache:
            rows = []
            for k in random.split(random.fold_in(base_key, chunk_idx),
                                  chunk_size):
                kL, kp, ku = random.split(k, 3)
                rows.append((np.array(random.randint(kL, (C,), Lmin,
                                                     Lmax + 1)),
                             np.asarray(random.normal(kp, (C, M), dtype)),
                             np.asarray(random.uniform(ku, (C,), dtype))))
            cache[chunk_idx] = rows
        return cache[chunk_idx][i]

    return draws


def _hmc_args(module):
    n = module.n_active
    return dict(nsamples=40, ndraws=0, delta=0.005, Lrange=[3, 8],
                initial_model=np.full(n, 0.001),
                aprior_model=np.full(n, 0.001),
                boundaries=np.stack([np.full(n, -0.1), np.full(n, 2.5)],
                                    axis=1),
                constraint="mandatory", log_factor=1000.0,
                dobs=np.concatenate([module.dobs_gz, module.dobs_tf]),
                RegulFactor=1.0, regularization="Damping", seed=1,
                Sigma=0.001, nchains=2, chunk_size=16, verbose=False,
                write_files=False)


def test_joint_hmc_matches_jax(problem, monkeypatch):
    """``tests/test_joint.py``'s ``HMCSample`` run in float64, the port's
    with the JAX sampler's draws: the same accept counts and attempts,
    the stored samples within 1e-6 of max|sample| (the port rounds dt and
    Sigma to f32, as its sampler does at every dtype)."""
    jm, tm, _, _ = problem
    want = jhmc.HMCSample(jm, **_hmc_args(jm), dtype=jnp.float64)
    sample = thmc.HamiltonianMC.sample
    draws = _jax_draws(1, 16, 2, tm.n_active, 3, 8, jnp.float64)
    monkeypatch.setattr(thmc.HamiltonianMC, "sample",
                        lambda self, n, d: sample(self, n, d, draws=draws))
    got = thmc.HMCSample(tm, **_hmc_args(tm), dtype=torch.float64,
                         device="cpu")
    assert got["fused_mode"] == "off"
    assert min(got["accepted"]) >= 40
    assert got["accepted"] == list(want["accepted"])
    assert got["attempted"] == want["attempted"]
    s_want = np.asarray(want["samples"])
    s_got = got["samples"].numpy()
    assert np.isfinite(s_got).all()
    assert np.abs(s_got - s_want).max() <= 1e-6 * np.abs(s_want).max()


def test_fused_request_runs_eager(problem):
    """``use_fused=True`` on a module without a host ``Aw`` (the JAX
    guard ``hmc.py:601``) samples on the eager path instead of failing
    in the fused op's build."""
    _, tm, _, _ = problem
    a = _hmc_args(tm)
    chain = thmc.HamiltonianMC(tm)
    w = tm.wdiag
    chain.low, chain.high = w * a["boundaries"][:, 0], w * a["boundaries"][:, 1]
    chain.initial_model = w * a["initial_model"]
    chain.aprior_model = w * a["aprior_model"]
    chain.dobs = a["dobs"]
    chain.dt, chain.Lrange, chain.Sigma = 0.005, [3, 8], 0.001
    chain.regularization = "Damping"
    chain.nchains, chain.chunk_size = 32, 8
    chain.verbose = chain.write_files = False
    chain.use_fused = True
    chain.device = "cpu"
    res = chain.sample(8, 0)
    assert res["fused_mode"] == "off"
    assert torch.isfinite(res["samples"]).all()
