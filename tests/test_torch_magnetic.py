"""Magnetics and the other prism and tesseroid fields: the port's copies
against the JAX package's.

* Host copies, bit for bit: every prism gravity field's matrix and
  forward, the prism ``tf`` (anomaly and matrix) and ``bx``/``by``/``bz``,
  the tesseroid ``tf``, ``bx``/``by``/``bz`` and field forwards, and
  ``sph2cart``/``ang2vec``/``vec2ang``.
* ``prism_kernel_matrix(backend="jax")`` (torch on the CPU) against the
  numpy float64 builder for every field, within 1e-12 of max|A|.
* ``GravMagModule(field="magnetic")``, cartesian and spherical: ``A``,
  ``Aw`` and ``wdiag`` equal to the JAX module's; ``A @ m`` reproduces
  ``tf`` (rtol 1e-10, as ``tests/test_magnetic_wavelet.py:20``); the
  flat-earth, vertical-field and induced-unit-column identities of
  ``tests/test_tesseroid_magnetic.py``; its potential against the JAX one.
* The fused trajectory and iteration ops (plain versions on the CPU) on a
  magnetic matrix, whose columns have both signs, against the JAX Pallas
  kernels in interpret mode, as ``tests/test_torch_leapfrog.py`` does for
  gravity.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravinv3dhmc_tpu import mesher as jmesher
from gravinv3dhmc_tpu import utils as jutils
from gravinv3dhmc_tpu.inversion.potential import GravMagModule as JModule
from gravinv3dhmc_tpu.ops import prism as jprism
from gravinv3dhmc_tpu.ops import tesseroid as jtess
from gravinv3dhmc_tpu_torch import mesher as tmesher
from gravinv3dhmc_tpu_torch import utils as tutils
from gravinv3dhmc_tpu_torch.inversion.potential import GravMagModule
from gravinv3dhmc_tpu_torch.ops import prism as tprism
from gravinv3dhmc_tpu_torch.ops import tesseroid as ttess
from test_torch_leapfrog import (BF16_REL_TOL, _assert_rel_to_max,
                                 _iteration_pair, _trajectory_pair)

torch.set_num_threads(2)

BOUNDS = (0, 800, 0, 800, 0, 400)
SPACING = (100, 100, 100)
MANGLE = (50.0, 20.0)

# a small equatorial tesseroid and its flat-earth prism
# (tests/test_tesseroid_magnetic.py)
R = jtess.MEAN_EARTH_RADIUS
D2R = np.pi / 180
W, E, S, N, TOP, BOT = -0.005, 0.005, -0.005, 0.005, -2000.0, -3000.0
CELLS = np.array([[W, E, S, N, TOP, BOT]])
PRISM = np.array([[R * S * D2R, R * N * D2R,
                   R * W * D2R, R * E * D2R, -TOP, -BOT]])
LONS = np.array([0.02, -0.015, 0.0])
LATS = np.array([0.01, 0.004, 0.03])
HS = np.array([500.0, 800.0, 300.0])


class FakeMesh:
    """Cells and a magnetization through the mesh interface."""

    def __init__(self, cells, mag):
        self.cells = cells
        self.props = {"magnetization": mag}
        self.active = np.ones(len(cells), bool)

    def cell_bounds(self, only_active=False):
        return self.cells


@pytest.fixture(scope="module")
def grid():
    """The 8 x 8 x 4 mesh of ``tests/test_magnetic_wavelet.py``, in both
    packages, observations over it (some right above corners: the guarded
    log/atan2 branches), and a magnetized block."""
    mesh_j = jmesher.PrismMesh(BOUNDS, SPACING)
    mesh_t = tmesher.PrismMesh(BOUNDS, SPACING)
    obs = jutils.regular((0, 800, 0, 800), (9, 9), z=-1.0)
    mag3 = np.zeros(mesh_j.shape)
    mag3[1:3, 3:6, 3:6] = 2.0
    return mesh_j, mesh_t, obs, mag3.ravel()


def test_units_bit_for_bit():
    lon, lat, h = np.array([10.0, -70.5]), np.array([-3.0, 45.0]), 500.0
    for a, b in zip(tutils.sph2cart(lon, lat, h), jutils.sph2cart(lon, lat, h)):
        np.testing.assert_array_equal(a, b)
    v = np.array([3.0, -2.0, 5.0])
    np.testing.assert_array_equal(tutils.ang2vec(v, 50.0, 20.0),
                                  jutils.ang2vec(v, 50.0, 20.0))
    np.testing.assert_array_equal(tutils.vec2ang(v), jutils.vec2ang(v))


@pytest.mark.parametrize("field", tprism.GRAVITY_FIELDS)
def test_prism_fields_bit_for_bit(grid, field):
    """Each field's f64 host matrix and forward equal the JAX package's;
    the torch builder (``backend="jax"``) is within 1e-12 of max|A|."""
    mesh_j, mesh_t, obs, _ = grid
    rho = np.random.RandomState(1).rand(mesh_j.size)
    mesh_j.addprop("density", rho)
    mesh_t.addprop("density", rho)
    want, kj = getattr(jprism, field)(*obs, mesh_j)
    got, kt = getattr(tprism, field)(*obs, mesh_t)
    np.testing.assert_array_equal(kt, kj)
    np.testing.assert_array_equal(got, want)
    kd = tprism.prism_kernel_matrix(field, *obs, mesh_t, backend="jax",
                                    device="cpu")
    assert kd.dtype == np.float64 and kd.shape == kj.shape
    assert np.abs(kd - kj).max() <= 1e-12 * np.abs(kj).max()
    k32 = tprism.prism_kernel_matrix(field, *obs, mesh_t, backend="jax",
                                     device="cpu", dtype=torch.float32,
                                     obs_chunk=7)
    assert k32.dtype == np.float32
    assert np.isfinite(k32).all()


def test_prism_magnetics_bit_for_bit(grid):
    mesh_j, mesh_t, obs, mag = grid
    vec = np.random.RandomState(2).randn(mesh_j.size, 3)
    for mesh in (mesh_j, mesh_t):
        mesh.addprop("magnetization", mag)
    for kw in ({}, {"pmag": 1.5}, {"pmag": [0.3, -1.0, 2.0]}):
        rj, kj = jprism.tf(*obs, mesh_j, *MANGLE, **kw)
        rt, kt = tprism.tf(*obs, mesh_t, *MANGLE, **kw)
        np.testing.assert_array_equal(kt, kj)
        np.testing.assert_array_equal(rt, rj)
    for mesh in (mesh_j, mesh_t):
        mesh.addprop("magnetization", vec)
    for name in ("bx", "by", "bz"):
        np.testing.assert_array_equal(getattr(tprism, name)(*obs, mesh_t),
                                      getattr(jprism, name)(*obs, mesh_j))
        np.testing.assert_array_equal(
            getattr(tprism, name)(*obs, mesh_t, pmag=[1.0, 2.0, -0.5]),
            getattr(jprism, name)(*obs, mesh_j, pmag=[1.0, 2.0, -0.5]))
    rj, _ = jprism.tf(*obs, mesh_j, *MANGLE)
    rt, _ = tprism.tf(*obs, mesh_t, *MANGLE)
    np.testing.assert_array_equal(rt, rj)


def test_prism_pallas_builder_is_gz_only(grid):
    """Both packages' f32 device builder covers gz alone."""
    _, mesh_t, obs, _ = grid
    with pytest.raises(NotImplementedError):
        tprism.prism_kernel_matrix("gzz", *obs, mesh_t, backend="pallas",
                                   device="cpu")
    with pytest.raises(NotImplementedError):
        jprism.prism_kernel_matrix("gzz", *obs, jmesher.PrismMesh(
            BOUNDS, SPACING), backend="pallas")


def test_tesseroid_magnetics_bit_for_bit():
    mag = np.array([[1.0, -0.5, 2.0]])
    for kw in ({}, {"pmag": 2.0}):
        rj, kj = jtess.tf(LONS, LATS, HS, FakeMesh(CELLS, mag), 45.0, 30.0,
                          **kw)
        info = {}
        rt, kt = ttess.tf(LONS, LATS, HS, FakeMesh(CELLS, mag), 45.0, 30.0,
                          info=info, **kw)
        assert info["tess_backend"] == "native"
        np.testing.assert_array_equal(kt, kj)
        np.testing.assert_array_equal(rt, rj)
    for name in ("bx", "by", "bz"):
        np.testing.assert_array_equal(
            getattr(ttess, name)(LONS, LATS, HS, FakeMesh(CELLS, mag)),
            getattr(jtess, name)(LONS, LATS, HS, FakeMesh(CELLS, mag)))
    with pytest.raises(ValueError):
        ttess.bx(LONS, LATS, HS, CELLS)
    # the flat-earth limit (tests/test_tesseroid_magnetic.py:48-62), the
    # vertical field (tf == bz) and the induced unit column
    px, py, pz = R * LATS * D2R, R * LONS * D2R, -HS
    res_t, k_t = ttess.tf(LONS, LATS, HS, CELLS, 45.0, 30.0, pmag=2.0)
    res_p, k_p = tprism.tf(px, py, pz, PRISM, 45.0, 30.0, pmag=2.0)
    np.testing.assert_allclose(res_t, res_p, rtol=5e-3)
    np.testing.assert_allclose(k_t, k_p, rtol=5e-3)
    for tb, pb in ((ttess.bx, tprism.bx), (ttess.by, tprism.by),
                   (ttess.bz, tprism.bz)):
        np.testing.assert_allclose(tb(LONS, LATS, HS, FakeMesh(CELLS, mag)),
                                   pb(px, py, pz, FakeMesh(PRISM, mag)),
                                   rtol=5e-3, atol=1e-4)
    vert = np.array([[0.0, 0.0, 2.0]])
    np.testing.assert_allclose(
        ttess.tf(LONS, LATS, HS, FakeMesh(CELLS, vert), 90.0, 0.0)[0],
        ttess.bz(LONS, LATS, HS, FakeMesh(CELLS, vert)), rtol=1e-10)
    unit, _ = ttess.tf(LONS, LATS, HS, CELLS, 45.0, 30.0, pmag=1.0)
    np.testing.assert_allclose(k_t[:, 0], unit, rtol=1e-12)


@pytest.mark.parametrize("field", ["gz", "gxz", "geoid"])
def test_tesseroid_forwards_bit_for_bit(field):
    mrange = (-0.1, 0.1, -0.1, 0.1, 0.0, -6000.0)
    spacing = (-2000.0, 0.05, 0.05)
    mesh_j = jmesher.TesseroidMesh(mrange, spacing)
    mesh_t = tmesher.TesseroidMesh(mrange, spacing)
    rho = np.random.RandomState(3).rand(mesh_j.size)
    mesh_j.addprop("density", rho)
    mesh_t.addprop("density", rho)
    args = (LONS * 5, LATS * 5, HS)
    rj, kj = getattr(jtess, field)(*args, mesh_j)
    rt, kt = getattr(ttess, field)(*args, mesh_t)
    np.testing.assert_array_equal(kt, kj)
    np.testing.assert_array_equal(rt, rj)
    np.testing.assert_array_equal(ttess.forward(field, *args, mesh_t),
                                  jtess.forward(field, *args, mesh_j))


def _magnetic_modules(coordinate, dtype=jnp.float32):
    rng = np.random.RandomState(0)
    if coordinate == "cartesian":
        mrange, spacing = BOUNDS, SPACING
        obs = jutils.regular((0, 800, 0, 800), (8, 8), z=-1.0)
    else:
        mrange = (-0.1, 0.1, -0.1, 0.1, 0.0, -6000.0)
        spacing = (-2000.0, 0.05, 0.05)
        lons, lats = np.meshgrid(np.linspace(-0.08, 0.08, 4),
                                 np.linspace(-0.08, 0.08, 4))
        obs = (lons.ravel(), lats.ravel(), np.full(16, 400.0))
    dobs = rng.normal(0, 5, obs[0].size)
    kw = dict(coordinate=coordinate, field="magnetic", mangle=MANGLE,
              verbose=False)
    jmod = JModule(dobs, mrange, spacing, obs, dtype=dtype, **kw)
    tmod = GravMagModule(dobs, mrange, spacing, obs, device="cpu",
                         dtype=torch.float64 if dtype == jnp.float64
                         else torch.float32, **kw)
    return jmod, tmod, dobs


@pytest.mark.parametrize("coordinate", ["cartesian", "spherical"])
def test_magnetic_module_matches_jax(coordinate):
    jmod, tmod, _ = _magnetic_modules(coordinate, jnp.float64)
    for k in ("A", "Aw", "wdiag", "wdiag_inv"):
        np.testing.assert_array_equal(getattr(tmod, k), getattr(jmod, k))
    assert (tmod.A < 0).any() and (tmod.A > 0).any()   # both signs
    assert tmod.tess_backend == ("native" if coordinate == "spherical"
                                 else None)
    assert (tmod.inc, tmod.dec) == MANGLE
    M = jmod.n_active
    w = jmod.wdiag
    kw = dict(regularization="Damping", constraint="logarithmic",
              jacobian=True, temperature=3.0)
    jpot = jmod.make_potential(0 * w, -2 * w, 2 * w, dtype=jnp.float64, **kw)
    tpot = tmod.make_potential(0 * w, -2 * w, 2 * w, dtype=torch.float64,
                               **kw)
    x = np.random.RandomState(4).normal(0, 2e-3, (3, M))
    for got, want in zip(tpot(torch.from_numpy(x), 0.5)[:2],
                         jpot(jnp.asarray(x), 0.5)[:2]):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()


def test_magnetic_module_reproduces_tf(grid):
    """``tests/test_magnetic_wavelet.py:20``: the induced-unit columns
    times the block's scalar magnetization give its total field."""
    mesh_j, _, _, mag = grid
    obs = jutils.regular((0, 800, 0, 800), (8, 8), z=-1.0)
    dobs, _ = tprism.tf(*obs, FakeMesh(mesh_j.cell_bounds(), mag), *MANGLE)
    mod = GravMagModule(dobs, BOUNDS, SPACING, obs, field="magnetic",
                        mangle=MANGLE, verbose=False, device="cpu")
    np.testing.assert_allclose(mod.A @ mag, dobs, rtol=1e-10)


def test_unknown_field_refused():
    with pytest.raises(ValueError):
        GravMagModule(np.zeros(4), BOUNDS, SPACING,
                      jutils.regular((0, 800, 0, 800), (2, 2), z=-1.0),
                      field="gravity_gradient", verbose=False, device="cpu")


@pytest.fixture(scope="module")
def magnetic_module():
    jmod, _, dobs = _magnetic_modules("cartesian")
    return jmod, dobs


@pytest.mark.parametrize("reg", ["MS", "Damping"])
def test_fused_trajectory_on_magnetic_matrix(magnetic_module, reg):
    """The f32 and bf16 trajectory ops against the JAX kernel (interpret
    mode) on the magnetic matrix, at ``test_torch_leapfrog.py``'s
    tolerances."""
    module, dobs = magnetic_module
    out_j, out_t = _trajectory_pair(module, dobs, reg, True, jnp.float32,
                                    torch.float32)
    tol = {"x": (2e-4, 1e-6), "p": (2e-3, 2e-6), "g": (2e-3, 2e-3),
           "U": (2e-4, 0), "ud": (2e-4, 0), "um": (2e-4, 1e-5)}
    for name, a, b in zip(["x", "p", "g", "U", "ud", "um"], out_j, out_t):
        rtol, atol = tol[name]
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol,
                                   atol=atol, err_msg=name)
    out_j, out_t = _trajectory_pair(module, dobs, reg, False, jnp.bfloat16,
                                    torch.bfloat16)
    for name, a, b in zip(["x", "p", "g", "U", "ud", "um"], out_j, out_t):
        _assert_rel_to_max(name, b.numpy(), a, BF16_REL_TOL[name])


@pytest.mark.parametrize("reg", ["MS", "Damping"])
def test_fused_iteration_on_magnetic_matrix(magnetic_module, reg):
    """One whole bf16 iteration (the slice's op) with the JAX kernel's
    stubbed momentum and u = 0: identical accept flags, state within
    ``BF16_REL_TOL``."""
    module, dobs = magnetic_module
    out_j, out_t = _iteration_pair(module, dobs, reg, jnp.bfloat16,
                                   torch.bfloat16)
    np.testing.assert_array_equal(out_t[5], out_j[5])
    assert out_j[5].sum() > 0
    for name, a, b in zip(["x", "U", "g", "ud", "um"], out_j, out_t):
        _assert_rel_to_max(name, b, a, BF16_REL_TOL[name])


def test_magnetic_demo_reduced_matches_jax(monkeypatch):
    """``magnetic.run`` on the CPU, the wide configuration cut to 6 x 6
    observations and a 4 + 4 ChEES: the demo's keys, the constrained
    configuration's data and module equal to the JAX demo's ``build``, its
    ridge control and float64 bounded MAP equal to the JAX package's on
    them (1e-9), the MAP's data misfits moving."""
    import os

    from gravinv3dhmc_tpu.inversion.reginv import cg_device as jcg
    from gravinv3dhmc_tpu_torch import magnetic

    from gravinv3dhmc_tpu.runtime import compile_cache

    # the demo turns on JAX's persistent compilation cache when imported
    monkeypatch.setattr(compile_cache, "enable_compile_cache",
                        lambda *a, **k: None)
    monkeypatch.syspath_prepend(os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "tools"))
    import magnetic_demo as jdemo

    res, tensors, hists = magnetic.run(
        "cpu", configs={"constrained": {},
                        "wide_nonunique": dict(nobs=6)},
        chees=dict(nwarmup=4, nsamples=4, chunk_iters=4))
    c = magnetic.CONSTRAINED
    jmod, _, truth, dpre, dobs, noise = jdemo.build(
        c["mrange"], c["ddeg"], c["dz"], c["nobs"], c["bodies"], c["zobs"])
    module, t_truth, t_dpre, t_dobs, t_noise, _ = magnetic.build(c, "cpu")
    for a, b in ((t_truth, truth), (t_dpre, dpre), (t_dobs, dobs),
                 (module.A, jmod.A), (module.Aw, jmod.Aw)):
        np.testing.assert_array_equal(a, b)
    assert t_noise == noise
    entry = res["constrained"]
    assert entry["problem"] == [64, 192]
    assert entry["tess_backend"] == "native"
    ridge = jdemo.ridge_control(jmod, dobs, dpre, noise, truth)
    assert entry["ridge_control"]["lambda"] == ridge["lambda"]
    assert entry["ridge_control"]["corr"] == pytest.approx(ridge["corr"],
                                                           abs=1e-4)
    jmap = jcg(jmod, dobs, (0.0, 3.0), regularization="Damping", maxk=400,
               dtype=jnp.float64, alpha=0.01)
    m = np.asarray(jmap["m"], np.float64)
    np.testing.assert_allclose(hists["constrained"]["m"], m, rtol=0,
                               atol=1e-9 * np.abs(m).max())
    np.testing.assert_allclose(hists["constrained"]["data_hist"],
                               jmap["data_hist"], rtol=1e-9)
    assert entry["bounded_map"]["truth_corr"] == pytest.approx(
        float(np.corrcoef(m, truth)[0, 1]), rel=1e-9)
    d_h = hists["constrained"]["data_hist"]
    assert np.ptp(d_h) > 1e-3 * d_h[0]
    ch = res["wide_nonunique"]["honest_chees"]
    assert res["wide_nonunique"]["problem"] == [36, 2000]
    assert set(ch) >= {"nchains", "nsamples", "accept",
                       "posterior_truth_corr", "coverage_2std",
                       "mean_posterior_std", "sampling_s", "rhat_max"}
    assert ch["nsamples"] == 4 and ch["nwarmup"] == 4
    assert tensors["wide_nonunique"]["samples"].shape == (4, 16, 2000)


def test_uniformgrid_magnetic_problem():
    """``uniformgrid.build_problem(field="magnetic")``: the block's total
    field with 2 % of max|d| noise, a ``tf`` matrix that reproduces it,
    and the sampler's box [0, 3]."""
    from gravinv3dhmc_tpu_torch import uniformgrid

    module, dobs = uniformgrid.build_problem(
        6, 8, 4, device="cpu", field="magnetic",
        mangle=uniformgrid.MAGNETIC["mangle"])
    body = (uniformgrid.MAGNETIC["magnetization"]
            * uniformgrid.density_model(6, 8, 4).ravel())
    pre = module.A @ body
    assert module.field == "magnetic" and (module.A < 0).any()
    assert module.noise_sigma == pytest.approx(0.02 * np.abs(pre).max(),
                                               rel=1e-10)
    np.testing.assert_allclose(dobs, tutils.contaminate(
        pre, module.noise_sigma, seed=1), rtol=1e-9)
    chain = uniformgrid.slice_sampler(module, dobs, "cpu", high=3.0)
    np.testing.assert_allclose(chain.high, 3.0 * module.wdiag)


def test_module_device_builder_matches_jax():
    """``GravMagModule(kernel_backend="jax")``: the gz matrix from the
    torch float64 builder (on the CPU here) within 1e-12 of max|A| of the
    JAX module's (its XLA builder) and of the numpy one; the build's
    device and copy times recorded."""
    obs = jutils.regular((0, 800, 0, 800), (8, 8), z=-1.0)
    dobs = np.random.RandomState(5).randn(64)
    jmod = JModule(dobs, BOUNDS, SPACING, obs, kernel_backend="jax",
                   verbose=False)
    tmod = GravMagModule(dobs, BOUNDS, SPACING, obs, kernel_backend="jax",
                         verbose=False, device="cpu")
    host = GravMagModule(dobs, BOUNDS, SPACING, obs, verbose=False,
                         device="cpu")
    assert tmod.A.dtype == np.float64
    for ref in (jmod.A, host.A):
        assert np.abs(tmod.A - ref).max() <= 1e-12 * np.abs(ref).max()
    assert {"device_s", "to_host_s", "weighting_s"} <= set(
        tmod.build_seconds)
