"""The realdata slice reduced: the spherical ``GravMagModule`` (segmented
tesseroids, topography carve, frozen cells) against the JAX package's on
the same arguments, its potential, and the slice's sampler end to end.

The module's host arrays come from the same f64 native builds and the
same numpy weighting, so ``A``, ``Aw``, ``wdiag`` and the mask are equal
bit for bit; the potential is f32 on both sides and agrees to f32
rounding (rtol 1e-5 of max|value|).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravinv3dhmc_tpu.inversion.potential import GravMagModule as JModule
from gravinv3dhmc_tpu_torch import realdata
from gravinv3dhmc_tpu_torch.inversion.potential import GravMagModule

torch.set_num_threads(2)

STEP = 2.0
POT_RTOL = 1e-5


def _args(step=STEP, fix_seed=None):
    """``build_problem``'s arguments at ``step`` degrees; ``fix_seed``
    draws a non-zero frozen-cell field."""
    w, e, s, n = realdata.MRANGE[:4]
    lons, lats = np.meshgrid(np.arange(w + step / 2, e, step),
                             np.arange(s + step / 2, n, step))
    lons, lats = lons.ravel(), lats.ravel()
    rng = np.random.RandomState(0)
    dobs = rng.normal(0, 20, lons.size)
    topo = rng.uniform(-2000, 2000, lons.size)
    fix = (np.zeros(lons.size) if fix_seed is None else
           np.random.RandomState(fix_seed).normal(0, 5, lons.size))
    return ((dobs, realdata.MRANGE, (realdata.DZ, step, step),
             (lons, lats, np.zeros(lons.size))),
            dict(fixed=True, grav_fix=fix, mseg=True,
                 mdivisionsection=realdata.DIVISION, coordinate="spherical",
                 field="gravity", verbose=False, mtopo=(lons, lats, topo)))


@pytest.fixture(scope="module")
def modules():
    args, kw = _args(fix_seed=4)
    return JModule(*args, **kw), GravMagModule(*args, **kw, device="cpu")


def test_spherical_module_matches_jax(modules):
    jm, tm = modules
    assert tm.n_active == jm.n_active == jm.mesh.n_active
    assert tm.mask == jm.mask and len(tm.mask) > 0
    assert tm.topocarve and jm.topocarve
    assert tm.mshape == jm.mshape
    assert tm.tess_backend == "native"
    for name in ("A", "Aw", "wdiag", "wdiag_inv"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))
    np.testing.assert_array_equal(tm.grav_fix, jm.grav_fix)
    assert tm.Aw.shape == (36, tm.n_active)


@pytest.mark.parametrize("regularization", ["Damping", "MS"])
def test_spherical_potential_matches_jax(modules, regularization):
    """U, its gradient and the data and model terms of a chain batch, the
    frozen-cell field included."""
    jm, tm = modules
    M = tm.n_active
    w = np.asarray(tm.wdiag)
    aprior, low, high = 0.001 * w, -0.5 * w, 0.5 * w
    x = (w * np.random.RandomState(1).uniform(-0.4, 0.4, (3, M))).astype(
        np.float32)
    kw = dict(regularization=regularization, beta=0.01)
    U_j, g_j, (_, ud_j, um_j) = jm.make_potential(
        aprior, low, high, dtype=jnp.float32, **kw)(jnp.asarray(x), 0.05)
    U_t, g_t, (_, ud_t, um_t) = tm.make_potential(
        aprior, low, high, **kw)(torch.from_numpy(x), 0.05)
    for t, j in ((U_t, U_j), (g_t, g_j), (ud_t, ud_j), (um_t, um_j)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=POT_RTOL * np.abs(j).max())


def test_build_problem_is_the_jax_benchs_geometry():
    """``realdata.build_problem`` equals a JAX module built from the JAX
    bench's synthetic arguments (here at a 2-degree step)."""
    module, dobs = realdata.build_problem("cpu", step=STEP)
    args, kw = _args()
    jm = JModule(*args, **kw)
    np.testing.assert_array_equal(dobs, jm.dobs)
    assert module.n_active == jm.n_active and module.mask == jm.mask
    np.testing.assert_array_equal(module.Aw, jm.Aw)
    np.testing.assert_array_equal(module.grav_fix, np.zeros(dobs.size))


def test_unported_module_options_raise(tmp_path):
    """The device tesseroid builder takes spherical gravity only: the
    magnetic field and a wavelet are refused with it, as in the JAX
    package (both are ported on the host: ``tests/test_torch_magnetic.py``,
    ``tests/test_torch_wavelet.py``; the builder itself:
    ``tests/test_torch_tesseroid_device.py``); the kernel cache is: the carved
    spherical module built with a cache path loads back from it (no
    tesseroid build) to the same matrices bit for bit. A field neither
    package has is refused."""
    args, kw = _args()
    with pytest.raises(NotImplementedError, match="spherical gravity"):
        GravMagModule(*args, **{**kw, "field": "magnetic"},
                      kernel_device=True, device="cpu")
    with pytest.raises(NotImplementedError, match="wavelet"):
        GravMagModule(*args, **kw, wavelet="1D", kernel_device=True,
                      device="cpu")
    path = str(tmp_path / "k.npy")
    built = GravMagModule(*args, **kw, kernel_cache=path, device="cpu")
    loaded = GravMagModule(*args, **kw, kernel_cache=path, device="cpu")
    assert built.tess_backend is not None and loaded.tess_backend is None
    for key in ("A", "Aw", "wdiag"):
        np.testing.assert_array_equal(getattr(loaded, key),
                                      getattr(built, key))
    with pytest.raises(ValueError):
        GravMagModule(*args, **{**kw, "field": "gravity_gradient"},
                      device="cpu")


def test_slice_runs_through_the_trajectory_op():
    """The slice's sampler on the reduced problem on the CPU (the kernels'
    plain versions): the fused trajectory op on an f32 matrix, the warmup
    adapts dt and the metric, and every stored sample is finite."""
    module, dobs = realdata.build_problem("cpu", step=STEP)
    chain = realdata.slice_sampler(module, dobs, "cpu", nchains=8, chunk=4,
                                   adapt_chunks=8, Lrange=(3, 6))
    res = chain.sample(8, 0)
    assert res["fused_mode"] == "trajectory(float32)"
    assert res["adapted_mass"]
    assert np.isfinite(res["step_size"]) and res["step_size"] > 0
    assert res["inv_mass"].shape == (module.n_active,)
    assert bool((res["inv_mass"] > 0).all())
    assert 0 < res["accept_ratio"] <= 1
    assert tuple(res["samples"].shape) == (8, 8, module.n_active)
    assert bool(torch.isfinite(res["samples"]).all())
    assert res["ess_median"] is not None
