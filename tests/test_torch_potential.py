"""The port's potential against ``GravMagModule.make_potential`` of the
JAX package, on ``small_module``'s problem with the same inputs.

Tolerances: U, dpre, ud, um to rtol 1e-5 at f32 and 1e-10 at f64 (sums
in different orders). The gradient is compared elementwise with rtol at
the same level plus an atol of that level times max|g|: the port writes
the MS gradient analytically while JAX differentiates the quotient, and
components near zero carry the cancellation of the larger ones.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gravinv3dhmc_tpu.inversion.potential import GravMagModule as JModule
from gravinv3dhmc_tpu_torch.inversion.potential import GravMagModule

torch.set_num_threads(2)

SPACING = (100, 100, 100)
BOUNDS = (0, 800, 0, 1200, 0, 400)


def _modules(small_module, fixed):
    jmod, dobs, _ = small_module
    obs = (jmod.lonobs, jmod.latobs, jmod.heightobs)
    kw = {}
    if fixed:
        kw = dict(fixed=True,
                  grav_fix=np.random.RandomState(1).randn(dobs.size))
    return (JModule(dobs, BOUNDS, SPACING, obs, verbose=False, **kw),
            GravMagModule(dobs, BOUNDS, SPACING, obs, verbose=False,
                          device="cpu", **kw))


@pytest.mark.parametrize("fixed", [False, True])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("float64", 1e-10)])
@pytest.mark.parametrize("reg", ["MS", "Damping", "Smoothness", "TV"])
def test_potential_matches_jax(small_module, reg, dtype, tol, fixed):
    jm, tm = _modules(small_module, fixed)
    np.testing.assert_array_equal(tm.Aw, jm.Aw)
    w = jm.wdiag
    args = (w * 0.001, w * 0.0, w * 1.0)
    jp = jm.make_potential(*args, regularization=reg, beta=0.001,
                           dtype=getattr(jnp, dtype))
    tp = tm.make_potential(*args, regularization=reg, beta=0.001,
                           dtype=getattr(torch, dtype))
    x = np.random.RandomState(0).uniform(0.1, 0.6, (5, jm.n_active)) * w
    Uj, gj, (dj, udj, umj) = jp(jnp.asarray(x, getattr(jnp, dtype)), 0.7)
    Ut, gt, (dt, udt, umt) = tp(torch.as_tensor(x, dtype=getattr(torch,
                                                                 dtype)), 0.7)
    for a, b in [(Uj, Ut), (dj, dt), (udj, udt), (umj, umt)]:
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=tol)
    gj = np.asarray(gj)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=tol,
                               atol=tol * np.abs(gj).max())
    # a single model (M,) gives the same as row 0 of the batch
    U1, g1, _ = tp(torch.as_tensor(x[0], dtype=getattr(torch, dtype)), 0.7)
    np.testing.assert_allclose(U1.numpy(), Ut[0].numpy(), rtol=tol)


def test_bf16_storage_accumulates_in_f32(small_module):
    """matvec_dtype=bfloat16 stores A in bf16; the result stays f32 and
    within bf16's ~3 digits of the f32 potential."""
    _, tm = _modules(small_module, False)
    w = tm.wdiag
    args = (w * 0.001, w * 0.0, w * 1.0)
    pf = tm.make_potential(*args, regularization="MS", beta=0.001)
    pb = tm.make_potential(*args, regularization="MS", beta=0.001,
                           matvec_dtype=torch.bfloat16)
    assert pb.params["Aw"].dtype == torch.bfloat16
    x = torch.as_tensor(np.random.RandomState(1).uniform(
        0.1, 0.6, (3, tm.n_active)) * w, dtype=torch.float32)
    Uf, gf, _ = pf(x, 1.0)
    Ub, gb, _ = pb(x, 1.0)
    assert Ub.dtype == torch.float32
    np.testing.assert_allclose(Ub.numpy(), Uf.numpy(), rtol=2e-2)


@pytest.mark.parametrize("kwargs", [dict(use_wavelet="1D"),
                                    dict(use_wavelet="3D"),
                                    dict(use_wavelet=True)])
def test_unported_potentials_raise(small_module, kwargs):
    """Wavelet potentials are ported: on a module built without a wavelet
    kernel (``Awcp`` None) ``use_wavelet`` gives the dense potential, as
    in the JAX package. The device tesseroid builder (``kernel_device``)
    takes spherical gravity only: a cartesian module refuses it, as the
    JAX package's does."""
    jm, tm = _modules(small_module, False)
    w = tm.wdiag
    args = (w * 0.001, w * 0.0, w * 1.0)
    x = np.random.RandomState(2).uniform(0.1, 0.6, (2, tm.n_active)) * w
    got = tm.make_potential(*args, **kwargs)(torch.as_tensor(
        x, dtype=torch.float32), 1.0)[1].numpy()
    want = np.asarray(jm.make_potential(*args, **kwargs)(
        jnp.asarray(x, jnp.float32), 1.0)[1])
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    obs = (jm.lonobs, jm.latobs, jm.heightobs)
    with pytest.raises(NotImplementedError, match="spherical gravity"):
        GravMagModule(small_module[1], BOUNDS, SPACING, obs, verbose=False,
                      device="cpu", kernel_device=True)


def _wavelet_modules(small_module, wavelet):
    jmod, dobs, _ = small_module
    obs = (jmod.lonobs, jmod.latobs, jmod.heightobs)
    return (JModule(dobs, BOUNDS, SPACING, obs, verbose=False,
                    wavelet=wavelet),
            GravMagModule(dobs, BOUNDS, SPACING, obs, verbose=False,
                          wavelet=wavelet, device="cpu"))


def _reference_point(jm, constraint, log_factor):
    """The box, a priori model and a point inside the box in the sampler's
    variable (mw, or the logistic x)."""
    w = np.asarray(jm.wdiag)
    low, high, apr = w * 0.0, w * 1.0, w * 0.001
    mw = np.random.RandomState(3).uniform(0.1, 0.6, jm.n_active) * w
    if constraint == "logarithmic":
        x = (1.0 / log_factor) * np.log((mw - low) / (high - mw))
    else:
        x = mw
    return x, apr, low, high


@pytest.mark.parametrize("wavelet", [False, "1D", "3D"])
@pytest.mark.parametrize("reg", ["MS", "Damping", "Smoothness"])
@pytest.mark.parametrize("constraint", ["mandatory", "logarithmic"])
def test_misfit_and_grad_and_data_match_jax(small_module, constraint, reg,
                                            wavelet):
    """The reference-compatible duck-typed API: ``misfit_and_grad``
    (float32 potential: U, the data and model terms and dpre to rtol
    1e-5, the gradient to 1e-5 of max|g|) and ``data`` (float64: rtol
    1e-10) equal the JAX module's, with the dense kernel and both
    wavelet kernels; numpy arrays and floats come back."""
    if wavelet:
        jm, tm = _wavelet_modules(small_module, wavelet)
    else:
        jm, tm = _modules(small_module, False)
    log_factor = 100.0
    x, apr, low, high = _reference_point(jm, constraint, log_factor)
    args = (x, apr, low, high, constraint, log_factor, 0.7)
    got = tm.misfit_and_grad(*args, regulization=reg, beta=0.001)
    want = jm.misfit_and_grad(*args, regulization=reg, beta=0.001)
    assert isinstance(got[0], float) and isinstance(got[1], np.ndarray)
    for i in (0, 3, 4):
        assert got[i] == pytest.approx(want[i], rel=1e-5), i
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5,
                               atol=1e-5 * np.abs(want[2]).max())
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5,
                               atol=1e-5 * np.abs(want[1]).max())
    d_t = tm.data(x, low, high, constraint, log_factor)
    d_j = jm.data(x, low, high, constraint, log_factor)
    assert isinstance(d_t, float)
    assert d_t == pytest.approx(d_j, rel=1e-10)


def test_misfit_and_grad_caches_one_potential_a_key(small_module):
    """As in the JAX module, the potential is made once a (regularization,
    constraint, beta, log_factor): a later call with another a priori
    model and the same key reuses the first call's; another beta makes a
    new one. An unknown constraint is refused by ``data``."""
    jm, tm = _modules(small_module, False)
    x, apr, low, high = _reference_point(jm, "mandatory", 1000.0)
    first = tm.misfit_and_grad(x, apr, low, high, "mandatory", 1000.0, 1.0)
    again = tm.misfit_and_grad(x, 2 * apr, low, high, "mandatory", 1000.0,
                               1.0)
    assert again[0] == first[0] and len(tm._potential_cache) == 1
    want = jm.misfit_and_grad(x, apr, low, high, "mandatory", 1000.0, 1.0)
    jm.misfit_and_grad(x, 2 * apr, low, high, "mandatory", 1000.0, 1.0)
    assert len(jm._potential_cache) == 1
    assert first[0] == pytest.approx(want[0], rel=1e-5)
    tm.misfit_and_grad(x, apr, low, high, "mandatory", 1000.0, 1.0,
                       beta=0.5)
    assert len(tm._potential_cache) == 2
    with pytest.raises(ValueError, match="constraint"):
        tm.data(x, low, high, "reflective", 1000.0)
