"""The logistic box transform, its log-Jacobian and the likelihood
temperature: the port's ``make_potential`` against the JAX package's
``fn`` on the same inputs.

U, the data and model terms agree within rtol 1e-5 of max|value| (f32
sums in different orders). So does g, or else its error against the same
potential evaluated by JAX in float64 is at most twice JAX's own f32
error: ``torch.sigmoid`` and XLA's ``1 / (1 + exp(-x))`` differ in the
last bit on about 0.4 % of inputs, and where mw lies within a few per
cent of the a priori model the MS gradient (proportional to
``dm = mw - aprior``) magnifies that bit past 1e-5 of max|g| on either
side. The chain rule differs only where the sigmoid saturates: JAX
differentiates ``sigmoid`` as ``s (1 - s)``, which is 0 once ``s`` rounds
to 1, the port as ``sigmoid(kx) sigmoid(-kx)``, which stays positive; with
|kx| up to 80 that term is below 1e-34 of the Jacobian's k, so the two
agree to the tolerance. Cells of zero width (low == high) take
``log_const = 0``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravinv3dhmc_tpu.inversion import potential as jpot
from gravinv3dhmc_tpu_torch.inversion import potential as tpot
from test_torch_potential import _modules
from test_torch_realdata import modules as rd_modules  # noqa: F401

torch.set_num_threads(2)

RTOL = 1e-5


def _inputs(M, w, C=4, seed=0, zero_width=()):
    """(aprior, low, high, x): a box [-0.5, 0.7] w with some cells of zero
    width, and logistic positions whose kx spans +-80 at k = 1000."""
    rng = np.random.RandomState(seed)
    low, high = -0.5 * w, 0.7 * w
    high = high.copy()
    high[list(zero_width)] = low[list(zero_width)]
    x = rng.uniform(-0.004, 0.004, (C, M))
    x[0, :4] = [0.08, -0.08, 0.05, -0.06]          # |kx| up to 80
    return 0.001 * w, low, high, x.astype(np.float32)


def _check(jm, tm, x, args, alpha, **kw):
    Uj, gj, (dj, udj, umj) = jm.make_potential(*args, dtype=jnp.float32,
                                               **kw)(jnp.asarray(x), alpha)
    Ut, gt, (dt, udt, umt) = tm.make_potential(*args, **kw)(
        torch.from_numpy(x), alpha)
    for t, j in ((Ut, Uj), (dt, dj), (udt, udj), (umt, umj)):
        j = np.asarray(j)
        assert np.isfinite(t.numpy()).all()
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=RTOL * np.abs(j).max())
    gj, gt = np.asarray(gj, np.float64), gt.numpy().astype(np.float64)
    assert np.isfinite(gt).all()
    err = np.abs(gt - gj).max()
    if err > RTOL * np.abs(gj).max():
        g64 = np.asarray(jm.make_potential(*args, dtype=jnp.float64, **kw)(
            jnp.asarray(x, jnp.float64), alpha)[1])
        assert (np.abs(gt - g64).max()
                <= 2.0 * np.abs(gj - g64).max()), err
    return Ut, gt


@pytest.mark.parametrize("fixed", [False, True])
@pytest.mark.parametrize("reg", ["MS", "Damping"])
@pytest.mark.parametrize("constraint,jacobian,temperature", [
    ("logarithmic", True, 1.0), ("logarithmic", True, 7.5),
    ("logarithmic", False, 1.0), ("logarithmic", False, 7.5),
    ("reflective", False, 1.0), ("reflective", True, 7.5)])
def test_logistic_potential_matches_jax(small_module, reg, fixed,
                                        constraint, jacobian, temperature):
    jm, tm = _modules(small_module, fixed)
    w = np.asarray(jm.wdiag)
    aprior, low, high, x = _inputs(jm.n_active, w, zero_width=(5, 17))
    if constraint == "reflective":
        x = (w * np.random.RandomState(2).uniform(
            -0.4, 0.6, x.shape)).astype(np.float32)
    _check(jm, tm, x, (aprior, low, high), 0.7, regularization=reg,
           beta=0.001, constraint=constraint, log_factor=1000.0,
           jacobian=jacobian, temperature=temperature)


@pytest.mark.parametrize("reg", ["MS", "Damping"])
def test_logistic_potential_carved_frozen_module(rd_modules, reg):
    """The spherical module with carved and frozen cells."""
    jm, tm = rd_modules
    w = np.asarray(tm.wdiag)
    aprior, low, high, x = _inputs(tm.n_active, w, C=3, seed=1,
                                   zero_width=(0, 9))
    _check(jm, tm, x, (aprior, low, high), 0.05, regularization=reg,
           beta=0.01, constraint="logarithmic", log_factor=1000.0,
           jacobian=True, temperature=7.5)


def test_zero_width_cells_take_no_log_constant(small_module):
    """With every cell of zero width the Jacobian term is
    ``sum softplus(kx) + softplus(-kx)`` exactly; the data term sees the
    constant mw = low."""
    _, tm = _modules(small_module, False)
    w = np.asarray(tm.wdiag)
    M = tm.n_active
    pot = tm.make_potential(0 * w, w * 0.3, w * 0.3, constraint="logarithmic",
                            jacobian=True, regularization="Damping")
    x = torch.from_numpy(np.random.RandomState(3).uniform(
        -0.01, 0.01, (2, M)).astype(np.float32))
    U, g, (dpre, ud, um) = pot(x, 1.0)
    kx = 1000.0 * x
    softplus = (torch.logaddexp(kx, torch.zeros_like(kx))
                + torch.logaddexp(-kx, torch.zeros_like(kx))).sum(-1)
    torch.testing.assert_close(U, ud + um + softplus, rtol=1e-6, atol=0)
    torch.testing.assert_close(g, 1000.0 * (torch.sigmoid(kx)
                                            - torch.sigmoid(-kx)),
                               rtol=1e-6, atol=1e-6)


def test_round_trip_and_numpy_forms():
    rng = np.random.RandomState(4)
    low = rng.uniform(-1, 0, 50)
    high = low + rng.uniform(0.1, 2, 50)
    mw = low + (high - low) * rng.uniform(1e-3, 1 - 1e-3, 50)
    x = tpot.mw_to_logistic(mw, low, high, 100.0)
    np.testing.assert_array_equal(
        x, jpot.mw_to_logistic(mw, low, high, 100.0))
    back = tpot.logistic_to_mw(x, low, high, 100.0, xp=np)
    np.testing.assert_allclose(back, mw, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(
        back, jpot.logistic_to_mw(x, low, high, 100.0, xp=np))
    t = tpot.logistic_to_mw(torch.from_numpy(x), torch.from_numpy(low),
                            torch.from_numpy(high), 100.0)
    np.testing.assert_allclose(t.numpy(), mw, rtol=1e-12, atol=1e-12)
    # deep in the tails the torch form saturates at the bounds
    sat = tpot.logistic_to_mw(torch.tensor([-1.0, 1.0]), 0.0, 2.0, 1000.0)
    assert sat.tolist() == [0.0, 2.0]
