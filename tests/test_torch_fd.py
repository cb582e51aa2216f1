"""The finite-difference regularizers: the port's ``ops.fd`` against the
JAX package's on the same seeded inputs, its written-out gradients
against ``jax.grad`` of the JAX functionals (float64, rtol 1e-12), and
the Smoothness and TV potentials on a topography-carved mesh against the
JAX ``make_potential`` (float32, within 1e-5 of max|value|)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravinv3dhmc_tpu.inversion.potential import GravMagModule as JModule
from gravinv3dhmc_tpu.ops import fd as jfd
from gravinv3dhmc_tpu_torch.inversion.potential import GravMagModule
from gravinv3dhmc_tpu_torch.ops import fd

torch.set_num_threads(2)

SHAPE = (3, 4, 5)
BETA = 0.01
GRAD_RTOL = 1e-12
POT_RTOL = 1e-5


def _inputs(batch=()):
    rng = np.random.RandomState(7)
    v = rng.randn(*batch, int(np.prod(SHAPE)))
    act = rng.rand(*SHAPE) > 0.3
    return v, act


@pytest.mark.parametrize("masked", [False, True])
def test_grid_diffs_and_values_match_jax(masked):
    v, act = _inputs()
    a = act if masked else None
    ja = jnp.asarray(act) if masked else None
    for t, j in zip(fd.grid_diffs(torch.from_numpy(v), SHAPE, torch, a),
                    jfd.grid_diffs(jnp.asarray(v), SHAPE, jnp, ja)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert float(fd.smoothness_value(torch.from_numpy(v), SHAPE, torch, a)) \
        == pytest.approx(float(jfd.smoothness_value(jnp.asarray(v), SHAPE,
                                                    jnp, ja)), rel=1e-14)
    assert float(fd.tv_value(torch.from_numpy(v), SHAPE, BETA, torch, a)) \
        == pytest.approx(float(jfd.tv_value(jnp.asarray(v), SHAPE, BETA,
                                            jnp, ja)), rel=1e-14)


@pytest.mark.parametrize("name", ["Smoothness", "TV"])
@pytest.mark.parametrize("masked", [False, True])
def test_gradients_match_jax_grad(name, masked):
    v, act = _inputs()
    a = act if masked else None
    ja = jnp.asarray(act) if masked else None
    if name == "Smoothness":
        def f(x):
            return jfd.smoothness_value(x, SHAPE, jnp, ja)
    else:
        def f(x):
            return jfd.tv_value(x, SHAPE, BETA, jnp, ja)
    jv, jg = jax.value_and_grad(f)(jnp.asarray(v))
    tv, tg = fd.value_and_grad(name, torch.from_numpy(v), SHAPE, BETA, a)
    assert float(tv) == pytest.approx(float(jv), rel=1e-14)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * np.abs(np.asarray(jg)).max())


def test_batched_rows_equal_single_rows():
    v, act = _inputs((3,))
    val, g = fd.value_and_grad("TV", torch.from_numpy(v), SHAPE, BETA, act)
    for i in range(3):
        vi, gi = fd.value_and_grad("TV", torch.from_numpy(v[i]), SHAPE, BETA,
                                   act)
        assert float(val[i]) == pytest.approx(float(vi), rel=1e-15)
        np.testing.assert_allclose(g[i].numpy(), gi.numpy(), rtol=1e-15)


def test_fd3d_matrix_equals_grid_diffs():
    """``R3d @ v`` holds the differences in the reference's row order:
    per layer its x then y differences, then the z differences."""
    v, _ = _inputs()
    R = fd.fd3d_matrix(SHAPE)
    assert (R != jfd.fd3d_matrix(SHAPE)).nnz == 0
    dx, dy, dz = (t.numpy() for t in fd.grid_diffs(torch.from_numpy(v),
                                                    SHAPE))
    rows = np.concatenate([np.concatenate([dx[k].ravel(), dy[k].ravel()])
                           for k in range(SHAPE[0])] + [dz.ravel()])
    np.testing.assert_allclose(R @ v, rows, rtol=0, atol=1e-15)
    np.testing.assert_allclose(
        fd.value_and_grad("Smoothness", torch.from_numpy(v), SHAPE,
                          0.0)[1].numpy(),
        2.0 * R.T @ (R @ v), rtol=1e-13, atol=1e-13)


@pytest.fixture(scope="module")
def carved_modules():
    """A 6 x 5 x 4 prism mesh carved under a sloping topography (its top
    layers partly removed), the same arguments to both packages."""
    bounds = (0, 600, 0, 500, -200, 200)
    spacing = (100, 100, 100)
    xo, yo = np.meshgrid(np.arange(50, 600, 100.0), np.arange(50, 500, 100.0))
    xo, yo = xo.ravel(), yo.ravel()
    zo = np.full(xo.size, -250.0)
    topo = 150.0 - 0.4 * xo
    dobs = np.random.RandomState(3).normal(0, 1, xo.size)
    kw = dict(verbose=False, mtopo=(xo, yo, topo))
    jm = JModule(dobs, bounds, spacing, (xo, yo, zo), **kw)
    tm = GravMagModule(dobs, bounds, spacing, (xo, yo, zo), device="cpu", **kw)
    return jm, tm


@pytest.mark.parametrize("regularization", ["Smoothness", "TV"])
def test_carved_potential_matches_jax(carved_modules, regularization):
    jm, tm = carved_modules
    assert tm._active3d is not None and jm._active3d is not None
    np.testing.assert_array_equal(tm._active3d, jm._active3d)
    M = tm.n_active
    assert M < int(np.prod(tm.mshape))
    w = np.asarray(tm.wdiag)
    aprior, low, high = 0.05 * w, -1.0 * w, 1.0 * w
    x = (w * np.random.RandomState(1).uniform(-0.8, 0.8, (3, M))).astype(
        np.float32)
    kw = dict(regularization=regularization, beta=BETA)
    U_j, g_j, (_, ud_j, um_j) = jm.make_potential(
        aprior, low, high, dtype=jnp.float32, **kw)(jnp.asarray(x), 0.3)
    U_t, g_t, (_, ud_t, um_t) = tm.make_potential(
        aprior, low, high, **kw)(torch.from_numpy(x), 0.3)
    for t, j in ((U_t, U_j), (g_t, g_j), (ud_t, ud_j), (um_t, um_j)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=POT_RTOL * np.abs(j).max())
