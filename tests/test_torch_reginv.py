"""The port's CG and bootstrap against the JAX package's on
``tests/test_reginv.py``'s 750-prism problem, float64 unless stated.

``_make_cg_core`` is fed the JAX module's ``Aw`` and ``wdiag`` on both
sides and run step for step for every regularizer, adaptive and with a
fixed alpha, with and without ``keep_best``, under both stop modes, on
the noisy data toward a non-zero prior and on a tenth of the noise-free
data (where most runs stop early and the histories get their NaN tails):
the histories and the models agree within rtol 1e-9 and ``n_iters`` is
identical. The run lengths are short (``MAXK``): projected
Fletcher-Reeves amplifies rounding, by about ten times every ten
iterations on the Smoothness case, so two float64 implementations that
sum in other orders part after a few dozen iterations. The starts are
non-zero: from zero the k = 0 step stays inside the box, and its step
(twice the exact line search, the reference's) lands on the start's
level set, so ``keep_best``'s first comparison would be a tie that
rounding decides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravinv3dhmc_tpu import mesher, utils
from gravinv3dhmc_tpu.inversion import reginv as jr
from gravinv3dhmc_tpu.inversion.potential import GravMagModule as JModule
from gravinv3dhmc_tpu.ops import prism
from gravinv3dhmc_tpu_torch.inversion import reginv as tr
from gravinv3dhmc_tpu_torch.inversion.potential import GravMagModule

torch.set_num_threads(2)

RTOL = 1e-9
MAXK = 20
BOUNDS = (0, 1000, 0, 1500, 0, 500)
SPACING = (100, 100, 100)


@pytest.fixture(scope="module")
def problem():
    """``tests/test_reginv.py``'s problem: the JAX ``ConjugateGradient``,
    the port's on the same arguments, the noisy and the noise-free data and
    the truth."""
    mesh = mesher.PrismMesh(BOUNDS, SPACING)
    rho3 = np.zeros(mesh.shape)
    rho3[1:4, 5:10, 3:7] = 0.8
    mesh.addprop("density", rho3.ravel())
    xo, yo, zo = utils.regular((0, 1000, 0, 1500), (10, 15), z=0.0)
    clean, _ = prism.gz(xo, yo, zo, mesh)
    dobs = utils.contaminate(clean, 0.02 * clean.max(), seed=4)
    obs = (xo, yo, zo)
    jinv = jr.ConjugateGradient(dobs, BOUNDS, SPACING, obs, verbose=False)
    tinv = tr.ConjugateGradient(dobs, BOUNDS, SPACING, obs, verbose=False,
                                device="cpu")
    return jinv, tinv, dobs, clean, rho3.ravel()


def _close(t, j, rtol=RTOL):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j, np.float64)
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    ok = ~np.isnan(j)
    np.testing.assert_allclose(t[ok], j[ok], rtol=0,
                               atol=rtol * np.abs(j[ok]).max())


#: (fixed alpha, keep_best, stop mode)
MODES = {"adaptive": (False, False, "normalized"),
         "adaptive_best": (False, True, "absolute"),
         "fixed": (True, False, "absolute"),
         "fixed_best": (True, True, "normalized")}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("regularization", ["MS", "Damping", "Smoothness",
                                            "TV"])
@pytest.mark.parametrize("data", ["noisy", "clean"])
def test_cg_core_step_for_step(problem, regularization, mode, data):
    jinv, _, dobs, clean, _ = problem
    fixed, keep_best, stop = MODES[mode]
    M = jinv.msize
    noisy = data == "noisy"
    d = dobs if noisy else 0.1 * clean
    apr = jinv.wdiag * 0.05 if noisy else None
    args = (jinv.Aw, d, jinv.wdiag, jinv.wdiag_inv, jinv.mshape, None,
            regularization, 0.01, 0.7, MAXK, 0.0, 1.0, stop)
    kw = dict(aprior_mw=apr, fixed_alpha=fixed, keep_best=keep_best)
    js = jax.jit(jr._make_cg_core(*args, jnp.float64, **kw))
    ts = tr._make_cg_core(*args, torch.float64, device="cpu", **kw)
    mw0 = jinv.wdiag * (0.1 if noisy else 0.05)
    c = np.ones(jinv.dsize)
    a = (None, 0.5) if fixed else ()
    jo = js(mw0, c, *a)
    to = ts(mw0, c, *a)
    assert int(to[4]) == int(jo[4])
    for t, j in zip(to[:4], jo[:4]):
        _close(t, j)
    assert to[0].shape == (M,)


@pytest.mark.parametrize("stop", ["normalized", "absolute"])
def test_stop_freezes_the_state(problem, stop):
    """A run that stops (MS at a fixed alpha on a tenth of the noise-free
    data): the same iteration, the histories NaN from there on, the model
    the frozen one."""
    jinv, _, _, clean, _ = problem
    args = (jinv.Aw, 0.1 * clean, jinv.wdiag, jinv.wdiag_inv, jinv.mshape,
            None, "MS", 0.01, 0.7, MAXK, 0.0, 1.0, stop)
    mw0 = jinv.wdiag * 0.05
    jo = jax.jit(jr._make_cg_core(*args, jnp.float64, fixed_alpha=True))(
        mw0, np.ones(jinv.dsize), None, 0.5)
    to = tr._make_cg_core(*args, torch.float64, fixed_alpha=True,
                          device="cpu")(mw0, np.ones(jinv.dsize), None, 0.5)
    n = int(jo[4])
    # stopped before the first read of the all-done flag, which ends the
    # loop there
    assert int(to[4]) == n < tr.CHECK_EVERY < MAXK
    assert torch.isnan(to[1][n:]).all() and not torch.isnan(to[1][:n]).any()
    for t, j in zip(to[:4], jo[:4]):
        _close(t, j)


def test_batched_rows_match_jax_vmap(problem):
    """Three sets of row weights in one ``(S, M)`` solve against the JAX
    core under ``vmap`` over the weights."""
    jinv, _, dobs, _, _ = problem
    args = (jinv.Aw, dobs, jinv.wdiag, jinv.wdiag_inv, jinv.mshape, None,
            "MS", 0.01, 0.9, MAXK, 0.0, 1.0, "absolute")
    js = jax.jit(jax.vmap(jr._make_cg_core(*args, jnp.float64,
                                           bootstrap_ms=True),
                          in_axes=(None, 0)))
    ts = tr._make_cg_core(*args, torch.float64, bootstrap_ms=True,
                          device="cpu")
    c = np.random.RandomState(2).poisson(1.0, (3, jinv.dsize)).astype(float)
    mw0 = np.zeros(jinv.msize)
    jo, to = js(mw0, c), ts(mw0, c)
    np.testing.assert_array_equal(to[4].numpy(), np.asarray(jo[4]))
    for t, j in zip(to[:4], jo[:4]):
        assert t.shape == np.asarray(j).shape
        _close(t, j)


def test_modules_match_jax(problem):
    jinv, tinv, _, _, _ = problem
    for name in ("A", "Aw", "wdiag", "wdiag_inv"):
        np.testing.assert_array_equal(getattr(tinv, name),
                                      getattr(jinv, name))
    assert (tinv.dsize, tinv.msize, tinv.mshape) == \
        (jinv.dsize, jinv.msize, jinv.mshape)
    for t, j in zip(tinv._mod.kernelw(), jinv._mod.kernelw()):
        np.testing.assert_array_equal(t, j)
    arrs = tinv._mod.device_arrays(torch.float32)
    assert arrs is tinv._mod.device_arrays(torch.float32)
    assert arrs["Aw"].dtype == torch.float32 and arrs["grav_fix"] is None
    assert tinv._mod._active3d is None


def test_conjugate_gradient_matches_jax(problem):
    jinv, tinv, _, _, _ = problem
    M = jinv.msize
    kw = dict(regularization="MS", beta=0.001, q=0.7, maxk=MAXK)
    jo = jinv.CG(np.zeros(M), np.zeros(M), (0.0, 1.0), **kw)
    to = tinv.CG(np.zeros(M), np.zeros(M), (0.0, 1.0), **kw)
    for t, j in zip(to, jo):
        assert isinstance(t, np.ndarray) and t.shape == j.shape
        _close(t, j)
    _close(tinv.result["m"], jo[0])
    assert tinv.data(tinv.wdiag * to[0]) == pytest.approx(
        jinv.data(jinv.wdiag * jo[0]), rel=RTOL)


def test_bootstrap_matches_jax(problem):
    jinv, _, dobs, _, _ = problem
    kw = dict(samples=4, beta=0.01, maxk=12, verbose=False)
    obs = (jinv._mod.lonobs, jinv._mod.latobs, jinv._mod.heightobs)
    jb = jr.BootStrap(BOUNDS, SPACING, obs, dobs, (0.0, 1.0), **kw)
    tb = tr.BootStrap(BOUNDS, SPACING, obs, dobs, (0.0, 1.0), device="cpu",
                      **kw)
    np.testing.assert_array_equal(tb.resample_weights(), jb.resample_weights())
    jo = jb.BSCG(np.zeros(jb.msize))
    to = tb.BSCG(np.zeros(tb.msize), batch=3)
    for t, j in zip(to, jo):
        assert t.shape == j.shape
        _close(t, j)
    assert tb.result["mw"].shape == (4, tb.msize)


def test_cg_device_f32_restarts(problem):
    """A fixed-alpha solve past one segment, float32 on both sides: maxk
    1700 runs as three restarted segments of 800 iterations (2,400 in
    all, as the JAX package runs them). The iteration counts and the alpha
    history are identical; float32 projected Fletcher-Reeves parts by
    rounding after about ten iterations, so the data misfits are held over
    the first ten (rtol 1e-4), and then the least objective (rtol 1e-5)
    and the best model (within 1e-4 of the box) the solves reach."""
    jinv, tinv, dobs, _, _ = problem
    D, M = jinv.dsize, jinv.msize
    kw = dict(regularization="Damping", maxk=1700, alpha=0.5)
    jo = jr.cg_device(jinv._mod, dobs, (0.0, 1.0), dtype=jnp.float32, **kw)
    to = tr.cg_device(tinv._mod, dobs, (0.0, 1.0), dtype=torch.float32, **kw)
    assert to["n_iters"] == jo["n_iters"] == to["data_hist"].size == 2400
    assert to["mw"].dtype == torch.float32
    np.testing.assert_array_equal(to["regul_hist"], jo["regul_hist"])
    np.testing.assert_allclose(to["data_hist"][:10], jo["data_hist"][:10],
                               rtol=1e-4)

    def objective(o):
        return np.min(D * o["data_hist"] + 0.5 * M * o["model_hist"])

    assert objective(to) == pytest.approx(objective(jo), rel=1e-5)
    np.testing.assert_allclose(to["m"].numpy(), np.asarray(jo["m"]), rtol=0,
                               atol=1e-4)
    one = tr.cg_device(tinv._mod, dobs, (0.0, 1.0), dtype=torch.float32,
                       segment=None, **kw)
    assert one["n_iters"] == 1700


def test_carved_smoothness_refused_by_both():
    """Smoothness and TV on a topography-carved mesh: the JAX package's
    ``fd.grid_diffs`` cannot reshape the packed active cells (TypeError);
    the port refuses with a ValueError."""
    xo, yo = np.meshgrid(np.arange(50, 600, 100.0), np.arange(50, 500, 100.0))
    xo, yo = xo.ravel(), yo.ravel()
    obs = (xo, yo, np.full(xo.size, -250.0))
    bounds = (0, 600, 0, 500, -200, 200)
    dobs = np.random.RandomState(3).normal(0, 1, xo.size)
    kw = dict(verbose=False, mtopo=(xo, yo, 150.0 - 0.4 * xo))
    jinv = jr.ConjugateGradient(dobs, bounds, SPACING, obs, **kw)
    tinv = tr.ConjugateGradient(dobs, bounds, SPACING, obs, device="cpu",
                                **kw)
    M = tinv.msize
    assert tinv._mod._active3d is not None and len(tinv.mask) > 0
    for reg in ("Smoothness", "TV"):
        with pytest.raises(TypeError):
            jinv.CG(np.zeros(M), np.zeros(M), (0.0, 1.0),
                    regularization=reg, maxk=3)
        with pytest.raises(ValueError, match="carved"):
            tinv.CG(np.zeros(M), np.zeros(M), (0.0, 1.0),
                    regularization=reg, maxk=3)
    # the other regularizers run on the carved mesh
    out = tinv.CG(np.zeros(M), np.zeros(M), (0.0, 1.0),
                  regularization="Damping", maxk=3)
    assert np.isfinite(out[0]).all()


def test_predict_leaves_grav_fix_out():
    """``predict`` with a non-zero frozen-cell field equals the JAX
    module's: ``mw @ Aw.T``, ``grav_fix`` not added (float32)."""
    xo, yo, zo = utils.regular((0, 600, 0, 500), (6, 5), z=0.0)
    dobs = np.random.RandomState(5).normal(0, 1, xo.size)
    fix = np.random.RandomState(6).normal(0, 3, xo.size)
    args = (dobs, (0, 600, 0, 500, 0, 300), SPACING, (xo, yo, zo))
    kw = dict(fixed=True, grav_fix=fix, verbose=False)
    jm = JModule(*args, **kw)
    tm = GravMagModule(*args, device="cpu", **kw)
    mw = np.random.RandomState(7).uniform(0, 1, (2, tm.n_active)) \
        * tm.wdiag
    mw = mw.astype(np.float32)
    j = np.asarray(jm.predict(jnp.asarray(mw)))
    t = tm.predict(torch.from_numpy(mw))
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), j, rtol=0,
                               atol=1e-6 * np.abs(j).max())
    np.testing.assert_allclose(t.numpy(), mw @ tm.Aw.T.astype(np.float32),
                               rtol=1e-5)


def test_entry_points_need_a_card(problem, monkeypatch):
    _, tinv, dobs, _, _ = problem
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    obs = (tinv._mod.lonobs, tinv._mod.latobs, tinv._mod.heightobs)
    with pytest.raises(RuntimeError):
        tr.ConjugateGradient(dobs, BOUNDS, SPACING, obs, verbose=False)
    with pytest.raises(RuntimeError):
        tr.BootStrap(BOUNDS, SPACING, obs, dobs, (0.0, 1.0), verbose=False)
    with pytest.raises(RuntimeError):
        tr._make_cg_core(tinv.Aw, dobs, tinv.wdiag, tinv.wdiag_inv,
                         tinv.mshape, None, "MS", 0.01, 0.7, 3, 0.0, 1.0,
                         "normalized", torch.float64)
