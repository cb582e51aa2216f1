"""The wavelet-compressed kernel: the port's ``ops/wavelet.py`` and the
module, potential and sampler paths that use it, against the JAX package.

* The host half (the DWTs, odd lengths included, and the compressors) is
  a copy: equal bit for bit, CSR ``indptr``, ``indices`` and ``data``
  included.
* ``make_model_transform`` against the JAX one: 1e-13 relative in
  float64, 1e-6 of max in float32, 1D and 3D, batched and not, odd shapes.
* The adjoint written out: ``|<W x, y> - <x, W^T y>|`` within 1e-12 of
  ``|<W x, y>|`` in float64 on shapes that pad.
* ``predict`` and ``make_potential`` with the wavelet kernel against the
  JAX ``fn`` (value and autodiff gradient): MS and Damping, 'mandatory'
  and 'logarithmic' with the Jacobian and a temperature, 1D and 3D, with
  frozen cells; float64 within 1e-12 of max, float32 within 1e-5.
* The eager sampler on the wavelet potential with the JAX draws injected,
  against the JAX chunk sampler on ``tests/test_magnetic_wavelet.py``'s 8
  x 8 x 4 mesh: the same accept decisions, states within float32 rounding.
* Refusals and pass-through in both packages: a 3D wavelet on a carved
  mesh; CG and bootstrap give the same models with and without
  ``wavelet="1D"`` (neither solve reads ``Awcp``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from gravinv3dhmc_tpu import mesher as jmesher
from gravinv3dhmc_tpu import utils as jutils
from gravinv3dhmc_tpu.inversion import hmc as jhmc
from gravinv3dhmc_tpu.inversion import reginv as jr
from gravinv3dhmc_tpu.inversion.potential import GravMagModule as JModule
from gravinv3dhmc_tpu.ops import prism as jprism
from gravinv3dhmc_tpu.ops import wavelet as jw
from gravinv3dhmc_tpu_torch.inversion import hmc as thmc
from gravinv3dhmc_tpu_torch.inversion import reginv as tr
from gravinv3dhmc_tpu_torch.inversion.potential import GravMagModule
from gravinv3dhmc_tpu_torch.ops import wavelet as tw
from test_torch_hmc import LMAX, LMIN, jax_draws

torch.set_num_threads(2)

BOUNDS = (0, 800, 0, 800, 0, 400)
SPACING = (100, 100, 100)
#: odd and even shapes: (10, 30, 20) pads to 6210 coefficients, (7, 17, 17)
#: pads every axis
SHAPES_3D = [(4, 8, 8), (5, 7, 9), (7, 17, 17)]
LENGTHS_1D = [256, 37, 1579]
#: the sampler test's step: about half the proposals reject
DT = 0.1


@pytest.fixture(scope="module")
def problem():
    """``tests/test_magnetic_wavelet.py``'s 8 x 8 x 4 mesh, its gz data,
    and frozen-cell data for ``grav_fix``."""
    mesh = jmesher.PrismMesh(BOUNDS, SPACING)
    rho3 = np.zeros(mesh.shape)
    rho3[1:3, 3:6, 3:6] = 1.0
    mesh.addprop("density", rho3.ravel())
    obs = jutils.regular((0, 800, 0, 800), (8, 8), z=-1.0)
    dobs, _ = jprism.gz(*obs, mesh)
    fix = 0.05 * np.sin(np.arange(dobs.size))
    return obs, dobs, fix


def _modules(problem, wavelet, dtype, fixed=False):
    obs, dobs, fix = problem
    kw = dict(wavelet=wavelet, verbose=False, fixed=fixed, grav_fix=fix)
    jmod = JModule(dobs, BOUNDS, SPACING, obs,
                   dtype=jnp.float64 if dtype == torch.float64
                   else jnp.float32, **kw)
    tmod = GravMagModule(dobs, BOUNDS, SPACING, obs, dtype=dtype,
                         device="cpu", **kw)
    return jmod, tmod, dobs


@pytest.mark.parametrize("n", LENGTHS_1D)
def test_host_dwt1d_bit_for_bit(n):
    x = np.random.RandomState(n).randn(3, n)
    np.testing.assert_array_equal(tw.dwt1d(x, axis=-1), jw.dwt1d(x, axis=-1))
    np.testing.assert_array_equal(tw.dwt1d(x[0]), jw.dwt1d(x[0]))
    for lv in (1, 3):
        np.testing.assert_array_equal(tw.dwt1d(x.T, levels=lv, axis=0),
                                      jw.dwt1d(x.T, levels=lv, axis=0))


@pytest.mark.parametrize("shape", SHAPES_3D)
def test_host_dwt3d_and_compressors_bit_for_bit(shape):
    rng = np.random.RandomState(sum(shape))
    M = int(np.prod(shape))
    vol = rng.randn(2, *shape)
    np.testing.assert_array_equal(tw.dwt3d(vol), jw.dwt3d(vol))
    np.testing.assert_array_equal(tw.dwt3d(vol[0]), jw.dwt3d(vol[0]))
    Aw = rng.randn(6, M) * 10.0 ** rng.uniform(-5, 0, M)
    m = rng.randn(M)
    for got, want in ((tw.kernelcompressor_1d(Aw), jw.kernelcompressor_1d(Aw)),
                      (tw.kernelcompressor_3d(Aw, shape),
                       jw.kernelcompressor_3d(Aw, shape))):
        assert want.nnz < want.shape[0] * want.shape[1]   # some thresholded
        for k in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
        assert (tw.compression_ratio(got, Aw.shape)
                == jw.compression_ratio(want, Aw.shape))
    c1, c3 = jw.kernelcompressor_1d(Aw), jw.kernelcompressor_3d(Aw, shape)
    np.testing.assert_array_equal(tw.modelcompressor_1d(m, c1),
                                  jw.modelcompressor_1d(m, c1))
    np.testing.assert_array_equal(tw.modelcompressor_3d(m, c3, shape),
                                  jw.modelcompressor_3d(m, c3, shape))


def _transform_cases():
    for n in LENGTHS_1D:
        yield "1D", None, n
    for s in SHAPES_3D:
        yield "3D", s, int(np.prod(s))


@pytest.mark.parametrize("mode,shape,M", list(_transform_cases()))
def test_model_transform_matches_jax(mode, shape, M):
    jt = jax.jit(jw.make_model_transform(mshape=shape, mode=mode))
    tt = tw.make_model_transform(mshape=shape, mode=mode)
    x = np.random.RandomState(M).randn(3, M)
    K = (jw.dwt1d(x) if mode == "1D"
         else jw.dwt3d(x.reshape((3,) + shape))).shape[-1]
    for batch in (x.reshape(3, 1, M), x[0]):
        want = np.asarray(jt(jnp.asarray(batch)))
        got = tt(torch.from_numpy(batch)).numpy()
        assert got.shape == want.shape == batch.shape[:-1] + (K,)
        np.testing.assert_allclose(got, want, rtol=1e-13,
                                   atol=1e-13 * np.abs(want).max())
    want32 = np.asarray(jt(jnp.asarray(x, jnp.float32)))
    got32 = tt(torch.from_numpy(x).float()).numpy()
    assert got32.dtype == np.float32
    assert np.abs(got32 - want32).max() <= 1e-6 * np.abs(want32).max()


@pytest.mark.parametrize("mode,shape,M", list(_transform_cases()))
def test_adjoint(mode, shape, M):
    """<W x, y> = <x, W^T y> in float64, batched, on shapes that pad; and
    W^T W x = x (W is an isometry before thresholding)."""
    tt = tw.make_model_transform(mshape=shape, mode=mode)
    rng = np.random.RandomState(M + 1)
    x = torch.from_numpy(rng.randn(4, M))
    y = torch.from_numpy(rng.randn(4, tt(x).shape[-1]))
    lhs = (tt(x) * y).sum(-1)
    rhs = (x * tt.adjoint(y, M)).sum(-1)
    assert ((lhs - rhs).abs() <= 1e-12 * lhs.abs()).all(), (lhs, rhs)
    back = tt.adjoint(tt(x), M)
    assert (back - x).abs().max() <= 1e-10 * x.abs().max()
    assert tt.adjoint(y[0], M).shape == (M,)


def test_transform_refuses_unknown_modes():
    with pytest.raises(ValueError):
        tw.make_model_transform(mode="2D")
    with pytest.raises(ValueError):
        tw.make_model_transform(mode="3D")
    with pytest.raises(ValueError):
        tw.make_model_transform(mode="1D").adjoint(torch.zeros(4))


@pytest.mark.parametrize("wavelet", ["1D", "3D"])
def test_module_and_predict_match_jax(problem, wavelet):
    """The same thresholded ``Awcp`` (nonzero set and values), staged with
    its transpose as CSR tensors; ``predict`` with and without the
    wavelet."""
    jmod, tmod, _ = _modules(problem, wavelet, torch.float64)
    for k in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(tmod.Awcp, k),
                                      getattr(jmod.Awcp, k))
    arrs = tmod.device_arrays()
    assert arrs["Awcp"].layout == torch.sparse_csr
    assert arrs["AwcpT"].layout == torch.sparse_csr
    np.testing.assert_array_equal(arrs["AwcpT"].to_dense().numpy(),
                                  jmod.Awcp.T.toarray())
    M = jmod.n_active
    mw = jmod.wdiag * np.random.RandomState(2).uniform(0, 1, (3, M))
    for use in (None, True, False):
        for m in (mw, mw[0]):
            want = np.asarray(jmod.predict(jnp.asarray(m), use_wavelet=use))
            got = tmod.predict(m, use_wavelet=use).numpy()
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-12 * np.abs(want).max())
    # the compressed operator is close to the dense one
    dense = tmod.predict(mw, use_wavelet=False).numpy()
    comp = tmod.predict(mw).numpy()
    assert np.abs(comp - dense).max() < 1e-2 * np.abs(dense).max()
    # the wavelet potential reads the staged CSR pair and no dense matrix
    w = tmod.wdiag
    pot = tmod.make_potential(w * 0.001, 0 * w, w)
    assert "Aw" not in pot.params
    assert pot.params["Awcp"] is arrs["Awcp"]
    assert pot.params["AwcpT"] is arrs["AwcpT"]
    assert "Awcp" not in tmod.make_potential(w * 0.001, 0 * w, w,
                                             use_wavelet=False).params


@pytest.mark.parametrize("wavelet", ["1D", "3D"])
def test_dense_reference_step(problem, wavelet):
    """``chip_smoke.py``'s wavelet reference: ``Awcp W`` built from the
    host DWT of the identity (no code shared with the torch transform, its
    adjoint or the CSR products) is the wavelet operator, and a float64
    leapfrog step through the dense potential on it equals the sparse
    path's within 1e-12."""
    import chip_smoke

    _, tmod, _ = _modules(problem, wavelet, torch.float64)
    dev = torch.device("cpu")
    B = chip_smoke.wavelet_dense(torch, tmod, dev, chunk=100)
    M = tmod.n_active
    assert B.shape == (tmod.Awcp.shape[0], M)
    rng = np.random.RandomState(4)
    w = tmod.wdiag
    x = torch.as_tensor(w * rng.uniform(0.2, 0.4, (3, M)))
    p = torch.as_tensor(rng.normal(0, 1e-3, (3, M)))
    np.testing.assert_allclose(tmod.predict(x).numpy(), (x @ B.T).numpy(),
                               rtol=0, atol=1e-12 * float(B.abs().max()))
    args, kw = (w * 0.001, 0 * w, w), dict(regularization="MS", beta=0.001)
    ref = tmod.make_potential(*args, **kw, use_wavelet=False)
    ref.params["Aw"] = B
    want = chip_smoke.leapfrog_step(ref, x, p, 0.01, torch.float64)
    got = chip_smoke.leapfrog_step(tmod.make_potential(*args, **kw), x, p,
                                   0.01, torch.float64)
    for a, b in zip(got, want):
        assert chip_smoke.rel_err(a, b)[1] <= 1e-12


POTENTIAL_CASES = [
    ("MS", "mandatory", False, 1.0, False),
    ("Damping", "mandatory", False, 1.0, True),
    ("MS", "logarithmic", True, 2.5, False),
    ("Damping", "logarithmic", True, 2.5, True),
]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("wavelet", ["1D", "3D"])
@pytest.mark.parametrize("reg,constraint,jac,temp,fixed", POTENTIAL_CASES)
def test_potential_matches_jax(problem, wavelet, dtype, reg, constraint,
                               jac, temp, fixed):
    jmod, tmod, _ = _modules(problem, wavelet, dtype, fixed=fixed)
    M = jmod.n_active
    w = np.asarray(jmod.wdiag)
    kw = dict(constraint=constraint, regularization=reg, beta=0.001,
              jacobian=jac, temperature=temp)
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    jpot = jmod.make_potential(w * 0.001, 0 * w, w, dtype=jd, **kw)
    tpot = tmod.make_potential(w * 0.001, 0 * w, w, dtype=dtype, **kw)
    rng = np.random.RandomState(5)
    x = (rng.normal(0, 3e-3, (3, M)) if constraint == "logarithmic"
         else w * rng.uniform(0, 0.5, (3, M)))
    f64 = dtype == torch.float64
    for xb in ((x, x[0]) if f64 else (x,)):
        U_j, g_j, (d_j, ud_j, um_j) = jpot(jnp.asarray(xb, jd), 1.3)
        U_t, g_t, (d_t, ud_t, um_t) = tpot(torch.as_tensor(xb, dtype=dtype),
                                           1.3)
        tol = 1e-12 if f64 else 1e-5
        for got, want in ((U_t, U_j), (g_t, g_j), (d_t, d_j), (ud_t, ud_j),
                          (um_t, um_j)):
            want = np.asarray(want, np.float64)
            err = np.abs(got.numpy().astype(np.float64) - want).max()
            assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())
        assert g_t.dtype == dtype
    if not f64 or constraint == "logarithmic":
        return
    # the use_wavelet=False potential is the dense one
    dense = tmod.make_potential(w * 0.001, 0 * w, w, dtype=dtype,
                                use_wavelet=False, **kw)
    ref = jmod.make_potential(w * 0.001, 0 * w, w, dtype=jd,
                              use_wavelet=False, **kw)
    got = dense(torch.as_tensor(x, dtype=dtype), 1.3)[1].numpy()
    want = np.asarray(ref(jnp.asarray(x, jd), 1.3)[1])
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("wavelet", ["1D", "3D"])
def test_eager_sampler_matches_jax(problem, wavelet):
    """A few iterations of the eager chunk sampler on the wavelet potential
    (shared L; the JAX sampler's draws injected) against JAX
    ``make_chunk_sampler``: the same accept decisions and L, states and
    stored rows within float32 rounding (5e-4 of max); and
    ``HamiltonianMC`` with ``use_fused=True`` takes the eager path."""
    jmod, tmod, dobs = _modules(problem, wavelet, torch.float32)
    M = jmod.n_active
    C, nsamples, chunk = 8, 8, 6
    w = np.asarray(jmod.wdiag)
    aprior, low, high = 0.001 * w, 0 * w, w
    common = dict(dt=DT, Lmin=LMIN, Lmax=LMAX, Sigma=0.001, low=low,
                  high=high, constraint="mandatory", alpha=1.0,
                  chunk_size=chunk, nsamples=nsamples, ndraws=0,
                  wdiag_inv=jmod.wdiag_inv, data_size=dobs.size,
                  shared_L=True, store_mode="accepted")
    jpot = jmod.make_potential(aprior, low, high, regularization="MS",
                               beta=0.001, dtype=jnp.float32)
    run_j = jhmc.make_chunk_sampler(jpot, dtype=jnp.float32, **common)
    x0 = (w * np.random.RandomState(4).uniform(0.2, 0.4, (C, M))).astype(
        np.float32)
    U, g, (_, ud, um) = jpot(jnp.asarray(x0), 1.0)
    carry_j = (jnp.asarray(x0), U, g, ud, um, jnp.zeros(C, jnp.int32),
               jnp.zeros((C, nsamples, M), jnp.float32),
               jnp.zeros((C, nsamples, 7), jnp.float32))
    seed = 11
    c_j, s_j = run_j(carry_j, random.fold_in(random.PRNGKey(seed), 0), 0,
                     jpot.params)
    tpot = tmod.make_potential(aprior, low, high, regularization="MS",
                               beta=0.001)
    run_t = thmc.make_chunk_sampler(
        tpot, draws=jax_draws(seed, chunk, C, M), device="cpu", **common)
    xt = torch.from_numpy(x0)
    U, g, (_, ud, um) = tpot(xt, 1.0)
    carry_t = (xt, U, g, ud, um, torch.zeros(C, dtype=torch.int32),
               torch.zeros((C, nsamples, M)), torch.zeros((C, nsamples, 7)))
    c_t, s_t = run_t(carry_t, seed, 0)
    s_j, s_t = np.asarray(s_j), s_t.numpy()
    np.testing.assert_array_equal(s_t[..., 0], s_j[..., 0])   # accepts
    np.testing.assert_array_equal(s_t[..., 4], s_j[..., 4])   # L
    assert 0 < s_j[..., 0].mean() < 1
    np.testing.assert_array_equal(c_t[5].numpy(), np.asarray(c_j[5]))
    for got, want in ((c_t[0], c_j[0]), (c_t[6], c_j[6])):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 5e-4 * np.abs(want).max()

    chain = thmc.HamiltonianMC(tmod)
    chain.device = "cpu"
    chain.use_fused = True
    chain.low, chain.high = low, high
    chain.aprior_model = aprior
    chain.initial_model = 0.3 * w
    chain.dobs = dobs
    chain.nchains, chain.chunk_size = 32, 4
    assert chain._build_fused("cpu") == (None, None)
    assert chain._fused_mode == "off"


def test_carved_3d_wavelet_refused_by_both():
    """A 3D wavelet on a carved mesh: the JAX module fails in the 3D
    compressor's reshape, the port says why before building."""
    bounds, spacing = (0, 400, 0, 500, 0, 600), (100, 100, 100)
    xo, yo = np.meshgrid(np.linspace(50, 350, 5), np.linspace(50, 450, 6))
    xo, yo = xo.ravel(), yo.ravel()
    topo = 150.0 + 150.0 * (xo > 200)
    obs = (xo, yo, np.full(xo.size, -1.0))
    dobs = np.zeros(xo.size)
    kw = dict(verbose=False, mtopo=(xo, yo, -topo))
    with pytest.raises(ValueError):
        JModule(dobs, bounds, spacing, obs, wavelet="3D", **kw)
    with pytest.raises(ValueError, match="3D wavelet"):
        GravMagModule(dobs, bounds, spacing, obs, wavelet="3D",
                      device="cpu", **kw)
    jmod = JModule(dobs, bounds, spacing, obs, wavelet="1D", **kw)
    tmod = GravMagModule(dobs, bounds, spacing, obs, wavelet="1D",
                         device="cpu", **kw)
    assert not tmod.mesh.active.all()
    assert tmod.Awcp.shape == jmod.Awcp.shape
    np.testing.assert_array_equal(tmod.Awcp.toarray(), jmod.Awcp.toarray())


def test_cg_and_bootstrap_ignore_the_wavelet(problem):
    """``ConjugateGradient.CG`` and ``BootStrap.BSCG`` solve on the dense
    ``Aw`` in both packages: with ``wavelet="1D"`` the modules build
    ``Awcp``, and the models are the same bit for bit as without it."""
    obs, dobs, _ = problem
    M = 256
    for pkg, kw in ((jr, {}), (tr, {"device": "cpu"})):
        res = []
        for wl in (False, "1D"):
            cg = pkg.ConjugateGradient(dobs, BOUNDS, SPACING, obs,
                                       wavelet=wl, verbose=False, **kw)
            assert (cg._mod.Awcp is not None) == bool(wl)
            model, _, d_h, _, _ = cg.CG(np.zeros(M), np.zeros(M), (0.0, 1.0),
                                        maxk=15)
            bs = pkg.BootStrap(BOUNDS, SPACING, obs, dobs, (0.0, 1.0),
                               samples=2, maxk=10, wavelet=wl, verbose=False,
                               **kw)
            res.append((model, d_h, bs.BSCG(np.zeros(M))[0]))
        for a, b in zip(*res):
            np.testing.assert_array_equal(a, b)


def test_uniformgrid_wavelet_stage():
    """``uniformgrid.run_wavelet`` at a small size on the CPU: the eager
    path, the module's ``Awcp``, the sparse products' shapes."""
    from gravinv3dhmc_tpu_torch import uniformgrid

    for mode in ("1D", "3D"):
        problem = uniformgrid.build_problem(6, 8, 4, device="cpu",
                                            wavelet=mode)
        line, res = uniformgrid.run_wavelet("cpu", mode, problem,
                                            nsamples=4, ndraws=4)
        assert line["fused_mode"] == "off" and line["mode"] == mode
        assert line["Awcp"][0] == list(problem[0].Awcp.shape)
        assert line["iterations"] == uniformgrid.WAVELET["chunk"]
        assert 0 < line["accept_ratio"] <= 1 and line["ms_per_step"] > 0
        assert torch.isfinite(res["samples"]).all()
        for name, (fn, dense) in uniformgrid.sparse_products(
                problem[0], "cpu", 5).items():
            assert fn().shape[1] == dense().shape[1] == 5
