"""The port's per-step op and the chunk sampler's per-step branch against
the JAX package's ``make_fused_step`` (Pallas ``_step_kernel`` run with
``interpret=True``, as ``tests/test_leapfrog_pallas.py`` runs it) and its
``make_chunk_sampler(fused_step=...)``.

Both sides get the same state through ``params_from_jax``. Tolerances:
f32 as ``tests/test_leapfrog_pallas.py:61-69`` holds the JAX step against
its potential (the two sides sum the products in different orders); bf16
relative to each output's largest value, as the port's trajectory tests
hold it (an x one f32 ulp apart can round to neighbouring bf16 values).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import random

from gravinv3dhmc_tpu.inversion import hmc as jhmc
from gravinv3dhmc_tpu.ops import leapfrog_pallas as jlf
from gravinv3dhmc_tpu_torch.inversion import hmc as thmc
from gravinv3dhmc_tpu_torch.inversion.potential import GravMagModule
from gravinv3dhmc_tpu_torch.ops import leapfrog as tlf

from test_torch_hmc import LMAX, LMIN, jax_draws

torch.set_num_threads(2)

#: f32 (rtol, atol) per output: x and U as the JAX step's own test; p
#: carries 2 eps A^T r summed in another order
F32_TOL = {"x": (1e-6, 1e-6), "p": (2e-3, 2e-4), "U": (2e-4, 0),
           "ud": (2e-4, 0), "um": (2e-4, 1e-5)}
#: bf16: error over the output's largest |value|
BF16_REL_TOL = {"x": 1e-4, "p": 2e-3, "U": 1e-5, "ud": 1e-5, "um": 1e-5}


def _fargs(module, dobs, grav_fix):
    M = module.n_active
    w = np.asarray(module.wdiag)
    return (np.asarray(module.Aw), np.asarray(dobs) - np.mean(dobs),
            grav_fix, w * np.full(M, 0.001), w * w, w * np.zeros(M),
            w * np.ones(M))


def _np_params(prm):
    return {k: np.asarray(v) for k, v in prm.items()}


@pytest.mark.parametrize("fix", [False, True])
@pytest.mark.parametrize("inv_mass", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reg", ["MS", "Damping"])
def test_step_matches_jax_kernel(small_module, reg, dtype, inv_mass, fix):
    """One step from a state where some cells cross the bounds (the clip
    and negate), with and without a diagonal inverse mass and a frozen-
    cell ``grav_fix``: x', p', U, ud and um agree."""
    module, dobs, _ = small_module
    M = module.n_active
    rng = np.random.RandomState(4)
    grav_fix = rng.randn(dobs.size) * 0.5 if fix else None
    fargs = _fargs(module, dobs, grav_fix)
    jstep = jlf.make_fused_step(*fargs, regularization=reg, beta=0.001,
                                tile_c=8, matvec_dtype=getattr(jnp, dtype),
                                interpret=True)
    tstep = tlf.make_fused_step(*fargs, regularization=reg, beta=0.001,
                                matvec_dtype=getattr(torch, dtype),
                                device="cpu")
    C = 8
    w = np.asarray(module.wdiag, np.float32)
    x = (rng.uniform(0.0, 1.0, (C, M)) * w).astype(np.float32)
    # momenta that carry a few percent of the cells across a bound
    p = (rng.randn(C, M) * 10.0 * w).astype(np.float32)
    im = (10.0 ** rng.uniform(-1, 0, M)).astype(np.float32) if inv_mass \
        else None
    out_j = jstep(jnp.asarray(x), jnp.asarray(p), jnp.float32(0.01),
                  jnp.float32(1.0), params=jstep.params,
                  inv_mass=None if im is None else jnp.asarray(im))
    params = tlf.params_from_jax(_np_params(jstep.params), device="cpu")
    assert params["A"].dtype == getattr(torch, dtype)
    assert ("fix" in params) and torch.equal(
        params["fix"] != 0, torch.full((dobs.size,), fix))
    t = torch.from_numpy
    out_t = tstep(t(x), t(p), 0.01, 1.0, params=params,
                  inv_mass=None if im is None else t(im))
    x_ref = x + np.float32(0.01) * ((1.0 if im is None else im) * p)
    hits = ((x_ref > fargs[6]) | (x_ref < fargs[5])).mean()
    assert 0.01 < hits < 0.5
    for name, a, b in zip(["x", "p", "U", "ud", "um"], out_j, out_t):
        a, b = np.asarray(a, np.float64), b.numpy().astype(np.float64)
        assert b.shape == a.shape, name
        if dtype == "float32":
            rtol, atol = F32_TOL[name]
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol,
                                       err_msg=name)
        else:
            err = np.abs(b - a).max()
            assert err <= BF16_REL_TOL[name] * np.abs(a).max(), (name, err)


def test_step_keeps_its_inputs_and_lane_pads():
    """x and p are not written (the sampler replays the last step from
    them); a lane-padded call gives the unpadded outputs bit for bit with
    zero pads."""
    rng = np.random.RandomState(6)
    D, M, C = 60, 200, 4
    step = tlf.make_fused_step(
        rng.randn(D, M) * 0.1, rng.randn(D), rng.randn(D), np.full(M, 0.5),
        np.ones(M), np.zeros(M), np.ones(M), regularization="MS",
        matvec_dtype=torch.bfloat16, device="cpu")
    Mp = step.Mp
    x = torch.from_numpy(rng.uniform(0, 1, (C, M)).astype(np.float32))
    p = torch.from_numpy(rng.randn(C, M).astype(np.float32))
    x0, p0 = x.clone(), p.clone()
    out = step(x, p, 0.05, 1.0)
    assert torch.equal(x, x0) and torch.equal(p, p0)
    pad = torch.nn.functional.pad
    out_p = step(pad(x, (0, Mp - M)), pad(p, (0, Mp - M)), 0.05, 1.0)
    for a, b in zip(out[:2], out_p[:2]):
        assert b.shape == (C, Mp)
        assert torch.equal(b[:, :M], a)
        assert torch.equal(b[:, M:], torch.zeros(C, Mp - M))
    for a, b in zip(out[2:], out_p[2:]):
        assert torch.equal(a, b)
    assert step.D == D and step.M == M and "fix" in step.params


@pytest.fixture(scope="module")
def torch_module(small_module):
    jmod, dobs, _ = small_module
    return GravMagModule(dobs, (0, 800, 0, 1200, 0, 400), (100, 100, 100),
                         (jmod.lonobs, jmod.latobs, jmod.heightobs),
                         verbose=False, device="cpu")


@pytest.mark.parametrize("store_mode,inv_mass", [
    ("chain", False), ("accepted", True), ("none", False)])
def test_chunk_matches_jax_per_step(small_module, torch_module, store_mode,
                                    inv_mass):
    """One chunk of the per-step branch fed the JAX sampler's draws:
    accept flags, L and accepted counts identical to JAX
    ``make_chunk_sampler(fused_step=...)``; state and sample buffers
    within rtol 5e-3 / atol 5e-4 (tests/test_leapfrog_pallas.py:108-120)."""
    jmod, dobs, _ = small_module
    M = jmod.n_active
    C, nsamples, chunk = 8, 16, 12
    fargs = _fargs(jmod, dobs, None)
    aprior, low, high = fargs[3], fargs[5], fargs[6]
    common = dict(dt=0.05, Lmin=LMIN, Lmax=LMAX, Sigma=0.001, low=low,
                  high=high, constraint="mandatory", alpha=1.0,
                  chunk_size=chunk, nsamples=nsamples, ndraws=2,
                  wdiag_inv=jmod.wdiag_inv, data_size=dobs.size,
                  shared_L=True, store_mode=store_mode)
    im = (10.0 ** np.random.RandomState(8).uniform(-0.3, 0, M)).astype(
        np.float32) if inv_mass else None
    jpot = jmod.make_potential(aprior, low, high, regularization="MS",
                               beta=0.001, dtype=jnp.float32)
    jstep = jlf.make_fused_step(*fargs, regularization="MS", beta=0.001,
                                tile_c=8, matvec_dtype=jnp.float32,
                                interpret=True)
    run_j = jhmc.make_chunk_sampler(jpot, dtype=jnp.float32,
                                    fused_step=jstep, **common)
    x0 = np.tile(0.3 * np.asarray(jmod.wdiag, np.float32), (C, 1))
    U, g, (_, ud, um) = jpot(jnp.asarray(x0), 1.0)
    carry_j = (jnp.asarray(x0), U, g, ud, um, jnp.zeros(C, jnp.int32),
               jnp.zeros((C, nsamples, M), jnp.float32),
               jnp.zeros((C, nsamples, 7), jnp.float32))
    seed = 42
    c_j, s_j = run_j(carry_j, random.fold_in(random.PRNGKey(seed), 0), 0,
                     jpot.params,
                     inv_mass=None if im is None else jnp.asarray(im))

    tpot = torch_module.make_potential(aprior, low, high,
                                       regularization="MS", beta=0.001)
    tstep = tlf.make_fused_step(*_fargs(torch_module, dobs, None),
                                regularization="MS", beta=0.001,
                                matvec_dtype=torch.float32, device="cpu")
    # both samplers scale the same normals by 1/sqrt(inv_mass)
    run_t = thmc.make_chunk_sampler(tpot, fused_step=tstep,
                                    draws=jax_draws(seed, chunk, C, M),
                                    device="cpu", **common)
    xt = torch.from_numpy(x0)
    U, g, (_, ud, um) = tpot(xt, 1.0)
    carry_t = (xt, U, g, ud, um, torch.zeros(C, dtype=torch.int32),
               torch.zeros((C, nsamples, M)), torch.zeros((C, nsamples, 7)))
    c_t, s_t = run_t(carry_t, seed, 0,
                     inv_mass=None if im is None else torch.from_numpy(im))

    s_j = np.asarray(s_j)
    s_t = s_t.numpy()
    np.testing.assert_array_equal(s_t[..., 0], s_j[..., 0])   # accepts
    np.testing.assert_array_equal(s_t[..., 4], s_j[..., 4])   # L
    np.testing.assert_array_equal(c_t[5].numpy(), np.asarray(c_j[5]))
    assert 0 < s_j[..., 0].mean() < 1
    np.testing.assert_allclose(c_t[0].numpy(), np.asarray(c_j[0]),
                               rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(c_t[2].numpy(), np.asarray(c_j[2]),
                               rtol=5e-3, atol=5e-3 * np.abs(c_j[2]).max())
    np.testing.assert_allclose(c_t[6].numpy(), np.asarray(c_j[6]),
                               rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(s_t[..., 1], s_j[..., 1], rtol=1e-3)
