"""The uniformgrid slice as a whole: the port's chunk sampler and
``HamiltonianMC.sample`` against the JAX package's shared-L sampler.

The JAX sampler's own random draws (L, momentum normals, accept
uniforms) are rebuilt here with ``jax.random`` exactly as
``gravinv3dhmc_tpu/inversion/hmc.py`` derives them (``fold_in(base_key,
chunk)`` -> ``split(chunk_size)`` -> ``split(key, 3)`` -> randint /
normal / uniform, hmc.py:227,253,316,393,417-418) and fed to the port's
draw source. With identical draws both samplers must take identical
accept decisions and trajectory lengths; states and sample buffers agree
to f32 rounding (rtol 5e-3 / atol 5e-4, the bound the JAX package's own
fused-vs-XLA tests use, tests/test_leapfrog_pallas.py:108-120).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import random

from gravinv3dhmc_tpu.inversion import hmc as jhmc
from gravinv3dhmc_tpu_torch.inversion import hmc as thmc
from gravinv3dhmc_tpu_torch.inversion.potential import GravMagModule
from gravinv3dhmc_tpu_torch.ops import leapfrog as tlf

torch.set_num_threads(2)

LMIN, LMAX = 3, 8


def jax_draws(seed, chunk_size, C, M, myrank=0, per_chain=False):
    """Draw source replaying the JAX sampler's keys for run seed ``seed``;
    ``per_chain``: one L a chain, a (C,) array (the masked-L scan's)."""
    base_key = random.fold_in(random.PRNGKey(seed), myrank)
    cache = {}

    def draws(chunk_idx, i):
        if chunk_idx not in cache:
            keys = random.split(random.fold_in(base_key, chunk_idx),
                                chunk_size)
            rows = []
            for k in keys:
                kL, kp, ku = random.split(k, 3)
                L = random.randint(kL, (C,) if per_chain else (), LMIN,
                                   LMAX + 1)
                rows.append((np.array(L) if per_chain else int(L),
                             np.asarray(random.normal(kp, (C, M),
                                                      jnp.float32)),
                             np.asarray(random.uniform(ku, (C,),
                                                       jnp.float32))))
            cache[chunk_idx] = rows
        return cache[chunk_idx][i]

    return draws


@pytest.fixture(scope="module")
def torch_module(small_module):
    """The port's GravMagModule on the same problem as ``small_module``."""
    jmod, dobs, _ = small_module
    return GravMagModule(dobs, (0, 800, 0, 1200, 0, 400), (100, 100, 100),
                         (jmod.lonobs, jmod.latobs, jmod.heightobs),
                         verbose=False, device="cpu")


def _bounds(module):
    M = module.n_active
    w = np.asarray(module.wdiag)
    return w * np.full(M, 0.001), w * np.zeros(M), w * np.ones(M)


@pytest.mark.parametrize("path,store_mode", [
    ("iteration", "accepted"), ("iteration", "chain"),
    ("trajectory", "accepted"), ("shared_L", "accepted"),
    ("shared_L", "none")])
def test_chunk_matches_jax_shared_L(small_module, torch_module, path,
                                    store_mode):
    jmod, dobs, _ = small_module
    M = jmod.n_active
    C, nsamples, chunk = 8, 16, 12
    aprior, low, high = _bounds(jmod)
    # dt = 0.05 rejects about half the proposals, so the accept flags
    # are a real test
    common = dict(dt=0.05, Lmin=LMIN, Lmax=LMAX, Sigma=0.001, low=low,
                  high=high, constraint="mandatory", alpha=1.0,
                  chunk_size=chunk, nsamples=nsamples, ndraws=2,
                  wdiag_inv=jmod.wdiag_inv, data_size=dobs.size,
                  shared_L=True, store_mode=store_mode)
    jpot = jmod.make_potential(aprior, low, high, regularization="MS",
                               beta=0.001, dtype=jnp.float32)
    run_j = jhmc.make_chunk_sampler(jpot, dtype=jnp.float32, **common)
    x0 = np.tile(0.3 * np.asarray(jmod.wdiag, np.float32), (C, 1))
    U, g, (_, ud, um) = jpot(jnp.asarray(x0), 1.0)
    carry_j = (jnp.asarray(x0), U, g, ud, um, jnp.zeros(C, jnp.int32),
               jnp.zeros((C, nsamples, M), jnp.float32),
               jnp.zeros((C, nsamples, 7), jnp.float32))
    seed = 42
    c_j, s_j = run_j(carry_j, random.fold_in(random.PRNGKey(seed), 0), 0,
                     jpot.params)

    tpot = torch_module.make_potential(aprior, low, high,
                                       regularization="MS", beta=0.001)
    fargs = (torch_module.Aw, dobs - dobs.mean(), None, aprior,
             torch_module.wdiag ** 2, low, high)
    fkw = dict(regularization="MS", beta=0.001, matvec_dtype=torch.float32,
               device="cpu")
    fused = {}
    if path == "iteration":
        fused["fused_iteration"] = tlf.make_fused_iteration(
            *fargs, Sigma=0.001, **fkw)
    elif path == "trajectory":
        fused["fused_trajectory"] = tlf.make_fused_trajectory(*fargs, **fkw)
    run_t = thmc.make_chunk_sampler(
        tpot, draws=jax_draws(seed, chunk, C, M), device="cpu", **common,
        **fused)
    xt = torch.from_numpy(x0)
    U, g, (_, ud, um) = tpot(xt, 1.0)
    carry_t = (xt, U, g, ud, um, torch.zeros(C, dtype=torch.int32),
               torch.zeros((C, nsamples, M)), torch.zeros((C, nsamples, 7)))
    c_t, s_t = run_t(carry_t, seed, 0)

    s_j = np.asarray(s_j)
    s_t = s_t.numpy()
    np.testing.assert_array_equal(s_t[..., 0], s_j[..., 0])   # accepts
    np.testing.assert_array_equal(s_t[..., 4], s_j[..., 4])   # L
    np.testing.assert_array_equal(c_t[5].numpy(), np.asarray(c_j[5]))
    assert 0 < s_j[..., 0].mean() < 1
    np.testing.assert_allclose(c_t[0].numpy(), np.asarray(c_j[0]),
                               rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(c_t[6].numpy(), np.asarray(c_j[6]),
                               rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(s_t[..., 1], s_j[..., 1], rtol=1e-3)


def _configure(chain, module, dobs, nchains=8):
    aprior, low, high = _bounds(module)
    chain.dt = 0.05
    chain.Lrange = [LMIN, LMAX]
    chain.Sigma = 0.001
    chain.seed = 7
    chain.RegulFactor = 1.0
    chain.regularization = "MS"
    chain.beta = 0.001
    chain.nchains = nchains
    chain.chunk_size = 8
    chain.verbose = False
    chain.write_files = False
    chain.shared_L = True
    chain.store_mode = "chain"
    chain.low, chain.high = low, high
    # started inside the box at dt = 0.05 about half the proposals reject
    chain.initial_model = 300.0 * aprior
    chain.aprior_model = aprior
    chain.dobs = dobs
    chain.device = "cpu"
    return chain


@pytest.mark.parametrize("use_fused", [True, False])
def test_sample_matches_jax_sampler(small_module, torch_module, use_fused):
    """``HamiltonianMC.sample(nsamples=16, store_mode='chain')`` with the
    JAX draws equals the JAX sampler's run."""
    jmod, dobs, _ = small_module
    jc = _configure(jhmc.HamiltonianMC(jmod), jmod, dobs)
    jc.use_fused = False
    jc.transfer_samples = True
    res_j = jc.sample(16, 0)

    tc = _configure(thmc.HamiltonianMC(torch_module), torch_module, dobs)
    tc.use_fused = use_fused
    tc.fused_matvec_dtype = torch.float32
    res_t = tc.sample(16, 0, draws=jax_draws(
        7, tc.chunk_size, tc.nchains, torch_module.n_active))

    assert res_t["accepted"] == res_j["accepted"]
    np.testing.assert_array_equal(res_t["n_stored"], res_j["n_stored"])
    assert res_t["attempted"] == res_j["attempted"]
    assert res_t["grad_evals"] == res_j["grad_evals"]
    np.testing.assert_allclose(res_t["samples"].numpy(), res_j["samples"],
                               rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(res_t["misfits"].numpy()[..., 0],
                               res_j["misfits"][..., 0], rtol=1e-3)
    assert res_t["ess_median"] is not None


def test_philox_draws_are_shared_by_all_paths(torch_module, small_module):
    """Without a draw source the fused iteration, the fused trajectory
    and the shared-L path draw the same Philox normals and uniforms, so
    they take the same accept decisions; a rerun is bit-identical."""
    _, dobs, _ = small_module
    runs = []
    for use_fused, prefer_iter in [(True, True), (True, False),
                                   (False, True), (True, True)]:
        tc = _configure(thmc.HamiltonianMC(torch_module), torch_module,
                        dobs)
        tc.use_fused = use_fused
        tc.prefer_iteration_kernel = prefer_iter
        tc.fused_matvec_dtype = torch.float32
        runs.append(tc.sample(16, 8))
    first = runs[0]
    assert 0 < first["accept_ratio"] < 1
    assert first["fused_mode"] == "iteration(float32)"
    assert runs[1]["fused_mode"] == "trajectory(float32)"
    for r in runs[1:3]:
        assert r["accepted"] == first["accepted"]
        np.testing.assert_allclose(r["samples"].numpy(),
                                   first["samples"].numpy(),
                                   rtol=5e-3, atol=5e-4)
    assert torch.equal(runs[3]["samples"], first["samples"])


@pytest.mark.parametrize("regularization", ["Smoothness", "TV"])
def test_fd_regularizers_match_jax_sampler(small_module, torch_module,
                                           regularization):
    """Smoothness and TV (which the fused kernels do not take, so both
    packages run their eager paths) with the JAX draws: the same accept
    decisions and samples as the JAX sampler's run."""
    jmod, dobs, _ = small_module
    jc = _configure(jhmc.HamiltonianMC(jmod), jmod, dobs)
    jc.regularization = regularization
    jc.use_fused = False
    jc.transfer_samples = True
    res_j = jc.sample(16, 0)
    tc = _configure(thmc.HamiltonianMC(torch_module), torch_module, dobs)
    tc.regularization = regularization
    res_t = tc.sample(16, 0, draws=jax_draws(
        7, tc.chunk_size, tc.nchains, torch_module.n_active))
    assert res_t["fused_mode"] == "off"
    assert res_t["accepted"] == res_j["accepted"]
    assert res_t["grad_evals"] == res_j["grad_evals"]
    np.testing.assert_allclose(res_t["samples"].numpy(), res_j["samples"],
                               rtol=5e-3, atol=5e-4)
