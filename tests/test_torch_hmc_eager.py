"""HMC's eager path: the configurations the fused kernels do not take
(the logistic transform with its Jacobian and a temperature, the
'reflective' folds) run, as in the JAX package, on the eager path, by
default with one trajectory length a chain (the JAX package's masked-L
scan).

The JAX sampler's draws are injected (``jax_draws``: for each iteration
``kL, kp, ku = split(key, 3)``, L from ``randint(kL, (C,) or ())``), so
the accept flags, L and the accept counts are identical. At a step well
inside the leapfrog's stability region (``interior``) the stored rows
(reference units; under 'logarithmic' ``logistic_to_mw(x) / wdiag``) and
positions agree within rtol 1e-5 of max|value| (f32 sums in other
orders). At a step on its edge (``edge``: about half the proposals
reject) only the discrete decisions are held: there f32 rounding grows
along each trajectory (past 1e-4 of max|row| in 1 % of the entries over a
10-iteration chunk), and under the reflective folds a fold that a
last-bit difference decides at a wall flips a cell's momentum.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from gravinv3dhmc_tpu.inversion import hmc as jhmc
from gravinv3dhmc_tpu_torch.inversion import hmc as thmc
from gravinv3dhmc_tpu_torch.ops import leapfrog as tlf
from test_torch_hmc import (LMAX, LMIN, _configure,  # noqa: F401
                            jax_draws, torch_module)

torch.set_num_threads(2)

RTOL = 1e-5


#: (constraint, jacobian, temperature, start in units of the box)
CHUNK_CASES = {
    "logarithmic": ("logarithmic", True, 7.5, 0.3),
    "reflective": ("reflective", False, 1.0, 0.5),
}
#: dt inside the leapfrog's stability region and on its edge
REGIMES = {"logarithmic": {"interior": 1e-3, "edge": 2.5e-3},
           "reflective": {"interior": 0.01, "edge": 0.07}}


@pytest.mark.parametrize("per_chain", [True, False])
@pytest.mark.parametrize("regime", ["interior", "edge"])
@pytest.mark.parametrize("case", list(CHUNK_CASES))
def test_chunk_matches_jax(small_module, torch_module, case, regime,
                           per_chain):
    """The masked-L scan (one L a chain) and the shared-L loop, under the
    logistic transform with its Jacobian at T = 7.5 and under the
    reflective folds, against JAX ``make_chunk_sampler``."""
    constraint, jac, temp, start = CHUNK_CASES[case]
    dt = REGIMES[case][regime]
    jmod, dobs, _ = small_module
    M = jmod.n_active
    C, nsamples, chunk = 8, 16, 10
    w = np.asarray(jmod.wdiag)
    aprior, low, high = 0.001 * w, 0.0 * w, 1.0 * w
    kw = dict(constraint=constraint, log_factor=1000.0,
              regularization="MS", beta=0.001, jacobian=jac,
              temperature=temp)
    common = dict(dt=dt, Lmin=LMIN, Lmax=LMAX, Sigma=0.001, low=low,
                  high=high, constraint=constraint, alpha=1.0,
                  chunk_size=chunk, nsamples=nsamples, ndraws=2,
                  wdiag_inv=jmod.wdiag_inv, data_size=dobs.size,
                  shared_L=not per_chain, store_mode="accepted",
                  log_factor=1000.0)
    mw0 = start * w + 0.05 * w * np.random.RandomState(1).uniform(
        -1, 1, (C, M))
    x0 = (np.log((mw0 - low) / (high - mw0)) / 1000.0
          if constraint == "logarithmic" else mw0).astype(np.float32)
    jpot = jmod.make_potential(aprior, low, high, dtype=jnp.float32, **kw)
    run_j = jhmc.make_chunk_sampler(jpot, dtype=jnp.float32, **common)
    U, g, (_, ud, um) = jpot(jnp.asarray(x0), 1.0)
    carry_j = (jnp.asarray(x0), U, g, ud, um, jnp.zeros(C, jnp.int32),
               jnp.zeros((C, nsamples, M), jnp.float32),
               jnp.zeros((C, nsamples, 7), jnp.float32))
    seed = 5
    c_j, s_j = run_j(carry_j, random.fold_in(random.PRNGKey(seed), 0), 0,
                     jpot.params)

    tpot = torch_module.make_potential(aprior, low, high, **kw)
    run_t = thmc.make_chunk_sampler(
        tpot, draws=jax_draws(seed, chunk, C, M, per_chain=per_chain),
        device="cpu",
        **common)
    xt = torch.from_numpy(x0)
    U, g, (_, ud, um) = tpot(xt, 1.0)
    carry_t = (xt, U, g, ud, um, torch.zeros(C, dtype=torch.int32),
               torch.zeros((C, nsamples, M)), torch.zeros((C, nsamples, 7)))
    tlf.reset_launch_counts()
    c_t, s_t = run_t(carry_t, seed, 0)
    assert tlf.launch_counts()["draws"] == 0   # CPU: the plain version

    s_j, s_t = np.asarray(s_j), s_t.numpy()
    np.testing.assert_array_equal(s_t[..., 0], s_j[..., 0])   # accepts
    np.testing.assert_array_equal(s_t[..., 4], s_j[..., 4])   # L
    if regime == "edge":
        assert 0.1 < s_j[..., 0].mean() < 0.9
    if per_chain:
        assert (s_j[..., 4] != s_j[..., :1, 4]).any()   # L differs by chain
    np.testing.assert_array_equal(c_t[5].numpy(), np.asarray(c_j[5]))
    if regime == "interior":
        for got, want in ((c_t[6], c_j[6]), (c_t[0], c_j[0])):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=RTOL * np.abs(want).max())
    rows = c_t[6].numpy()
    stored = rows[np.abs(rows).sum(-1) > 0]
    assert len(stored) and (stored >= 0).all() and (stored <= 1).all()


def _honest(chain, module, dobs):
    """``examples/run.py global --honest``'s target on the small problem:
    the logistic transform with its Jacobian, T = 2 sigma^2, Damping,
    windowed warmup of dt and the metric, per-chain L; the fused path is
    asked for and must give way."""
    _configure(chain, module, dobs)
    chain.constraint = "logarithmic"
    chain.jacobian = True
    chain.temperature = 7.5
    chain.regularization = "Damping"
    chain.beta = 0.01
    chain.dt = 2e-5
    chain.shared_L = False
    chain.use_fused = True
    chain.adapt_step_size = True
    chain.adapt_mass = True
    chain.adapt_chunks = 8
    return chain


def test_honest_sampler_runs_eager_and_matches_jax(small_module,
                                                   torch_module):
    """``HamiltonianMC`` with the logistic transform, a Jacobian, T != 1
    and ``use_fused=True`` samples on the eager path (mode "off") instead
    of raising, and equals the JAX sampler's run with its draws: the
    frozen dt, the accept counts, the gradient evaluations, the metric
    (rtol 1e-5) and the stored samples."""
    jmod, dobs, _ = small_module
    jc = _honest(jhmc.HamiltonianMC(jmod), jmod, dobs)
    res_j = jc.sample(16, 0)
    assert jc._fused_mode == "off"
    tc = _honest(thmc.HamiltonianMC(torch_module), torch_module, dobs)
    res_t = tc.sample(16, 0, draws=jax_draws(
        7, tc.chunk_size, tc.nchains, torch_module.n_active,
        per_chain=True))
    assert res_t["fused_mode"] == "off"
    assert res_t["step_size"] == res_j["step_size"]
    assert res_t["accepted"] == res_j["accepted"]
    assert res_t["attempted"] == res_j["attempted"]
    assert res_t["grad_evals"] == res_j["grad_evals"]
    assert 0 < res_t["accept_ratio"] < 1
    np.testing.assert_allclose(res_t["inv_mass"].numpy(), res_j["inv_mass"],
                               rtol=RTOL)
    want = np.asarray(res_j["samples"])
    np.testing.assert_allclose(res_t["samples"].numpy(), want, rtol=0,
                               atol=RTOL * np.abs(want).max())
