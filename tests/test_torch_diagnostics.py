"""``ess_torch`` against the JAX package's ``effective_sample_size`` and
``ess_jax`` on the same f64 chains (rtol 1e-6: the three differ only in
FFT rounding)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gravinv3dhmc_tpu import diagnostics as jdiag
from gravinv3dhmc_tpu_torch import diagnostics as tdiag

torch.set_num_threads(2)


def _ar1(C, N, K, phi, seed):
    rng = np.random.RandomState(seed)
    x = np.zeros((C, N, K))
    for t in range(1, N):
        x[:, t] = phi * x[:, t - 1] + rng.randn(C, K)
    x[:, :, 0] = 1.5  # a constant parameter takes the var == 0 branch
    return x


@pytest.mark.parametrize("N,phi", [(64, 0.0), (64, 0.8), (33, 0.95)])
def test_ess_torch_matches_numpy_and_jax(N, phi):
    x = _ar1(4, N, 6, phi, seed=N)
    ref = jdiag.effective_sample_size(x)
    np.testing.assert_allclose(tdiag.effective_sample_size(x), ref,
                               rtol=1e-12)
    got = tdiag.ess_torch(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jdiag.ess_jax(jnp.asarray(x))),
                               rtol=1e-6)


def test_ess_torch_short_chains():
    x = torch.zeros((3, 3, 5), dtype=torch.float64)
    np.testing.assert_array_equal(tdiag.ess_torch(x).numpy(), 9.0)


def _chains(seed, C=4, N=40, M=7):
    rng = np.random.RandomState(seed)
    x = rng.randn(C, N, M) * rng.uniform(0.5, 2.0, M) + rng.randn(C, 1, M)
    x[:, :, 0] = 0.25        # no within-chain variance: R-hat 1
    return x


@pytest.mark.parametrize("N", [40, 41])
def test_split_rhat_and_stats_match_numpy(N):
    x = _chains(N, N=N)
    np.testing.assert_allclose(tdiag.split_rhat(torch.from_numpy(x)).numpy(),
                               jdiag.split_rhat(x), rtol=1e-12)
    assert tdiag.split_rhat(x)[0].item() == 1.0
    for a, b in zip(tdiag.posterior_stats(x), jdiag.posterior_stats(x)):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-12)
    # float32 input is computed in float64
    x32 = torch.from_numpy(x.astype(np.float32))
    np.testing.assert_allclose(
        tdiag.split_rhat(x32).numpy(),
        jdiag.split_rhat(x.astype(np.float32).astype(np.float64)),
        rtol=1e-12)


def test_rmsd_rmsm_and_summarize_match_numpy():
    x = _chains(5)
    rng = np.random.RandomState(6)
    dobs, dpre, truth = rng.randn(30), rng.randn(30), rng.randn(7)
    assert tdiag.rmsd(torch.from_numpy(dobs), dpre) == pytest.approx(
        jdiag.rmsd(dobs, dpre), rel=1e-12)
    assert tdiag.rmsm(x[0, 0], torch.from_numpy(truth)) == pytest.approx(
        jdiag.rmsm(x[0, 0], truth), rel=1e-12)
    for kw in ({}, dict(dobs=dobs, dpre=dpre, truth=truth),
               dict(truth=truth, post_mean=x[1, 2])):
        got = tdiag.summarize(torch.from_numpy(x), **kw)
        ref = jdiag.summarize(x, **kw)
        assert set(got) == set(ref)
        for k, v in ref.items():
            assert got[k] == pytest.approx(v, rel=1e-12, abs=0), k


@pytest.mark.parametrize("C,n", [(8, 200), (64, 256), (4, 20), (1024, 64),
                                 (3, 3)])
def test_ess_frozen_floor_matches_the_workloads_flag(C, n):
    """The floor is the workloads' ``median(ess_jax(frozen))`` of an f32
    linspace ensemble (rtol 1e-5: its f32 FFT); an ESS within 1.25x of it
    is flagged."""
    frozen = jnp.broadcast_to(
        jnp.linspace(0.0, 1.0, C, dtype=jnp.float32)[:, None, None],
        (C, n, 4))
    ref = float(jnp.median(jdiag.ess_jax(frozen)))
    floor = tdiag.ess_frozen_floor(C, n)
    assert floor == pytest.approx(ref, rel=1e-5)
    assert tdiag.ess_degenerate(1.2 * floor, C, n)
    assert not tdiag.ess_degenerate(1.3 * floor, C, n)
