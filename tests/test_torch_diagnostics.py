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
