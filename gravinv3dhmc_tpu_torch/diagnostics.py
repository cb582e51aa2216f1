"""Posterior diagnostics: autocorrelation ESS on the host and on the device.

``effective_sample_size`` is a numpy copy of the JAX package's
(``gravinv3dhmc_tpu/diagnostics.py``); ``ess_torch`` is its ``ess_jax``
written on ``torch.fft``, so the ESS of a device-resident sample buffer
is computed where the buffer lives and only the result moves. ``median``
is the median as ``np.median`` and ``jnp.median`` take it.
"""
from __future__ import annotations

import numpy as np
import torch


def effective_sample_size(chains):
    """Autocorrelation-based ESS per parameter (Geyer initial-monotone
    estimator over the chain-averaged correlogram); ``chains`` is a numpy
    (C, N, M) array."""
    c, n, m = chains.shape
    if n < 4:
        return np.full(m, float(c * n))
    centered = chains - chains.mean(axis=1, keepdims=True)
    # FFT autocovariance per chain/parameter
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(centered, nfft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), nfft, axis=1)[:, :n].real
    acov /= n
    var_plus = acov[:, 0].mean(axis=0) * n / (n - 1)
    rho = 1.0 - (acov[:, 0].mean(axis=0) - acov.mean(axis=0)) / \
        np.where(var_plus == 0, 1.0, var_plus)
    ess = np.empty(m)
    for j in range(m):
        if var_plus[j] == 0:
            ess[j] = c * n
            continue
        # pair sums until the first negative pair (initial positive seq.)
        t = 1
        s = 0.0
        while t + 1 < n:
            pair = rho[t, j] + rho[t + 1, j]
            if pair < 0:
                break
            s += pair
            t += 2
        tau = 1.0 + 2.0 * s
        ess[j] = c * n / max(tau, 1.0)
    return ess


def median(t):
    """The median of all of ``t``'s values, on its device and in its type,
    as ``jnp.median`` computes it: the mean of the two middle values when
    the count is even, ``(lo + hi) * 0.5`` (``torch.median`` would return
    the lower one)."""
    s = t.reshape(-1).sort().values
    n = s.numel()
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def ess_torch(chains):
    """:func:`effective_sample_size` for a (C, N, K) tensor, computed on
    its device; returns a (K,) tensor of total-ESS values. The Geyer
    stopping rule is vectorised as a cumulative positivity mask."""
    c, n, k = chains.shape
    if n < 4:
        return torch.full((k,), float(c * n), dtype=chains.dtype,
                          device=chains.device)
    centered = chains - chains.mean(dim=1, keepdim=True)
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = torch.fft.rfft(centered, nfft, dim=1)
    acov = torch.fft.irfft(f * torch.conj(f), nfft, dim=1)[:, :n] / n
    var0 = acov[:, 0].mean(dim=0)                             # (K,)
    var_plus = var0 * n / (n - 1)
    safe = torch.where(var_plus == 0, torch.ones_like(var_plus), var_plus)
    rho = 1.0 - (var0[None, :] - acov.mean(dim=0)) / safe     # (n, K)
    npairs = (n - 1) // 2
    pairs = rho[1:1 + 2 * npairs].reshape(npairs, 2, k).sum(dim=1)
    keep = torch.cumprod((pairs >= 0).to(rho.dtype), dim=0)
    tau = torch.clamp(1.0 + 2.0 * (pairs * keep).sum(dim=0), min=1.0)
    return torch.where(var_plus == 0, torch.full_like(tau, float(c * n)),
                       c * n / tau)
