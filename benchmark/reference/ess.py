"""The multi-chain effective sample size the benchmark reports.

Geyer's initial-positive-sequence estimator over the chain-averaged
correlogram, with the between-chain variance in ``var_plus`` (the
estimator of ``gravinv3dhmc_tpu_torch.diagnostics.ess_torch``, copied so
that the yardstick stays fixed while the program changes): for a (C, N,
K) tensor of C chains of N draws of K quantities, ``rho_t = 1 - (W -
mean_c acov_c(t)) / var_plus`` with ``W`` the mean within-chain variance
and ``var_plus = W N / (N - 1)``; pairs ``rho_t + rho_{t+1}`` (t odd)
are summed while they stay non-negative, ``tau = 1 + 2 sum`` (at least
1), ``ESS = C N / tau``. A quantity that never varies gets ``C N``.
"""
from __future__ import annotations

import math

import torch


def ess(chains):
    """(K,) total ESS of a (C, N, K) tensor, computed on its device."""
    c, n, k = chains.shape
    if n < 4:
        return torch.full((k,), float(c * n), dtype=chains.dtype,
                          device=chains.device)
    centred = chains - chains.mean(dim=1, keepdim=True)
    nfft = 1 << math.ceil(math.log2(2 * n))
    f = torch.fft.rfft(centred, nfft, dim=1)
    acov = torch.fft.irfft(f * torch.conj(f), nfft, dim=1)[:, :n] / n
    var0 = acov[:, 0].mean(dim=0)
    var_plus = var0 * n / (n - 1)
    safe = torch.where(var_plus == 0, torch.ones_like(var_plus), var_plus)
    rho = 1.0 - (var0[None, :] - acov.mean(dim=0)) / safe
    npairs = (n - 1) // 2
    pairs = rho[1:1 + 2 * npairs].reshape(npairs, 2, k).sum(dim=1)
    keep = torch.cumprod((pairs >= 0).to(rho.dtype), dim=0)
    tau = torch.clamp(1.0 + 2.0 * (pairs * keep).sum(dim=0), min=1.0)
    return torch.where(var_plus == 0, torch.full_like(tau, float(c * n)),
                       c * n / tau)


def median(t):
    """The median of all values of ``t``: the mean of the two middle ones
    when their count is even."""
    s = t.reshape(-1).sort().values
    n = s.numel()
    return float((s[(n - 1) // 2] + s[n // 2]) * 0.5)
