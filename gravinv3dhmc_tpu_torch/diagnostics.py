"""Posterior diagnostics: R-hat, ESS, posterior moments and recovery
metrics, on the host and on the device.

``effective_sample_size`` is a numpy copy of the JAX package's
(``gravinv3dhmc_tpu/diagnostics.py``); ``ess_torch`` is its ``ess_jax``
written on ``torch.fft``, so the ESS of a device-resident sample buffer
is computed where the buffer lives and only the result moves. ``median``
is the median as ``np.median`` and ``jnp.median`` take it.
``split_rhat``, ``posterior_stats``, ``rmsd``, ``rmsm`` and ``summarize``
are the JAX package's functions of the same names; they take numpy arrays
or tensors on any device and compute in float64 where the tensor lives.
``ess_frozen_floor`` and ``ess_degenerate`` flag an ESS that measures the
ensemble's size rather than mixing (``examples/workloads.py``).
``load_chains`` reads sample files back through the native reader
(``runtime/sink.py``), with no ``np.loadtxt`` fall back.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def load_chains(save_folder, nchains, ndraws=0, myrank=0):
    """Load ``<save_folder><c>/model.dat`` for c in rank..rank+nchains-1,
    skipping ``ndraws`` warm-up lines, like the reference's plot scripts
    (reference: example/uniformgrid/plot_uniform.py:47-54); a numpy
    (C, N, M) array cut to the shortest chain."""
    from .runtime.sink import read_matrix

    chains = []
    for c in range(myrank, myrank + nchains):
        path = os.path.join(f"{save_folder}{c}", "model.dat")
        m = np.atleast_2d(read_matrix(path))
        chains.append(m[ndraws:])
    n = min(len(m) for m in chains)
    return np.stack([m[:n] for m in chains])  # (C, N, M)


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


def _f64(a):
    """``a`` as a float64 tensor, on its device if it is a tensor."""
    return torch.as_tensor(a).to(torch.float64)


def posterior_stats(chains):
    """Mean and std (ddof 0) over all chains and draws; chains is (C, N, M).
    Returns float64 tensors on the chains' device."""
    c = _f64(chains)
    flat = c.reshape(-1, c.shape[-1])
    return flat.mean(0), flat.std(0, correction=0)


def rmsd(dobs, dpre):
    """Root-mean-square data misfit."""
    return float(torch.sqrt(((_f64(dobs) - _f64(dpre)) ** 2).mean()))


def rmsm(model, truth):
    """Root-mean-square model recovery error."""
    return float(torch.sqrt(((_f64(model) - _f64(truth)) ** 2).mean()))


def split_rhat(chains):
    """Split potential-scale-reduction R-hat per parameter (float64 tensor).

    ``chains`` is (C, N, M); each chain is split in half, giving 2C
    sequences; a parameter with no within-sequence variance gets 1."""
    c = _f64(chains)
    half = c.shape[1] // 2
    seqs = torch.cat([c[:, :half], c[:, half:2 * half]])
    n2 = seqs.shape[1]
    w = seqs.var(1, correction=1).mean(0)                  # within
    b = n2 * seqs.mean(1).var(0, correction=1)             # between
    var_plus = (n2 - 1) / n2 * w + b / n2
    rhat = torch.sqrt(var_plus / w)
    return torch.where(w == 0, torch.ones_like(rhat), rhat)


def summarize(chains, dobs=None, dpre=None, truth=None, post_mean=None):
    """One-stop posterior summary dict, the JAX package's keys: R-hat and
    ESS over all parameters (``ess_torch`` in float64), RMSD and RMSM when
    their inputs are given."""
    c = _f64(chains)
    mean, _ = posterior_stats(c)
    ess = ess_torch(c)
    out = {
        "n_chains": c.shape[0],
        "n_samples": c.shape[1],
        "rhat_max": float(split_rhat(c).nan_to_num(nan=-np.inf).max()),
        "ess_min": float(ess.nan_to_num(nan=np.inf).min()),
        "ess_mean": float(ess.nanmean()),
    }
    if dobs is not None and dpre is not None:
        out["RMSD"] = rmsd(dobs, dpre)
    if truth is not None:
        out["RMSM"] = rmsm(post_mean if post_mean is not None else mean,
                           truth)
    return out


def ess_frozen_floor(C, n):
    """The ESS the estimator gives C chains of n draws that never move
    (each chain constant, the chains apart): ``rho_t = 1 - t (n-1)/n^2``
    for every such ensemble, so every pair stays positive and the total
    ESS is ``C n / tau``, about C. An ESS median near it measures the
    ensemble's size, not mixing (``examples/workloads.py``, which takes it
    from ``ess_jax`` of a frozen f32 ensemble)."""
    if n < 4:
        return float(C * n)
    t = np.arange(1, 2 * ((n - 1) // 2) + 1, dtype=np.float64)
    tau = 1.0 + 2.0 * np.sum(1.0 - t * (n - 1) / (n * n))
    return float(C * n / max(tau, 1.0))


def ess_degenerate(ess_median, C, n):
    """True when ``ess_median`` lies below 1.25 times the frozen floor."""
    return bool(ess_median < 1.25 * ess_frozen_floor(C, n))
