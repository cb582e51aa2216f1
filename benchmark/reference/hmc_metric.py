"""HMC under a diagonal inverse mass, and the windowed warmup's two
estimators: a plain reference in PyTorch.

One iteration of a chain under the inverse mass ``m`` (a positive (M,)
vector): momentum ``p0 = n / sqrt(m)`` (n the chain's standard normals),
``H0 = K(p0) + U(x)`` with ``K(p) = sum(m p^2) / 2``; L leapfrog steps of
a half kick ``p - eps/2 g``, then drifts ``x + eps m p`` clipped to the
box ``[low, high]``, the momentum of each clipped cell negated, with full
kicks between them and a half kick after the last; the Metropolis test
accepts where ``H1 < H0`` or ``u < exp(H0 - H1)`` (u the chain's
uniform), and a rejected chain keeps its state. Each row of a batch may
have its own L: past its L a row's state passes through. ``pot(x)``
returns ``(U, g, ...)`` at the rows of ``x`` and has a ``dtype``, the
precision the iteration runs in.

The metric the warmup freezes (Stan's): the variance of each cell over
every chain's draws of one window, pooled as the mean over chains of each
chain's sample variance, shrunk towards 1e-3 with a weight of 5 draws
against the window's N draws of every chain (``n = N C``): ``n / (n + 5)
var + 1e-3 5 / (n + 5)``, and at least 1e-12.

The step size the warmup freezes: Nesterov dual averaging on log step
size (Hoffman and Gelman 2014, gamma 0.05, t0 10, kappa 0.75), started at
``eps0`` (``mu = log(10 eps0)``), one update per chunk with the chunk's
mean accept rate; the frozen step size is the exponential of the
averaged iterate.
"""
from __future__ import annotations

import math

import torch


def iterate(pot, x, U, g, n01, u, L, eps, inv_mass, low, high):
    """One HMC iteration of each row of ``x`` (R, M) with its carried
    ``U`` and ``g``, normals ``n01`` (R, M), uniforms ``u`` (R,), lengths
    ``L`` (R,) and the inverse mass ``inv_mass`` (M,). Returns ``(x, U,
    g, accepted, proposal)``."""
    dt = pot.dtype
    x, U, g = x.to(dt), U.to(dt), g.to(dt)
    m = inv_mass.to(dt)
    L = torch.as_tensor(L, device=x.device)
    p0 = n01.to(dt) / torch.sqrt(m)
    H0 = 0.5 * (m * p0 * p0).sum(-1) + U
    p = p0 - (0.5 * eps) * g
    xs, Us, gs = x.clone(), U.clone(), g.clone()
    for step in range(int(L.max())):
        act = (step < L)[:, None]
        xn = xs + eps * (m * p)
        xc = torch.minimum(torch.maximum(xn, low), high)
        pn = torch.where(xn != xc, -p, p)
        Un, gn = pot(xc)[:2]
        kick = torch.where(L - 1 == step, 0.5 * eps, eps).to(dt)
        xs = torch.where(act, xc, xs)
        p = torch.where(act, pn - kick[:, None] * gn, p)
        gs = torch.where(act, gn, gs)
        Us = torch.where(act[:, 0], Un, Us)
    H1 = 0.5 * (m * p * p).sum(-1) + Us
    acc = (H1 < H0) | (u.to(dt) < torch.exp(-(H1 - H0)))
    a = acc[:, None]
    return (torch.where(a, xs, x), torch.where(acc, Us, U),
            torch.where(a, gs, g), acc, xs)


def pooled_variance(draws):
    """The shrunk pooled variance of ``draws`` (C, N, K): C chains' N
    draws of K cells, one window; (K,) float64."""
    d = draws.to(torch.float64)
    C, N = d.shape[:2]
    var = d.var(dim=1, unbiased=True).mean(0)
    n = float(N * C)
    return torch.clamp((n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0)),
                       min=1e-12)


def dual_averaging(eps0, accept_rates, target, gamma=0.05, t0=10.0,
                   kappa=0.75):
    """``[(log_eps, log_eps_avg), ...]``: the state after each update of
    dual averaging started at ``eps0`` with the mean accept rates
    ``accept_rates`` in turn."""
    mu = math.log(10.0 * eps0)
    h_bar, log_eps_avg, out = 0.0, math.log(eps0), []
    for t, a in enumerate(accept_rates, start=1):
        eta = 1.0 / (t + t0)
        h_bar = (1.0 - eta) * h_bar + eta * (target - float(a))
        log_eps = mu - math.sqrt(t) / gamma * h_bar
        w = t ** (-kappa)
        log_eps_avg = w * log_eps + (1.0 - w) * log_eps_avg
        out.append((log_eps, log_eps_avg))
    return out
