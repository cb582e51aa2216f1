"""Plain HMC on the weighted, mean-centred least-squares potential.

The target: ``U(x) = |A_c x - d'|^2 + alpha R(x - a)``, with ``A_c`` the
weighted matrix less its column means over the stations (so ``A_c x`` is
the predicted data less its mean), ``d'`` the data less its mean, and
``R`` the MS functional ``sum w^2 dm^2 / (dm^2 + beta)`` or Damping
``sum dm^2``. Its gradient is ``2 A_c^T r + alpha grad R``.

One iteration of a chain: momentum ``p0 = Sigma n`` (n the Philox normals
of the chain and iteration), ``H0 = |p0|^2 / 2 + U(x)``; L leapfrog steps
of a half kick, then drifts that clip x to the box and negate the
momentum of each clipped cell, with full kicks between them and a half
kick after the last; the Metropolis test accepts where ``H1 < H0`` or
``u < exp(H0 - H1)`` (u the chain's Philox uniform), and a rejected
chain keeps its state. Each row of a batch may have its own L: past its
L a row's state passes through.

``precision`` sets how the two products with the matrix are computed:
"float64" (the reference) or "float8" (e4m3, one scale per tensor: the
matrix and the vector it multiplies rounded to that type, accumulated in
float32), a control.
"""
from __future__ import annotations

import torch

PRECISIONS = ("float64", "float8")
_FP8_MAX = 448.0


def _round(t, precision):
    """``t`` (float32) rounded to ``precision`` and widened back."""
    if precision == "float8":
        scale = _FP8_MAX / t.abs().amax().clamp_min(1e-30)
        return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return t


class Potential:
    """``U``, its gradient and the data and model terms at a batch of
    states, in ``precision``; the state and terms are float64 for the
    reference and float32 for the lower precisions."""

    def __init__(self, Aw, dobs, aprior, wmsq, alpha, beta, regularization,
                 precision="float64"):
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision
        self.dtype = torch.float64 if precision == "float64" else \
            torch.float32
        Aw = Aw.to(torch.float64)
        Ac = Aw - Aw.mean(0, keepdim=True)
        self.A = _round(Ac.to(self.dtype), precision)
        d = dobs.to(torch.float64)
        self.d = (d - d.mean()).to(self.dtype)
        self.aprior = aprior.to(self.dtype)
        self.wmsq = wmsq.to(self.dtype)
        self.alpha = float(alpha)
        self.beta = float(beta)
        if regularization not in ("MS", "Damping"):
            raise ValueError(f"unknown regularization {regularization!r}")
        self.ms = regularization == "MS"

    def __call__(self, x):
        """``(U, g, ud, um)`` at the rows of ``x``."""
        x = x.to(self.dtype)
        r = _round(x, self.precision) @ self.A.T - self.d
        ud = (r * r).sum(-1)
        gd = 2.0 * (_round(r, self.precision) @ self.A)
        dm = x - self.aprior
        if self.ms:
            den = dm * dm + self.beta
            um = (self.wmsq * dm * dm / den).sum(-1)
            gm = self.wmsq * (2.0 * self.beta) * dm / (den * den)
        else:
            um = (dm * dm).sum(-1)
            gm = 2.0 * dm
        return ud + self.alpha * um, gd + self.alpha * gm, ud, um


def iterate(pot, x, U, g, n01, u, L, eps, sigma, low, high):
    """One HMC iteration of each row of ``x`` (R, M) with its carried
    ``U`` and ``g``, normals ``n01`` (R, M), uniforms ``u`` (R,) and
    lengths ``L`` (R,). Returns ``(x, U, g, accepted, proposal)``."""
    dt = pot.dtype
    x, U, g = x.to(dt), U.to(dt), g.to(dt)
    L = torch.as_tensor(L, device=x.device)
    p0 = sigma * n01.to(dt)
    H0 = 0.5 * (p0 * p0).sum(-1) + U
    p = p0 - (0.5 * eps) * g
    xs, Us, gs = x.clone(), U.clone(), g.clone()
    for step in range(int(L.max())):
        act = (step < L)[:, None]
        xn = xs + eps * p
        xc = torch.minimum(torch.maximum(xn, low), high)
        pn = torch.where(xn != xc, -p, p)
        Un, gn, _, _ = pot(xc)
        kick = torch.where(L - 1 == step, 0.5 * eps, eps).to(dt)
        xs = torch.where(act, xc, xs)
        p = torch.where(act, pn - kick[:, None] * gn, p)
        gs = torch.where(act, gn, gs)
        Us = torch.where(act[:, 0], Un, Us)
    H1 = 0.5 * (p * p).sum(-1) + Us
    acc = (H1 < H0) | (u.to(dt) < torch.exp(-(H1 - H0)))
    a = acc[:, None]
    return (torch.where(a, xs, x), torch.where(acc, Us, U),
            torch.where(a, gs, g), acc, xs)
