"""Warmup adaptation shared by HMC and NUTS: dual averaging of the step
size and Welford moments for a diagonal metric.

Counterpart of the adaptation section of
``gravinv3dhmc_tpu/inversion/nuts.py`` (``dual_averaging_init/update``,
``welford_init/update/variance``). The dual-averaging state is host
float64 scalar maths, as the JAX package runs it (op by op in float64
outside any compiled function): ``math.log``, ``math.sqrt`` and ``**``
give the same bits as its ``jnp.log``, ``jnp.sqrt`` and power, so a run
fed the same accept rates takes the same step sizes. The Welford moments
are tensors on the chains' device.

The No-U-Turn sampler itself (``make_nuts_kernel``, ``run_nuts``) is not
ported yet (ROADMAP.md queue 1, item 5).
"""
from __future__ import annotations

import math

import torch


def dual_averaging_init(step_size0, target=0.8):
    """The state of Nesterov dual averaging on log step size, started at
    ``step_size0`` and aiming at accept rate ``target``."""
    return dict(
        log_eps=math.log(step_size0),
        log_eps_avg=math.log(step_size0),
        h_bar=0.0,
        mu=math.log(10.0 * step_size0),
        t=0.0,
        target=float(target),
    )


def dual_averaging_update(state, accept_prob, gamma=0.05, t0=10.0,
                          kappa=0.75):
    """Nesterov dual averaging on log step size (Hoffman & Gelman 2014)."""
    t = state["t"] + 1.0
    eta_h = 1.0 / (t + t0)
    h_bar = (1 - eta_h) * state["h_bar"] + eta_h * (state["target"]
                                                    - accept_prob)
    log_eps = state["mu"] - math.sqrt(t) / gamma * h_bar
    eta = t ** (-kappa)
    log_eps_avg = eta * log_eps + (1 - eta) * state["log_eps_avg"]
    return {**state, "t": t, "h_bar": h_bar, "log_eps": log_eps,
            "log_eps_avg": log_eps_avg}


def welford_init(m, dtype=torch.float32, device=None):
    """Zero running moments of an (m,) position (or of ``m`` = a shape)."""
    return dict(mean=torch.zeros(m, dtype=dtype, device=device),
                m2=torch.zeros(m, dtype=dtype, device=device),
                count=torch.zeros((), dtype=dtype, device=device))


def welford_update(state, x):
    """The moments after one more position ``x``."""
    count = state["count"] + 1.0
    delta = x - state["mean"]
    mean = state["mean"] + delta / count
    m2 = state["m2"] + delta * (x - mean)
    return dict(mean=mean, m2=m2, count=count)


def welford_variance(state, regularize=True):
    """The sample variance of the positions seen; ``regularize`` shrinks it
    toward a unit metric as Stan does (:func:`shrink`)."""
    var = state["m2"] / torch.clamp(state["count"] - 1.0, min=1.0)
    if regularize:
        var = shrink(var, state["count"])
    return var


def shrink(var, n):
    """Stan's shrinkage of a variance estimated from ``n`` positions: a
    weight of 5 positions at 1e-3."""
    return (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
