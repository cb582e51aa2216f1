"""The No-U-Turn sampler and the warmup adaptation shared by HMC, NUTS
and ChEES: dual averaging of the step size and Welford moments for a
diagonal metric.

Counterpart of ``gravinv3dhmc_tpu/inversion/nuts.py``. For fixed-L HMC
the dual-averaging state is host float64 scalar maths, as the JAX
package runs it (op by op in float64 outside any compiled function):
``math.log``, ``math.sqrt`` and ``**`` give the same bits as its
``jnp.log``, ``jnp.sqrt`` and power, so a run fed the same accept rates
takes the same step sizes. The same update runs on tensors: float32 and
shared by the chains in ChEES, float64 and one state per chain in NUTS
(:func:`dual_averaging_tensors`), as the JAX package's are. The Welford
moments are tensors on the chains' device.

:func:`make_nuts_kernel` is the JAX package's iterative NUTS (multinomial
proposals, Stan's momentum-sum U-turn rule checked at every power-of-two
boundary from a checkpoint stack, divergence at dH >= 1000 or NaN) over a
(C, M) chain batch. The JAX package vmaps one chain's while-loops; under
vmap they run in lockstep: every chain still building doubles at the same
loop depth, so subtree d has 2^d leaves for each, and a chain that has
turned or diverged keeps its state bit for bit through the others' work.
The batch does the same with per-chain masks, reading on the host one
flag a doubling and one a leaf (whether any chain is still building).
The random draws of a transition are a table (:func:`generator_draws`):
the momentum normals ``z`` (C, M), a direction ``dir`` (C, max_depth)
and a merge uniform ``merge`` (C, max_depth) a doubling, and a uniform
``leaf`` (C, max_depth, 2^(max_depth-1)) a leaf; on the card they come
from a ``torch.Generator`` on the device, and the tests inject the JAX
kernel's own.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from .._device import resolve
from ..runtime.sink import write_chains
from .potential import logistic_to_mw, mw_to_logistic


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


def dual_averaging_tensors(step_size0, target=0.8, dtype=torch.float32,
                           shape=(), device=None):
    """:func:`dual_averaging_init`'s values (host float64) as tensors of
    ``dtype`` and ``shape``: the JAX package's state cast to float32, one
    state for all chains (ChEES), or float64 per chain (NUTS)."""
    return {k: torch.full(shape, v, dtype=dtype, device=device)
            for k, v in dual_averaging_init(step_size0, target).items()}


def dual_averaging_update(state, accept_prob, gamma=0.05, t0=10.0,
                          kappa=0.75):
    """Nesterov dual averaging on log step size (Hoffman & Gelman 2014), on
    host floats or, op for op the same, on tensors of the state's type."""
    t = state["t"] + 1.0
    sqrt = torch.sqrt if torch.is_tensor(t) else math.sqrt
    eta_h = 1.0 / (t + t0)
    h_bar = (1 - eta_h) * state["h_bar"] + eta_h * (state["target"]
                                                    - accept_prob)
    log_eps = state["mu"] - sqrt(t) / gamma * h_bar
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


# ---------------------------------------------------------------------------
# the No-U-Turn sampler
# ---------------------------------------------------------------------------

MAX_DELTA_H = 1000.0  # divergence threshold


def _ctz(n):
    """Trailing zeros of a positive int; 0 for 0 (the JAX kernel's clipped
    slot of leaf 0)."""
    return (n & -n).bit_length() - 1 if n > 0 else 0


def generator_draws(C, M, max_depth, generator, dtype=torch.float32):
    """A draw source of NUTS transition tables from ``generator`` (a
    ``torch.Generator`` on the chains' device)."""
    device = generator.device

    def draws(_it):
        def u(*shape):
            return torch.rand(shape, generator=generator, dtype=dtype,
                              device=device)
        return dict(z=torch.randn((C, M), generator=generator, dtype=dtype,
                                  device=device),
                    dir=u(C, max_depth) < 0.5, merge=u(C, max_depth),
                    leaf=u(C, max_depth, 2 ** (max_depth - 1)))

    return draws


def make_nuts_kernel(potential_fn, *, max_depth=8, dtype=torch.float32):
    """One NUTS transition of a (C, M) chain batch.

    ``potential_fn(x) -> (U (C,), grad (C, M))``. Returns ``step(x, U, g,
    table, step_size, inv_mass) -> (x', U', g', stats)`` with ``table`` a
    transition's draws (see the module docstring), ``step_size`` (C,) and
    ``inv_mass`` (M,) or (C, M); ``stats`` holds per-chain
    ``accept_prob``, ``depth``, ``n_leapfrog`` (the leaves actually run)
    and ``diverging``.
    """

    def kinetic(p, im):
        return 0.5 * (im * p * p).sum(-1)

    def turned(p_left, p_right, rho, im):
        return (((rho * (im * p_left)).sum(-1) <= 0)
                | ((rho * (im * p_right)).sum(-1) <= 0))

    def sel(mask, new, old):
        return torch.where(mask[:, None] if new.dim() > 1 else mask, new,
                           old)

    def step(x0, U0, g0, table, step_size, inv_mass):
        C, M = x0.shape
        im = inv_mass
        p0 = torch.as_tensor(table["z"], dtype=dtype,
                             device=x0.device) / torch.sqrt(im)
        H0 = U0 + kinetic(p0, im)
        dirs = torch.as_tensor(table["dir"], device=x0.device)
        merge_u = torch.as_tensor(table["merge"], dtype=dtype,
                                  device=x0.device)
        leaf_u = torch.as_tensor(table["leaf"], dtype=dtype,
                                 device=x0.device)
        zeros_c = torch.zeros(C, dtype=dtype, device=x0.device)
        false_c = torch.zeros(C, dtype=torch.bool, device=x0.device)
        t = dict(xl=x0, pl=p0, gl=g0, xr=x0, pr=p0, gr=g0, xp=x0, Up=U0,
                 gp=g0, logw=zeros_c, rho=p0, sum_acc=zeros_c,
                 n_leaves=torch.ones(C, dtype=torch.int32, device=x0.device),
                 depth=torch.zeros(C, dtype=torch.int32, device=x0.device),
                 turning=false_c, diverging=false_c)
        for d in range(max_depth):
            active = ~t["turning"] & ~t["diverging"]
            if not bool(active.any()):
                break
            fwd = dirs[:, d]
            eps = torch.where(fwd, step_size, -step_size)[:, None]
            s = dict(x=sel(fwd, t["xr"], t["xl"]),
                     p=sel(fwd, t["pr"], t["pl"]),
                     g=sel(fwd, t["gr"], t["gl"]))
            s.update(xp=s["x"], Up=zeros_c, gp=s["g"],
                     logw=torch.full_like(zeros_c, -np.inf),
                     rho=torch.zeros_like(x0), sum_acc=zeros_c,
                     leaf=torch.zeros_like(t["depth"]), turning=false_c,
                     diverging=false_c)
            # per slot: momentum and momentum sum before the leaf
            ck_p = [None] * (max_depth + 1)
            ck_S = [None] * (max_depth + 1)
            for k in range(2 ** d):
                live = active & ~s["turning"] & ~s["diverging"]
                if not bool(live.any()):
                    break
                p = s["p"] - 0.5 * eps * s["g"]
                x = s["x"] + eps * im * p
                U, g = potential_fn(x)
                p = p - 0.5 * eps * g
                if k % 2 == 0:
                    # a chain that is not live never reads its slots again
                    slot = min(_ctz(k), max_depth)
                    ck_p[slot], ck_S[slot] = p, s["rho"]
                dH = U + kinetic(p, im) - H0
                diverging = ~(dH < MAX_DELTA_H)
                dH = torch.where(diverging, torch.full_like(dH, np.inf), dH)
                logw_new = torch.logaddexp(s["logw"], -dH)
                take = torch.log(leaf_u[:, d, k]) < -dH - logw_new
                rho = s["rho"] + p
                turning = s["turning"]
                kk = k + 1
                for j in range(1, max_depth + 1):
                    size = 2 ** j
                    if kk % size or size > kk:
                        continue
                    m = kk - size
                    mslot = min(_ctz(m), max_depth)
                    turning = turning | turned(ck_p[mslot], p,
                                               rho - ck_S[mslot], im)
                new = dict(x=x, p=p, g=g, xp=sel(take, x, s["xp"]),
                           Up=torch.where(take, U, s["Up"]),
                           gp=sel(take, g, s["gp"]), logw=logw_new, rho=rho,
                           sum_acc=s["sum_acc"] + torch.clamp(
                               torch.exp(-dH), max=1.0),
                           leaf=s["leaf"] + 1, turning=turning,
                           diverging=diverging)
                s = {key: sel(live, new[key], s[key]) for key in new}
            ok = ~s["turning"] & ~s["diverging"]
            take = (torch.log(merge_u[:, d]) < s["logw"] - t["logw"]) & ok
            grow = ok & fwd
            grow_left = ok & ~fwd
            rho = t["rho"] + sel(ok, s["rho"], torch.zeros_like(s["rho"]))
            new = dict(
                xl=sel(grow_left, s["x"], t["xl"]),
                pl=sel(grow_left, s["p"], t["pl"]),
                gl=sel(grow_left, s["g"], t["gl"]),
                xr=sel(grow, s["x"], t["xr"]),
                pr=sel(grow, s["p"], t["pr"]),
                gr=sel(grow, s["g"], t["gr"]),
                xp=sel(take, s["xp"], t["xp"]),
                Up=torch.where(take, s["Up"], t["Up"]),
                gp=sel(take, s["gp"], t["gp"]),
                logw=torch.where(ok, torch.logaddexp(t["logw"], s["logw"]),
                                 t["logw"]),
                rho=rho, sum_acc=t["sum_acc"] + s["sum_acc"],
                n_leaves=t["n_leaves"] + s["leaf"], depth=t["depth"] + 1,
                diverging=s["diverging"])
            new["turning"] = s["turning"] | turned(new["pl"], new["pr"], rho,
                                                   im)
            t = {key: sel(active, new[key], t[key]) for key in t}
        stats = dict(
            accept_prob=t["sum_acc"] / torch.clamp(t["n_leaves"] - 1,
                                                   min=1).to(dtype),
            depth=t["depth"], n_leapfrog=t["n_leaves"] - 1,
            diverging=t["diverging"])
        return t["xp"], t["Up"], t["gp"], stats

    return step


def run_nuts(potential_fn, x0, *, n_warmup=200, n_samples=500,
             step_size0=0.1, max_depth=8, adapt_mass=True,
             dtype=torch.float32, draws=None, seed=0):
    """Adaptive NUTS over a (C, M) chain batch, the JAX package's
    ``run_nuts`` for every chain at once.

    Each chain adapts its own step size (float64 dual averaging toward
    0.8) and diagonal metric (float64 Welford moments, Stan's shrinkage),
    in two windows: 2/5 of the warmup under the unit metric, then the
    rest under the estimated one with dual averaging restarted from the
    first window's averaged step. ``draws(it)`` gives transition ``it``'s
    table (warmup transitions 0 .. n_warmup-1, sampling from n_warmup);
    by default a ``torch.Generator`` on the chains' device seeded
    ``seed``.

    Returns ``(samples (C, N, M), stats)`` with per-chain ``step_size``
    and ``inv_mass`` (float32), per-draw ``depths``, ``accept_probs``,
    ``n_leapfrog`` and ``divergences`` (N, C), the warmup's step sizes
    ``warm_step_size`` (n_warmup, C) and leaves ``warm_n_leapfrog``, and
    ``state``: the chains' final (x, U, g) and the adaptation state.
    """
    x = torch.as_tensor(x0).to(dtype)
    C, M = x.shape
    device = x.device
    if draws is None:
        gen = torch.Generator(device=device).manual_seed(int(seed))
        draws = generator_draws(C, M, max_depth, gen, dtype)
    kernel = make_nuts_kernel(potential_fn, max_depth=max_depth,
                              dtype=dtype)
    U, g = potential_fn(x)
    inv_mass = torch.ones(M, dtype=dtype, device=device)
    n_a = max(n_warmup * 2 // 5, 1)
    n_b = max(n_warmup - n_a, 1)
    da = dual_averaging_tensors(step_size0, 0.8, torch.float64, (C,), device)
    wf = welford_init((C, M), torch.float64, device)
    warm_eps, warm_leaves = [], []

    def warm(its, x, U, g, da, wf):
        for it in its:
            eps = torch.exp(da["log_eps"]).to(dtype)
            x, U, g, st = kernel(x, U, g, draws(it), eps, inv_mass)
            da = dual_averaging_update(da, st["accept_prob"])
            wf = welford_update(wf, x)
            warm_eps.append(eps)
            warm_leaves.append(st["n_leapfrog"])
        return x, U, g, da, wf

    x, U, g, da, wf = warm(range(n_a), x, U, g, da, wf)
    if adapt_mass:
        inv_mass = welford_variance(wf).to(dtype)
    eps_a = torch.exp(da["log_eps_avg"])
    da = dual_averaging_tensors(1.0, 0.8, torch.float64, (C,), device)
    da.update(log_eps=torch.log(eps_a), log_eps_avg=torch.log(eps_a),
              mu=torch.log(10.0 * eps_a))
    wf = welford_init((C, M), torch.float64, device)
    x, U, g, da, wf = warm(range(n_a, n_a + n_b), x, U, g, da, wf)
    eps = torch.exp(da["log_eps_avg"]).to(dtype)
    samples = torch.empty((n_samples, C, M), dtype=dtype, device=device)
    rows = {"depths": [], "accept_probs": [], "n_leapfrog": [],
            "divergences": []}
    for j, it in enumerate(range(n_warmup, n_warmup + n_samples)):
        x, U, g, st = kernel(x, U, g, draws(it), eps, inv_mass)
        samples[j] = x
        for key, name in (("depths", "depth"), ("accept_probs",
                                                "accept_prob"),
                          ("n_leapfrog", "n_leapfrog"),
                          ("divergences", "diverging")):
            rows[key].append(st[name])

    def stack(v, like):
        return torch.stack(v) if v else torch.zeros((0, C), dtype=like,
                                                     device=device)

    stats = dict(step_size=eps, inv_mass=inv_mass,
                 depths=stack(rows["depths"], torch.int32),
                 accept_probs=stack(rows["accept_probs"], dtype),
                 n_leapfrog=stack(rows["n_leapfrog"], torch.int32),
                 divergences=stack(rows["divergences"], torch.bool),
                 warm_step_size=stack(warm_eps, dtype),
                 warm_n_leapfrog=stack(warm_leaves, torch.int32),
                 state=dict(x=x, U=U, g=g, dual_averaging=da, welford=wf,
                            inv_mass=inv_mass))
    return samples.transpose(0, 1), stats


def NUTSSample(model, nsamples, nwarmup, initial_model, aprior_model,
               boundaries, dobs, RegulFactor=1.0, regularization="Damping",
               beta=0.01, seed=100, log_factor=100.0, step_size0=0.05,
               max_depth=8, myrank=0, save_folder=None, nchains=2,
               dtype=torch.float32, verbose=True, temperature=1.0,
               device=None, draws=None):
    """Adaptive multi-chain NUTS on a :class:`GravMagModule` potential under
    the logistic box transform with its Jacobian, as the JAX package's
    ``NUTSSample``: every chain starts at the initial model (pulled 1e-9
    of the span inside the box) and adapts its own step size and metric.

    Returns its dict with ``samples`` (C, N, M) in reference units, and
    ``step_size`` (C,) and ``inv_mass`` (C, M), as tensors on ``device``
    (``cuda:0`` when None). ``grad_evals`` counts the leapfrog steps the
    sampling trees ran (the JAX package counts 2^depth - 1 a tree, more
    than a tree that stopped inside its last subtree ran).
    With ``save_folder``, chain c's samples are written to
    ``<save_folder><myrank + c>/model.dat`` with a row of seven zeros in
    ``misfit.dat`` each (``runtime/sink.py``), and ``folders`` lists the
    folders, as in the JAX package."""
    device = resolve(device)
    pot, low, high, x0 = _logistic_target(
        model, initial_model, aprior_model, boundaries, regularization,
        beta, log_factor, dtype, temperature, device)
    x0_b = torch.as_tensor(np.tile(x0[None, :], (nchains, 1)), dtype=dtype,
                           device=device)

    def potential(x):
        U, g, _ = pot(x, RegulFactor)
        return U, g

    t0 = time.time()
    xs, stats = run_nuts(potential, x0_b, n_warmup=nwarmup,
                         n_samples=nsamples, step_size0=step_size0,
                         max_depth=max_depth, dtype=dtype, draws=draws,
                         seed=seed + myrank)
    samples = _to_model(xs.transpose(0, 1), low, high, log_factor, model,
                        dtype, device)
    elapsed = time.time() - t0
    out = {
        "samples": samples,
        "step_size": stats["step_size"],
        "inv_mass": stats["inv_mass"],
        "mean_accept": float(stats["accept_probs"].mean()),
        "mean_depth": float(stats["depths"].double().mean()),
        "divergences": int(stats["divergences"].sum()),
        "elapsed_s": elapsed,
        "grad_evals": int(stats["n_leapfrog"].sum()),
    }
    if save_folder is not None:
        host = samples.cpu().numpy().astype(np.float64)
        out["folders"] = write_chains(save_folder, myrank, host,
                                      np.zeros(host.shape[:2] + (7,)))
    return out


def _logistic_target(model, initial_model, aprior_model, boundaries,
                     regularization, beta, log_factor, dtype, temperature,
                     device):
    """The adaptive samplers' target and start, as the JAX package's
    ``CheesSample`` and ``NUTSSample`` build them: the potential under the
    logistic transform with its Jacobian, the box (low, high) in the
    weighted domain, and the start x0 (numpy float64)."""
    wdiag = np.asarray(model.wdiag, np.float64)
    boundaries = np.asarray(boundaries, dtype=np.float64)
    low = wdiag * boundaries[:, 0]
    high = wdiag * boundaries[:, 1]
    aprior_mw = wdiag * np.asarray(aprior_model, dtype=np.float64)
    init_mw = wdiag * np.asarray(initial_model, dtype=np.float64)
    pot = model.make_potential(
        aprior_mw, low, high, constraint="logarithmic",
        log_factor=log_factor, regularization=regularization, beta=beta,
        dtype=dtype, jacobian=True, temperature=temperature, device=device)
    span = high - low + 1e-30
    x0 = mw_to_logistic(np.clip(init_mw, low + 1e-9 * span,
                                high - 1e-9 * span), low, high, log_factor)
    return pot, low, high, np.where(np.isfinite(x0), x0, 0.0)


def _to_model(xs_ncm, low, high, log_factor, model, dtype, device):
    """(N, C, M) logistic positions -> (C, N, M) models in reference
    units, on the device."""
    def vec(v):
        return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
    mw = logistic_to_mw(xs_ncm, vec(low), vec(high), log_factor)
    return (mw * vec(model.wdiag_inv)).transpose(0, 1)
