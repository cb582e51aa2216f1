"""ChEES-HMC: cross-chain adaptive trajectory lengths, in PyTorch.

Counterpart of ``gravinv3dhmc_tpu/inversion/chees.py``. Every chain runs
the same number of leapfrog steps an iteration, ``L = clip(int(u T / eps)
+ 1, 1, max_steps)`` with ``u`` the van der Corput jitter
(:func:`_halton`); the step size eps adapts by dual averaging toward the
target mean accept probability and the trajectory time T by Adam on the
accept-weighted ChEES gradient of log T. As in the JAX package the
adaptation state is float32 and shared by all chains, and both freeze
after warmup (eps at its averaged iterate).

One runner serves the JAX package's one-shot ``run_chees`` and its
``run_chees_chunked``: the chunked form (``chunk_iters``) rounds the
warmup and sample counts up to whole blocks and reads a summary a block;
the blocks were a TPU-worker workaround, so there is no second trajectory
loop. ``static_trajectory`` (the JAX package's masked fixed-length scan,
bit-equal to its dynamic loop) runs the same loop.

The state lives on the chains' device. During warmup the host reads L
once an iteration (it depends on the last iteration's accept rate);
after the freeze every L is known and read once. Momentum normals and
accept uniforms come from Philox keyed by (salt of ``seed``, iteration):
one launch of the ``draws`` kernel an iteration on the card, its plain
version on the CPU. A *draw source* ``draws(it) -> (n01 (C, M), u (C,))``
replaces them; the tests feed it the JAX runner's own draws.

Entry points run on ``cuda:0`` unless a device is given.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .._device import resolve
from ..ops import philox
from ..ops.leapfrog import KERNELS, LANE
from ..runtime.sink import write_chains
from .nuts import (_logistic_target, _to_model, dual_averaging_tensors,
                   dual_averaging_update)


def _halton(i):
    """Van der Corput jitter (base 2, 16-bit reversal) of iteration ``i``
    (an int or an integer tensor), float32: the sum of exact powers of 2,
    so bit-equal to the JAX package's."""
    i = torch.as_tensor(i).to(torch.int64) + 1
    out = torch.zeros(i.shape, dtype=torch.float32, device=i.device)
    f = 0.5
    for _ in range(16):
        out = out + f * (i % 2).to(torch.float32)
        i = i // 2
        f *= 0.5
    return out


def adam_init(x0, device=None):
    """Adam's state on a scalar started at ``x0``, float32 tensors."""
    def z(v):
        return torch.tensor(v, dtype=torch.float32, device=device)
    return dict(x=z(float(x0)), m=z(0.0), v=z(0.0), t=z(0.0))


def adam_update(state, grad, lr=0.025, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam ascent step on the scalar ``x``."""
    t = state["t"] + 1.0
    m = b1 * state["m"] + (1 - b1) * grad
    v = b2 * state["v"] + (1 - b2) * grad * grad
    mhat = m / (1 - b1 ** t)
    vhat = v / (1 - b2 ** t)
    x = state["x"] + lr * mhat / (torch.sqrt(vhat) + eps)
    return dict(x=x, m=m, v=v, t=t)


def _lengths(its, log_eps, log_T, max_steps):
    """The trajectory lengths of iterations ``its`` (int tensor) at
    ``eps = exp(log_eps)``, ``T = exp(log_T)`` (float32), as the JAX
    package truncates them; u T / eps is capped at ``max_steps`` before
    the integer conversion, which the clip makes no difference to."""
    eps = torch.exp(log_eps)
    T = torch.exp(log_T)
    v = torch.nan_to_num(_halton(its) * T / eps, nan=0.0)
    v = torch.clamp(v, max=float(max_steps))
    return torch.clamp(v.to(torch.int32) + 1, 1, max_steps)


def _philox_draws(salt, C, M, device):
    """The card's draw source: one ``draws`` launch an iteration."""
    width = -(-M // LANE) * LANE

    def draws(it):
        n01 = torch.empty((C, width), dtype=torch.float32, device=device)
        u = torch.empty(C, dtype=torch.float32, device=device)
        KERNELS["draws"](n01, u, salt, it)
        return n01[:, :M], u

    return draws


def run_chees(potential_fn, x0, *, n_warmup=200, n_samples=500,
              step_size0=0.05, T0=None, target_accept=0.75, max_steps=1024,
              dtype=torch.float32, static_trajectory=False, chunk_iters=None,
              seed=0, draws=None, verbose=False):
    """Adaptive ChEES-HMC over a chain batch.

    ``potential_fn(x) -> (U (C,), grad (C, M))`` takes the whole batch:
    the adaptation couples the chains through cross-chain means. ``x0`` is
    a (C, M) tensor on the device the run uses. ``chunk_iters`` runs the
    JAX package's ``run_chees_chunked`` schedule (counts rounded up to
    whole blocks of that many iterations, a summary read a block).
    ``static_trajectory`` is accepted for the JAX signature and runs the
    same loop. ``seed`` keys the Philox draws; ``draws`` replaces them.

    Returns ``(samples (n_samples, C, M), stats)``. ``stats`` has the JAX
    one-shot runner's keys (per-iteration ``accept``, ``L`` and
    ``warm_*`` series as tensors, ``step_size``, ``trajectory_time``,
    ``mean_L``, ``max_steps``, ``max_steps_saturated``), the counts run,
    and ``state``: the final chain state and the frozen adaptation state
    (tensors on the device). In the chunked form it adds ``chunk_iters``
    and the block summaries ``block_accept`` and ``block_mean_L``.
    """
    del static_trajectory  # same loop; see the module docstring
    x = torch.as_tensor(x0).to(dtype)
    device = x.device
    C, M = x.shape
    if T0 is None:
        T0 = 10.0 * step_size0
    if chunk_iters:
        n_warmup = -(-n_warmup // chunk_iters) * chunk_iters
        n_samples = -(-n_samples // chunk_iters) * chunk_iters
    if draws is None:
        draws = _philox_draws(philox.salt_from_seed(seed), C, M, device)

    U, g = potential_fn(x)
    U, g = U.to(dtype), g.to(dtype)
    da = dual_averaging_tensors(step_size0, target_accept, torch.float32,
                                device=device)
    ad = adam_init(np.log(T0), device)
    samples = torch.empty((n_samples, C, M), dtype=dtype, device=device)
    series = {"accept": [], "L": [], "T": []}

    def iteration(it, L, x, U, g, da, ad, collecting):
        eps = torch.exp(da["log_eps"]).to(dtype)
        T = torch.exp(ad["x"]).to(dtype)
        u_it = _halton(it).to(device)
        n01, u = draws(it)
        p0 = torch.as_tensor(n01, dtype=dtype, device=device)
        u = torch.as_tensor(u, dtype=dtype, device=device)
        H0 = U + 0.5 * (p0 * p0).sum(-1)
        xs, p, Us, gs = x, p0 - 0.5 * eps * g, U, g
        for i in range(L):
            xs = xs + eps * p
            Us, gs = potential_fn(xs)
            p = p - (0.5 * eps if i == L - 1 else eps) * gs
        dH = Us + 0.5 * (p * p).sum(-1) - H0
        accept_prob = torch.clamp(torch.exp(-torch.where(
            torch.isfinite(dH), dH, torch.full_like(dH, np.inf))), max=1.0)
        acc = u < accept_prob
        # the ChEES gradient (accept-weighted), normalised for Adam on log T
        w = accept_prob / torch.clamp(accept_prob.sum(), min=1e-12)
        c_old = x - x.mean(0)
        c_new = xs - (w[:, None] * xs).sum(0)
        delta = (c_new * c_new).sum(-1) - (c_old * c_old).sum(-1)
        grad_t = (w * delta * (c_new * p).sum(-1)).sum() * u_it
        grad_log_T = grad_t * T / (torch.abs(grad_t * T) + 1e-6)
        x = torch.where(acc[:, None], xs, x)
        U = torch.where(acc, Us, U)
        g = torch.where(acc[:, None], gs, g)
        mean_accept = accept_prob.mean()
        if not collecting:
            da = dual_averaging_update(da, mean_accept)
            ad = adam_update(ad, grad_log_T)
        series["accept"].append(mean_accept)
        series["T"].append(torch.exp(ad["x"]))
        series["L"].append(L)
        return x, U, g, da, ad

    def report(phase, it):
        if verbose and chunk_iters and (it + 1) % chunk_iters == 0:
            block = series["L"][-chunk_iters:]
            print(f"chees {phase} block {(it + 1) // chunk_iters}: accept "
                  f"{float(torch.stack(series['accept'][-chunk_iters:]).mean()):.2f}"
                  f" mean_L {np.mean(block):.0f}", flush=True)

    for it in range(n_warmup):
        L = int(_lengths(torch.tensor(it), da["log_eps"], ad["x"], max_steps))
        x, U, g, da, ad = iteration(it, L, x, U, g, da, ad, False)
        report("warmup", it)
    # freeze: eps at its averaged iterate, T where Adam left it
    da = {**da, "log_eps": da["log_eps_avg"]}
    its = torch.arange(n_warmup, n_warmup + n_samples, device=device)
    Ls = _lengths(its, da["log_eps"], ad["x"], max_steps).tolist()
    for j, it in enumerate(range(n_warmup, n_warmup + n_samples)):
        x, U, g, da, ad = iteration(it, Ls[j], x, U, g, da, ad, True)
        samples[j] = x
        report("sampling", it)

    def tail(key, lo, hi):
        vals = series[key][lo:hi]
        if key == "L":
            return torch.tensor(vals, dtype=torch.int64)
        return (torch.stack(vals) if vals
                else torch.zeros(0, dtype=torch.float32, device=device))

    L_s = tail("L", n_warmup, None)
    stats = dict(
        step_size=torch.exp(da["log_eps_avg"]),
        trajectory_time=torch.exp(ad["x"]),
        warm_accept=tail("accept", 0, n_warmup),
        warm_L=tail("L", 0, n_warmup),
        warm_T=tail("T", 0, n_warmup),
        accept=tail("accept", n_warmup, None),
        L=L_s,
        mean_L=float(L_s.double().mean()) if n_samples else float("nan"),
        max_steps=max_steps,
        max_steps_saturated=(float((L_s >= max_steps).double().mean())
                             if n_samples else float("nan")),
        n_warmup=n_warmup, n_samples=n_samples,
        state=dict(x=x, U=U, g=g, dual_averaging=da, adam=ad),
    )
    if chunk_iters:
        acc_s = stats["accept"].reshape(-1, chunk_iters)
        stats.update(chunk_iters=chunk_iters,
                     block_accept=acc_s.mean(1),
                     block_mean_L=L_s.reshape(-1, chunk_iters).double()
                     .mean(1))
    return samples, stats


def CheesSample(model, nsamples, nwarmup, initial_model, aprior_model,
                boundaries, dobs, RegulFactor=1.0, regularization="Damping",
                beta=0.01, seed=100, log_factor=100.0, step_size0=0.05,
                target_accept=0.75, myrank=0, save_folder=None, nchains=16,
                dtype=torch.float32, verbose=True, temperature=1.0,
                max_steps=1024, chunk_iters=None, transfer_samples=True,
                device=None, draws=None):
    """Multi-chain ChEES-HMC on a :class:`GravMagModule` potential under the
    logistic box transform with its Jacobian, as the JAX package's
    ``CheesSample``.

    The chains start at the initial model (pulled 1e-9 of the span inside
    the box) plus 0.01 of normals from a CPU generator seeded ``seed + 1``
    (the JAX package draws them from its own key). Returns its dict with
    ``samples`` (C, N, M) in reference units as a tensor on ``device``
    (``cuda:0`` when None; ``transfer_samples`` is accepted for the JAX
    signature), and, unlike the JAX package's chunked mode, the
    per-iteration ``L`` and warmup's trajectories counted in
    ``grad_evals`` (batch gradient evaluations, the JAX one-shot count).
    With ``save_folder``, chain c's samples are written to
    ``<save_folder><myrank + c>/model.dat`` with a row of seven zeros in
    ``misfit.dat`` each (``runtime/sink.py``), and ``folders`` lists the
    folders, as in the JAX package."""
    del transfer_samples
    device = resolve(device)
    pot, low, high, x0 = _logistic_target(
        model, initial_model, aprior_model, boundaries, regularization,
        beta, log_factor, dtype, temperature, device)
    gen = torch.Generator().manual_seed(seed + 1)
    x0_b = (torch.as_tensor(np.tile(x0[None, :], (nchains, 1)), dtype=dtype)
            + 0.01 * torch.randn((nchains, x0.size), generator=gen,
                                 dtype=dtype)).to(device)

    def potential(x):
        U, g, _ = pot(x, RegulFactor)
        return U, g

    t0 = time.time()
    xs, stats = run_chees(
        potential, x0_b, n_warmup=nwarmup, n_samples=nsamples,
        step_size0=step_size0, target_accept=target_accept,
        max_steps=max_steps, dtype=dtype, chunk_iters=chunk_iters,
        seed=seed + myrank, draws=draws, verbose=verbose)
    samples = _to_model(xs, low, high, log_factor, model, dtype, device)
    elapsed = time.time() - t0
    out = {
        "samples": samples,
        "step_size": float(stats["step_size"]),
        "trajectory_time": float(stats["trajectory_time"]),
        "mean_accept": float(stats["accept"].mean()),
        "mean_L": stats["mean_L"],
        "L": stats["L"],
        "max_steps": max_steps,
        "max_steps_saturated": stats["max_steps_saturated"],
        "elapsed_s": elapsed,
        "grad_evals": int(stats["L"].sum() + stats["warm_L"].sum()),
    }
    if save_folder is not None:
        host = samples.cpu().numpy().astype(np.float64)
        out["folders"] = write_chains(save_folder, myrank, host,
                                      np.zeros(host.shape[:2] + (7,)))
    return out
