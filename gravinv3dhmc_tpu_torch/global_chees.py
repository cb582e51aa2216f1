"""The calibrated whole-Earth posterior by ChEES-HMC, on the card.

Counterpart of ``tools/global_chees.py``: the 7,381 x 72,000 tesseroid
problem of :mod:`.global_tess` (the matrix built and weighted on the card)
under its honest posterior, the likelihood ``exp(-||r||^2 / (2
sigma^2))`` with sigma = 0.02 max|dpre| (temperature T = 2 sigma^2) and
Damping (beta 0.01) toward the a priori model 0.001 at RegulFactor 5.0,
the box [0, 0.8] through the logistic transform (k = 1000) with its
Jacobian (:func:`target`). The chains start at the model 0.1 pulled 1e-6
of the span inside the box (:func:`start`) and run
:func:`~.inversion.chees.run_chees` from step size 0.01, its momenta and
accept uniforms from the ``draws`` kernel (Philox keyed by ``--seed``).
``--chunk N`` runs the JAX package's chunked schedule (the warmup and
sample counts rounded up to whole blocks of N iterations, as
``run_chees_chunked`` rounds them); ``--static`` is accepted for the
tool's flag and runs the same loop. At ``--max-steps 512 --chunk 16`` it
reproduces ``GLOBAL_r05.json``'s ``chees_fullscale_chunked``.

The (N, C, M) draw buffer stays on the card, and so does
:func:`summarize`: the posterior mean and (population) standard
deviation in the model domain, RMSD of the mean's mean-removed residual,
RMSM, the correlation with the truth, the share of cells whose truth lies
within two standard deviations of the mean, the amplitude ratio, and
the median ESS over the tool's 128-cell subsample (``RandomState(0)``,
:func:`~.diagnostics.ess_torch`). ``grad_evals`` counts the sampling
phase, C times the sum of its L, as the tool does; ``compile_s`` is 0.0,
as on the JAX chunked path (nothing is compiled here but the kernels,
before the run); ``sampling_s`` runs from the first iteration to the
summary, to a device sync.

``python -m gravinv3dhmc_tpu_torch.global_chees [--nchains 16]
[--nsamples 512] [--nwarmup 300] [--scale 1.0] [--max-steps 1024]
[--chunk 0] [--static] [--seed 7] [--out PATH] [--device DEV]`` prints
the card's name and power limit, then one JSON line with the tool's keys
(``device`` is that card line) and writes it to ``--out`` when given. It
runs on ``cuda:0`` and fails without a card unless given ``--device
cpu``.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from . import _device
from .diagnostics import ess_torch, median
from .global_tess import build
from .inversion.chees import run_chees
from .inversion.potential import logistic_to_mw, mw_to_logistic

#: the tool's target: the regularization factor, the logistic transform's
#: k, the box and a priori model (times the weighting), the start and its
#: pull inside the box (a share of the span)
ALPHA = 5.0
LOG_FACTOR = 1000.0
BOX = (0.0, 0.8)
APRIOR = 0.001
START = 0.1
START_PULL = 1e-6
#: the cells whose ESS is taken (``RandomState(0)``)
NSUB = 128


def target(module, dpre):
    """``(pot, low, high, noise_sigma, temperature)``: the tool's
    potential (``tools/global_chees.py:81-87``) on ``module``."""
    noise_sigma = float(0.02 * np.abs(dpre).max())
    temperature = 2.0 * noise_sigma ** 2
    wdiag = module.wdiag
    low = wdiag * BOX[0]
    high = wdiag * BOX[1]
    pot = module.make_potential(
        wdiag * APRIOR, low, high, constraint="logarithmic",
        log_factor=LOG_FACTOR, regularization="Damping", beta=0.01,
        dtype=torch.float32, jacobian=True, temperature=temperature)
    return pot, low, high, noise_sigma, temperature


def start(wdiag, low, high, nchains):
    """The chains' start in the logistic variable, (C, M) float32:
    ``mw = 0.1 wdiag`` clipped 1e-6 of the span inside the box."""
    span = high - low
    mw0 = torch.minimum(torch.maximum(wdiag * START,
                                      low + START_PULL * span),
                        high - START_PULL * span)
    x0 = mw_to_logistic(mw0, low, high, LOG_FACTOR, xp=torch)
    return x0.to(torch.float32).expand(nchains, -1).contiguous()


def subsample(M):
    """The tool's 128 cells (``RandomState(0)``, no repeats)."""
    return np.random.RandomState(0).choice(M, size=NSUB, replace=False)


def summarize(xs, Aw, low, high, wdiag, wdiag_inv, dobs, truth, sub):
    """The tool's posterior summary of the (N, C, M) logistic-space draws
    ``xs``, on their device: ``(RMSD, RMSM, corr, coverage_2std,
    amplitude_ratio, ess_median, std_model_max)`` as 0-d tensors."""
    m = logistic_to_mw(xs, low, high, LOG_FACTOR) * wdiag_inv
    mean_m = m.mean(dim=(0, 1))
    std_m = m.std(dim=(0, 1), correction=0)
    dpre_mean = (mean_m * wdiag) @ Aw.T
    r = (dpre_mean - dpre_mean.mean()) - (dobs - dobs.mean())
    rmsd = torch.sqrt((r * r).mean())
    rmsm = torch.sqrt(((mean_m - truth) ** 2).mean())
    corr = torch.corrcoef(torch.stack([mean_m, truth]))[0, 1]
    cov = ((mean_m - truth).abs() <= 2.0 * std_m).to(m.dtype).mean()
    amp = torch.sqrt((mean_m ** 2).mean() / (truth ** 2).mean())
    idx = torch.as_tensor(sub, device=m.device)
    ess = ess_torch(m[:, :, idx].permute(1, 0, 2))
    return rmsd, rmsm, corr, cov, amp, median(ess), std_m.max()


def run(nchains=16, nsamples=512, nwarmup=300, scale=1.0, max_steps=1024,
        chunk=0, static=False, seed=7, device=None, problem=None,
        draws=None):
    """The tool's run; returns ``(line, samples)``: its JSON line as a
    dict and the (N, C, M) draw buffer on the device. ``problem`` is a
    built ``(wl, dpre, dobs, module)`` (:func:`~.global_tess.build`) to use
    in place of building one on ``device`` (``cuda:0`` when None);
    ``draws`` replaces the Philox draw source (the tests give it the JAX
    runner's draws)."""
    t_all = time.perf_counter()
    if problem is None:
        problem = build(scale, device=_device.resolve(device))
    wl, dpre, dobs, module = problem
    M = module.n_active
    pot, low, high, noise_sigma, temperature = target(module, dpre)
    x0 = start(module.wdiag, low, high, nchains)
    dev = x0.device
    f32 = torch.float32
    Aw = module.device_arrays(f32)["Aw"]
    truth = _device.as_tensor(wl["rho"], f32, dev)
    dobs_d = _device.as_tensor(dobs, f32, dev)

    def potential(x):
        U, g, _ = pot(x, ALPHA)
        return U, g

    _device.sync(dev)
    t0 = time.perf_counter()
    xs, stats = run_chees(potential, x0, n_warmup=nwarmup,
                          n_samples=nsamples, step_size0=0.01, dtype=f32,
                          max_steps=max_steps, static_trajectory=static,
                          chunk_iters=chunk or None, seed=seed, draws=draws)
    out = summarize(xs, Aw, low, high, module.wdiag, module.wdiag_inv,
                    dobs_d, truth, subsample(M))
    rmsd = float(out[0])  # waits for the card
    elapsed = time.perf_counter() - t0
    dc = dobs - dobs.mean()
    res = {
        "case": "global whole-Earth, HONEST posterior (ChEES-HMC)",
        "device": _device.card() if dev.type == "cuda" else str(dev),
        "problem": [int(dobs.size), int(M)],
        "nchains": nchains, "nsamples": stats["n_samples"],
        "nwarmup": stats["n_warmup"],
        "temperature": temperature,
        "RegulFactor": ALPHA,
        "noise_sigma": noise_sigma,
        "data_rms_centered": float(np.sqrt((dc ** 2).mean())),
        "RMSD": rmsd,
        "RMSM": float(out[1]),
        "posterior_truth_corr": float(out[2]),
        "coverage_2std": float(out[3]),
        "amplitude_ratio": float(out[4]),
        "ess_median": float(out[5]),
        "std_model_max": float(out[6]),
        "accept_mean": float(stats["accept"].mean()),
        "step_size": float(stats["step_size"]),
        "trajectory_time": float(stats["trajectory_time"]),
        "grad_evals": int(nchains * int(stats["L"].sum())),
        "mean_L": stats["mean_L"],
        "max_steps": max_steps,
        "max_steps_saturated": stats["max_steps_saturated"],
        "static_trajectory": static,
        "chunk_iters": chunk or None,
        "compile_s": 0.0,
        "sampling_s": elapsed,
        "total_s": time.perf_counter() - t_all,
    }
    res["ess_per_s_median"] = res["ess_median"] / elapsed
    return res, xs


def parse_args(argv=None):
    """The tool's knobs (``GC_NCHAINS``, ``GC_NSAMPLES``, ``GC_NWARMUP``,
    ``GC_SCALE``, ``GC_MAX_STEPS``, ``GC_CHUNK``, ``GC_STATIC``,
    ``GC_OUT``) at their defaults, and the key's seed."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nchains", type=int, default=16)
    ap.add_argument("--nsamples", type=int, default=512)
    ap.add_argument("--nwarmup", type=int, default=300)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--max-steps", dest="max_steps", type=int, default=1024)
    ap.add_argument("--chunk", type=int, default=0,
                    help="iterations a block of the chunked schedule "
                    "(0: one-shot counts)")
    ap.add_argument("--static", action="store_true")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=None, help="also write the line here")
    ap.add_argument("--device", default=None,
                    help="cuda:0 when not given; cpu runs the plain path")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = _device.resolve(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    if device.type == "cuda":
        print(_device.card(), flush=True)
    res, _ = run(args.nchains, args.nsamples, args.nwarmup, args.scale,
                 args.max_steps, args.chunk, args.static, args.seed, device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
