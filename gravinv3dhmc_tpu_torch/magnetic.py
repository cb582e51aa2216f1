"""Spherical magnetic inversion on the card: the port's run of
``tools/magnetic_demo.py`` (which stays as it is).

Total-field data of magnetized tesseroids (inclination 50, declination -5
degrees; the kernel from Poisson's relation over the tesseroid tensor,
:func:`~.ops.tesseroid.tf`, f64 on the host by the native engine), 2 % of
max|d| noise (seed 7), and the demo's two configurations:

* ``constrained``: a 0.4-degree box of 0.05-degree cells, three 2 km
  layers (64 x 192: 8 x 8 observations at 400 m over one shallow body of
  2 A/m): the exact ridge control (host float64, the best of lambda in
  1e-4, 1e-2, 1) and the bounded MAP
  (:func:`~.inversion.reginv.cg_device`, Damping, float64, box [0, 3],
  alpha 0.01, 400 iterations);
* ``wide_nonunique``: a 1-degree box, five layers (576 x 2000: 24 x 24
  observations at 500 m over two bodies): the ridge control, the bounded
  MAP at alpha 0.05 and 800 iterations, and the honest ChEES
  (:func:`~.inversion.chees.run_chees` in its chunked form: 16 chains,
  192 warmup and 256 draws in blocks of 32, step 0.01 to start, at most
  256 steps; the logistic box [0, 3] with its Jacobian, Damping at alpha
  0.05, beta 0.01, a priori 0.01, T = 2 sigma^2 of the noise).

``python -m gravinv3dhmc_tpu_torch.magnetic`` prints the card's name and
power limit, then one JSON line with the demo's keys (unrounded), plus
each configuration's ``build_s`` and ``tess_backend``, the MAP's
``solve_s``, ``n_iters`` and data misfits, and the ChEES's ``rhat_max``,
``step_size`` and ``mean_L``. :func:`run` takes overrides that cut the
ChEES (``chip_smoke.py``'s phase) or the problems (the tests).
``tools/magnetic_demo.json`` holds the JAX package's statistics from a
TPU run; they are the reference's statistics, never the port's times.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from . import _device, mesher
from .diagnostics import split_rhat
from .inversion.chees import run_chees
from .inversion.potential import (GravMagModule, logistic_to_mw,
                                  mw_to_logistic)
from .inversion.reginv import cg_device
from .ops import tesseroid
from .utils import dircos, regular

INC, DEC = 50.0, -5.0
#: the demo's two configurations (tools/magnetic_demo.py main)
CONSTRAINED = dict(mrange=(-0.2, 0.2, -0.2, 0.2, 0.0, -6000.0), ddeg=0.05,
                   dz=-2000.0, nobs=8, bodies=[(0, 2, 3, 6, 3, 6, 2.0)],
                   zobs=400.0, map=dict(alpha=0.01, maxk=400), chees=None)
WIDE = dict(mrange=(-0.5, 0.5, -0.5, 0.5, 0.0, -10000.0), ddeg=0.05,
            dz=-2000.0, nobs=24,
            bodies=[(0, 2, 5, 10, 5, 10, 2.0), (1, 3, 10, 15, 10, 15, 1.0)],
            zobs=500.0, map=dict(alpha=0.05, maxk=800),
            chees=dict(nchains=16, nwarmup=192, nsamples=256, chunk_iters=32,
                       step_size0=0.01, max_steps=256, seed=11, alpha=0.05,
                       beta=0.01, aprior=0.01, initial=0.1, box=(0.0, 3.0),
                       log_factor=1000.0))
CONFIGS = {"constrained": CONSTRAINED, "wide_nonunique": WIDE}


def build(cfg, device, seed=7):
    """The demo's ``build``: ``(module, truth, dpre, dobs, noise,
    build_s)``; the data from the tesseroid ``tf`` of the bodies'
    magnetization, the module spherical magnetic on ``device``."""
    t0 = time.perf_counter()
    mrange = cfg["mrange"]
    spacing = (cfg["dz"], cfg["ddeg"], cfg["ddeg"])
    mesh = mesher.TesseroidMesh(mrange, spacing)
    mag3 = np.zeros(mesh.shape)
    for (z0, z1, y0, y1, x0, x1, amp) in cfg["bodies"]:
        mag3[z0:z1, y0:y1, x0:x1] = amp
    mesh.addprop("magnetization",
                 np.outer(mag3.ravel(), np.array(dircos(INC, DEC))))
    pad = 0.04 * (mrange[1] - mrange[0])
    lons, lats, hs = regular((mrange[0] + pad, mrange[1] - pad,
                              mrange[2] + pad, mrange[3] - pad),
                             (cfg["nobs"], cfg["nobs"]), z=cfg["zobs"])
    dpre, _ = tesseroid.tf(lons, lats, hs, mesh, INC, DEC)
    rng = np.random.RandomState(seed)
    noise = 0.02 * np.abs(dpre).max()
    dobs = dpre + rng.normal(0, noise, dpre.size)
    module = GravMagModule(dobs, mrange, spacing, (lons, lats, hs),
                           coordinate="spherical", field="magnetic",
                           mangle=(INC, DEC), verbose=False, device=device)
    return (module, mag3.ravel(), dpre, dobs, noise,
            time.perf_counter() - t0)


def ridge_control(module, dobs, dpre, noise, truth):
    """Exact (unbounded) ridge on the weighted normal equations, host
    float64: the best lambda by correlation with the truth."""
    Aw = np.asarray(module.Aw, np.float64)
    best = None
    for lam in (1e-4, 1e-2, 1.0):
        mw = np.linalg.solve(Aw.T @ Aw + lam * np.eye(Aw.shape[1]),
                             Aw.T @ dobs)
        m = mw * np.asarray(module.wdiag_inv)
        corr = float(np.corrcoef(m, truth)[0, 1])
        fit = float(np.sqrt(np.mean((module.A @ m - dpre) ** 2)) / noise)
        if best is None or corr > best["corr"]:
            best = {"lambda": lam, "corr": corr, "rmsd_over_noise": fit}
    return best


def bounded_map(module, dobs, dpre, noise, truth, alpha, maxk, device):
    """The float64 bounded MAP on the card: ``(summary, history)``."""
    _device.sync(device)
    t0 = time.perf_counter()
    cg = cg_device(module, dobs, (0.0, 3.0), regularization="Damping",
                   maxk=maxk, dtype=torch.float64, alpha=alpha)
    m = cg["m"].cpu().numpy()
    solve_s = time.perf_counter() - t0
    d_h = cg["data_hist"]
    out = {"alpha": alpha, "maxk": maxk,
           "truth_corr": float(np.corrcoef(m, truth)[0, 1]),
           "rmsd_over_noise": float(np.sqrt(np.mean(
               (module.A @ m - dpre) ** 2)) / noise),
           "n_iters": cg["n_iters"], "solve_s": solve_s,
           "data_hist_first": float(d_h[0]),
           "data_hist_min": float(np.min(d_h)),
           "data_hist_last": float(d_h[-1]),
           "m_on_card": cg["m"].device.type == torch.device(device).type}
    return out, {"data_hist": d_h, "model_hist": cg["model_hist"], "m": m}


def honest_chees(module, noise, truth, cfg, device):
    """The calibrated ChEES on the logistic box: ``(summary, tensors)``."""
    M = module.n_active
    wdiag = np.asarray(module.wdiag)
    lo, hi = cfg["box"]
    low, high = wdiag * lo, wdiag * hi
    lf = cfg["log_factor"]
    pot = module.make_potential(wdiag * cfg["aprior"], low, high,
                                constraint="logarithmic", log_factor=lf,
                                regularization="Damping", beta=cfg["beta"],
                                dtype=torch.float32, jacobian=True,
                                temperature=2.0 * float(noise) ** 2,
                                device=device)

    def potential(x):
        U, g, _ = pot(x, cfg["alpha"])
        return U, g

    C = cfg["nchains"]
    span = high - low
    x0 = mw_to_logistic(np.clip(wdiag * cfg["initial"], low + 1e-6 * span,
                                high - 1e-6 * span), low, high, lf)
    x0b = torch.as_tensor(np.tile(x0[None, :], (C, 1)),
                          dtype=torch.float32, device=device)
    _device.sync(device)
    t0 = time.perf_counter()
    buf, st = run_chees(potential, x0b, n_warmup=cfg["nwarmup"],
                        n_samples=cfg["nsamples"],
                        chunk_iters=cfg["chunk_iters"],
                        step_size0=cfg["step_size0"],
                        max_steps=cfg["max_steps"], seed=cfg["seed"])
    _device.sync(device)
    sampling_s = time.perf_counter() - t0
    lo_t = torch.as_tensor(low, dtype=torch.float32, device=device)
    hi_t = torch.as_tensor(high, dtype=torch.float32, device=device)
    mw = logistic_to_mw(buf, lo_t, hi_t, lf)
    m = mw * torch.as_tensor(module.wdiag_inv, dtype=torch.float32,
                             device=device)
    mean_m = m.mean((0, 1)).double()
    std_m = m.std((0, 1), correction=0).double()
    t_d = torch.as_tensor(truth, dtype=torch.float64, device=device)
    corr = torch.corrcoef(torch.stack([mean_m, t_d]))[0, 1]
    rhat = split_rhat(m.transpose(0, 1))
    out = {"nchains": C, "nsamples": int(st["n_samples"]),
           "nwarmup": int(st["n_warmup"]),
           "accept": float(st["accept"].mean()),
           "posterior_truth_corr": float(corr),
           "coverage_2std": float(((mean_m - t_d).abs()
                                   <= 2.0 * std_m).double().mean()),
           "mean_posterior_std": float(std_m.mean()),
           "rhat_max": float(rhat.max()),
           "step_size": float(st["step_size"]), "mean_L": st["mean_L"],
           "max_steps_saturated": st["max_steps_saturated"],
           "grad_evals": int(C * (st["warm_L"].sum() + st["L"].sum())),
           "sampling_s": sampling_s}
    return out, {"samples": buf, "x": st["state"]["x"]}


def run(device=None, configs=None, chees=None):
    """The demo's run: ``(result, tensors, hists)``. ``configs`` maps a
    configuration name to changes of :data:`CONSTRAINED` / :data:`WIDE`
    (both by default; a name mapped to None is skipped); ``chees``
    changes the wide configuration's ChEES settings."""
    device = _device.resolve(device)
    configs = {name: {} for name in CONFIGS} if configs is None else configs
    t0 = time.perf_counter()
    res = {"case": "spherical MAGNETIC inversion, tesseroid tf via Poisson "
                   "over the GLQ tensor (the JAX package's extension)",
           "device": str(device)}
    tensors, hists = {}, {}
    for name, change in configs.items():
        if change is None:
            continue
        cfg = dict(CONFIGS[name], **change)
        module, truth, dpre, dobs, noise, build_s = build(cfg, device)
        entry = {"problem": [int(dobs.size), int(module.n_active)],
                 "build_s": build_s, "tess_backend": module.tess_backend,
                 "ridge_control": ridge_control(module, dobs, dpre, noise,
                                                truth)}
        entry["bounded_map"], hists[name] = bounded_map(
            module, dobs, dpre, noise, truth, cfg["map"]["alpha"],
            cfg["map"]["maxk"], device)
        if cfg["chees"] is not None:
            ch = dict(cfg["chees"], **(chees or {}))
            entry["honest_chees"], tensors[name] = honest_chees(
                module, noise, truth, ch, device)
        res[name] = entry
    res["total_s"] = time.perf_counter() - t0
    return res, tensors, hists


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = _device.resolve(None)
    card = _device.card()
    print(card, flush=True)
    res, _, _ = run(device)
    print(json.dumps({"card": card, **res}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
