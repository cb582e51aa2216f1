"""The deterministic path on the card: CG, bootstrap and the bounded MAP.

Three stages, each a command of the JAX package at its defaults, rebuilt from
this package's own layers (:mod:`.inversion.reginv`):

* ``cg``: ``examples/run.py cg``. The reference's CG model 03, two
  dipping dykes of unit density in a 30 x 40 x 10 mesh of 100 m prisms
  under 1,200 observations at z = 0 (:func:`twodykes`), data from the f64
  prism forward with 2 % noise (seed 1), then float64
  :class:`~.inversion.reginv.ConjugateGradient`: MS, beta 0.001, q 0.7,
  200 iterations at most, box [0, 1], starting and a priori model 0.
* ``bootstrap``: ``examples/run.py bootstrap``. The single cube of the
  600 x 6000 uniformgrid problem (:func:`singlecube`) with the same
  noise, 20 replicates of float64 :class:`~.inversion.reginv.BootStrap`
  (beta 0.01, 200 iterations at most, box [0, 1]), all in one batch.
* ``map``: the bounded MAP that calibrates the realdata temperature in
  ``tools/samplers_tpu.py realdata`` (``SAMPLERS_RD_TEMP=auto``):
  :func:`~.realdata.build_problem`'s 576 x 10,676 tesseroid problem,
  :func:`~.inversion.reginv.cg_device` in float32 with Damping at a fixed
  alpha 0.05, 400 iterations at most, box [-0.5, 0.5]; then the
  mean-removed residual of ``predict``, sigma_hat^2 its mean square and
  the likelihood temperature T = 2 sigma_hat^2.

The matrices are built on the host as the JAX classes build them (the f64
numpy prism builder, the native tesseroid engine); the solves run on the
card. Each stage's line has the JAX command's keys (``cg``: iterations,
final_data_misfit, RMSD, RMSM, corr; ``bootstrap``: samples,
mean_model_max, std_model_max, RMSM; ``map``: n_iters, RMSD, temperature,
data_hist_min, data_hist_last), plus ``build_s`` (the host builds),
``solve_s`` (the solve, to a device sync), ``total_s`` and ``device``.

``python -m gravinv3dhmc_tpu_torch.cg [cg] [bootstrap] [map]`` (all three
by default) prints the card's name and power limit, then one JSON line a
stage. Matrix products are IEEE (TF32 off). A failing stage fails the run.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from . import _device, mesher, realdata, utils
from .diagnostics import rmsd, rmsm
from .inversion.reginv import BootStrap, ConjugateGradient, cg_device
from .ops import prism
from .uniformgrid import _sync, density_model

#: the stages' settings (``examples/run.py cg`` and ``bootstrap`` at their
#: defaults, the samplers tool's bounded MAP); ``nz``, ``shape`` and
#: ``step`` cut the problems for the tests
CG = dict(nz=10, regularization="MS", beta=0.001, q=0.7, maxk=200,
          noise=0.02, seed_noise=1)
BOOTSTRAP = dict(shape=(20, 30, 10), samples=20, beta=0.01, maxk=200,
                 noise=0.02, seed_noise=1)
MAP = dict(step=0.5, regularization="Damping", alpha=0.05, maxk=400,
           boundary=(-0.5, 0.5), dtype=torch.float32)
STAGES = ("cg", "bootstrap", "map")


def twodykes(nz=10):
    """The reference's CG model 03 (``examples/workloads.py`` cg_model
    "model03_twodykes", reference: example/CG/model03_twodykes.py:51-57):
    30 x 40 x ``nz`` prisms of 100 m (10 layers in the reference), two
    dipping dykes of density 1 (cut at the mesh's bottom when ``nz`` is
    smaller), observations over the mesh's columns at z = 0. Returns the
    workload dict of ``workloads.py``."""
    nx, ny, d = 30, 40, 100
    mrange = (0, nx * d, 0, ny * d, 0, nz * d)
    mesh = mesher.PrismMesh(mrange, (d, d, d))
    rho3 = np.zeros(mesh.shape)
    for iz in range(1, min(4, nz)):
        rho3[iz, iz + 8: iz + 11, 14:17] = 1.0
    for iz in range(2, min(8, nz)):
        rho3[iz, -iz + 24: -iz + 33, 11:20] = 1.0
    rho = rho3.ravel()
    mesh.addprop("density", rho)
    xo, yo, zo = utils.regular(mrange[:4], (nx, ny), z=0.0)
    return dict(mrange=mrange, mspacing=(d, d, d), mesh=mesh, rho=rho,
                obs=(xo, yo, zo), rhomin=0.0, rhomax=1.0)


def singlecube(nx=20, ny=30, nz=10):
    """The uniformgrid workload (``workloads.uniformgrid``, reference:
    example/uniformgrid/model01_singlecube.py:24-40): a unit-density cube
    in ``nx`` x ``ny`` x ``nz`` prisms of 100 m
    (:func:`~.uniformgrid.density_model`), observations over the columns
    at z = 0."""
    d = 100
    mrange = (0, nx * d, 0, ny * d, 0, nz * d)
    mesh = mesher.PrismMesh(mrange, (d, d, d))
    rho = density_model(nx, ny, nz).ravel()
    mesh.addprop("density", rho)
    xo, yo, zo = utils.regular(mrange[:4], (nx, ny), z=0.0)
    return dict(mrange=mrange, mspacing=(d, d, d), mesh=mesh, rho=rho,
                obs=(xo, yo, zo), rhomin=0.0, rhomax=1.0)


def forward_with_noise(wl, noise=0.02, seed=1):
    """The truth's data from the f64 host prism builder with ``noise``
    times max|data| of seeded Gaussian noise (``workloads.py``
    ``forward_with_noise``): ``(dpre, dobs)``."""
    dpre, _ = prism.gz(*wl["obs"], wl["mesh"])
    return dpre, utils.contaminate(dpre, noise * np.abs(dpre).max(),
                                   seed=seed)


def decay_iters(regul):
    """The iterations k >= 2 at which the adaptive alpha fell."""
    r = np.asarray(regul, np.float64)
    return [k for k in range(2, r.size) if np.isfinite(r[k])
            and r[k] < r[k - 1]]


def stage_cg(device, cfg):
    t0 = time.perf_counter()
    wl = twodykes(cfg["nz"])
    _, dobs = forward_with_noise(wl, cfg["noise"], cfg["seed_noise"])
    inv = ConjugateGradient(dobs, wl["mrange"], wl["mspacing"], wl["obs"],
                            verbose=False, device=device)
    M = inv.msize
    t1 = time.perf_counter()
    model_inv, data_inv, d_h, m_h, r_h = inv.CG(
        np.zeros(M), np.zeros(M), (wl["rhomin"], wl["rhomax"]),
        regularization=cfg["regularization"], beta=cfg["beta"], q=cfg["q"],
        maxk=cfg["maxk"])
    _sync(device)
    t2 = time.perf_counter()
    line = dict(workload="CG:model03_twodykes", problem=[inv.dsize, M],
                iterations=len(d_h), final_data_misfit=float(d_h[-1]),
                RMSD=rmsd(dobs, data_inv), RMSM=rmsm(model_inv, wl["rho"]),
                corr=float(np.corrcoef(model_inv, wl["rho"])[0, 1]),
                model_max=float(model_inv.max()),
                model_min=float(model_inv.min()),
                n_decays=len(decay_iters(r_h)))
    hist = dict(data_hist=d_h, model_hist=m_h, regul_hist=r_h,
                model=model_inv, truth=wl["rho"])
    return line, inv.result, hist, t1 - t0, t2 - t1


def stage_bootstrap(device, cfg):
    t0 = time.perf_counter()
    wl = singlecube(*cfg["shape"])
    _, dobs = forward_with_noise(wl, cfg["noise"], cfg["seed_noise"])
    bs = BootStrap(wl["mrange"], wl["mspacing"], wl["obs"], dobs,
                   (wl["rhomin"], wl["rhomax"]), samples=cfg["samples"],
                   beta=cfg["beta"], maxk=cfg["maxk"], verbose=False,
                   device=device)
    t1 = time.perf_counter()
    models, d_h, m_h, r_h = bs.BSCG(np.zeros(bs.msize))
    _sync(device)
    t2 = time.perf_counter()
    mean = models.mean(axis=0)
    std = models.std(axis=0)
    n_iters = [int(np.sum(~np.isnan(row))) + 1 for row in d_h]
    line = dict(workload="bootstrap", problem=[bs.dsize, bs.msize],
                samples=cfg["samples"], mean_model_max=float(mean.max()),
                std_model_max=float(std.max()),
                RMSM=float(np.sqrt(np.mean((mean - wl["rho"]) ** 2))),
                n_iters=n_iters)
    hist = dict(data_hist=d_h, model_hist=m_h, regul_hist=r_h,
                models=models)
    return line, bs.result, hist, t1 - t0, t2 - t1


def stage_map(device, cfg, problem=None):
    t0 = time.perf_counter()
    module, dobs = problem or realdata.build_problem(device=device,
                                                     step=cfg["step"])
    t1 = time.perf_counter()
    res = cg_device(module, dobs, cfg["boundary"],
                    regularization=cfg["regularization"], maxk=cfg["maxk"],
                    dtype=cfg["dtype"], alpha=cfg["alpha"])
    dp = module.predict(res["mw"])
    dz = torch.as_tensor(dobs, dtype=cfg["dtype"], device=dp.device)
    rr = (dp - dp.mean()) - (dz - dz.mean())
    sigma_hat2 = float((rr * rr).mean())
    _sync(device)
    t2 = time.perf_counter()
    d_h = res["data_hist"]
    line = dict(workload="realdata_map",
                problem=[int(dobs.size), int(module.n_active)],
                n_iters=res["n_iters"], RMSD=float(np.sqrt(sigma_hat2)),
                sigma_hat2=sigma_hat2, temperature=2.0 * sigma_hat2,
                data_hist_min=float(np.min(d_h)),
                data_hist_last=float(d_h[-1]),
                data_hist_first=float(d_h[0]),
                RegulFactor=cfg["alpha"])
    hist = {k: res[k] for k in ("data_hist", "model_hist", "regul_hist")}
    return (line, {"mw": res["mw"], "m": res["m"], "dpre": dp}, hist,
            t1 - t0, t2 - t1)


def run(which=STAGES, device=None, overrides=None, map_problem=None):
    """Run the stages ``which`` on ``device`` (``cuda:0`` when None).
    Returns ``{name: (line, tensors, hist)}``: the JSON line's dict, the
    solution tensors on the device, and the host float64 histories (with
    the host models and truth where the stage has them). ``overrides``
    maps a stage name to changes of :data:`CG`, :data:`BOOTSTRAP` or
    :data:`MAP`; ``map_problem`` is a realdata ``(module, dobs)`` for the
    ``map`` stage."""
    device = _device.resolve(device)
    overrides = overrides or {}
    stages = {"cg": (stage_cg, CG), "bootstrap": (stage_bootstrap,
                                                  BOOTSTRAP),
              "map": (stage_map, MAP)}
    out = {}
    for name in which:
        if name not in stages:
            raise ValueError(f"unknown stage {name!r}; choose from "
                             f"{STAGES}")
        fn, base = stages[name]
        cfg = dict(base, **overrides.get(name, {}))
        t0 = time.perf_counter()
        args = (map_problem,) if name == "map" else ()
        line, tensors, hist, build_s, solve_s = fn(device, cfg, *args)
        line.update(build_s=build_s, solve_s=solve_s,
                    total_s=time.perf_counter() - t0, device=str(device))
        out[name] = (line, tensors, hist)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("stages", nargs="*", metavar="{cg,bootstrap,map}",
                    help="the stages to run (all three by default)")
    args = ap.parse_args(argv)
    stages = args.stages or list(STAGES)
    if not set(stages) <= set(STAGES):
        ap.error(f"choose stages from {STAGES}")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = _device.resolve(None)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for name in stages:
        line = run((name,), device)[name][0]
        print(json.dumps({"card": card, "stage": name, **line}), flush=True)


if __name__ == "__main__":
    main()
