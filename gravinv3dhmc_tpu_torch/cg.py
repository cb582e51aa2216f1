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
* ``bootstrap_southchina``: ``examples/run.py bootstrap-southchina`` at
  its defaults (reference:
  example/bootstrap_southchina/main_BSCG_SouthChina_20km.py:38-56, its
  data synthetic as in the JAX command): a ratio-1.5 mesh of 7 x 17 x 17
  cells carved under a coastal topography to 1,579 cells, 289
  observations on the topography, seeded Gaussian data (sigma 15), 20
  float64 :class:`~.inversion.reginv.BootStrap` replicates (beta 0.01,
  200 iterations at most, box [-1, 1]) with ``wavelet="1D"``: the module
  builds the wavelet kernel, and the solve reads the dense one, as the
  JAX package's does.
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
mean_model_max, std_model_max, RMSM; ``bootstrap_southchina``:
mesh_shape, carved_cells, samples, model_std_max, finite; ``map``:
n_iters, RMSD, temperature, data_hist_min, data_hist_last), plus
``build_s`` (the host builds),
``solve_s`` (the solve, to a device sync), ``total_s`` and ``device``.

``python -m gravinv3dhmc_tpu_torch.cg [cg] [bootstrap]
[bootstrap_southchina] [map]`` (all four by default) prints the card's name and power limit, then one JSON line a
stage. Matrix products are IEEE (TF32 off). A failing stage fails the run.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from . import _device, realdata
from .diagnostics import rmsd, rmsm
from .inversion.reginv import BootStrap, ConjugateGradient, cg_device
from .workloads import forward_with_noise, singlecube, twodykes

#: the stages' settings (``examples/run.py cg`` and ``bootstrap`` at their
#: defaults, the samplers tool's bounded MAP); ``nz``, ``shape`` and
#: ``step`` cut the problems for the tests
CG = dict(nz=10, regularization="MS", beta=0.001, q=0.7, maxk=200,
          noise=0.02, seed_noise=1)
BOOTSTRAP = dict(shape=(20, 30, 10), samples=20, beta=0.01, maxk=200,
                 noise=0.02, seed_noise=1)
MAP = dict(step=0.5, regularization="Damping", alpha=0.05, maxk=400,
           boundary=(-0.5, 0.5), dtype=torch.float32)
SOUTHCHINA = dict(samples=20, beta=0.01, maxk=200, mratio=1.5,
                  wavelet="1D", boundary=(-1.0, 1.0), seed=2)
STAGES = ("cg", "bootstrap", "bootstrap_southchina", "map")


def southchina(seed=2):
    """``examples/run.py bootstrap-southchina``'s geometry and data
    (reference: example/bootstrap_southchina/main_BSCG_SouthChina_20km.py:
    38-56): ``mrange``, ``mspacing`` (2 km on top, 100 km cells), 17 x 17
    observations on a coastal topography (land in the NW, sea floor in the
    SE, seeded roughness), ``heights`` = the topography above sea level,
    ``dobs`` seeded Gaussian data (sigma 15) drawn after it."""
    mrange = (-750000, 950000, -820000, 880000, -3500, 50000)
    mspacing = (2000, 100000, 100000)
    rng = np.random.RandomState(seed)
    xo, yo = np.meshgrid(np.linspace(-700000, 900000, 17),
                         np.linspace(-770000, 830000, 17))
    xo, yo = xo.ravel(), yo.ravel()
    topo = (1500 - 3000 * (xo + yo + 1.5e6) / 3.2e6
            + rng.normal(0, 100, xo.size))
    heights = np.maximum(topo, 0.0)
    dobs = rng.normal(0, 15, xo.size)
    return dict(mrange=mrange, mspacing=mspacing, xo=xo, yo=yo, topo=topo,
                obs=(xo, yo, -heights), dobs=dobs)


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
    _device.sync(device)
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
    _device.sync(device)
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


def stage_bootstrap_southchina(device, cfg):
    t0 = time.perf_counter()
    g = southchina(cfg["seed"])
    bs = BootStrap(g["mrange"], g["mspacing"], g["obs"], g["dobs"],
                   cfg["boundary"], samples=cfg["samples"], beta=cfg["beta"],
                   maxk=cfg["maxk"], mratio=cfg["mratio"],
                   wavelet=cfg["wavelet"], verbose=False, device=device,
                   mtopo=(g["xo"], g["yo"], g["topo"]))
    t1 = time.perf_counter()
    models, d_h, m_h, r_h = bs.BSCG(np.zeros(bs.msize))
    _device.sync(device)
    t2 = time.perf_counter()
    n_iters = [int(np.sum(~np.isnan(row))) + 1 for row in d_h]
    awcp = bs._mod.Awcp
    line = dict(workload="bootstrap_southchina",
                mesh_shape=list(bs.mshape), carved_cells=int(bs.msize),
                samples=cfg["samples"],
                model_std_max=float(models.std(axis=0).max()),
                mean_model_max=float(models.mean(axis=0).max()),
                finite=bool(np.isfinite(models).all()),
                problem=[bs.dsize, bs.msize], n_iters=n_iters,
                wavelet=cfg["wavelet"],
                Awcp=[list(awcp.shape), int(awcp.nnz)])
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
    _device.sync(device)
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
    maps a stage name to changes of :data:`CG`, :data:`BOOTSTRAP`,
    :data:`SOUTHCHINA` or :data:`MAP`; ``map_problem`` is a realdata
    ``(module, dobs)`` for the ``map`` stage."""
    device = _device.resolve(device)
    overrides = overrides or {}
    stages = {"cg": (stage_cg, CG), "bootstrap": (stage_bootstrap,
                                                  BOOTSTRAP),
              "bootstrap_southchina": (stage_bootstrap_southchina,
                                       SOUTHCHINA),
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
    ap.add_argument("stages", nargs="*",
                    metavar="{cg,bootstrap,bootstrap_southchina,map}",
                    help="the stages to run (all four by default)")
    args = ap.parse_args(argv)
    stages = args.stages or list(STAGES)
    if not set(stages) <= set(STAGES):
        ap.error(f"choose stages from {STAGES}")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = _device.resolve(None)
    card = _device.card()
    print(card, flush=True)
    for name in stages:
        line = run((name,), device)[name][0]
        print(json.dumps({"card": card, "stage": name, **line}), flush=True)


if __name__ == "__main__":
    main()
