"""The whole-Earth tesseroid inversion on the card.

The port's counterpart of ``examples/run.py global`` (its ``cmd_global``)
with copies of ``examples/workloads.py``'s :func:`global_tess`,
:func:`forward_with_noise` and :func:`device_posterior_summary` (the
JAX package cannot be imported here; ``tests/test_torch_global.py`` holds
the copies against the originals). At ``--scale 1`` the problem is the
reference's: a 10 x 60 x 120 tesseroid mesh of 300 km shells and 3-degree
cells (72,000 cells) under 121 x 61 = 7,381 observations at 5 km, five
dense boxes in the truth.

The matrix is built on the card (``GravMagModule(kernel_device=True)``,
:func:`~.ops.tesseroid.tesseroid_kernel_device`: 2.13 GB in f32) and
weighted there; no host copy exists. Two modes, as in the JAX command:

* ``--map-only``: the bounded MAP, fixed-alpha projected CG
  (:func:`~.inversion.reginv.cg_device`, Damping, ``--cg-alpha`` 5.0 by
  default, ``--cg-maxk`` iterations, the best-objective iterate);
* otherwise HMC (:func:`~.inversion.hmc.HMCSample`, the eager path: the
  fused kernels need a host matrix): a CG warm start (``--cg-alpha``
  fixed, or None for the reference's adaptive schedule, ``--no-cg`` to
  start from the flat 0.001 model), the windowed warmup (dual-averaged
  dt and the Welford diagonal metric, ``--adapt-chunks`` at least 20),
  chain-mode storage (``--store-thin``), Damping at ``RegulFactor`` 0.05;
  ``--honest`` samples the calibrated posterior instead (the logistic box
  transform with its Jacobian, likelihood temperature 2 sigma^2,
  ``RegulFactor`` 5.0).

The synthetic data: the JAX command forwards the truth through the whole
f64 host matrix. The truth is zero outside its five boxes, so here the
native engine builds only the columns of the nonzero cells (each entry
of the engine is computed on its own, so they are the full matrix's
columns bit for bit) and the forward sums over them; only the order of
the summation differs (``forward_s`` in the line).

``python -m gravinv3dhmc_tpu_torch.global_tess [--scale 1.0] [--map-only]
...`` prints the card's name and power limit, then one JSON line with the
JAX command's keys (``RMSD``, ``RMSM``, ``posterior_truth_corr``,
``coverage_2std``, ``ess_median``, ``ess_frozen_floor``,
``ess_degenerate``, ``kernel_build_device_s``, ``weighting_device_s``,
``nearfield_pairs``, ``grad_evals_per_s``, ``accept_ratio``,
``step_size``, ``variance_explained``, ``cg``) plus the build's stages
and backends. It runs on ``cuda:0`` and fails without a card.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from . import _device, mesher, utils
from .diagnostics import ess_torch, median
from .inversion import hmc
from .inversion.potential import GravMagModule, logistic_to_mw
from .inversion.reginv import cg_device
from .ops import tesseroid


def global_tess(scale=1.0):
    """Whole-Earth tesseroid inversion, the workload that OOM-killed the
    reference (reference: example/global/model_global.py:47-82,
    example/global/logout_T1.txt). ``scale`` < 1 coarsens the mesh for
    quick runs; scale=1 is the full 120x60x10 = 72000-cell problem.
    """
    dlon = dlat = 3 / scale
    nlon, nlat, nr = int(120 * scale), int(60 * scale), 10
    dr = -300000
    mrange = (-180, 180, -90, 90, 0, nr * dr)
    mesh = mesher.TesseroidMesh(mrange, (dr, dlat, dlon))
    assert mesh.shape == (nr, nlat, nlon)
    rho3 = np.zeros(mesh.shape)

    def sbox(iz, iy, ix, value):
        s = scale
        rho3[iz[0]: iz[1] + 1,
             int(iy[0] * s): int(iy[1] * s) + 1,
             int(ix[0] * s): int(ix[1] * s) + 1] = value

    sbox((2, 6), (25, 40), (25, 40), 0.8)
    sbox((2, 6), (10, 20), (60, 70), 0.4)
    sbox((2, 5), (45, 50), (60, 90), 0.6)
    sbox((2, 4), (30, 35), (70, 80), 0.5)
    sbox((2, 4), (25, 30), (90, 100), 0.5)
    rho = rho3.ravel()
    mesh.addprop("density", rho)
    lons, lats, heights = utils.regular((-180, 180, -90, 90),
                                        (nlon + 1, nlat + 1), z=5000.0)
    return dict(mrange=mrange, mspacing=(dr, dlat, dlon), mesh=mesh,
                rho=rho, obs=(lons, lats, heights),
                mesh_kwargs=dict(coordinate="spherical"),
                rhomin=0.0, rhomax=0.8)


def forward_with_noise(wl, noise=0.02, seed=1):
    """The synthetic truth's gz plus seeded noise: ``(dpre, dobs)``. The
    native engine builds the f64 columns of the truth's nonzero cells
    only; ``wl["forward_s"]`` is the build and product's wall time and
    ``wl["forward_backend"]`` the builder that ran."""
    t0 = time.perf_counter()
    mesh = wl["mesh"]
    rho = np.asarray(wl["rho"], np.float64)[mesh.active]
    nz = np.flatnonzero(rho)
    cells = np.asarray(mesh.cell_bounds(only_active=True), np.float64)
    info = {}
    K = tesseroid.tesseroid_kernel_matrix("gz", *wl["obs"], cells[nz],
                                          info=info)
    dpre = K @ rho[nz]
    wl["forward_s"] = time.perf_counter() - t0
    wl["forward_backend"] = info["tess_backend"]
    dobs = utils.contaminate(dpre, noise * np.abs(dpre).max(), seed=seed)
    return dpre, dobs


def device_posterior_summary(module, stats, dobs, truth=None, sub=128):
    """Posterior statistics from the sampler's buffers on the card
    (``stats["samples"]``, (C, nsamples, M) in reference units): mean and
    std, RMSD (mean-removed, the misfit convention the inversion targets),
    RMSM, correlation, 2-std coverage and amplitude ratio against
    ``truth``, the median ESS over ``sub`` cells and the estimator's
    degenerate floor at this (C, N) (``ess_frozen_floor``: bitwise-frozen
    chains give it; ``ess_degenerate`` flags an ESS below 1.25 times
    it). Returns ``(out, mean)``; only scalars reach the host."""
    buf = stats["samples"]
    n_common = int(min(stats["n_stored"].min(), buf.shape[1]))
    out = {"n_common": n_common}
    if n_common == 0:
        out.update(RMSD=float("nan"), mean_model_max=float("nan"),
                   std_model_max=float("nan"))
        if truth is not None:
            out.update(RMSM=float("nan"),
                       posterior_truth_corr=float("nan"))
        return out, None
    sl = buf[:, :n_common]
    mean_m = sl.mean(dim=(0, 1))
    std_m = sl.std(dim=(0, 1), correction=0)
    dtype, dev = mean_m.dtype, mean_m.device
    wdiag = torch.as_tensor(module.wdiag, dtype=dtype, device=dev)
    dpre = module.predict(mean_m * wdiag)
    dobs_d = torch.as_tensor(dobs, dtype=dtype, device=dev)
    r = (dpre - dpre.mean()) - (dobs_d - dobs_d.mean())
    out["RMSD"] = float(torch.sqrt((r ** 2).mean()))
    out["mean_model_max"] = float(mean_m.max())
    out["std_model_max"] = float(std_m.max())
    if truth is not None:
        t_d = torch.as_tensor(truth, dtype=dtype, device=dev)
        out["RMSM"] = float(torch.sqrt(((mean_m - t_d) ** 2).mean()))
        out["posterior_truth_corr"] = float(
            torch.corrcoef(torch.stack([mean_m, t_d]))[0, 1])
        out["coverage_2std"] = float(
            ((mean_m - t_d).abs() <= 2.0 * std_m).to(dtype).mean())
        out["amplitude_ratio"] = float(
            torch.sqrt((mean_m ** 2).mean() / (t_d ** 2).mean()))
    if n_common >= 8:
        idx = np.random.RandomState(0).choice(
            buf.shape[2], size=min(buf.shape[2], sub), replace=False)
        ess = ess_torch(sl[:, :, torch.as_tensor(idx, device=dev)])
        out["ess_median"] = float(median(ess))
        C = buf.shape[0]
        frozen = torch.linspace(0.0, 1.0, C, dtype=torch.float32,
                                device=dev)[:, None, None].expand(
                                    C, n_common, 4)
        floor = float(median(ess_torch(frozen)))
        out["ess_frozen_floor"] = floor
        out["ess_degenerate"] = bool(out["ess_median"] < 1.25 * floor)
    return out, mean_m


def build(scale=1.0, seed_noise=1, device=None, verbose=False):
    """``(wl, dpre, dobs, module)``: the workload, its synthetic data and
    the module whose matrix is built and weighted on ``device``."""
    wl = global_tess(scale=scale)
    dpre, dobs = forward_with_noise(wl, seed=seed_noise)
    module = GravMagModule(dobs, wl["mrange"], wl["mspacing"], wl["obs"],
                           kernel_device=True, verbose=verbose,
                           device=device, **wl["mesh_kwargs"])
    return wl, dpre, dobs, module


def _fit(module, mw, dobs):
    """The mean-removed RMS residual of ``predict(mw)`` against ``dobs``."""
    dp = module.predict(mw)
    dobs_d = torch.as_tensor(dobs, dtype=dp.dtype, device=dp.device)
    r = (dp - dp.mean()) - (dobs_d - dobs_d.mean())
    return float(torch.sqrt((r ** 2).mean()))


def bounded_map(wl, dobs, module, alpha=5.0, maxk=1600, beta=0.001):
    """``--map-only``: fixed-alpha projected CG with Damping in float32,
    its best-objective iterate. Returns ``(out, cg)``: RMSD, RMSM and the
    correlation with the truth, ``n_iters`` and ``solve_s`` (to a device
    sync), and ``cg_device``'s result."""
    _device.sync(module.device)
    t0 = time.perf_counter()
    cg = cg_device(module, dobs, (wl["rhomin"], wl["rhomax"]),
                   regularization="Damping", beta=beta, maxk=maxk,
                   dtype=torch.float32, alpha=alpha)
    _device.sync(module.device)
    solve_s = time.perf_counter() - t0
    m = cg["m"]
    truth = torch.as_tensor(wl["rho"], dtype=m.dtype, device=m.device)
    out = {
        "estimator": f"bounded MAP (projected CG, alpha={alpha}, "
                     f"maxk={maxk}, best-objective iterate)",
        "problem": [int(dobs.size), int(module.n_active)],
        "RMSD": _fit(module, cg["mw"], dobs),
        "RMSM": float(torch.sqrt(((m - truth) ** 2).mean())),
        "posterior_truth_corr": float(
            torch.corrcoef(torch.stack([m, truth]))[0, 1]),
        "n_iters": cg["n_iters"],
        "solve_s": solve_s,
    }
    return out, cg


def sample(wl, dobs, module, nsamples=500, ndraws=0, nchains=2,
           Lrange=(5, 20), RegulFactor=0.05, chunk_size=64, adapt_chunks=20,
           adapt_mass=True, store_thin=1, honest=False, noise_sigma=None,
           cg_warm_start=True, cg_maxk=200, cg_alpha=None, warm_start=None,
           seed=100, verbose=False):
    """The HMC mode (the JAX command's ``run_hmc`` with its global
    arguments): a CG warm start, ``HMCSample`` with the windowed warmup
    and chain-mode storage, then :func:`device_posterior_summary`.
    ``warm_start``, a ``cg_device`` result (the bounded MAP's), is the
    start in place of a new CG solve. ``honest`` needs the data's
    ``noise_sigma`` (the likelihood temperature is 2 noise_sigma^2).
    Returns ``(out, stats, chain_args)``; ``chain_args`` is what
    :func:`profile_post_freeze` needs to rebuild the frozen kernel."""
    if honest and not adapt_mass:
        raise ValueError("--honest requires the Welford metric warmup; "
                         "drop --no-adapt-mass")
    t0 = time.perf_counter()
    M = module.n_active
    initial = np.full(M, 0.001)
    aprior = np.full(M, 0.001)
    boundaries = np.stack([np.full(M, wl["rhomin"]),
                           np.full(M, wl["rhomax"])], axis=1)
    cg_info = None
    if warm_start is not None:
        initial = warm_start["m"]
    elif cg_warm_start:
        t_cg = time.perf_counter()
        cg = cg_device(module, dobs, (wl["rhomin"], wl["rhomax"]),
                       regularization="Damping", beta=0.01, q=0.7,
                       maxk=cg_maxk, dtype=torch.float32, alpha=cg_alpha)
        d_h = [round(float(v), 3) for v in cg["data_hist"]]
        cg_info = {
            "n_iters": cg["n_iters"],
            "elapsed_s": time.perf_counter() - t_cg,
            "RMSD": _fit(module, cg["mw"], dobs),
            "alpha": cg_alpha,
            "data_hist_head": d_h[:5],
            "data_hist_min": min(d_h),
            "data_hist_last": d_h[-1],
            "diverged": d_h[-1] > 2.0 * min(d_h),
            "regul_hist_last": float(cg["regul_hist"][-1]),
        }
        initial = cg["m"]   # (M,) on the card, and stays there
    kw = dict(constraint="logarithmic", jacobian=True,
              temperature=2.0 * noise_sigma ** 2) if honest else dict(
                  constraint="mandatory")
    chain_args = dict(nchains=nchains, chunk_size=chunk_size,
                      Lrange=list(Lrange), Sigma=0.001,
                      RegulFactor=RegulFactor, regularization="Damping",
                      beta=0.01, boundaries=boundaries, aprior=aprior,
                      log_factor=1000.0, seed=seed, **kw)
    stats = hmc.HMCSample(
        module, nsamples, ndraws, 0.005, list(Lrange), initial, aprior,
        boundaries, kw["constraint"], 1000.0, dobs,
        RegulFactor=RegulFactor, regularization="Damping", beta=0.01,
        seed=seed, Sigma=0.001, nchains=nchains, chunk_size=chunk_size,
        verbose=verbose, write_files=False, adapt_step_size=True,
        adapt_mass=adapt_mass, adapt_chunks=adapt_chunks,
        transfer_samples=False, store_mode="chain", store_thin=store_thin,
        jacobian=kw.get("jacobian", False),
        temperature=kw.get("temperature", 1.0), device=module.device)
    out, _ = device_posterior_summary(module, stats, dobs,
                                      truth=wl.get("rho"))
    out.update(sampler="hmc", total_s=time.perf_counter() - t0,
               sampling_s=stats["elapsed_s"],
               grad_evals_per_s=stats["grad_evals_per_s"],
               accept_ratio=stats["accept_ratio"],
               step_size=stats["step_size"],
               adapted_mass=stats["adapted_mass"],
               fused_mode=stats["fused_mode"])
    if cg_info:
        out["cg"] = cg_info
    if out.get("ess_median") is not None:
        out["ess_per_s_median"] = (out["ess_median"]
                                   / max(stats["elapsed_s"], 1e-9))
    return out, stats, chain_args


def profile_post_freeze(module, dobs, stats, chain_args, chunk_idx=1):
    """One chunk of the frozen kernel (``stats``' step size and metric)
    from the chains' final state, under ``torch.profiler`` after a warm
    chunk (:func:`~.uniformgrid.profile_run`): ``(summary, profiler)``."""
    from .uniformgrid import profile_run

    a = chain_args
    chain = hmc.HamiltonianMC(module)
    for k in ("nchains", "chunk_size", "Lrange", "Sigma", "RegulFactor",
              "regularization", "beta", "constraint", "log_factor", "seed"):
        setattr(chain, k, a[k])
    chain.jacobian = a.get("jacobian", False)
    chain.temperature = a.get("temperature", 1.0)
    chain.store_mode = "chain"
    chain.dt = stats["step_size"]
    chain.device = module.device
    chain.dobs = np.asarray(dobs, np.float64)
    wdiag = module.wdiag.double()

    def mw(v):
        return wdiag * torch.as_tensor(v, dtype=torch.float64,
                                       device=wdiag.device)

    chain.low = mw(a["boundaries"][:, 0])
    chain.high = mw(a["boundaries"][:, 1])
    chain.aprior_model = mw(a["aprior"])
    x = stats["x"].double()
    if chain.constraint == "logarithmic":
        x = logistic_to_mw(x, chain.low, chain.high, chain.log_factor)
    chain.initial_model = x
    run_chunk, carry = chain.prepare(nsamples=chain.chunk_size, ndraws=0)
    inv_mass = stats["inv_mass"]

    def frozen(c, seed, idx):
        return run_chunk(c, seed, idx, inv_mass=inv_mass)

    return profile_run(frozen, carry, chain.seed, module.device, chunk_idx)


def run(args, device=None):
    """``examples/run.py global``'s ``cmd_global`` on the card: the line
    it prints, with the port's build stages."""
    t0 = time.perf_counter()
    wl, dpre, dobs, module = build(args.scale, args.seed_noise, device,
                                   verbose=not args.quiet)
    noise_sigma = float(0.02 * np.abs(dpre).max())
    build_keys = dict(
        kernel_build_device_s=module.kernel_build_s,
        weighting_device_s=module.weighting_s,
        nearfield_pairs=module.nearfield_pairs,
        mask_backend=module.mask_backend,
        pairs_backend=module.pairs_backend,
        build_seconds=module.build_seconds,
        forward_s=wl["forward_s"], forward_backend=wl["forward_backend"])
    if args.map_only:
        alpha = args.cg_alpha if args.cg_alpha is not None else 5.0
        out, _ = bounded_map(wl, dobs, module, alpha=alpha,
                             maxk=args.cg_maxk, beta=args.beta)
        out.update(workload=f"global(scale={args.scale})",
                   noise_sigma=noise_sigma, **build_keys,
                   total_s=time.perf_counter() - t0)
        return out
    out, _, _ = sample(
        wl, dobs, module, nsamples=args.nsamples, ndraws=args.ndraws,
        nchains=args.nchains, Lrange=tuple(args.Lrange),
        RegulFactor=args.RegulFactor, chunk_size=args.chunk_size,
        adapt_chunks=max(args.adapt_chunks, 20),
        adapt_mass=not args.no_adapt_mass, store_thin=args.store_thin,
        honest=args.honest, noise_sigma=noise_sigma,
        cg_warm_start=not args.no_cg,
        cg_maxk=args.cg_maxk, cg_alpha=args.cg_alpha,
        verbose=not args.quiet)
    out["workload"] = f"global(scale={args.scale})"
    out["problem"] = [int(dobs.size), int(module.n_active)]
    out["total_s"] = time.perf_counter() - t0
    dc = dobs - dobs.mean()
    out["data_rms_centered"] = float(np.sqrt((dc ** 2).mean()))
    out["noise_sigma"] = noise_sigma
    out["target"] = ("honest posterior (T=2 sigma^2, Jacobian)"
                     if args.honest else "reference Sigma-tempered")
    out["variance_explained"] = float(
        1.0 - (out["RMSD"] / out["data_rms_centered"]) ** 2) \
        if np.isfinite(out.get("RMSD", np.nan)) else None
    out.update(build_keys)
    return out


def parse_args(argv=None):
    """``examples/run.py global``'s options (its defaults)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=0.25,
                    help="global mesh scale (1.0 = full 72000 cells)")
    ap.add_argument("--nsamples", type=int, default=500)
    ap.add_argument("--ndraws", type=int, default=0)
    ap.add_argument("--nchains", type=int, default=2)
    ap.add_argument("--chunk-size", type=int, dest="chunk_size", default=64)
    ap.add_argument("--Lrange", type=int, nargs=2, default=[5, 20])
    ap.add_argument("--RegulFactor", type=float, default=None,
                    help="alpha (default 0.05; 5.0 with --honest)")
    ap.add_argument("--beta", type=float, default=0.001)
    ap.add_argument("--seed-noise", dest="seed_noise", type=int, default=1)
    ap.add_argument("--no-adapt-mass", dest="no_adapt_mass",
                    action="store_true")
    ap.add_argument("--no-cg", dest="no_cg", action="store_true")
    ap.add_argument("--cg-maxk", dest="cg_maxk", type=int, default=200)
    ap.add_argument("--cg-alpha", dest="cg_alpha", type=float, default=None)
    ap.add_argument("--map-only", dest="map_only", action="store_true")
    ap.add_argument("--honest", action="store_true")
    ap.add_argument("--store-thin", dest="store_thin", type=int, default=1)
    ap.add_argument("--adapt-chunks", dest="adapt_chunks", type=int,
                    default=10)
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    if args.RegulFactor is None:
        args.RegulFactor = 5.0 if args.honest else 0.05
    return args


def main(argv=None):
    args = parse_args(argv)
    device = _device.resolve()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(_device.card(), flush=True)
    out = run(args, device)
    out["device"] = torch.cuda.get_device_name(device)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
