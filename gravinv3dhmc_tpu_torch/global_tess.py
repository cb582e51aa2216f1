"""The whole-Earth tesseroid inversion on the card.

The port's counterpart of ``examples/run.py global`` (its ``cmd_global``)
on :mod:`.workloads`' :func:`~.workloads.global_tess`,
:func:`~.workloads.forward_with_noise` and
:func:`~.workloads.device_posterior_summary`
(``tests/test_torch_global.py`` holds them against
``examples/workloads.py``'s). At ``--scale 1`` the problem is the
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
import os
import time

import numpy as np
import torch

from . import _device
from .inversion import hmc
from .inversion.potential import GravMagModule, logistic_to_mw
from .inversion.reginv import cg_device
from . import workloads
from .workloads import (device_posterior_summary, forward_with_noise,
                        global_tess, mean_removed_rms)


def build(scale=1.0, seed_noise=1, device=None, verbose=False,
          kernel_cache=None, host_kernel=False):
    """``(wl, dpre, dobs, module)``: the workload, its synthetic data and
    the module whose matrix is built and weighted on ``device``
    (``host_kernel``: built on the host and moved there). A
    ``kernel_cache`` path seeds the data (:func:`~.workloads.
    forward_with_noise`: the whole f64 host matrix, built and saved there
    when missing); the device build stands on its own and is not given
    it, as in the JAX command."""
    wl = global_tess(scale=scale)
    dpre, dobs = forward_with_noise(wl, seed=seed_noise,
                                    kernel_cache=kernel_cache)
    module = GravMagModule(dobs, wl["mrange"], wl["mspacing"], wl["obs"],
                           kernel_device=not host_kernel, verbose=verbose,
                           kernel_cache=kernel_cache if host_kernel else None,
                           device=device, **wl["mesh_kwargs"])
    return wl, dpre, dobs, module


def device_vs_host(module, kernel_cache, n=2000):
    """The largest gap of ``n`` sampled entries of the device-built
    weighted matrix against the f64 host cache's, relative to the
    largest host entry (``examples/run.py global``'s independent check)."""
    K_host = np.load(kernel_cache, mmap_mode="r")
    rng = np.random.RandomState(0)
    si = rng.randint(0, K_host.shape[0], n)
    sj = rng.randint(0, K_host.shape[1], n)
    Aw = module.device_arrays()["Aw"]
    dev_vals = Aw[torch.as_tensor(si, device=Aw.device),
                  torch.as_tensor(sj, device=Aw.device)]
    dev_vals = dev_vals.cpu().numpy().astype(np.float64)
    wdiag_inv = torch.as_tensor(module.wdiag_inv).cpu().numpy()
    host_vals = np.asarray(K_host[si, sj], np.float64) * wdiag_inv[sj]
    return float(np.abs(dev_vals - host_vals).max()
                 / max(np.abs(host_vals).max(), 1e-30))


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
        "RMSD": mean_removed_rms(module, cg["mw"], dobs),
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
        # (M,) on the card, and it stays there
        initial, cg_info = workloads.cg_start(
            module, wl, dobs, "Damping", 0.01, cg_maxk, cg_alpha)
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
    chunk (:func:`~.profiling.profile_run`): ``(summary, profiler)``."""
    from .profiling import profile_run

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
    kernel_cache, host_kernel = args.kernel_cache, args.host_kernel
    wl, dpre, dobs, module = build(args.scale, args.seed_noise, device,
                                   verbose=not args.quiet,
                                   kernel_cache=kernel_cache,
                                   host_kernel=host_kernel)
    noise_sigma = float(0.02 * np.abs(dpre).max())
    build_keys = dict(
        kernel_build_device_s=module.kernel_build_s,
        weighting_device_s=getattr(module, "weighting_s", None),
        nearfield_pairs=getattr(module, "nearfield_pairs", None),
        mask_backend=getattr(module, "mask_backend", None),
        pairs_backend=getattr(module, "pairs_backend", None),
        build_seconds=module.build_seconds)
    build_keys.update({k: wl[k] for k in ("forward_s", "forward_backend",
                                          "kernel_build_host_s")
                       if k in wl})
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
    if not host_kernel and kernel_cache and os.path.exists(kernel_cache):
        out["device_vs_host_max_rel_err"] = device_vs_host(module,
                                                           kernel_cache)
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
    ap.add_argument("--kernel-cache", dest="kernel_cache", default=None)
    ap.add_argument("--host-kernel", dest="host_kernel", action="store_true")
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
