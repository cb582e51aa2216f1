"""Unified example CLI: every reference workload behind one entry point,
the port of ``examples/run.py``.

    python -m gravinv3dhmc_tpu_torch.run uniformgrid [--nsamples 500 ...]
    python -m gravinv3dhmc_tpu_torch.run segmentgrid | ratiogrid | global | realdata
    python -m gravinv3dhmc_tpu_torch.run cg --model model03_twodykes
    python -m gravinv3dhmc_tpu_torch.run bootstrap | bootstrap-southchina

The same eight subcommands, flags and defaults as the JAX command, over
:mod:`.workloads`, and one JSON line with its keys. Everything runs on
``--device`` (``cuda:0`` when not given; without a card that is an error,
never a quiet fall back to the CPU, which the tests ask for with
``--device cpu``). The HMC subcommands run the eager sampler, as the JAX
command does (``HMCSample`` defaults to ``use_fused=False``): on the card
one ``draws`` launch an iteration gives its momentum and accept draws.
``--setpmts FILE --attempt N`` takes the reference-format SetPMTS line N.

``global`` is :func:`.global_tess.run` (its line adds the device
build's stages, :data:`GLOBAL_ADDED`, and the synthetic data's forward
over the truth's cells replaces the whole host matrix's build unless
``--kernel-cache`` is given, :data:`GLOBAL_DROPPED`); ``bootstrap`` and
``bootstrap-southchina`` are :mod:`.cg`'s stages, printed under the JAX
command's keys. ``--no-transfer`` keeps the realdata ChEES samples on
the device and computes the summary there.

``--multichip [N]`` runs the HMC sampler of uniformgrid, segmentgrid or
ratiogrid SPMD over the ranks of a ``torch.distributed`` group, one
process a rank, started by ``torchrun``::

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m gravinv3dhmc_tpu_torch.run uniformgrid --multichip

(:func:`.parallel.multihost.initialize` on torchrun's environment; the
mesh is :func:`.parallel.make_mesh` of the world; a bare flag means the
world size, another N exits). Each rank runs on ``--device`` or, without
it, ``cuda:{LOCAL_RANK}``. ``--dist-backend`` is ``nccl`` for one card a
rank (the default on CUDA) and ``gloo`` for ranks that share a card or run
on the CPU (``--device cpu``). Rank 0 prints the line, which has the
unsharded line's keys; the group is destroyed at exit.

:func:`main` takes an argument list, prints the line and returns its
dict, so the tests and ``chip_smoke.py`` run it in-process.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from . import _device, cg, diagnostics, global_tess, utils
from . import workloads as W
from .config import load_setpmts
from .inversion import hmc
from .inversion.potential import GravMagModule
from .inversion.reginv import cg_device

WORKLOADS = ("uniformgrid", "segmentgrid", "ratiogrid", "global", "realdata",
             "cg", "bootstrap", "bootstrap-southchina")
#: keys of the ``global`` line beyond the JAX command's: the device
#: build's stages, the CG solve's seconds and the sampler's path
GLOBAL_ADDED = {"solve_s", "kernel_build_device_s", "weighting_device_s",
                "nearfield_pairs", "mask_backend", "pairs_backend",
                "build_seconds", "forward_s", "forward_backend",
                "fused_mode"}
#: the JAX command's ``global`` key that the port's line has only with
#: ``--kernel-cache`` (without it the data come from the truth's columns,
#: ``forward_s``, and no whole host matrix is built)
GLOBAL_DROPPED = {"kernel_build_host_s"}
#: the JAX command's keys of the two bootstrap lines
BOOTSTRAP_KEYS = ("workload", "samples", "mean_model_max", "std_model_max",
                  "RMSM")
SOUTHCHINA_KEYS = ("workload", "mesh_shape", "carved_cells", "samples",
                   "model_std_max", "finite")


def spmd_mesh(args, device):
    """The (chains, model) mesh of a ``--multichip`` run over the process
    group's ranks (reference analogue: the mpiexec launcher,
    run_main.sh:16-20, but sharing one kernel matrix column-sharded
    instead of every rank rebuilding its own copy)."""
    from .parallel import make_mesh, multihost

    world = multihost.world_size()
    n = world if args.multichip < 0 else args.multichip
    if n != world:
        raise SystemExit(f"--multichip {n}: the process group has {world} "
                         "ranks (start one process a rank with torchrun)")
    mesh = make_mesh(n, devices=[device] * n)
    if not args.quiet and mesh.rank == 0:
        print(f"multichip: mesh {mesh.shape} over {n} ranks on "
              f"{device.type} ({multihost.backend_name()})", flush=True)
    if args.nchains % mesh.shape["chains"] != 0:
        raise SystemExit(
            f"--nchains {args.nchains} must tile the 'chains' mesh axis "
            f"({mesh.shape['chains']})")
    return mesh


def cmd_hmc(args, builder, device, mesh=None):
    wl = builder()
    dpre, dobs = W.forward_with_noise(wl, seed=args.seed_noise)
    module, stats, mean, std, out = W.run_hmc(
        wl, dobs, nsamples=args.nsamples, ndraws=args.ndraws,
        nchains=args.nchains, delta=args.delta, Lrange=tuple(args.Lrange),
        Sigma=args.Sigma, RegulFactor=args.RegulFactor,
        regularization=args.regularization, beta=args.beta,
        wavelet=args.wavelet, chunk_size=args.chunk_size,
        save_folder=args.save_folder, verbose=not args.quiet,
        sampler=args.sampler, nwarmup=args.nwarmup,
        temperature=args.temperature,
        adapt_step_size=args.adapt_step_size, adapt_mass=args.adapt_mass,
        adapt_chunks=args.adapt_chunks, spmd_mesh=mesh, device=device)
    out["workload"] = args.workload
    out["problem"] = [int(dobs.size), int(module.n_active)]
    return out


def cmd_global(args, device):
    """Whole-Earth inversion, the reference's OOM case
    (reference: example/global/main_global.py): :func:`.global_tess.run`,
    and with ``--out`` the JSON evidence artifact of the JAX command."""
    out = global_tess.run(args, device)
    if args.out:
        art = dict(case="global whole-Earth tesseroid gz inversion",
                   device=str(device),
                   reference_outcome="OOM-killed at ~0.6% sampling on a "
                   "72-CPU 251GB node (example/global/logout_T1.txt)",
                   D=out["problem"][0], M=out["problem"][1],
                   nchains=args.nchains, nsamples=args.nsamples)
        art.update(out)
        with open(args.out, "w") as f:
            json.dump(art, f, indent=1)
    return out


def map_temperature(module, rd, alpha):
    """The honest target's temperature T = 2 sigma_hat^2, sigma_hat^2 the
    mean square of the mean-removed residual of the bounded MAP
    (float32 projected CG, Damping at the fixed ``alpha``, 400
    iterations at most), as the JAX command takes it for real data."""
    res = cg_device(module, rd["dobs"], (rd["rhomin"], rd["rhomax"]),
                    regularization="Damping", maxk=400, dtype=torch.float32,
                    alpha=alpha)
    return 2.0 * W.mean_removed_rms(module, res["mw"], rd["dobs"]) ** 2


def cmd_realdata(args, device):
    rd = W.realdata_southchina()
    dobs = rd["dobs"]
    # segmented tesseroids carved under the topography, frozen sea cells
    module = GravMagModule(
        dobs, rd["mrange"], rd["mspacing"], rd["obs"], fixed=True,
        grav_fix=rd["grav_sea"], mseg=True, mdivisionsection=rd["division"],
        coordinate="spherical", field="gravity", wavelet=False,
        verbose=not args.quiet, mtopo=rd["topo"], device=device)
    M = module.n_active
    aprior = np.full(M, 0.001)   # the stand-in has no a priori model
    initial = utils.rho2carve(np.full(module.mesh.size, 0.01), module.mask)
    boundaries = np.stack([np.full(M, rd["rhomin"]),
                           np.full(M, rd["rhomax"])], axis=1)
    extra = {}
    if args.sampler == "hmc":
        stats = hmc.HMCSample(
            module, args.nsamples, args.ndraws, args.delta,
            list(args.Lrange), initial, aprior, boundaries, "mandatory",
            1000.0, dobs, RegulFactor=args.RegulFactor,
            regularization="Damping", beta=args.beta, seed=100,
            Sigma=args.Sigma,
            save_folder=args.save_folder or "result/SC_chain",
            nchains=args.nchains, chunk_size=args.chunk_size,
            verbose=not args.quiet,
            write_files=args.save_folder is not None,
            adapt_step_size=args.adapt_step_size,
            adapt_mass=args.adapt_mass, adapt_chunks=args.adapt_chunks,
            device=device)
        host = stats["samples"].cpu().numpy().astype(np.float64)
        chains = np.stack([host[c, : int(stats["n_stored"][c])]
                           for c in range(args.nchains)])
    else:
        # adaptive samplers on real data: the honest calibrated target at
        # T = 2 sigma_hat^2 unless --temperature is given
        temperature = (map_temperature(module, rd, args.RegulFactor)
                       if args.temperature is None else args.temperature)
        kwargs = dict(RegulFactor=args.RegulFactor,
                      regularization="Damping", beta=args.beta,
                      seed=100, step_size0=args.delta,
                      nchains=args.nchains, verbose=not args.quiet,
                      save_folder=args.save_folder,
                      temperature=temperature, device=device)
        warm = args.nwarmup if args.nwarmup is not None \
            else max(args.ndraws, 100)
        if args.sampler == "nuts":
            if args.no_transfer:
                raise SystemExit("--no-transfer on realdata currently "
                                 "pairs with --sampler chees")
            from .inversion.nuts import NUTSSample
            stats = NUTSSample(module, args.nsamples, warm, initial,
                               aprior, boundaries, dobs, **kwargs)
        else:
            from .inversion.chees import CheesSample
            stats = CheesSample(module, args.nsamples, warm, initial,
                                aprior, boundaries, dobs,
                                chunk_iters=args.chunk_size,
                                transfer_samples=not args.no_transfer,
                                **kwargs)
        if args.no_transfer:
            # statistics where the samples live, scalars only
            sl = stats["samples"]
            dstats = {"samples": sl,
                      "n_stored": np.full(args.nchains, sl.shape[1])}
            out, _ = W.device_posterior_summary(module, dstats, dobs)
            out.update(workload="realdata_southchina",
                       sampler=args.sampler,
                       problem=[int(dobs.size), int(M)],
                       total_s=stats["elapsed_s"],
                       accept_ratio=stats["mean_accept"],
                       mean_L=stats["mean_L"],
                       max_steps_saturated=stats["max_steps_saturated"],
                       temperature=temperature)
            if out.get("ess_median") is not None:
                out["ess_per_s_median"] = (
                    out["ess_median"] / max(stats["elapsed_s"], 1e-9))
            return out
        chains = stats["samples"].cpu().numpy().astype(np.float64)
        stats["grad_evals_per_s"] = (stats.get("grad_evals", 0)
                                     / max(stats["elapsed_s"], 1e-9))
        stats["accept_ratio"] = stats.get("mean_accept", float("nan"))
        extra["temperature"] = temperature
    mean, _ = diagnostics.posterior_stats(chains)
    out = diagnostics.summarize(chains, dobs=dobs,
                                dpre=module.A @ mean.cpu().numpy())
    out.update(workload="realdata_southchina", sampler=args.sampler,
               problem=[int(dobs.size), int(M)],
               total_s=stats["elapsed_s"],
               grad_evals_per_s=stats["grad_evals_per_s"],
               accept_ratio=stats["accept_ratio"], **extra)
    return out


def cmd_cg(args, device):
    wl = W.cg_model(args.model)
    dpre, dobs = W.forward_with_noise(wl, seed=args.seed_noise)
    inv3d, model_inv, data_inv, out = W.run_cg(
        wl, dobs, regularization=args.regularization, beta=args.beta,
        q=0.7, maxk=args.maxk, verbose=not args.quiet, device=device)
    out["workload"] = f"CG:{args.model}"
    return out


def cmd_bootstrap_southchina(args, device):
    """Bootstrap on a South-China-shaped coastal problem: ratio mesh +
    topography carving + with-replacement row resampling
    (reference: example/bootstrap_southchina/main_BSCG_SouthChina_20km.py:
    38-56, its data synthetic): :func:`.cg.stage_bootstrap_southchina`."""
    cfg = dict(cg.SOUTHCHINA, samples=args.samples, maxk=args.maxk)
    line = cg.stage_bootstrap_southchina(device, cfg)[0]
    return {k: line[k] for k in SOUTHCHINA_KEYS}


def cmd_bootstrap(args, device):
    """Bootstrap replicates of the uniformgrid problem:
    :func:`.cg.stage_bootstrap`."""
    cfg = dict(cg.BOOTSTRAP, samples=args.samples, maxk=args.maxk,
               seed_noise=args.seed_noise)
    line = cg.stage_bootstrap(device, cfg)[0]
    return {k: line[k] for k in BOOTSTRAP_KEYS}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("workload", choices=WORKLOADS)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; the tests pass cpu)")
    ap.add_argument("--nsamples", type=int, default=500)
    ap.add_argument("--ndraws", type=int, default=0)
    ap.add_argument("--sampler", choices=["hmc", "nuts", "chees"],
                    default="hmc",
                    help="MCMC kernel: the reference's fixed-L HMC, or the "
                         "adaptive NUTS / ChEES-HMC extensions")
    ap.add_argument("--nwarmup", type=int, default=None,
                    help="warm-up draws for nuts/chees (default: "
                         "max(ndraws, 100))")
    ap.add_argument("--nchains", type=int, default=2)
    ap.add_argument("--chunk-size", type=int, dest="chunk_size", default=64)
    ap.add_argument("--delta", type=float, default=0.01)
    ap.add_argument("--Lrange", type=int, nargs=2, default=[5, 20])
    ap.add_argument("--Sigma", type=float, default=0.001)
    ap.add_argument("--RegulFactor", type=float, default=None,
                    help="regularization weight alpha (default 1.0; the "
                         "global workload defaults to 0.05, 5.0 with "
                         "--honest)")
    ap.add_argument("--regularization", default="MS")
    ap.add_argument("--beta", type=float, default=0.001)
    ap.add_argument("--wavelet", default=False,
                    type=lambda s: s if s else False)
    ap.add_argument("--save-folder", dest="save_folder", default=None)
    ap.add_argument("--seed-noise", dest="seed_noise", type=int, default=1)
    ap.add_argument("--scale", type=float, default=0.25,
                    help="global mesh scale (1.0 = full 72000 cells)")
    ap.add_argument("--model", default="model03_twodykes",
                    help=f"cg: one of {', '.join(W.CG_MODELS)}")
    ap.add_argument("--maxk", type=int, default=200)
    ap.add_argument("--samples", type=int, default=20)
    ap.add_argument("--kernel-cache", dest="kernel_cache", default=None)
    ap.add_argument("--out", default=None,
                    help="global: write a JSON evidence artifact here")
    ap.add_argument("--host-kernel", dest="host_kernel",
                    action="store_true",
                    help="global: build the kernel on the host and move it "
                         "to the device (default: build on the device)")
    ap.add_argument("--no-adapt-mass", dest="no_adapt_mass",
                    action="store_true",
                    help="global: disable the Welford metric warmup")
    ap.add_argument("--no-cg", dest="no_cg", action="store_true",
                    help="global: skip the CG warm start (HMC then starts "
                         "from the flat 0.001 model)")
    ap.add_argument("--cg-maxk", dest="cg_maxk", type=int, default=200,
                    help="global: CG warm-start iteration budget")
    ap.add_argument("--cg-alpha", dest="cg_alpha", type=float,
                    default=None,
                    help="global: fixed regularization weight of the CG "
                         "warm start (default: the reference's adaptive "
                         "schedule)")
    ap.add_argument("--map-only", dest="map_only", action="store_true",
                    help="global: skip sampling and report the bounded "
                         "MAP (fixed-alpha projected CG, best-objective "
                         "iterate; --cg-alpha defaults to 5.0)")
    ap.add_argument("--honest", action="store_true",
                    help="global: sample the calibrated posterior "
                         "(likelihood temperature 2*sigma^2, logistic box "
                         "transform with Jacobian)")
    ap.add_argument("--store-thin", dest="store_thin", type=int, default=1,
                    help="global: chain-store thinning stride")
    ap.add_argument("--multichip", type=int, nargs="?", const=-1,
                    default=0, metavar="N",
                    help="run the HMC sampler SPMD over the N ranks of a "
                         "torch.distributed group (bare flag = the world "
                         "size; start the ranks with torchrun): kernel "
                         "columns shard over 'model', the chain batch "
                         "over 'chains'")
    ap.add_argument("--dist-backend", dest="dist_backend",
                    choices=["nccl", "gloo"], default=None,
                    help="--multichip's torch.distributed backend (default "
                         "nccl on CUDA, gloo on the CPU; gloo when ranks "
                         "share one card)")
    ap.add_argument("--no-transfer", dest="no_transfer",
                    action="store_true",
                    help="realdata: keep the ChEES samples on the device "
                         "and compute the posterior summary there")
    ap.add_argument("--setpmts", default=None,
                    help="reference-format SetPMTS.txt (JSON lines)")
    ap.add_argument("--attempt", type=int, default=0,
                    help="line index into --setpmts (the reference's CLI "
                         "integer, main_uniform.py:105)")
    ap.add_argument("--temperature", type=float, default=None,
                    help="adaptive-sampler target exp(-U/T): 1.0 = the "
                         "proper Bayesian posterior (default)")
    ap.add_argument("--adapt-step-size", dest="adapt_step_size",
                    action="store_true",
                    help="dual-averaging warmup for the fixed-L HMC "
                         "sampler")
    ap.add_argument("--adapt-mass", dest="adapt_mass",
                    action="store_true",
                    help="windowed warmup: Welford diagonal metric + dt "
                         "re-tuning for the fixed-L HMC sampler")
    ap.add_argument("--adapt-chunks", dest="adapt_chunks", type=int,
                    default=10, help="warmup length in sampler chunks")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    if args.setpmts:
        cfg = load_setpmts(args.setpmts)[args.attempt]
        args.nsamples = cfg.nsamples
        args.Lrange = list(cfg.Lrange)
        args.delta = cfg.delta
        args.Sigma = cfg.Sigma
        args.RegulFactor = cfg.RegulFactor
        args.regularization = cfg.regularization
        args.beta = cfg.beta
    if args.RegulFactor is None:
        if args.workload == "global":
            args.RegulFactor = 5.0 if args.honest else 0.05
        else:
            args.RegulFactor = 1.0
    return args


def run(argv=None):
    """Parse ``argv``, run the subcommand on its device and return the
    dict its JSON line holds."""
    args = parse_args(argv)
    builders = {"uniformgrid": W.uniformgrid, "segmentgrid": W.segmentgrid,
                "ratiogrid": W.ratiogrid}
    if args.multichip:
        if args.workload not in builders:
            raise SystemExit("--multichip drives the Cartesian HMC "
                             "workloads (uniformgrid/segmentgrid/"
                             "ratiogrid); the global workload's kernel is "
                             "device-built per chip")
        return run_multichip(args, builders[args.workload])
    device = _device.resolve(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    if args.workload in builders:
        return cmd_hmc(args, builders[args.workload], device)
    return {"global": cmd_global, "realdata": cmd_realdata, "cg": cmd_cg,
            "bootstrap": cmd_bootstrap,
            "bootstrap-southchina": cmd_bootstrap_southchina}[
                args.workload](args, device)


def run_multichip(args, builder):
    """A ``--multichip`` run: join (or keep) the process group, build the
    mesh, run the HMC subcommand SPMD; rank 0's line, None on the other
    ranks. The group this call made is destroyed at its end."""
    import torch.distributed as dist

    from .parallel import multihost

    made = not dist.is_initialized()
    info = multihost.initialize(backend=args.dist_backend,
                                device=args.device)
    try:
        device = torch.device(info["device"])
        if device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
        mesh = spmd_mesh(args, device)
        out = cmd_hmc(args, builder, device, mesh)
        return out if mesh.rank == 0 else None
    finally:
        if made:
            dist.destroy_process_group()


def main(argv=None):
    """Run ``argv`` (the command line when None), print its JSON line and
    return its dict (under ``--multichip``, on rank 0 only: the other
    ranks print nothing and return None)."""
    out = run(argv)
    if out is not None:
        print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
