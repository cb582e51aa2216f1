"""The adaptive samplers on the uniformgrid problem, on the card.

Counterpart of ``tools/samplers_tpu.py``'s ``nuts`` and ``chees`` stages
at their defaults: the bench's 600 x 6000 uniformgrid problem
(:func:`~.uniformgrid.build_problem`), the target MS with beta 0.001
under the logistic box transform (k = 1000) with its Jacobian, the box
[0, 1] and the a priori model 0.001 (times the weighting), T = 1; 8
chains, 200 draws after 200 warmup, step size 0.01 to start and NUTS
trees of depth 8 at most. R-hat and ESS are taken on the tool's 64-cell
subsample (``RandomState(0)``), in float64. ``hmc`` adds a short honest
fixed-L run through :class:`~.inversion.HamiltonianMC` on the same
problem: the logistic transform with its Jacobian at T = 2 sigma^2 (sigma
the problem's 2 % noise, as ``examples/run.py global --honest`` sets
it), Damping, windowed warmup of dt and a diagonal metric, one L a chain,
chain-mode storage, 64 chains; the fused kernels do not take this
target, so it runs on the eager path, its momenta and accept uniforms
from the ``draws`` kernel.

``realdata`` is the tool's calibrated realdata ChEES (its ``realdata``
stage with ``SAMPLERS_RD_TEMP=auto``): :func:`~.realdata.build_problem`'s
576 x 10,676 tesseroid problem, Damping (beta 0.01) at RegulFactor 0.05
toward the a priori model 0.001, the box [-0.5, 0.5] and the start 0.01
(each times the weighting; x0 clipped 1e-9 of the span inside the box,
0 where a cell has no width) under the logistic transform (k = 1000) with
its Jacobian, at the likelihood temperature T = 2 sigma_hat^2 of the
bounded MAP (the ``map`` stage of :mod:`.cg`) or a given number; 64
chains, 256 draws after 256 warmup, step size 0.01 to start, seed 100.
Its line has the tool's keys (``workload``, ``problem``,
``RegulFactor``, ``temperature``, ``mean_L``, ``max_steps_saturated``,
``trajectory_time``, ``target_note``, ``vs_baseline_ess`` and
``vs_reference_kernel_ess`` from the anchors :mod:`.bench` reads) and,
when T came from the MAP, the MAP's ``map`` summary.

``python -m gravinv3dhmc_tpu_torch.samplers [nuts] [chees] [hmc]
[realdata]`` (the first three by default) prints the card and then one
JSON line per sampler
with the tool's keys (``total_s``, ``ess_min``, ``ess_median``,
``ess_per_total_s_median``, ``rhat_max``, ``mean_accept``,
``step_size``, ``grad_evals``, ``grad_evals_per_total_s``; NUTS adds
``mean_depth`` and ``divergences``); ``--profile`` adds one line that
splits one post-freeze ChEES iteration (the adapted step and trajectory
time) between host and device (:func:`profile_chees_iteration`).
``grad_evals`` counts the sampling
phase, as the tool does: C times the sum of L for ChEES, the leaves the
trees ran for NUTS (the tool counts 2^depth - 1 a tree). ``total_s`` is
the whole run, warmup included, to a device sync. A failing sampler
fails the run. Matrix products are IEEE float32 (TF32 off).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from . import _device, realdata, uniformgrid
from .diagnostics import ess_torch, median, split_rhat
from .inversion.chees import run_chees
from .inversion.hmc import HamiltonianMC
from .inversion.nuts import _logistic_target, run_nuts
from .inversion.potential import logistic_to_mw

#: the tool's defaults
SAMPLERS = dict(nchains=8, nsamples=200, nwarmup=200, nsub=64,
                step_size0=0.01, max_depth=8, log_factor=1000.0,
                beta=0.001, seed=100)
#: the honest fixed-L HMC run (``examples/run.py``'s delta 0.005, Sigma
#: 0.001, Damping with beta 0.01; 64 chains, 8 warmup chunks of 16
#: iterations, then 64 stored iterations)
HMC = dict(nchains=64, chunk=16, adapt_chunks=8, nsamples=64, dt=0.005,
           Lrange=(5, 20), Sigma=0.001, beta=0.01, seed=100)
#: the tool's calibrated realdata ChEES (``temperature`` "auto": T = 2
#: sigma_hat^2 from the bounded MAP; a number sets T)
REALDATA = dict(nchains=64, nsamples=256, nwarmup=256, nsub=64,
                step_size0=0.01, log_factor=1000.0, alpha=0.05, beta=0.01,
                aprior=0.001, initial=0.01, box=(-0.5, 0.5), seed=100,
                temperature="auto", draws=None)
STAGES = ("nuts", "chees", "hmc", "realdata")
#: the samplers run when none is named
DEFAULT = ("nuts", "chees", "hmc")


def target(module, device, log_factor=SAMPLERS["log_factor"],
           beta=SAMPLERS["beta"]):
    """The tool's target on ``module``: ``(potential, low, high, x0)`` with
    ``potential(x) -> (U, g)`` of a chain batch and x0 (M,) in float64,
    built as ``CheesSample`` and ``NUTSSample`` build theirs."""
    M = module.n_active
    pot, low, high, x0 = _logistic_target(
        module, np.full(M, 0.001), np.full(M, 0.001),
        np.column_stack([np.zeros(M), np.ones(M)]), "MS", beta, log_factor,
        torch.float32, 1.0, device)

    def potential(x):
        U, g, _ = pot(x, 1.0)
        return U, g

    return potential, low, high, x0


def _summary(chains, elapsed, sub, **extra):
    """The tool's summary of (C, N, K) draws of the subsample ``sub``."""
    ess = ess_torch(chains[:, :, sub].double())
    med = float(median(ess))
    C, N = chains.shape[:2]
    return dict(nchains=C, nsamples=N, total_s=elapsed,
                ess_min=float(ess.min()), ess_median=med,
                ess_per_total_s_median=med / elapsed,
                rhat_max=float(split_rhat(chains[:, :, sub]).max()), **extra)


def _adaptive(name, problem, device, cfg):
    """One run of ChEES or NUTS: ``(line, tensors)``."""
    module = problem[0]
    potential, low, high, x0 = target(module, device, cfg["log_factor"],
                                      cfg["beta"])
    C, N, W = cfg["nchains"], cfg["nsamples"], cfg["nwarmup"]
    x0_b = torch.as_tensor(np.tile(x0[None, :], (C, 1)), dtype=torch.float32,
                           device=device)
    sub = torch.as_tensor(np.random.RandomState(0).choice(
        module.n_active, size=min(module.n_active, cfg["nsub"]),
        replace=False), device=device)
    _device.sync(device)
    t0 = time.perf_counter()
    if name == "chees":
        xs, st = run_chees(potential, x0_b, n_warmup=W, n_samples=N,
                           step_size0=cfg["step_size0"], seed=cfg["seed"])
        xs = xs.transpose(0, 1)
        extra = dict(mean_accept=float(st["accept"].mean()),
                     step_size=float(st["step_size"]),
                     trajectory_time=float(st["trajectory_time"]),
                     mean_L=st["mean_L"],
                     max_steps_saturated=st["max_steps_saturated"],
                     grad_evals=int(C * st["L"].sum()))
        state = dict(x=st["state"]["x"], **st["state"]["dual_averaging"],
                     **{f"adam_{k}": v for k, v in st["state"]["adam"].items()})
    else:
        xs, st = run_nuts(potential, x0_b, n_warmup=W, n_samples=N,
                          step_size0=cfg["step_size0"],
                          max_depth=cfg["max_depth"], seed=cfg["seed"])
        extra = dict(mean_accept=float(st["accept_probs"].mean()),
                     mean_depth=float(st["depths"].double().mean()),
                     divergences=int(st["divergences"].sum()),
                     grad_evals=int(st["n_leapfrog"].sum()),
                     step_size=float(st["step_size"].mean()))
        state = dict(x=st["state"]["x"], inv_mass=st["inv_mass"],
                     **st["state"]["dual_averaging"])
    _device.sync(device)
    elapsed = time.perf_counter() - t0
    lo = torch.as_tensor(low, dtype=torch.float32, device=device)
    hi = torch.as_tensor(high, dtype=torch.float32, device=device)
    mw = logistic_to_mw(xs, lo, hi, cfg["log_factor"])
    line = _summary(mw, elapsed, sub, sampler=name, nwarmup=W, **extra)
    line["grad_evals_per_total_s"] = line["grad_evals"] / elapsed
    return line, dict(samples=xs, **state)


def _hmc(problem, device, cfg, nsub):
    """The honest fixed-L run: ``(line, tensors)``."""
    module, dobs = problem
    M = module.n_active
    w = np.asarray(module.wdiag, np.float64)
    chain = HamiltonianMC(module)
    chain.device = device
    chain.dt, chain.Lrange, chain.Sigma = cfg["dt"], list(cfg["Lrange"]), \
        cfg["Sigma"]
    chain.regularization, chain.beta = "Damping", cfg["beta"]
    chain.constraint, chain.jacobian = "logarithmic", True
    chain.temperature = 2.0 * module.noise_sigma ** 2
    chain.nchains, chain.chunk_size = cfg["nchains"], cfg["chunk"]
    chain.seed = cfg["seed"]
    chain.verbose = False
    chain.use_fused = True
    chain.shared_L = False
    chain.store_mode = "chain"
    chain.adapt_step_size = chain.adapt_mass = True
    chain.adapt_chunks = cfg["adapt_chunks"]
    chain.low, chain.high = 0.0 * w, 1.0 * w
    chain.initial_model = chain.aprior_model = 0.001 * w
    chain.dobs = dobs
    _device.sync(device)
    t0 = time.perf_counter()
    res = chain.sample(cfg["nsamples"], 0)
    _device.sync(device)
    elapsed = time.perf_counter() - t0
    sub = torch.as_tensor(np.random.RandomState(0).choice(
        M, size=min(M, nsub), replace=False), device=device)
    line = _summary(res["samples"], elapsed, sub, sampler="hmc",
                     nwarmup=chain.adapt_chunks * chain.chunk_size,
                     temperature=chain.temperature,
                     mean_accept=res["accept_ratio"],
                     step_size=res["step_size"],
                     grad_evals=res["grad_evals"],
                     fused_mode=res["fused_mode"],
                     adapted_mass=res["adapted_mass"])
    line["grad_evals_per_total_s"] = res["grad_evals"] / elapsed
    return line, dict(samples=res["samples"], x=res["x"],
                      inv_mass=res["inv_mass"])


def _realdata(problem, device, cfg):
    """The calibrated realdata ChEES: ``(line, tensors)``."""
    from . import cg
    from .bench import BASELINE_REALDATA_SAMPLES_PER_S, reference_kernel

    module, dobs = problem
    M = module.n_active
    lf = cfg["log_factor"]
    extra = {}
    T = cfg["temperature"]
    if T == "auto":
        map_line, map_t, _, _, map_s = cg.stage_map(
            device, dict(cg.MAP, alpha=cfg["alpha"]), problem)
        T = map_line["temperature"]
        extra["map"] = {k: map_line[k] for k in (
            "n_iters", "RMSD", "sigma_hat2", "data_hist_min",
            "data_hist_last")}
        extra["map"]["solve_s"] = map_s
    T = float(T)
    # the tool's target and start, built as CheesSample builds them (x0
    # 1e-9 of the span inside the box; 0 where a cell has no width)
    with np.errstate(invalid="ignore", divide="ignore"):
        pot, low, high, x0 = _logistic_target(
            module, np.full(M, cfg["initial"]), np.full(M, cfg["aprior"]),
            np.tile(np.asarray(cfg["box"], np.float64), (M, 1)), "Damping",
            cfg["beta"], lf, torch.float32, T, device)
    C, N, W = cfg["nchains"], cfg["nsamples"], cfg["nwarmup"]
    x0_b = torch.as_tensor(np.tile(x0[None, :], (C, 1)), dtype=torch.float32,
                           device=device)

    def potential(x):
        U, g, _ = pot(x, cfg["alpha"])
        return U, g

    sub = torch.as_tensor(np.random.RandomState(0).choice(
        M, size=min(M, cfg["nsub"]), replace=False), device=device)
    _device.sync(device)
    t0 = time.perf_counter()
    xs, st = run_chees(potential, x0_b, n_warmup=W, n_samples=N,
                       step_size0=cfg["step_size0"], seed=cfg["seed"],
                       draws=cfg["draws"])
    _device.sync(device)
    elapsed = time.perf_counter() - t0
    lo = torch.as_tensor(low, dtype=torch.float32, device=device)[sub]
    hi = torch.as_tensor(high, dtype=torch.float32, device=device)[sub]
    mw = logistic_to_mw(xs.transpose(0, 1)[:, :, sub], lo, hi, lf)
    line = _summary(mw, elapsed, torch.arange(sub.numel(), device=device),
                    sampler="chees", workload="realdata_southchina",
                    problem=[int(np.size(dobs)), int(M)], nwarmup=W,
                    RegulFactor=cfg["alpha"], temperature=T,
                    mean_accept=float(st["accept"].mean()),
                    step_size=float(st["step_size"]),
                    trajectory_time=float(st["trajectory_time"]),
                    mean_L=st["mean_L"],
                    max_steps_saturated=st["max_steps_saturated"],
                    grad_evals=int(C * st["L"].sum()),
                    target_note=(
                        "calibrated honest posterior (T=2*sigma_hat^2)"
                        if cfg["temperature"] == "auto" else
                        "the temperature given"))
    line["grad_evals_per_total_s"] = line["grad_evals"] / elapsed
    # the tool's anchors: the reference's realdata samples/s, and that
    # times the reference kernel's recorded ESS per sample
    line["vs_baseline_ess"] = (line["ess_per_total_s_median"]
                               / BASELINE_REALDATA_SAMPLES_PER_S)
    ref = reference_kernel()
    if ref is not None:
        line["vs_reference_kernel_ess"] = (line["ess_per_total_s_median"]
                                           / ref["ref_hw_ess_per_s"])
    line.update(extra)
    tensors = dict(samples=xs, x=st["state"]["x"],
                   **st["state"]["dual_averaging"],
                   **{f"adam_{k}": v for k, v in st["state"]["adam"].items()})
    if extra:
        tensors["map_mw"] = map_t["mw"]
    return line, tensors


def run(which=DEFAULT, device=None, problem=None, hmc=None, rd=None,
        rd_problem=None, **overrides):
    """Run the samplers ``which`` on ``device`` (``cuda:0`` when None);
    returns ``{name: (line, tensors)}``: the JSON line's dict and the run's
    tensors (samples, final chain state, adaptation state). ``problem``
    is ``(module, dobs)`` (by default the 600 x 6000 problem built on
    ``device``); ``overrides`` change :data:`SAMPLERS` and ``hmc`` updates
    :data:`HMC`. ``realdata`` runs on ``rd_problem`` (by default
    :func:`~.realdata.build_problem`'s on ``device``) with :data:`REALDATA`
    updated by ``rd``."""
    device = _device.resolve(device)
    cfg = dict(SAMPLERS, **overrides)
    for name in which:
        if name not in STAGES:
            raise ValueError(f"unknown sampler {name!r}; choose from "
                             f"{STAGES}")
    if set(which) - {"realdata"}:
        problem = problem or uniformgrid.build_problem(device=device)
    out = {}
    for name in which:
        if name == "realdata":
            out[name] = _realdata(
                rd_problem or realdata.build_problem(device=device), device,
                dict(REALDATA, **(rd or {})))
        elif name == "hmc":
            out[name] = _hmc(problem, device, dict(HMC, **(hmc or {})),
                             cfg["nsub"])
        else:
            out[name] = _adaptive(name, problem, device, cfg)
    return out


def profile_chees_iteration(problem, device, step_size, trajectory_time,
                            nchains=SAMPLERS["nchains"]):
    """One frozen ChEES iteration (u = 1/2, so L = T / (2 eps) + 1) under
    ``torch.profiler`` after a warm one: its L, the host's wall time, the
    device's busy time (the union of kernel intervals) and idle share, the
    kernels launched and the device time of the largest ones."""
    from torch.profiler import ProfilerActivity, profile

    potential, _, _, x0 = target(problem[0], device)
    x = torch.as_tensor(np.tile(x0[None, :], (nchains, 1)),
                        dtype=torch.float32, device=device)
    kw = dict(n_warmup=0, n_samples=1, step_size0=step_size,
              T0=trajectory_time)
    run_chees(potential, x, **kw)
    _device.sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, st = run_chees(potential, x, **kw)
        _device.sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = uniformgrid._device_intervals(prof)
    busy_ms = uniformgrid._union_us(spans) / 1e3
    by_kernel = {}
    for name, a, b in spans:
        ms, n = by_kernel.get(name, (0.0, 0))
        by_kernel[name] = (ms + (b - a) / 1e3, n + 1)
    return {"L": int(st["L"][0]), "wall_ms": wall_ms,
            "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "kernels_launched": len(spans),
            "top_kernels": sorted(([k, ms, n] for k, (ms, n)
                                   in by_kernel.items()),
                                  key=lambda r: -r[1])[:8]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("stages", nargs="*", metavar="{nuts,chees,hmc,realdata}",
                    help="the samplers to run (nuts, chees and hmc by "
                    "default)")
    ap.add_argument("--nsamples", type=int, default=SAMPLERS["nsamples"])
    ap.add_argument("--nwarmup", type=int, default=SAMPLERS["nwarmup"])
    ap.add_argument("--profile", action="store_true",
                    help="after chees, profile one of its iterations")
    ap.add_argument("--temperature", default=REALDATA["temperature"],
                    help="realdata's likelihood temperature: 'auto' (2 "
                    "sigma_hat^2 from the bounded MAP) or a number")
    args = ap.parse_args(argv)
    stages = args.stages or list(DEFAULT)
    if not set(stages) <= set(STAGES):
        ap.error(f"choose samplers from {STAGES}")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = _device.resolve(None)
    card = _device.card()
    print(card, flush=True)
    problem = (uniformgrid.build_problem(device=device)
               if set(stages) - {"realdata"} else None)
    temperature = (args.temperature if args.temperature == "auto"
                   else float(args.temperature))
    for name in stages:
        line, _ = run((name,), device, problem, nsamples=args.nsamples,
                      nwarmup=args.nwarmup,
                      rd=dict(temperature=temperature))[name]
        print(json.dumps({"card": card, **line}), flush=True)
        if name == "chees" and args.profile:
            print(json.dumps({"card": card, "profile": "chees iteration",
                              **profile_chees_iteration(
                                  problem, device, line["step_size"],
                                  line["trajectory_time"])}), flush=True)


if __name__ == "__main__":
    main()
