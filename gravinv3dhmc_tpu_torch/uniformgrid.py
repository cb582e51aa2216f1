"""The uniformgrid slice: the JAX bench's flagship problem and sampler
settings (``gravinv3dhmc_tpu/bench.py`` ``build_problem`` and its
uniformgrid stage), rebuilt from this package's own layers, and a profile
of it.

``python -m gravinv3dhmc_tpu_torch.uniformgrid`` (on a machine with a
GPU) samples the 600 x 6000 problem with 1024 chains a few times with
different seeds, printing grad-evals/s per run, then runs one chunk under
``torch.profiler``: device busy time (the union of kernel intervals)
against the host's wall time, and device time by kernel. One JSON object
per line; ``--out FILE`` also writes the profiler's table there.
``--matvec float32`` runs the fused iteration on an f32 matrix (the JAX
bench's ``BENCH_MATVEC_DTYPE=float32``) instead of the default bf16.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from . import _device, mesher, utils
from .inversion.hmc import HamiltonianMC
from .inversion.potential import GravMagModule
from .ops import leapfrog
from .ops import prism

#: the bench's uniformgrid sampler settings at full width
SLICE = dict(nchains=1024, chunk=128, nsamples=64, ndraws=256, dt=0.01,
             Lrange=(5, 20), Sigma=0.001, beta=0.001)


def density_model(nx, ny, nz):
    """The bench's unit-density block, (nz, ny, nx); at 20 x 30 x 10 it is
    ``rho[2:5, 10:18, 7:11]`` exactly as ``bench.py`` sets it."""
    rho = np.zeros((nz, ny, nx))
    rho[nz // 5:nz // 2, ny // 3:(3 * ny) // 5,
        (7 * nx) // 20:(11 * nx) // 20] = 1.0
    return rho


def build_problem(nx=20, ny=30, nz=10, spacing=100.0, device=None):
    """``(module, dobs)``: nx * ny observations at z = 0 over nx * ny * nz
    prisms of ``spacing`` metres, data from the f64 prism builder with 2 %
    noise (seed 1), the module on ``device`` (``cuda:0`` when None). The
    default is the bench's 600 x 6000 problem. The noise's standard
    deviation is ``module.noise_sigma``."""
    d = spacing
    bounds = (0, nx * d, 0, ny * d, 0, nz * d)
    mesh = mesher.PrismMesh(bounds, (d, d, d))
    mesh.addprop("density", density_model(nx, ny, nz).ravel())
    xo, yo, zo = utils.regular((0, nx * d, 0, ny * d), (nx, ny), z=0.0)
    gz_pre, _ = prism.gz(xo, yo, zo, mesh)
    dobs = utils.contaminate(gz_pre, 0.02 * gz_pre.max(), seed=1)
    module = GravMagModule(dobs, bounds, (d, d, d), (xo, yo, zo),
                           verbose=False, device=device)
    module.noise_sigma = 0.02 * float(gz_pre.max())
    return module, dobs


def sampler(module, dobs, device, nchains, chunk, dt, Lrange, Sigma, beta,
            matvec, seed=0, initial=0.001):
    """A fixed-dt ``HamiltonianMC`` on the fused kernels with the bench's
    run semantics: shared L, MS regularization, ``store_mode='chain'``,
    bounds [0, 1] and a priori 0.001 in reference units."""
    M = module.n_active
    w = module.wdiag
    chain = HamiltonianMC(module)
    chain.device = device
    chain.dt, chain.Lrange, chain.Sigma = dt, list(Lrange), Sigma
    chain.regularization, chain.beta = "MS", beta
    chain.RegulFactor = 1.0
    chain.nchains, chain.chunk_size = nchains, chunk
    chain.seed = seed
    chain.verbose = False
    chain.use_fused = True
    chain.shared_L = True
    chain.store_mode = "chain"
    chain.fused_matvec_dtype = matvec
    chain.low, chain.high = w * np.zeros(M), w * np.ones(M)
    chain.initial_model = w * np.full(M, initial)
    chain.aprior_model = w * np.full(M, 0.001)
    chain.dobs = dobs
    return chain


def slice_sampler(module, dobs, device, seed=0, matvec=torch.bfloat16,
                  **overrides):
    """:func:`sampler` at the :data:`SLICE` settings, a bf16 matrix unless
    ``matvec`` says otherwise."""
    cfg = dict(SLICE, **overrides)
    return sampler(module, dobs, device, cfg["nchains"], cfg["chunk"],
                   cfg["dt"], cfg["Lrange"], cfg["Sigma"], cfg["beta"],
                   matvec, seed=seed)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _device_intervals(prof):
    """(name, start_us, end_us) of every kernel or copy the profiler saw
    on a GPU."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == cuda]


def _union_us(intervals):
    busy, end = 0.0, -np.inf
    for _, a, b in sorted(intervals, key=lambda t: t[1]):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def profile_chunk(chain, chunk_idx=1):
    """One chunk of ``chain`` under ``torch.profiler`` after a warm chunk:
    host wall time, device busy time and device time by kernel."""
    run_chunk, carry = chain.prepare(nsamples=chain.chunk_size, ndraws=0)
    return profile_run(run_chunk, carry, chain.seed,
                       _device.resolve(chain.device), chunk_idx)


def profile_run(run_chunk, carry, seed, device, chunk_idx=1):
    """Chunk ``chunk_idx`` of ``run_chunk`` under ``torch.profiler`` after
    a warm chunk 0: ``(summary, profiler)`` with the host wall time, the
    device busy time, device time by kernel and the wrappers' launches."""
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    carry, _ = run_chunk(carry, seed, 0)
    _sync(device)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    leapfrog.reset_launch_counts()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        carry, stats = run_chunk(carry, seed, chunk_idx)
        _sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = leapfrog.launch_counts()
    spans = _device_intervals(prof)
    by_kernel = {}
    for name, a, b in spans:
        ms, n = by_kernel.get(name, (0.0, 0))
        by_kernel[name] = (ms + (b - a) / 1e3, n + 1)
    busy_ms = _union_us(spans) / 1e3 if spans else None
    # device time by owner: the port's kernels (csrc/*.cu, all in an
    # anonymous namespace), device-to-device copies, and PyTorch's own
    # kernels (the eager ops around them)
    owners = dict.fromkeys(("port", "memcpy", "torch"), 0.0)
    for name, (ms, _) in by_kernel.items():
        owners["port" if name.startswith("(anonymous namespace)::") else
               "memcpy" if name.startswith("Memcpy") else "torch"] += ms
    return {
        "iterations": stats.shape[0], "chains": stats.shape[1],
        "steps": int(stats[:, 0, 4].sum().item()),
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "busy_share": None if busy_ms is None else busy_ms / wall_ms,
        "device_ms_by_owner": owners if busy_ms else None,
        "share_of_busy_by_owner": ({k: v / busy_ms for k, v in owners.items()}
                                   if busy_ms else None),
        "launches": launches,
        "by_kernel": sorted(([k, ms, n] for k, (ms, n) in by_kernel.items()),
                            key=lambda r: -r[1]),
    }, prof


def parse_args(argv=None):
    """The command line, with ``--matvec`` as a torch dtype."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=3,
                    help="full slice runs, seeds 0..repeats-1")
    ap.add_argument("--profile-chunk", type=int, default=32,
                    help="iterations in the profiled chunk")
    ap.add_argument("--matvec", choices=("bfloat16", "float32"),
                    default="bfloat16",
                    help="storage type of the kernel matrix")
    ap.add_argument("--out", help="write the profiler's table here")
    args = ap.parse_args(argv)
    args.matvec = getattr(torch, args.matvec)
    return args


def main(argv=None):
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("uniformgrid profile: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), flush=True)
    module, dobs = build_problem(device=dev)
    rates = []
    for seed in range(args.repeats):
        res = slice_sampler(module, dobs, dev, seed=seed,
                            matvec=args.matvec).sample(SLICE["nsamples"],
                                                       SLICE["ndraws"])
        rates.append(res["grad_evals_per_s"])
        print(json.dumps({"seed": seed, "matvec": str(args.matvec),
                          "grad_evals_per_s":
                          res["grad_evals_per_s"],
                          "accept_ratio": res["accept_ratio"],
                          "elapsed_s": res["elapsed_s"],
                          "grad_evals": res["grad_evals"]}), flush=True)
    chain = slice_sampler(module, dobs, dev, matvec=args.matvec,
                          chunk=args.profile_chunk)
    summary, prof = profile_chunk(chain)
    print(json.dumps({"profile": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=25))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
