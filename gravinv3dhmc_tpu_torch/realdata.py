"""The realdata slice: the reference's South China case (spherical
tesseroids, segmented depth spacing, a topography carve and frozen
cells) with the JAX bench's realdata stage settings
(``gravinv3dhmc_tpu/bench.py``, ``build_realdata_problem`` and
``realdata_stage``), rebuilt from this package's own layers, and a
profile of it.

The published observation files are not part of the repository, so the
problem is the JAX bench's synthetic stand-in of the same geometry:
observations on a 0.5-degree grid over 106.5-118.5 E, 16-28 N at height
0, data N(0, 20) mGal and topography U(-2000, 2000) m from
``RandomState(0)``, no frozen-cell field. At the default grid that is
576 observations over a 21 x 24 x 24 tesseroid mesh (12,096 cells), of
which the carve leaves 10,676 active. The f64 matrix comes from the
native tesseroid engine on the host (:mod:`.runtime.tessglq`).

The sampler is the JAX stage's: 256 chains, chunks of 64, 768 stored
samples in ``store_mode='chain'``, Damping at RegulFactor 0.05, L in
[5, 40], dt 0.005 and Sigma 0.001 to start, and the windowed warmup
(dual-averaged dt and a diagonal metric, 12 chunks, target accept 0.75).
Its kernel path is chosen here: the fused trajectory op on an f32 matrix
(``prefer_iteration_kernel = False``, reported ``trajectory(float32)``),
the op the JAX bench lands on for this stage, so that realdata drives
the trajectory op (``refresh``, ``drift``, ``residual_f32``,
``kick_f32``, ``traj_finish``, ``accept``) and uniformgrid the iteration
op.

``python -m gravinv3dhmc_tpu_torch.realdata`` (on a machine with a GPU)
builds the problem, runs the stage's warmup
(:meth:`~.inversion.hmc.HamiltonianMC.adapt`), printing the frozen
kernel's numbers, then runs one frozen chunk from the warmed chains under
``torch.profiler``. One JSON object per line; ``--out FILE`` also writes
the profiler's table there.
"""
from __future__ import annotations

import argparse
import functools
import json
import time

import numpy as np
import torch

from . import _device
from .profiling import profile_run
from .inversion.hmc import HamiltonianMC
from .inversion.potential import GravMagModule

#: the model region (w, e, s, n, top, bottom) and its depth segments
MRANGE = (106.5, 118.5, 16, 28, 2000, -60000)
DIVISION = [2000, -5000, -15000, -60000]
DZ = [-1000, -2000, -5000]
#: the JAX bench's realdata stage settings at full width
SLICE = dict(nchains=256, chunk=64, nsamples=768, adapt_chunks=12,
             dt=0.005, Lrange=(5, 40), Sigma=0.001, RegulFactor=0.05,
             regularization="Damping", adapt_target=0.75, store_thin=1,
             matvec=torch.float32, seed=100)


def standin(step=0.5):
    """The JAX bench's synthetic stand-in of the published data, ``step``
    degrees apart (``examples/workloads.py`` ``realdata_southchina``
    without the reference's files): ``(lons, lats, heights, dobs,
    grav_sea, topo)``, observations at the cells' centres at height 0,
    data N(0, 20) mGal and topography U(-2000, 2000) m from
    ``RandomState(0)``, no frozen-cell field."""
    lons, lats = np.meshgrid(np.arange(MRANGE[0] + step / 2, MRANGE[1], step),
                             np.arange(MRANGE[2] + step / 2, MRANGE[3], step))
    lons, lats = lons.ravel(), lats.ravel()
    rng = np.random.RandomState(0)
    dobs = rng.normal(0, 20, lons.size)
    topo = rng.uniform(-2000, 2000, lons.size)
    return (lons, lats, np.full(lons.size, 0.0), dobs, np.zeros(lons.size),
            topo)


def build_problem(device=None, step=0.5, kernel_cache=None):
    """``(module, dobs)``: the JAX bench's synthetic South China problem
    (:func:`standin`), observations and mesh columns ``step`` degrees
    apart (0.5, the default, is the bench's 576 x 10,676 problem; a
    coarser step is a smaller problem of the same geometry), the module's
    tensors on ``device`` (``cuda:0`` when None); ``kernel_cache`` is the
    module's (a path the tesseroid matrix is loaded from, or saved to)."""
    lons, lats, heights, dobs, grav_sea, topo = standin(step)
    module = GravMagModule(
        dobs, MRANGE, (DZ, step, step), (lons, lats, heights), fixed=True,
        grav_fix=grav_sea, mseg=True, mdivisionsection=DIVISION,
        coordinate="spherical", field="gravity", verbose=False,
        device=device, kernel_cache=kernel_cache, mtopo=(lons, lats, topo))
    return module, np.asarray(dobs, np.float64)


def slice_sampler(module, dobs, device, **overrides):
    """The stage's ``HamiltonianMC`` at the :data:`SLICE` settings
    (``overrides`` replace any of them): the fused trajectory op on a
    ``matvec`` matrix, shared L, windowed warmup of dt and the diagonal
    metric, chain-mode storage, bounds [-0.5, 0.5], start 0.01 and a
    priori 0.001 in reference units."""
    cfg = dict(SLICE, **overrides)
    M = module.n_active
    w = np.asarray(module.wdiag)
    chain = HamiltonianMC(module)
    chain.device = device
    chain.dt = cfg["dt"]
    chain.Lrange = list(cfg["Lrange"])
    chain.Sigma = cfg["Sigma"]
    chain.seed = cfg["seed"]
    chain.RegulFactor = cfg["RegulFactor"]
    chain.regularization = cfg["regularization"]
    chain.nchains = cfg["nchains"]
    chain.chunk_size = cfg["chunk"]
    chain.verbose = False
    chain.write_files = False
    chain.shared_L = True
    chain.use_fused = True
    chain.prefer_iteration_kernel = False
    chain.fused_matvec_dtype = cfg["matvec"]
    chain.fused_per_step_ok = False
    chain.adapt_step_size = True
    chain.adapt_mass = True
    chain.adapt_target = cfg["adapt_target"]
    chain.adapt_chunks = cfg["adapt_chunks"]
    chain.store_mode = "chain"
    chain.store_thin = cfg["store_thin"]
    chain.transfer_samples = False
    chain.low = w * np.full(M, -0.5)
    chain.high = w * np.full(M, 0.5)
    chain.initial_model = w * np.full(M, 0.01)
    chain.aprior_model = w * np.full(M, 0.001)
    chain.dobs = np.asarray(dobs, np.float64)
    return chain


def trajectory_op(module, dobs, device):
    """The fused trajectory op the slice's sampler runs on ``module``'s
    matrix (f32, the slice's bounds and a priori model)."""
    fused_traj, _ = slice_sampler(module, dobs, device)._build_fused(device)
    return fused_traj


def profile_frozen_chunk(frozen, device):
    """One frozen chunk of the warmed chains under ``torch.profiler``,
    after a warm one, both as :meth:`~.inversion.hmc.HamiltonianMC.sample`
    issues them after its freeze: ``frozen`` is
    :meth:`~.inversion.hmc.HamiltonianMC.adapt`'s record (the frozen dt
    and metric, the chains' carry without the warmup's Welford moments).
    Returns :func:`~.profiling.profile_run`'s summary and profiler."""
    run_chunk = functools.partial(frozen.run_chunk, dt=frozen.dt,
                                  inv_mass=frozen.inv_mass, store_base=0)
    return profile_run(run_chunk, frozen.carry, frozen.seed,
                       _device.resolve(device), chunk_idx=frozen.n_chunks)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the profiler's table here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("realdata profile: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), flush=True)
    t0 = time.perf_counter()
    module, dobs = build_problem(device=dev)
    print(json.dumps({"problem": [int(dobs.size), module.n_active],
                      "kernel_build_s": module.kernel_build_s,
                      "tess_backend": module.tess_backend,
                      "build_s": time.perf_counter() - t0}), flush=True)
    chain = slice_sampler(module, dobs, dev)
    t0 = time.perf_counter()
    frozen = chain.adapt(chain.chunk_size, 0)
    torch.cuda.synchronize(dev)
    adapt_s = time.perf_counter() - t0
    print(json.dumps({
        "fused_mode": chain._fused_mode, "step_size": frozen.dt,
        "adapted_mass": frozen.inv_mass is not None,
        "warmup_chunks": frozen.n_chunks, "adapt_s": adapt_s,
        "adapt_grad_evals": frozen.grad_evals,
        "adapt_grad_evals_per_s": frozen.grad_evals / adapt_s}),
        flush=True)
    summary, prof = profile_frozen_chunk(frozen, dev)
    print(json.dumps({"profile": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=25))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
