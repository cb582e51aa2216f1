"""The ratiogrid slice: the reference's dyke-complex example on a
geometric-ratio mesh (``examples/workloads.py`` ``ratiogrid`` and
``forward_with_noise``), its matrix built in f32 on the device by the
``gz_nodes`` kernel (``ops.prism_gz``), sampled through the per-step
fused op with the JAX bench's per-step settings
(``gravinv3dhmc_tpu/bench.py``, its ``per-step`` stage), and a profile of
it.

``python -m gravinv3dhmc_tpu_torch.ratiogrid`` (on a machine with a GPU)
builds the 900 x 17,100 problem, samples it with 1024 chains a few times
with different seeds, printing grad-evals/s per run, then runs one chunk
under ``torch.profiler`` (device busy time and time by kernel). One JSON
object per line; ``--out FILE`` also writes the profiler's table there.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from . import _device, mesher, utils
from .inversion.hmc import make_chunk_sampler
from .inversion.potential import GravMagModule
from .ops import leapfrog, prism
from .uniformgrid import profile_run

#: the bench's per-step sampler settings at full width: MS, alpha 1,
#: bf16 matrix, store_mode 'chain'
SLICE = dict(nchains=1024, chunk=64, nsamples=64, ndraws=0, dt=0.01,
             Lrange=(5, 20), Sigma=0.001, beta=0.001)
#: geometric growth of the cell thickness with depth
RATIO = 1.05
#: the dykes' density contrast, also the upper bound of the model
RHO = 0.4


def density_model(shape):
    """The workload's dyke complex on a (nz, ny, nx) mesh: a vertical
    dyke and three bars of density 0.4, exactly as ``examples/
    workloads.py`` sets them at 19 x 30 x 30 (boxes past a smaller mesh's
    edge are cut by it)."""
    nz = shape[0]
    rho = np.zeros(shape)
    for (z0, z1), (y0, y1), (x0, x1) in (
            ((2, min(15, nz - 1)), (10, 11), (5, 25)),
            ((3, min(16, nz - 1)), (12, 21), (23, 25)),
            ((5, min(9, nz - 1)), (12, 21), (14, 16)),
            ((3, min(16, nz - 1)), (12, 21), (5, 7))):
        rho[z0:z1 + 1, y0:y1 + 1, x0:x1 + 1] = RHO
    return rho


def mesh_and_obs(n=30, spacing=200.0):
    """``(mesh, (xo, yo, zo))``: a cube of n * spacing metres cut into n x
    n columns of ratio-1.05 prisms and n x n observation points at z = 0
    over it; the default is ratiogrid's 19 x 30 x 30 mesh and 900
    points."""
    d = float(spacing)
    bounds = (0, n * d, 0, n * d, 0, n * d)
    mesh = mesher.PrismMesh(bounds, (d, d, d), RATIO)
    _, ny, nx = mesh.shape
    return mesh, utils.regular(bounds[:4], (nx, ny), z=0.0)


def build_problem(device=None, kernel_backend="pallas", n=30, spacing=200.0):
    """``(module, dobs, seconds)``: :func:`mesh_and_obs`'s problem; the
    default is ratiogrid's 900 x 17,100 problem. Data come from the f64
    host builder with 2 % noise (seed 1); the module's own matrix from
    ``kernel_backend`` on ``device`` (``cuda:0`` when None). ``seconds``
    holds the wall times of the f64 host forward (which builds the whole
    f64 matrix) and of the module's matrix build (``kernel_build_s``),
    and that build's parts (``GravMagModule.build_seconds``): on a GPU
    the gz kernel's device time ``gz_kernel_s``, then the copy to the
    host ``to_host_s`` and the weighting ``weighting_s``."""
    d = float(spacing)
    mesh, (xo, yo, zo) = mesh_and_obs(n, spacing)
    bounds = mesh.bounds
    mesh.addprop("density", density_model(mesh.shape).ravel())
    t0 = time.perf_counter()
    dpre, _ = prism.gz(xo, yo, zo, mesh)
    host_s = time.perf_counter() - t0
    dobs = utils.contaminate(dpre, 0.02 * np.abs(dpre).max(), seed=1)
    module = GravMagModule(dobs, bounds, (d, d, d), (xo, yo, zo),
                           mratio=RATIO, kernel_backend=kernel_backend,
                           verbose=False, device=device)
    return module, dobs, {"host_f64_s": host_s,
                          "kernel_build_s": module.kernel_build_s,
                          **module.build_seconds}


def step_sampler(module, dobs, device, draws=None, matvec=torch.bfloat16,
                 **overrides):
    """``(run_chunk, carry, cfg)``: the per-step chunk runner at the
    :data:`SLICE` settings (``overrides`` replace any of them) and its
    carry, as the JAX bench builds them: bounds [0, 0.4] and a priori
    0.001 in reference units, chains started at 0.001, the carry's (U, g)
    from the f32 potential while the op steps on the ``matvec`` (bf16)
    matrix."""
    cfg = dict(SLICE, **overrides)
    device = torch.device(device)
    M = module.n_active
    w = module.wdiag
    aprior, low, high = (w * np.full(M, 0.001), w * np.zeros(M),
                         w * np.full(M, RHO))
    pot = module.make_potential(aprior, low, high, constraint="mandatory",
                                regularization="MS", beta=cfg["beta"],
                                dtype=torch.float32, device=device)
    fstep = leapfrog.make_fused_step(
        module.Aw, dobs - dobs.mean(), None, aprior, w * w, low, high,
        regularization="MS", beta=cfg["beta"], matvec_dtype=matvec,
        device=device)
    C, nsamples = cfg["nchains"], cfg["nsamples"]
    run_chunk = make_chunk_sampler(
        pot, dt=cfg["dt"], Lmin=cfg["Lrange"][0], Lmax=cfg["Lrange"][1],
        Sigma=cfg["Sigma"], low=low, high=high, constraint="mandatory",
        alpha=1.0, chunk_size=cfg["chunk"], nsamples=nsamples,
        ndraws=cfg["ndraws"], wdiag_inv=module.wdiag_inv,
        data_size=dobs.size, dtype=torch.float32, shared_L=True,
        fused_step=fstep, store_mode="chain", draws=draws, device=device)
    w_t = torch.as_tensor(np.asarray(w), dtype=torch.float32, device=device)
    x = (0.001 * w_t).expand(C, M).contiguous()
    U, g, (_, ud, um) = pot(x, 1.0)
    carry = (x, U, g, ud, um,
             torch.zeros(C, dtype=torch.int32, device=device),
             torch.zeros((C, nsamples, M), device=device),
             torch.zeros((C, nsamples, 7), device=device))
    return run_chunk, carry, cfg


def run_chunks(run_chunk, carry, seed, n_chunks, device):
    """A warm chunk 0, then chunks 1..n_chunks timed on the host clock to a
    device sync: grad-evals/s, accept ratio, the median ESS of the last
    chunk's stored samples (128-cell subsample) and whether the state and
    stats stayed finite."""
    from .diagnostics import ess_torch, median

    device = torch.device(device)
    carry, _ = run_chunk(carry, seed, 0)
    _device.sync(device)
    grad_evals = accepts = 0.0
    attempted = 0
    finite = torch.ones((), dtype=torch.bool, device=device)
    t0 = time.perf_counter()
    for i in range(1, n_chunks + 1):
        carry, stats = run_chunk(carry, seed, i)
        grad_evals = grad_evals + stats[..., 4].sum(dtype=torch.float64)
        accepts = accepts + stats[..., 0].sum(dtype=torch.float64)
        finite = finite & torch.isfinite(stats).all()
        attempted += stats.shape[0] * stats.shape[1]
    _device.sync(device)
    elapsed = time.perf_counter() - t0
    finite = bool(finite & torch.isfinite(carry[0]).all()
                  & torch.isfinite(carry[6]).all())
    M = carry[0].shape[1]
    sub = np.random.RandomState(0).choice(M, size=min(M, 128), replace=False)
    ess = ess_torch(carry[6][:, :, torch.as_tensor(sub, device=device)])
    grad_evals = float(grad_evals)
    return {"iterations": attempted // carry[0].shape[0],
            "grad_evals": grad_evals, "elapsed_s": elapsed,
            "grad_evals_per_s": grad_evals / max(elapsed, 1e-9),
            "accept_ratio": float(accepts) / max(attempted, 1),
            "ess_median": float(median(ess)), "finite": finite,
            "samples_shape": list(carry[6].shape)}, carry


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=3,
                    help="slice runs, seeds 0..repeats-1")
    ap.add_argument("--chunks", type=int, default=4,
                    help="timed chunks per run, after a warm chunk")
    ap.add_argument("--profile-chunk", type=int, default=16,
                    help="iterations in the profiled chunk")
    ap.add_argument("--out", help="write the profiler's table here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ratiogrid profile: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), flush=True)
    module, dobs, seconds = build_problem(device=dev)
    print(json.dumps({"problem": [int(dobs.size), module.n_active],
                      **seconds}), flush=True)
    for seed in range(args.repeats):
        run_chunk, carry, _ = step_sampler(module, dobs, dev)
        res, _ = run_chunks(run_chunk, carry, seed, args.chunks, dev)
        print(json.dumps({"seed": seed, **res}), flush=True)
    run_chunk, carry, _ = step_sampler(module, dobs, dev,
                                       chunk=args.profile_chunk)
    summary, prof = profile_run(run_chunk, carry, 0, dev)
    print(json.dumps({"profile": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=25))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
