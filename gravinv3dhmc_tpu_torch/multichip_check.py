"""Check the multi-device sampler on the card against the unsharded one.

One rank of a ``torch.distributed`` group, started by ``torchrun``::

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        -m gravinv3dhmc_tpu_torch.multichip_check runs --device cuda:0 \\
        --backend gloo --runs fixed,adapt,smooth --out DIR \\
        [--kernel-cache K.npy]

``runs`` samples the uniformgrid flagship (600 x 6,000, the bench's
problem, :func:`problem`) at full width with each of :data:`RUNS` (depth
cut: few, short chunks) through ``HMCSample(spmd_mesh=...)`` over the
(chains, model) mesh of the group; rank 0 writes each run's gathered
final state to ``DIR/<run>_x.npy`` and prints one JSON line a run (accept
counts, step size, a digest of the inverse mass, seconds, and the
``draws`` launches of all ranks). :func:`sample` with ``mesh=None`` is
the unsharded run the lines are held against (``chip_smoke.py``'s
``multichip`` phase runs it in its own process).

``cli -- ARGS`` runs ``gravinv3dhmc_tpu_torch.run`` with ARGS in this
process (``ARGS`` with ``--multichip``: SPMD over the group) and prints,
on rank 0, its line with the run's per-chain accept counts and the
ranks' ``draws`` launches.

Ranks that share one card need ``--backend gloo`` (NCCL refuses two
ranks of a communicator on one GPU); gloo stages the CUDA tensors of every
collective through the host, so these runs check the sharded sampler's
numbers and are no measure of its speed.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

#: the runs, each at full width (1024 chains, 600 x 6,000) and cut depth
#: (chunks of 4 iterations, 4 stored): float64, the run.py defaults
#: otherwise (MS, dt 0.01, Sigma 0.001, L in [5, 20], one L a chain);
#: "adapt" runs the windowed warmup (the shortest it takes, 8 chunks) and
#: stores by iteration ('chain' mode: one of 1024 chains that accepts
#: nothing after the freeze would otherwise hold the accept-counted run to
#: its 208-chunk limit), "smooth" the Smoothness regularizer (the z-halo
#: branch at model 2: 3,000 cells are 5 of the 10 planes of 600)
RUNS = {
    "fixed": dict(nsamples=4, chunk_size=4),
    "adapt": dict(nsamples=4, chunk_size=4, adapt_mass=True,
                  adapt_chunks=8, store_mode="chain"),
    "smooth": dict(nsamples=4, chunk_size=4, regularization="Smoothness",
                   beta=0.01),
}
NCHAINS = 1024


def problem(device, kernel_cache=None):
    """``(module, dobs)``: ``run.py uniformgrid``'s problem (the data of
    ``workloads.forward_with_noise`` seed 1, the module on ``device``),
    its f64 host matrix read from ``kernel_cache`` when that file exists
    (else built, and saved there when a path is given)."""
    from . import workloads as W
    from .inversion.potential import GravMagModule

    wl = W.uniformgrid()
    _, dobs = W.forward_with_noise(wl, seed=1, kernel_cache=kernel_cache)
    module = GravMagModule(dobs, wl["mrange"], wl["mspacing"], wl["obs"],
                           verbose=False, kernel_cache=kernel_cache,
                           device=device)
    return module, dobs


def sample(module, dobs, name, device, mesh=None, dtype=torch.float64):
    """Run :data:`RUNS` ``name`` (``HMCSample``, seed 100, the box [0, 1]
    of ``run.py uniformgrid``) on ``device``, SPMD over ``mesh`` when
    given; returns the sampler's result dict."""
    from .inversion import hmc

    cfg = dict(RUNS[name])
    nsamples = cfg.pop("nsamples")
    M = module.n_active
    return hmc.HMCSample(
        module, nsamples, 0, 0.01, [5, 20], np.full(M, 0.001),
        np.full(M, 0.001), np.stack([np.zeros(M), np.ones(M)], axis=1),
        "mandatory", 1000.0, dobs, RegulFactor=1.0,
        regularization=cfg.pop("regularization", "MS"),
        beta=cfg.pop("beta", 0.001), seed=100, Sigma=0.001,
        nchains=NCHAINS, dtype=dtype, verbose=False, write_files=False,
        spmd_mesh=mesh, device=device, **cfg)


def summary(res, seconds):
    """The JSON-able numbers of a result that the check compares."""
    inv = res["inv_mass"]
    return {"accepted": res["accepted"], "step_size": res["step_size"],
            "inv_mass_sum": None if inv is None else float(inv.sum()),
            "inv_mass_min": None if inv is None else float(inv.min()),
            "attempted": res["attempted"], "grad_evals": res["grad_evals"],
            "seconds": seconds}


def _draws_total(mesh):
    """The ``draws`` launches of all ranks (one ``all_reduce``)."""
    from .ops.leapfrog import KERNELS

    n = torch.tensor([float(KERNELS["draws"].launches)],
                     dtype=torch.float64, device=mesh.device)
    return int(mesh.all_reduce(n, ("chains", "model")).item())


def cmd_runs(args):
    from .ops import leapfrog
    from .parallel import multihost, sharded

    info = multihost.initialize(backend=args.backend, device=args.device)
    dev = torch.device(info["device"])
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = sharded.make_mesh(devices=[dev] * info["process_count"])
    module, dobs = problem(dev, args.kernel_cache)
    for name in args.runs.split(","):
        leapfrog.reset_launch_counts()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = sample(module, dobs, name, dev, mesh)
        x = sharded.gather(mesh, res["x"], sharded.X_SPEC, module.n_active)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        launches = _draws_total(mesh)
        if mesh.rank == 0:
            np.save(os.path.join(args.out, f"{name}_x.npy"),
                    x.cpu().numpy())
            print(json.dumps({"multichip_check": name,
                              "mesh": mesh.shape, "backend": info["backend"],
                              "draws_launches": launches,
                              **summary(res, seconds)}), flush=True)
    torch.distributed.destroy_process_group()


def run_cli(argv):
    """``run.run(argv)`` with the sampler's per-chain accept counts (the
    result of its ``HamiltonianMC.sample``) and the ``draws`` launches of
    this process: ``(line, accepted, launches)``."""
    from . import run
    from .inversion import hmc
    from .ops import leapfrog

    seen = {}
    sample_fn = hmc.HamiltonianMC.sample

    def recorded(self, *a, **kw):
        res = sample_fn(self, *a, **kw)
        seen["accepted"] = res["accepted"]
        return res

    hmc.HamiltonianMC.sample = recorded
    leapfrog.reset_launch_counts()
    try:
        line = run.run(argv)
    finally:
        hmc.HamiltonianMC.sample = sample_fn
    return line, seen.get("accepted"), leapfrog.KERNELS["draws"].launches


def cmd_cli(args):
    import torch.distributed as dist

    from .parallel import multihost

    # keep the group up after run.run so the launches can be summed
    info = multihost.initialize(backend=args.backend, device=args.device)
    line, accepted, launches = run_cli(args.argv)
    n = torch.tensor([float(launches)], dtype=torch.float64,
                     device=info["device"])
    dist.all_reduce(n)
    if line is not None:
        print(json.dumps({"multichip_check": "cli", "line": line,
                          "accepted": accepted,
                          "draws_launches": int(n.item())}), flush=True)
    dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("runs")
    r.add_argument("--runs", default="fixed,adapt")
    r.add_argument("--out", required=True)
    r.add_argument("--kernel-cache", dest="kernel_cache", default=None,
                   help="the flagship's f64 host matrix (.npy), read by "
                        "every rank instead of building it")
    c = sub.add_parser("cli")
    c.add_argument("argv", nargs=argparse.REMAINDER)
    for p in (r, c):
        p.add_argument("--device", default=None)
        p.add_argument("--backend", choices=["nccl", "gloo"], default=None)
    args = ap.parse_args(argv)
    if args.cmd == "cli":
        args.argv = [a for a in args.argv if a != "--"]
        cmd_cli(args)
    else:
        cmd_runs(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
