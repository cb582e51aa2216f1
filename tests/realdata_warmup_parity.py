"""The realdata stage's windowed warmup in the JAX package and in the port,
side by side on the CPU (not a test: it takes minutes).

    JAX_PLATFORMS=cpu python tests/realdata_warmup_parity.py --chains 32

Both samplers run the JAX bench's realdata stage settings on its
synthetic 576 x 10,676 problem (JAX: ``bench.build_realdata_problem`` on
its XLA shared-L path; the port: ``realdata.build_problem`` and
``realdata.slice_sampler`` through the fused trajectory op's plain
versions) with ``--chains`` chains and the JAX sampler's own draws fed to
the port. One JSON line per chunk and side (the dt the chunk ran at and
its mean accept), then each side's frozen step size and post-freeze
accept ratio. The two agree chunk by chunk to f32 rounding of states
that differ by f32 rounding (a full-width matrix product sums in another
order), so the dt sequences agree closely, not bit for bit.
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import conftest  # noqa: E402,F401  (jax on the CPU, x64 as in the package)
import test_torch_hmc  # noqa: E402

from gravinv3dhmc_tpu import bench as jbench  # noqa: E402
from gravinv3dhmc_tpu.inversion import hmc as jhmc  # noqa: E402
from gravinv3dhmc_tpu_torch import realdata  # noqa: E402
from gravinv3dhmc_tpu_torch.inversion import hmc as thmc  # noqa: E402


def recording(mod, side, jax_style):
    """``mod.make_chunk_sampler`` whose runner prints each chunk."""
    make = mod.make_chunk_sampler

    def wrapped(*a, **k):
        run = make(*a, **k)

        def run_chunk(carry, key, idx, *args, **kw):
            dt = args[1] if jax_style else kw["dt"]
            carry, stats = run(carry, key, idx, *args, **kw)
            print(json.dumps({"side": side, "chunk": int(idx),
                              "dt": float(dt), "accept": float(
                                  np.asarray(stats[..., 0]).mean())}),
                  flush=True)
            return carry, stats

        return run_chunk

    return wrapped


def jax_chain(C, nsamples):
    module, dobs = jbench.build_realdata_problem()
    M = module.n_active
    w = np.asarray(module.wdiag)
    chain = jhmc.HamiltonianMC(module)
    cfg = realdata.SLICE
    chain.dt, chain.Lrange, chain.Sigma = cfg["dt"], list(cfg["Lrange"]), \
        cfg["Sigma"]
    chain.seed, chain.RegulFactor = cfg["seed"], cfg["RegulFactor"]
    chain.regularization = cfg["regularization"]
    chain.nchains, chain.chunk_size = C, cfg["chunk"]
    chain.verbose = chain.write_files = chain.use_fused = False
    chain.shared_L = chain.adapt_step_size = chain.adapt_mass = True
    chain.adapt_target, chain.adapt_chunks = cfg["adapt_target"], \
        cfg["adapt_chunks"]
    chain.store_mode, chain.transfer_samples = "chain", False
    chain.low, chain.high = w * np.full(M, -0.5), w * np.full(M, 0.5)
    chain.initial_model = w * np.full(M, 0.01)
    chain.aprior_model = w * np.full(M, 0.001)
    chain.dobs = dobs
    return chain.sample(nsamples, 0)


def port_chain(C, nsamples):
    module, dobs = realdata.build_problem("cpu")
    chain = realdata.slice_sampler(module, dobs, "cpu", nchains=C)
    test_torch_hmc.LMIN, test_torch_hmc.LMAX = realdata.SLICE["Lrange"]
    draws = test_torch_hmc.jax_draws(realdata.SLICE["seed"],
                                     realdata.SLICE["chunk"], C,
                                     module.n_active)
    return chain.sample(nsamples, 0, draws=draws)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chains", type=int, default=32)
    ap.add_argument("--nsamples", type=int, default=64,
                    help="stored samples after the warmup")
    ap.add_argument("--side", choices=("both", "jax", "port"),
                    default="both")
    args = ap.parse_args()
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    jhmc.make_chunk_sampler = recording(jhmc, "jax", True)
    thmc.make_chunk_sampler = recording(thmc, "port", False)
    for side, run in (("jax", jax_chain), ("port", port_chain)):
        if args.side not in ("both", side):
            continue
        t0 = time.time()
        res = run(args.chains, args.nsamples)
        print(json.dumps({"side": side, "chains": args.chains,
                          "step_size": res["step_size"],
                          "accept_ratio": res["accept_ratio"],
                          "adapted_mass": res["adapted_mass"],
                          "seconds": time.time() - t0}), flush=True)


if __name__ == "__main__":
    main()
