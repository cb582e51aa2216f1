"""One rank of the multi-process checks of ``tests/test_torch_parallel.py``.

Not a test module of its own: ``test_torch_parallel.py`` starts
``python tests/test_torch_parallel_worker.py SPEC RANK`` once per rank of
a mesh, all ranks together, on the CPU over the gloo backend (a
``file://`` rendezvous in the test's temporary directory). It imports no
JAX. Each rank joins the group with ``multihost.initialize``, builds the
mesh of ``SPEC``'s shape and runs every case on its block; the global
results (gathered with ``sharded.gather``) are written by rank 0 to
``<dir>/out_<tag>.npz`` and ``<dir>/out_<tag>.json`` for the test to hold
against the JAX sharded functions and the unsharded port.

The inputs (``<dir>/inputs.npz``) come from the test: the JAX package's
weighted matrices of the three problems and its draws.
"""
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the potential cases: (problem, regularization, beta)
POTENTIALS = [("full", "Damping", 0.01), ("full", "MS", 0.001),
              ("full", "Smoothness", 0.01), ("full", "TV", 0.001),
              ("carved", "Smoothness", 0.01), ("carved", "TV", 0.001),
              ("nz3", "Smoothness", 0.01), ("nz3", "TV", 0.001)]
#: the chunk parity run (test_parallel.py's feature-parity test)
CHUNK = dict(nchains=4, nsamples=4, ndraws=0, chunk_size=6, Lmin=5,
             Lmax=20, dt=0.01, Sigma=0.001, shared_L=True, welford=True,
             store_mode="chain", store_thin=2)
#: the sample() runs: fixed dt with one L a chain, and the windowed warmup
SAMPLE = dict(nchains=4, chunk_size=8, dt=0.01, Lrange=[3, 8],
              Sigma=0.001, regularization="MS", beta=0.001, seed=11)
ADAPT = dict(adapt_mass=True, adapt_chunks=10, dt=0.05)
#: the cut run that snapshots and stops, and the nsamples of every run
CUT_CHUNKS, NSAMPLES = 2, 16
#: the command line's arguments (the uniformgrid cube cut to 8 x 10 x 4)
CLI = ["uniformgrid", "--nchains", "4", "--nsamples", "16",
       "--chunk-size", "8", "--quiet"]


def problem_geometry(nz=4, carved=False):
    """``(bounds, spacing, obs, mtopo)`` of the JAX tests' 8 x 8 x nz
    problem (``tests/test_parallel.py``), with its carving topography."""
    from gravinv3dhmc_tpu_torch import utils

    bounds = (0, 800, 0, 800, 0, 100 * nz)
    obs = tuple(utils.regular((0, 800, 0, 800), (8, 8), z=0.0))
    mtopo = None
    if carved:
        xt, yt = np.meshgrid(np.linspace(0, 800, 9), np.linspace(0, 800, 9))
        ht = -(50.0 + 100.0 * (xt > 400.0))
        mtopo = (xt.ravel(), yt.ravel(), ht.ravel())
    return bounds, (100, 100, 100), obs, mtopo


def port_module(dobs, nz=4):
    """The port's GravMagModule of the full problem on the CPU."""
    from gravinv3dhmc_tpu_torch.inversion.potential import GravMagModule

    bounds, spacing, obs, _ = problem_geometry(nz)
    return GravMagModule(dobs, bounds, spacing, obs, verbose=False,
                         device="cpu")


def configure(chain, module, dobs, **kw):
    """A HamiltonianMC on ``module`` with :data:`SAMPLE` and ``kw``."""
    M = module.n_active
    w = np.asarray(module.wdiag)
    chain.low, chain.high = w * 0.0, w * 1.0
    chain.initial_model = w * np.full(M, 0.001)
    chain.aprior_model = w * np.full(M, 0.001)
    chain.dobs = np.asarray(dobs)
    chain.device = "cpu"
    chain.verbose = False
    for k, v in dict(SAMPLE, **kw).items():
        setattr(chain, k, v)
    return chain


def small_uniformgrid():
    """``workloads.uniformgrid`` cut to the 8 x 10 x 4 cube."""
    from gravinv3dhmc_tpu_torch import workloads as TW

    return TW.singlecube(8, 10, 4)


def main():
    spec_path, rank = sys.argv[1], int(sys.argv[2])
    with open(spec_path) as f:
        spec = json.load(f)
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from gravinv3dhmc_tpu_torch.inversion import hmc
    from gravinv3dhmc_tpu_torch.ops import leapfrog
    from gravinv3dhmc_tpu_torch.parallel import multihost, sharded

    world = spec["world"]
    info = multihost.initialize(spec["init"], world, rank, backend="gloo",
                                device="cpu", timeout=spec["timeout"])
    mesh = sharded.make_mesh(world, chains_axis=spec["chains_axis"],
                             devices=["cpu"] * world)
    d = spec["dir"]
    z = np.load(os.path.join(d, "inputs.npz"))
    arrays, meta = {}, {"info": info, "shape": mesh.shape,
                        "coords": list(mesh.coords)}

    def glob(t, spec_, M=None):
        return sharded.gather(mesh, t, spec_, M).numpy()

    # ---- the potentials, f64
    layouts = {}
    for name, reg, beta in POTENTIALS:
        p = name + "_"
        Aw, xb = z[p + "Aw"], z[p + "xb"]
        M = Aw.shape[1]
        active = z[p + "active"]
        pot, _ = sharded.make_sharded_potential(
            mesh, Aw, z[p + "dobs"], z[p + "apr"], z[p + "low"],
            z[p + "high"], regularization=reg, beta=beta,
            wm_sq=z[p + "wdiag"] ** 2, mshape=tuple(z[p + "mshape"]),
            active=active, dtype=torch.float64)
        x = sharded.shard(mesh, torch.as_tensor(xb), sharded.X_SPEC)
        U, g, (dpre, ud, um) = pot(x, 0.5)
        key = f"pot_{name}_{reg}"
        arrays[key + "_U"] = glob(U, sharded.CHAIN_SPEC)
        arrays[key + "_g"] = glob(g, sharded.X_SPEC, M)
        arrays[key + "_um"] = glob(um, sharded.CHAIN_SPEC)
        layouts[key] = pot.grid_layout
    meta["layouts"] = layouts

    # ---- the chunk sampler with the JAX draws (shared L), f64
    Aw = z["full_Aw"]
    M = Aw.shape[1]
    Ls, n01s, us = z["draw_L"], z["draw_n01"], z["draw_u"]
    pot, _ = sharded.make_sharded_potential(
        mesh, Aw, z["full_dobs"], z["full_apr"], z["full_low"],
        z["full_high"], regularization="Damping", dtype=torch.float64)
    c = CHUNK
    run_chunk, init_carry = sharded.make_sharded_chunk_sampler(
        mesh, pot, low=z["full_low"], high=z["full_high"], M=M,
        nchains=c["nchains"], nsamples=c["nsamples"], ndraws=c["ndraws"],
        wdiag_inv=z["full_wdiag_inv"], data_size=z["full_dobs"].size,
        dt=c["dt"], Lmin=c["Lmin"], Lmax=c["Lmax"], Sigma=c["Sigma"],
        chunk_size=c["chunk_size"], dtype=torch.float64,
        shared_L=c["shared_L"], welford=c["welford"],
        store_mode=c["store_mode"], store_thin=c["store_thin"],
        draws=lambda ci, i: (int(Ls[ci, i]), n01s[ci, i], us[ci, i]))
    carry = init_carry(np.tile(z["full_apr"][None], (c["nchains"], 1)))
    carry, _ = run_chunk(carry, 7, 0, store_base=hmc.STORE_OFF)
    carry, _ = run_chunk(carry, 7, 1, dt=0.005,
                         inv_mass=np.full(M, 0.5), store_base=0)
    full = [glob(leaf, s, M) for leaf, s in
            zip(carry, sharded.carry_shardings(mesh, welford=True))]
    for i, name in ((0, "x"), (5, "nacc"), (6, "store"), (8, "w_mean"),
                    (9, "w_m2"), (10, "w_count")):
        arrays["chunk_" + name] = full[i]
    _, inv_mass = sharded.welford_metric_switch(carry, mesh=mesh)
    arrays["chunk_switch_inv_mass"] = glob(inv_mass, ("model",), M)

    # ---- a chain group whose ranks disagree fails loudly
    try:
        hmc._check_lockstep(mesh, carry[5] + mesh.coords[1], 0)
        meta["lockstep_raised"] = mesh.shape["model"] == 1
    except RuntimeError:
        meta["lockstep_raised"] = True

    # ---- sample(): one L a chain with the Philox draws, the windowed
    # warmup, a cut run's snapshot and a resumed unsharded snapshot
    module = port_module(z["full_dobs"])
    leapfrog.reset_launch_counts()
    runs = {"fixed": {}, "adapt": ADAPT}
    for tag, kw in runs.items():
        chain = configure(hmc.HamiltonianMC(module), module,
                          z["full_dobs"], dtype=torch.float64,
                          spmd_mesh=mesh, **kw)
        res = chain.sample(NSAMPLES, 0)
        arrays[f"{tag}_samples"] = glob(res["samples"], sharded.BUF_M_SPEC,
                                        M)
        arrays[f"{tag}_x"] = glob(res["x"], sharded.X_SPEC, M)
        if res["inv_mass"] is not None:
            arrays[f"{tag}_inv_mass"] = res["inv_mass"].numpy()
        meta[tag] = {k: res[k] for k in (
            "accepted", "attempted", "grad_evals", "step_size",
            "ess_median", "accept_ratio", "n_stored", "shard")}
        meta[tag]["n_stored"] = res["n_stored"].tolist()
    chain = configure(hmc.HamiltonianMC(module), module, z["full_dobs"],
                      dtype=torch.float64, spmd_mesh=mesh, write_files=True,
                      save_folder=os.path.join(d, "files", "chain"))
    meta["folders"] = chain.sample(NSAMPLES, 0)["folders"]
    snap = os.path.join(d, "snap_sharded.npz")
    chain = configure(hmc.HamiltonianMC(module), module, z["full_dobs"],
                      dtype=torch.float64, spmd_mesh=mesh)
    chain.sample(NSAMPLES, 0, max_chunks=CUT_CHUNKS, checkpoint_path=snap)
    resumed = os.path.join(d, f"snap_unsharded_{rank}.npz")
    if os.path.exists(os.path.join(d, "snap_unsharded.npz")):
        import shutil

        shutil.copy(os.path.join(d, "snap_unsharded.npz"), resumed)
        chain = configure(hmc.HamiltonianMC(module), module,
                          z["full_dobs"], dtype=torch.float64,
                          spmd_mesh=mesh)
        res = chain.sample(NSAMPLES, 0, checkpoint_path=resumed)
        arrays["resumed_samples"] = glob(res["samples"],
                                         sharded.BUF_M_SPEC, M)
        meta["resumed"] = {"accepted": res["accepted"]}
    meta["draws_launches"] = leapfrog.KERNELS["draws"].launches
    meta["chains_for_host"] = list(multihost.chains_for_host(8))
    meta["host_seed"] = multihost.host_seed(100)

    # ---- the command line, the group kept
    from gravinv3dhmc_tpu_torch import run as trun
    from gravinv3dhmc_tpu_torch import workloads as TW

    TW.uniformgrid = small_uniformgrid
    line = trun.run(CLI + ["--multichip", "--device", "cpu",
                           "--dist-backend", "gloo"])
    meta["cli_is_none"] = line is None
    if rank == 0:
        meta["cli"] = line
    gathered = [None] * world
    dist.all_gather_object(gathered, {k: meta[k] for k in (
        "coords", "chains_for_host", "host_seed", "draws_launches",
        "lockstep_raised", "cli_is_none", "folders")})
    dist.destroy_process_group()
    if rank == 0:
        meta["ranks"] = gathered
        np.savez(os.path.join(d, f"out_{spec['tag']}.npz"), **arrays)
        with open(os.path.join(d, f"out_{spec['tag']}.json"), "w") as f:
            json.dump(meta, f, default=float)


if __name__ == "__main__":
    main()
