"""Workload library: the reference's example configurations and the
shared runners, the port of ``examples/workloads.py``.

Each builder returns the workload dict of the JAX library (``mrange``,
``mspacing``, ``mesh``, ``rho`` (the truth), ``obs``, ``mesh_kwargs``,
``rhomin``, ``rhomax``) with its geometry and anomalous bodies bit for
bit (``tests/test_torch_run.py``); :func:`realdata_southchina` returns the
South China case's data instead of a truth. The runners drive HMC, NUTS,
ChEES or CG on top of them through this package's layers, on ``device``
(``cuda:0`` when None, see ``_device.py``): :func:`run_hmc` and
:func:`run_cg`, with :func:`forward_with_noise` for the synthetic data
and :func:`device_posterior_summary` for statistics computed where the
samples live. ``run.py`` is the command line over them.

Two differences from the JAX library, named where they live: without a
``kernel_cache``, a spherical workload's data are forwarded over the
truth's nonzero cells only (the whole-Earth matrix is 72,000 columns, the
truth's five boxes a few thousand), within 1e-12 of the whole matrix's
forward (``tests/test_torch_global.py``); and :func:`realdata_southchina`
has no branch that reads the published observation files, which are not
in this repository.
"""
from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np
import torch

from . import diagnostics, mesher, realdata, utils
from . import ratiogrid as ratiogrid_mod
from .diagnostics import ess_torch, median
from .inversion import hmc
from .inversion.hmc import _unported
from .inversion.potential import GravMagModule
from .inversion.reginv import ConjugateGradient, cg_device
from .ops import prism, tesseroid
from .uniformgrid import density_model

def _box(rho3, iz, iy, ix, value):
    rho3[iz[0]: iz[1] + 1, iy[0]: iy[1] + 1, ix[0]: ix[1] + 1] = value


# ---------------------------------------------------------------------------
# Cartesian synthetic workloads
# ---------------------------------------------------------------------------

def singlecube(nx=20, ny=30, nz=10):
    """A unit-density cube in ``nx`` x ``ny`` x ``nz`` prisms of 100 m
    (:func:`~.uniformgrid.density_model`), observations over the columns
    at z = 0; the default is :func:`uniformgrid`'s geometry, smaller
    meshes cut the problem for the tests."""
    d = 100
    mrange = (0, nx * d, 0, ny * d, 0, nz * d)
    mesh = mesher.PrismMesh(mrange, (d, d, d))
    rho = density_model(nx, ny, nz).ravel()
    mesh.addprop("density", rho)
    xo, yo, zo = utils.regular(mrange[:4], (nx, ny), z=0.0)
    return dict(mrange=mrange, mspacing=(d, d, d), mesh=mesh, rho=rho,
                obs=(xo, yo, zo), mesh_kwargs={}, rhomin=0.0, rhomax=1.0)


def uniformgrid():
    """Single cube, 20x30x10 uniform mesh
    (reference: example/uniformgrid/model01_singlecube.py:24-40)."""
    return singlecube()


def segmentgrid():
    """Single cube on a segmented-depth mesh
    (reference: example/segmentgrid/model_seg.py:25-45)."""
    nx, ny = 20, 30
    d = 100
    mrange = (0, 2000, 0, 3000, 0, 2100)
    division = [0, 300, 900, 2100]
    spacing = ([100, 200, 300], d, d)
    mesh = mesher.PrismMeshSegment(mrange, spacing, division)
    rho3 = np.zeros(mesh.shape)
    _box(rho3, (2, 4), (10, 17), (7, 10), 1.0)
    rho = rho3.ravel()
    mesh.addprop("density", rho)
    xo, yo, zo = utils.regular(mrange[:4], (nx, ny), z=0.0)
    return dict(mrange=mrange, mspacing=spacing, mesh=mesh, rho=rho,
                obs=(xo, yo, zo),
                mesh_kwargs=dict(mseg=True, mdivisionsection=division),
                rhomin=0.0, rhomax=1.0)


def ratiogrid():
    """Dyke complex on a geometric-ratio mesh
    (reference: example/ratiogrid/model_ratio.py:25-56, SetPMTS mratio=1.05):
    :func:`.ratiogrid.mesh_and_obs` and :func:`.ratiogrid.density_model`."""
    mesh, obs = ratiogrid_mod.mesh_and_obs()
    rho = ratiogrid_mod.density_model(mesh.shape).ravel()
    mesh.addprop("density", rho)
    d = 200
    return dict(mrange=(0, 6000, 0, 6000, 0, 6000), mspacing=(d, d, d),
                mesh=mesh, rho=rho, obs=obs,
                mesh_kwargs=dict(mratio=ratiogrid_mod.RATIO), rhomin=0.0,
                rhomax=ratiogrid_mod.RHO)


# ---------------------------------------------------------------------------
# CG synthetic models (reference: example/CG/model0*.py)
# ---------------------------------------------------------------------------

def twodykes(nz=10):
    """The reference's CG model 03 (example/CG/model03_twodykes.py:51-57):
    30 x 40 x ``nz`` prisms of 100 m (10 layers in the reference), two
    dipping dykes of density 1 (cut at the mesh's bottom when ``nz`` is
    smaller), observations over the mesh's columns at z = 0."""
    nx, ny, d = 30, 40, 100
    mrange = (0, nx * d, 0, ny * d, 0, nz * d)
    mesh = mesher.PrismMesh(mrange, (d, d, d))
    rho3 = np.zeros(mesh.shape)
    for iz in range(1, min(4, nz)):
        rho3[iz, iz + 8: iz + 11, 14:17] = 1.0
    for iz in range(2, min(8, nz)):
        rho3[iz, -iz + 24: -iz + 33, 11:20] = 1.0
    rho = rho3.ravel()
    mesh.addprop("density", rho)
    xo, yo, zo = utils.regular(mrange[:4], (nx, ny), z=0.0)
    return dict(mrange=mrange, mspacing=(d, d, d), mesh=mesh, rho=rho,
                obs=(xo, yo, zo), mesh_kwargs={}, rhomin=0.0, rhomax=1.0)


CG_MODELS = ("model01_singlecube", "model02_twocubes", "model03_twodykes",
             "model04_complex")


def cg_model(name="model03_twodykes"):
    if name == "model01_singlecube":
        return uniformgrid()
    if name == "model03_twodykes":
        return twodykes()
    d = 100
    if name == "model02_twocubes":
        nx, ny, nz = 20, 30, 10
        mrange = (0, nx * d, 0, ny * d, 0, nz * d)
        mesh = mesher.PrismMesh(mrange, (d, d, d))
        rho3 = np.zeros(mesh.shape)
        # reference model02 uses a rhomin=-1 cube and a rhomax=+1 cube
        # (example/CG/model02_twocubes.py:47-53)
        _box(rho3, (2, 4), (5, 11), (8, 12), -1.0)
        _box(rho3, (3, 5), (18, 24), (8, 12), 1.0)
        rhomin, rhomax = -1.0, 1.0
    elif name == "model04_complex":
        nx, ny, nz = 30, 40, 10
        mrange = (0, nx * d, 0, ny * d, 0, nz * d)
        mesh = mesher.PrismMesh(mrange, (d, d, d))
        rho3 = np.zeros(mesh.shape)
        # five bodies (example/CG/model04_complex.py:47-64)
        _box(rho3, (2, 6), (24, 27), (7, 10), 1.0)
        _box(rho3, (3, 5), (27, 31), (15, 20), 1.0)
        _box(rho3, (2, 4), (10, 16), (5, 7), 1.0)
        _box(rho3, (2, 4), (14, 16), (7, 15), 1.0)
        _box(rho3, (2, 6), (9, 19), (21, 24), 1.0)
        rhomin, rhomax = 0.0, 1.0
    else:
        raise ValueError(f"unknown CG model {name}")
    rho = rho3.ravel()
    mesh.addprop("density", rho)
    xo, yo, zo = utils.regular(mrange[:4], (nx, ny), z=0.0)
    return dict(mrange=mrange, mspacing=(d, d, d), mesh=mesh, rho=rho,
                obs=(xo, yo, zo), mesh_kwargs={}, rhomin=rhomin,
                rhomax=rhomax)


# ---------------------------------------------------------------------------
# Spherical workloads
# ---------------------------------------------------------------------------

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


def realdata_southchina():
    """South China real-data case: spherical + segmented + topography +
    frozen water cells + prior model
    (reference: example/realdata/main_real.py:21-75). The published
    observation files are not in this repository, so this is the JAX
    library's synthetic stand-in of the same geometry
    (:func:`.realdata.standin`), which that library also returns without
    the reference's tree (no a priori model)."""
    lons, lats, heights, dobs, grav_sea, topo = realdata.standin()
    return dict(mrange=realdata.MRANGE,
                mspacing=(list(realdata.DZ), 0.5, 0.5),
                division=list(realdata.DIVISION), obs=(lons, lats, heights),
                dobs=dobs, grav_sea=grav_sea, topo=(lons, lats, topo),
                aprior_mesh=None, rhomin=-0.5, rhomax=0.5)


# ---------------------------------------------------------------------------
# shared runners
# ---------------------------------------------------------------------------

def _cache_meta_path(kernel_cache):
    """Per-cache metadata file (``k.npy`` -> ``k.meta.json``): a fixed
    per-directory name would let two caches in one directory clobber each
    other's metadata."""
    stem = kernel_cache[:-4] if kernel_cache.endswith(".npy") \
        else kernel_cache
    return stem + ".meta.json"


def _geometry_fingerprint(wl):
    """Hash of everything the kernel matrix depends on: mesh bounds,
    spacing, mesh kwargs and observation coordinates, so a
    shape-compatible cache from a different geometry is rejected instead
    of silently replaying wrong observations."""
    h = hashlib.sha256()
    h.update(repr(tuple(np.asarray(wl["mrange"], np.float64))).encode())
    h.update(repr(wl["mspacing"]).encode())
    h.update(repr(sorted(wl.get("mesh_kwargs", {}).items())).encode())
    for a in wl["obs"]:
        h.update(np.ascontiguousarray(a, np.float64).tobytes())
    return h.hexdigest()


def _spherical(wl):
    return wl.get("mesh_kwargs", {}).get("coordinate") == "spherical"


def forward_with_noise(wl, noise=0.02, seed=1, kernel_cache=None):
    """Forward the synthetic truth + seeded noise: ``(dpre, dobs)``. When
    ``kernel_cache`` points at an existing ``.npy`` kernel matrix (the
    file :class:`GravMagModule` caches), the forward is one matvec against
    it (a cache of another shape, or whose ``.meta.json`` names another
    geometry, is refused with ``ValueError``); given but missing, the
    whole f64 host matrix is built, used and saved there with its
    metadata (``kernel_build_host_s``). Without a cache a spherical
    workload is forwarded over the truth's nonzero cells only: the native
    engine builds those columns (each entry computed on its own, so they
    are the whole matrix's columns bit for bit) and the sum runs over
    them (``forward_s`` and ``forward_backend`` in ``wl``); a Cartesian
    one through the f64 host prism builder."""
    xo, yo, zo = wl["obs"]
    if kernel_cache and os.path.exists(kernel_cache):
        K = np.load(kernel_cache, mmap_mode="r")
        D, M = len(wl["obs"][0]), len(wl["rho"])
        if K.shape != (D, M):
            raise ValueError(
                f"kernel cache {kernel_cache} has shape {K.shape}, but the "
                f"current workload needs ({D}, {M}): stale cache from a "
                "different --scale or geometry?")
        meta_path = _cache_meta_path(kernel_cache)
        fp = _geometry_fingerprint(wl)
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            if meta.get("geometry") not in (None, fp):
                raise ValueError(
                    f"kernel cache {kernel_cache} was built for a "
                    "different geometry (fingerprint mismatch in "
                    f"{meta_path}): delete the cache or pass the "
                    "matching workload")
        dpre = K @ np.asarray(wl["rho"], dtype=K.dtype)
    elif _spherical(wl) and not kernel_cache:
        t0 = time.perf_counter()
        mesh = wl["mesh"]
        rho = np.asarray(wl["rho"], np.float64)[mesh.active]
        nz = np.flatnonzero(rho)
        cells = np.asarray(mesh.cell_bounds(only_active=True), np.float64)
        info = {}
        K = tesseroid.tesseroid_kernel_matrix("gz", xo, yo, zo, cells[nz],
                                              info=info)
        dpre = K @ rho[nz]
        wl["forward_s"] = time.perf_counter() - t0
        wl["forward_backend"] = info["tess_backend"]
    else:
        t0 = time.time()
        builder = tesseroid if _spherical(wl) else prism
        dpre, K = builder.gz(xo, yo, zo, wl["mesh"])
        wl["kernel_build_host_s"] = time.time() - t0
        if kernel_cache:
            # the f64 host kernel: later runs forward with one matvec
            os.makedirs(os.path.dirname(kernel_cache) or ".",
                        exist_ok=True)
            np.save(kernel_cache, K)
            with open(_cache_meta_path(kernel_cache), "w") as f:
                json.dump({"shape": list(K.shape),
                           "geometry": _geometry_fingerprint(wl),
                           "build_s": wl["kernel_build_host_s"]}, f)
        del K
    dobs = utils.contaminate(dpre, noise * np.abs(dpre).max(), seed=seed)
    return dpre, dobs


def device_posterior_summary(module, stats, dobs, truth=None, sub=128):
    """Posterior statistics from the sampler's buffers where they live
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
    out["RMSD"] = mean_removed_rms(module, mean_m * wdiag, dobs)
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


def mean_removed_rms(module, mw, dobs):
    """The mean-removed RMS residual of ``predict(mw)`` against ``dobs``
    (the misfit convention the inversion targets)."""
    dp = module.predict(mw)
    dz = torch.as_tensor(dobs, dtype=dp.dtype, device=dp.device)
    r = (dp - dp.mean()) - (dz - dz.mean())
    return float(torch.sqrt((r ** 2).mean()))


def cg_start(module, wl, dobs, regularization, beta, maxk, alpha):
    """The HMC warm start: float32 projected CG on the module's device
    (:func:`~.inversion.reginv.cg_device`, q 0.7, ``alpha`` fixed or None
    for the reference's adaptive schedule). Returns ``(m, cg_info)``: the
    solution (M,) on the device and the summary the JAX library prints
    under ``cg`` (head, least and last of the data misfits)."""
    t_cg = time.time()
    cg = cg_device(module, dobs, (wl["rhomin"], wl["rhomax"]),
                   regularization=regularization, beta=beta, q=0.7,
                   maxk=maxk, dtype=torch.float32, alpha=alpha)
    d_h = [round(float(v), 3) for v in cg["data_hist"]]
    return cg["m"], {
        "n_iters": cg["n_iters"],
        "elapsed_s": time.time() - t_cg,
        "RMSD": mean_removed_rms(module, cg["mw"], dobs),
        "alpha": alpha,
        "data_hist_head": d_h[:5],
        "data_hist_min": min(d_h),
        "data_hist_last": d_h[-1],
        "diverged": d_h[-1] > 2.0 * min(d_h),
        "regul_hist_last": float(cg["regul_hist"][-1]),
    }



def run_hmc(wl, dobs, nsamples=500, ndraws=0, nchains=2, delta=0.01,
            Lrange=(5, 20), Sigma=0.001, RegulFactor=1.0,
            regularization="MS", beta=0.001, wavelet=False, chunk_size=64,
            save_folder=None, seed=100, verbose=True, kernel_cache=None,
            sampler="hmc", nwarmup=None, temperature=None,
            adapt_step_size=False, adapt_mass=False, adapt_chunks=10,
            kernel_device=False, transfer_samples=True,
            cg_warm_start=False, cg_maxk=200, cg_alpha=None,
            store_mode="accepted", store_thin=1, spmd_mesh=None,
            constraint="mandatory", jacobian=False, hmc_temperature=1.0,
            device=None):
    """Shared sampling driver (reference: example/*/main_*.py pattern),
    the JAX library's ``run_hmc`` on ``device``: returns ``(module,
    stats, mean, std, out)``.

    ``sampler`` selects the MCMC kernel: ``'hmc'``, the reference's
    fixed-L leapfrog HMC (:func:`.inversion.hmc.HMCSample`, the eager
    path: one ``draws`` launch an iteration on the card), or the adaptive
    ``'nuts'`` / ``'chees'``; ``ndraws`` doubles as their warm-up length
    unless ``nwarmup`` is given. ``kernel_device=True`` builds the
    tesseroid matrix on the card; ``transfer_samples=False`` computes the
    statistics where the samples live (:func:`device_posterior_summary`;
    ``mean`` and ``std`` are then None), otherwise the chains come to the
    host (``mean`` and ``std`` numpy). ``cg_warm_start=True`` starts every
    chain at the projected-CG solution (:func:`.inversion.reginv.cg_device`
    in float32, ``cg_alpha`` a fixed regularization weight or None for the
    reference's adaptive schedule). ``spmd_mesh`` (multi-device) is not
    ported yet and raises ``NotImplementedError``.
    """
    if spmd_mesh is not None:
        raise _unported("SPMD meshes (--multichip)", "item 13")
    mesh_kwargs = dict(wl.get("mesh_kwargs", {}))
    t0 = time.time()
    module = GravMagModule(dobs, wl["mrange"], wl["mspacing"], wl["obs"],
                           wavelet=wavelet, verbose=verbose,
                           kernel_cache=kernel_cache,
                           kernel_device=kernel_device, device=device,
                           **mesh_kwargs)
    device = module.device
    M = module.n_active
    initial = np.full(M, 0.001)
    aprior = np.full(M, 0.001)
    boundaries = np.stack([np.full(M, wl["rhomin"]),
                           np.full(M, wl["rhomax"])], axis=1)
    cg_info = None
    if cg_warm_start:
        # (M,) on the device, and it stays there
        initial, cg_info = cg_start(module, wl, dobs, regularization, beta,
                                    cg_maxk, cg_alpha)
        if verbose:
            print(f"CG warm start: {cg_info['n_iters']} iters, "
                  f"RMSD {cg_info['RMSD']:.2f}, "
                  f"{cg_info['elapsed_s']:.1f}s", flush=True)
    if sampler == "hmc":
        if temperature is not None:
            raise ValueError(
                "--temperature applies to the adaptive samplers only "
                "(nuts/chees); the reference HMC kernel's effective "
                "tempering comes from Sigma (inversion/hmc.py docstring)")
        stats = hmc.HMCSample(
            module, nsamples, ndraws, delta, list(Lrange), initial, aprior,
            boundaries, constraint, 1000.0, dobs, RegulFactor=RegulFactor,
            regularization=regularization, beta=beta, seed=seed, Sigma=Sigma,
            save_folder=save_folder or "result/chain", nchains=nchains,
            chunk_size=chunk_size, verbose=verbose,
            write_files=save_folder is not None and transfer_samples,
            adapt_step_size=adapt_step_size, adapt_mass=adapt_mass,
            adapt_chunks=adapt_chunks, transfer_samples=transfer_samples,
            store_mode=store_mode, store_thin=store_thin,
            jacobian=jacobian, temperature=hmc_temperature, device=device)
        if not transfer_samples:
            out, _ = device_posterior_summary(module, stats, dobs,
                                              truth=wl.get("rho"))
            out.update(sampler=sampler, total_s=time.time() - t0,
                       sampling_s=stats["elapsed_s"],
                       grad_evals_per_s=stats["grad_evals_per_s"],
                       accept_ratio=stats["accept_ratio"],
                       step_size=stats["step_size"],
                       adapted_mass=stats["adapted_mass"])
            if cg_info:
                out["cg"] = cg_info
            if out.get("ess_median") is not None:
                out["ess_per_s_median"] = (out["ess_median"]
                                           / max(stats["elapsed_s"], 1e-9))
            return module, stats, None, None, out
        host = stats["samples"].cpu().numpy().astype(np.float64)
        chains = np.stack([host[c, : int(stats["n_stored"][c])]
                           for c in range(nchains)])
    elif sampler in ("nuts", "chees"):
        warm = nwarmup if nwarmup is not None else max(ndraws, 100)
        if temperature is not None and temperature <= 0:
            raise ValueError(f"temperature must be positive, "
                             f"got {temperature}")
        kwargs = dict(RegulFactor=RegulFactor,
                      regularization=regularization, beta=beta, seed=seed,
                      step_size0=delta, nchains=nchains, verbose=verbose,
                      save_folder=save_folder,
                      temperature=(temperature if temperature is not None
                                   else 1.0), device=device)
        if sampler == "nuts":
            from .inversion.nuts import NUTSSample
            stats = NUTSSample(module, nsamples, warm, initial, aprior,
                               boundaries, dobs, **kwargs)
        else:
            from .inversion.chees import CheesSample
            stats = CheesSample(module, nsamples, warm, initial, aprior,
                                boundaries, dobs, **kwargs)
        chains = stats["samples"].cpu().numpy().astype(np.float64)
        stats["grad_evals_per_s"] = (stats["grad_evals"]
                                     / max(stats["elapsed_s"], 1e-9))
        stats["accept_ratio"] = stats.get("mean_accept", float("nan"))
    else:
        raise ValueError(
            "sampler must be one of 'hmc', 'nuts', 'chees'")
    total = time.time() - t0
    mean, std = (t.cpu().numpy() for t in diagnostics.posterior_stats(chains))
    if module.A is not None:
        dpre_mean = module.A @ mean
    else:   # a matrix built on the card: the forward runs there
        w = torch.as_tensor(module.wdiag, dtype=torch.float64,
                            device=device)
        dpre_mean = module.predict(torch.as_tensor(mean, device=device)
                                   * w).cpu().numpy().astype(np.float64)
    out = diagnostics.summarize(chains, dobs=dobs, dpre=dpre_mean,
                                truth=wl.get("rho"), post_mean=mean)
    out.update(sampler=sampler, total_s=total,
               sampling_s=stats["elapsed_s"],
               grad_evals_per_s=stats["grad_evals_per_s"],
               accept_ratio=stats["accept_ratio"])
    if cg_info:
        out["cg"] = cg_info
    # ESS/s over a parameter subsample (north-star metric, BASELINE.json)
    if chains.shape[1] >= 8:
        sub = np.random.RandomState(0).choice(
            M, size=min(M, 128), replace=False)
        ess = diagnostics.effective_sample_size(chains[:, :, sub])
        out["ess_per_s_median"] = (float(np.median(ess))
                                   / max(stats["elapsed_s"], 1e-9))
    return module, stats, mean, std, out


def run_cg(wl, dobs, regularization="MS", beta=0.001, q=0.7, maxk=200,
           wavelet=False, verbose=True, device=None):
    """Shared CG driver (reference: example/CG/main_prism_CG.py:40-76):
    float64 :class:`~.inversion.reginv.ConjugateGradient` on ``device``.
    Returns ``(inv3d, model_inv, data_inv, out)``."""
    inv3d = ConjugateGradient(dobs, wl["mrange"], wl["mspacing"], wl["obs"],
                              wavelet=wavelet, verbose=verbose,
                              device=device, **wl.get("mesh_kwargs", {}))
    M = inv3d.msize
    model_inv, data_inv, d_h, m_h, r_h = inv3d.CG(
        np.zeros(M), np.zeros(M), (wl["rhomin"], wl["rhomax"]),
        regularization=regularization, beta=beta, q=q, maxk=maxk)
    out = {
        "iterations": len(d_h),
        "final_data_misfit": float(d_h[-1]),
        "RMSD": diagnostics.rmsd(dobs, data_inv),
    }
    if "rho" in wl:
        out["RMSM"] = diagnostics.rmsm(model_inv, wl["rho"])
        out["corr"] = float(np.corrcoef(model_inv, wl["rho"])[0, 1])
    return inv3d, model_inv, data_inv, out
