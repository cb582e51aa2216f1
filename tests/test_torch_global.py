"""The whole-Earth command (``gravinv3dhmc_tpu_torch/global_tess.py``)
against ``examples/run.py global`` at scale 0.25 (496 observations x
4,500 tesseroids).

* ``global_tess`` equals ``examples/workloads.global_tess`` (imported by
  path; ``examples/`` is not a package) bit for bit, at 0.25 and at the
  full scale; the synthetic data, forwarded over the truth's nonzero
  cells only, within 1e-12 (relative) of the JAX ``forward_with_noise``,
  which forwards the whole host matrix.
* ``--map-only`` and ``--honest --no-cg`` at the depths of
  ``tests/test_examples_cli.py``, held to its bounds.
* On the matrix built by the device builder (run on the CPU here) in both
  packages: ``cg_device``'s first data misfits against the JAX one's,
  ``device_posterior_summary`` against the JAX one on the same buffers,
  and ``HMCSample`` started from the CG model on the device (its weights
  and start are tensors there) against the JAX sampler with its draws.
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from gravinv3dhmc_tpu.inversion import hmc as jhmc
from gravinv3dhmc_tpu.inversion.potential import GravMagModule as JModule
from gravinv3dhmc_tpu.inversion.reginv import cg_device as j_cg_device
from gravinv3dhmc_tpu_torch import global_tess as G
from gravinv3dhmc_tpu_torch.inversion import hmc as thmc
from gravinv3dhmc_tpu_torch.inversion.reginv import cg_device

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = 0.25
#: cg_device's data misfits held to the JAX solver's over this prefix:
#: the two f32 matrices differ by ~1e-7 and projected Fletcher-Reeves
#: amplifies the difference as it goes (``tests/test_torch_reginv.py``)
CG_PREFIX, CG_RTOL = 20, 1e-4


def _workloads():
    spec = importlib.util.spec_from_file_location(
        "workloads", os.path.join(REPO, "examples", "workloads.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("scale", [SCALE, 1.0])
def test_global_tess_matches_workloads(scale):
    want = _workloads().global_tess(scale)
    got = G.global_tess(scale)
    for key in ("mrange", "mspacing", "mesh_kwargs", "rhomin", "rhomax"):
        assert got[key] == want[key]
    np.testing.assert_array_equal(got["rho"], want["rho"])
    for a, b in zip(got["obs"], want["obs"]):
        np.testing.assert_array_equal(a, b)
    assert got["mesh"].shape == want["mesh"].shape
    np.testing.assert_array_equal(got["mesh"].cell_bounds(),
                                  want["mesh"].cell_bounds())


def test_forward_with_noise_matches_jax():
    W = _workloads()
    dpre_j, dobs_j = W.forward_with_noise(W.global_tess(SCALE))
    wl = G.global_tess(SCALE)
    dpre, dobs = G.forward_with_noise(wl)
    assert wl["forward_backend"] == "native" and wl["forward_s"] > 0
    for got, want in ((dpre, dpre_j), (dobs, dobs_j)):
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_map_only():
    out = G.run(G.parse_args(["--scale", "0.25", "--map-only",
                              "--cg-maxk", "120", "--quiet"]), "cpu")
    assert out["estimator"].startswith("bounded MAP")
    assert out["problem"] == [496, 4500]
    assert out["posterior_truth_corr"] > 0.3
    assert out["RMSD"] < 5000
    assert out["mask_backend"] == out["pairs_backend"] == "native"
    assert out["nearfield_pairs"] > 0


def test_honest_mode():
    out = G.run(G.parse_args(["--scale", "0.25", "--honest", "--no-cg",
                              "--nchains", "4", "--nsamples", "24",
                              "--chunk-size", "8", "--adapt-chunks", "6",
                              "--quiet"]), "cpu")
    assert out["target"].startswith("honest posterior")
    assert out["accept_ratio"] > 0.2
    assert "ess_frozen_floor" in out
    assert out["fused_mode"] == "off" and out["adapted_mass"]
    for key in ("RMSD", "RMSM", "posterior_truth_corr", "coverage_2std",
                "ess_median", "grad_evals_per_s", "step_size",
                "variance_explained", "kernel_build_device_s",
                "weighting_device_s"):
        assert np.isfinite(out[key]), key


@pytest.fixture(scope="module")
def device_built():
    """Both packages' modules on the device builder (CPU) at scale 0.25."""
    wl = G.global_tess(SCALE)
    _, dobs = G.forward_with_noise(wl)
    args = (dobs, wl["mrange"], wl["mspacing"], wl["obs"])
    jm = JModule(*args, kernel_device=True, verbose=False,
                 **wl["mesh_kwargs"])
    tm = G.GravMagModule(*args, kernel_device=True, verbose=False,
                         device="cpu", **wl["mesh_kwargs"])
    return wl, dobs, jm, tm


def test_cg_device_on_device_built_module(device_built):
    wl, dobs, jm, tm = device_built
    assert tm.Aw is None and jm.Aw is None
    box = (wl["rhomin"], wl["rhomax"])
    kw = dict(regularization="Damping", beta=0.01, maxk=60, alpha=5.0)
    want = j_cg_device(jm, dobs, box, dtype=jnp.float32, **kw)
    got = cg_device(tm, dobs, box, **kw)
    assert got["m"].dtype == torch.float32 and got["n_iters"] == 60
    d_j, d_t = want["data_hist"][:CG_PREFIX], got["data_hist"][:CG_PREFIX]
    assert np.abs(d_t - d_j).max() <= CG_RTOL * np.abs(d_j).max()
    assert np.ptp(got["data_hist"]) > 1e-3 * got["data_hist"][0]


def _jax_draws(seed, chunk_size, C, M, Lmin, Lmax):
    base_key = random.fold_in(random.PRNGKey(seed), 0)
    cache = {}

    def draws(chunk_idx, i):
        if chunk_idx not in cache:
            rows = []
            for k in random.split(random.fold_in(base_key, chunk_idx),
                                  chunk_size):
                kL, kp, ku = random.split(k, 3)
                rows.append((np.array(random.randint(kL, (C,), Lmin,
                                                     Lmax + 1)),
                             np.asarray(random.normal(kp, (C, M),
                                                      jnp.float32)),
                             np.asarray(random.uniform(ku, (C,),
                                                       jnp.float32))))
            cache[chunk_idx] = rows
        return cache[chunk_idx][i]

    return draws


def test_hmc_from_the_device_warm_start(device_built, monkeypatch):
    """The global HMC's start: the CG model (a tensor on the device) and
    the module's weights on the device go through ``HMCSample`` as they
    are, and the run equals the JAX sampler's on its own device-built
    module with the same draws (accept counts; samples within 1e-4 of
    max|sample|, the matrices' f32 difference carried along)."""
    wl, dobs, jm, tm = device_built
    M = tm.n_active
    box = (wl["rhomin"], wl["rhomax"])
    cg_j = j_cg_device(jm, dobs, box, regularization="Damping", maxk=10,
                       dtype=jnp.float32, alpha=5.0)
    m0 = torch.as_tensor(np.array(cg_j["m"]))
    bounds = np.stack([np.full(M, box[0]), np.full(M, box[1])], axis=1)
    args = dict(nsamples=8, ndraws=0, delta=0.005, Lrange=[5, 20],
                aprior_model=np.full(M, 0.001), boundaries=bounds,
                constraint="mandatory", log_factor=1000.0, dobs=dobs,
                RegulFactor=0.05, regularization="Damping", beta=0.01,
                seed=100, Sigma=0.001, nchains=2, chunk_size=8,
                verbose=False, write_files=False, store_mode="chain")
    want = jhmc.HMCSample(jm, initial_model=cg_j["m"], **args)
    sample = thmc.HamiltonianMC.sample
    draws = _jax_draws(100, 8, 2, M, 5, 20)
    monkeypatch.setattr(thmc.HamiltonianMC, "sample",
                        lambda self, n, d: sample(self, n, d, draws=draws))
    got = thmc.HMCSample(tm, initial_model=m0, device="cpu", **args)
    assert torch.is_tensor(tm.wdiag) and got["fused_mode"] == "off"
    assert got["accepted"] == list(want["accepted"])
    s_want = np.asarray(want["samples"])
    s_got = got["samples"].numpy()
    assert np.abs(s_got - s_want).max() <= 1e-4 * np.abs(s_want).max()


def test_posterior_summary_matches_jax(device_built):
    """``device_posterior_summary`` on the same (4, 16, M) buffers."""
    W = _workloads()
    wl, dobs, jm, tm = device_built
    rng = np.random.RandomState(3)
    buf = (wl["rho"] + 0.05 * rng.randn(4, 16, tm.n_active)).astype(
        np.float32)
    n_stored = np.full(4, 16)
    want, _ = W.device_posterior_summary(
        jm, {"samples_device": jnp.asarray(buf), "n_stored": n_stored},
        dobs, truth=wl["rho"])
    got, mean = G.device_posterior_summary(
        tm, {"samples": torch.as_tensor(buf), "n_stored": n_stored}, dobs,
        truth=wl["rho"])
    assert set(got) == set(want) and mean.shape == (tm.n_active,)
    for key, v in want.items():
        if isinstance(v, bool):
            assert got[key] == v, key
        else:
            assert got[key] == pytest.approx(v, rel=1e-4), key
