"""The port's command line (``gravinv3dhmc_tpu_torch/run.py``) and its
workload library (``gravinv3dhmc_tpu_torch/workloads.py``) against
``examples/run.py`` and ``examples/workloads.py``, in-process on the CPU.

* Every builder's geometry, truth and observations are bit-equal to the
  JAX library's (``examples/`` is imported by path).
* ``forward_with_noise`` gives the JAX library's data (rtol 1e-13: the
  same f64 host builder), saves a kernel cache the JAX library replays to
  the same data bit for bit, and refuses a stale shape and a wrong
  geometry as it does (``tests/test_workload_cache.py``).
* ``run_cg`` on ``model01_singlecube`` at 10 iterations equals the JAX
  ``run_cg`` within 1e-10 relative (float64 on both sides).
* Every subcommand, the JAX driver's ``main`` and the port's on the same
  small arguments, prints one JSON line whose key set equals the JAX
  line's (``global`` with the documented differences of ``run.py``,
  :data:`~gravinv3dhmc_tpu_torch.run.GLOBAL_ADDED` and ``GLOBAL_DROPPED``).
  The realdata stand-in is cut to 2 degrees in both packages (36
  observations), the uniformgrid cube to 8 x 10 x 4 prisms (also under
  ``cg`` and ``bootstrap``), the segmentgrid and ratiogrid meshes to 8 x
  10 and 10 x 10 columns and the
  whole-Earth mesh to scale 0.1 (91 x 720), so the runs stay short; the
  code paths are the full ones.
* ``--multichip`` is held in ``tests/test_torch_parallel.py``.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from gravinv3dhmc_tpu import mesher as jmesher
from gravinv3dhmc_tpu_torch import cg as tcg
from gravinv3dhmc_tpu_torch import mesher as tmesher
from gravinv3dhmc_tpu_torch import ratiogrid as tratiogrid
from gravinv3dhmc_tpu_torch import realdata
from gravinv3dhmc_tpu_torch import utils as tutils
from gravinv3dhmc_tpu_torch import run as trun
from gravinv3dhmc_tpu_torch import workloads as TW

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
import run as jrun  # noqa: E402
import workloads as JW  # noqa: E402

torch.set_num_threads(2)

#: the realdata stand-in's grid step in these tests (degrees)
STEP = 2.0
#: run_cg's tolerance against the JAX run (float64, 10 iterations)
CG_RTOL = 1e-10

BUILDERS = {
    "uniformgrid": "uniformgrid()",
    "segmentgrid": "segmentgrid()",
    "ratiogrid": "ratiogrid()",
    **{m: f"cg_model({m!r})" for m in TW.CG_MODELS},
    "global(0.25)": "global_tess(0.25)",
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_is_the_jax_librarys(name):
    got = eval("TW." + BUILDERS[name])
    want = eval("JW." + BUILDERS[name])
    assert set(got) == set(want)
    for key in ("mrange", "mspacing", "mesh_kwargs", "rhomin", "rhomax"):
        assert got[key] == want[key], key
    np.testing.assert_array_equal(got["rho"], want["rho"])
    for a, b in zip(got["obs"], want["obs"]):
        np.testing.assert_array_equal(a, b)
    assert got["mesh"].shape == want["mesh"].shape
    np.testing.assert_array_equal(got["mesh"].cell_bounds(),
                                  want["mesh"].cell_bounds())
    np.testing.assert_array_equal(got["mesh"].props["density"],
                                  want["mesh"].props["density"])


def test_realdata_southchina_is_the_jax_librarys():
    """Without the reference's files both libraries give the synthetic
    stand-in of the published geometry (576 observations)."""
    got, want = TW.realdata_southchina(), JW.realdata_southchina()
    assert set(got) == set(want)
    for key in ("mrange", "mspacing", "division", "rhomin", "rhomax",
                "aprior_mesh"):
        assert got[key] == want[key], key
    for key in ("obs", "topo"):
        for a, b in zip(got[key], want[key]):
            np.testing.assert_array_equal(a, b)
    for key in ("dobs", "grav_sea"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["dobs"].size == 576


def test_forward_with_noise_is_the_jax_librarys():
    for a, b in zip(TW.forward_with_noise(TW.uniformgrid()),
                    JW.forward_with_noise(JW.uniformgrid())):
        np.testing.assert_allclose(a, b, rtol=1e-13, atol=0)


def test_cache_save_and_replay(tmp_path):
    """The port writes the cache and its metadata; both libraries replay
    it to the same data bit for bit."""
    wl = TW.uniformgrid()
    cache = str(tmp_path / "k.npy")
    d1, o1 = TW.forward_with_noise(wl, kernel_cache=cache)
    assert os.path.exists(cache) and wl["kernel_build_host_s"] > 0
    with open(tmp_path / "k.meta.json") as f:
        meta = json.load(f)
    assert meta["geometry"] == TW._geometry_fingerprint(wl) \
        == JW._geometry_fingerprint(JW.uniformgrid())
    assert meta["shape"] == [600, 6000]
    d2, o2 = TW.forward_with_noise(TW.uniformgrid(), kernel_cache=cache)
    d3, o3 = JW.forward_with_noise(JW.uniformgrid(), kernel_cache=cache)
    for a, b, c in ((d1, d2, d3), (o1, o2, o3)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert TW._cache_meta_path("x/a.npy") == JW._cache_meta_path("x/a.npy")
    assert TW._cache_meta_path("x/a") == JW._cache_meta_path("x/a")


def test_stale_cache_rejected(tmp_path):
    cache = str(tmp_path / "k.npy")
    np.save(cache, np.zeros((7, 7)))
    with pytest.raises(ValueError, match="stale cache"):
        TW.forward_with_noise(TW.uniformgrid(), kernel_cache=cache)


def test_wrong_geometry_rejected(tmp_path):
    cache = str(tmp_path / "k.npy")
    TW.forward_with_noise(TW.uniformgrid(), kernel_cache=cache)
    wl2 = TW.uniformgrid()
    xo, yo, zo = wl2["obs"]
    wl2["obs"] = (xo + 50.0, yo, zo)   # same count, shifted stations
    with pytest.raises(ValueError, match="different geometry"):
        TW.forward_with_noise(wl2, kernel_cache=cache)


def test_run_cg_matches_jax():
    wl = TW.cg_model("model01_singlecube")
    _, dobs = TW.forward_with_noise(wl)
    _, model, data_inv, out = TW.run_cg(wl, dobs, maxk=10, verbose=False,
                                        device="cpu")
    _, jmodel, jdata, jout = JW.run_cg(JW.cg_model("model01_singlecube"),
                                       dobs, maxk=10, verbose=False)
    assert set(out) == set(jout) and out["iterations"] == 10
    for key, value in jout.items():
        assert out[key] == pytest.approx(value, rel=CG_RTOL), key
    np.testing.assert_allclose(model, jmodel, rtol=0,
                               atol=CG_RTOL * np.abs(jmodel).max())
    np.testing.assert_allclose(data_inv, jdata, rtol=CG_RTOL)


# --------------------------------------------------------------------------
# the subcommands against the JAX driver
# --------------------------------------------------------------------------

HMC = ["--nchains", "2", "--nsamples", "16", "--chunk-size", "8"]
COMMANDS = {
    "uniformgrid": ["uniformgrid", *HMC],
    "uniformgrid-chees": ["uniformgrid", "--sampler", "chees",
                          "--nwarmup", "16", *HMC],
    "segmentgrid": ["segmentgrid", *HMC],
    "ratiogrid": ["ratiogrid", "--nchains", "2", "--nsamples", "8",
                  "--chunk-size", "8", "--Lrange", "2", "3"],
    "realdata": ["realdata", *HMC],
    "realdata-chees": ["realdata", "--sampler", "chees", "--nwarmup", "16",
                       "--nchains", "4", "--nsamples", "16",
                       "--chunk-size", "8"],
    "global-map": ["global", "--scale", "0.1", "--map-only", "--cg-maxk",
                   "20"],
    "global-hmc": ["global", "--scale", "0.1", "--cg-maxk", "20",
                   "--nchains", "2", "--nsamples", "8", "--chunk-size", "4",
                   "--Lrange", "2", "4"],
    "cg": ["cg", "--model", "model01_singlecube", "--maxk", "5"],
    "bootstrap": ["bootstrap", "--samples", "2", "--maxk", "5"],
    "bootstrap-southchina": ["bootstrap-southchina", "--samples", "2",
                             "--maxk", "5"],
}


def _small_ratiogrid(module, mesher):
    """``module.ratiogrid`` replaced by the same dyke complex on a 10 x 10
    column ratio mesh (``ratiogrid.mesh_and_obs(n=10)``'s geometry, the
    boxes cut at its edges) built with ``mesher``."""
    full = module.ratiogrid

    def small():
        wl = full()
        d, n = 200.0, 10
        bounds = (0, n * d, 0, n * d, 0, n * d)
        mesh = mesher.PrismMesh(bounds, (d, d, d), 1.05)
        rho = tratiogrid.density_model(mesh.shape).ravel()
        mesh.addprop("density", rho)
        _, ny, nx = mesh.shape
        wl.update(mrange=bounds, mesh=mesh, rho=rho,
                  obs=tutils.regular(bounds[:4], (nx, ny), z=0.0))
        return wl

    return small


def _small_uniformgrid(module, mesher):
    """``module.uniformgrid`` replaced by the single cube in 8 x 10 x 4
    prisms (``workloads.singlecube(8, 10, 4)``) built with ``mesher``."""
    def small():
        wl = TW.singlecube(8, 10, 4)
        mesh = mesher.PrismMesh(wl["mrange"], wl["mspacing"])
        mesh.addprop("density", wl["rho"])
        return dict(wl, mesh=mesh)

    return small


def _small_segmentgrid(module, mesher):
    """``module.segmentgrid`` replaced by the same segmented depths under
    8 x 10 columns (a 3 x 3 x 3 cube) built with ``mesher``."""
    full = module.segmentgrid

    def small():
        wl = full()
        mrange = (0, 800, 0, 1000, 0, 2100)
        mesh = mesher.PrismMeshSegment(mrange, wl["mspacing"],
                                       wl["mesh_kwargs"]["mdivisionsection"])
        rho3 = np.zeros(mesh.shape)
        rho3[2:5, 3:6, 2:5] = 1.0
        rho = rho3.ravel()
        mesh.addprop("density", rho)
        wl.update(mrange=mrange, mesh=mesh, rho=rho,
                  obs=tutils.regular(mrange[:4], (8, 10), z=0.0))
        return wl

    return small


def _coarse(module):
    """``module.realdata_southchina`` replaced by the same stand-in at
    :data:`STEP` degrees (both libraries use this one)."""
    full = module.realdata_southchina

    def coarse():
        rd = full()
        lons, lats, heights, dobs, grav_sea, topo = realdata.standin(STEP)
        rd.update(mspacing=(list(realdata.DZ), STEP, STEP),
                  obs=(lons, lats, heights), dobs=dobs, grav_sea=grav_sea,
                  topo=(lons, lats, topo))
        return rd

    return coarse


def _small(mp):
    """The cut workloads above, in both libraries, on ``mp``."""
    mp.setattr(TW, "realdata_southchina", _coarse(TW))
    mp.setattr(JW, "realdata_southchina", _coarse(JW))
    mp.setattr(TW, "ratiogrid", _small_ratiogrid(TW, tmesher))
    mp.setattr(JW, "ratiogrid", _small_ratiogrid(JW, jmesher))
    mp.setattr(TW, "uniformgrid", _small_uniformgrid(TW, tmesher))
    mp.setattr(JW, "uniformgrid", _small_uniformgrid(JW, jmesher))
    mp.setitem(tcg.BOOTSTRAP, "shape", (8, 10, 4))
    mp.setattr(TW, "segmentgrid", _small_segmentgrid(TW, tmesher))
    mp.setattr(JW, "segmentgrid", _small_segmentgrid(JW, jmesher))


def _both(mp, argv):
    """``argv`` through the port's ``run`` on the CPU and the JAX driver's
    ``main``: ``(port line, JAX line)``."""
    from io import StringIO

    got = trun.run(argv + ["--device", "cpu", "--quiet"])
    mp.setattr(sys, "argv", ["run.py", *argv, "--quiet"])
    buf = StringIO()
    mp.setattr(sys, "stdout", buf)
    try:
        jrun.main()
    finally:
        mp.setattr(sys, "stdout", sys.__stdout__)
    return got, json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def lines():
    """``{name: (port line, JAX line)}`` for every command of
    :data:`COMMANDS`."""
    mp = pytest.MonkeyPatch()
    _small(mp)
    try:
        return {name: _both(mp, argv) for name, argv in COMMANDS.items()}
    finally:
        mp.undo()


@pytest.mark.parametrize("name", sorted(COMMANDS))
def test_subcommand_line_has_the_jax_keys(lines, name):
    got, want = lines[name]
    assert json.loads(json.dumps(got)) == got
    if name.startswith("global"):
        assert set(got) - trun.GLOBAL_ADDED == \
            set(want) - trun.GLOBAL_DROPPED - trun.GLOBAL_ADDED
    else:
        assert set(got) == set(want)
    assert got.get("problem") == want.get("problem")
    assert got.get("workload") == want.get("workload")
    for key in ("accept_ratio", "RMSD", "rhat_max", "posterior_truth_corr",
                "temperature", "mean_model_max", "model_std_max"):
        if key in got:
            assert np.isfinite(got[key]), key


def test_chip_smoke_expects_the_jax_keys(lines):
    """``chip_smoke.py``'s ``run`` phase runs the same subcommands at full
    geometry and holds each line to ``RUN_KEYS``: those are the key sets
    of the port's lines here, which equal the JAX driver's."""
    import chip_smoke

    assert set(chip_smoke.RUN_CASES) == set(COMMANDS) \
        == set(chip_smoke.RUN_KEYS) == set(chip_smoke.RUN_BOUNDS)
    for name, (got, _) in lines.items():
        assert set(got) == chip_smoke.RUN_KEYS[name], name
        assert chip_smoke.RUN_CASES[name][0] == COMMANDS[name][0]
        for key in chip_smoke.RUN_BOUNDS[name]:
            assert key in got, (name, key)


def test_deterministic_lines_match_jax(lines):
    """The deterministic subcommands' numbers against the JAX driver's:
    CG (float64, 5 iterations) within 1e-9, the bootstraps' summaries
    within 1e-6 (their resampling comes from the same seeded generator)."""
    for name, rel in (("cg", 1e-9), ("bootstrap", 1e-6),
                      ("bootstrap-southchina", 1e-6)):
        got, want = lines[name]
        for key, value in want.items():
            if isinstance(value, float):
                assert got[key] == pytest.approx(value, rel=rel), (name, key)
            else:
                assert got[key] == value, (name, key)


def _jax_draws(seed, myrank, chunk_size, C, M, Lmin, Lmax):
    """The JAX ``HMCSample``'s own draws (the eager masked-L scan, one L a
    chain): for each iteration ``kL, kp, ku = split(key, 3)`` of
    ``split(fold_in(base_key, chunk), chunk_size)``
    (``gravinv3dhmc_tpu/inversion/hmc.py``)."""
    from jax import random
    import jax.numpy as jnp

    base_key = random.fold_in(random.PRNGKey(seed), myrank)
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


#: the injected-draws lines' tolerance on their statistics (relative):
#: float32 trajectories of up to 20 steps, sums in other orders (1e-7 apart
#: when this was written)
HMC_RTOL = 1e-6


@pytest.mark.parametrize("name", ["uniformgrid", "realdata"])
def test_hmc_line_with_the_jax_draws_matches_jax(name, monkeypatch):
    """An HMC subcommand's line, the port's ``HMCSample`` fed the JAX
    sampler's own draws, against the JAX driver's: the same accept ratio
    and stored counts; RMSD, RMSM (where there is a truth), R-hat and the
    ESS within :data:`HMC_RTOL`. This holds the driver's glue around the
    sampler (the data's noise, the initial and a priori models, the box,
    the stored chains' summary) to the JAX command's."""
    from gravinv3dhmc_tpu_torch.inversion import hmc as thmc

    _small(monkeypatch)
    sample = thmc.HamiltonianMC.sample

    def injected(self, nsamples, ndraws, **kw):
        return sample(self, nsamples, ndraws, draws=_jax_draws(
            self.seed, self.myrank, self.chunk_size, self.nchains,
            self.model.n_active, *self.Lrange), **kw)

    monkeypatch.setattr(thmc.HamiltonianMC, "sample", injected)
    got, want = _both(monkeypatch, COMMANDS[name])
    assert got["accept_ratio"] == want["accept_ratio"]
    assert got["n_samples"] == want["n_samples"]
    assert got["problem"] == want["problem"]
    for key in ("RMSD", "RMSM", "rhat_max", "ess_min", "ess_mean"):
        if key in want:
            assert got[key] == pytest.approx(want[key], rel=HMC_RTOL), key
    assert ("RMSM" in got) == (name == "uniformgrid")


def test_default_device_needs_a_card(monkeypatch):
    """Without ``--device`` the command runs on ``cuda:0`` and, without a
    card, fails before building anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trun.run(["cg", "--maxk", "1"])


def test_setpmts_line_sets_the_run(tmp_path):
    """``--setpmts`` / ``--attempt``: the reference-format line's sampler
    settings replace the flags', as in the JAX driver."""
    path = tmp_path / "SetPMTS.txt"
    path.write_text(json.dumps({"nsamples": 7, "Lrange": [3, 4],
                                "delta": 0.02, "Sigma": 0.01,
                                "RegulFactor": 2.0, "regularization":
                                "Damping", "beta": 0.1}) + "\n")
    args = trun.parse_args(["uniformgrid", "--setpmts", str(path)])
    assert (args.nsamples, args.Lrange, args.delta, args.Sigma,
            args.RegulFactor, args.regularization, args.beta) == (
        7, [3, 4], 0.02, 0.01, 2.0, "Damping", 0.1)
