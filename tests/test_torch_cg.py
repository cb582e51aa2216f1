"""The deterministic slice (``gravinv3dhmc_tpu_torch.cg``) and the
calibrated realdata ChEES, reduced, on the CPU, against the JAX package.

The stages' geometry is copied from ``examples/workloads.py`` (which
imports the JAX package); the copies are held equal to the originals. The
``cg`` and ``bootstrap`` stages are held against the JAX classes on the
same reduced problems (float64, short runs: rtol 1e-9).

The ``map`` stage's fixed-alpha Damping solve copies a property of the
JAX package's step (twice the exact line search, the reference's): while
the box is not active every iterate lies on the start's level set of the
objective, so the best iterate, and the temperature T taken from it, is
picked by rounding in both packages. So T is held against the JAX path on
the same iterate (the final one of a short run, rtol 1e-4), and the level
set is checked on both sides.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from gravinv3dhmc_tpu import mesher as jmesher
from gravinv3dhmc_tpu.inversion import chees as jchees
from gravinv3dhmc_tpu.inversion import reginv as jr
from gravinv3dhmc_tpu.inversion.potential import GravMagModule as JModule
from gravinv3dhmc_tpu.inversion.potential import mw_to_logistic
from gravinv3dhmc_tpu_torch import cg, realdata, samplers
from gravinv3dhmc_tpu_torch.inversion import reginv as tr
from gravinv3dhmc_tpu_torch.ops import leapfrog as tlf
from test_torch_chees import jax_draws
from test_torch_realdata import _args

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
import workloads as W  # noqa: E402

torch.set_num_threads(2)

RTOL = 1e-9
STEP = 2.0
REDUCED = {"cg": dict(nz=2, maxk=20),
           "bootstrap": dict(shape=(6, 8, 4), samples=3, maxk=10),
           "bootstrap_southchina": dict(samples=4, maxk=30),
           "map": dict(step=STEP, maxk=20)}
#: bootstrap_southchina's data misfits grow rounding about tenfold an
#: iteration (ROADMAP.md queue 1, item 8): the first six are held, within
#: 1e-9 of the start's rounding grown over five iterations
SOUTHCHINA_PREFIX = 6
SOUTHCHINA_RTOL = 5e-8


def test_geometry_copies_match_workloads():
    for ours, theirs in ((cg.twodykes(), W.cg_model("model03_twodykes")),
                         (cg.singlecube(), W.uniformgrid())):
        assert ours["mrange"] == theirs["mrange"]
        assert tuple(ours["mspacing"]) == tuple(theirs["mspacing"])
        assert ours["mesh"].shape == theirs["mesh"].shape
        np.testing.assert_array_equal(ours["rho"], theirs["rho"])
        for a, b in zip(ours["obs"], theirs["obs"]):
            np.testing.assert_array_equal(a, b)
        assert (ours["rhomin"], ours["rhomax"]) == \
            (theirs["rhomin"], theirs["rhomax"])


def test_forward_with_noise_matches_workloads():
    ours = cg.singlecube(6, 8, 4)
    mesh = jmesher.PrismMesh(ours["mrange"], ours["mspacing"])
    mesh.addprop("density", ours["rho"])
    theirs = dict(ours, mesh=mesh)
    for a, b in zip(cg.forward_with_noise(ours), W.forward_with_noise(theirs)):
        np.testing.assert_allclose(a, b, rtol=1e-13, atol=0)


@pytest.fixture(scope="module")
def reduced_run():
    return cg.run(device="cpu", overrides=REDUCED)


def test_run_reduced_matches_jax(reduced_run):
    """``run()`` at reduced sizes: the ``cg`` and ``bootstrap`` lines equal
    the JAX classes' on the same problems, every tensor stays on the CPU,
    the histories are finite up to the iterations run."""
    out = reduced_run
    assert set(out) == set(cg.STAGES)
    for name, (line, tensors, hist) in out.items():
        assert json.loads(json.dumps(line)) == line
        assert {"build_s", "solve_s", "total_s", "device"} <= set(line)
        assert all(v.device.type == "cpu" for v in tensors.values())
        assert (np.isfinite(hist["data_hist"]).all()
                or name.startswith("bootstrap"))
    line, tensors, hist = out["cg"]
    wl = cg.twodykes(2)
    _, dobs = cg.forward_with_noise(wl)
    jinv = jr.ConjugateGradient(dobs, wl["mrange"], wl["mspacing"], wl["obs"],
                                verbose=False)
    M = jinv.msize
    model, data_inv, d_h, _, r_h = jinv.CG(
        np.zeros(M), np.zeros(M), (0.0, 1.0), regularization="MS",
        beta=0.001, q=0.7, maxk=20)
    assert line["iterations"] == len(d_h) == 20
    np.testing.assert_allclose(hist["data_hist"], d_h, rtol=RTOL)
    np.testing.assert_allclose(hist["model"], model, rtol=0,
                               atol=RTOL * np.abs(model).max())
    assert line["corr"] == pytest.approx(
        float(np.corrcoef(model, wl["rho"])[0, 1]), rel=1e-9)
    assert line["RMSD"] == pytest.approx(
        float(np.sqrt(np.mean((dobs - data_inv) ** 2))), rel=1e-9)
    assert line["n_decays"] == len(cg.decay_iters(r_h))
    assert cg.decay_iters(hist["regul_hist"]) == cg.decay_iters(r_h)
    assert tensors["m"].shape == (M,)

    line, tensors, hist = out["bootstrap"]
    wl = cg.singlecube(6, 8, 4)
    _, dobs = cg.forward_with_noise(wl)
    bs = jr.BootStrap(wl["mrange"], wl["mspacing"], wl["obs"], dobs,
                      (0.0, 1.0), samples=3, beta=0.01, maxk=10,
                      verbose=False)
    models = bs.BSCG(np.zeros(bs.msize))[0]
    np.testing.assert_allclose(hist["models"], models, rtol=0,
                               atol=RTOL * np.abs(models).max())
    assert line["mean_model_max"] == pytest.approx(
        float(models.mean(0).max()), rel=1e-9)
    assert line["std_model_max"] == pytest.approx(
        float(models.std(0).max()), rel=1e-7)
    assert line["n_iters"] == [10, 10, 10]
    assert tensors["mw"].shape == (3, bs.msize)

    line, tensors, hist = out["map"]
    assert line["n_iters"] == 20 and line["problem"][0] == 36
    assert line["temperature"] == pytest.approx(2 * line["sigma_hat2"])
    assert tensors["dpre"].shape == (36,)


def test_southchina_geometry_is_the_examples(monkeypatch):
    """``cg.southchina`` and the stage's arguments are the ones
    ``examples/run.py bootstrap-southchina`` gives ``BootStrap``."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples"))
    import run as examples_run

    seen = {}

    class Stop(Exception):
        pass

    def fake(*args, **kwargs):
        seen.update(args=args, kwargs=kwargs)
        raise Stop

    monkeypatch.setattr(jr, "BootStrap", fake)
    args = type("Args", (), dict(samples=20, maxk=200, quiet=True))()
    with pytest.raises(Stop):
        examples_run.cmd_bootstrap_southchina(args)
    g, cfg = cg.southchina(), cg.SOUTHCHINA
    mrange, mspacing, obs, dobs, boundary = seen["args"]
    assert (mrange, mspacing, boundary) == (g["mrange"], g["mspacing"],
                                            cfg["boundary"])
    for a, b in zip(obs, g["obs"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(dobs, g["dobs"])
    kw = seen["kwargs"]
    for a, b in zip(kw.pop("mtopo"), (g["xo"], g["yo"], g["topo"])):
        np.testing.assert_array_equal(a, b)
    assert kw == dict(samples=cfg["samples"], beta=cfg["beta"],
                      maxk=cfg["maxk"], mratio=cfg["mratio"],
                      wavelet=cfg["wavelet"], verbose=False)


def test_southchina_reduced_matches_jax(reduced_run):
    """4 replicates of 30 iterations: the carved mesh (1,579 of 7 x 17 x
    17 cells, ``Awcp`` 289 x 1580), the first six data misfits of each
    replicate within ``SOUTHCHINA_RTOL`` of the JAX package's (the later
    ones part by rounding, as the JAX package's own do)."""
    line, tensors, hist = reduced_run["bootstrap_southchina"]
    g, cfg = cg.southchina(), cg.SOUTHCHINA
    bs = jr.BootStrap(g["mrange"], g["mspacing"], g["obs"], g["dobs"],
                      cfg["boundary"], samples=4, beta=cfg["beta"], maxk=30,
                      mratio=cfg["mratio"], wavelet=cfg["wavelet"],
                      verbose=False, mtopo=(g["xo"], g["yo"], g["topo"]))
    _, d_h, _, _ = bs.BSCG(np.zeros(bs.msize))
    assert line["mesh_shape"] == [7, 17, 17] == list(bs.mshape)
    assert line["carved_cells"] == 1579 == bs.msize
    assert line["Awcp"] == [[289, 1580], bs._mod.Awcp.nnz]
    assert line["finite"] and tensors["mw"].shape == (4, 1579)
    n = SOUTHCHINA_PREFIX
    np.testing.assert_allclose(hist["data_hist"][:, :n], d_h[:, :n],
                               rtol=SOUTHCHINA_RTOL)


@pytest.fixture(scope="module")
def realdata_modules():
    args, kw = _args(step=STEP)
    module, dobs = realdata.build_problem(device="cpu", step=STEP)
    return JModule(*args, **kw), module, dobs


def _temperature(dp, dobs):
    dz = np.asarray(dobs, np.float32)
    rr = (dp - dp.mean()) - (dz - dz.mean())
    return 2.0 * float((rr * rr).mean())


def test_map_temperature_matches_jax(realdata_modules):
    """The bounded MAP's T = 2 sigma_hat^2 on the same iterate (the last of
    four, float32) against the JAX ``cg_device`` + ``predict`` path; and
    the level set both packages' iterates lie on."""
    jm, tm, dobs = realdata_modules
    kw = dict(regularization="Damping", alpha=0.05)
    jo = jr.cg_device(jm, dobs, (-0.5, 0.5), dtype=jnp.float32, maxk=4,
                      keep_best=False, **kw)
    to = tr.cg_device(tm, dobs, (-0.5, 0.5), dtype=torch.float32, maxk=4,
                      keep_best=False, **kw)
    T_j = _temperature(np.asarray(jm.predict(jo["mw"])), dobs)
    T_t = _temperature(tm.predict(to["mw"]).numpy(), dobs)
    assert T_t == pytest.approx(T_j, rel=1e-4)
    D, M = tm.Aw.shape
    for o in (jr.cg_device(jm, dobs, (-0.5, 0.5), dtype=jnp.float64,
                           maxk=60, **kw),
              tr.cg_device(tm, dobs, (-0.5, 0.5), dtype=torch.float64,
                           maxk=60, **kw)):
        obj = D * o["data_hist"] + 0.05 * M * o["model_hist"]
        assert np.abs(obj / obj[0] - 1).max() < 1e-12
        # yet the iterates move: the data misfit changes by percents
        assert np.ptp(o["data_hist"]) > 1e-3 * o["data_hist"][0]


def _jax_chees(jm, dobs, T, C, nw, ns, key):
    """The tool's realdata ChEES in the JAX package, float32."""
    w = np.asarray(jm.wdiag)
    M = jm.n_active
    lf = 1000.0
    low, high = -0.5 * w, 0.5 * w
    jp = jm.make_potential(0.001 * w, low, high, constraint="logarithmic",
                           log_factor=lf, regularization="Damping",
                           beta=0.01, dtype=jnp.float32, jacobian=True,
                           temperature=T)
    with np.errstate(invalid="ignore", divide="ignore"):
        x0 = mw_to_logistic(
            np.clip(w * np.full(M, 0.01), low + 1e-9 * (high - low + 1e-30),
                    high - 1e-9 * (high - low + 1e-30)), low, high, lf)
    x0 = np.where(np.isfinite(x0), x0, 0.0)

    def jpot(x, P=None):
        u, g, _ = jp.fn(x, 0.05, jp.params)
        return u, g

    x0_b = jnp.asarray(np.tile(x0[None, :], (C, 1)), jnp.float32)
    return jax.jit(lambda x, k: jchees.run_chees(
        jpot, x, k, n_warmup=nw, n_samples=ns, step_size0=0.01))(x0_b, key)


def test_realdata_chees_matches_jax(realdata_modules):
    """The ``realdata`` sampler stage at a given T with the JAX runner's
    draws injected: the same trajectory lengths (mean L, gradient
    evaluations), the same accept decisions and step size."""
    jm, tm, dobs = realdata_modules
    C, nw, ns, T = 4, 3, 3, 800.0
    key = random.PRNGKey(100)
    xs_j, st_j = _jax_chees(jm, dobs, T, C, nw, ns, key)
    tlf.reset_launch_counts()
    line, tensors = samplers.run(
        ("realdata",), device="cpu", rd_problem=(tm, dobs),
        rd=dict(nchains=C, nwarmup=nw, nsamples=ns, temperature=T,
                draws=jax_draws(key, nw + ns, C, tm.n_active, False)))[
                    "realdata"]
    assert tlf.launch_counts()["draws"] == 0
    assert line["temperature"] == T and "map" not in line
    assert line["mean_L"] == pytest.approx(float(st_j["mean_L"]))
    assert line["grad_evals"] == int(C * np.sum(np.asarray(st_j["L"])))
    assert line["step_size"] == pytest.approx(float(st_j["step_size"]),
                                              rel=1e-5)
    xs_t = tensors["samples"].numpy()
    xs_j = np.asarray(xs_j)
    kept = (xs_j[1:] == xs_j[:-1]).all(-1)
    np.testing.assert_array_equal((xs_t[1:] == xs_t[:-1]).all(-1), kept)
    assert {"vs_baseline_ess", "rhat_max", "ess_median", "problem"} <= \
        set(line)
    assert line["problem"] == [36, tm.n_active]


def test_realdata_auto_temperature(realdata_modules):
    """``temperature="auto"`` takes T from the bounded MAP on the same
    module: the ``map`` stage's T, reported beside the line."""
    _, tm, dobs = realdata_modules
    T = cg.stage_map(torch.device("cpu"), cg.MAP, (tm, dobs))[0][
        "temperature"]
    line, _ = samplers.run(("realdata",), device="cpu",
                           rd_problem=(tm, dobs),
                           rd=dict(nchains=2, nwarmup=1, nsamples=4))[
                               "realdata"]
    assert line["temperature"] == T
    assert line["map"]["n_iters"] == 400
    assert np.isfinite([line["ess_median"], line["mean_accept"]]).all()


def test_entry_points_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        cg.run(("map",))
    with pytest.raises(RuntimeError):
        samplers.run(("realdata",))
    with pytest.raises(ValueError):
        cg.run(("bogus",), device="cpu")
