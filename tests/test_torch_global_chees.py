"""The whole-Earth ChEES (``gravinv3dhmc_tpu_torch/global_chees.py``)
against ``tools/global_chees.py`` at scale 0.25 (496 observations x 4,500
tesseroids, both packages' device builders run on the CPU).

The tool's target, start and summary are written inside its ``main``, so
the JAX side here is what they call, with the tool's arguments: the JAX
module's ``make_potential`` (``tools/global_chees.py:81-87``), its
``mw_to_logistic`` (:92-97), the summary's formulas with ``ess_jax``
(:108-126, copied below in ``jnp``) and ``run_chees``. Both sides read
the port's matrix and weights (put into the JAX potential's params), so
they differ only in their arithmetic. The run is held as
``tests/test_torch_chees.py`` holds ``run_chees``: the JAX runner's own
draws injected, the same trajectory lengths and accept decisions.
"""
import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from gravinv3dhmc_tpu.diagnostics import ess_jax
from gravinv3dhmc_tpu.inversion import chees as jchees
from gravinv3dhmc_tpu.inversion.potential import GravMagModule as JModule
from gravinv3dhmc_tpu.inversion.potential import (logistic_to_mw as
                                                  j_logistic_to_mw)
from gravinv3dhmc_tpu.inversion.potential import (mw_to_logistic as
                                                  j_mw_to_logistic)
from gravinv3dhmc_tpu_torch import global_chees as GC
from gravinv3dhmc_tpu_torch import global_tess as G
from test_torch_chees import jax_draws

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = 0.25
RTOL, ESS_RTOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def problem():
    return G.build(SCALE, device="cpu")


@pytest.fixture(scope="module")
def jax_target(problem):
    """The tool's potential on a JAX module of the same geometry, its
    matrix and weights replaced by the port's; the tool's box and start."""
    wl, dpre, dobs, tm = problem
    jm = JModule(dobs, wl["mrange"], wl["mspacing"], wl["obs"],
                 kernel_device=True, verbose=False, **wl["mesh_kwargs"])
    wdiag = jnp.asarray(tm.wdiag.numpy())
    noise_sigma = 0.02 * np.abs(dpre).max()
    low, high = wdiag * 0.0, wdiag * 0.8
    pot = jm.make_potential(
        wdiag * 0.001, low, high, constraint="logarithmic",
        log_factor=1000.0, regularization="Damping", beta=0.01,
        dtype=jnp.float32, jacobian=True,
        temperature=float(2.0 * noise_sigma ** 2))
    params = dict(pot.params,
                  Aw=jnp.asarray(tm.device_arrays()["Aw"].numpy()),
                  wm_sq=wdiag * wdiag)
    eps_b = 1e-6
    mw0 = jnp.clip(wdiag * 0.1, low + eps_b * (high - low),
                   high - eps_b * (high - low))
    x0 = j_mw_to_logistic(mw0, low, high, 1000.0, xp=jnp)

    def pot_batch(x):
        u, g, _ = pot.fn(x, 5.0, params)
        return u, g

    return dict(pot_batch=pot_batch, x0=x0, low=low, high=high,
                wdiag=wdiag, params=params)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def test_start_matches_jax_mw_to_logistic(problem, jax_target):
    tm = problem[3]
    _, low, high, _, _ = GC.target(tm, problem[1])
    x0 = GC.start(tm.wdiag, low, high, 3)
    assert x0.shape == (3, tm.n_active) and x0.dtype == torch.float32
    assert torch.equal(x0[0], x0[2])
    assert rel(x0[0].numpy(), jax_target["x0"]) <= 1e-6


def test_potential_matches_jax(problem, jax_target):
    tm = problem[3]
    pot, _, _, noise_sigma, temperature = GC.target(tm, problem[1])
    assert noise_sigma == 0.02 * np.abs(problem[1]).max()
    assert temperature == 2.0 * noise_sigma ** 2
    rng = np.random.RandomState(0)
    x = (np.asarray(jax_target["x0"])[None, :]
         + 1e-3 * rng.randn(3, tm.n_active)).astype(np.float32)
    U_t, g_t, _ = pot(torch.from_numpy(x), GC.ALPHA)
    U_j, g_j = jax_target["pot_batch"](jnp.asarray(x))
    assert rel(U_t.numpy(), U_j) <= RTOL
    assert rel(g_t.numpy(), g_j) <= RTOL


def jax_summarize(xs, Aw, low, high, wdiag, dobs, truth, sub):
    """``tools/global_chees.py:108-126``."""
    low_b, high_b = low[None, None, :], high[None, None, :]
    mw = j_logistic_to_mw(xs, low_b, high_b, 1000.0)
    wdiag_inv = jnp.where(wdiag == 0, 0.0, 1.0 / jnp.where(wdiag == 0, 1.0,
                                                           wdiag))
    m = mw * wdiag_inv[None, None, :]
    mean_m = jnp.mean(m, axis=(0, 1))
    std_m = jnp.std(m, axis=(0, 1))
    dpre_mean = (mean_m * wdiag) @ Aw.T
    r = (dpre_mean - jnp.mean(dpre_mean)) - (dobs - jnp.mean(dobs))
    rmsd = jnp.sqrt(jnp.mean(r ** 2))
    rmsm = jnp.sqrt(jnp.mean((mean_m - truth) ** 2))
    corr = jnp.corrcoef(jnp.stack([mean_m, truth]))[0, 1]
    cov = jnp.mean(jnp.abs(mean_m - truth) <= 2.0 * std_m)
    amp = jnp.sqrt(jnp.mean(mean_m ** 2) / jnp.mean(truth ** 2))
    ess = ess_jax(jnp.transpose(m[:, :, sub], (1, 0, 2)))
    return (rmsd, rmsm, corr, cov, amp, jnp.median(ess), jnp.max(std_m))


def test_summarize_matches_the_tools_formulas(problem, jax_target):
    wl, dpre, dobs, tm = problem
    _, low, high, _, _ = GC.target(tm, dpre)
    M = tm.n_active
    rng = np.random.RandomState(1)
    # 16 draws of 4 chains around the start, correlated along the draws
    walk = np.cumsum(rng.randn(16, 4, M), axis=0) * 2e-4
    xs = (np.asarray(jax_target["x0"])[None, None, :] + walk
          + 1e-3 * rng.randn(1, 4, M)).astype(np.float32)
    sub = GC.subsample(M)
    np.testing.assert_array_equal(
        sub, np.random.RandomState(0).choice(M, size=128, replace=False))
    Aw = tm.device_arrays()["Aw"]
    got = GC.summarize(torch.from_numpy(xs), Aw, low, high, tm.wdiag,
                       tm.wdiag_inv, torch.as_tensor(dobs, dtype=torch.float32),
                       torch.as_tensor(wl["rho"], dtype=torch.float32), sub)
    want = jax_summarize(
        jnp.asarray(xs), jnp.asarray(Aw.numpy()), jax_target["low"],
        jax_target["high"], jax_target["wdiag"],
        jnp.asarray(dobs, jnp.float32), jnp.asarray(wl["rho"], jnp.float32),
        jnp.asarray(sub))
    names = ("RMSD", "RMSM", "corr", "coverage", "amplitude", "ess_median",
             "std_max")
    for name, g, w in zip(names, got, want):
        tol = ESS_RTOL if name == "ess_median" else RTOL
        assert rel(float(g), float(w)) <= tol, (name, float(g), float(w))
    # the population standard deviation (jnp.std), not torch's default
    assert 0.0 < float(got[3]) < 1.0


@pytest.fixture(scope="module")
def injected_runs(problem, jax_target):
    """A 2-chain, 4 + 4 run of each package with the JAX runner's draws."""
    C, M = 2, problem[3].n_active
    nw, ns, max_steps = 4, 4, 8
    key = random.PRNGKey(7)
    x0_b = jnp.broadcast_to(jax_target["x0"], (C, M)).astype(jnp.float32)
    xs_j, st_j = jax.jit(lambda x, k: jchees.run_chees(
        jax_target["pot_batch"], x, k, n_warmup=nw, n_samples=ns,
        step_size0=0.01, dtype=jnp.float32, max_steps=max_steps))(x0_b, key)
    line, xs_t = GC.run(nchains=C, nsamples=ns, nwarmup=nw,
                        max_steps=max_steps, problem=problem,
                        draws=jax_draws(key, nw + ns, C, M, False))
    return xs_j, st_j, line, xs_t


def test_injected_draws_give_the_jax_run(injected_runs):
    xs_j, st_j, line, xs_t = injected_runs
    xs_j = np.asarray(xs_j)
    assert xs_t.shape == xs_j.shape

    def kept(a):
        return (a[1:] == a[:-1]).all(-1)

    np.testing.assert_array_equal(kept(xs_t.numpy()), kept(xs_j))
    assert line["mean_L"] == float(np.mean(np.asarray(st_j["L"])))
    assert line["grad_evals"] == 2 * int(np.sum(np.asarray(st_j["L"])))
    assert line["step_size"] == pytest.approx(float(st_j["step_size"]),
                                              rel=RTOL)
    assert line["trajectory_time"] == pytest.approx(
        float(st_j["trajectory_time"]), rel=RTOL)
    assert line["accept_mean"] == pytest.approx(
        float(np.mean(np.asarray(st_j["accept"]))), abs=1e-4)
    assert line["max_steps_saturated"] == float(
        st_j["max_steps_saturated"])


def _tool_keys():
    """The keys of the tool's ``res``, from its source."""
    with open(os.path.join(REPO, "tools", "global_chees.py")) as f:
        tree = ast.parse(f.read())
    keys = set()
    for n in ast.walk(tree):
        if not isinstance(n, ast.Assign):
            continue
        t = n.targets[0]
        if isinstance(t, ast.Name) and t.id == "res" \
                and isinstance(n.value, ast.Dict):
            keys |= {k.value for k in n.value.keys}
        elif isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name) \
                and t.value.id == "res":
            keys.add(t.slice.value)
    return keys


def test_line_keys_are_the_tools(injected_runs):
    line = injected_runs[2]
    keys = _tool_keys()
    assert {"ess_per_s_median", "max_steps_saturated", "grad_evals"} <= keys
    assert set(line) == keys
    assert line["device"] == "cpu" and line["problem"] == [496, 4500]
    assert line["compile_s"] == 0.0 and line["chunk_iters"] is None
    assert all(np.isfinite(v) for v in line.values()
               if isinstance(v, float))


def test_chunked_counts_round_up(problem):
    """``--chunk``: the warmup and sample counts rounded up to whole
    blocks, as the JAX chunked runner rounds them (3 -> 4, 5 -> 8)."""
    line, xs = GC.run(nchains=2, nsamples=5, nwarmup=3, max_steps=2,
                      chunk=4, problem=problem)
    assert (line["nwarmup"], line["nsamples"]) == (4, 8)
    assert line["chunk_iters"] == 4 and xs.shape[:2] == (8, 2)
