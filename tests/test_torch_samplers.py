"""The adaptive samplers as a user calls them: ``CheesSample`` and
``NUTSSample`` against the JAX package's on ``small_module``, and
``samplers.run()`` end to end at a reduced size, on the CPU.

The port draws its own random numbers (Philox and a ``torch.Generator``),
so the two packages' runs agree within Monte Carlo error only: the
posterior means correlate above 0.95 across cells (0.99 seen), the mean
posterior std and the adapted step size within 10 % and 30 %, the mean
accept rate within 0.1; each run also passes the JAX package's own tests
of these samplers (``tests/test_chees.py``, ``tests/test_nuts.py``): the
samples finite and in the box, the accept rate in (0.2, 1], the mean
correlated with the truth above 0.2.
"""
import json

import numpy as np
import pytest
import torch

from gravinv3dhmc_tpu.inversion import chees as jchees
from gravinv3dhmc_tpu.inversion import nuts as jnuts
from gravinv3dhmc_tpu_torch import samplers, uniformgrid
from gravinv3dhmc_tpu_torch.inversion import chees as tchees
from gravinv3dhmc_tpu_torch.inversion import nuts as tnuts
from gravinv3dhmc_tpu_torch.ops import leapfrog as tlf
from test_torch_hmc import torch_module  # noqa: F401

torch.set_num_threads(2)


def _kw(small_module):
    _, dobs, _ = small_module
    M = small_module[0].n_active
    return dict(nsamples=60, nwarmup=80, initial_model=np.full(M, 0.001),
                aprior_model=np.full(M, 0.001),
                boundaries=np.column_stack([np.zeros(M), np.ones(M)]),
                dobs=dobs, RegulFactor=1.0, regularization="Damping", seed=7,
                log_factor=100.0, step_size0=0.05, verbose=False,
                temperature=0.1)


def _same_posterior(res_j, res_t, truth):
    sj = np.asarray(res_j["samples"])
    st = res_t["samples"].numpy()
    assert st.shape == sj.shape
    assert np.isfinite(st).all()
    assert st.min() >= -1e-6 and st.max() <= 1.0 + 1e-6
    assert 0.2 < res_t["mean_accept"] <= 1.0
    mj, mt = sj.mean((0, 1)), st.mean((0, 1))
    assert np.corrcoef(mt, truth)[0, 1] > 0.2
    assert np.corrcoef(mt, mj)[0, 1] > 0.95
    assert st.std((0, 1)).mean() == pytest.approx(sj.std((0, 1)).mean(),
                                                  rel=0.1)
    assert abs(res_t["mean_accept"] - res_j["mean_accept"]) < 0.1
    assert float(torch.as_tensor(res_t["step_size"]).mean()) == \
        pytest.approx(float(np.mean(res_j["step_size"])), rel=0.3)


def test_chees_sample_matches_jax(small_module, torch_module):
    jmod, _, truth = small_module
    kw = _kw(small_module)
    res_j = jchees.CheesSample(jmod, nchains=8, **kw)
    res_t = tchees.CheesSample(torch_module, nchains=8, device="cpu", **kw)
    _same_posterior(res_j, res_t, truth)
    assert res_t["trajectory_time"] > 0
    # warmup's trajectories are counted, one L an iteration
    assert res_t["grad_evals"] > int(res_t["L"].sum())


def test_chunked_chees_sample_keeps_its_lengths(small_module, torch_module):
    """``chunk_iters``: 60 draws in 3 blocks of 20; unlike the JAX
    package's chunked mode, L is the per-iteration series (not the
    constant mean) and ``grad_evals`` counts the warmup too."""
    kw = dict(_kw(small_module), nsamples=50, nwarmup=30)
    res = tchees.CheesSample(torch_module, nchains=8, device="cpu",
                             chunk_iters=20, **kw)
    assert res["samples"].shape[1] == 60
    assert len(torch.unique(res["L"])) > 1
    assert res["mean_L"] == pytest.approx(float(res["L"].double().mean()))
    assert res["grad_evals"] > int(res["L"].sum())
    assert 0 <= res["max_steps_saturated"] <= 1.0


def test_nuts_sample_matches_jax(small_module, torch_module):
    jmod, _, truth = small_module
    kw = _kw(small_module)
    res_j = jnuts.NUTSSample(jmod, nchains=4, max_depth=5, **kw)
    res_t = tnuts.NUTSSample(torch_module, nchains=4, max_depth=5,
                             device="cpu", **kw)
    _same_posterior(res_j, res_t, truth)
    assert res_t["divergences"] < 0.2 * 4 * 60
    assert res_t["inv_mass"].shape == (4, small_module[0].n_active)
    # the leaves the trees ran, at most 2^depth - 1 each
    assert 0 < res_t["grad_evals"] <= 4 * 60 * (2 ** 5 - 1)


TOOL_KEYS = {"total_s", "ess_min", "ess_median", "ess_per_total_s_median",
             "rhat_max", "mean_accept", "step_size", "grad_evals",
             "grad_evals_per_total_s"}


def test_run_end_to_end_reduced():
    """``samplers.run()`` on a 48-observation, 192-cell problem: every
    sampler's line has the tool's keys (NUTS also ``mean_depth`` and
    ``divergences``) and is JSON; the tensors stay where the run ran; the
    honest HMC run takes the eager path with one L a chain and draws with
    the ``draws`` kernel's plain version here (no launch on the CPU)."""
    problem = uniformgrid.build_problem(6, 8, 4, device="cpu")
    tlf.reset_launch_counts()
    out = samplers.run(device="cpu", problem=problem, nchains=4,
                       nsamples=12, nwarmup=12, max_depth=4,
                       hmc=dict(nchains=8, chunk=4, nsamples=8))
    assert set(out) == {"nuts", "chees", "hmc"}
    assert tlf.launch_counts()["draws"] == 0
    for name, (line, tensors) in out.items():
        assert TOOL_KEYS <= set(line), name
        assert json.loads(json.dumps(line)) == line
        assert line["sampler"] == name
        assert all(np.isfinite(line[k]) for k in TOOL_KEYS), name
        assert line["grad_evals"] > 0 and 0 < line["mean_accept"] <= 1
        for v in tensors.values():
            assert v.device.type == "cpu"
    assert {"mean_depth", "divergences"} <= set(out["nuts"][0])
    assert out["chees"][1]["samples"].shape == (4, 12, 192)
    hmc = out["hmc"][0]
    assert hmc["fused_mode"] == "off" and hmc["adapted_mass"]
    assert hmc["temperature"] == pytest.approx(
        2 * problem[0].noise_sigma ** 2)
    with pytest.raises(ValueError):
        samplers.run(("bogus",), device="cpu", problem=problem)


def test_entry_point_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        samplers.run(("nuts",))
