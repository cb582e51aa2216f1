"""ChEES-HMC: the port's runner against the JAX package's ``run_chees``
and ``run_chees_chunked`` with the JAX runners' own draws injected.

For iteration ``it`` the JAX runners draw ``kp, ka = split(k)``,
``normal(kp, (C, M))`` and ``uniform(ka, (C,))``, with ``k = split(key,
n)[it]`` one-shot and ``fold_in(key, it)`` chunked; the tests rebuild
them and feed them to the port's draw source. Then every trajectory
length is identical, so are the accept decisions (a chain's sample is
bit-equal to its previous one exactly when it rejected), and the
positions, the adapted step size and trajectory time agree within rtol
1e-5 (f32 sums over chains and cells in other orders), the accept rates
within rtol 1e-5 on the Gaussian and 1e-4 absolute on the inversion,
whose U of ~1,200 carries f32 steps of 1.2e-4 into exp(-dH).

The inversion target (the small module under the logistic transform with
its Jacobian, k = 100) is stiff: along a trajectory the last-bit
differences of the two potentials grow, to 3e-4 of max|x| after 16
steps at the step sizes dual averaging picks from 0.01. So the continuous
values are held on short trajectories (``max_steps`` 8, from 0.003), and
the long ones (``inversion_long``) are held to identical lengths and
accept decisions only. ``_halton`` and ``adam_update`` (float32) are
bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from gravinv3dhmc_tpu.inversion import chees as jchees
from gravinv3dhmc_tpu_torch.inversion import chees as tchees
from test_torch_hmc import torch_module  # noqa: F401

torch.set_num_threads(2)

RTOL = 1e-5


def jax_draws(key, n, C, M, chunked):
    keys = None if chunked else random.split(key, n)

    def draws(it):
        k = random.fold_in(key, it) if chunked else keys[it]
        kp, ka = random.split(k)
        return (np.array(random.normal(kp, (C, M), jnp.float32)),
                np.array(random.uniform(ka, (C,), jnp.float32)))

    return draws


def test_halton_bit_for_bit():
    its = np.arange(70000, dtype=np.int32)
    np.testing.assert_array_equal(tchees._halton(torch.from_numpy(its)).numpy(),
                                  np.asarray(jchees._halton(jnp.asarray(its))))
    assert tchees._halton(0).item() == 0.5


def test_adam_update_bit_for_bit():
    rng = np.random.RandomState(0)
    j = {k: jnp.asarray(v, jnp.float32)
         for k, v in jchees.adam_init(np.log(0.3)).items()}
    t = tchees.adam_init(np.log(0.3))
    for _ in range(400):
        gr = np.float32(rng.uniform(-1, 1))
        j = jchees.adam_update(j, jnp.float32(gr))
        t = tchees.adam_update(t, torch.tensor(gr))
        for k in j:
            assert np.float32(j[k]).tobytes() == t[k].numpy().tobytes(), k


def _gaussian():
    prec = np.float32(1.0 / np.linspace(1.0, 3.0, 6) ** 2)
    pj, pt = jnp.asarray(prec), torch.from_numpy(prec)

    def jpot(x, P=None):
        return 0.5 * jnp.sum(pj * x * x, axis=-1), pj * x

    def tpot(x):
        return 0.5 * (pt * x * x).sum(-1), pt * x

    x0 = np.random.RandomState(3).normal(0, 0.3, (8, 6)).astype(np.float32)
    return jpot, tpot, x0, 0.2


def _inversion(small_module, torch_module):
    jmod, dobs, _ = small_module
    M = jmod.n_active
    w = np.asarray(jmod.wdiag)
    args = (0.001 * w, 0.0 * w, 1.0 * w)
    kw = dict(constraint="logarithmic", log_factor=100.0,
              regularization="Damping", beta=0.01, jacobian=True)
    jp = jmod.make_potential(*args, dtype=jnp.float32, **kw)
    tp = torch_module.make_potential(*args, **kw)

    def jpot(x, P=None):
        u, g, _ = jp.fn(x, 1.0, jp.params)
        return u, g

    def tpot(x):
        u, g, _ = tp(x, 1.0)
        return u, g

    x0 = (np.log(0.001 / 0.999) / 100.0
          + 0.01 * np.random.RandomState(4).randn(8, M)).astype(np.float32)
    return jpot, tpot, x0, 0.003


#: per target: (max_steps, step_size0, continuous values checked,
#: accept-rate tolerance (rtol, atol))
CASES = {"gaussian": (64, 0.2, True, (RTOL, 0)),
         "inversion": (8, 0.003, True, (0, 1e-4)),
         "inversion_long": (16, 0.01, False, None)}


def _target(target, small_module, torch_module):
    if target == "gaussian":
        return _gaussian()[:3]
    return _inversion(small_module, torch_module)[:3]


def _same_decisions(xs_j, xs_t):
    """Accept flags from the samples: a rejecting chain keeps its position
    bit for bit."""
    def kept(a):
        return (a[1:] == a[:-1]).all(-1)
    np.testing.assert_array_equal(kept(xs_t), kept(xs_j))
    assert kept(xs_j).any() and not kept(xs_j).all()


def _compare(xs_j, st_j, xs_t, st_t, continuous, acc_tol):
    np.testing.assert_array_equal(st_t["warm_L"].numpy(),
                                  np.asarray(st_j["warm_L"]))
    np.testing.assert_array_equal(st_t["L"].numpy(), np.asarray(st_j["L"]))
    xs_j = np.asarray(xs_j)
    xs_t = xs_t.numpy()
    _same_decisions(xs_j, xs_t)
    if not continuous:
        return
    np.testing.assert_allclose(xs_t, xs_j, rtol=0,
                               atol=RTOL * np.abs(xs_j).max())
    np.testing.assert_allclose(st_t["warm_T"].numpy(),
                               np.asarray(st_j["warm_T"]), rtol=RTOL)
    for k in ("warm_accept", "accept"):
        np.testing.assert_allclose(st_t[k].numpy(), np.asarray(st_j[k]),
                                   rtol=acc_tol[0], atol=acc_tol[1])
    for k in ("step_size", "trajectory_time"):
        assert float(st_t[k]) == pytest.approx(float(st_j[k]), rel=RTOL), k


@pytest.mark.parametrize("target", list(CASES))
def test_run_chees_matches_jax(target, small_module, torch_module):
    jpot, tpot, x0 = _target(target, small_module, torch_module)
    max_steps, step0, continuous, acc_tol = CASES[target]
    C, M = x0.shape
    nw, ns = 6, 6
    key = random.PRNGKey(11)
    kw = dict(n_warmup=nw, n_samples=ns, step_size0=step0,
              max_steps=max_steps)
    xs_j, st_j = jax.jit(lambda x, k: jchees.run_chees(jpot, x, k, **kw))(
        jnp.asarray(x0), key)
    xs_t, st_t = tchees.run_chees(
        tpot, torch.from_numpy(x0),
        draws=jax_draws(key, nw + ns, C, M, False), **kw)
    _compare(xs_j, st_j, xs_t, st_t, continuous, acc_tol)
    assert xs_t.shape == (ns, C, M)


@pytest.mark.parametrize("target", list(CASES))
def test_chunked_runner_matches_jax(target, small_module, torch_module):
    """The chunked schedule: counts rounded up to whole blocks (3 -> 4,
    5 -> 6),
    draws keyed ``fold_in(key, it)``; the block summaries are the
    per-iteration series' means."""
    jpot, tpot, x0 = _target(target, small_module, torch_module)
    max_steps, step0, continuous, acc_tol = CASES[target]
    C, M = x0.shape
    key = random.PRNGKey(12)
    kw = dict(n_warmup=3, n_samples=5, chunk_iters=2, step_size0=step0,
              max_steps=max_steps)
    buf_j, st_j = jchees.run_chees_chunked(jpot, jnp.asarray(x0), key,
                                           pot_params=None, **kw)
    xs_t, st_t = tchees.run_chees(tpot, torch.from_numpy(x0),
                                  draws=jax_draws(key, 10, C, M, True), **kw)
    assert st_t["n_warmup"] == st_j["n_warmup"] == 4
    assert st_t["n_samples"] == st_j["n_samples"] == 6
    assert xs_t.shape == np.asarray(buf_j).shape
    np.testing.assert_allclose(st_t["block_mean_L"].numpy(),
                               np.asarray(st_j["L"]), rtol=0)
    assert st_t["mean_L"] == pytest.approx(st_j["mean_L"], rel=1e-12)
    xs_j = np.asarray(buf_j)
    _same_decisions(xs_j, xs_t.numpy())
    if not continuous:
        return
    np.testing.assert_allclose(st_t["block_accept"].numpy(),
                               np.asarray(st_j["accept"]), rtol=acc_tol[0],
                               atol=acc_tol[1])
    np.testing.assert_allclose(xs_t.numpy(), xs_j, rtol=0,
                               atol=RTOL * np.abs(xs_j).max())
    for k in ("step_size", "trajectory_time"):
        assert float(st_t[k]) == pytest.approx(float(st_j[k]), rel=RTOL), k


def test_chees_gaussian_moments_and_adaptation():
    """As the JAX package's own test: an anisotropic Gaussian (scales 1-4)
    sampled with the Philox draws; ChEES picks a trajectory time near the
    long scale and the moments are right."""
    scales = np.linspace(1.0, 4.0, 8)
    prec = torch.tensor(1.0 / scales ** 2, dtype=torch.float32)

    def pot(x):
        return 0.5 * (prec * x * x).sum(-1), prec * x

    gen = torch.Generator().manual_seed(0)
    x0 = 0.1 * torch.randn((64, 8), generator=gen)
    xs, stats = tchees.run_chees(pot, x0, n_warmup=300, n_samples=400,
                                 step_size0=0.2, seed=1)
    xs = xs.numpy()
    assert np.isfinite(xs).all()
    assert 0.5 < float(stats["accept"].mean()) <= 1.0
    assert 1.0 < float(stats["trajectory_time"]) < 40.0
    assert len(np.unique(stats["L"].numpy())) > 1
    flat = xs.reshape(-1, 8)
    np.testing.assert_allclose(flat.mean(0), np.zeros(8), atol=0.35)
    np.testing.assert_allclose(flat.std(0), scales, rtol=0.25)
    assert stats["state"]["x"].shape == (64, 8)
    assert stats["state"]["dual_averaging"]["log_eps"].dtype == torch.float32
