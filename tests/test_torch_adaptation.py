"""Warmup adaptation: the port's dual averaging, Welford moments, median
and ``HamiltonianMC.sample``'s windowed warmup against the JAX package's.

Dual averaging is host float64 maths on both sides and must agree bit
for bit. The sampler runs are fed the JAX sampler's own draws
(``jax_draws``, see ``test_torch_hmc.py``) and compared chunk by chunk
with the JAX sampler (``use_fused=False``, its XLA shared-L path): the
step size each chunk runs at, the chunks where the metric switches, the
storage base each chunk gets and every accept flag must be identical;
the inverse mass agrees within rtol 1e-5 (f32 moments of states that
differ by f32 rounding); the frozen step size is identical. Both of the
port's paths are held to it: the eager shared-L path and the fused
trajectory op (the realdata slice's, here through its plain versions).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravinv3dhmc_tpu.diagnostics import ess_jax
from gravinv3dhmc_tpu.inversion import hmc as jhmc
from gravinv3dhmc_tpu.inversion import nuts as jnuts
from gravinv3dhmc_tpu_torch.diagnostics import ess_torch, median
from gravinv3dhmc_tpu_torch.inversion import hmc as thmc
from gravinv3dhmc_tpu_torch.inversion import nuts as tnuts
from test_torch_hmc import _configure, jax_draws, torch_module  # noqa: F401

torch.set_num_threads(2)

INV_MASS_RTOL = 1e-5


def test_dual_averaging_bit_for_bit():
    rng = np.random.RandomState(0)
    for step0, target in ((0.005, 0.75), (1.3, 0.8), (2e-7, 0.05)):
        j = jnuts.dual_averaging_init(step0, target=target)
        t = tnuts.dual_averaging_init(step0, target=target)
        for _ in range(60):
            acc = float(np.float32(rng.uniform()))
            j = jnuts.dual_averaging_update(j, acc)
            t = tnuts.dual_averaging_update(t, acc)
            for k in ("log_eps", "log_eps_avg", "h_bar", "mu", "t"):
                assert t[k] == float(j[k]), k
            assert float(np.exp(t["log_eps"])) == float(np.exp(j["log_eps"]))


def test_welford_matches_jax():
    xs = np.random.RandomState(1).normal(2.0, 0.5, (40, 33)).astype(
        np.float32)
    j = jnuts.welford_init(33)
    j = {k: jnp.asarray(v, jnp.float32) for k, v in j.items()}
    t = tnuts.welford_init(33)
    for x in xs:
        j = jnuts.welford_update(j, jnp.asarray(x))
        t = tnuts.welford_update(t, torch.from_numpy(x))
    for k in ("mean", "m2", "count"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
    for reg in (True, False):
        np.testing.assert_array_equal(
            tnuts.welford_variance(t, reg).numpy(),
            np.asarray(jnuts.welford_variance(j, reg)))


@pytest.mark.parametrize("n", [1, 2, 127, 128, 10676])
def test_median_is_the_averaging_median(n):
    v = np.random.RandomState(n).lognormal(size=n).astype(np.float32)
    m = median(torch.from_numpy(v))
    assert m.dtype == torch.float32
    assert m.item() == float(jnp.median(jnp.asarray(v)))
    assert m.item() == pytest.approx(float(np.median(v)), rel=1e-7)
    if n % 2 == 0:
        assert m.item() != torch.median(torch.from_numpy(v)).item()
    assert median(torch.arange(128, dtype=torch.float32)).item() == 63.5


def _recording(mod, log, jax_style):
    """``mod.make_chunk_sampler`` whose chunk runner logs (chunk, dt,
    inv_mass, store_base, accept flags) of every chunk."""
    make = mod.make_chunk_sampler

    def wrapped(*a, **k):
        run = make(*a, **k)

        def run_chunk(carry, key, idx, *args, **kw):
            dt, im = (args[1], args[2]) if jax_style else (kw["dt"],
                                                           kw["inv_mass"])
            carry, stats = run(carry, key, idx, *args, **kw)
            log.append((idx, float(dt),
                        None if im is None else np.array(im, np.float32),
                        int(kw["store_base"]), np.asarray(stats[..., 0])))
            return carry, stats

        return run_chunk

    return wrapped


def _runs(small_module, torch_module, monkeypatch, path, seed=3, **adapt):
    jmod, dobs, _ = small_module
    jc = _configure(jhmc.HamiltonianMC(jmod), jmod, dobs)
    jc.use_fused = False
    tc = _configure(thmc.HamiltonianMC(torch_module), torch_module, dobs)
    tc.use_fused = path == "trajectory"
    tc.prefer_iteration_kernel = False
    tc.fused_matvec_dtype = torch.float32
    for c in (jc, tc):
        c.seed = seed
        for k, v in adapt.items():
            setattr(c, k, v)
    jlog, tlog = [], []
    monkeypatch.setattr(jhmc, "make_chunk_sampler",
                        _recording(jhmc, jlog, True))
    monkeypatch.setattr(thmc, "make_chunk_sampler",
                        _recording(thmc, tlog, False))
    res_j = jc.sample(16, 0)
    res_t = tc.sample(16, 0, draws=jax_draws(
        seed, tc.chunk_size, tc.nchains, torch_module.n_active))
    return res_j, res_t, jlog, tlog


def _check_chunks(jlog, tlog):
    assert [e[0] for e in tlog] == [e[0] for e in jlog]
    assert [e[1] for e in tlog] == [e[1] for e in jlog]      # dt
    assert [e[3] for e in tlog] == [e[3] for e in jlog]      # store base
    for a, b in zip(jlog, tlog):
        np.testing.assert_array_equal(b[4], a[4])            # accepts
        assert (a[2] is None) == (b[2] is None)
        if a[2] is not None:
            np.testing.assert_allclose(b[2], a[2], rtol=INV_MASS_RTOL)


def _switches(log):
    """The chunks that run under a new metric."""
    out, last = [], None
    for idx, _, im, _, _ in log:
        if im is not None and (last is None or not np.array_equal(im, last)):
            out.append(idx)
        last = im
    return out


@pytest.mark.parametrize("path", ["shared_L", "trajectory"])
def test_windowed_warmup_matches_jax(small_module, torch_module,
                                     monkeypatch, path):
    res_j, res_t, jlog, tlog = _runs(
        small_module, torch_module, monkeypatch, path,
        adapt_step_size=True, adapt_mass=True, adapt_chunks=8)
    _check_chunks(jlog, tlog)
    # W = 8: w1 = 1, slow windows ending at chunks 2, 4, 5, final window
    # of 3; the metric switches after those chunks
    assert thmc.warmup_schedule(8, True, True) == (8, 1, [2, 4, 5])
    assert _switches(tlog) == _switches(jlog) == [2, 4, 5]
    assert res_t["step_size"] == res_j["step_size"]
    assert res_t["adapted_mass"] and res_j["adapted_mass"]
    np.testing.assert_allclose(res_t["inv_mass"].numpy(), res_j["inv_mass"],
                               rtol=INV_MASS_RTOL)
    assert res_t["accepted"] == res_j["accepted"]
    assert res_t["attempted"] == res_j["attempted"]
    assert res_t["grad_evals"] == res_j["grad_evals"]
    # the accept rate moved, so dual averaging had work to do
    rates = [e[4].mean() for e in jlog]
    assert min(rates) < 0.5 < max(rates)
    if path == "trajectory":
        assert res_t["fused_mode"] == "trajectory(float32)"


@pytest.mark.parametrize("path", ["shared_L", "trajectory"])
def test_emergency_brake_matches_jax(small_module, torch_module,
                                     monkeypatch, path):
    """A target of 0.05 drives dual averaging to a dt that rejects every
    proposal once frozen; the brake halves dt, restarting the counters
    each time, until a chunk accepts more than a quarter of the target."""
    res_j, res_t, jlog, tlog = _runs(
        small_module, torch_module, monkeypatch, path,
        adapt_step_size=True, adapt_chunks=2, adapt_target=0.05)
    _check_chunks(jlog, tlog)
    dts = [e[1] for e in tlog]
    halvings = [i for i in range(3, len(dts)) if dts[i] == 0.5 * dts[i - 1]]
    assert len(halvings) >= 3
    assert res_t["step_size"] == res_j["step_size"] == dts[-1]
    assert not res_t["adapted_mass"] and res_t["inv_mass"] is None
    assert res_t["accepted"] == res_j["accepted"]
    assert res_t["attempted"] == res_j["attempted"]


@pytest.mark.parametrize("path", ["shared_L", "trajectory"])
def test_chunk_updates_moments_only_when_carried(torch_module, small_module,
                                                 path):
    """A carry with Welford moments gets them updated from every
    iteration's post-accept position (:func:`nuts.welford_update`, pads
    left out); a carry of 8 stays 8, and the chains move the same."""
    _, dobs, _ = small_module
    tc = _configure(thmc.HamiltonianMC(torch_module), torch_module, dobs)
    tc.use_fused = path == "trajectory"
    tc.prefer_iteration_kernel = False
    tc.fused_matvec_dtype = torch.float32
    tc.adapt_mass = True
    run_chunk, carry = tc.prepare(tc.chunk_size, 0)
    assert len(carry) == 11
    with_m, _ = run_chunk(carry, 3, 0, store_base=0)
    without, _ = run_chunk(carry[:8], 3, 0, store_base=0)
    assert len(with_m) == 11 and len(without) == 8
    for a, b in zip(with_m[:6], without[:6]):
        assert torch.equal(a, b)
    # chain-mode storage keeps every post-accept x (times wdiag_inv)
    w = torch.as_tensor(np.asarray(torch_module.wdiag), dtype=torch.float32)
    st = tnuts.welford_init(with_m[0].shape)
    for i in range(tc.chunk_size):
        st = tnuts.welford_update(st, with_m[6][:, i] * w)
    for got, want in zip(with_m[8:], (st["mean"], st["m2"], st["count"])):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert with_m[10].item() == tc.chunk_size


def test_frozen_chunks_carry_no_moments(small_module, torch_module,
                                        monkeypatch):
    """``sample()`` drops the Welford moments at the freeze: every warmup
    chunk gets a carry of 11, every frozen one a carry of 8."""
    _, dobs, _ = small_module
    tc = _configure(thmc.HamiltonianMC(torch_module), torch_module, dobs)
    tc.adapt_step_size = tc.adapt_mass = True
    tc.adapt_chunks = 8
    sizes = []
    make = thmc.make_chunk_sampler

    def recording(*a, **k):
        run = make(*a, **k)

        def run_chunk(carry, *args, **kw):
            sizes.append(len(carry))
            return run(carry, *args, **kw)

        return run_chunk

    monkeypatch.setattr(thmc, "make_chunk_sampler", recording)
    res = tc.sample(16, 0)
    assert res["adapted_mass"]
    assert sizes[:8] == [11] * 8 and len(sizes) > 8
    assert set(sizes[8:]) == {8}


def test_ess_median_is_jax_median_of_the_same_buffer(torch_module,
                                                     small_module):
    """``sample()``'s ``ess_median`` is the averaging median of the ESS of
    its own sample buffer's 128-cell subsample, as ``jnp.median`` takes
    it (the JAX sampler's on-device ESS)."""
    _, dobs, _ = small_module
    tc = _configure(thmc.HamiltonianMC(torch_module), torch_module, dobs)
    res = tc.sample(16, 0)
    M = torch_module.n_active
    sub = np.random.RandomState(0).choice(M, size=min(M, 128),
                                          replace=False)
    ess = ess_torch(res["samples"][:, :, torch.as_tensor(sub)])
    assert res["ess_median"] == float(jnp.median(jnp.asarray(ess.numpy())))
    # and the JAX on-device ESS of the same buffer agrees to f32 rounding
    ess_j = ess_jax(jnp.asarray(res["samples"].numpy()[:, :, sub]))
    assert res["ess_median"] == pytest.approx(float(jnp.median(ess_j)),
                                              rel=1e-4)
