"""Checkpoint and resume in the port: ``checkpoint.py`` and
``HamiltonianMC.sample(checkpoint_path=...)`` against the JAX package's
(``tests/test_checkpoint.py``'s problem and chain).

A resumed run must equal the uninterrupted one bit for bit on the CPU
(the port's draws depend only on (seed, chunk index)); with the JAX
draws injected a JAX snapshot resumed in the port must follow the JAX
package's own resumed run to the sample tolerance of
``tests/test_torch_hmc.py`` (rtol 5e-3, atol 5e-4: f32 rounding, the
same accept decisions). Under warmup adaptation the port's snapshot also
stores the frozen kernel, so that its resumed run keeps it; the JAX
package's snapshot lacks it (its resumed adaptive run re-adapts and never
freezes again), and the port refuses such a file.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import random

from gravinv3dhmc_tpu import checkpoint as jckpt
from gravinv3dhmc_tpu import mesher, utils
from gravinv3dhmc_tpu.inversion import hmc as jhmc
from gravinv3dhmc_tpu.inversion.potential import GravMagModule as JModule
from gravinv3dhmc_tpu.ops import prism
from gravinv3dhmc_tpu_torch import checkpoint as tckpt
from gravinv3dhmc_tpu_torch.inversion import hmc as thmc
from gravinv3dhmc_tpu_torch.inversion.potential import GravMagModule
from test_torch_hmc import jax_draws

torch.set_num_threads(2)

BOUNDS = (0, 500, 0, 500, 0, 300)
SPACING = (100, 100, 100)


@pytest.fixture(scope="module")
def problem():
    mesh = mesher.PrismMesh(BOUNDS, SPACING)
    rho3 = np.zeros(mesh.shape)
    rho3[0:2, 1:4, 1:4] = 1.0
    mesh.addprop("density", rho3.ravel())
    obs = utils.regular((0, 500, 0, 500), (5, 5), z=0.0)
    dobs, _ = prism.gz(*obs, mesh)
    return (JModule(dobs, BOUNDS, SPACING, obs, verbose=False),
            GravMagModule(dobs, BOUNDS, SPACING, obs, verbose=False,
                          device="cpu"), dobs)


def _chain(cls, module, dobs, **kw):
    """``tests/test_checkpoint.py``'s chain in either package."""
    M = module.n_active
    chain = cls(module)
    chain.dt = 0.01
    chain.Lrange = [3, 8]
    chain.Sigma = 0.001
    chain.seed = 7
    chain.RegulFactor = 1.0
    chain.regularization = "Damping"
    chain.nchains = 2
    chain.chunk_size = 8
    chain.verbose = False
    chain.write_files = False
    wdiag = np.asarray(module.wdiag)
    chain.low = wdiag * np.zeros(M)
    chain.high = wdiag * np.ones(M)
    chain.initial_model = wdiag * np.full(M, 0.001)
    chain.aprior_model = wdiag * np.full(M, 0.001)
    chain.dobs = dobs
    if cls is thmc.HamiltonianMC:
        chain.device = "cpu"
    for k, v in kw.items():
        setattr(chain, k, v)
    return chain


def _same_run(a, b):
    for key in ("samples", "misfits", "x"):
        assert torch.equal(a[key], b[key]), key
    assert a["accepted"] == b["accepted"]
    np.testing.assert_array_equal(a["n_stored"], b["n_stored"])


@pytest.mark.parametrize("kw", [
    dict(), dict(use_fused=True, fused_matvec_dtype=torch.float32),
    dict(use_fused=True, store_mode="chain")])
def test_resume_is_exact_continuation(problem, tmp_path, kw):
    """``test_checkpoint.py::test_resume_is_exact_continuation`` in the
    port, on the eager path and the fused iteration op (f32 and bf16
    matrix, whose chunk pads x and g): bit for bit."""
    _, module, dobs = problem
    ckpt = str(tmp_path / "state.npz")
    full = _chain(thmc.HamiltonianMC, module, dobs, **kw).sample(64, 0)
    part = _chain(thmc.HamiltonianMC, module, dobs, **kw).sample(
        64, 0, max_chunks=3, checkpoint_path=ckpt, checkpoint_every=1)
    assert part["accepted"] != full["accepted"]  # interrupted
    _, n_chunks, _, meta = tckpt.load_state(ckpt)
    assert n_chunks == 3 and meta["store_iters"] == 24
    resumed = _chain(thmc.HamiltonianMC, module, dobs, **kw).sample(
        64, 0, checkpoint_path=ckpt)
    _same_run(resumed, full)


def test_checkpoint_config_mismatch_raises(problem, tmp_path):
    _, module, dobs = problem
    ckpt = str(tmp_path / "state2.npz")
    _chain(thmc.HamiltonianMC, module, dobs).sample(
        16, 0, max_chunks=1, checkpoint_path=ckpt, checkpoint_every=1)
    other = _chain(thmc.HamiltonianMC, module, dobs, seed=99)
    with pytest.raises(ValueError, match="mismatch"):
        other.sample(16, 0, checkpoint_path=ckpt)


ADAPT = [dict(adapt_step_size=True, adapt_chunks=2),
         dict(adapt_step_size=True, adapt_mass=True, adapt_chunks=8)]


@pytest.mark.parametrize("kw", ADAPT)
def test_adaptive_resume_keeps_the_frozen_kernel(problem, tmp_path, capsys,
                                                 kw):
    """Checkpointed after the freeze and resumed: the frozen dt and metric,
    the samples and the counts equal the uninterrupted run's, and the run
    stops without the ``max_chunks`` warning (the JAX package's resumed run
    re-adapts until ``max_chunks``)."""
    _, module, dobs = problem
    W = thmc.warmup_schedule(kw["adapt_chunks"], True,
                             kw.get("adapt_mass", False))[0]
    ckpt = str(tmp_path / "adapt.npz")
    full = _chain(thmc.HamiltonianMC, module, dobs, **kw).sample(64, 0)
    part = _chain(thmc.HamiltonianMC, module, dobs, **kw).sample(
        64, 0, max_chunks=W + 2, checkpoint_path=ckpt, checkpoint_every=1)
    capsys.readouterr()
    extra = tckpt.load_extra(ckpt)
    assert bool(extra["frozen"])
    assert float(extra["step_size"]) == part["step_size"] == \
        full["step_size"]
    resumed = _chain(thmc.HamiltonianMC, module, dobs, **kw).sample(
        64, 0, checkpoint_path=ckpt)
    assert "WARNING" not in capsys.readouterr().out
    assert resumed["step_size"] == full["step_size"] != 0.01
    if kw.get("adapt_mass"):
        assert torch.equal(resumed["inv_mass"], full["inv_mass"])
        # the JAX layout: 8 leaves and the (zeroed) Welford moments
        assert len(tckpt.load_state(ckpt)[0]) == 11
    else:
        assert resumed["inv_mass"] is None
    _same_run(resumed, full)
    assert min(full["accepted"]) >= 64


@pytest.mark.parametrize("kw", ADAPT)
def test_snapshot_without_frozen_kernel_refused(problem, tmp_path, kw):
    """A JAX adaptive snapshot (no frozen kernel) and a port snapshot taken
    during the warmup are refused with a ``ValueError``."""
    jmodule, module, dobs = problem
    W = thmc.warmup_schedule(kw["adapt_chunks"], True,
                             kw.get("adapt_mass", False))[0]
    jpath = str(tmp_path / "jax.npz")
    _chain(jhmc.HamiltonianMC, jmodule, dobs, **kw).sample(
        64, 0, max_chunks=W + 2, checkpoint_path=jpath, checkpoint_every=1)
    with pytest.raises(ValueError, match="no frozen kernel"):
        _chain(thmc.HamiltonianMC, module, dobs, **kw).sample(
            64, 0, checkpoint_path=jpath)
    tpath = str(tmp_path / "warmup.npz")
    _chain(thmc.HamiltonianMC, module, dobs, **kw).sample(
        64, 0, max_chunks=W - 1, checkpoint_path=tpath)
    with pytest.raises(ValueError, match="during the warmup"):
        _chain(thmc.HamiltonianMC, module, dobs, **kw).sample(
            64, 0, checkpoint_path=tpath)


@pytest.mark.parametrize("adapt_mass", [False, True])
def test_snapshots_load_in_both_packages(problem, tmp_path, adapt_mass):
    """A JAX snapshot loads in the port with its leaves bit for bit, and a
    port snapshot in JAX ``load_state(like_carry=...)``: the same keys,
    leaf count and dtypes, and the port's ``base_key`` (its Philox salt
    words) wraps as a JAX key."""
    jmodule, module, dobs = problem
    kw = dict(adapt_step_size=adapt_mass, adapt_mass=adapt_mass,
              adapt_chunks=8)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    _chain(jhmc.HamiltonianMC, jmodule, dobs, **kw).sample(
        16, 0, max_chunks=9 if adapt_mass else 2, checkpoint_path=jpath)
    _chain(thmc.HamiltonianMC, module, dobs, **kw).sample(
        16, 0, max_chunks=9 if adapt_mass else 2, checkpoint_path=tpath)
    jleaves, jn, _, jmeta = jckpt.load_state(jpath)
    _, tcarry0 = _chain(thmc.HamiltonianMC, module, dobs, **kw).prepare(
        16, 0)
    tleaves, tn, _, tmeta = tckpt.load_state(jpath, like_carry=tcarry0)
    assert (tn, tmeta) == (jn, jmeta)
    assert len(tleaves) == len(jleaves) == (11 if adapt_mass else 8)
    for t, j in zip(tleaves, jleaves):
        j = np.asarray(j)
        assert t.numpy().dtype == j.dtype
        np.testing.assert_array_equal(t.numpy(), j)
    like = tuple(jnp.zeros(t.shape, t.numpy().dtype) for t in tleaves)
    back, n, key, meta = jckpt.load_state(tpath, like_carry=like)
    tback, tn2, salt, tmeta2 = tckpt.load_state(tpath)
    assert (n, meta) == (tn2, tmeta2)
    assert meta == jmeta
    assert tuple(int(w) for w in random.key_data(key)) == salt
    for b, t in zip(back, tback):
        assert np.asarray(b).dtype == t.numpy().dtype
        np.testing.assert_array_equal(np.asarray(b), t.numpy())


def test_jax_snapshot_resumed_in_port(problem, tmp_path):
    """A JAX run checkpointed at chunk 3 and resumed in the port with the
    JAX draws follows the JAX package's own resumed run."""
    jmodule, module, dobs = problem
    ckpt = str(tmp_path / "jax3.npz")
    _chain(jhmc.HamiltonianMC, jmodule, dobs).sample(
        64, 0, max_chunks=3, checkpoint_path=ckpt, checkpoint_every=1)
    tpath = str(tmp_path / "copy.npz")
    with open(ckpt, "rb") as src, open(tpath, "wb") as dst:
        dst.write(src.read())
    res_j = _chain(jhmc.HamiltonianMC, jmodule, dobs).sample(
        64, 0, checkpoint_path=ckpt)
    res_t = _chain(thmc.HamiltonianMC, module, dobs).sample(
        64, 0, checkpoint_path=tpath,
        draws=jax_draws(7, 8, 2, module.n_active, per_chain=True))
    assert res_t["accepted"] == res_j["accepted"]
    assert res_t["attempted"] == res_j["attempted"]
    np.testing.assert_array_equal(res_t["n_stored"], res_j["n_stored"])
    np.testing.assert_allclose(res_t["samples"].numpy(), res_j["samples"],
                               rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(res_t["misfits"].numpy()[..., 0],
                               res_j["misfits"][..., 0], rtol=1e-3)


def test_save_state_is_atomic_and_keeps_extra_keys_apart(tmp_path):
    """``save_state`` leaves no ``.tmp.npz`` behind and refuses an extra
    key that would shadow the layout's."""
    path = str(tmp_path / "s.npz")
    carry = (torch.arange(6.0).reshape(2, 3),
             torch.zeros(2, dtype=torch.int32))
    tckpt.save_state(path, carry, 4, (1, 2), meta={"a": 1},
                     extra={"step_size": 0.5})
    assert sorted(p.name for p in tmp_path.iterdir()) == ["s.npz"]
    assert tckpt.load_extra(path) == {"step_size": 0.5}
    leaves, n, key, meta = tckpt.load_state(path)
    assert (n, key, meta) == (4, (1, 2), {"a": 1})
    assert torch.equal(leaves[0], carry[0])
    with pytest.raises(ValueError, match="leaves"):
        tckpt.load_state(path, like_carry=carry[:1])
    for bad in ("meta", "leaf_0"):
        with pytest.raises(ValueError, match="layout"):
            tckpt.save_state(path, carry, 4, (1, 2), extra={bad: 1})
