"""Files a user gets from the port, against the JAX package's: the sample
files of ``HamiltonianMC.sample(write_files=True)`` and of ``HMCSample``,
``sample(callback=)``, the ``save_folder`` of ``CheesSample`` and
``NUTSSample``, and ``GravMagModule``'s kernel disk cache.

With the JAX draws injected (``tests/test_torch_hmc.py``'s ``jax_draws``)
both samplers take the same accept decisions, so their files have the
same folders and line counts and values within that file's sample
tolerance (rtol 5e-3, atol 5e-4). A file holds the ``%.8f`` rounding of
the f32 sample cast to f64: within 5e-9 of the returned samples (plus
f64's spacing at their size).
"""
import os

import numpy as np
import pytest
import torch

from gravinv3dhmc_tpu.inversion import chees as jchees
from gravinv3dhmc_tpu.inversion import hmc as jhmc
from gravinv3dhmc_tpu.inversion import nuts as jnuts
from gravinv3dhmc_tpu.inversion.potential import GravMagModule as JModule
from gravinv3dhmc_tpu.runtime.sink import read_matrix as jread
from gravinv3dhmc_tpu_torch import diagnostics as tdiag
from gravinv3dhmc_tpu_torch import samplers, uniformgrid
from gravinv3dhmc_tpu_torch.inversion import chees as tchees
from gravinv3dhmc_tpu_torch.inversion import hmc as thmc
from gravinv3dhmc_tpu_torch.inversion import nuts as tnuts
from gravinv3dhmc_tpu_torch.inversion.potential import GravMagModule
from gravinv3dhmc_tpu_torch.runtime.sink import read_matrix
from test_torch_hmc import _configure, jax_draws
from test_torch_hmc import torch_module  # noqa: F401
from test_torch_sink import jax_sink_built  # noqa: F401

torch.set_num_threads(2)

BOUNDS = (0, 800, 0, 1200, 0, 400)
SPACING = (100, 100, 100)
RTOL, ATOL = 5e-3, 5e-4


def _rounding(ref):
    """The ``%.8f`` file's bound against ``ref`` (f64)."""
    return 5e-9 + 1e-15 * np.abs(ref).max()


def _read(folder):
    return (read_matrix(os.path.join(folder, "model.dat")),
            read_matrix(os.path.join(folder, "misfit.dat")))


@pytest.mark.parametrize("store_mode", ["chain", "accepted"])
def test_write_files_matches_jax(small_module, torch_module, tmp_path,
                                 store_mode):
    jmod, dobs, _ = small_module
    runs = {}
    for name, cls, module in (("jax", jhmc.HamiltonianMC, jmod),
                              ("port", thmc.HamiltonianMC, torch_module)):
        chain = _configure(cls(module), module, dobs)
        chain.store_mode = store_mode
        chain.write_files = True
        chain.save_folder = str(tmp_path / name / "chain")
        kw = {}
        if name == "port":
            kw["draws"] = jax_draws(7, chain.chunk_size, chain.nchains,
                                    module.n_active)
        else:
            chain.use_fused = False
        runs[name] = chain.sample(16, 2, **kw)
    res_j, res_t = runs["jax"], runs["port"]
    assert [os.path.relpath(f, tmp_path / "port") for f in res_t["folders"]] \
        == [os.path.relpath(f, tmp_path / "jax") for f in res_j["folders"]] \
        == [f"chain{c}" for c in range(8)]
    np.testing.assert_array_equal(res_t["n_stored"], res_j["n_stored"])
    samples = res_t["samples"].double().numpy()
    misfits = res_t["misfits"].double().numpy()
    for c, (ft, fj) in enumerate(zip(res_t["folders"], res_j["folders"])):
        (mt, kt), (mj, kj) = _read(ft), _read(fj)
        n = int(res_t["n_stored"][c])
        assert mt.shape == mj.shape == (n, torch_module.n_active)
        assert kt.shape == kj.shape == (n, 7)
        np.testing.assert_allclose(mt, mj, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(kt[:, 0], kj[:, 0], rtol=1e-3)
        assert np.abs(mt - samples[c, :n]).max() <= _rounding(samples)
        assert np.abs(kt - misfits[c, :n]).max() <= _rounding(misfits)
    if store_mode == "accepted":
        assert len(set(res_t["n_stored"].tolist())) > 1


def test_callback_once_a_chunk(small_module, torch_module):
    """``callback(nacc, x)`` after every chunk: int64 counts equal to the
    JAX package's, and the chains' (C, M) state."""
    jmod, dobs, _ = small_module
    seen = {"jax": [], "port": []}
    for name, cls, module in (("jax", jhmc.HamiltonianMC, jmod),
                              ("port", thmc.HamiltonianMC, torch_module)):
        chain = _configure(cls(module), module, dobs)
        chain.use_fused = name == "port"
        chain.fused_matvec_dtype = torch.float32 if name == "port" else None

        def callback(nacc, x, name=name):
            seen[name].append((nacc.copy(), tuple(x.shape), type(x)))

        kw = dict(callback=callback)
        if name == "port":
            kw["draws"] = jax_draws(7, chain.chunk_size, chain.nchains,
                                    module.n_active)
        res = chain.sample(16, 0, **kw)
        assert len(seen[name]) == res["attempted"] // (chain.chunk_size
                                                       * chain.nchains)
    assert len(seen["port"]) == len(seen["jax"]) > 1
    for (nt, st, tt), (nj, sj, _) in zip(seen["port"], seen["jax"]):
        assert nt.dtype == np.int64 == nj.dtype
        np.testing.assert_array_equal(nt, nj)
        assert st == sj == (8, torch_module.n_active)
        assert tt is torch.Tensor


def test_hmcsample_configures_the_chain_as_jax(small_module, torch_module,
                                               tmp_path, monkeypatch):
    """``HMCSample`` builds the same chain in both packages (``sample``
    patched to capture it), and the port's run writes the files that
    ``load_chains`` reads back as its samples."""
    jmod, dobs, _ = small_module
    M = jmod.n_active
    args = dict(nsamples=8, ndraws=2, delta=0.05, Lrange=(3, 8),
                initial_model=np.full(M, 0.3), aprior_model=np.full(M, 0.001),
                boundaries=np.column_stack([np.zeros(M), np.ones(M)]),
                constraint="mandatory", log_factor=50.0, dobs=dobs,
                RegulFactor=0.5, regularization="MS", beta=0.002, seed=11,
                Sigma=0.001, myrank=2, save_folder=str(tmp_path / "c"),
                nchains=4, chunk_size=8, verbose=False, adapt_step_size=True,
                adapt_target=0.7, adapt_mass=True, adapt_chunks=9,
                shared_L=True, use_fused=True, store_mode="chain",
                store_thin=2, temperature=1.0)
    chains = {}
    for name, mod, module in (("jax", jhmc, jmod),
                              ("port", thmc, torch_module)):
        def capture(self, nsamples, ndraws, name=name):
            chains[name] = self
            return (nsamples, ndraws)
        monkeypatch.setattr(mod.HamiltonianMC, "sample", capture)
        assert mod.HMCSample(module, **args) == (8, 2)
    monkeypatch.undo()
    j, t = chains["jax"], chains["port"]
    for key in ("low", "high", "initial_model", "aprior_model", "dobs"):
        np.testing.assert_array_equal(getattr(t, key), getattr(j, key))
    for key in ("seed", "myrank", "save_folder", "constraint", "log_factor",
                "Lrange", "dt", "Sigma", "RegulFactor", "regularization",
                "beta", "nchains", "chunk_size", "verbose", "write_files",
                "adapt_step_size", "adapt_target", "adapt_mass",
                "adapt_chunks", "shared_L", "use_fused", "transfer_samples",
                "store_mode", "store_thin", "spmd_mesh", "jacobian",
                "temperature"):
        assert getattr(t, key) == getattr(j, key), key
    assert (t.seed, t.dtype, t.device) == (13, torch.float32, None)
    assert thmc.HamitonianMC is thmc.HamiltonianMC

    res = thmc.HMCSample(torch_module, **dict(
        args, adapt_step_size=False, adapt_mass=False, use_fused=False,
        ndraws=0), device="cpu")
    assert res["folders"] == [str(tmp_path / f"c{c}") for c in (2, 3, 4, 5)]
    back = tdiag.load_chains(str(tmp_path / "c"), 4, myrank=2)
    samples = res["samples"].double().numpy()
    assert back.shape == samples.shape
    assert np.abs(back - samples).max() <= _rounding(samples)


def _sampler_kw(small_module):
    _, dobs, _ = small_module
    M = small_module[0].n_active
    return dict(nsamples=5, nwarmup=4, initial_model=np.full(M, 0.001),
                aprior_model=np.full(M, 0.001),
                boundaries=np.column_stack([np.zeros(M), np.ones(M)]),
                dobs=dobs, seed=7, log_factor=100.0, step_size0=0.05,
                verbose=False, temperature=0.1, nchains=2, myrank=1)


@pytest.mark.parametrize("jfn,tfn", [
    (jchees.CheesSample, tchees.CheesSample),
    (jnuts.NUTSSample, tnuts.NUTSSample)], ids=["chees", "nuts"])
def test_sampler_save_folder_layout(small_module, torch_module, tmp_path,
                                    jfn, tfn):
    """ChEES and NUTS ``save_folder``: the JAX layout (``<save_folder><myrank
    + c>/``, every draw a line, a zero misfit row each), the files equal to
    the returned samples to the ``%.8f`` rounding."""
    jmod = small_module[0]
    kw = _sampler_kw(small_module)
    extra = dict(max_depth=3) if jfn is jnuts.NUTSSample else {}
    res_j = jfn(jmod, save_folder=str(tmp_path / "j" / "s"), **kw, **extra)
    res_t = tfn(torch_module, save_folder=str(tmp_path / "t" / "s"),
                device="cpu", **kw, **extra)
    names = [os.path.relpath(f, tmp_path / "t") for f in res_t["folders"]]
    assert names == [os.path.relpath(f, tmp_path / "j")
                     for f in res_j["folders"]] == ["s1", "s2"]
    samples = res_t["samples"].double().numpy()
    for c, (ft, fj) in enumerate(zip(res_t["folders"], res_j["folders"])):
        (mt, kt), (mj, kj) = _read(ft), _read(fj)
        assert mt.shape == mj.shape == (5, jmod.n_active)
        np.testing.assert_array_equal(kt, np.zeros((5, 7)))
        np.testing.assert_array_equal(kj, kt)
        assert np.abs(mt - samples[c]).max() <= _rounding(samples)
        np.testing.assert_array_equal(jread(os.path.join(ft, "model.dat")),
                                      mt)


@pytest.mark.parametrize("suffix", [".npy", ""])
def test_kernel_cache_crosses_packages(small_module, tmp_path, capsys,
                                       suffix):
    """A cache the JAX module wrote loads in the port to a bit-equal ``A``
    and ``Aw``, and the reverse; a path without ``.npy`` is written through
    ``<path>.npy`` and renamed, leaving no other file."""
    jmod, dobs, _ = small_module
    obs = (jmod.lonobs, jmod.latobs, jmod.heightobs)

    def port(path, verbose=False):
        return GravMagModule(dobs, BOUNDS, SPACING, obs, verbose=verbose,
                             device="cpu", kernel_cache=path)

    def jax(path, verbose=False):
        return JModule(dobs, BOUNDS, SPACING, obs, verbose=verbose,
                       kernel_cache=path)

    for writer, reader, name in ((jax, port, "jax"), (port, jax, "port")):
        path = str(tmp_path / f"{name}{suffix}")
        built = writer(path)
        assert sorted(os.listdir(tmp_path))[-1] == f"{name}{suffix}"
        capsys.readouterr()
        loaded = reader(path, verbose=True)
        assert f"loaded kernel from {path}" in capsys.readouterr().out
        for key in ("A", "Aw", "wdiag"):
            np.testing.assert_array_equal(np.asarray(getattr(loaded, key)),
                                          np.asarray(getattr(built, key)))
        np.testing.assert_array_equal(np.asarray(built.A), jmod.A)
    assert sorted(os.listdir(tmp_path)) == [f"jax{suffix}", f"port{suffix}"]


def test_kernel_cache_of_another_geometry(small_module, tmp_path):
    """A cache whose shape is not (observations, active cells): the JAX
    module takes it silently, the port refuses it."""
    jmod, dobs, _ = small_module
    obs = (jmod.lonobs, jmod.latobs, jmod.heightobs)
    path = str(tmp_path / "other.npy")
    np.save(path, np.ones((dobs.size, jmod.n_active - 1)))
    assert JModule(dobs, BOUNDS, SPACING, obs, verbose=False,
                   kernel_cache=path).Aw.shape == (dobs.size,
                                                   jmod.n_active - 1)
    with pytest.raises(ValueError, match="holds a"):
        GravMagModule(dobs, BOUNDS, SPACING, obs, verbose=False,
                      device="cpu", kernel_cache=path)


def test_samplers_run_save_folder(tmp_path):
    """``samplers.run(save_folder=...)``: ChEES and NUTS write their draws in
    reference units, chain c to ``<save_folder><name>_<c>/``, read back by
    ``load_chains`` to the ``%.8f`` rounding; the honest HMC writes none."""
    problem = uniformgrid.build_problem(6, 8, 4, device="cpu")
    base = str(tmp_path / "s_")
    out = samplers.run(device="cpu", problem=problem, nchains=3,
                       nsamples=5, nwarmup=4, max_depth=3,
                       hmc=dict(nchains=4, chunk=4, nsamples=4),
                       save_folder=base)
    for name in ("chees", "nuts"):
        line, tensors = out[name]
        assert line["folders"] == [f"{base}{name}_{c}" for c in range(3)]
        model = tensors["model"].double().numpy()
        assert model.shape == (3, 5, 192)
        back = tdiag.load_chains(f"{base}{name}_", 3)
        assert np.abs(back - model).max() <= _rounding(model)
        np.testing.assert_array_equal(
            read_matrix(os.path.join(line["folders"][0], "misfit.dat")),
            np.zeros((5, 7)))
    assert "folders" not in out["hmc"][0]
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"s_{n}_{c}" for n in ("chees", "nuts") for c in range(3))
