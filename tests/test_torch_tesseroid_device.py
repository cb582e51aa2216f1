"""The device tesseroid builder and the near-field machinery against the
JAX package's (``tests/test_tesseroid_ops.py``'s three device tests).

* ``subdivision_mask``: the port's host and native backends give the JAX
  package's pairs in the same order, and its torch device backend (run
  on the CPU here, f32) the JAX device backend's pair set.
* The native engine's pair and mask entries (``kernel_pairs``,
  ``subdivision_pairs``) equal the JAX package's bit for bit, and the
  pair values equal the full matrix's entries within 1e-12 (native, and
  the numpy worklist the port falls back to with a warning).
* ``tesseroid_kernel_device`` in f32: within 1e-6 of max|K| of the JAX
  builder's f32 matrix (the same stable formula, summed in another
  order), within 1e-5 of the f64 host matrix with and without ``winv``,
  and every far-field entry within 1e-5 of its own value.
* ``GravMagModule(kernel_device=True)``: ``wdiag``, the weighted matrix
  and ``nearfield_pairs`` against the JAX module's; the same refusals.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravinv3dhmc_tpu.inversion.potential import GravMagModule as JModule
from gravinv3dhmc_tpu.ops import tesseroid as jt
from gravinv3dhmc_tpu.runtime import tessglq as jnative
from gravinv3dhmc_tpu_torch.inversion.potential import GravMagModule
from gravinv3dhmc_tpu_torch.ops import tesseroid as tt
from gravinv3dhmc_tpu_torch.runtime import tessglq as tnative

torch.set_num_threads(2)

#: the f32 builders against each other, relative to max|K|: the same
#: formula in the same type, reductions in another order
JAX_F32_RTOL = 1e-6
#: the f32 builders against the f64 host matrix (the JAX test's bound)
HOST_RTOL = 1e-5


def _ring():
    """A ring of 3-degree tesseroids at depth under 120 observations: the
    global case's geometry, whose mask boundary sits at ~530 km."""
    cells = np.array([[w, w + 3.0, -1.5, 1.5, -3e5, -6e5]
                      for w in range(-180, 180, 3)], np.float64)
    lons = np.linspace(-180, 177.0, 120)
    return lons, np.full(lons.size, 0.5), np.full(lons.size, 5e3), cells


def _three_cells():
    cells = np.array([
        [-10.0, 10.0, -10.0, 10.0, 0.0, -5e4],
        [10.0, 30.0, -10.0, 10.0, 0.0, -5e4],
        [150.0, 170.0, 40.0, 60.0, -5e4, -1e5],
    ])
    lons, lats = np.meshgrid(np.linspace(-30, 40, 6),
                             np.linspace(-25, 25, 5))
    lons, lats = lons.ravel(), lats.ravel()
    return lons, lats, np.full(lons.size, 5e3), cells


def test_subdivision_mask_backends_match_jax():
    lons, lats, h, cells = _ring()
    for backend in ("host", "native"):
        want = jt.subdivision_mask(lons, lats, h, cells, 1.6,
                                   backend=backend)
        got = tt.subdivision_mask(lons, lats, h, cells, 1.6,
                                  backend=backend)
        for a, b in zip(got, want):
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    oi, ci = tt.subdivision_mask(lons, lats, h, cells, 1.6, backend="host")
    oi_d, ci_d = tt.subdivision_mask(lons, lats, h, cells, 1.6,
                                     backend="device", device="cpu",
                                     obs_block=50)
    oj, cj = jt.subdivision_mask(lons, lats, h, cells, 1.6,
                                 backend="device")
    assert oi.size > 0
    assert set(zip(oi_d.tolist(), ci_d.tolist())) == set(
        zip(oj.tolist(), cj.tolist())) == set(zip(oi.tolist(), ci.tolist()))
    with pytest.raises(ValueError):
        tt.subdivision_mask(lons, lats, h, cells, 1.6, backend="gpu")


def test_pair_engines_match_jax(monkeypatch):
    lons, lats, h, cells = _ring()
    kh = tt.tesseroid_kernel_matrix("gz", lons, lats, h, cells)
    oi, ci = tt.subdivision_mask(lons, lats, h, cells, 1.6, backend="host")
    args = ("gz", lons, lats, h, oi, ci, cells, 1.6)
    np.testing.assert_array_equal(tnative.kernel_pairs(*args),
                                  jnative.kernel_pairs(*args))
    lon_r, lat_r = np.radians(lons), np.radians(lats)
    terms = jt._mask_cell_terms(cells, 1.6)
    for a, b in zip(tt._mask_cell_terms(cells, 1.6), terms):
        np.testing.assert_array_equal(a, b)
    lont, _, sinlatt, coslatt, rt, thr = terms
    mask_args = (lon_r, np.sin(lat_r), np.cos(lat_r),
                 tt.MEAN_EARTH_RADIUS + h, lont, sinlatt, coslatt, rt, thr)
    for a, b in zip(tnative.subdivision_pairs(*mask_args),
                    jnative.subdivision_pairs(*mask_args)):
        np.testing.assert_array_equal(a, b)
    want = kh[oi, ci]
    scale = np.abs(kh).max()
    info = {}
    got = tt._nearfield_pair_values(*args, info=info) * tt._SCALES["gz"]
    assert info["pairs_backend"] == "native"
    assert np.abs(got - want).max() / scale < 1e-12
    with pytest.raises(ValueError):
        tnative.kernel_pairs("gz", lons, lats, h, oi, ci + 1000, cells, 1.6)

    def broken(*a, **k):
        raise RuntimeError("no toolchain")

    monkeypatch.setattr(tnative, "kernel_pairs", broken)
    with pytest.warns(RuntimeWarning, match="near-field pairs with numpy"):
        got = tt._nearfield_pair_values(*args, info=info)
    assert info["pairs_backend"] == "numpy"
    assert np.abs(got * tt._SCALES["gz"] - want).max() / scale < 1e-12


def test_device_kernel_matches_jax_and_host():
    lons, lats, h, cells = _three_cells()
    k_host = tt.tesseroid_kernel_matrix("gz", lons, lats, h, cells)
    scale = np.abs(k_host).max()
    for kwargs in (dict(host_kernel=k_host), dict()):
        info = {}
        k_dev, (oi, ci) = tt.tesseroid_kernel_device(
            "gz", lons, lats, h, cells, obs_block=7, device="cpu",
            info=info, **kwargs)
        k_jax, (oj, cj) = jt.tesseroid_kernel_device(
            "gz", lons, lats, h, cells, obs_block=7, **kwargs)
        assert k_dev.dtype == torch.float32 and oi.size > 0
        assert info["mask_backend"] == "native"
        assert info["pairs_backend"] == ("host_kernel" if kwargs
                                         else "native")
        np.testing.assert_array_equal(oi, oj)
        np.testing.assert_array_equal(ci, cj)
        k = k_dev.numpy().astype(np.float64)
        assert np.abs(k - k_host).max() / scale < HOST_RTOL
        assert np.abs(k - np.asarray(k_jax, np.float64)).max() / scale \
            < JAX_F32_RTOL
    winv = np.linspace(0.5, 2.0, cells.shape[0])
    k_w, _ = tt.tesseroid_kernel_device("gz", lons, lats, h, cells,
                                        host_kernel=k_host, winv=winv,
                                        device="cpu")
    assert np.abs(k_w.numpy() - k_host * winv).max() / scale < HOST_RTOL
    # the ring: every far-field entry to its own 1e-5, the f32 regime
    # where the classic distance form cancels
    lons, lats, h, cells = _ring()
    k_host = tt.tesseroid_kernel_matrix("gz", lons, lats, h, cells)
    k_dev, (oi, ci) = tt.tesseroid_kernel_device(
        "gz", lons, lats, h, cells, obs_block=16, device="cpu")
    far = np.ones_like(k_host, bool)
    far[oi, ci] = False
    rel = np.abs(k_dev.numpy() - k_host)[far] / np.abs(k_host)[far]
    assert rel.max() < HOST_RTOL
    with pytest.raises(ValueError):
        tt.tesseroid_kernel_device("gzzz", lons, lats, h, cells,
                                   device="cpu")


def test_device_kernel_mask_fallback_warns(monkeypatch):
    """Without the native engine the mask falls back, with a warning, to
    the host test at this size, and the result says so."""
    lons, lats, h, cells = _three_cells()
    want, _ = tt.tesseroid_kernel_device("gz", lons, lats, h, cells,
                                         device="cpu")

    def broken(*a, **k):
        raise OSError("cannot load the engine")

    monkeypatch.setattr(tnative, "subdivision_pairs", broken)
    info = {}
    with pytest.warns(RuntimeWarning, match="by the host backend"):
        got, _ = tt.tesseroid_kernel_device("gz", lons, lats, h, cells,
                                            device="cpu", info=info)
    assert info["mask_backend"] == "host"
    torch.testing.assert_close(got, want, rtol=0, atol=0)


MRANGE = (-10, 10, -10, 10, 0, -300000.0)
SPACING = (-100000.0, 2.0, 2.0)


def _obs():
    lons, lats = np.meshgrid(np.linspace(-9, 9, 7), np.linspace(-9, 9, 6))
    lons, lats = lons.ravel(), lats.ravel()
    return (np.random.RandomState(0).normal(0, 5, lons.size),
            (lons, lats, np.full(lons.size, 5000.0)))


@pytest.mark.parametrize("dtypes", [(torch.float32, jnp.float32),
                                    (torch.float64, jnp.float64)])
def test_module_kernel_device_matches_jax(dtypes, tmp_path):
    dobs, obs = _obs()
    kw = dict(coordinate="spherical", kernel_device=True, verbose=False)
    jm = JModule(dobs, MRANGE, SPACING, obs, dtype=dtypes[1], **kw)
    tm = GravMagModule(dobs, MRANGE, SPACING, obs, dtype=dtypes[0],
                       device="cpu", **kw)
    assert tm.A is None and tm.Aw is None
    assert tm.nearfield_pairs == jm.nearfield_pairs > 0
    assert tm.mask_backend == tm.pairs_backend == "native"
    assert tm.wdiag.dtype == tm.wdiag_inv.dtype == torch.float32
    assert tm.n_active == jm.n_active
    assert _rel(tm.wdiag, jm.wdiag) <= 1e-6
    Aw = tm.device_arrays()["Aw"]
    assert Aw.dtype == dtypes[0]
    assert _rel(Aw, jm.device_arrays()["Aw"]) <= 1e-6
    host = GravMagModule(dobs, MRANGE, SPACING, obs, coordinate="spherical",
                         verbose=False, device="cpu")
    assert _rel(Aw, host.Aw) <= HOST_RTOL
    mw = torch.as_tensor(host.wdiag * 0.1, dtype=dtypes[0])
    assert _rel(tm.predict(mw), host.Aw @ mw.double().numpy()) <= HOST_RTOL
    pot = tm.make_potential(0 * tm.wdiag, -tm.wdiag, tm.wdiag)
    U, g, _ = pot(torch.stack([mw, 0.5 * mw]), 1.0)
    assert torch.isfinite(U).all() and torch.isfinite(g).all()
    with pytest.raises(ValueError):
        tm.device_arrays(torch.float16)
    # a host cache gives the near-field values and the host matrices
    path = str(tmp_path / "k.npy")
    np.save(path, host.A)
    cached = GravMagModule(dobs, MRANGE, SPACING, obs, dtype=dtypes[0],
                           device="cpu", kernel_cache=path, **kw)
    assert cached.pairs_backend == "host_kernel"
    np.testing.assert_array_equal(cached.A, host.A)
    assert _rel(cached.Aw, host.Aw) <= HOST_RTOL


def _rel(got, want):
    got = (got.double().numpy() if torch.is_tensor(got)
           else np.asarray(got, np.float64))
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("kwargs", [dict(coordinate="cartesian"),
                                    dict(coordinate="spherical",
                                         field="magnetic"),
                                    dict(coordinate="spherical",
                                         wavelet="1D")])
def test_module_kernel_device_refusals(kwargs):
    dobs, obs = _obs()
    for cls, extra in ((JModule, {}), (GravMagModule, {"device": "cpu"})):
        with pytest.raises(NotImplementedError):
            cls(dobs, MRANGE, SPACING, obs, kernel_device=True,
                verbose=False, **kwargs, **extra)


def test_builder_defaults_to_the_card(monkeypatch):
    """``device=None`` is ``cuda:0``; without a card that is an error."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lons, lats, h, cells = _three_cells()
    with pytest.raises(RuntimeError, match="cuda:0"):
        tt.tesseroid_kernel_device("gz", lons, lats, h, cells)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(RuntimeError, match="cuda:0"):
            tt.subdivision_mask(lons, lats, h, cells, 1.6,
                                backend="device")
