"""The port's tesseroid gz builder (``ops/tesseroid.py`` and the native
engine ``runtime/native/tessglq.cpp``) against the JAX package's
``tesseroid_kernel_matrix``.

The native engines are the same C++ source built with the same flags
(``g++ -O3 -march=native -fopenmp``), so their matrices must be equal bit
for bit; the numpy builders are the same numpy code, held within 1e-12
relative (of max|A|). The grid is coarse, a few dozen observations over a
few hundred carved, segmented tesseroids of the realdata geometry, with
observations both above the mesh and inside its top layer (where the
adaptive subdivision hits its minimum sizes).
"""
import warnings

import numpy as np
import pytest

from gravinv3dhmc_tpu import mesher as jmesher
from gravinv3dhmc_tpu.ops import tesseroid as jtess
from gravinv3dhmc_tpu_torch import mesher as tmesher
from gravinv3dhmc_tpu_torch import realdata
from gravinv3dhmc_tpu_torch.ops import tesseroid as ttess
from gravinv3dhmc_tpu_torch.runtime import tessglq

NUMPY_RTOL = 1e-12
STEP = 2.0


def _geometry(mesher_mod):
    """A carved segment mesh of the realdata region at 2 degrees (6 x 6 x
    21 = 756 cells) and its 36 observations, half at 0 m (inside the top
    layer) and half at 5 km."""
    w, e, s, n = realdata.MRANGE[:4]
    lons, lats = np.meshgrid(np.arange(w + STEP / 2, e, STEP),
                             np.arange(s + STEP / 2, n, STEP))
    lons, lats = lons.ravel(), lats.ravel()
    heights = np.where(np.arange(lons.size) % 2, 5000.0, 0.0)
    topo = np.random.RandomState(0).uniform(-2000, 2000, lons.size)
    mesh = mesher_mod.TesseroidMeshSegment(
        realdata.MRANGE, (realdata.DZ, STEP, STEP), realdata.DIVISION)
    mesh.carvetopo(lons, lats, topo)
    return lons, lats, heights, mesh


@pytest.fixture(scope="module")
def geometry():
    return _geometry(jmesher), _geometry(tmesher)


def _quiet(fn, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return fn(*args, **kw)


def test_native_matrix_bit_equal(geometry):
    (lo, la, h, jm), (_, _, _, tm) = geometry
    info = {}
    kt = ttess.tesseroid_kernel_matrix("gz", lo, la, h, tm,
                                       backend="native", info=info)
    kj = jtess.tesseroid_kernel_matrix("gz", lo, la, h, jm,
                                       backend="native")
    assert info == {"tess_backend": "native"}
    assert kt.shape == (36, tm.n_active) and 0 < tm.n_active < tm.size
    assert np.all(np.isfinite(kt)) and np.abs(kt).max() > 0
    np.testing.assert_array_equal(kt, kj)
    assert tessglq.library_path().parent == tessglq.BUILD_DIR


def test_numpy_matrix_matches(geometry):
    (lo, la, h, jm), (_, _, _, tm) = geometry
    info = {}
    kt = _quiet(ttess.tesseroid_kernel_matrix, "gz", lo, la, h, tm,
                backend="numpy", info=info)
    kj = _quiet(jtess.tesseroid_kernel_matrix, "gz", lo, la, h, jm,
                backend="numpy")
    assert info == {"tess_backend": "numpy"}
    np.testing.assert_allclose(kt, kj, rtol=0,
                               atol=NUMPY_RTOL * np.abs(kj).max())
    # the two engines make the same leaves; they differ in summation order
    kn = ttess.tesseroid_kernel_matrix("gz", lo, la, h, tm)
    assert np.abs(kn - kt).max() < 1e-6 * np.abs(kt).max()


def test_adaptive_leaves_match(geometry):
    (lo, la, h, jm), (_, _, _, tm) = geometry
    lon_r, lat_r = np.radians(lo[:6]), np.radians(la[:6])
    args = (lon_r, np.sin(lat_r), np.cos(lat_r),
            ttess.MEAN_EARTH_RADIUS + h[:6])
    cells = tm.cell_bounds(only_active=True)[:40]
    out_t = _quiet(ttess.adaptive_leaves, *args, cells, ttess.RATIO_G)
    out_j = _quiet(jtess.adaptive_leaves, *args, cells, jtess.RATIO_G)
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a, b)
    assert out_t[2].shape[0] > cells.shape[0] * 6  # cells were split


def test_auto_backend_records_which_ran(geometry, monkeypatch):
    """``auto`` takes the native engine; when it cannot be loaded the
    numpy build is taken with a warning and recorded, never silently."""
    _, (lo, la, h, tm) = geometry
    # observations at 5 km, above the mesh
    lo, la, h = lo[1::2], la[1::2], h[1::2]
    info = {}
    ttess.tesseroid_kernel_matrix("gz", lo[:4], la[:4], h[:4], tm,
                                  info=info)
    assert info["tess_backend"] == "native"

    def broken(*a, **k):
        raise OSError("no engine")

    monkeypatch.setattr(tessglq, "kernel_matrix", broken)
    info = {}
    with pytest.warns(RuntimeWarning, match="native tesseroid engine"):
        ttess.tesseroid_kernel_matrix("gz", lo[:4], la[:4], h[:4], tm,
                                      info=info)
    assert info["tess_backend"] == "numpy"
    with pytest.raises(OSError):
        ttess.tesseroid_kernel_matrix("gz", lo[:4], la[:4], h[:4], tm,
                                      backend="native")


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_degenerate_cells_dropped(backend):
    """Cells thinner than 1e-6 degrees or 1e-3 m are dropped with a
    warning, as in the JAX package, so M shrinks."""
    cells = np.array([[0, 2, 0, 2, -1000, -5000],
                      [5, 5 + 1e-8, 0, 2, -1000, -5000],
                      [3, 4, 0, 2, -1000, -1000 - 1e-4],
                      [6, 8, 1, 3, 0, -3000]], dtype=float)
    lon, lat, h = np.array([1.0, 7.0]), np.array([1.0, 2.0]), np.full(2, 1e4)
    with pytest.warns(RuntimeWarning, match="Ignoring this tesseroid"):
        kt = ttess.tesseroid_kernel_matrix("gz", lon, lat, h, cells,
                                           backend=backend)
    with pytest.warns(RuntimeWarning):
        kj = jtess.tesseroid_kernel_matrix("gz", lon, lat, h, cells,
                                           backend=backend)
    assert kt.shape == kj.shape == (2, 2)
    np.testing.assert_array_equal(kt, kj)


def test_unknown_field_or_backend_raises():
    cells = np.array([[0, 2, 0, 2, -1000, -5000]], dtype=float)
    one = np.array([1.0])
    with pytest.raises(ValueError):
        ttess.tesseroid_kernel_matrix("gq", one, one, one, cells)
    with pytest.raises(ValueError):
        ttess.tesseroid_kernel_matrix("gz", one, one, one, cells,
                                      backend="device")
