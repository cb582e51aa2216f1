"""The port's copies of the JAX package's host utilities
(``gravinv3dhmc_tpu_torch/utils``, ``config.py``, ``mesher.PrismRelief``)
against their originals on the same seeded inputs, mirroring
``tests/test_utils.py`` and ``tests/test_mesher.py``: numpy code carried
over line for line, so every result is equal, not close.
"""
import dataclasses
import json
import struct

import numpy as np
import pytest
import scipy.sparse as sp

from gravinv3dhmc_tpu import config as jconfig
from gravinv3dhmc_tpu import mesher as jmesher
from gravinv3dhmc_tpu import utils as jutils
from gravinv3dhmc_tpu_torch import config as tconfig
from gravinv3dhmc_tpu_torch import mesher as tmesher
from gravinv3dhmc_tpu_torch import utils as tutils

RNG = np.random.RandomState(11)


def test_exports_match_the_jax_utils():
    assert sorted(tutils.__all__) == sorted(jutils.__all__)
    for name in jutils.__all__:
        assert callable(getattr(tutils, name)), name


@pytest.mark.parametrize("case", ["gaussian", "gaussian2d"])
def test_gaussians(case):
    x = RNG.uniform(-50, 50, 200)
    y = RNG.uniform(-50, 50, 200)
    if case == "gaussian":
        args = (x, 3.0, 0.7)
    else:
        args = (x, y, 12.0, 30.0, 1.5, -2.0, 35.0)
    np.testing.assert_array_equal(getattr(tutils, case)(*args),
                                  getattr(jutils, case)(*args))


@pytest.mark.parametrize("shape", [(2, 1, 3), (2, 3, 4), (5, 4, 3)])
def test_kernel2ubc(shape):
    nx, ny, nz = shape
    kernel = RNG.normal(size=(7, nx * ny * nz))
    np.testing.assert_array_equal(tutils.kernel2ubc(kernel, shape),
                                  jutils.kernel2ubc(kernel, shape))
    assert tutils.kernel2UBC is tutils.kernel2ubc


@pytest.mark.parametrize("mask", [[2, 5], [], "bool"])
def test_packing(mask):
    rho = RNG.normal(size=10)
    if mask == "bool":
        mask = RNG.rand(10) > 0.4
    for fn in ("active_from_mask",):
        np.testing.assert_array_equal(getattr(tutils, fn)(mask, 10),
                                      getattr(jutils, fn)(mask, 10))
    packed = tutils.rho2carve(rho, mask)
    np.testing.assert_array_equal(packed, jutils.rho2carve(rho, mask))
    base = RNG.normal(size=10)
    np.testing.assert_array_equal(tutils.carve2rho(packed, base, mask),
                                  jutils.carve2rho(packed, base, mask))
    with pytest.raises(ValueError):
        tutils.active_from_mask(np.ones(3, bool), 10)


@pytest.mark.parametrize("sparse", [False, True])
def test_linalg(sparse):
    A = RNG.normal(size=(6, 6)) + 6 * np.eye(6)
    A[np.abs(A) < 0.8] = 0.0
    b = RNG.normal(size=6)
    B = RNG.normal(size=(6, 3))
    if sparse:
        A = sp.csr_matrix(A)
    for fn, args in [("safe_inverse", (A,)), ("safe_solve", (A, b)),
                     ("safe_dot", (A, B)), ("safe_diagonal", (A,))]:
        got = getattr(tutils, fn)(*args)
        want = getattr(jutils, fn)(*args)
        assert sp.issparse(got) == sp.issparse(want)
        if sp.issparse(got):
            got, want = got.toarray(), want.toarray()
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    if sparse:
        vec = sp.csr_matrix(b[:, None])
        np.testing.assert_array_equal(tutils.safe_solve(A, vec),
                                      jutils.safe_solve(A, vec))


def test_sparse_list():
    kw = dict(elements={1: 2.5, -1: 7.0}, default=-1.0)
    t, j = tutils.SparseList(5, **kw), jutils.SparseList(5, **kw)
    assert list(t) == list(j) and len(t) == len(j) == 5
    t[2] = j[2] = 3.0
    assert list(t) == list(j) and repr(t) == repr(j)
    assert t.index(3.0) == j.index(3.0) and (7.0 in t) == (7.0 in j)
    for bad in (5, -6):
        with pytest.raises(IndexError):
            t[bad]
    with pytest.raises(ValueError):
        tutils.SparseList(-1)


def test_load_setpmts_reads_the_same(tmp_path):
    lines = [
        {"set": "model01_singlecube", "test": "T1", "rhomin": 0,
         "rhomax": 1, "mspacing": [100, 100, 100], "Lrange": [5, 20],
         "delta": 0.01, "Sigma": 0.001, "RegulFactor": 1,
         "regularization": "MS", "beta": 0.001, "nsamples": 500},
        {"set": "realdata", "nchains": 64, "matvec_dtype": "bfloat16",
         "wavelet": "1D", "custom_knob": [1, 2]},
    ]
    p = tmp_path / "SetPMTS.txt"
    p.write_text("\n".join(json.dumps(d) for d in lines) + "\n\n")
    got = tconfig.load_setpmts(str(p))
    want = jconfig.load_setpmts(str(p))
    assert [c.to_dict() for c in got] == [c.to_dict() for c in want]
    assert got[1].extra == {"custom_knob": [1, 2]}
    assert got[1].matvec_dtype == "bfloat16"
    assert ([(f.name, f.default) for f in dataclasses.fields(
        tconfig.HMCConfig) if f.name != "extra"]
            == [(f.name, f.default) for f in dataclasses.fields(
                jconfig.HMCConfig) if f.name != "extra"])


def _dsrb(path, data, xll=1.0, yll=2.0, dx=0.5, dy=0.25, blank=1.70141e38):
    """A Surfer-7 binary grid (tags DSRB, GRID, DATA) of ``data``."""
    nrow, ncol = data.shape
    grid = struct.pack("<ii8d", nrow, ncol, xll, yll, dx, dy,
                       float(np.nanmin(data)), float(np.nanmax(data)), 0.0,
                       blank)
    body = np.ascontiguousarray(data, "<f8").tobytes()
    with open(path, "wb") as f:
        f.write(b"DSRB" + struct.pack("<ii", 4, 2))
        f.write(b"GRID" + struct.pack("<i", len(grid)) + grid)
        f.write(b"DATA" + struct.pack("<i", len(body)) + body)


def _same_grid(a, b):
    for field in dataclasses.fields(jutils.GridData):
        va, vb = getattr(a, field.name), getattr(b, field.name)
        if field.name == "data":
            np.testing.assert_array_equal(va, vb)
        else:
            assert va == vb, field.name


def test_grd_round_trip_across_packages(tmp_path):
    """A grid written by each package is read back by the other; a
    binary DSRB file (a blanked node NaN) reads the same in both."""
    data = RNG.normal(size=(5, 7))
    x = np.linspace(0, 6, 7)
    y = np.linspace(0, 4, 5)
    pt, pj = str(tmp_path / "t.grd"), str(tmp_path / "j.grd")
    tutils.grdwrite(x, y, data, pt)
    jutils.grdwrite(x, y, data, pj)
    assert open(pt).read() == open(pj).read()
    _same_grid(tutils.grdload(pj), jutils.grdload(pt))
    np.testing.assert_allclose(tutils.grdload(pj).data, data)
    pb = str(tmp_path / "b.grd")
    grid = RNG.normal(size=(4, 6))
    grid[1, 2] = 1.70141e38
    _dsrb(pb, grid)
    got, want = tutils.grdload(pb), jutils.grdload(pb)
    assert np.isnan(got.data[1, 2])
    np.testing.assert_array_equal(np.isnan(got.data), np.isnan(want.data))
    np.testing.assert_array_equal(np.nan_to_num(got.data),
                                  np.nan_to_num(want.data))
    got.data = want.data = None
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tutils.gmdata is tutils.GridData
    bad = tmp_path / "bad.grd"
    bad.write_text("XXXX\n1 1\n")
    with pytest.raises(ValueError):
        tutils.grdload(str(bad))


def test_prism_relief():
    """``tests/test_mesher.py::test_prism_relief_sign_flip`` on the port's
    copy, and every prism equal to the JAX package's."""
    nodes = (np.array([0.0, 10.0, 20.0]), np.array([0.0, 10.0, 5.0]),
             np.array([-50.0, 50.0, 0.0]))
    t = tmesher.PrismRelief(0, (10, 10), nodes)
    j = jmesher.PrismRelief(0, (10, 10), nodes)
    for r in (t, j):
        r.addprop("density", [100.0, 100.0, 100.0])
    assert t.props["density"][0] == 100.0
    assert t.props["density"][1] == -100.0
    np.testing.assert_array_equal(t.props["density"], j.props["density"])
    assert len(t) == len(j) == 3
    for pt, pj in zip(t, j):
        assert (pt.x1, pt.x2, pt.y1, pt.y2, pt.z1, pt.z2) == \
            (pj.x1, pj.x2, pj.y1, pj.y2, pj.z1, pj.z2)
        assert pt.props == pj.props
    assert t[-1].z2 == j[-1].z2
    with pytest.raises(ValueError):
        tmesher.PrismRelief(0, (1, 1), (np.zeros(2), np.zeros(3),
                                        np.zeros(2)))
