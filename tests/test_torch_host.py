"""The port's copied host numpy layers against the JAX package's
originals: the copies must not drift apart (rtol 1e-12; all of it is f64
host arithmetic on the same inputs)."""
import numpy as np
import pytest
import torch

from gravinv3dhmc_tpu import constants as jconst
from gravinv3dhmc_tpu import mesher as jmesher
from gravinv3dhmc_tpu import utils as jutils
from gravinv3dhmc_tpu.mesher import mesh as jmesh
from gravinv3dhmc_tpu.inversion.potential import (
    sensitivity_weighting as j_weighting,
)
from gravinv3dhmc_tpu.ops import prism as jprism
from gravinv3dhmc_tpu_torch import constants as tconst
from gravinv3dhmc_tpu_torch import mesher as tmesher
from gravinv3dhmc_tpu_torch import realdata
from gravinv3dhmc_tpu_torch import utils as tutils
from gravinv3dhmc_tpu_torch.mesher import mesh as tmesh
from gravinv3dhmc_tpu_torch.inversion.potential import (
    sensitivity_weighting as t_weighting,
)
from gravinv3dhmc_tpu_torch.ops import prism as tprism

torch.set_num_threads(2)

BOUNDS = (0, 800, 0, 1200, 0, 400)


@pytest.mark.parametrize("spacing,ratio", [((100, 100, 100), 1),
                                           ((50, 100, 200), 1.3)])
def test_prism_mesh_cell_bounds(spacing, ratio):
    jm = jmesher.PrismMesh(BOUNDS, spacing, ratio)
    tm = tmesher.PrismMesh(BOUNDS, spacing, ratio)
    assert tm.shape == jm.shape and tm.size == jm.size
    np.testing.assert_array_equal(tm.cell_bounds(), jm.cell_bounds())
    np.testing.assert_array_equal(tm.get_zs(), jm.get_zs())
    np.testing.assert_array_equal(tm.centers(), jm.centers())


def test_regular_and_contaminate():
    jx = jutils.regular((0, 800, 0, 1200), (8, 12), z=-5.0)
    tx = tutils.regular((0, 800, 0, 1200), (8, 12), z=-5.0)
    for a, b in zip(jx, tx):
        np.testing.assert_array_equal(b, a)
    data = np.linspace(-1.0, 3.0, 96)
    np.testing.assert_allclose(tutils.contaminate(data, 0.1, seed=5),
                               jutils.contaminate(data, 0.1, seed=5),
                               rtol=1e-12)
    np.testing.assert_allclose(
        tutils.contaminate(data, 0.05, percent=True, seed=2),
        jutils.contaminate(data, 0.05, percent=True, seed=2), rtol=1e-12)


def test_constants_and_units():
    for name in ("G", "SI2MGAL", "SI2EOTVOS", "T2NT", "CM", "g0"):
        assert getattr(tconst, name) == getattr(jconst, name)
    v = np.array([1e-5, -2e-3])
    np.testing.assert_array_equal(tutils.si2mgal(v), jutils.si2mgal(v))
    np.testing.assert_array_equal(tutils.dircos(30, 40),
                                  jutils.dircos(30, 40))


def test_prism_kernel_matrix_and_weighting():
    """The f64 gz matrix over a grid that includes points right above cell
    corners (the guarded log/atan2 branches), then its weighting."""
    mesh_t = tmesher.PrismMesh(BOUNDS, (100, 100, 100))
    mesh_j = jmesher.PrismMesh(BOUNDS, (100, 100, 100))
    xo, yo, zo = tutils.regular((0, 800, 0, 1200), (9, 13), z=0.0)
    kt = tprism.prism_kernel_matrix("gz", xo, yo, zo, mesh_t)
    kj = jprism.prism_kernel_matrix("gz", xo, yo, zo, mesh_j)
    assert kt.dtype == np.float64 and kt.shape == (117, mesh_t.size)
    np.testing.assert_allclose(kt, kj, rtol=1e-12, atol=0)
    rho = np.random.RandomState(0).rand(mesh_t.size)
    mesh_t.addprop("density", rho)
    mesh_j.addprop("density", rho)
    np.testing.assert_allclose(tprism.gz(xo, yo, zo, mesh_t)[0],
                               jprism.gz(xo, yo, zo, mesh_j)[0], rtol=1e-12)
    kt[:, 3] = 0.0  # a zero column stays unscaled
    for a, b in zip(t_weighting(kt, 0.5), j_weighting(kt, 0.5)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)


def test_unported_builders_raise():
    """The JAX package's ``backend="jax"`` builder and fields other than
    gz are not ported; the f32 device builder (``"pallas"``) is."""
    mesh = tmesher.PrismMesh(BOUNDS, (100, 100, 100))
    with pytest.raises(NotImplementedError):
        tprism.prism_kernel_matrix("gz", [0.0], [0.0], [0.0], mesh,
                                   backend="jax")
    for backend in ("numpy", "pallas"):
        with pytest.raises(NotImplementedError):
            tprism.prism_kernel_matrix("gzz", [0.0], [0.0], [0.0], mesh,
                                       backend=backend)


@pytest.mark.parametrize("division,dzlist", [
    ([2000, -5000, -15000, -60000], [-1000, -2000, -5000]),
    # segments that do not divide evenly: bottoms overshoot the breakpoint
    ([0, 300, 900, 2100], [70, 250, 500])])
def test_segment_layers(division, dzlist):
    jn, jtop, jbot = jmesh._segment_layers(division, dzlist)
    tn, ttop, tbot = tmesh._segment_layers(division, dzlist)
    assert tn == jn
    np.testing.assert_array_equal(ttop, jtop)
    np.testing.assert_array_equal(tbot, jbot)


def _realdata_obs(step=0.5):
    """The realdata slice's observation grid and synthetic topography, as
    the JAX bench draws them."""
    w, e, s, n = realdata.MRANGE[:4]
    lons, lats = np.meshgrid(np.arange(w + step / 2, e, step),
                             np.arange(s + step / 2, n, step))
    lons, lats = lons.ravel(), lats.ravel()
    rng = np.random.RandomState(0)
    rng.normal(0, 20, lons.size)
    return lons, lats, rng.uniform(-2000, 2000, lons.size)


@pytest.mark.parametrize("name,args", [
    ("TesseroidMeshSegment", (realdata.MRANGE, (realdata.DZ, 0.5, 0.5),
                              realdata.DIVISION)),
    ("TesseroidMesh", ((106.5, 118.5, 16, 28, 2000, -4000),
                       (-1000, 0.5, 0.5))),
    ("PrismMeshSegment", ((0, 2000, 0, 3000, 0, 2100),
                          ([70, 250, 500], 100, 100), [0, 300, 900, 2100]))])
def test_segment_and_tesseroid_meshes(name, args):
    """Edges, layers, cell bounds and the cells ``mesh[i]`` returns; on
    the realdata geometry (at full size) the topography carve's mask and
    active count."""
    jm = getattr(jmesher, name)(*args)
    tm = getattr(tmesher, name)(*args)
    assert tm.shape == jm.shape and tm.size == jm.size
    assert tm.bounds == jm.bounds and tm.zdown == jm.zdown
    for attr in ("xe", "ye", "ztop", "zbot"):
        np.testing.assert_array_equal(getattr(tm, attr), getattr(jm, attr))
    np.testing.assert_array_equal(tm.cell_bounds(), jm.cell_bounds())
    for i in (0, tm.size // 3, tm.size - 1):
        assert type(tm[i]).__name__ == type(jm[i]).__name__
        assert tm[i].get_bounds() == jm[i].get_bounds()
    if name.startswith("Tesseroid"):
        lons, lats, topo = _realdata_obs()
        assert tm.carvetopo(lons, lats, topo) == jm.carvetopo(lons, lats,
                                                              topo)
        np.testing.assert_array_equal(tm.active, jm.active)
        assert tm.n_active == jm.n_active
        np.testing.assert_array_equal(tm.cell_bounds(only_active=True),
                                      jm.cell_bounds(only_active=True))
        assert 0 < tm.n_active < tm.size


def test_realdata_mesh_is_the_benchs():
    """The slice's full-size mesh: 21 x 24 x 24 tesseroids, 10,676 left
    after the carve, and ``mesh[i]`` of a carved cell is None."""
    lons, lats, topo = _realdata_obs()
    mesh = tmesher.TesseroidMeshSegment(
        realdata.MRANGE, (realdata.DZ, 0.5, 0.5), realdata.DIVISION)
    mask = mesh.carvetopo(lons, lats, topo)
    assert mesh.shape == (21, 24, 24) and lons.size == 576
    assert mesh.n_active == 10676 and len(mask) == 1420
    assert mesh[mask[0]] is None


def test_tesseroid_split_and_half():
    jt = jmesher.Tesseroid(10, 12, 40, 41, 0, -3000, props={"density": 2})
    tt = tmesher.Tesseroid(10, 12, 40, 41, 0, -3000, props={"density": 2})
    assert str(tt) == str(jt)
    for a, b in ((tt.half(), jt.half()), (tt.half(r=False), jt.half(r=False)),
                 (tt.split(2, 3, 4), jt.split(2, 3, 4))):
        assert [c.get_bounds() for c in a] == [c.get_bounds() for c in b]
