"""The port's visualization layer (``gravinv3dhmc_tpu_torch/vis``) against
the JAX package's (``tests/test_vis.py``'s cases), on the Agg backend.

Beyond drawing without error, the drawn artists' data are compared with
the JAX module's on the same inputs, exactly: contour levels and paths,
pcolormesh arrays, the ``Poly3DCollection`` vertices and face colours of
``myv.prisms``, and the embedded geodata's segments bit for bit. A
``values`` argument may be a torch tensor; it draws what its numpy copy
draws.
"""
import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from gravinv3dhmc_tpu import mesher as jmesher  # noqa: E402
from gravinv3dhmc_tpu import utils as jutils  # noqa: E402
from gravinv3dhmc_tpu.vis import geodata as jgeo  # noqa: E402
from gravinv3dhmc_tpu.vis import mpl as jmpl  # noqa: E402
from gravinv3dhmc_tpu.vis import myv as jmyv  # noqa: E402
from gravinv3dhmc_tpu_torch import mesher as tmesher  # noqa: E402
from gravinv3dhmc_tpu_torch.vis import geodata as tgeo  # noqa: E402
from gravinv3dhmc_tpu_torch.vis import mpl as tmpl  # noqa: E402
from gravinv3dhmc_tpu_torch.vis import myv as tmyv  # noqa: E402


@pytest.fixture(autouse=True)
def _close_figs():
    yield
    plt.close("all")


def _flat_grid():
    x, y, z = jutils.regular((0, 1000, 0, 2000), (5, 8), z=0.0)
    v = np.sin(x / 300.0) + np.cos(y / 500.0)
    return x, y, v, (5, 8)


def _paths(ax):
    """Every path vertex array the axes hold, in drawing order."""
    out = []
    for coll in ax.collections:
        for p in coll.get_paths():
            out.append(np.asarray(p.vertices))
    for ln in ax.lines:
        out.append(np.asarray(ln.get_xydata()))
    return out


def _draw(module, fn, *args, **kwargs):
    fig = plt.figure()
    res = getattr(module, fn)(*args, **kwargs)
    return res, _paths(fig.gca()), fig


def _same_paths(a, b):
    assert len(a) == len(b)
    for p, q in zip(a, b):
        np.testing.assert_array_equal(p, q)


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("fn", ["contour", "contourf"])
def test_contours_match_jax(fn, as_tensor):
    x, y, v, shape = _flat_grid()
    tv = torch.as_tensor(v) if as_tensor else v
    lv_t, paths_t, _ = _draw(tmpl, fn, x, y, tv, shape, levels=5)
    lv_j, paths_j, _ = _draw(jmpl, fn, x, y, v, shape, levels=5)
    np.testing.assert_array_equal(lv_t, lv_j)
    assert paths_t
    _same_paths(paths_t, paths_j)


def test_contourf_on_a_projection_matches_jax():
    area = (100, 120, 18, 32)
    lon, lat, _ = jutils.regular(area, (6, 7), z=0.0)
    v = np.cos(np.radians(lon)) * np.sin(np.radians(lat))
    lv_t, p_t, _ = _draw(tmpl, "contourf", lon, lat, v, (6, 7), 6,
                         basemap=tmpl.basemap(area, "merc"))
    lv_j, p_j, _ = _draw(jmpl, "contourf", lon, lat, v, (6, 7), 6,
                         basemap=jmpl.basemap(area, "merc"))
    np.testing.assert_array_equal(lv_t, lv_j)
    _same_paths(p_t, p_j)


def test_pcolor_and_m2km_match_jax():
    x, y, v, shape = _flat_grid()
    mt = tmpl.pcolor(x, y, torch.as_tensor(v), shape)
    tmpl.m2km()
    labels_t = [t.get_text() for t in plt.gca().get_xticklabels()]
    plt.figure()
    mj = jmpl.pcolor(x, y, v, shape)
    jmpl.m2km()
    labels_j = [t.get_text() for t in plt.gca().get_xticklabels()]
    np.testing.assert_array_equal(np.asarray(mt.get_array()),
                                  np.asarray(mj.get_array()))
    np.testing.assert_array_equal(mt.get_coordinates(), mj.get_coordinates())
    assert labels_t == labels_j


@pytest.mark.parametrize("proj", ["merc", "ortho", "stere", "robin", "cyl",
                                  "lcc"])
def test_basemap_projections_match_jax(proj):
    area = (100, 120, 18, 32)
    lon, lat = np.meshgrid(np.linspace(101, 119, 5), np.linspace(19, 31, 4))
    xt, yt = tmpl.basemap(area, proj)(lon, lat)
    xj, yj = jmpl.basemap(area, proj)(lon, lat)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(yt, yj)
    x0, _ = tmpl.basemap(area, proj)(110.0, 25.0)
    assert abs(float(x0)) < 1e-6 * tmpl.basemap(area, proj).R
    with pytest.raises(ValueError):
        tmpl.basemap(area, "not-a-projection")


def test_geodata_bit_for_bit():
    for name in ("WORLD_COASTLINES", "WORLD_BORDERS"):
        a, b = getattr(tgeo, name), getattr(jgeo, name)
        assert len(a) == len(b)
        for s, t in zip(a, b):
            np.testing.assert_array_equal(np.asarray(s), np.asarray(t))
    for area in (None, (100, 130, 5, 45), (-20, 40, -40, 40)):
        for fn in ("coastline_segments", "border_segments"):
            _same_paths(getattr(tgeo, fn)(area=area),
                        getattr(jgeo, fn)(area=area))


def test_load_segments_matches_jax(tmp_path):
    path = tmp_path / "lines.txt"
    path.write_text("# a polyline file\n100 20\n101 21\n102 21.5\n>\n"
                    "110 30\n111 31\n\n120 10\n")
    _same_paths(tgeo.load_segments(str(path)), jgeo.load_segments(str(path)))
    area = (100, 112, 18, 32)
    _same_paths(tgeo.coastline_segments(area, source=str(path)),
                jgeo.coastline_segments(area, source=str(path)))


def test_draw_geolines_coastlines_countries_match_jax():
    area = (100, 130, 5, 45)
    paths = []
    for mod in (tmpl, jmpl):
        m = mod.basemap(area, "merc")
        plt.figure()
        mod.draw_geolines(area, 5, 5, m)
        n0 = len(plt.gca().lines)
        mod.draw_coastlines(m)
        n1 = len(plt.gca().lines)
        mod.draw_countries(m)
        assert 0 < n0 < n1 < len(plt.gca().lines)
        paths.append(_paths(plt.gca()))
    _same_paths(*paths)


def _small_mesh(mesher):
    mesh = mesher.PrismMesh((0, 400, 0, 400, 0, 200), (100, 100, 100))
    rho = np.zeros(mesh.size)
    rho[::3] = 1.0
    mesh.addprop("density", rho)
    return mesh


def test_myv_prisms_match_jax():
    """The same face colours and axis limits; the tensor-valued property
    draws what its numpy copy draws."""
    out = []
    for mod, mesher, wrap in ((tmyv, tmesher, torch.as_tensor),
                              (jmyv, jmesher, np.asarray)):
        mesh = _small_mesh(mesher)
        mesh.props["density"] = wrap(mesh.props["density"])
        ax = mod.prisms(mesh, threshold=0.5)
        coll = ax.collections[0]
        out.append((np.asarray(coll.get_facecolor()), ax.get_xlim(),
                    ax.get_ylim(), ax.get_zlim()))
        plt.close("all")
    (fc_t, *lim_t), (fc_j, *lim_j) = out
    np.testing.assert_array_equal(fc_t, fc_j)
    assert lim_t == lim_j


def test_myv_prism_vertices_match_jax(monkeypatch):
    """``Poly3DCollection``'s input polygons, captured as built."""
    import mpl_toolkits.mplot3d.art3d as art3d
    seen = []
    real = art3d.Poly3DCollection

    class Capture(real):
        def __init__(self, verts, *args, **kwargs):
            seen.append([np.asarray(v) for v in verts])
            super().__init__(verts, *args, **kwargs)

    monkeypatch.setattr(art3d, "Poly3DCollection", Capture)
    for mod, mesher in ((tmyv, tmesher), (jmyv, jmesher)):
        mod.prisms(_small_mesh(mesher), threshold=0.5)
        bounds = (0, 400, 0, 400, 0, 200)
        ax = plt.gca()
        for wall in ("wall_north", "wall_south", "wall_east", "wall_west",
                     "wall_top", "wall_bottom"):
            getattr(mod, wall)(bounds, ax=ax)
        plt.close("all")
    half = len(seen) // 2
    assert half == 7 and len(seen[0]) == 6 * 11   # 11 of 32 cells drawn
    for a, b in zip(seen[:half], seen[half:]):
        _same_paths(a, b)


def test_myv_sphere_scene_matches_jax():
    scenes = []
    for mod in (tmyv, jmyv):
        ax = mod.earth()
        mod.core(ax=ax)
        mod.meridians([0, 90, 180, 270], ax=ax)
        mod.parallels([-45, 0, 45], ax=ax)
        with pytest.warns(UserWarning):
            mod.continents(ax=ax)
        pts = [(0, 0, 0), (45, 45, 1000.0)]
        mod.points(torch.as_tensor(pts) if mod is tmyv else pts,
                   spherical=True, ax=ax)
        mod.colorbar(None, ax=ax)
        mod.title("scene", ax=ax)
        mod.axes(ax)
        scenes.append([np.asarray(ln.get_data_3d()) for ln in ax.lines]
                      + [np.asarray(ax.collections[-1]._offsets3d)])
        plt.close("all")
    _same_paths(*scenes)


def test_layers_and_profile_match_jax():
    mesh_t, mesh_j = _small_mesh(tmesher), _small_mesh(jmesher)
    v = np.random.RandomState(0).rand(mesh_t.size)
    arrays = []
    for mod, mesh, vals in ((tmpl, mesh_t, torch.as_tensor(v)),
                            (jmpl, mesh_j, v)):
        fig = mod.layers(mesh, vals, ncols=2)
        prof = mod.profile(mesh, vals, axis="x", index=1)
        arrays.append([np.asarray(c.get_array()) for a in fig.axes
                       for c in a.collections]
                      + [np.asarray(c.get_array()) for a in prof.axes
                         for c in a.collections])
        plt.close("all")
    _same_paths(*arrays)
