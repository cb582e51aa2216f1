"""3-D mesh visualization (matplotlib backend).

The reference renders meshes with Mayavi/TVTK (reference: vis/myv.py:182,
335 — mostly commented out at its call sites). Mayavi is unavailable in
modern headless environments, so the same API surface is provided on
matplotlib's 3-D toolkit: ``prisms``/``tesseroids`` draw property-colored
cell boxes; ``figure``/``axes``/``savefig``/``show`` mirror the reference
entry points.

The port's copy of ``gravinv3dhmc_tpu/vis/myv.py``: matplotlib is
imported only inside the functions, and property values and points may be
torch tensors on any device (brought to the host by ``mpl._host``).
"""
from __future__ import annotations

import numpy as np

from .mpl import _host


def _plt():
    import matplotlib.pyplot as plt
    return plt


def figure(size=None, zdown=True):
    """New 3-D figure; z axis inverted for z-down meshes
    (reference: vis/myv.py:457-487)."""
    plt = _plt()
    fig = plt.figure(figsize=size or (8, 7))
    ax = fig.add_subplot(projection="3d")
    if zdown:
        ax.invert_zaxis()
    return ax


def prisms(mesh_or_cells, prop="density", ax=None, cmap=None, alpha=0.9,
           threshold=None, scale=(1.0, 1.0, 1.0)):
    """Draw prisms colored by a property (reference: vis/myv.py:335-456).

    ``threshold`` hides cells with |value| below it (otherwise dense
    meshes are unreadable); pass 0 to draw everything.
    """
    plt = _plt()
    if cmap is None:
        cmap = plt.cm.jet
    if hasattr(mesh_or_cells, "cell_bounds"):
        cells = mesh_or_cells.cell_bounds(only_active=True)
        values = _host(mesh_or_cells.props.get(prop, np.zeros(len(cells))))
        if values.size == mesh_or_cells.size:
            values = values[mesh_or_cells.active]
    else:
        cells = np.asarray(mesh_or_cells)
        values = np.zeros(len(cells))
    if ax is None:
        ax = figure()
    if threshold is None:
        threshold = 0.05 * np.abs(values).max() if values.size else 0.0
    keep = np.abs(values) >= threshold
    cells = cells[keep]
    values = values[keep]
    if values.size == 0:
        return ax
    norm = plt.Normalize(values.min(), values.max() or 1.0)
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection
    polys = []
    for (x1, x2, y1, y2, z1, z2) in cells:
        v = np.array([[x1, y1, z1], [x2, y1, z1], [x2, y2, z1], [x1, y2, z1],
                      [x1, y1, z2], [x2, y1, z2], [x2, y2, z2], [x1, y2, z2]])
        faces = [[0, 1, 2, 3], [4, 5, 6, 7], [0, 1, 5, 4],
                 [2, 3, 7, 6], [0, 3, 7, 4], [1, 2, 6, 5]]
        polys.extend([v[f] * np.array(scale) for f in faces])
    colors = np.repeat(cmap(norm(values)), 6, axis=0)
    coll = Poly3DCollection(polys, facecolors=colors, alpha=alpha,
                            edgecolor="k", linewidths=0.1)
    ax.add_collection3d(coll)
    allv = cells
    ax.set_xlim(allv[:, 0].min(), allv[:, 1].max())
    ax.set_ylim(allv[:, 2].min(), allv[:, 3].max())
    ax.set_zlim(allv[:, 5].max(), allv[:, 4].min())
    return ax


def tesseroids(mesh_or_cells, prop="density", ax=None, **kwargs):
    """Draw tesseroids in (lon, lat, height) box approximation
    (reference: vis/myv.py:182-334 transforms to Cartesian vertices; the
    box approximation keeps the plot readable without VTK)."""
    return prisms(mesh_or_cells, prop=prop, ax=ax, **kwargs)


def axes(ax, xlabel="x", ylabel="y", zlabel="z"):
    """Label axes (reference: vis/myv.py:457-530)."""
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_zlabel(zlabel)
    return ax


def outline(ax=None):
    """No-op compatibility shim (reference: vis/myv.py:531-560)."""
    return ax


def title(text, color=(0, 0, 0), size=0.3, height=1, ax=None):
    """Scene title (reference: vis/myv.py:89-111)."""
    plt = _plt()
    (ax or plt.gca()).set_title(text, color=color)
    return ax


def points(pts, color=(0, 0, 0), size=200.0, opacity=1, spherical=False,
           ax=None):
    """Scatter 3-D points (reference: vis/myv.py:142-181).

    ``spherical=True`` takes (lon, lat, height) triples and converts to
    Cartesian like the reference's Mayavi path.
    """
    pts = _host(pts).astype(float).reshape(-1, 3)
    if spherical:
        from ..utils import sph2cart
        x, y, z = sph2cart(pts[:, 0], pts[:, 1], pts[:, 2])
        pts = np.column_stack([x, y, z])
    if ax is None:
        ax = figure(zdown=not spherical)
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], color=color, s=size / 10.0,
               alpha=opacity)
    return ax


def colorbar(plot, ax=None):
    """Attach a colorbar to a collection returned by prisms/tesseroids
    (reference: vis/myv.py:888)."""
    plt = _plt()
    mappable = plot
    if not hasattr(plot, "get_array") or plot.get_array() is None:
        mappable = plt.cm.ScalarMappable(cmap=plt.cm.jet)
        mappable.set_array(np.array([0.0, 1.0]))
    return plt.colorbar(mappable, ax=ax or plt.gca())


def _wall(x, y, z, color, opacity, scale, ax):
    """Translucent quad face (reference: vis/myv.py:708-720)."""
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection
    if ax is None:
        ax = figure()
    sx, sy, sz = scale
    verts = [list(zip(np.asarray(x) * sx, np.asarray(y) * sy,
                      np.asarray(z) * sz))]
    ax.add_collection3d(Poly3DCollection(verts, facecolors=[color],
                                         alpha=opacity))
    return ax


def wall_north(bounds, color=(0, 0, 0), opacity=0.1, scale=(1, 1, 1),
               ax=None):
    """Wall at the north (max-x) face of ``bounds = [x1,x2,y1,y2,z1,z2]``
    (reference: vis/myv.py:564-587; x axis points north)."""
    x1, x2, y1, y2, z1, z2 = bounds
    return _wall([x2, x2, x2, x2], [y1, y2, y2, y1], [z1, z1, z2, z2],
                 color, opacity, scale, ax)


def wall_south(bounds, color=(0, 0, 0), opacity=0.1, scale=(1, 1, 1),
               ax=None):
    """Wall at the south (min-x) face (reference: vis/myv.py:588-611)."""
    x1, x2, y1, y2, z1, z2 = bounds
    return _wall([x1, x1, x1, x1], [y1, y2, y2, y1], [z1, z1, z2, z2],
                 color, opacity, scale, ax)


def wall_east(bounds, color=(0, 0, 0), opacity=0.1, scale=(1, 1, 1),
              ax=None):
    """Wall at the east (max-y) face (reference: vis/myv.py:612-635)."""
    x1, x2, y1, y2, z1, z2 = bounds
    return _wall([x1, x2, x2, x1], [y2, y2, y2, y2], [z1, z1, z2, z2],
                 color, opacity, scale, ax)


def wall_west(bounds, color=(0, 0, 0), opacity=0.1, scale=(1, 1, 1),
              ax=None):
    """Wall at the west (min-y) face (reference: vis/myv.py:636-659)."""
    x1, x2, y1, y2, z1, z2 = bounds
    return _wall([x1, x2, x2, x1], [y1, y1, y1, y1], [z1, z1, z2, z2],
                 color, opacity, scale, ax)


def wall_top(bounds, color=(0, 0, 0), opacity=0.1, scale=(1, 1, 1),
             ax=None):
    """Wall at the top (min-z for z-down) face
    (reference: vis/myv.py:660-683)."""
    x1, x2, y1, y2, z1, z2 = bounds
    return _wall([x1, x2, x2, x1], [y1, y1, y2, y2], [z1, z1, z1, z1],
                 color, opacity, scale, ax)


def wall_bottom(bounds, color=(0, 0, 0), opacity=0.1, scale=(1, 1, 1),
                ax=None):
    """Wall at the bottom (max-z for z-down) face
    (reference: vis/myv.py:684-707)."""
    x1, x2, y1, y2, z1, z2 = bounds
    return _wall([x1, x2, x2, x1], [y1, y1, y2, y2], [z2, z2, z2, z2],
                 color, opacity, scale, ax)


def _sphere(radius, color, opacity, ax, nlon=48, nlat=24):
    if ax is None:
        ax = figure(zdown=False)
    lon = np.linspace(0, 2 * np.pi, nlon)
    lat = np.linspace(-np.pi / 2, np.pi / 2, nlat)
    lon, lat = np.meshgrid(lon, lat)
    x = radius * np.cos(lat) * np.cos(lon)
    y = radius * np.cos(lat) * np.sin(lon)
    z = radius * np.sin(lat)
    ax.plot_surface(x, y, z, color=color, alpha=opacity, linewidth=0)
    return ax


def earth(color=(0.4, 0.5, 1.0), opacity=1, ax=None):
    """Mean-radius Earth sphere for spherical scenes
    (reference: vis/myv.py:758-784)."""
    from ..constants import MEAN_EARTH_RADIUS
    return _sphere(MEAN_EARTH_RADIUS, color, opacity, ax)


def core(inner=False, color=(1, 0, 0), opacity=1, ax=None):
    """Core-mantle (or inner-core) boundary sphere
    (reference: vis/myv.py:785-819)."""
    radius = 1216000.0 if inner else 3486000.0
    return _sphere(radius, color, opacity, ax)


def continents(color=(0, 0, 0), linewidth=1, resolution=2, opacity=1,
               radius=None, ax=None):
    """Continent outlines (reference: vis/myv.py:721-757 used Mayavi's
    builtin Earth surface). No coastline dataset ships with the framework;
    warns and returns the axes unchanged."""
    import warnings
    warnings.warn("continents: no coastline dataset bundled; skipping",
                  stacklevel=2)
    return ax


def meridians(longitudes, color=(0, 0, 0), linewidth=1, opacity=1, ax=None,
              radius=None):
    """Meridian great-circle arcs on the Earth sphere
    (reference: vis/myv.py:820-854)."""
    from ..constants import MEAN_EARTH_RADIUS
    if radius is None:
        radius = MEAN_EARTH_RADIUS
    if ax is None:
        ax = figure(zdown=False)
    lat = np.radians(np.linspace(-90, 90, 91))
    for lon_deg in np.atleast_1d(longitudes):
        lon = np.radians(float(lon_deg))
        x = radius * np.cos(lat) * np.cos(lon)
        y = radius * np.cos(lat) * np.sin(lon)
        z = radius * np.sin(lat)
        ax.plot(x, y, z, color=color, linewidth=linewidth, alpha=opacity)
    return ax


def parallels(latitudes, color=(0, 0, 0), linewidth=1, opacity=1, ax=None,
              radius=None):
    """Latitude circles on the Earth sphere
    (reference: vis/myv.py:855-887)."""
    from ..constants import MEAN_EARTH_RADIUS
    if radius is None:
        radius = MEAN_EARTH_RADIUS
    if ax is None:
        ax = figure(zdown=False)
    lon = np.radians(np.linspace(0, 360, 181))
    for lat_deg in np.atleast_1d(latitudes):
        lat = np.radians(float(lat_deg))
        x = radius * np.cos(lat) * np.cos(lon)
        y = radius * np.cos(lat) * np.sin(lon)
        z = np.full_like(lon, radius * np.sin(lat))
        ax.plot(x, y, z, color=color, linewidth=linewidth, alpha=opacity)
    return ax


def savefig(path, dpi=300):
    _plt().savefig(path, dpi=dpi, bbox_inches="tight")


def show():
    _plt().show()
