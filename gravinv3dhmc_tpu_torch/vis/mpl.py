"""Matplotlib plotting wrappers for gridded fields and mesh layers.

Re-implements the reference's fatiando-derived helpers
(reference: vis/mpl.py:184-435): ``contour``/``contourf``/``pcolor`` take
the flattened x, y, value vectors produced by :func:`utils.regular` plus
the grid ``shape`` and reshape internally. The Basemap wrappers of the
reference (vis/mpl.py:50-183) are reproduced on a small self-contained
projection object (:func:`basemap`) — the Basemap toolkit itself is dead
upstream, so the same calling convention (``m(lon, lat) -> (x, y)``) is
implemented directly for the projections the reference accepts.

The port's copy of ``gravinv3dhmc_tpu/vis/mpl.py``: host numpy and
matplotlib, which is imported only inside the functions (the module
imports without it). A values argument may also be a torch tensor on any
device; it is brought to the host first (:func:`_host`).
"""
from __future__ import annotations

import numpy as np

from ..constants import MEAN_EARTH_RADIUS


def _mpl():
    import matplotlib.pyplot as plt
    return plt


def _host(v):
    """``v`` as a host numpy array: a torch tensor (on any device) via
    ``.detach().cpu().numpy()``, anything else through ``np.asarray``."""
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class SimpleProjection:
    """Basemap-compatible map projection: ``m(lon, lat) -> (x, y)``.

    Implements the forward math for the projections the reference's
    :func:`basemap` accepts (reference: vis/mpl.py:113-182, which
    delegated to the now-dead Basemap toolkit). ``contourf(...,
    basemap=m)`` and the ``draw_*`` helpers consume this object exactly
    like reference plot scripts consume a Basemap instance.
    """

    def __init__(self, area, projection="merc"):
        self.area = tuple(float(a) for a in area)
        self.projection = projection
        west, east, south, north = self.area
        self.lon_0 = 0.5 * (west + east)
        self.lat_0 = 0.5 * (south + north)
        self.R = MEAN_EARTH_RADIUS

    def __call__(self, lon, lat):
        lon = np.asarray(lon, float)
        lat = np.asarray(lat, float)
        lam = np.radians(lon - self.lon_0)
        phi = np.radians(np.clip(lat, -89.9, 89.9))
        R = self.R
        if self.projection == "merc":
            ts = np.radians(self.lat_0)
            x = R * np.cos(ts) * lam
            y = R * np.cos(ts) * np.log(np.tan(np.pi / 4 + phi / 2))
        elif self.projection in ("ortho", "stere"):
            phi0 = np.radians(self.lat_0)
            cosc = (np.sin(phi0) * np.sin(phi)
                    + np.cos(phi0) * np.cos(phi) * np.cos(lam))
            if self.projection == "stere":
                k = 2.0 / np.maximum(1.0 + cosc, 1e-9)
            else:
                k = np.where(cosc >= 0, 1.0, np.nan)
            x = R * k * np.cos(phi) * np.sin(lam)
            y = R * k * (np.cos(phi0) * np.sin(phi)
                         - np.sin(phi0) * np.cos(phi) * np.cos(lam))
        elif self.projection == "robin":
            # Robinson via its standard interpolation table is overkill
            # for plot decoration; a flat-polar pseudocylindrical
            # approximation keeps graticules sensible.
            x = R * lam * (0.8507 - 0.1450 * (phi / (np.pi / 2)) ** 2)
            y = R * 0.9642 * phi
        else:  # cyl/cass/poly/lcc/geos/aeqd -> equirectangular fallback
            x = R * lam * np.cos(np.radians(self.lat_0))
            y = R * phi
        return x, y

    # Basemap-API conveniences used by reference plot scripts
    def drawmeridians(self, meridians, **kwargs):
        draw_geolines_meridians(self, meridians, **kwargs)

    def drawparallels(self, parallels, **kwargs):
        draw_geolines_parallels(self, parallels, **kwargs)


def basemap(area, projection, resolution="c"):
    """Make a map-projection object for plotting
    (reference: vis/mpl.py:113-182).

    Returns a :class:`SimpleProjection` with the Basemap calling
    convention; ``resolution`` (Basemap's coastline-dataset knob) is
    accepted for call compatibility — coastline fidelity is chosen by the
    ``source`` argument of :func:`draw_coastlines` instead.
    """
    if projection not in ["ortho", "aeqd", "geos", "robin", "cass", "merc",
                          "poly", "lcc", "stere", "cyl"]:
        raise ValueError(f"Unsupported projection '{projection}'")
    return SimpleProjection(area, projection)


def draw_geolines_meridians(bm, meridians, linewidth=0.5, style=":",
                            axis=None):
    plt = _mpl()
    ax = axis or plt.gca()
    west, east, south, north = bm.area
    lats = np.linspace(south, north, 73)
    for lon in np.atleast_1d(meridians):
        x, y = bm(np.full_like(lats, float(lon)), lats)
        ax.plot(x, y, style, color="k", linewidth=linewidth)


def draw_geolines_parallels(bm, parallels, linewidth=0.5, style=":",
                            axis=None):
    plt = _mpl()
    ax = axis or plt.gca()
    west, east, south, north = bm.area
    lons = np.linspace(west, east, 145)
    for lat in np.atleast_1d(parallels):
        x, y = bm(lons, np.full_like(lons, float(lat)))
        ax.plot(x, y, style, color="k", linewidth=linewidth)


def draw_geolines(area, dlon, dlat, basemap, linewidth=1):
    """Draw meridian/parallel graticule lines on a projected map
    (reference: vis/mpl.py:50-74)."""
    west, east, south, north = area
    meridians = np.arange(west, east + 0.5 * dlon, dlon)
    parallels = np.arange(south, north + 0.5 * dlat, dlat)
    draw_geolines_meridians(basemap, meridians, linewidth=linewidth)
    draw_geolines_parallels(basemap, parallels, linewidth=linewidth)


def _draw_segments(bm, segments, linewidth, style, color, ax=None):
    plt = _mpl()
    ax = ax or plt.gca()
    ls = {"solid": "-", "dashed": "--", "dotted": ":"}.get(style, style)
    for seg in segments:
        x, y = bm(seg[:, 0], seg[:, 1])
        ax.plot(x, y, ls, color=color, linewidth=linewidth)


def draw_countries(basemap, linewidth=1, style="dashed", source=None,
                   ax=None):
    """Country borders (reference: vis/mpl.py:75-93, which delegated to
    the dead Basemap toolkit's datasets).

    Draws from the embedded coarse border set
    (:mod:`gravinv3dhmc_tpu_torch.vis.geodata` — orientation quality, ~2-5
    degree fidelity) or from a user ``source`` polyline file
    (GMT/psxy-style ``lon lat`` segments)."""
    from .geodata import border_segments
    segs = border_segments(area=basemap.area, source=source)
    _draw_segments(basemap, segs, linewidth, style, "0.4", ax)


def draw_coastlines(basemap, linewidth=1, style="solid", source=None,
                    ax=None):
    """Coastlines (reference: vis/mpl.py:94-112).

    Data sources, in order of fidelity: a user ``source`` polyline file;
    a Surfer topography ``.grd`` whose zero contour is the exact regional
    coastline (pass its path as ``source`` — the realdata workload's
    ``topo_12d05d.grd`` works directly); the embedded coarse world set."""
    from .geodata import coastline_segments
    segs = coastline_segments(area=basemap.area, source=source)
    _draw_segments(basemap, segs, linewidth, style, "k", ax)


def m2km(axis=None):
    """Re-label the current axes from metres to kilometres
    (reference: vis/mpl.py:184-199)."""
    plt = _mpl()
    if axis is None:
        axis = plt.gca()
    axis.set_xticks(axis.get_xticks())
    axis.set_yticks(axis.get_yticks())
    axis.set_xticklabels([f"{0.001 * x:g}" for x in axis.get_xticks()])
    axis.set_yticklabels([f"{0.001 * y:g}" for y in axis.get_yticks()])


def _grid(x, y, v, shape):
    x = _host(x).reshape(shape)
    y = _host(y).reshape(shape)
    v = _host(v).reshape(shape)
    return x, y, v


def contour(x, y, v, shape, levels, interp=False, color="k", label=None,
            clabel=True, style="solid", linewidth=1.0, basemap=None):
    """Contour lines of a flattened regular grid
    (reference: vis/mpl.py:250-310). With ``basemap`` (a
    :class:`SimpleProjection`), x/y are lon/lat and are projected first,
    matching the reference's Basemap branch."""
    plt = _mpl()
    X, Y, V = _grid(x, y, v, shape)
    if basemap is not None:
        X, Y = basemap(X, Y)
    kwargs = dict(colors=color, linestyles=style, linewidths=linewidth)
    ct = plt.contour(X, Y, V, levels, **kwargs)
    if clabel:
        ct.clabel(fmt="%g")
    if label is not None:
        ct.collections[0].set_label(label)
    return ct.levels


def contourf(x, y, v, shape, levels, interp=False, cmap=None, basemap=None):
    """Filled contours of a flattened regular grid
    (reference: vis/mpl.py:313-370; realdata plot scripts pass
    ``basemap=`` — example/realdata/plot_real_multichain.py:182)."""
    plt = _mpl()
    if cmap is None:
        cmap = plt.cm.jet
    X, Y, V = _grid(x, y, v, shape)
    if basemap is not None:
        X, Y = basemap(X, Y)
    ct = plt.contourf(X, Y, V, levels, cmap=cmap)
    return ct.levels


def pcolor(x, y, v, shape, cmap=None, vmin=None, vmax=None, basemap=None):
    """Pseudo-color plot of a flattened regular grid
    (reference: vis/mpl.py:373-435)."""
    plt = _mpl()
    if basemap is not None:
        X, Y, V = _grid(x, y, v, shape)
        X, Y = basemap(X, Y)
        if cmap is None:
            cmap = plt.cm.jet
        return plt.pcolormesh(X, Y, V, cmap=cmap, vmin=vmin, vmax=vmax,
                              shading="auto")
    if cmap is None:
        cmap = plt.cm.jet
    X, Y, V = _grid(x, y, v, shape)
    return plt.pcolormesh(X, Y, V, cmap=cmap, vmin=vmin, vmax=vmax,
                          shading="auto")


def layers(mesh, values, prop_label="density", cmap=None, vmin=None,
           vmax=None, ncols=5, figsize=None, suptitle=None):
    """Plot every depth layer of a mesh model as a panel grid — the
    standard posterior-slice figure of the example plot scripts
    (reference: example/uniformgrid/plot_uniform.py:158-230).

    ``values`` is a flat dense model vector (use
    :func:`utils.carve2rho` first for carved meshes).
    """
    plt = _mpl()
    if cmap is None:
        cmap = plt.cm.jet
    nz, ny, nx = mesh.shape
    v3 = _host(values).reshape(nz, ny, nx)
    nrows = int(np.ceil(nz / ncols))
    fig, axes = plt.subplots(nrows, ncols,
                             figsize=figsize or (2.2 * ncols, 2.2 * nrows),
                             squeeze=False)
    if vmin is None:
        vmin = v3.min()
    if vmax is None:
        vmax = v3.max()
    zs = mesh.get_zs()
    for k in range(nrows * ncols):
        ax = axes[k // ncols][k % ncols]
        if k >= nz:
            ax.axis("off")
            continue
        im = ax.pcolormesh(v3[k].T, cmap=cmap, vmin=vmin, vmax=vmax,
                           shading="auto")
        ax.set_title(f"z {zs[k]:g}..{zs[k + 1]:g}", fontsize=8)
        ax.set_aspect("equal", adjustable="box")
    fig.colorbar(im, ax=axes.ravel().tolist(), label=prop_label)
    if suptitle:
        fig.suptitle(suptitle)
    return fig


def profile(mesh, values, axis="y", index=0, cmap=None, vmin=None,
            vmax=None):
    """Vertical cross-section through a mesh model
    (reference: example/uniformgrid/plot_uniform.py:232-264)."""
    plt = _mpl()
    if cmap is None:
        cmap = plt.cm.jet
    nz, ny, nx = mesh.shape
    v3 = _host(values).reshape(nz, ny, nx)
    fig, ax = plt.subplots()
    if axis == "y":
        sec = v3[:, :, index]
    else:
        sec = v3[:, index, :]
    im = ax.pcolormesh(sec, cmap=cmap, vmin=vmin, vmax=vmax, shading="auto")
    ax.invert_yaxis()
    fig.colorbar(im, ax=ax)
    return fig
