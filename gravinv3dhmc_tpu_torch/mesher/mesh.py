"""Struct-of-arrays 3-D structured meshes (numpy, host only).

A copy of ``gravinv3dhmc_tpu/mesher/mesh.py``: :class:`StructuredMesh3D`,
:class:`PrismMesh`, :class:`TesseroidMesh` and the per-segment depth
spacing of :class:`PrismMeshSegment` and :class:`TesseroidMeshSegment`
(the realdata slice's mesh) and :class:`PrismRelief`. The JAX package
cannot be imported here (its ``__init__`` imports jax), so the numpy code
is carried over and ``tests/test_torch_host.py`` and
``tests/test_torch_utils.py`` hold it against the original.

Cell ordering matches the reference exactly: x fastest, then y, z slowest
(reference: mesher/mesh.py:131-138, 240-244).
"""
from __future__ import annotations

import numpy as np
import scipy.interpolate

from .geometry import Prism, Tesseroid


def _uniform_axis(a1, a2, d):
    """Number of cells and edges for one horizontal axis; the model range is
    enlarged to the next multiple of the spacing (reference:
    mesher/mesh.py:171-174)."""
    n = int(np.ceil((a2 - a1) / d))
    edges = a1 + d * np.arange(n + 1, dtype=np.float64)
    return n, edges


def _ratio_layers(z1, z2, dz, ratio):
    """Geometric-ratio depth layers (reference: mesher/mesh.py:177-205).

    Bottom depths form the geometric series S_k = dz*(1-ratio^(k+1))/(1-ratio);
    layers are added while the bottom is above z2 and more than dz remains.
    The final layer's bottom is clamped to z2.
    """
    if ratio == 1:
        nz = int(np.ceil((z2 - z1) / dz))
        ztop = z1 + dz * np.arange(nz, dtype=np.float64)
        zbot = ztop + dz
        return nz, ztop, zbot
    nz = 1
    while True:
        depth = z1 + dz * (1 - ratio ** nz) / (1 - ratio)
        if depth < z2 and (z2 - depth) > dz:
            nz += 1
        else:
            break
    k = np.arange(nz, dtype=np.float64)
    zbot = z1 + dz * (1 - ratio ** (k + 1)) / (1 - ratio)
    ztop = zbot - dz * ratio ** k
    zbot[-1] = z2
    return nz, ztop, zbot


def _segment_layers(divisionsection, dzlist):
    """Per-segment depth layers (reference: mesher/mesh.py:601-645).

    Each segment i spans divisionsection[i]..divisionsection[i+1] with its
    own spacing dzlist[i]; cell tops are div[i] + j*dz_i and bottoms are one
    spacing below (bottoms may overshoot the next breakpoint when the segment
    does not divide evenly — preserved from the reference's __getitem__,
    mesher/mesh.py:667-683).
    """
    ztop, zbot = [], []
    for i, dz in enumerate(dzlist):
        nzi = int(np.ceil((divisionsection[i + 1] - divisionsection[i]) / dz))
        j = np.arange(nzi, dtype=np.float64)
        top = divisionsection[i] + dz * j
        ztop.append(top)
        zbot.append(top + dz)
    ztop = np.concatenate(ztop)
    zbot = np.concatenate(zbot)
    return len(ztop), ztop, zbot


class StructuredMesh3D:
    """Common array-backed mesh machinery.

    Attributes:
        shape: (nz, ny, nx)
        size: nz*ny*nx
        xe, ye: horizontal cell-edge arrays, (nx+1,) and (ny+1,)
        ztop, zbot: per-layer top/bottom coordinate, (nz,)
        active: boolean (size,) — False for carved (masked) cells
        zdown: True for Cartesian (z positive down), False for spherical
    """

    celltype = Prism
    zdown = True
    #: where the topography test samples each layer: PrismMesh uses layer
    #: centres (reference: mesher/mesh.py:332-346), segment meshes use layer
    #: tops (reference: mesher/mesh.py:744-752)
    carve_at = "center"
    #: scattered-topography interpolation method used by carvetopo
    carve_interp = "cubic"

    def __init__(self, bounds, xe, ye, ztop, zbot, props=None):
        self.bounds = tuple(float(b) for b in bounds)
        self.xe = np.asarray(xe, dtype=np.float64)
        self.ye = np.asarray(ye, dtype=np.float64)
        self.ztop = np.asarray(ztop, dtype=np.float64)
        self.zbot = np.asarray(zbot, dtype=np.float64)
        nx = len(self.xe) - 1
        ny = len(self.ye) - 1
        nz = len(self.ztop)
        self.shape = (nz, ny, nx)
        self.size = nz * ny * nx
        self.active = np.ones(self.size, dtype=bool)
        self.props = dict(props) if props else {}
        self._i = 0

    # ------------------------------------------------------------------ core
    def cell_bounds(self, only_active=False):
        """Dense (size, 6) array of [x1, x2, y1, y2, z1, z2] per cell in
        reference ordering (x fastest, z slowest)."""
        nz, ny, nx = self.shape
        x1 = np.tile(self.xe[:-1], ny * nz)
        x2 = np.tile(self.xe[1:], ny * nz)
        y1 = np.tile(np.repeat(self.ye[:-1], nx), nz)
        y2 = np.tile(np.repeat(self.ye[1:], nx), nz)
        z1 = np.repeat(self.ztop, nx * ny)
        z2 = np.repeat(self.zbot, nx * ny)
        bounds = np.stack([x1, x2, y1, y2, z1, z2], axis=1)
        if only_active:
            bounds = bounds[self.active]
        return bounds

    def centers(self):
        """(size, 3) cell-centre coordinates (x, y, z)."""
        b = self.cell_bounds()
        return np.stack([
            0.5 * (b[:, 0] + b[:, 1]),
            0.5 * (b[:, 2] + b[:, 3]),
            0.5 * (b[:, 4] + b[:, 5]),
        ], axis=1)

    @property
    def n_active(self):
        return int(self.active.sum())

    @property
    def mask(self):
        """Reference-style list of carved cell indices
        (reference: mesher/mesh.py:224-226)."""
        return np.flatnonzero(~self.active).tolist()

    # ------------------------------------------------- reference-style access
    def addprop(self, prop, values):
        self.props[prop] = values

    def get_xs(self):
        return self.xe.copy()

    def get_ys(self):
        return self.ye.copy()

    def get_zs(self):
        """(nz+1,) layer-interface array: tops plus the final bottom
        (reference: mesher/mesh.py:421-445)."""
        return np.concatenate([self.ztop, self.zbot[-1:]])

    def __len__(self):
        return self.size

    def __getitem__(self, index):
        if index >= self.size or index < -self.size:
            raise IndexError("mesh index out of range")
        if index < 0:
            index = self.size + index
        if not self.active[index]:
            return None
        nz, ny, nx = self.shape
        k = index // (nx * ny)
        j = (index - k * nx * ny) // nx
        i = index - k * nx * ny - j * nx
        props = {p: self.props[p][index] for p in self.props}
        return self.celltype(self.xe[i], self.xe[i + 1],
                             self.ye[j], self.ye[j + 1],
                             self.ztop[k], self.zbot[k], props=props)

    def __iter__(self):
        self._i = 0
        return self

    def __next__(self):
        if self._i >= self.size:
            raise StopIteration
        cell = self[self._i]
        self._i += 1
        return cell

    # ------------------------------------------------------------- carvetopo
    def _carve_zsamples(self):
        if self.carve_at == "center":
            zc = 0.5 * (self.ztop + self.zbot)
        else:  # 'top'
            zc = self.ztop.copy()
        return zc

    def carvetopo(self, x, y, height, below=False):
        """Mask cells above (or below) a topographic surface.

        Scattered (x, y, height) samples are interpolated at cell centres
        (cubic for uniform/ratio meshes, nearest for segment meshes —
        reference: mesher/mesh.py:301-394, 717-797). Returns the
        reference-style list of carved indices and updates ``active``.
        """
        nz, ny, nx = self.shape
        xc = 0.5 * (self.xe[:-1] + self.xe[1:])
        yc = 0.5 * (self.ye[:-1] + self.ye[1:])
        zc = self._carve_zsamples()
        XC, YC = np.meshgrid(xc, yc)  # (ny, nx): y-major, x fastest
        topo = scipy.interpolate.griddata(
            (np.asarray(x), np.asarray(y)), np.asarray(height), (XC, YC),
            method=self.carve_interp).ravel()
        if self.zdown:
            topo = -topo
        nanmask = np.isnan(topo)
        # layer-major broadcast: mask index = k*nx*ny + (y, x flat index)
        if self.zdown:
            above = zc[:, None] < topo[None, :]
        else:
            above = zc[:, None] > topo[None, :]
        if below:
            above = ~above
        carved = (above | nanmask[None, :]).ravel()
        self.active &= ~carved
        return self.mask

    # ------------------------------------------------------------------- IO
    def dump(self, meshfile, propfile, prop):
        """Write the mesh and one property in UBC-GIF MeshTools3D format
        (reference: mesher/mesh.py:473-512)."""
        if prop not in self.props:
            raise ValueError(f"mesh doesn't have a '{prop}' property.")
        nz, ny, nx = self.shape
        x1, _, y1, _, z1, _ = self.bounds
        dx = self.xe[1] - self.xe[0]
        dy = self.ye[1] - self.ye[0]
        dz = self.zbot[0] - self.ztop[0]
        close = isinstance(meshfile, str)
        f = open(meshfile, "w") if close else meshfile
        f.writelines([
            "%d %d %d\n" % (ny, nx, nz),
            "%g %g %g\n" % (y1, x1, -z1),
            "%d*%g\n" % (ny, dy),
            "%d*%g\n" % (nx, dx),
            "%d*%g" % (nz, dz),
        ])
        if close:
            f.close()
        values = np.asarray(self.props[prop], dtype=np.float64).copy()
        values[~self.active] = -10000000
        reordered = np.ravel(np.reshape(values, self.shape), order="F")
        np.savetxt(propfile, reordered, fmt="%.4f")

    def copy(self):
        import copy as _copy
        return _copy.deepcopy(self)


class PrismMesh(StructuredMesh3D):
    """Cartesian mesh with uniform or geometric-ratio depth spacing.

    ``bounds = (xmin, xmax, ymin, ymax, zmin, zmax)``,
    ``spacing = (dz, dy, dx)``, ``ratio >= 1`` grows cell thickness with
    depth (reference: mesher/mesh.py:126-516).
    """

    celltype = Prism
    zdown = True
    carve_at = "center"
    carve_interp = "cubic"

    def __init__(self, bounds, spacing, ratio=1, props=None):
        dz, dy, dx = spacing
        x1, x2, y1, y2, z1, z2 = bounds
        self.dims = (dx, dy, dz)
        self.ratio = ratio
        nx, xe = _uniform_axis(x1, x2, dx)
        ny, ye = _uniform_axis(y1, y2, dy)
        nz, ztop, zbot = _ratio_layers(z1, z2, dz, ratio)
        if ratio == 1:
            bounds_big = (x1, x1 + nx * dx, y1, y1 + ny * dy, z1, z1 + nz * dz)
        else:
            bounds_big = (x1, x1 + nx * dx, y1, y1 + ny * dy, z1, z2)
        super().__init__(bounds_big, xe, ye, ztop, zbot, props=props)


class TesseroidMesh(PrismMesh):
    """Spherical mesh of tesseroids.

    ``bounds = (w, e, s, n, top, bottom)`` with w/e/s/n in degrees and
    top/bottom heights in metres (positive up, so ``dr`` in
    ``spacing = (dr, dlat, dlon)`` is negative);
    reference: mesher/mesh.py:518-559.
    """

    celltype = Tesseroid
    zdown = False

    def __init__(self, bounds, spacing, ratio=1, props=None):
        super().__init__(bounds, spacing, ratio, props=props)
        self.dump = None


class PrismMeshSegment(StructuredMesh3D):
    """Cartesian mesh with per-segment depth spacing.

    ``spacing = ([dz1, dz2, ...], dy, dx)`` and ``divisionsection`` gives the
    segment breakpoints, e.g. ``[0, 300, 900, 2100]``
    (reference: mesher/mesh.py:561-912).
    """

    celltype = Prism
    zdown = True
    carve_at = "top"
    carve_interp = "nearest"

    def __init__(self, bounds, spacing, divisionsection, props=None):
        dzlist, dy, dx = spacing
        x1, x2, y1, y2, z1, z2 = bounds
        self.dims = (dx, dy, dzlist)
        self.segment = len(dzlist)
        self.divisionsection = list(divisionsection)
        nx, xe = _uniform_axis(x1, x2, dx)
        ny, ye = _uniform_axis(y1, y2, dy)
        nz, ztop, zbot = _segment_layers(divisionsection, dzlist)
        bounds_big = (x1, x1 + nx * dx, y1, y1 + ny * dy, z1, zbot[-1])
        super().__init__(bounds_big, xe, ye, ztop, zbot, props=props)


class TesseroidMeshSegment(PrismMeshSegment):
    """Spherical segmented mesh (reference: mesher/mesh.py:914-955)."""

    celltype = Tesseroid
    zdown = False

    def __init__(self, bounds, spacing, divisionsection, props=None):
        super().__init__(bounds, spacing, divisionsection, props=props)
        self.dump = None


class PrismRelief:
    """Topography/basin relief as a collection of column prisms.

    ``ref`` is the reference depth; each (x, y, z) node produces a prism of
    plan size (dx, dy) spanning from z to ref (reference:
    mesher/mesh.py:23-124). ``addprop`` flips the sign of the property for
    prisms above the reference level, as the reference does
    (mesher/mesh.py:116-120).
    """

    def __init__(self, ref, dims, nodes):
        x, y, z = (np.asarray(a, dtype=np.float64) for a in nodes)
        if not (x.size == y.size == z.size):
            raise ValueError("x, y, z must have the same number of nodes")
        self.x, self.y, self.z = x, y, z
        self.size = x.size
        self.ref = float(ref)
        self.dy, self.dx = dims
        self.props = {}
        self._i = 0

    def __len__(self):
        return self.size

    def __getitem__(self, index):
        if index < 0:
            index = self.size + index
        xc, yc, zc = self.x[index], self.y[index], self.z[index]
        x1 = xc - 0.5 * self.dx
        x2 = xc + 0.5 * self.dx
        y1 = yc - 0.5 * self.dy
        y2 = yc + 0.5 * self.dy
        if zc <= self.ref:
            z1, z2 = zc, self.ref
        else:
            z1, z2 = self.ref, zc
        props = {p: self.props[p][index] for p in self.props}
        return Prism(x1, x2, y1, y2, z1, z2, props=props)

    def __iter__(self):
        self._i = 0
        return self

    def __next__(self):
        if self._i >= self.size:
            raise StopIteration
        p = self[self._i]
        self._i += 1
        return p

    def addprop(self, prop, values):
        values = np.asarray(values, dtype=np.float64).copy()
        flip = self.z > self.ref
        values[flip] = -values[flip]
        self.props[prop] = values
