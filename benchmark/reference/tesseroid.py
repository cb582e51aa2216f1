"""Tesseroid gz, the South China stand-in's mesh and the depth weighting:
a plain reference in PyTorch and NumPy, float64 on any device.

The field: Uieda, Barbosa and Braitenberg (2016), "Tesseroids:
Forward-modeling gravitational fields in spherical coordinates",
Geophysics 81(5), F41-F48, as the upstream GravInv3DHMC runs it for gz
(``gravmag/tesseroid.py`` and ``gravmag/_tesseroid_numba.py``):

- Gauss-Legendre quadrature of order :data:`GLQ_ORDER` = 2 in longitude,
  latitude and radius (nodes +-1/sqrt(3), unit weights), the integrand
  ``r'^2 cos(lat') (r' cos(psi) - r) / l^3`` times the cell's
  ``dlon dlat dr / 8``, negated so that gz is positive down;
- the distance-to-size subdivision: a cell is halved along each axis
  whose size ``L`` has ``distance <= RATIO_GZ L`` (:data:`RATIO_GZ` = 1.6,
  the upstream's ratio for the gravity components), with the distance
  from the station to the cell's centre, ``L`` the arc of the cell's top
  along longitude and latitude (the upstream's arccos formulas) and its
  thickness along the radius; an axis is not halved below
  :data:`MIN_HORIZONTAL` = 0.1 m or :data:`MIN_RADIAL` = 1,000 m;
- a sphere of radius :data:`MEAN_EARTH_RADIUS` = 6,378,137 m, heights
  above it, and ``G`` = 0.00000006673 times 1e5 mGal per m/s^2 (the
  upstream's ``constants``), for a unit density.

Departures from the upstream, none of which changes a value here:

- the subdivision runs breadth first over every (station, cell) pair at
  once rather than on a stack per pair: the same leaves, summed in
  another order (rounding only);
- the upstream raises once a pair's stack passes 100 cells; here a pair
  is subdivided at most :data:`MAX_ROUNDS` times and what is left then is
  evaluated as it is. The stand-in's deepest pairs stop after about ten
  rounds.

The mesh (the upstream ``mesher.TesseroidMeshSegment`` and its
``carvetopo``): longitude and latitude edges ``w + k step`` up to the
region's east and north edges, layers per depth segment ``i`` with tops
``division[i] + j dz[i]`` (``dz`` negative: heights go down) and bottoms
one ``dz`` below, cells ordered longitude fastest, then latitude, then
layer. The carve drops every cell whose top lies above the topography of
its column, the topography taken from the nearest of the scattered
samples to the column's centre.

The depth weighting: ``w_j = (sum_i A_ij^2)^factor`` (factor 0.5) and
the weighted matrix ``A / w``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

GLQ_ORDER = 2
RATIO_GZ = 1.6
MIN_HORIZONTAL = 0.1
MIN_RADIAL = 1e3
MEAN_EARTH_RADIUS = 6378137.0
G = 0.00000006673
SI2MGAL = 100000.0
MAX_ROUNDS = 40

_D2R = math.pi / 180.0
_NODES = (-1.0 / math.sqrt(3.0), 1.0 / math.sqrt(3.0))


def segment_layers(division, dz):
    """``(tops, bottoms)`` (float64 arrays) of the segmented layers:
    segment i from ``division[i]`` to ``division[i + 1]`` in steps of
    ``dz[i]``."""
    tops, bottoms = [], []
    for i, d in enumerate(dz):
        n = int(math.ceil((division[i + 1] - division[i]) / d))
        for j in range(n):
            tops.append(division[i] + d * j)
            bottoms.append(division[i] + d * j + d)
    return np.array(tops), np.array(bottoms)


def edges(a1, a2, step):
    """The cell edges of one horizontal axis, ``a1 + k step`` up to the
    first at or past ``a2``."""
    n = int(math.ceil((a2 - a1) / step))
    return a1 + step * np.arange(n + 1, dtype=np.float64)


def region_cells(mrange, step, division, dz):
    """(N, 6) float64 cells ``[w, e, s, n, top, bottom]`` (degrees and
    metres) of the segmented mesh over ``mrange = (w, e, s, n, ...)``,
    ``step`` degrees wide, longitude fastest and layer slowest."""
    xe = edges(mrange[0], mrange[1], step)
    ye = edges(mrange[2], mrange[3], step)
    tops, bottoms = segment_layers(division, dz)
    nx, ny, nz = len(xe) - 1, len(ye) - 1, len(tops)
    ix = np.tile(np.arange(nx), ny * nz)
    iy = np.tile(np.repeat(np.arange(ny), nx), nz)
    iz = np.repeat(np.arange(nz), nx * ny)
    return np.stack([xe[ix], xe[ix + 1], ye[iy], ye[iy + 1], tops[iz],
                     bottoms[iz]], axis=1)


def carve(cells, lon, lat, topo):
    """(N,) bool: the cells that stay, those whose top is at or under the
    topography of their column, the nearest sample ``(lon, lat, topo)``
    to the column's centre."""
    lon, lat, topo = (np.asarray(v, np.float64) for v in (lon, lat, topo))
    xc = 0.5 * (cells[:, 0] + cells[:, 1])
    yc = 0.5 * (cells[:, 2] + cells[:, 3])
    d2 = (xc[:, None] - lon[None, :]) ** 2 + (yc[:, None] - lat[None, :]) ** 2
    return ~(cells[:, 4] > topo[np.argmin(d2, axis=1)])


def _geometry(b, lon, sinlat, coslat, radius):
    """Distance from each pair's station to its cell's centre, and the
    cell's sizes (Llon, Llat, Lr) in metres."""
    w, e, s, n, top, bottom = b.unbind(1)
    rt = 0.5 * (top + bottom) + MEAN_EARTH_RADIUS
    latt = _D2R * 0.5 * (s + n)
    sinlatt, coslatt = torch.sin(latt), torch.cos(latt)
    cospsi = sinlat * sinlatt + coslat * coslatt * torch.cos(
        lon - _D2R * 0.5 * (w + e))
    distance = torch.sqrt(radius * radius + rt * rt
                          - 2.0 * radius * rt * cospsi)
    rtop = top + MEAN_EARTH_RADIUS
    llon = rtop * torch.arccos(torch.clamp(
        sinlatt * sinlatt + coslatt * coslatt * torch.cos(_D2R * (e - w)),
        -1.0, 1.0))
    llat = rtop * torch.arccos(torch.clamp(
        torch.sin(_D2R * n) * torch.sin(_D2R * s)
        + torch.cos(_D2R * n) * torch.cos(_D2R * s), -1.0, 1.0))
    return distance, llon, llat, top - bottom


def _glq_gz(b, lon, sinlat, coslat, radius):
    """gz of each leaf cell at its pair's station, unit density, without
    the constant."""
    w, e, s, n, top, bottom = b.unbind(1)
    dlon, dlat, dr = _D2R * (e - w), _D2R * (n - s), top - bottom
    mlon, mlat = _D2R * 0.5 * (e + w), _D2R * 0.5 * (n + s)
    mr = 0.5 * (top + bottom) + MEAN_EARTH_RADIUS
    total = torch.zeros_like(w)
    for ti in _NODES:
        lonc = 0.5 * dlon * ti + mlon
        coslon = torch.cos(lon - lonc)
        for tj in _NODES:
            latc = 0.5 * dlat * tj + mlat
            sinlatc, coslatc = torch.sin(latc), torch.cos(latc)
            cospsi = sinlat * sinlatc + coslat * coslatc * coslon
            for tk in _NODES:
                rc = 0.5 * dr * tk + mr
                l2 = radius * radius + rc * rc - 2.0 * radius * rc * cospsi
                total = total + (rc * rc * coslatc * (rc * cospsi - radius)
                                 / (l2 * torch.sqrt(l2)))
    return -total * (dlon * dlat * dr * 0.125)


def _children(b, nlon, nlat, nr):
    """Each row of ``b`` cut into its nlon x nlat x nr children: ``(rows,
    bounds)``, the parent row of each child and the child's bounds."""
    rows = torch.arange(b.shape[0], device=b.device).repeat_interleave(8)
    code = torch.arange(8, device=b.device).repeat(b.shape[0])
    i, j, k = code // 4, (code // 2) % 2, code % 2
    keep = (i < nlon[rows]) & (j < nlat[rows]) & (k < nr[rows])
    rows, i, j, k = rows[keep], i[keep], j[keep], k[keep]
    p = b[rows]
    w, e, s, n, top, bottom = p.unbind(1)
    dlon = (e - w) / nlon[rows]
    dlat = (n - s) / nlat[rows]
    dr = (top - bottom) / nr[rows]
    return rows, torch.stack([w + i * dlon, w + (i + 1) * dlon,
                              s + j * dlat, s + (j + 1) * dlat,
                              bottom + (k + 1) * dr, bottom + k * dr], 1)


def gz_matrix(lon, lat, height, cells, device, ratio=RATIO_GZ, block=None):
    """(D, M) float64 gz (mGal) of unit-density tesseroids ``cells`` (M,
    6) at stations ``lon``, ``lat`` (degrees) and ``height`` (m), on
    ``device``, in blocks of stations."""
    f64 = dict(dtype=torch.float64, device=device)
    lon_r = torch.as_tensor(np.radians(np.asarray(lon, np.float64)), **f64)
    lat_r = torch.as_tensor(np.radians(np.asarray(lat, np.float64)), **f64)
    radius = torch.as_tensor(np.asarray(height, np.float64), **f64) \
        + MEAN_EARTH_RADIUS
    sinlat, coslat = torch.sin(lat_r), torch.cos(lat_r)
    cl = torch.as_tensor(np.asarray(cells, np.float64), **f64)
    D, M = lon_r.shape[0], cl.shape[0]
    block = block or max(1, int(2 ** 20 // max(M, 1)))
    out = torch.zeros((D, M), **f64)
    for s0 in range(0, D, block):
        nb = min(block, D - s0)
        obs = torch.arange(s0, s0 + nb, device=device).repeat_interleave(M)
        cell = torch.arange(M, device=device).repeat(nb)
        b = cl[cell]
        for r in range(MAX_ROUNDS + 1):
            at = (lon_r[obs], sinlat[obs], coslat[obs], radius[obs])
            dist, llon, llat, lr = _geometry(b, *at)
            one = torch.ones_like(obs)
            nlon = torch.where((dist <= ratio * llon)
                               & (llon > MIN_HORIZONTAL), 2 * one, one)
            nlat = torch.where((dist <= ratio * llat)
                               & (llat > MIN_HORIZONTAL), 2 * one, one)
            nr = torch.where((dist <= ratio * lr) & (lr > MIN_RADIAL),
                             2 * one, one)
            leaf = (nlon * nlat * nr == 1) | (r == MAX_ROUNDS)
            if leaf.any():
                out.index_put_((obs[leaf], cell[leaf]),
                               _glq_gz(b[leaf], *(v[leaf] for v in at)),
                               accumulate=True)
            split = ~leaf
            if not split.any():
                break
            rows, b = _children(b[split], nlon[split], nlat[split],
                                nr[split])
            obs, cell = obs[split][rows], cell[split][rows]
    return out * (G * SI2MGAL)


def weighting(A, factor=0.5):
    """Depth weights from column energies, ``w_j = (sum_i A_ij^2)^factor``,
    and the weighted matrix ``A / w`` (a zero column left as it is):
    ``(Aw, w)``."""
    w = (A * A).sum(0) ** factor
    inv = torch.where(w == 0, torch.zeros_like(w),
                      1.0 / torch.where(w == 0, torch.ones_like(w), w))
    return A * inv, w
