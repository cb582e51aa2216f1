"""Tesseroid (spherical prism) gz sensitivity matrix, Uieda et al. (2016),
on the host.

A numpy copy of ``gravinv3dhmc_tpu/ops/tesseroid.py``'s host builders
(the JAX package cannot be imported here): the vectorised adaptive
subdivision (``_distance_size``, ``_split_axis_counts``, ``_expand``,
:func:`adaptive_leaves`), the 2x2x2-node Gauss-Legendre point kernels
(``_glq_nodes``, ``_pair_terms``, ``_make_kernels`` with ``xp=np``), the
active-cell bounds with the degenerate-cell drop (``_tess_cells``) and
:func:`tesseroid_kernel_matrix`. ``tests/test_tesseroid_ops`` pins the
original against the reference engine; ``tests/test_torch_tesseroid.py``
holds this copy against the original.

The matrix is built in f64 on the host, as in the JAX package: by the
native C++/OpenMP engine (:mod:`..runtime.tessglq`, a copy of the JAX
package's ``tessglq.cpp``) or by the numpy worklist expansion. It is not
a TPU kernel. ``backend="auto"`` takes the native engine and falls back to
numpy only with a warning, and every build says which one ran (``info``).

The field forwards (``potential`` ... ``gzz`` of a mesh's density,
:func:`forward`) and the magnetics (:func:`tf`, :func:`bx`, :func:`by`,
:func:`bz`: Poisson's relation over the six tensor matrices,
``_tensor_kernels_local_down``) are copies of the JAX package's too. Not
copied yet (ROADMAP.md queue 1, item 12): ``subdivision_mask`` and the
device builder ``tesseroid_kernel_device``.
"""
from __future__ import annotations

import warnings

import numpy as np

from .. import constants
from ..constants import MEAN_EARTH_RADIUS

# accuracy ratios (reference: gravmag/tesseroid.py:76-79)
RATIO_V = 1
RATIO_G = 1.6
RATIO_GG = 8
STACK_SIZE = 100
#: maximum host expansion rounds (a stack depth equivalent)
MAX_DEPTH = 40

NODES = np.array([-0.577350269189625731058868041146,
                  0.577350269189625731058868041146])

D2R = np.pi / 180.0


# --------------------------------------------------------------------------
# host-side adaptive subdivision (vectorised reference algorithm)
# --------------------------------------------------------------------------

def _distance_size(lon, coslat, sinlat, radius, b):
    """Distance obs->cell centre and cell dimensions in metres
    (reference: gravmag/_tesseroid_numba.py:94-111).

    ``b`` is an (N, 6) bounds array [w, e, s, n, top, bottom] (degrees/m);
    obs arrays are per-pair (radians / sin / cos / m).
    """
    w, e, s, n, top, bottom = (b[:, i] for i in range(6))
    rt = 0.5 * (top + bottom) + MEAN_EARTH_RADIUS
    lont = D2R * 0.5 * (w + e)
    latt = D2R * 0.5 * (s + n)
    sinlatt = np.sin(latt)
    coslatt = np.cos(latt)
    cospsi = sinlat * sinlatt + coslat * coslatt * np.cos(lon - lont)
    distance = np.sqrt(radius ** 2 + rt ** 2 - 2 * radius * rt * cospsi)
    rtop = top + MEAN_EARTH_RADIUS
    Llon = rtop * np.arccos(
        np.clip(sinlatt ** 2 + coslatt ** 2 * np.cos(D2R * (e - w)), -1, 1))
    Llat = rtop * np.arccos(
        np.clip(np.sin(D2R * n) * np.sin(D2R * s)
                + np.cos(D2R * n) * np.cos(D2R * s), -1, 1))
    Lr = top - bottom
    return distance, Llon, Llat, Lr


def _split_axis_counts(distance, Llon, Llat, Lr, ratio):
    """Per-axis 1-or-2 split decision with minimum-size guards
    (reference: gravmag/_tesseroid_numba.py:135-157)."""
    nlon = np.where((distance <= ratio * Llon) & (Llon > 0.1), 2, 1)
    nlat = np.where((distance <= ratio * Llat) & (Llat > 0.1), 2, 1)
    nr = np.where((distance <= ratio * Lr) & (Lr > 1e3), 2, 1)
    undersized = (((distance <= ratio * Llon) & (Llon <= 0.1))
                  | ((distance <= ratio * Llat) & (Llat <= 0.1))
                  | ((distance <= ratio * Lr) & (Lr <= 1e3)))
    return nlon, nlat, nr, undersized


def _expand(b, nlon, nlat, nr):
    """Split each bounds row into its children (vectorised
    reference split(), gravmag/_tesseroid_numba.py:114-132)."""
    out = []
    w, e, s, n, top, bottom = (b[:, i] for i in range(6))
    dlon = (e - w) / nlon
    dlat = (n - s) / nlat
    dr = (top - bottom) / nr
    # children per row: nlon*nlat*nr in {2,4,8}; group rows by pattern
    for pat_lon in (1, 2):
        for pat_lat in (1, 2):
            for pat_r in (1, 2):
                sel = (nlon == pat_lon) & (nlat == pat_lat) & (nr == pat_r)
                if pat_lon * pat_lat * pat_r == 1 or not sel.any():
                    continue
                idx = np.flatnonzero(sel)
                for i in range(pat_lon):
                    for j in range(pat_lat):
                        for k in range(pat_r):
                            child = np.empty((idx.size, 6))
                            child[:, 0] = w[idx] + i * dlon[idx]
                            child[:, 1] = w[idx] + (i + 1) * dlon[idx]
                            child[:, 2] = s[idx] + j * dlat[idx]
                            child[:, 3] = s[idx] + (j + 1) * dlat[idx]
                            child[:, 4] = bottom[idx] + (k + 1) * dr[idx]
                            child[:, 5] = bottom[idx] + k * dr[idx]
                            out.append((idx, child))
    return out


def adaptive_leaves(lon_r, sinlat, coslat, radius, cells, ratio,
                    max_depth=MAX_DEPTH, pairs=None):
    """Resolve the adaptive subdivision for a block of observation points.

    Returns (pair_obs, pair_cell, leaf_bounds): flat arrays where each leaf
    is a (obs index within block, cell index, 6 bounds) quadrature task.

    ``pairs=(obs_idx, cell_idx)`` restricts the worklist to an explicit
    pair subset instead of the full (obs x cell) cross product — the
    near-field correction path of the device kernel builder.
    """
    n_obs = lon_r.size
    n_cells = cells.shape[0]
    if pairs is not None:
        obs_idx = np.asarray(pairs[0], dtype=np.int64)
        cell_idx = np.asarray(pairs[1], dtype=np.int64)
        bounds = np.asarray(cells, np.float64)[cell_idx]
    else:
        # initial worklist: the full (obs x cell) cross product
        obs_idx = np.repeat(np.arange(n_obs), n_cells)
        cell_idx = np.tile(np.arange(n_cells), n_obs)
        bounds = np.tile(cells, (n_obs, 1))

    leaves_obs, leaves_cell, leaves_b = [], [], []
    warned = False
    for _ in range(max_depth):
        if obs_idx.size == 0:
            break
        d, Llon, Llat, Lr = _distance_size(
            lon_r[obs_idx], coslat[obs_idx], sinlat[obs_idx],
            radius[obs_idx], bounds)
        nlon, nlat, nr, undersized = _split_axis_counts(d, Llon, Llat, Lr,
                                                        ratio)
        if undersized.any() and not warned:
            warnings.warn(
                "Stopped dividing a tesseroid because it's dimensions would "
                "be below the minimum numerical threshold (1e-6 degrees or "
                "1e-3 m). Will compute without division. Cannot guarantee "
                "the accuracy of the solution.", RuntimeWarning)
            warned = True
        total = nlon * nlat * nr
        done = total == 1
        leaves_obs.append(obs_idx[done])
        leaves_cell.append(cell_idx[done])
        leaves_b.append(bounds[done])
        todo = ~done
        if not todo.any():
            obs_idx = obs_idx[:0]
            break
        groups = _expand(bounds[todo], nlon[todo], nlat[todo], nr[todo])
        t_obs = obs_idx[todo]
        t_cell = cell_idx[todo]
        obs_parts, cell_parts, b_parts = [], [], []
        for idx, child in groups:
            obs_parts.append(t_obs[idx])
            cell_parts.append(t_cell[idx])
            b_parts.append(child)
        obs_idx = np.concatenate(obs_parts)
        cell_idx = np.concatenate(cell_parts)
        bounds = np.concatenate(b_parts)
    else:
        if obs_idx.size:
            # treat whatever is left as leaves (stack-overflow analogue;
            # the reference raises OverflowError at STACK_SIZE instead)
            leaves_obs.append(obs_idx)
            leaves_cell.append(cell_idx)
            leaves_b.append(bounds)
    return (np.concatenate(leaves_obs), np.concatenate(leaves_cell),
            np.concatenate(leaves_b))


# --------------------------------------------------------------------------
# GLQ point kernels (reference: gravmag/_tesseroid_numba.py:160-328)
# evaluated over flat leaf arrays; xp is numpy (the JAX package also passes
# jax.numpy, for its device builder)
# --------------------------------------------------------------------------

def _glq_nodes(b, xp):
    """Scaled 2-node GLQ abscissas per leaf
    (reference: gravmag/_tesseroid_numba.py:75-91).

    Returns (lonc, sinlatc, coslatc, rc) with shape (N, 2) and the (N,)
    volume scale.
    """
    w, e, s, n, top, bottom = (b[:, i] for i in range(6))
    nodes = xp.asarray(NODES, dtype=b.dtype)
    dlon = D2R * (e - w)
    dlat = D2R * (n - s)
    dr = top - bottom
    lonc = 0.5 * dlon[:, None] * nodes[None, :] + D2R * 0.5 * (e + w)[:, None]
    latc = 0.5 * dlat[:, None] * nodes[None, :] + D2R * 0.5 * (n + s)[:, None]
    sinlatc = xp.sin(latc)
    coslatc = xp.cos(latc)
    rc = (0.5 * dr[:, None] * nodes[None, :]
          + 0.5 * (top + bottom)[:, None] + MEAN_EARTH_RADIUS)
    scale = dlon * dlat * dr * 0.125
    return lonc, sinlatc, coslatc, rc, scale


def _pair_terms(lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc, xp):
    """Common per-(i,j,k) quantities for all kernels, vectorised over the
    2x2x2 node grid: returns arrays of shape (N, 2, 2, 2)."""
    coslon = xp.cos(lon[:, None] - lonc)            # (N, 2): i
    sinlon = xp.sin(lonc - lon[:, None])            # (N, 2): i
    # cospsi, kphi over (i, j)
    cospsi = (sinlat[:, None, None] * sinlatc[:, None, :]
              + coslat[:, None, None] * coslatc[:, None, :]
              * coslon[:, :, None])                 # (N, i, j)
    kphi = (coslat[:, None, None] * sinlatc[:, None, :]
            - sinlat[:, None, None] * coslatc[:, None, :]
            * coslon[:, :, None])                   # (N, i, j)
    rc_k = rc[:, None, None, :]                     # (N, 1, 1, k)
    l_sqr = (radius[:, None, None, None] ** 2 + rc_k ** 2
             - 2 * radius[:, None, None, None] * rc_k
             * cospsi[:, :, :, None])               # (N, i, j, k)
    kappa = (rc_k ** 2) * coslatc[:, None, :, None]  # (N, 1, j, k)
    return coslon, sinlon, cospsi, kphi, rc_k, l_sqr, kappa


def _pair_terms_stable(lon, sinlat, coslat, radius, lonc, sinlatc, coslatc,
                       rc, xp):
    """Cancellation-free variant of :func:`_pair_terms` for float32 device
    evaluation.

    The classic ``l_sqr = radius^2 + rc^2 - 2 radius rc cospsi`` cancels
    catastrophically at Earth-radius magnitude (~4e13) in f32 for pairs
    just outside the near-field mask (per-entry rel err up to ~1e-4).
    Rearranged as ``(radius - rc)^2 + 4 radius rc hav(psi)`` with the
    haversine ``hav = sin^2(dlat/2) + coslat coslatc sin^2(dlon/2)``:
    both terms are computed from SMALL differences, no large-square
    subtraction anywhere.
    """
    dlon = lon[:, None] - lonc
    coslon = xp.cos(dlon)                           # (N, 2): i
    sinlon = xp.sin(lonc - lon[:, None])            # (N, 2): i
    lat = xp.arctan2(sinlat, coslat)                # (N,)
    latc = xp.arctan2(sinlatc, coslatc)             # (N, 2): j
    sin_hlat = xp.sin(0.5 * (lat[:, None] - latc))  # (N, j)
    sin_hlon = xp.sin(0.5 * dlon)                   # (N, i)
    hav = ((sin_hlat ** 2)[:, None, :]
           + coslat[:, None, None] * coslatc[:, None, :]
           * (sin_hlon ** 2)[:, :, None])           # (N, i, j)
    cospsi = 1.0 - 2.0 * hav
    kphi = (coslat[:, None, None] * sinlatc[:, None, :]
            - sinlat[:, None, None] * coslatc[:, None, :]
            * coslon[:, :, None])                   # (N, i, j)
    rc_k = rc[:, None, None, :]                     # (N, 1, 1, k)
    # radial separation from small height differences: radius = R + h_obs
    # and rc = R + h_node, so (radius - rc) = h_obs - h_node exactly
    dr = (radius - MEAN_EARTH_RADIUS)[:, None, None, None] \
        - (rc_k - MEAN_EARTH_RADIUS)
    l_sqr = dr * dr + 4.0 * radius[:, None, None, None] * rc_k \
        * hav[:, :, :, None]                        # (N, i, j, k)
    kappa = (rc_k ** 2) * coslatc[:, None, :, None]  # (N, 1, j, k)
    return coslon, sinlon, cospsi, kphi, rc_k, l_sqr, kappa


def _sum_ijk(x, xp):
    return xp.sum(x, axis=(1, 2, 3))


def _make_kernels(xp, pair_terms=None):
    pair_terms = _pair_terms if pair_terms is None else pair_terms
    def kernelV(lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc):
        _, _, _, _, _, l_sqr, kappa = pair_terms(
            lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc, xp)
        return _sum_ijk(kappa / xp.sqrt(l_sqr), xp)

    def kernelx(lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc):
        _, _, _, kphi, rc_k, l_sqr, kappa = pair_terms(
            lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc, xp)
        return _sum_ijk(kappa * rc_k * kphi[:, :, :, None] / l_sqr ** 1.5, xp)

    def kernely(lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc):
        _, sinlon, _, _, rc_k, l_sqr, kappa = pair_terms(
            lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc, xp)
        deltay = rc_k * coslatc[:, None, :, None] * sinlon[:, :, None, None]
        return _sum_ijk(kappa * deltay / l_sqr ** 1.5, xp)

    def kernelz(lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc):
        _, _, cospsi, _, rc_k, l_sqr, kappa = pair_terms(
            lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc, xp)
        deltaz = rc_k * cospsi[:, :, :, None] - radius[:, None, None, None]
        # sign flip so gz is z-down positive (reference:
        # gravmag/_tesseroid_numba.py:219-223)
        return -_sum_ijk(kappa * deltaz / l_sqr ** 1.5, xp)

    def kernelxx(lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc):
        _, _, _, kphi, rc_k, l_sqr, kappa = pair_terms(
            lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc, xp)
        num = 3 * (rc_k * kphi[:, :, :, None]) ** 2 - l_sqr
        return _sum_ijk(kappa * num / l_sqr ** 2.5, xp)

    def kernelxy(lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc):
        _, sinlon, _, kphi, rc_k, l_sqr, kappa = pair_terms(
            lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc, xp)
        num = (3 * rc_k ** 2 * kphi[:, :, :, None]
               * coslatc[:, None, :, None] * sinlon[:, :, None, None])
        return _sum_ijk(kappa * num / l_sqr ** 2.5, xp)

    def kernelxz(lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc):
        _, _, cospsi, kphi, rc_k, l_sqr, kappa = pair_terms(
            lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc, xp)
        deltaz = rc_k * cospsi[:, :, :, None] - radius[:, None, None, None]
        num = 3 * rc_k * kphi[:, :, :, None] * deltaz
        return _sum_ijk(kappa * num / l_sqr ** 2.5, xp)

    def kernelyy(lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc):
        _, sinlon, _, _, rc_k, l_sqr, kappa = pair_terms(
            lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc, xp)
        deltay = rc_k * coslatc[:, None, :, None] * sinlon[:, :, None, None]
        return _sum_ijk(kappa * (3 * deltay ** 2 - l_sqr) / l_sqr ** 2.5, xp)

    def kernelyz(lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc):
        _, sinlon, cospsi, _, rc_k, l_sqr, kappa = pair_terms(
            lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc, xp)
        deltay = rc_k * coslatc[:, None, :, None] * sinlon[:, :, None, None]
        deltaz = rc_k * cospsi[:, :, :, None] - radius[:, None, None, None]
        return _sum_ijk(kappa * 3.0 * deltay * deltaz / l_sqr ** 2.5, xp)

    def kernelzz(lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc):
        _, _, cospsi, _, rc_k, l_sqr, kappa = pair_terms(
            lon, sinlat, coslat, radius, lonc, sinlatc, coslatc, rc, xp)
        deltaz = rc_k * cospsi[:, :, :, None] - radius[:, None, None, None]
        return _sum_ijk(kappa * (3 * deltaz ** 2 - l_sqr) / l_sqr ** 2.5, xp)

    return {
        "potential": kernelV, "gx": kernelx, "gy": kernely, "gz": kernelz,
        "gxx": kernelxx, "gxy": kernelxy, "gxz": kernelxz,
        "gyy": kernelyy, "gyz": kernelyz, "gzz": kernelzz,
    }


_NP_KERNELS = _make_kernels(np)

_RATIOS = {
    "potential": RATIO_V, "geoid": RATIO_V,
    "gx": RATIO_G, "gy": RATIO_G, "gz": RATIO_G,
    "gxx": RATIO_GG, "gxy": RATIO_GG, "gxz": RATIO_GG,
    "gyy": RATIO_GG, "gyz": RATIO_GG, "gzz": RATIO_GG,
}

_SCALES = {
    "potential": constants.G,
    "geoid": constants.G / constants.g0,
    "gx": constants.SI2MGAL * constants.G,
    # the reference scales gy with the spherical-SI constant
    # (gravmag/tesseroid.py:416-417)
    "gy": constants.SI2MGAL * constants.Gs,
    "gz": constants.SI2MGAL * constants.G,
    "gxx": constants.SI2EOTVOS * constants.G,
    "gxy": constants.SI2EOTVOS * constants.G,
    "gxz": constants.SI2EOTVOS * constants.G,
    "gyy": constants.SI2EOTVOS * constants.G,
    "gyz": constants.SI2EOTVOS * constants.G,
    "gzz": constants.SI2EOTVOS * constants.G,
}


def _tess_cells(mesh_or_cells):
    """(M, 6) [w, e, s, n, top, bottom] bounds of active cells."""
    if hasattr(mesh_or_cells, "cell_bounds"):
        cells = np.asarray(mesh_or_cells.cell_bounds(only_active=True),
                           dtype=np.float64)
    else:
        cells = np.asarray(mesh_or_cells, dtype=np.float64)
    # validity checks (reference: gravmag/tesseroid.py:126-153)
    w, e, s, n, top, bottom = (cells[:, i] for i in range(6))
    assert (w <= e).all() and (s <= n).all() and (top >= bottom).all(), \
        "Invalid tesseroid dimensions"
    degenerate = ((e - w <= 1e-6) | (n - s <= 1e-6) | (top - bottom <= 1e-3))
    if degenerate.any():
        warnings.warn(
            "Encountered tesseroid with dimensions smaller than the "
            "numerical threshold (1e-6 degrees or 1e-3 m). "
            "Ignoring this tesseroid.", RuntimeWarning)
        cells = cells[~degenerate]
    return cells


def tesseroid_kernel_matrix(field, lon, lat, height, mesh_or_cells,
                            ratio=None, obs_block=256, backend="auto",
                            info=None):
    """Dense (D, M) f64 sensitivity matrix of a tesseroid field in output
    units.

    Each column holds the field of a unit-density (1 g/cm^3) tesseroid,
    equivalent to the reference's ``kernel2d`` accumulation
    (reference: gravmag/_tesseroid_numba.py:63-69).

    Backends: ``'native'`` -- the C++/OpenMP adaptive-stack engine
    (``runtime/native/tessglq.cpp``); ``'numpy'`` -- vectorised host
    worklist expansion + batched GLQ; ``'auto'`` -- native, and numpy with
    a ``RuntimeWarning`` when the native engine cannot be built or loaded.
    Both produce the same leaves; they cross-check each other in tests.
    ``info``, a dict, receives ``"tess_backend"``: the backend that built
    the matrix.
    """
    if field not in _SCALES:
        raise ValueError(f"unknown tesseroid field {field!r}")
    if backend not in ("auto", "native", "numpy"):
        raise ValueError(f"unknown tesseroid backend {backend!r}")
    info = {} if info is None else info
    ratio = _RATIOS[field] if ratio is None else ratio
    cells = _tess_cells(mesh_or_cells)
    lon = np.asarray(lon, dtype=np.float64).ravel()
    lat = np.asarray(lat, dtype=np.float64).ravel()
    height = np.asarray(height, dtype=np.float64).ravel()
    assert lon.shape == lat.shape == height.shape, \
        "Input coordinate arrays must have same shape"
    assert ratio > 0, f"Invalid ratio {ratio}. Must be > 0."
    D, M = lon.size, cells.shape[0]
    kname = "potential" if field == "geoid" else field

    if backend in ("auto", "native"):
        try:
            from ..runtime import tessglq
            kernel = tessglq.kernel_matrix(kname, lon, lat, height, cells,
                                           ratio)
            info["tess_backend"] = "native"
            return kernel * _SCALES[field]
        except Exception as e:  # noqa: BLE001 -- reported, not silent
            if backend == "native":
                raise
            warnings.warn(f"native tesseroid engine unavailable "
                          f"({type(e).__name__}: {e}); building the matrix "
                          f"with numpy", RuntimeWarning)
    info["tess_backend"] = "numpy"
    # coordinate conversion (reference: gravmag/tesseroid.py:108-123)
    lon_r = np.radians(lon)
    lat_r = np.radians(lat)
    sinlat = np.sin(lat_r)
    coslat = np.cos(lat_r)
    radius = MEAN_EARTH_RADIUS + height

    kfn = _NP_KERNELS[kname]
    kernel = np.zeros((D, M))
    for s0 in range(0, D, obs_block):
        s1 = min(s0 + obs_block, D)
        p_obs, p_cell, leaf_b = adaptive_leaves(
            lon_r[s0:s1], sinlat[s0:s1], coslat[s0:s1], radius[s0:s1],
            cells, ratio)
        lonc, sinlatc, coslatc, rc, scale = _glq_nodes(leaf_b, np)
        vals = scale * kfn(lon_r[s0:s1][p_obs], sinlat[s0:s1][p_obs],
                           coslat[s0:s1][p_obs], radius[s0:s1][p_obs],
                           lonc, sinlatc, coslatc, rc)
        np.add.at(kernel, (s0 + p_obs, p_cell), vals)
    kernel *= _SCALES[field]
    return kernel


def _tess_field(field):
    def compute(lon, lat, height, model, dens=None, ratio=None, njobs=1,
                pool=None, **_ignored):
        """Field value and sensitivity matrix, reference-compatible API
        (reference: gravmag/tesseroid.py:324-508): returns
        ``(res, kernel2d)`` with res = kernel2d @ densities. ``njobs`` and
        ``pool`` are accepted for parity and ignored."""
        kernel2d = tesseroid_kernel_matrix(field, lon, lat, height, model,
                                           ratio=ratio)
        if dens is not None:
            densities = np.full(kernel2d.shape[1], float(dens))
        elif hasattr(model, "props") and "density" in model.props:
            densities = np.asarray(model.props["density"],
                                   dtype=np.float64)[model.active]
        else:
            densities = np.zeros(kernel2d.shape[1])
        res = kernel2d @ densities
        return res, kernel2d

    compute.__name__ = field
    return compute


potential = _tess_field("potential")
geoid = _tess_field("geoid")
gx = _tess_field("gx")
gy = _tess_field("gy")
gz = _tess_field("gz")
gxx = _tess_field("gxx")
gxy = _tess_field("gxy")
gxz = _tess_field("gxz")
gyy = _tess_field("gyy")
gyz = _tess_field("gyz")
gzz = _tess_field("gzz")


def forward(field, lon, lat, height, model, dens=None, ratio=None):
    """Forward-only evaluation: the field of the model's density (the
    reference's ``tesseroidforward`` module,
    reference: gravmag/tesseroidforward.py)."""
    res, _ = _tess_field(field)(lon, lat, height, model, dens=dens,
                                ratio=ratio)
    return res


# --------------------------------------------------------------------------
# magnetics (the JAX package's extension; the reference declares
# spherical magnetics unimplemented, readme.md:9-18): Poisson's relation,
# the induction of a uniformly magnetized body is the gravity-gradient
# tensor of the same geometry contracted with the magnetization vector
# --------------------------------------------------------------------------

def _tensor_kernels_local_down(lons, lats, heights, mesh_or_cells,
                               ratio=None, backend="auto", info=None):
    """Six RAW tensor kernel matrices in the local x=north, y=east,
    z=DOWN frame (the prism/magnetics convention, :mod:`.prism`).

    The GLQ tensor kernels use a local z-UP radial axis, so the mixed
    z terms flip sign (gxz/gyz). "Raw" = each field's output scaling
    divided back out (this also neutralises the reference's Gs-on-gy
    quirk, which must not leak into magnetics). ``info`` receives the
    builder's ``tess_backend``.
    """
    vs = []
    for f in ("gxx", "gxy", "gxz", "gyy", "gyz", "gzz"):
        k = tesseroid_kernel_matrix(f, lons, lats, heights, mesh_or_cells,
                                    ratio=ratio, backend=backend, info=info)
        k = k / _SCALES[f]
        if f in ("gxz", "gyz"):
            k = -k
        vs.append(k)
    return vs


def tf(lons, lats, heights, mesh_or_cells, inc, dec, pmag=None,
       ratio=None, backend="auto", info=None, **_ignored):
    """Total-field magnetic anomaly of tesseroids and its sensitivity
    matrix, with the API and conventions of :func:`.prism.tf` (inc/dec in
    degrees, inc positive down; output nT via CM * T2NT; ``kernel2d``
    columns = unit INDUCED magnetization along the regional field).
    ``info`` receives the builder's ``tess_backend``."""
    from ..utils.units import dircos
    from .prism import _magnetization_vectors, _project

    cells = _tess_cells(mesh_or_cells)
    M = cells.shape[0]
    fdir = dircos(inc, dec)
    fx, fy, fz = fdir
    # magnetization override rules shared with the prism driver (bounds
    # units differ between prisms and tesseroids, props do not)
    mvec = _magnetization_vectors(mesh_or_cells, pmag, fdir, M)
    vs = _tensor_kernels_local_down(lons, lats, heights, mesh_or_cells,
                                    ratio=ratio, backend=backend, info=info)
    scale = constants.CM * constants.T2NT
    bxm, bym, bzm = _project(vs, (mvec[0][None, :], mvec[1][None, :],
                                  mvec[2][None, :]))
    res = (fx * bxm + fy * bym + fz * bzm).sum(axis=1) * scale
    bxf, byf, bzf = _project(vs, (fx, fy, fz))
    kernel2d = (fx * bxf + fy * byf + fz * bzf) * scale
    return res, kernel2d


def _b_component_tess(index):
    def compute(lons, lats, heights, mesh_or_cells, pmag=None, ratio=None,
                backend="auto", **_ignored):
        """One component of the magnetic induction (nT), local x=north /
        y=east / z=down: the tesseroid counterpart of
        ``prism.bx``/``by``/``bz`` (result only)."""
        from .prism import _project

        cells = _tess_cells(mesh_or_cells)
        M = cells.shape[0]
        if pmag is not None:
            vec = np.asarray(pmag, dtype=np.float64).reshape(3, 1)
            mvec = np.broadcast_to(vec, (3, M))
        else:
            values = None
            if hasattr(mesh_or_cells, "props"):
                values = mesh_or_cells.props.get("magnetization")
                if values is not None:
                    values = np.asarray(values,
                                        np.float64)[mesh_or_cells.active]
            if values is None or np.asarray(values).ndim != 2:
                raise ValueError(
                    "b-components need vector magnetization or pmag")
            mvec = np.asarray(values, dtype=np.float64).T
        vs = _tensor_kernels_local_down(lons, lats, heights,
                                        mesh_or_cells, ratio=ratio,
                                        backend=backend)
        comps = _project(vs, (mvec[0][None, :], mvec[1][None, :],
                              mvec[2][None, :]))
        return comps[index].sum(axis=1) * constants.CM * constants.T2NT

    return compute


bx = _b_component_tess(0)
by = _b_component_tess(1)
bz = _b_component_tess(2)
