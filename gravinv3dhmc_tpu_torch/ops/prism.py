"""Closed-form right-rectangular-prism forward operators (Nagy et al. 2000).

A copy of ``gravinv3dhmc_tpu/ops/prism.py``: every field is a vectorised
function of an (obs-block, cells) grid evaluated at the eight prism
corners with alternating signs, producing the dense sensitivity matrix
(D x M) in one pass, with the reference's singularity handling
(corner-aligned radius dodges for gxy/gxz/gyz, zero-guarded log/atan2;
reference: gravmag/_prism.pyx:16-34, 346-354, 380-385, 443-448). The
point kernels, ``_dodged_radius`` and ``_eval_block`` take an ``xp``
argument, numpy or torch, as the JAX package's take numpy or jax.numpy.

Builders (:func:`prism_kernel_matrix`):

* ``backend='numpy'``: float64 on the host, the default (the corner
  difference cancels catastrophically in f32 for distant cells).
* ``backend='jax'`` keeps the JAX package's name for its device builder
  (float64 under the package's x64): here ``_eval_block`` with
  ``xp=torch`` on ``device`` (``cuda:0`` when None), in ``dtype`` (float64
  by default), chunked over observations by the JAX rule ``4e6 // M``.
  Plain PyTorch: the JAX builder is XLA, not a Pallas kernel.
* ``backend='pallas'`` keeps the JAX package's name for its f32 gz
  builder: the hand-written CUDA kernels of :mod:`.prism_gz` on a CUDA
  device (their plain PyTorch versions on the CPU); gz only, as in the JAX
  package.

Magnetics (:func:`tf`, :func:`bx`, :func:`by`, :func:`bz`) are host
float64, as in the JAX package. Units follow the reference exactly:
densities in g/cm^3, coordinates in metres, gz in mGal via ``G * SI2MGAL``
(reference: gravmag/prism.py:291-316), tensors in Eotvos, total-field
anomaly via ``CM * T2NT`` (reference: gravmag/prism.py:729-731).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import constants
from .._device import resolve
from ..utils.units import dircos
from .prism_gz import gz_kernel_matrix

__all__ = [
    "potential", "geoid", "gx", "gy", "gz",
    "gxx", "gxy", "gxz", "gyy", "gyz", "gzz",
    "tf", "bx", "by", "bz",
    "prism_kernel_matrix", "GRAVITY_FIELDS",
]


# --------------------------------------------------------------------------
# guarded primitives (reference: gravmag/_prism.pyx:16-34)
# --------------------------------------------------------------------------

def _safe_log(x, xp):
    return xp.where(x == 0, 0.0, xp.log(xp.where(x == 0, 1.0, x)))


def _safe_atan2(y, x, xp):
    res = xp.arctan2(y, x)
    res = xp.where((y > 0) & (x < 0), res - np.pi, res)
    res = xp.where((y < 0) & (x < 0), res + np.pi, res)
    # reference convention: y == 0 -> 0 REGARDLESS of x's sign
    # (gravmag/_prism.pyx:17-19). numpy's atan2(0, x<0) is +-pi, which
    # would shift gx/gy/tensor kernels by O(pi) per corner for
    # observation points lying exactly in a corner-aligned plane
    # (e.g. dy == 0 with dx < 0 in kernelx's atan2(dz*dy, dx*r)).
    return xp.where(y == 0, xp.zeros_like(res), res)


# --------------------------------------------------------------------------
# point kernels: functions of corner offsets (dx, dy, dz) and radius r
# (reference: gravmag/_prism.pyx:36-68). Gravity kernels carry the minus of
# -grad(V) where Nagy gives grad(V).
# --------------------------------------------------------------------------

def _kernelpot(dx, dy, dz, r, xp):
    return (dx * dy * _safe_log(dz + r, xp)
            + dy * dz * _safe_log(dx + r, xp)
            + dx * dz * _safe_log(dy + r, xp)
            - 0.5 * dx ** 2 * _safe_atan2(dz * dy, dx * r, xp)
            - 0.5 * dy ** 2 * _safe_atan2(dz * dx, dy * r, xp)
            - 0.5 * dz ** 2 * _safe_atan2(dx * dy, dz * r, xp))


def _kernelx(dx, dy, dz, r, xp):
    return -(dy * _safe_log(dz + r, xp) + dz * _safe_log(dy + r, xp)
             - dx * _safe_atan2(dz * dy, dx * r, xp))


def _kernely(dx, dy, dz, r, xp):
    return -(dz * _safe_log(dx + r, xp) + dx * _safe_log(dz + r, xp)
             - dy * _safe_atan2(dx * dz, dy * r, xp))


def _kernelz(dx, dy, dz, r, xp):
    return -(dx * _safe_log(dy + r, xp) + dy * _safe_log(dx + r, xp)
             - dz * _safe_atan2(dx * dy, dz * r, xp))


def _kernelxx(dx, dy, dz, r, xp):
    return -_safe_atan2(dz * dy, dx * r, xp)


def _kernelxy(dx, dy, dz, r, xp):
    return _safe_log(dz + r, xp)


def _kernelxz(dx, dy, dz, r, xp):
    return _safe_log(dy + r, xp)


def _kernelyy(dx, dy, dz, r, xp):
    return -_safe_atan2(dz * dx, dy * r, xp)


def _kernelyz(dx, dy, dz, r, xp):
    return _safe_log(dx + r, xp)


def _kernelzz(dx, dy, dz, r, xp):
    return -_safe_atan2(dx * dy, dz * r, xp)


_POINT_KERNELS = {
    "potential": _kernelpot,
    "gx": _kernelx,
    "gy": _kernely,
    "gz": _kernelz,
    "gxx": _kernelxx,
    "gxy": _kernelxy,
    "gxz": _kernelxz,
    "gyy": _kernelyy,
    "gyz": _kernelyz,
    "gzz": _kernelzz,
}

# per-field corner-singularity radius dodges
# (reference: gravmag/_prism.pyx:346-354, 380-385, 443-448)
_DODGE_AXES = {"gxy": ("x", "y", "z"), "gxz": ("x", "z", "y"), "gyz": ("y", "z", "x")}

_SCALES = {
    "potential": constants.G,
    "geoid": constants.G / constants.g0,
    "gx": constants.G * constants.SI2MGAL,
    "gy": constants.G * constants.SI2MGAL,
    "gz": constants.G * constants.SI2MGAL,
    "gxx": constants.G * constants.SI2EOTVOS,
    "gxy": constants.G * constants.SI2EOTVOS,
    "gxz": constants.G * constants.SI2EOTVOS,
    "gyy": constants.G * constants.SI2EOTVOS,
    "gyz": constants.G * constants.SI2EOTVOS,
    "gzz": constants.G * constants.SI2EOTVOS,
}

GRAVITY_FIELDS = tuple(_SCALES)


def _dodged_radius(field, dx, dy, dz, cell_ext, xp):
    """Radius with the reference's corner-aligned singularity dodge.

    ``cell_ext`` is the (M, 3) array of cell extents (x2-x1, y2-y1, z2-z1).
    """
    r = xp.sqrt(dx * dx + dy * dy + dz * dz)
    axes = _DODGE_AXES.get(field)
    if axes is None:
        return r
    d = {"x": dx, "y": dy, "z": dz}
    ext = {"x": cell_ext[:, 0], "y": cell_ext[:, 1], "z": cell_ext[:, 2]}
    a1, a2, a3 = axes
    cond = (d[a1] == 0) & (d[a2] == 0) & (d[a3] < 0)
    t1 = 1e-5 * ext[a1]
    t2 = 1e-5 * ext[a2]
    r_dodge = xp.sqrt(t1 * t1 + t2 * t2 + d[a3] * d[a3])
    return xp.where(cond, r_dodge, r)


def _corner_offsets(obs, cells, corner, xp):
    """Offsets of one of the 8 prism corners from each observation point.

    ``corner = (i, j, k)`` indexes [upper, lower] bounds per axis, matching
    the reference's x=[x2,x1] ordering so the sign is (-1)^(i+j+k)
    (reference: gravmag/_prism.pyx:281-290).
    """
    i, j, k = corner
    xo, yo, zo = obs
    dx = cells[:, 1 - i][None, :] - xo[:, None]
    dy = cells[:, 3 - j][None, :] - yo[:, None]
    dz = cells[:, 5 - k][None, :] - zo[:, None]
    return dx, dy, dz


def _eval_block(field, obs, cells, cell_ext, xp):
    """(B, M) kernel-matrix block for one gravity field."""
    kfn = _POINT_KERNELS["potential" if field == "geoid" else field]
    acc = None
    for i in range(2):
        for j in range(2):
            for k in range(2):
                dx, dy, dz = _corner_offsets(obs, cells, (i, j, k), xp)
                r = _dodged_radius(field, dx, dy, dz, cell_ext, xp)
                term = kfn(dx, dy, dz, r, xp)
                if (i + j + k) % 2:
                    term = -term
                acc = term if acc is None else acc + term
    return acc


def _as_cells(mesh_or_cells, prop="density"):
    """Normalise input to (cells (M,6) f64, per-cell property values or None).

    Accepts a mesher mesh (active cells only, reference skips masked prisms,
    gravmag/prism.py:298-301) or a raw (M, 6) bounds array.
    """
    if hasattr(mesh_or_cells, "cell_bounds"):
        mesh = mesh_or_cells
        cells = np.asarray(mesh.cell_bounds(only_active=True), dtype=np.float64)
        values = mesh.props.get(prop)
        if values is not None:
            values = np.asarray(values, dtype=np.float64)[mesh.active]
        return cells, values
    cells = np.asarray(mesh_or_cells, dtype=np.float64)
    if cells.ndim != 2 or cells.shape[1] != 6:
        raise ValueError("cells must be a (M, 6) bounds array or a mesh")
    return cells, None


def prism_kernel_matrix(field, xo, yo, zo, mesh_or_cells, backend="numpy",
                        obs_chunk=None, dtype=None, device=None,
                        timings=None):
    """Dense (D, M) sensitivity matrix of one field, in output units, as
    a numpy array.

    Each column holds the field of a unit-density (1 g/cm^3) prism
    (reference: gravmag/_prism.pyx:289-290). ``backend="numpy"``: float64
    on the host. ``backend="jax"``: the same expressions in torch on
    ``device`` (``cuda:0`` when None) in ``dtype`` (float64 when None).
    ``backend="pallas"``: the f32 gz matrix from the CUDA ``gz`` kernels
    on a CUDA ``device``, from their plain PyTorch versions on the CPU.
    ``timings``, a dict, receives the device builders' ``to_host_s`` (and
    the CUDA gz kernel's ``gz_kernel_s``; the torch builder's
    ``device_s``, its evaluation to a device sync).
    """
    if field not in _SCALES:
        raise ValueError(f"unknown gravity field {field!r}")
    if backend not in ("numpy", "jax", "pallas"):
        raise ValueError(f"unknown prism backend {backend!r}")
    cells, _ = _as_cells(mesh_or_cells)
    xo = np.asarray(xo, dtype=np.float64).ravel()
    yo = np.asarray(yo, dtype=np.float64).ravel()
    zo = np.asarray(zo, dtype=np.float64).ravel()
    if not (xo.shape == yo.shape == zo.shape):
        raise ValueError("Input arrays xp, yp, and zp must have same length!")
    D, M = xo.size, cells.shape[0]
    cell_ext = np.stack([cells[:, 1] - cells[:, 0],
                         cells[:, 3] - cells[:, 2],
                         cells[:, 5] - cells[:, 4]], axis=1)
    scale = _SCALES[field]
    timings = {} if timings is None else timings

    if backend == "pallas":
        if field != "gz":
            raise NotImplementedError("pallas builder currently covers gz")
        obs = np.stack([xo, yo, zo], axis=1)
        out = gz_kernel_matrix(obs, cells, scale, resolve(device), timings)
        t0 = time.perf_counter()
        out = out.cpu().numpy()
        timings["to_host_s"] = time.perf_counter() - t0
        return out

    if backend == "jax":
        device = resolve(device)
        dtype = dtype or torch.float64
        t0 = time.perf_counter()
        cdev = torch.as_tensor(cells, dtype=dtype, device=device)
        edev = torch.as_tensor(cell_ext, dtype=dtype, device=device)
        odev = torch.as_tensor(np.stack([xo, yo, zo]), dtype=dtype,
                               device=device)
        if obs_chunk is None:
            obs_chunk = max(1, min(D, int(4e6 // max(M, 1)) or 1))
        out = torch.empty((D, M), dtype=dtype, device=device)
        for s in range(0, D, obs_chunk):
            e = min(s + obs_chunk, D)
            out[s:e] = _eval_block(field, tuple(odev[:, s:e]), cdev, edev,
                                   torch) * scale
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        out = out.cpu().numpy()
        timings["device_s"] = t1 - t0
        timings["to_host_s"] = time.perf_counter() - t1
        return out

    if obs_chunk is None:
        obs_chunk = max(1, min(D, int(2e6 // max(M, 1)) or 1))
    kernel = np.empty((D, M), dtype=np.float64)
    for s in range(0, D, obs_chunk):
        e = min(s + obs_chunk, D)
        kernel[s:e] = _eval_block(
            field, (xo[s:e], yo[s:e], zo[s:e]), cells, cell_ext, np)
    kernel *= scale
    return kernel


def _gravity_field(field):
    def compute(xp, yp, zp, prisms, dens=None, backend="numpy",
                obs_chunk=None, **_ignored):
        """Field value and sensitivity matrix, reference-compatible API
        (reference: gravmag/prism.py:875-982): returns ``(res, kernel2d)``
        with res = kernel2d @ densities."""
        kernel2d = prism_kernel_matrix(field, xp, yp, zp, prisms,
                                       backend=backend, obs_chunk=obs_chunk)
        _, values = _as_cells(prisms)
        if dens is not None:
            densities = np.full(kernel2d.shape[1], float(dens))
        elif values is not None:
            densities = values
        else:
            densities = np.zeros(kernel2d.shape[1])
        res = kernel2d @ densities
        return res, kernel2d

    compute.__name__ = field
    return compute


potential = _gravity_field("potential")
geoid = _gravity_field("geoid")
gx = _gravity_field("gx")
gy = _gravity_field("gy")
gz = _gravity_field("gz")
gxx = _gravity_field("gxx")
gxy = _gravity_field("gxy")
gxz = _gravity_field("gxz")
gyy = _gravity_field("gyy")
gyz = _gravity_field("gyz")
gzz = _gravity_field("gzz")


# --------------------------------------------------------------------------
# magnetics (reference: gravmag/_prism.pyx:72-205, gravmag/prism.py:665-870)
# --------------------------------------------------------------------------

def _tensor_block(obs, cells, xp):
    """The six tensor kernels summed over corners: (B, M) each."""
    vs = [None] * 6
    kfns = [_kernelxx, _kernelxy, _kernelxz, _kernelyy, _kernelyz, _kernelzz]
    for i in range(2):
        for j in range(2):
            for k in range(2):
                dx, dy, dz = _corner_offsets(obs, cells, (i, j, k), xp)
                r = xp.sqrt(dx * dx + dy * dy + dz * dz)
                sign = -1.0 if (i + j + k) % 2 else 1.0
                for n, kfn in enumerate(kfns):
                    term = sign * kfn(dx, dy, dz, r, xp)
                    vs[n] = term if vs[n] is None else vs[n] + term
    return vs  # v1..v6 = xx, xy, xz, yy, yz, zz


def _project(vs, m):
    """b-field components from tensor kernels and a moment vector.

    ``m`` has shape (..., 3) broadcastable against the (B, M) blocks.
    """
    v1, v2, v3, v4, v5, v6 = vs
    mx, my, mz = m
    bx_ = v1 * mx + v2 * my + v3 * mz
    by_ = v2 * mx + v4 * my + v5 * mz
    bz_ = v3 * mx + v5 * my + v6 * mz
    return bx_, by_, bz_


def _magnetization_vectors(prisms, pmag, fdir, M):
    """(3, M) per-cell magnetization vectors following the reference's
    override rules (reference: gravmag/prism.py:702-720)."""
    fx, fy, fz = fdir
    if pmag is not None:
        if np.isscalar(pmag):
            vec = np.array([pmag * fx, pmag * fy, pmag * fz])[:, None]
        else:
            vec = np.asarray(pmag, dtype=np.float64).reshape(3, 1)
        return np.broadcast_to(vec, (3, M)).copy()
    _, values = _as_cells(prisms, prop="magnetization")
    if values is None:
        return np.zeros((3, M))
    values = np.asarray(values, dtype=np.float64)
    if values.ndim == 1:  # scalar (induced) magnetization per cell
        return np.stack([values * fx, values * fy, values * fz])
    return values.T  # (M, 3) vectors -> (3, M)


def tf(xp, yp, zp, prisms, inc, dec, pmag=None, obs_chunk=None, **_ignored):
    """Total-field magnetic anomaly and its sensitivity matrix.

    ``kernel2d`` columns are the anomaly of unit induced magnetization along
    the regional field (the reference's f-projected ``kernelk``,
    gravmag/_prism.pyx:103-108); ``res`` uses each cell's own magnetization
    vector. Output scaled by ``CM * T2NT``
    (reference: gravmag/prism.py:729-731).
    """
    cells, _ = _as_cells(prisms)
    xo = np.asarray(xp, dtype=np.float64).ravel()
    yo = np.asarray(yp, dtype=np.float64).ravel()
    zo = np.asarray(zp, dtype=np.float64).ravel()
    D, M = xo.size, cells.shape[0]
    fdir = dircos(inc, dec)
    fx, fy, fz = fdir
    mvec = _magnetization_vectors(prisms, pmag, fdir, M)
    if obs_chunk is None:
        obs_chunk = max(1, min(D, int(1e6 // max(M, 1)) or 1))
    res = np.empty(D)
    kernel2d = np.empty((D, M))
    scale = constants.CM * constants.T2NT
    for s in range(0, D, obs_chunk):
        e = min(s + obs_chunk, D)
        vs = _tensor_block((xo[s:e], yo[s:e], zo[s:e]), cells, np)
        bxm, bym, bzm = _project(vs, (mvec[0][None, :], mvec[1][None, :],
                                      mvec[2][None, :]))
        res[s:e] = (fx * bxm + fy * bym + fz * bzm).sum(axis=1) * scale
        bxf, byf, bzf = _project(vs, (fx, fy, fz))
        kernel2d[s:e] = (fx * bxf + fy * byf + fz * bzf) * scale
    return res, kernel2d


def _b_component(index):
    def compute(xp, yp, zp, prisms, pmag=None, obs_chunk=None, **_ignored):
        """One component of the magnetic induction (reference:
        gravmag/prism.py:735-870; no kernel matrix, result only)."""
        cells, _ = _as_cells(prisms)
        xo = np.asarray(xp, dtype=np.float64).ravel()
        yo = np.asarray(yp, dtype=np.float64).ravel()
        zo = np.asarray(zp, dtype=np.float64).ravel()
        D, M = xo.size, cells.shape[0]
        if pmag is not None:
            # reference accepts only a 3-vector here (gravmag/prism.py:765-767)
            vec = np.asarray(pmag, dtype=np.float64).reshape(3, 1)
            mvec = np.broadcast_to(vec, (3, M))
        else:
            _, values = _as_cells(prisms, prop="magnetization")
            if values is None or np.asarray(values).ndim != 2:
                raise ValueError(
                    "b-components need vector magnetization or pmag")
            mvec = np.asarray(values, dtype=np.float64).T
        if obs_chunk is None:
            obs_chunk = max(1, min(D, int(1e6 // max(M, 1)) or 1))
        res = np.empty(D)
        scale = constants.CM * constants.T2NT
        for s in range(0, D, obs_chunk):
            e = min(s + obs_chunk, D)
            vs = _tensor_block((xo[s:e], yo[s:e], zo[s:e]), cells, np)
            comps = _project(vs, (mvec[0][None, :], mvec[1][None, :],
                                  mvec[2][None, :]))
            res[s:e] = comps[index].sum(axis=1) * scale
        return res

    return compute


bx = _b_component(0)
by = _b_component(1)
bz = _b_component(2)
