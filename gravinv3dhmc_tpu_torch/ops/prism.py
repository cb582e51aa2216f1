"""Closed-form right-rectangular-prism gz (Nagy et al. 2000), numpy f64.

A copy of the host float64 path of ``gravinv3dhmc_tpu/ops/prism.py``
(``_safe_log``, ``_safe_atan2``, ``_kernelz``, ``_eval_block``,
``_as_cells``, ``prism_kernel_matrix(backend="numpy")`` and ``gz``),
reduced to the gz field. The corner-difference formula cancels
catastrophically in f32 for distant cells, so the default matrix is built
on the host in f64 and cast when it moves to the device.

``backend="pallas"`` keeps the JAX package's name for its f32 device
builder: here it is the hand-written CUDA kernel of :mod:`.prism_gz` on a
CUDA device (its plain PyTorch version on the CPU). The JAX package's
``backend="jax"`` builder is not ported yet.
"""
from __future__ import annotations

import time

import numpy as np

from .. import constants
from .._device import resolve
from .prism_gz import gz_kernel_matrix

__all__ = ["gz", "prism_kernel_matrix"]


def _safe_log(x, xp):
    return xp.where(x == 0, 0.0, xp.log(xp.where(x == 0, 1.0, x)))


def _safe_atan2(y, x, xp):
    res = xp.arctan2(y, x)
    res = xp.where((y > 0) & (x < 0), res - np.pi, res)
    res = xp.where((y < 0) & (x < 0), res + np.pi, res)
    # reference convention: y == 0 -> 0 regardless of x's sign
    # (gravmag/_prism.pyx:17-19)
    return xp.where(y == 0, xp.zeros_like(res), res)


def _kernelz(dx, dy, dz, r, xp):
    return -(dx * _safe_log(dy + r, xp) + dy * _safe_log(dx + r, xp)
             - dz * _safe_atan2(dx * dy, dz * r, xp))


_SCALES = {"gz": constants.G * constants.SI2MGAL}


def _corner_offsets(obs, cells, corner):
    """Offsets of one of the 8 prism corners from each observation point,
    in the reference's x=[x2,x1] ordering so the sign is (-1)^(i+j+k)
    (reference: gravmag/_prism.pyx:281-290)."""
    i, j, k = corner
    xo, yo, zo = obs
    dx = cells[:, 1 - i][None, :] - xo[:, None]
    dy = cells[:, 3 - j][None, :] - yo[:, None]
    dz = cells[:, 5 - k][None, :] - zo[:, None]
    return dx, dy, dz


def _eval_block(obs, cells):
    """(B, M) gz kernel-matrix block (gz needs no corner radius dodge)."""
    acc = None
    for i in range(2):
        for j in range(2):
            for k in range(2):
                dx, dy, dz = _corner_offsets(obs, cells, (i, j, k))
                r = np.sqrt(dx * dx + dy * dy + dz * dz)
                term = _kernelz(dx, dy, dz, r, np)
                if (i + j + k) % 2:
                    term = -term
                acc = term if acc is None else acc + term
    return acc


def _as_cells(mesh_or_cells, prop="density"):
    """Normalise input to (cells (M,6) f64, per-cell property values or None).

    Accepts a mesh (active cells only) or a raw (M, 6) bounds array.
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
                        obs_chunk=None, device=None, timings=None):
    """Dense (D, M) gz sensitivity matrix in mGal per g/cm^3.

    ``backend="numpy"``: f64 on the host. ``backend="pallas"`` (the JAX
    package's name for its f32 device builder): the f32 matrix from the
    CUDA ``gz`` kernel when ``device`` is a CUDA device (``cuda:0`` when
    None), from its plain PyTorch version on the CPU; returned as a numpy
    f32 array, as the JAX package returns it.
    """
    if field not in _SCALES:
        raise NotImplementedError(
            f"field {field!r}: the port builds gz only so far")
    if backend not in ("numpy", "pallas"):
        raise NotImplementedError(
            f"backend {backend!r}: the port has the f64 numpy and the f32 "
            "device ('pallas') builders (ROADMAP.md queue 1)")
    cells, _ = _as_cells(mesh_or_cells)
    xo = np.asarray(xo, dtype=np.float64).ravel()
    yo = np.asarray(yo, dtype=np.float64).ravel()
    zo = np.asarray(zo, dtype=np.float64).ravel()
    if not (xo.shape == yo.shape == zo.shape):
        raise ValueError("Input arrays xp, yp, and zp must have same length!")
    if backend == "pallas":
        obs = np.stack([xo, yo, zo], axis=1)
        out = gz_kernel_matrix(obs, cells, _SCALES[field], resolve(device),
                               timings)
        t0 = time.perf_counter()
        out = out.cpu().numpy()
        if timings is not None:
            timings["to_host_s"] = time.perf_counter() - t0
        return out
    D, M = xo.size, cells.shape[0]
    if obs_chunk is None:
        obs_chunk = max(1, min(D, int(2e6 // max(M, 1)) or 1))
    kernel = np.empty((D, M), dtype=np.float64)
    for s in range(0, D, obs_chunk):
        e = min(s + obs_chunk, D)
        kernel[s:e] = _eval_block((xo[s:e], yo[s:e], zo[s:e]), cells)
    kernel *= _SCALES[field]
    return kernel


def gz(xp, yp, zp, prisms, dens=None, backend="numpy", obs_chunk=None):
    """gz and its sensitivity matrix, reference-compatible API
    (reference: gravmag/prism.py:875-982): ``(res, kernel2d)`` with
    ``res = kernel2d @ densities``."""
    kernel2d = prism_kernel_matrix("gz", xp, yp, zp, prisms,
                                   backend=backend, obs_chunk=obs_chunk)
    _, values = _as_cells(prisms)
    if dens is not None:
        densities = np.full(kernel2d.shape[1], float(dens))
    elif values is not None:
        densities = values
    else:
        densities = np.zeros(kernel2d.shape[1])
    return kernel2d @ densities, kernel2d
