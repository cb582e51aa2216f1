"""Finite-difference regularizer operators, in PyTorch.

Counterpart of ``gravinv3dhmc_tpu/ops/fd.py``: the first differences of a
model on its (nz, ny, nx) grid along x, y and z, which are together the
rows of the reference's sparse ``R3d``, and the Smoothness (``||R v||^2``)
and total-variation (``sum sqrt((R v)^2 + beta)``) functionals on them.
The JAX package differentiates these with ``jax.grad``; here the
gradients are written out with the adjoint of the three differences:
``2 R^T (R v)`` for Smoothness and ``R^T (R v / sqrt((R v)^2 + beta))``
for TV. An active mask zeroes the differences that touch an inactive
cell, and with them their share of the gradient (both gradients vanish
where a difference is 0).

Every function takes a flat model vector or a batch of them (``(..., M)``
with ``M = nz ny nx``); the functionals sum over the grid, one value a
batch row. ``xp`` (``torch`` by default, or ``numpy``) is kept for the
JAX signature. ``fd3d_matrix`` builds the explicit scipy matrix in the
reference's row order, for the tests.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch


def fd3d_matrix(shape):
    """Sparse first-difference matrix, reference row ordering
    (reference: inversion/potential.py:266-361).

    ``shape = (nz, ny, nx)``; each row is m[i] - m[j] for an adjacent pair.
    """
    nz, ny, nx = shape
    per_layer = (nx - 1) * ny + (ny - 1) * nx
    nderivs = per_layer * nz + nx * ny * (nz - 1)
    rows, cols, vals = [], [], []

    def add(r, c1, c2):
        rows.extend([r, r])
        cols.extend([c1, c2])
        vals.extend([1.0, -1.0])

    for k in range(nz):
        deriv = per_layer * k
        base = nx * ny * k
        # x-direction within each y-row
        p = 0
        for _ in range(ny):
            for _ in range(nx - 1):
                add(deriv, base + p, base + p + 1)
                deriv += 1
                p += 1
            p += 1
        # y-direction
        p = 0
        for _ in range(ny - 1):
            for _ in range(nx):
                add(deriv, base + p, base + p + nx)
                deriv += 1
                p += 1
    front = per_layer * nz
    for k in range(nz - 1):
        base = nx * ny * k
        for p in range(nx * ny):
            add(front + base + p, base + p, base + p + nx * ny)
    return sp.coo_matrix((vals, (rows, cols)),
                         (nderivs, nx * ny * nz)).tocsr()


def _edge_masks(active3d):
    """The (x, y, z) masks of the differences whose two cells are active."""
    a = active3d
    return (a[:, :, :-1] & a[:, :, 1:], a[:, :-1, :] & a[:, 1:, :],
            a[:-1, :, :] & a[1:, :, :])


def grid_diffs(v, shape, xp=torch, active3d=None):
    """First differences of a flat model vector (or a batch of them) along
    x, y, z: ``(dx, dy, dz)``, together exactly the entries of ``R3d @ v``.
    With ``active3d`` (boolean (nz, ny, nx)) the differences touching an
    inactive cell are 0."""
    nz, ny, nx = shape
    g = xp.reshape(v, tuple(v.shape[:-1]) + (nz, ny, nx))
    dx = g[..., :, :, :-1] - g[..., :, :, 1:]
    dy = g[..., :, :-1, :] - g[..., :, 1:, :]
    dz = g[..., :-1, :, :] - g[..., 1:, :, :]
    if active3d is not None:
        if xp is torch:
            active3d = torch.as_tensor(active3d, device=dx.device)
        ax, ay, az = _edge_masks(active3d)
        dx = xp.where(ax, dx, 0.0)
        dy = xp.where(ay, dy, 0.0)
        dz = xp.where(az, dz, 0.0)
    return dx, dy, dz


def _grid_sum(t):
    return t.sum((-3, -2, -1)) if isinstance(t, torch.Tensor) else \
        t.sum(axis=(-3, -2, -1))


def smoothness_value(v, shape, xp=torch, active3d=None):
    """``||R3d v||^2`` (1st-order Tikhonov, reference:
    inversion/potential.py:786-796) without materialising R3d."""
    dx, dy, dz = grid_diffs(v, shape, xp, active3d)
    return _grid_sum(dx * dx) + _grid_sum(dy * dy) + _grid_sum(dz * dz)


def tv_value(v, shape, beta, xp=torch, active3d=None):
    """Total-variation functional ``sum sqrt((R3d v)^2 + beta)``
    (reference: inversion/potential.py:798-810). The reference sums
    sqrt(beta) over *all* rows of R3d, zero differences included; so does
    this."""
    dx, dy, dz = grid_diffs(v, shape, xp, active3d)
    return (_grid_sum(xp.sqrt(dx * dx + beta))
            + _grid_sum(xp.sqrt(dy * dy + beta))
            + _grid_sum(xp.sqrt(dz * dz + beta)))


def _adjoint(ex, ey, ez, shape):
    """``R^T e`` for the three difference arrays ``e``: each difference
    adds its value to its first cell and subtracts it from its second."""
    nz, ny, nx = shape
    out = ex.new_zeros(tuple(ex.shape[:-3]) + (nz, ny, nx))
    out[..., :, :, :-1] += ex
    out[..., :, :, 1:] -= ex
    out[..., :, :-1, :] += ey
    out[..., :, 1:, :] -= ey
    out[..., :-1, :, :] += ez
    out[..., 1:, :, :] -= ez
    return out.reshape(tuple(ex.shape[:-3]) + (nz * ny * nx,))


def value_and_grad(name, v, shape, beta, active3d=None):
    """``(value, gradient)`` of the regularizer ``name`` ("Smoothness" or
    "TV", ``beta`` its smoothing) at ``v``, from one set of differences:
    the gradient is ``2 R^T (R v)`` (Smoothness) or
    ``R^T (R v / sqrt((R v)^2 + beta))`` (TV)."""
    diffs = grid_diffs(v, shape, torch, active3d)
    dx, dy, dz = diffs
    if name == "Smoothness":
        value = _grid_sum(dx * dx) + _grid_sum(dy * dy) + _grid_sum(dz * dz)
        return value, _adjoint(2.0 * dx, 2.0 * dy, 2.0 * dz, shape)
    roots = [torch.sqrt(d * d + beta) for d in diffs]
    value = _grid_sum(roots[0]) + _grid_sum(roots[1]) + _grid_sum(roots[2])
    return value, _adjoint(*(d / r for d, r in zip(diffs, roots)), shape)
