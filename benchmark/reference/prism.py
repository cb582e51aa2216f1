"""The gravity (gz) of right rectangular prisms: Nagy et al. (2000).

A prism's gz at a station is the sum over its eight corners, with signs
(-1)^(i+j+k), of ``-(dx log(dy + r) + dy log(dx + r) - dz atan2(dx dy,
dz r))`` for the corner's offsets (dx, dy, dz) from the station and r
their length; a log of 0 counts 0 and an atan2 with a numerator of 0
counts 0, whatever the sign of the denominator. Units: densities in
g/cm^3, metres, gz in mGal (G = 6.673e-8 and 1e5 mGal a m/s^2), z down.
Computed in float64 on any device, in blocks of stations.
"""
from __future__ import annotations

import torch

G_MGAL = 0.00000006673 * 100000.0


def _log0(v):
    return torch.where(v == 0, torch.zeros_like(v),
                       torch.log(torch.where(v == 0, torch.ones_like(v), v)))


def _atan0(y, x):
    a = torch.atan2(y, x)
    a = torch.where((y > 0) & (x < 0), a - torch.pi, a)
    a = torch.where((y < 0) & (x < 0), a + torch.pi, a)
    return torch.where(y == 0, torch.zeros_like(a), a)


def gz_matrix(stations, cells, device, block=None):
    """(D, M) float64 gz of unit-density prisms: ``stations`` (D, 3) x, y,
    z and ``cells`` (M, 6) x1, x2, y1, y2, z1, z2."""
    st = torch.as_tensor(stations, dtype=torch.float64, device=device)
    cl = torch.as_tensor(cells, dtype=torch.float64, device=device)
    D, M = st.shape[0], cl.shape[0]
    block = block or max(1, int(2e7 // max(M, 1)))
    out = torch.empty((D, M), dtype=torch.float64, device=device)
    for s in range(0, D, block):
        o = st[s:s + block]
        acc = torch.zeros((o.shape[0], M), dtype=torch.float64,
                          device=device)
        for i in range(2):
            dx = cl[None, :, 1 - i] - o[:, 0:1]
            for j in range(2):
                dy = cl[None, :, 3 - j] - o[:, 1:2]
                for k in range(2):
                    dz = cl[None, :, 5 - k] - o[:, 2:3]
                    r = torch.sqrt(dx * dx + dy * dy + dz * dz)
                    t = -(dx * _log0(dy + r) + dy * _log0(dx + r)
                          - dz * _atan0(dx * dy, dz * r))
                    acc += -t if (i + j + k) % 2 else t
        out[s:s + block] = acc * G_MGAL
    return out


def grid_cells(origin, spacing, shape):
    """(M, 6) bounds of a regular prism grid, x fastest and z slowest:
    the grid's corner ``origin`` (x, y, z), ``spacing`` (dx, dy, dz) and
    ``shape`` (nz, ny, nx); edges at origin + k spacing."""
    nz, ny, nx = shape
    e = [o + d * torch.arange(n + 1, dtype=torch.float64)
         for o, d, n in zip(origin, spacing, (nx, ny, nz))]
    iz, iy, ix = (t.reshape(-1) for t in torch.meshgrid(
        torch.arange(nz), torch.arange(ny), torch.arange(nx),
        indexing="ij"))
    return torch.stack([e[0][ix], e[0][ix + 1], e[1][iy], e[1][iy + 1],
                        e[2][iz], e[2][iz + 1]], dim=1)


def weighting(A, factor=0.5):
    """Depth weights from column energies: ``w_j = (sum_i A_ij^2)^factor``
    and the weighted matrix ``A / w`` (a zero column left as it is)."""
    w = (A * A).sum(0) ** factor
    inv = torch.where(w == 0, torch.zeros_like(w),
                      1.0 / torch.where(w == 0, torch.ones_like(w), w))
    return A * inv, w, inv
