"""The prism-gz sensitivity matrix in float32, built on the GPU.

Counterpart of ``gravinv3dhmc_tpu/ops/prism_pallas.py``
(``gz_kernel_matrix_pallas`` and its ``_gz_tile_kernel``): the same Nagy
corner formula as the f64 host builder (:mod:`.prism`), evaluated in f32.
The ``gz`` kernel is hand-written CUDA (``csrc/prism_gz.cu``, whose header
says what bounds it); :func:`gz_plain` is its plain PyTorch version, the
same expressions in torch f32, which runs for CPU tensors.

Precision: the corner differences cancel in f32 for distant cells, so an
f32 matrix is compared with the f64 one relative to max|A| and in
Frobenius norm, never column by column (a deep, thick cell's column can
be off by percents of itself while its entries are tiny). One cancellation
is removed where the JAX kernel keeps it: ``log(a + r)`` with a large
negative offset ``a`` is evaluated as ``log((b^2 + c^2) / (r - a))``, equal
in exact arithmetic. At ratiogrid's full size that brings the worst entry
from 1.2e-3 to 1.2e-4 of max|A| against the f64 matrix.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import _cuda

_F32 = torch.float32
_GZ_TPU = "gravinv3dhmc_tpu/ops/prism_pallas.py:57"
#: observation rows per plain-version block (bounds its temporaries)
PLAIN_ROWS = 64


def _safe_log(x):
    return torch.where(x == 0, 0.0, torch.log(torch.where(x == 0, 1.0, x)))


def _log_a_plus_r(a, b2c2, r):
    """log(a + r) where r^2 = a^2 + b2c2, with the reference's log(0) ->
    0; for a < 0 the sum is taken as b2c2 / (r - a), which does not
    cancel."""
    return _safe_log(torch.where(a < 0, b2c2 / (r - a), a + r))


def _safe_atan2(y, x):
    """The reference's shifted atan2: atan(y/x) for x != 0 (the +-pi
    shifts cancel atan2's branch offsets), sign(y) pi/2 on x == 0 and 0
    for y == 0."""
    res = torch.where(x == 0, torch.sign(y) * (math.pi / 2),
                      torch.atan(y / torch.where(x == 0, 1.0, x)))
    return torch.where(y == 0, 0.0, res)


def gz_plain(obs, cells, scale):
    """(D, M) f32 gz matrix of ``cells`` (M, 6) [x1, x2, y1, y2, z1, z2]
    at ``obs`` (D, 3) [x, y, z], times ``scale``: 8 signed corner terms in
    the reference's x = [x2, x1] order, summed as the kernel sums them."""
    obs = obs.to(_F32)
    cells = cells.to(_F32)
    D, M = obs.shape[0], cells.shape[0]
    xs, ys, zs = ((cells[:, 2 * a + 1], cells[:, 2 * a]) for a in range(3))
    out = torch.empty((D, M), dtype=_F32, device=obs.device)
    for s in range(0, D, PLAIN_ROWS):
        xo, yo, zo = (obs[s:s + PLAIN_ROWS, a:a + 1] for a in range(3))
        acc = None
        for i in range(2):
            dx = xs[i][None, :] - xo
            for j in range(2):
                dy = ys[j][None, :] - yo
                for k in range(2):
                    dz = zs[k][None, :] - zo
                    dx2, dy2, dz2 = dx * dx, dy * dy, dz * dz
                    r = torch.sqrt(dx2 + dy2 + dz2)
                    term = -(dx * _log_a_plus_r(dy, dx2 + dz2, r)
                             + dy * _log_a_plus_r(dx, dy2 + dz2, r)
                             - dz * _safe_atan2(dx * dy, dz * r))
                    if acc is None:
                        acc = term
                    elif (i + j + k) % 2:
                        acc = acc - term
                    else:
                        acc = acc + term
        out[s:s + PLAIN_ROWS] = acc * scale
    return out


def _gz_cuda(obs, cells, scale):
    D, M = obs.shape[0], cells.shape[0]
    obs = obs.to(_F32).contiguous()
    cells_t = cells.to(_F32).T.contiguous()          # (6, M): coalesced
    out = torch.empty((D, M), dtype=_F32, device=obs.device)
    P = _cuda.ptr
    _cuda.library("prism_gz").call(
        "gz_matrix", P(obs, _F32, (D, 3)), P(cells_t, _F32, (6, M)),
        P(out, _F32, (D, M)), D, M, scale, _cuda.stream(obs))
    return out


_cuda.register(_cuda.Kernel("gz", gz_plain, _gz_cuda, _GZ_TPU, "prism_gz"))


def gz_kernel_matrix(obs, cells, scale, device):
    """(D, M) f32 gz matrix in output units as a tensor on ``device``.

    ``obs`` is (D, 3) [x, y, z], ``cells`` (M, 6) bounds, ``scale`` the
    unit factor (G * SI2MGAL for mGal). On a CUDA device this launches the
    ``gz`` kernel; on the CPU it runs :func:`gz_plain`.
    """
    device = torch.device(device)
    obs_t = torch.as_tensor(np.asarray(obs, np.float32), device=device)
    cells_t = torch.as_tensor(np.asarray(cells, np.float32), device=device)
    return _cuda.KERNELS["gz"](obs_t, cells_t, float(np.float32(scale)))
