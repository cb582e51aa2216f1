"""The prism-gz sensitivity matrix in float32, built on the GPU.

Counterpart of ``gravinv3dhmc_tpu/ops/prism_pallas.py``
(``gz_kernel_matrix_pallas`` and its ``_gz_tile_kernel``): the same Nagy
corner formula as the f64 host builder (:mod:`.prism`), evaluated in f32.
Two hand-written CUDA kernels compute it (``csrc/prism_gz.cu``, whose
header says what bounds each): ``gz_nodes`` evaluates each corner term
once per distinct node of the cells (:func:`node_tables`) and gathers a
cell's 8 values from them, ``gz`` evaluates the 8 corners of every cell.
:func:`gz_plan` picks one from the cells alone, before any launch:
``gz_nodes`` when the cells share their nodes (a rectilinear mesh) and
its plane ring fits in a block's shared memory. :func:`gz_nodes_plain`
and :func:`gz_plain` are their plain PyTorch versions, which run for CPU
tensors.

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
from typing import NamedTuple

import numpy as np
import torch

from . import _cuda

_F32 = torch.float32
_GZ_TPU = "gravinv3dhmc_tpu/ops/prism_pallas.py:57"
#: observation rows per plain-version block (bounds its temporaries)
PLAIN_ROWS = 64
#: the dynamic shared memory a node-kernel block may take (its plane ring
#: and tables, :func:`node_smem_bytes`), in bytes: the most an sm_90 block
#: may opt into (227 KB), past which the kernel's C entry fails to set it
NODE_SMEM = 232_448


class NodeTables(NamedTuple):
    """The distinct nodes of a cell set and each cell's place among them.

    ``ux``, ``uy``, ``uz``: the sorted distinct f32 values of each axis's
    bounds. ``cells`` (M, 4) int32, in group order: for x, y and z the
    word ``upper | lower << 16`` of the cell's two node indices (the
    upper bound first, as the corner formula's x = [x2, x1] order), then
    the cell's column in the matrix. ``offsets`` (len(uz) + 1,) int32:
    the cells whose upper z node is k are ``cells[offsets[k]:offsets[k +
    1]]``. ``n_nodes``: |ux| |uy| |uz|, the node evaluations an
    observation; ``span``: the widest z extent of a cell in planes (-1
    when some cell's lower z bound lies above its upper one, or there is
    no cell)."""
    ux: np.ndarray
    uy: np.ndarray
    uz: np.ndarray
    cells: np.ndarray
    offsets: np.ndarray
    n_nodes: int
    span: int


def node_tables(cells):
    """:class:`NodeTables` of ``cells`` (M, 6) [x1, x2, y1, y2, z1, z2],
    from their float32 values: faces that differ in float64 but round to
    one float32 share a node, as the corner kernel sees them; faces one
    float32 ulp apart stay two nodes. The cells are grouped by the node of
    their upper z bound in a stable order, so a mesh's own order (x
    fastest, z slowest) is kept."""
    c = np.asarray(cells, np.float32).reshape(-1, 6)
    axes, words = [], []
    for a in range(3):
        u = np.unique(c[:, 2 * a:2 * a + 2])
        upper = np.searchsorted(u, c[:, 2 * a + 1]).astype(np.uint32)
        lower = np.searchsorted(u, c[:, 2 * a]).astype(np.uint32)
        axes.append((u, upper, lower))
        words.append(upper | (lower << np.uint32(16)))
    (ux, _, _), (uy, _, _), (uz, kz, kz_low) = axes
    order = np.argsort(kz, kind="stable")
    packed = np.stack(words + [np.arange(len(c), dtype=np.uint32)], 1)
    offsets = np.searchsorted(kz[order], np.arange(len(uz) + 1))
    extent = kz.astype(np.int64) - kz_low
    span = int(extent.max()) if len(c) and extent.min() >= 0 else -1
    return NodeTables(ux, uy, uz, packed[order].view(np.int32),
                      offsets.astype(np.int32), len(ux) * len(uy) * len(uz),
                      span)


def node_smem_bytes(t):
    """Dynamic shared memory of one node-kernel block (one observation):
    a ring of ``span + 2`` planes of |ux| x |uy| f32 node values (a plane
    is computed while the cells of the one before are gathered), then the
    axes and the group offsets."""
    nx, ny, nz = len(t.ux), len(t.uy), len(t.uz)
    return 4 * ((t.span + 2) * nx * ny + nx + ny + 2 * nz + 1)


def gz_plan(cells):
    """``(kernel name, NodeTables)`` for ``cells`` (M, 6): ``"gz_nodes"``
    when the node evaluations are at most half the corner evaluations
    (|nodes| <= 4 M), each axis's node indices fit in 16 bits, every cell
    has its z bounds in order and the block's plane ring fits in shared
    memory; else ``"gz"``."""
    t = node_tables(cells)
    fits = (max(len(t.ux), len(t.uy), len(t.uz)) <= 1 << 16
            and node_smem_bytes(t) <= NODE_SMEM)
    use = t.span >= 0 and t.n_nodes <= 4 * len(t.cells) and fits
    return ("gz_nodes" if use else "gz"), t


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


def _nagy_term(dx, dy, dz):
    """The corner term F of nodes at offsets (dx, dy, dz) (broadcast)."""
    dx2, dy2, dz2 = dx * dx, dy * dy, dz * dz
    r = torch.sqrt(dx2 + dy2 + dz2)
    return -(dx * _log_a_plus_r(dy, dx2 + dz2, r)
             + dy * _log_a_plus_r(dx, dy2 + dz2, r)
             - dz * _safe_atan2(dx * dy, dz * r))


def _corner_sum(terms):
    """The 8 signed corner terms (``terms(i, j, k)``) summed as the kernels
    sum them: corner (i, j, k) in that order, sign (-1)^(i + j + k)."""
    acc = None
    for i in range(2):
        for j in range(2):
            for k in range(2):
                term = terms(i, j, k)
                if acc is None:
                    acc = term
                elif (i + j + k) % 2:
                    acc = acc - term
                else:
                    acc = acc + term
    return acc


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
        dx, dy, dz = ([u[None, :] - o for u in us]
                      for us, o in ((xs, xo), (ys, yo), (zs, zo)))
        acc = _corner_sum(lambda i, j, k: _nagy_term(dx[i], dy[j], dz[k]))
        out[s:s + PLAIN_ROWS] = acc * scale
    return out


def gz_nodes_plain(obs, ux, uy, uz, cells, offsets, span, scale):
    """The same matrix from node tables (:class:`NodeTables`' fields as
    tensors; ``offsets`` and ``span`` pace the kernel and are not needed
    here): F on the whole node grid once per observation block, each
    cell's 8 values gathered in the corner order and summed as
    :func:`gz_plain` sums them, times ``scale``."""
    obs = obs.to(_F32)
    D, M = obs.shape[0], cells.shape[0]
    nx, ny = ux.shape[0], uy.shape[0]
    w = cells.to(torch.int64) & 0xFFFFFFFF
    # (upper, lower) node index of each axis; the flat node is (z, y, x)
    xi, yi, zi = ((w[:, a] & 0xFFFF, w[:, a] >> 16) for a in range(3))
    column = w[:, 3]
    out = torch.empty((D, M), dtype=_F32, device=obs.device)
    for s in range(0, D, PLAIN_ROWS):
        xo, yo, zo = (obs[s:s + PLAIN_ROWS, a:a + 1] for a in range(3))
        B = xo.shape[0]
        F = _nagy_term((ux[None, :] - xo)[:, None, None, :],
                       (uy[None, :] - yo)[:, None, :, None],
                       (uz[None, :] - zo)[:, :, None, None]).reshape(B, -1)
        acc = _corner_sum(lambda i, j, k: F[:, (zi[k] * ny + yi[j]) * nx
                                            + xi[i]])
        out[s:s + PLAIN_ROWS, column] = acc * scale
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


def _gz_nodes_cuda(obs, ux, uy, uz, cells, offsets, span, scale):
    D, M = obs.shape[0], cells.shape[0]
    nx, ny, nz = ux.shape[0], uy.shape[0], uz.shape[0]
    obs = obs.to(_F32).contiguous()
    out = torch.empty((D, M), dtype=_F32, device=obs.device)
    P, i32 = _cuda.ptr, torch.int32
    _cuda.library("prism_gz").call(
        "gz_nodes_matrix", P(obs, _F32, (D, 3)), P(ux, _F32, (nx,)),
        P(uy, _F32, (ny,)), P(uz, _F32, (nz,)), P(cells, i32, (M, 4)),
        P(offsets, i32, (nz + 1,)), P(out, _F32, (D, M)), D, M, nx, ny, nz,
        span, scale, _cuda.stream(obs))
    return out


_cuda.register(
    _cuda.Kernel("gz", gz_plain, _gz_cuda, _GZ_TPU, "prism_gz"),
    _cuda.Kernel("gz_nodes", gz_nodes_plain, _gz_nodes_cuda, _GZ_TPU,
                 "prism_gz"))


def node_args(t, device):
    """The node kernel's table arguments (after ``obs``, before
    ``scale``) as tensors on ``device``."""
    return (*(torch.as_tensor(a, device=device)
              for a in (t.ux, t.uy, t.uz, t.cells, t.offsets)), t.span)


def gz_kernel_matrix(obs, cells, scale, device, timings=None):
    """(D, M) f32 gz matrix in output units as a tensor on ``device``.

    ``obs`` is (D, 3) [x, y, z], ``cells`` (M, 6) bounds, ``scale`` the
    unit factor (G * SI2MGAL for mGal). The kernel is :func:`gz_plan`'s:
    on a CUDA device it is launched, on the CPU its plain version runs.
    On a CUDA device a ``timings`` dict gets ``gz_kernel_s``, the device
    time between CUDA events recorded around the launch (the host's issue
    of the launch included), after a wait for the end event.
    """
    device = torch.device(device)
    scale = float(np.float32(scale))
    obs_t = torch.as_tensor(np.asarray(obs, np.float32), device=device)
    cells = np.asarray(cells, np.float32)
    name, tables = gz_plan(cells)
    args = ((obs_t, *node_args(tables, device), scale) if name == "gz_nodes"
            else (obs_t, torch.as_tensor(cells, device=device), scale))
    timed = timings is not None and device.type == "cuda"
    if timed:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
    out = _cuda.KERNELS[name](*args)
    if timed:
        end.record()
        end.synchronize()
        timings["gz_kernel_s"] = start.elapsed_time(end) / 1e3
    return out
