"""Wavelet kernel-matrix compression (db4, periodized, level 2).

The host half is a numpy copy of ``gravinv3dhmc_tpu/ops/wavelet.py``
(reference: gravmag/compressor1D.py:18-60, compressor3D.py:18-68), equal
to it bit for bit: the Daubechies-4 taps, ``_dwt_level``, :func:`dwt1d`,
:func:`dwt3d`, the kernel and model compressors and
:func:`compression_ratio`. Rows of the weighted kernel are transformed with
an orthonormal Daubechies-4 discrete wavelet transform, hard-thresholded,
and stored sparse; the model vector is transformed with the same operator
so the matvec happens in the wavelet domain:

    A m  =  (A W^T) (W m)  ~=  threshold(A W^T) (W m)

``W`` is a linear isometry (W^T W = I): odd-length levels are zero-padded
before the even-periodized orthogonal step, so the identity holds exactly
before thresholding.

The device half, :func:`make_model_transform`, is the counterpart of the
JAX package's jittable ``W m`` in torch (any batch shape, any device),
with the coefficient layout of :func:`dwt1d` / :func:`dwt3d`. The JAX
package differentiates through it; here the gradient is written out, so
the transform also has its adjoint ``W^T`` (:meth:`ModelTransform.adjoint`).
One periodized level ``a[k] = sum_j lo[j] x[(2k + j) mod n]`` (and ``d``
with ``hi``) has the adjoint ``x[i] = sum over j = i (mod 2) of lo[j]
a[((i - j) mod n) / 2] + hi[j] d[...]``: four taps of each filter an
entry, read through a precomputed (n, 4) index table. A gather, not an
``index_add_``: CUDA's atomics would change the sum order from run to run.
Where a level padded an odd length, the adjoint drops the padded entry.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

# Daubechies-4 (8-tap) scaling filter, orthonormal normalisation
DB4_LO = np.array([
    0.23037781330885523, 0.7148465705525415, 0.6308807679295904,
    -0.02798376941698385, -0.18703481171888114, 0.030841381835986965,
    0.032883011666982945, -0.010597401784997278,
])
#: quadrature-mirror high-pass: h[m] = (-1)^m g[L-1-m]
DB4_HI = ((-1.0) ** np.arange(8)) * DB4_LO[::-1]


def _dwt_level(x, axis):
    """One periodized DWT level along ``axis``; zero-pads odd lengths first.

    Jointly (approx, detail) is an isometry of the input axis.
    """
    x = np.moveaxis(np.asarray(x, dtype=np.float64), axis, -1)
    n = x.shape[-1]
    if n % 2:
        x = np.concatenate([x, np.zeros(x.shape[:-1] + (1,))], axis=-1)
        n += 1
    idx = (2 * np.arange(n // 2)[:, None] + np.arange(8)[None, :]) % n
    windows = x[..., idx]  # (..., n//2, 8)
    a = windows @ DB4_LO
    d = windows @ DB4_HI
    return np.moveaxis(a, -1, axis), np.moveaxis(d, -1, axis)


def dwt1d(x, levels=2, axis=-1):
    """Multi-level 1-D DWT along ``axis``: [a_L, d_L, ..., d_1] concatenated.

    Operates on any batch shape; the transform is a linear isometry of the
    chosen axis.
    """
    details = []
    a = np.asarray(x, dtype=np.float64)
    for _ in range(levels):
        a, d = _dwt_level(a, axis)
        details.append(d)
    return np.concatenate([a] + details[::-1], axis=axis)


def _level3d(v, axes):
    """Split one level into the LLL block plus 7 detail octants."""
    blocks = [v]
    for ax in axes:
        nxt = []
        for b in blocks:
            a, d = _dwt_level(b, ax)
            nxt.extend([a, d])
        blocks = nxt
    return blocks[0], blocks[1:]


def dwt3d(vol, levels=2):
    """Multi-level separable 3-D DWT flattened to a vector.

    ``vol`` is (nz, ny, nx) or batched (B, nz, ny, nx). Output stacks the
    deepest approximation block then the detail octants per level (deepest
    first). Output length K >= nz*ny*nx when padding occurred.
    """
    vol = np.asarray(vol, dtype=np.float64)
    batched = vol.ndim == 4
    if not batched:
        vol = vol[None]
    axes = (1, 2, 3)
    a = vol
    details = []
    for _ in range(levels):
        a, ds = _level3d(a, axes)
        details.append(np.concatenate(
            [d.reshape(d.shape[0], -1) for d in ds], axis=1))
    flat = np.concatenate([a.reshape(a.shape[0], -1)] + details[::-1], axis=1)
    return flat if batched else flat[0]


# --------------------------------------------------------------------------
# compressors (reference-compatible API)
# --------------------------------------------------------------------------

def kernelcompressor_1d(Aw, threshold=1e-3, levels=2):
    """Row-wise 1-D DWT + hard threshold -> CSR
    (reference: gravmag/compressor1D.py:18-47)."""
    Aw = np.asarray(Aw, dtype=np.float64)
    coeffs = dwt1d(Aw, levels=levels, axis=1)
    coeffs[np.abs(coeffs) < threshold] = 0.0
    return sp.csr_matrix(coeffs)


def modelcompressor_1d(m, Awcp, levels=2):
    """Wavelet-domain matvec: Awcp @ W m
    (reference: gravmag/compressor1D.py:50-60)."""
    mcp = dwt1d(np.asarray(m, dtype=np.float64), levels=levels, axis=-1)
    return np.asarray(Awcp @ mcp).ravel()


def kernelcompressor_3d(Aw, mshape, threshold=1e-3, levels=2):
    """Row-wise 3-D DWT + hard threshold -> CSR
    (reference: gravmag/compressor3D.py:18-40)."""
    Aw = np.asarray(Aw, dtype=np.float64)
    nz, ny, nx = mshape
    vol = Aw.reshape(Aw.shape[0], nz, ny, nx)
    coeffs = dwt3d(vol, levels=levels)
    coeffs[np.abs(coeffs) < threshold] = 0.0
    return sp.csr_matrix(coeffs)


def modelcompressor_3d(m, Awcp, mshape, levels=2):
    """Wavelet-domain matvec for the 3-D transform
    (reference: gravmag/compressor3D.py:46-68)."""
    nz, ny, nx = mshape
    mcp = dwt3d(np.asarray(m, dtype=np.float64).reshape(nz, ny, nx),
                levels=levels)
    return np.asarray(Awcp @ mcp).ravel()


def compression_ratio(Awcp, dense_shape):
    """Fraction of nonzeros retained after thresholding."""
    return Awcp.nnz / float(dense_shape[0] * dense_shape[1])


# --------------------------------------------------------------------------
# device half (torch): W m and its adjoint W^T y
# --------------------------------------------------------------------------

def _half(n):
    """Each output's length of one level on an axis of length ``n``."""
    return (n + n % 2) // 2


def _level_tables(n):
    """Index tables of one level on an axis of length ``n`` (even after
    padding, ``np_``): the forward windows ``(np_/2, 8)`` and the adjoint's
    ``(np_, 4)`` coefficient indices with their taps ``(np_, 4, 2)`` (lo,
    hi)."""
    np_ = n + n % 2
    win = (2 * np.arange(np_ // 2)[:, None] + np.arange(8)[None, :]) % np_
    i = np.arange(np_)[:, None]
    j = (i % 2) + 2 * np.arange(4)[None, :]          # taps with j = i mod 2
    k = ((i - j) % np_) // 2
    taps = np.stack([DB4_LO[j], DB4_HI[j]], axis=-1)
    return win, k, taps


class ModelTransform:
    """``W m`` (``self(m)``) and ``W^T y`` (:meth:`adjoint`) on the last
    axis of a torch batch ``(..., M)``. ``mode="1D"`` transforms the trailing axis, ``"3D"`` reshapes it to
    ``mshape`` (nz, ny, nx) first. The layout is :func:`dwt1d`'s /
    :func:`dwt3d`'s."""

    def __init__(self, mshape=None, mode="1D", levels=2):
        if mode not in ("1D", "3D"):
            raise ValueError(f"wavelet mode {mode!r}: choose '1D' or '3D'")
        if mode == "3D" and mshape is None:
            raise ValueError("a 3D wavelet transform needs mshape")
        self.mode = mode
        self.levels = levels
        self.mshape = None if mshape is None else tuple(int(s) for s in
                                                        mshape)
        self._tables = {}

    def _table(self, n, like):
        key = (n, like.device, like.dtype)
        if key not in self._tables:
            win, k, taps = _level_tables(n)
            lh = np.stack([DB4_LO, DB4_HI], axis=1)          # (8, 2)
            self._tables[key] = (
                torch.as_tensor(win, device=like.device),
                torch.as_tensor(lh, dtype=like.dtype, device=like.device),
                torch.as_tensor(k, device=like.device),
                torch.as_tensor(taps, dtype=like.dtype, device=like.device))
        return self._tables[key]

    def _level(self, x, dim):
        """One level along ``dim``: ``(a, d)``."""
        x = x.movedim(dim, -1)
        n = x.shape[-1]
        win, lh, _, _ = self._table(n, x)
        if n % 2:
            x = torch.cat([x, x.new_zeros(x.shape[:-1] + (1,))], dim=-1)
        ad = x[..., win] @ lh                                # (..., h, 2)
        return ad[..., 0].movedim(-1, dim), ad[..., 1].movedim(-1, dim)

    def _level_adjoint(self, a, d, n, dim):
        """The adjoint of :meth:`_level` on an axis of length ``n``."""
        a, d = a.movedim(dim, -1), d.movedim(dim, -1)
        _, _, k, taps = self._table(n, a)
        ad = torch.stack([a, d], dim=-1)                     # (..., h, 2)
        x = (ad[..., k, :] * taps).sum((-2, -1))             # (..., np_)
        return x[..., :n].movedim(-1, dim)

    def _lengths(self):
        """Per level: the input shape of the level's block (1D: a length;
        3D: (nz, ny, nx))."""
        shapes = []
        s = self.mshape if self.mode == "3D" else None
        for _ in range(self.levels):
            shapes.append(s)
            s = None if s is None else tuple(_half(v) for v in s)
        return shapes, s

    def __call__(self, m):
        if self.mode == "1D":
            a, details = m, []
            for _ in range(self.levels):
                a, d = self._level(a, -1)
                details.append(d)
            return torch.cat([a] + details[::-1], dim=-1)
        batch = m.shape[:-1]
        a = m.reshape(batch + self.mshape)
        off = len(batch)
        details = []
        for _ in range(self.levels):
            blocks = [a]
            for ax in (off, off + 1, off + 2):
                blocks = [h for b in blocks for h in self._level(b, ax)]
            a = blocks[0]
            details.append(torch.cat([b.reshape(batch + (-1,))
                                      for b in blocks[1:]], dim=-1))
        return torch.cat([a.reshape(batch + (-1,))] + details[::-1], dim=-1)

    def adjoint(self, y, M=None):
        """``W^T y`` for a coefficient batch ``(..., K)``: ``(..., M)``.
        A 1D transform needs the model length ``M`` (two lengths can share
        a ``K``); a 3D one has it from ``mshape``."""
        batch = y.shape[:-1]
        if self.mode == "1D":
            if M is None:
                raise ValueError("the 1D adjoint needs the model length M")
            ns = [int(M)]
            for _ in range(self.levels - 1):
                ns.append(_half(ns[-1]))
            sizes = [_half(ns[-1])] + [_half(n) for n in ns[::-1]]
            parts = list(torch.split(y, sizes, dim=-1))
            a = parts[0]
            for n, d in zip(ns[::-1], parts[1:]):
                a = self._level_adjoint(a, d, n, -1)
            return a
        shapes, last = self._lengths()
        off = len(batch)
        axes = (off, off + 1, off + 2)
        sizes = [int(np.prod(last))] + [
            7 * int(np.prod([_half(v) for v in s])) for s in shapes[::-1]]
        parts = list(torch.split(y, sizes, dim=-1))
        a = parts[0].reshape(batch + last)
        for s, det in zip(shapes[::-1], parts[1:]):
            h = tuple(_half(v) for v in s)
            blocks = [a] + [b.reshape(batch + h)
                            for b in torch.split(det, int(np.prod(h)),
                                                 dim=-1)]
            # undo the axes in reverse; after axis ax the blocks are the
            # (a, d) pairs of the blocks before it
            for ax in reversed(range(3)):
                blocks = [self._level_adjoint(blocks[i], blocks[i + 1],
                                              s[ax], axes[ax])
                          for i in range(0, len(blocks), 2)]
            a = blocks[0]
        return a.reshape(batch + (-1,))


def make_model_transform(mshape=None, mode="1D", levels=2):
    """``W m`` for the sampler's wavelet-domain matvec, the counterpart of
    the JAX package's jittable transform: a :class:`ModelTransform`
    (call it on a ``(..., M)`` torch batch; :meth:`ModelTransform.adjoint`
    is ``W^T``). ``mode='1D'`` transforms the trailing axis, ``'3D'``
    reshapes it to ``mshape`` first; the layout matches :func:`dwt1d` /
    :func:`dwt3d` exactly."""
    return ModelTransform(mshape=mshape, mode=mode, levels=levels)
