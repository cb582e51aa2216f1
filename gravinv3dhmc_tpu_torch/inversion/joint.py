"""Joint gravity + magnetic inversion module, in PyTorch.

Counterpart of ``gravinv3dhmc_tpu/inversion/joint.py``: both fields share
one mesh (cartesian prisms or spherical tesseroids); the block structure
of the (D_g + D_t) x 2M kernel is kept, so the joint product is two
``torch.matmul``s and the combined matrix is only formed on request
(:attr:`JointModule.A`). Weighting follows the reference's ``weightKDM``
(reference: inversion/potential.py:1003-1065): each field weights its own
columns by their energy to the power 0.5, and the magnetic rows are
scaled by ``wb_tf = std(kernel_gz) / std(kernel_tf)``. The matrices and
weights are f64 on the host, as in the JAX package.

The data term is the plain (not mean-removed) weighted residual
``||[Awg mw_g; Awt mw_t] - dobsw||^2`` (reference:
inversion/potential.py:1665-1690), unlike the single-field module.
Regularizers act on the stacked ``[rho; mag]`` vector; Smoothness and TV
apply :mod:`..ops.fd` to each half. ``cross_gradient_weight`` adds the
structural coupling ``sum |grad rho x grad mag|^2`` over the grid, on the
unweighted model ``m = mw * wdiag_inv``, each one-short difference padded
with one zero at the end of its own axis, as the JAX package pads it.

The JAX package differentiates the scalar potential with
``jax.value_and_grad``; here the gradient is written out: ``2 A^T r`` for
each block, the regularizers' gradients (:func:`.potential.
model_value_and_grad`), the cross-gradient's ``2 (b x c)`` and ``2 (c x
a)`` (``c = a x b``) through the adjoint of the differences, and under
'logarithmic' the logistic chain rule, as in :mod:`.potential`. The JAX
module has no Pallas kernel on this path (the fused HMC kernels need a
host ``Aw``, which this module does not have), so neither has this one.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import mesher
from .._device import as_tensor, resolve
from ..ops import fd, prism, tesseroid
from ..utils.units import ang2vec
from .potential import (Potential, model_value_and_grad,
                        sensitivity_weighting)


def _cross_value_and_grad(m, mshape):
    """``sum |a x b|^2`` over the grid and its gradient in ``m`` (..., 2M),
    where ``a`` and ``b`` are the first differences of the two halves,
    each padded with one zero at the end of its own axis."""
    M = m.shape[-1] // 2

    def padded(v):
        dx, dy, dz = fd.grid_diffs(v, mshape)
        return (F.pad(dx, (0, 1)), F.pad(dy, (0, 0, 0, 1)),
                F.pad(dz, (0, 0, 0, 0, 0, 1)))

    def cross(u, v):
        return (u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2],
                u[0] * v[1] - u[1] * v[0])

    def unpadded_adjoint(e):
        # the pads are constants: only the differences carry gradient
        return fd._adjoint(e[0][..., :, :, :-1], e[1][..., :, :-1, :],
                           e[2][..., :-1, :, :], mshape)

    a, b = padded(m[..., :M]), padded(m[..., M:])
    c = cross(a, b)
    value = sum(fd._grid_sum(ci * ci) for ci in c)
    ga = unpadded_adjoint([2.0 * t for t in cross(b, c)])
    gb = unpadded_adjoint([2.0 * t for t in cross(c, a)])
    return value, torch.cat([ga, gb], dim=-1)


class JointModule:
    """Misfit/gradient provider for joint [density; magnetization]
    inversion, with the JAX module's reference-compatible constructor
    (reference: inversion/potential.py:848-1001). ``mangle = (inc, dec)``
    in degrees is the regional field; any extra keyword argument is the
    topography triple ``mtopo`` that carves the mesh. ``njobs`` and
    ``wavelet`` are accepted and unused, as in the JAX package. ``device``
    (``cuda:0`` when None) is where :meth:`make_potential` puts its
    tensors."""

    def __init__(self, dobs_gz, dobs_tf, mrange, mspacing, obsurface,
                 mratio=1, coordinate="cartesian", njobs=1, mangle=(90, 0),
                 wavelet=False, dtype=torch.float32, verbose=True,
                 device=None, **kwargs):
        self.dobs_gz = np.asarray(dobs_gz, dtype=np.float64)
        self.dobs_tf = np.asarray(dobs_tf, dtype=np.float64)
        self.mrange = mrange
        self.mspacing = mspacing
        self.mratio = mratio
        self.inc, self.dec = mangle
        self.dtype = dtype
        self.device = resolve(device)
        self.topocarve = False
        self.mask = []
        lon, lat, height = (np.asarray(a, dtype=np.float64)
                            for a in obsurface)

        mtopo = None
        for _k, v in kwargs.items():
            self.topocarve = True
            mtopo = v

        if coordinate == "spherical":
            mesh = mesher.TesseroidMesh(mrange, mspacing, mratio)
            builder = tesseroid
            gz = tesseroid.tesseroid_kernel_matrix
        elif coordinate == "cartesian":
            mesh = mesher.PrismMesh(mrange, mspacing, mratio)
            builder = prism
            gz = prism.prism_kernel_matrix
        else:
            raise ValueError(
                "Please choose coordinate from(cartesian, spherical)!")
        if mtopo is not None:
            self.mask = mesh.carvetopo(mtopo[0], mtopo[1], mtopo[2])
        self.mesh = mesh
        self.mshape = mesh.shape
        self.mxs = mesh.get_xs()
        self.mys = mesh.get_ys()
        self.mzs = mesh.get_zs()

        mesh.addprop("density", np.zeros(mesh.size))
        kernel_gz = gz("gz", lon, lat, height, mesh)
        mesh.addprop("magnetization",
                     ang2vec(np.zeros(mesh.size), self.inc, self.dec))
        _, kernel_tf = builder.tf(lon, lat, height, mesh, self.inc,
                                  self.dec)
        self.kernel_gz = kernel_gz
        self.kernel_tf = kernel_tf

        # weightKDM: each field weights its own columns; Wb balances the
        # magnetic rows
        _, wg, wg_inv = sensitivity_weighting(kernel_gz, 0.5)
        _, wt, wt_inv = sensitivity_weighting(kernel_tf, 0.5)
        std_gz = float(np.std(kernel_gz))
        std_tf = float(np.std(kernel_tf))
        self.wb_tf = std_gz / std_tf
        self.wdiag = np.concatenate([wg, wt])
        self.wdiag_inv = np.concatenate([wg_inv, wt_inv])
        self.Awg = kernel_gz * wg_inv[None, :]
        self.Awt = (kernel_tf * wt_inv[None, :]) * self.wb_tf
        self.dobsw = np.concatenate([self.dobs_gz,
                                     self.wb_tf * self.dobs_tf])
        self.M = kernel_gz.shape[1]
        self.n_active = 2 * self.M
        self._active3d = (mesh.active.reshape(mesh.shape)
                          if not mesh.active.all() else None)

    @property
    def A(self):
        """Materialised block-diagonal kernel, reference layout
        (inversion/potential.py:935-938). Prefer the block product."""
        Dg, M = self.kernel_gz.shape
        Dt = self.kernel_tf.shape[0]
        A = np.zeros((Dg + Dt, 2 * M))
        A[:Dg, :M] = self.kernel_gz
        A[Dg:, M:] = self.kernel_tf
        return A

    def forward(self, model):
        """Unweighted forward of a stacked [rho; mag] model
        (reference: inversion/potential.py:1067-1073)."""
        model = np.asarray(model)
        return np.concatenate([self.kernel_gz @ model[: self.M],
                               self.kernel_tf @ model[self.M:]])

    def make_potential(self, aprior_mw, low, high, constraint="mandatory",
                       log_factor=1000.0, regularization="Damping",
                       beta=0.01, cross_gradient_weight=0.0, dtype=None,
                       jacobian=False, temperature=1.0, device=None):
        """A :class:`~.potential.Potential` over the stacked (2M,) variable
        or a chain batch (C, 2M): ``fn(x, alpha, P) -> (U, g, (dpre,
        U_data, U_model))``. 'mandatory' (and 'reflective', the identity
        transform too) or 'logarithmic' (``log_factor`` k); the
        Jacobian and a temperature other than 1 raise
        ``NotImplementedError``, as in the JAX package."""
        if jacobian or float(temperature) != 1.0:
            raise NotImplementedError(
                "the joint potential does not support the honest-"
                "posterior temperature/jacobian mode yet")
        if regularization not in ("MS", "Damping", "Smoothness", "TV"):
            raise ValueError(
                "Please choose regularization from 'MS','Damping', "
                "'Smoothness', 'TV'.")
        dtype = dtype or self.dtype
        device = self.device if device is None else torch.device(device)
        M = self.M
        mshape = self.mshape
        beta = float(beta)
        lf = float(log_factor)
        cgw = float(cross_gradient_weight)
        logistic = constraint == "logarithmic"

        def vec(v):
            return as_tensor(v, dtype, device)

        params = {
            "Awg": vec(self.Awg),
            "Awt": vec(self.Awt),
            "dobsw": vec(self.dobsw),
            "aprior_mw": vec(aprior_mw),
            "low": vec(low),
            "high": vec(high),
            "wm_sq": vec(self.wdiag ** 2),
            "wdiag_inv": vec(self.wdiag_inv),
        }
        params["width"] = params["high"] - params["low"]

        def model_term(dm, P):
            if regularization in ("MS", "Damping"):
                return model_value_and_grad(regularization, dm, P["wm_sq"],
                                            beta, mshape)
            # the doubled-size operators: fd on each half
            (ug, gg), (ut, gt) = (fd.value_and_grad(regularization, h,
                                                    mshape, beta)
                                  for h in (dm[..., :M], dm[..., M:]))
            return ug + ut, torch.cat([gg, gt], dim=-1)

        def fn(x, alpha, P):
            x = torch.as_tensor(x, dtype=dtype, device=device)
            if logistic:
                kx = lf * x
                s = torch.sigmoid(kx)
                mw = P["low"] + P["width"] * s
            else:
                mw = x
            dpre = torch.cat([mw[..., :M] @ P["Awg"].T,
                              mw[..., M:] @ P["Awt"].T], dim=-1)
            r = dpre - P["dobsw"]  # plain residual (joint convention)
            u_data = (r * r).sum(-1)
            Dg = P["Awg"].shape[0]
            gdata = torch.cat([(2.0 * r[..., :Dg]) @ P["Awg"],
                               (2.0 * r[..., Dg:]) @ P["Awt"]], dim=-1)
            u_model, gm = model_term(mw - P["aprior_mw"], P)
            U = u_data + alpha * u_model
            g = gdata + alpha * gm
            if cgw:
                u_cg, g_cg = _cross_value_and_grad(mw * P["wdiag_inv"],
                                                   mshape)
                U = U + cgw * u_cg
                g = g + cgw * g_cg * P["wdiag_inv"]
            if logistic:
                g = g * P["width"] * (s * torch.sigmoid(-kx)) * lf
            return U, g, (dpre, u_data, u_model)

        return Potential(fn, params)
