"""Misfit/gradient provider for gravity and magnetics, in PyTorch.

Counterpart of ``gravinv3dhmc_tpu/inversion/potential.py``:
``sensitivity_weighting`` and :class:`GravMagModule` for ``field="gravity"``
or ``"magnetic"`` (the total field) on cartesian prism meshes (uniform,
ratio or per-segment depth spacing) and spherical tesseroid meshes
(uniform or per-segment), with topography carving, the frozen-cell
``grav_fix`` correction and the wavelet-compressed kernel (``wavelet`` or
``wavelet_mode`` "1D" or "3D", :mod:`..ops.wavelet`), and
``make_potential`` with the MS, Damping, Smoothness or TV regularizer
under the 'mandatory', 'reflective' (both the identity transform) or
'logarithmic' constraint (the logistic box transform,
:func:`logistic_to_mw`), at a likelihood temperature and, under
'logarithmic', with the transform's log-Jacobian. For the CG solvers
(:mod:`.reginv`) the module also has the JAX one's ``kernelw``,
``device_arrays`` (the matrix and the data on the module's device, one
copy a dtype), ``predict`` and ``_active3d``.

The kernel matrix: prism gz from the f64 host builder, the torch device
builder (``kernel_backend="jax"``, f64) or the f32 CUDA gz kernels
(``"pallas"``); the prism total field (:func:`..ops.prism.tf`) and every
tesseroid field (the native f64 engine, :mod:`..ops.tesseroid`) on the
host in f64, as in the JAX package; spherical gravity with
``kernel_device=True`` on the card
(:func:`..ops.tesseroid.tesseroid_kernel_device`), weighted there, with
no host copy of the matrix.

The JAX package differentiates a scalar potential with
``jax.value_and_grad``; here the gradient is written out. With
``r = (d - mean d) - dobs_c`` and ``d = A mw + fix`` the data term
``sum r^2`` has gradient ``2 A^T (r - mean r)`` (the transpose of the
mean-removal projector); with the wavelet kernel ``d = Awcp W mw + fix``
and the gradient is ``W^T Awcp^T 2 (r - mean r)``, the adjoint of the
transform written out (:meth:`..ops.wavelet.ModelTransform.adjoint`) and
``Awcp^T`` kept as a CSR tensor of its own. The regularizer gradients are
``2 dm`` (Damping), ``wm_sq * 2 beta dm / (dm^2 + beta)^2`` (MS) and the
adjoints of the finite differences (Smoothness, TV: :mod:`..ops.fd`; on
a carved mesh the active cells are scattered to the full grid, and the
differences that touch a carved cell are 0).
Under 'logarithmic', ``mw = low + (high - low) s`` with ``s = sigmoid(kx)``,
so the mw-gradient is chained through ``dmw/dx = (high - low) k s s'``
with ``s' = sigmoid(-kx)`` (not ``1 - s``, which is 0 once ``s`` rounds to
1 at large kx), and the Jacobian term ``softplus(kx) + softplus(-kx) -
log((high - low) k)`` adds ``k (s - s')``. Dense products with the matrix
are IEEE float32 ``torch.matmul`` on the card (TF32 stays off: PyTorch's
default for matmul, ``torch.backends.cuda.matmul.allow_tf32`` False);
the wavelet products are ``torch.sparse`` CSR products. The joint
gravity and magnetic module is :mod:`.joint`.
"""
from __future__ import annotations

import os
import time
import warnings

import numpy as np
import torch
from torch import nn

from .. import mesher
from .._device import as_tensor, resolve, sync
from ..ops import fd, prism, tesseroid
from ..ops import wavelet as wavelet_ops
from ..utils.units import ang2vec

CONSTRAINTS = ("mandatory", "logarithmic", "reflective")


def logistic_to_mw(x, low, high, log_factor, xp=torch):
    """x -> mw under the 'logarithmic' boundary constraint:
    ``low + (high - low) sigmoid(k x)``. ``xp=np`` takes numpy arrays and
    the JAX package's stable numpy form."""
    if xp is torch:
        return low + (high - low) * torch.sigmoid(log_factor * x)
    t = log_factor * np.asarray(x)
    e = np.exp(-np.abs(t))
    s = np.where(t >= 0, 1.0 / (1.0 + e), e / (1.0 + e))
    return low + (high - low) * s


def mw_to_logistic(mw, low, high, log_factor, xp=np):
    """mw -> x, the inverse transform: ``log((mw - low) / (high - mw)) / k``."""
    return (1.0 / log_factor) * xp.log((mw - low) / (high - mw))


def sensitivity_weighting(A, weightfactor=0.5):
    """Depth weighting from column energies (numpy, f64).

    Returns (Aw, wdiag, wdiag_inv): ``wdiag_j = (sum_i A_ij^2)^wf`` and
    ``Aw = A / wdiag`` with zero columns left unscaled
    (reference: inversion/potential.py:232-264, minus its zero-column bug).
    """
    col_sq = np.einsum("ij,ij->j", A, A)
    wdiag = np.power(col_sq, weightfactor)
    wdiag_inv = np.where(wdiag == 0, 0.0, 1.0 / np.where(wdiag == 0, 1.0, wdiag))
    Aw = A * wdiag_inv[None, :]
    return Aw, wdiag, wdiag_inv


class Potential(nn.Module):
    """Potential energy with explicit parameters.

    ``fn(x, alpha, params) -> (U, grad, (dpre, U_data, U_model))`` keeps the
    JAX package's layout; ``params`` is a dict of tensors under the JAX
    names (``Aw``, ``dobs_centered``, ``aprior_mw``, ``low``, ``high``,
    ``wm_sq``, ``grav_fix``). Calling the module uses its own params.
    """

    def __init__(self, fn, params):
        super().__init__()
        self.fn = fn
        self.params = params

    def forward(self, x, alpha):
        return self.fn(x, alpha, self.params)


def model_value_and_grad(regularization, dm, wm_sq, beta, mshape,
                         active3d=None, active_idx=None):
    """The regularizer's value ``(...,)`` and gradient ``(..., M)`` at
    ``dm = mw - aprior_mw``: MS ``sum wm_sq dm^2 / (dm^2 + beta)`` with
    gradient ``wm_sq 2 beta dm / (dm^2 + beta)^2``, Damping ``sum dm^2``
    with ``2 dm``, Smoothness and TV from :func:`..ops.fd.value_and_grad`.
    On a carved mesh (``active3d`` and the packed cells' grid indices
    ``active_idx``) the active cells go to the full grid (the JAX
    package's ``scatter_full``) and the gradient comes back."""
    if regularization == "MS":
        dm2 = dm * dm
        den = dm2 + beta
        return ((wm_sq * dm2 / den).sum(-1),
                wm_sq * (2.0 * beta) * dm / (den * den))
    if regularization == "Damping":
        return (dm * dm).sum(-1), 2.0 * dm
    if active_idx is None:
        return fd.value_and_grad(regularization, dm, mshape, beta)
    full = dm.new_zeros(dm.shape[:-1] + (int(np.prod(mshape)),))
    full[..., active_idx] = dm
    u, g = fd.value_and_grad(regularization, full, mshape, beta, active3d)
    return u, g[..., active_idx]


def sparse_pair(Awcp, dtype, device):
    """``{"Awcp", "AwcpT"}``: the scipy matrix and its transpose as torch
    CSR tensors of ``dtype`` on ``device``. The transpose has a CSR copy of
    its own, so the gradient's product is a CSR product too."""
    def csr(m):
        m = m.tocsr()
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "Sparse CSR tensor support")
            return torch.sparse_csr_tensor(
                torch.as_tensor(m.indptr, dtype=torch.int64),
                torch.as_tensor(m.indices, dtype=torch.int64),
                torch.as_tensor(m.data, dtype=dtype), size=m.shape,
                device=device, check_invariants=False)
    return {"Awcp": csr(Awcp), "AwcpT": csr(Awcp.T)}


def spmm(S, v):
    """``S v`` on the last axis of ``v`` (..., K) for a CSR ``S`` (D, K):
    (..., D), one CSR product with the batch as columns."""
    K = v.shape[-1]
    cols = v.reshape(-1, K).T.contiguous()
    return (S @ cols).T.reshape(v.shape[:-1] + (S.shape[0],))


class GravMagModule:
    """Builds the kernel and its weighting; provides the potential.

    The constructor keeps the JAX package's signature. Gravity and the
    total magnetic field (``field="magnetic"``, ``mangle=(inc, dec)`` in
    degrees: the column of a cell is the anomaly of a unit magnetization
    induced along the regional field) are ported on both coordinates:
    cartesian prisms (:class:`~..mesher.PrismMesh`, or
    :class:`~..mesher.PrismMeshSegment` with ``mseg``) and spherical
    tesseroids (:class:`~..mesher.TesseroidMesh`, or
    :class:`~..mesher.TesseroidMeshSegment` with ``mseg`` and
    ``mdivisionsection``). Any extra keyword argument is the topography
    triple ``mtopo = (x, y, height)``, as in the JAX package: the mesh is
    carved under it, ``mask`` lists the carved cells and ``topocarve`` is
    set. ``fixed`` with ``grav_fix`` adds the frozen cells' data.
    ``wavelet`` (or ``wavelet_mode``) "1D" or "3D" also thresholds the
    weighted kernel's wavelet coefficients into ``Awcp`` (scipy CSR, f64,
    on the host; :mod:`..ops.wavelet`), which :meth:`predict` and
    :meth:`make_potential` use by default; a 3D wavelet needs the full
    grid, so a carved mesh refuses it (``ValueError``, as the JAX module
    fails in its reshape). ``kernel_cache`` is a path: a file that exists
    there is loaded with ``np.load`` in place of the build (the unweighted
    matrix; a shape other than (observations, active cells) raises
    ``ValueError``), and otherwise the built matrix is saved there with
    ``np.save``, as the JAX module does.

    ``kernel_device=True`` (spherical gravity only; any other field,
    coordinate or a wavelet raises ``NotImplementedError``, as in the JAX
    package) builds the matrix on ``device`` in ``dtype``
    (:func:`~..ops.tesseroid.tesseroid_kernel_device`: the far field in
    torch, the near-field pairs from the native engine, or from
    ``kernel_cache``'s host matrix when that file exists) and weights it
    there: ``wdiag`` (column norms to the power ``weightfactor``, summed
    in f32, zero columns left unscaled) and ``wdiag_inv`` are f32 tensors
    on ``device``, ``device_arrays()["Aw"]`` is the weighted matrix, and
    ``A`` and ``Aw`` are None unless the cache gave the host matrix.
    ``kernel_build_s``, ``weighting_s``, ``nearfield_pairs``,
    ``mask_backend``, ``pairs_backend`` and ``build_seconds`` (the
    builder's stages) describe the build.

    ``device`` (by default ``cuda:0``, see
    :mod:`~gravinv3dhmc_tpu_torch._device`) is where
    :meth:`make_potential` puts its tensors and, for prism gz with
    ``kernel_backend="jax"`` (f64) or ``"pallas"`` (f32, the CUDA gz
    kernels), where the matrix is built (see
    :func:`~..ops.prism.prism_kernel_matrix`); the weighting then runs in
    numpy on the returned matrix, as in the JAX package. A tesseroid
    matrix is built in f64 on the host by the native engine (numpy with a
    warning when it cannot be built), as in the JAX package;
    ``tess_backend`` says which ran. ``kernel_build_s`` is the builder's
    wall time, the copy to the host included; ``build_seconds`` splits the
    build: the device builders' timings (see
    :func:`~..ops.prism.prism_kernel_matrix`), ``weighting_s``, the wall
    time of :func:`sensitivity_weighting`, and ``wavelet_s``, the
    compressor's.
    """

    def __init__(self, dobs, mrange, mspacing, obsurface, fixed=False,
                 grav_fix=(), mratio=1, mseg=False, mdivisionsection=(),
                 weightfactor=0.5, coordinate="cartesian", njobs=1,
                 field="gravity", mangle=(90, 0), wavelet_mode=None,
                 wavelet=False, kernel_backend="numpy", dtype=torch.float32,
                 kernel_cache=None, kernel_device=False, verbose=True,
                 device=None, **kwargs):
        if coordinate not in ("cartesian", "spherical"):
            raise ValueError(
                "Please choose coordinate from(cartesian, spherical) and "
                "field from(gravity, magnetic)!")
        if field not in ("gravity", "magnetic"):
            raise ValueError(
                "Please choose coordinate from(cartesian, spherical) and "
                "field from(gravity, magnetic)!")
        self.dobs = np.asarray(dobs, dtype=np.float64)
        self.fixed = fixed
        self.grav_fix = (np.asarray(grav_fix, dtype=np.float64) if fixed
                         else None)
        self.mrange = mrange
        self.mspacing = mspacing
        self.mratio = mratio
        self.mseg = mseg
        self.mdivisionsection = mdivisionsection
        self.weightfactor = weightfactor
        self.coordinate = coordinate
        self.field = field
        self.inc, self.dec = mangle
        # the reference passes the mode under the name 'wavelet'
        self.wavelet = wavelet_mode if wavelet_mode is not None else wavelet
        self.dtype = dtype
        self.device = resolve(device)
        self.lonobs = np.asarray(obsurface[0], dtype=np.float64)
        self.latobs = np.asarray(obsurface[1], dtype=np.float64)
        self.heightobs = np.asarray(obsurface[2], dtype=np.float64)
        self.topocarve = False
        self.mask = []
        mtopo = None
        for _key, value in kwargs.items():
            self.topocarve = True
            mtopo = value

        if coordinate == "spherical":
            mesh = (mesher.TesseroidMeshSegment(mrange, mspacing,
                                                mdivisionsection) if mseg
                    else mesher.TesseroidMesh(mrange, mspacing, mratio))
        else:
            mesh = (mesher.PrismMeshSegment(mrange, mspacing,
                                            mdivisionsection) if mseg
                    else mesher.PrismMesh(mrange, mspacing, mratio))
        if mtopo is not None:
            self.mask = mesh.carvetopo(mtopo[0], mtopo[1], mtopo[2])
        self.mesh = mesh
        self.mshape = mesh.shape
        if kernel_device:
            if not (coordinate == "spherical" and field == "gravity"):
                raise NotImplementedError(
                    "kernel_device=True is implemented for spherical "
                    "gravity (the tesseroid device builder)")
            if self.wavelet:
                raise NotImplementedError(
                    "wavelet compression needs the host kernel; drop "
                    "kernel_device or wavelet")
            self._init_kernel_device(kernel_cache, weightfactor, verbose)
            return
        if self.wavelet == "3D" and not mesh.active.all():
            raise ValueError(
                f"a 3D wavelet needs the full {mesh.shape} grid: the "
                f"carved mesh keeps {int(mesh.active.sum())} of {mesh.size} "
                "cells, and the 3D compressor reshapes the packed kernel to "
                "the grid; use wavelet='1D'")
        start = time.time()
        self.build_seconds = {}
        self.tess_backend = None
        info = {}
        if kernel_cache and os.path.exists(kernel_cache):
            # the JAX module loads whatever the file holds; a matrix of
            # another geometry is refused here
            kernel = np.load(kernel_cache)
            want = (self.lonobs.size, int(mesh.active.sum()))
            if kernel.shape != want:
                raise ValueError(
                    f"kernel cache {kernel_cache} holds a {kernel.shape} "
                    f"matrix; this module's observations and active cells "
                    f"need {want}")
            if verbose:
                print(f"loaded kernel from {kernel_cache}")
        else:
            if field == "magnetic":
                mesh.addprop("magnetization",
                             ang2vec(np.zeros(mesh.size), self.inc,
                                     self.dec))
                builder = tesseroid if coordinate == "spherical" else prism
                kw = {"info": info} if coordinate == "spherical" else {}
                _, kernel = builder.tf(self.lonobs, self.latobs,
                                       self.heightobs, mesh, self.inc,
                                       self.dec, **kw)
            elif coordinate == "spherical":
                mesh.addprop("density", np.zeros(mesh.size))
                kernel = tesseroid.tesseroid_kernel_matrix(
                    "gz", self.lonobs, self.latobs, self.heightobs, mesh,
                    info=info)
            else:
                mesh.addprop("density", np.zeros(mesh.size))
                kernel = prism.prism_kernel_matrix(
                    "gz", self.lonobs, self.latobs, self.heightobs, mesh,
                    backend=kernel_backend, device=self.device,
                    timings=self.build_seconds)
            if verbose:
                print("End of calculate kernel:%.6f s"
                      % (time.time() - start))
            if kernel_cache:
                # np.save appends ".npy" to a path without it
                np.save(kernel_cache if kernel_cache.endswith(".npy")
                        else kernel_cache + ".npy", kernel)
                if not kernel_cache.endswith(".npy"):
                    os.replace(kernel_cache + ".npy", kernel_cache)
        self.tess_backend = info.get("tess_backend")
        self.kernel_build_s = time.time() - start
        t0 = time.perf_counter()
        Aw, wdiag, wdiag_inv = sensitivity_weighting(kernel, weightfactor)
        self.build_seconds["weighting_s"] = time.perf_counter() - t0
        self.A = kernel
        self.Aw = Aw
        self.wdiag = wdiag
        self.wdiag_inv = wdiag_inv
        self.n_active = Aw.shape[1]
        # the active-cell grid of a carved mesh (Smoothness and TV)
        self._active3d = (mesh.active.reshape(mesh.shape)
                          if not mesh.active.all() else None)
        # the wavelet-compressed kernel, thresholded in f64 on the host
        self.Awcp = None
        self._model_transform = None
        if self.wavelet in ("1D", "3D"):
            if verbose:
                print(f"Using {self.wavelet} wavelet to compress kernel.")
            t0 = time.perf_counter()
            if self.wavelet == "1D":
                self.Awcp = wavelet_ops.kernelcompressor_1d(Aw)
            else:
                self.Awcp = wavelet_ops.kernelcompressor_3d(Aw, self.mshape)
            self._model_transform = wavelet_ops.make_model_transform(
                mshape=self.mshape, mode=self.wavelet)
            self.build_seconds["wavelet_s"] = time.perf_counter() - t0
        self._dev = {}

    def _init_kernel_device(self, kernel_cache, weightfactor, verbose):
        """The matrix built and weighted on ``self.device``; ``A`` and
        ``Aw`` stay None unless ``kernel_cache`` holds the host matrix."""
        t0 = time.perf_counter()
        self.mesh.addprop("density", np.zeros(self.mesh.size))
        cells = self.mesh.cell_bounds(only_active=True)
        K_host = None
        if kernel_cache and os.path.exists(kernel_cache):
            K_host = np.load(kernel_cache)
            if verbose:
                print(f"loaded host kernel cache {kernel_cache} for "
                      "near-field corrections")
        info = {}
        K, (oi, _) = tesseroid.tesseroid_kernel_device(
            "gz", self.lonobs, self.latobs, self.heightobs, cells,
            host_kernel=K_host, dtype=self.dtype, device=self.device,
            info=info)
        self.nearfield_pairs = int(oi.size)
        self.mask_backend = info["mask_backend"]
        self.pairs_backend = info.get("pairs_backend")
        t1 = time.perf_counter()
        if verbose:
            print("End of calculate kernel:%.6f s" % (t1 - t0))
        # column energies in f32 (the JAX module's), the matrix scaled in
        # place (the JAX module donates it)
        Kf = K.float()
        wdiag = (Kf * Kf).sum(0) ** float(weightfactor)
        del Kf
        wdiag_inv = torch.where(
            wdiag == 0, 0.0, 1.0 / torch.where(wdiag == 0, 1.0, wdiag))
        K.mul_(wdiag_inv.to(K.dtype))
        sync(self.device)
        t2 = time.perf_counter()
        self.A = K_host
        self.Aw = None
        if K_host is not None:
            w = wdiag.cpu().double().numpy()
            self.Aw = K_host * np.where(
                w == 0, 0.0, 1.0 / np.where(w == 0, 1.0, w))[None, :]
        self.wdiag = wdiag
        self.wdiag_inv = wdiag_inv
        self.n_active = int(cells.shape[0])
        self._active3d = (self.mesh.active.reshape(self.mesh.shape)
                          if not self.mesh.active.all() else None)
        self.Awcp = None
        self._model_transform = None
        self.tess_backend = None
        self._dev = {self.dtype: {
            "Aw": K,
            "dobs": as_tensor(self.dobs, self.dtype, self.device),
            "grav_fix": (as_tensor(self.grav_fix, self.dtype, self.device)
                         if self.fixed else None)}}
        self.kernel_build_s = t1 - t0
        self.weighting_s = t2 - t1
        self.build_seconds = {k: v for k, v in info.items()
                              if k.endswith("_s")}
        self.build_seconds["weighting_s"] = self.weighting_s

    def kernelw(self):
        """Weighted kernel and (vector) weighting diagonals: ``(Aw,
        wdiag_inv, wdiag)``, host numpy, as the JAX module returns them."""
        return self.Aw, self.wdiag_inv, self.wdiag

    def device_arrays(self, dtype=None):
        """``{"Aw", "dobs", "grav_fix"}`` as tensors of ``dtype`` (the
        module's by default) on the module's device, made once a dtype
        (``grav_fix`` is None without frozen cells); with a wavelet kernel
        also ``"Awcp"`` and its transpose ``"AwcpT"``, CSR tensors cast
        from the f64 thresholded matrix (so both hold its nonzero set)."""
        dtype = dtype or self.dtype
        if dtype not in self._dev and self.Aw is None:
            raise ValueError(
                f"the matrix was built on the card in {self.dtype}; this "
                f"module has no {dtype} copy")
        if dtype not in self._dev:
            def dev(a):
                return torch.as_tensor(np.asarray(a), dtype=dtype,
                                       device=self.device)
            self._dev[dtype] = {
                "Aw": dev(self.Aw), "dobs": dev(self.dobs),
                "grav_fix": dev(self.grav_fix) if self.fixed else None}
            if self.Awcp is not None:
                self._dev[dtype].update(sparse_pair(self.Awcp, dtype,
                                                    self.device))
        return self._dev[dtype]

    def predict(self, mw, use_wavelet=None):
        """Predicted data of a weighted-domain model or batch ``(..., M)``
        in the module's dtype: ``mw @ Aw.T``, or with the wavelet kernel
        (the module's ``wavelet`` unless ``use_wavelet`` says otherwise)
        ``Awcp W mw``. As in the JAX package's ``predict``, ``grav_fix``
        is not added (an open question of ROADMAP.md queue 3: the realdata
        problems here have ``grav_fix = 0``)."""
        arrs = self.device_arrays()
        A = arrs["Aw"]
        mw = torch.as_tensor(mw, dtype=A.dtype, device=A.device)
        use_wavelet = self.wavelet if use_wavelet is None else use_wavelet
        if use_wavelet and self.Awcp is not None:
            return spmm(arrs["Awcp"], self._model_transform(mw))
        return mw @ A.T

    def make_potential(self, aprior_mw, low, high, constraint="mandatory",
                       log_factor=1000.0, regularization="Damping",
                       beta=0.01, use_wavelet=None, dtype=None,
                       matvec_dtype=None, jacobian=False, temperature=1.0,
                       device=None):
        """Return a :class:`Potential` for a model (M,) or chain batch (C, M).

        ``aprior_mw``, ``low`` and ``high`` are in the weighted (mw)
        domain. ``matvec_dtype`` (e.g. ``torch.bfloat16``) stores the kernel
        matrix in that type; products are accumulated in ``dtype``. With a
        wavelet kernel the data term is ``Awcp W mw`` (the module's
        ``wavelet`` unless ``use_wavelet`` says otherwise; ``Awcp`` at
        ``dtype``, ``matvec_dtype`` unused, as in the JAX package). Under
        ``constraint="logarithmic"`` x is the logistic variable
        (``log_factor`` k) and ``jacobian`` adds the transform's
        log-Jacobian; ``temperature`` divides the data and model terms.
        """
        if regularization not in ("MS", "Damping", "Smoothness", "TV"):
            raise ValueError(
                "Please choose regularization from 'MS','Damping', "
                "'Smoothness', 'TV'.")
        if constraint not in CONSTRAINTS:
            raise ValueError(
                "Please choose right boundary constraint(mandatory, "
                "logarithmic)!")
        use_wavelet = self.wavelet if use_wavelet is None else use_wavelet
        wave = bool(use_wavelet) and self.Awcp is not None
        dtype = dtype or self.dtype
        device = self.device if device is None else torch.device(device)

        def vec(v):
            return as_tensor(v, dtype, device)

        dobs = vec(self.dobs)
        params = {
            "dobs_centered": dobs - dobs.mean(),
            "aprior_mw": vec(aprior_mw),
            "low": vec(low),
            "high": vec(high),
            "wm_sq": vec(self.wdiag * self.wdiag),
            "grav_fix": vec(self.grav_fix) if self.fixed else None,
        }
        if not wave and self.Aw is None:
            # built on the card: the module's own weighted matrix
            params["Aw"] = self.device_arrays(dtype)["Aw"].to(
                device=device, dtype=matvec_dtype or dtype)
        elif not wave:
            params["Aw"] = torch.as_tensor(
                self.Aw, dtype=matvec_dtype or dtype, device=device)
        elif device == self.device:
            arrs = self.device_arrays(dtype)
            params.update(Awcp=arrs["Awcp"], AwcpT=arrs["AwcpT"])
        else:
            params.update(sparse_pair(self.Awcp, dtype, device))
        transform = self._model_transform
        M = self.n_active
        beta = float(beta)
        mshape = self.mshape
        if regularization in ("Smoothness", "TV") and self._active3d is not None:
            params["active3d"] = torch.as_tensor(self._active3d,
                                                 device=device)
            params["active_idx"] = torch.as_tensor(
                np.flatnonzero(self.mesh.active), device=device)
        logistic = constraint == "logarithmic"
        jac = logistic and jacobian
        lf = float(log_factor)
        # the likelihood temperature: target exp(-U/T) (the JAX package's
        # ``temperature``); the Jacobian term is not divided by it
        inv_t = 1.0 / float(temperature)
        if logistic:
            width = params["high"] - params["low"]
            params["width"] = width
            # cells of zero width have a constant mw and no log-width
            params["log_const"] = torch.where(
                width > 0, torch.log(torch.where(width > 0, width, 1.0) * lf),
                torch.zeros_like(width))

        def fn(x, alpha, P):
            x = torch.as_tensor(x, dtype=dtype, device=device)
            if logistic:
                kx = lf * x
                s = torch.sigmoid(kx)
                sn = torch.sigmoid(-kx)
                mw = P["low"] + P["width"] * s
            else:
                mw = x
            if wave:
                dpre = spmm(P["Awcp"], transform(mw))
            else:
                A = P["Aw"]
                if A.dtype != dtype:
                    # reduced-precision storage: round the model to A's
                    # type, then multiply and accumulate in ``dtype``
                    A = A.to(dtype)
                    mv = mw.to(P["Aw"].dtype).to(dtype)
                else:
                    mv = mw
                dpre = mv @ A.T
            dinv = dpre + P["grav_fix"] if P["grav_fix"] is not None else dpre
            r = (dinv - dinv.mean(-1, keepdim=True)) - P["dobs_centered"]
            u_data = (r * r).sum(-1)
            rc = 2.0 * (r - r.mean(-1, keepdim=True))
            if wave:
                # W^T Awcp^T rc: the transpose's own CSR, then the adjoint
                gdata = transform.adjoint(spmm(P["AwcpT"], rc), M)
            else:
                gdata = rc @ A
            u_model, gm = model_value_and_grad(
                regularization, mw - P["aprior_mw"], P["wm_sq"], beta,
                mshape, P.get("active3d"), P.get("active_idx"))
            U = u_data + alpha * u_model
            g = gdata + alpha * gm
            if inv_t != 1.0:
                U = U * inv_t
                g = g * inv_t
            if logistic:
                # the chain rule through mw(x), then the Jacobian term
                g = g * P["width"] * (s * sn)
                if jac:
                    U = U + (torch.logaddexp(kx, torch.zeros_like(kx))
                             + torch.logaddexp(-kx, torch.zeros_like(kx))
                             - P["log_const"]).sum(-1)
                    g = g + (s - sn)
                g = g * lf
            return U, g, (dpre, u_data, u_model)

        return Potential(fn, params)
