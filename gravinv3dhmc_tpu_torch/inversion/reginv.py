"""Deterministic regularized inversion: projected CG and bootstrap, in
PyTorch.

Counterpart of ``gravinv3dhmc_tpu/inversion/reginv.py``: the
Fletcher-Reeves CG with the analytic step size, the hard box projection
in the model domain and the reference's adaptive regularization schedule
(alpha = 0 at k = 0, alpha = data/model at k = 1, alpha <- q alpha
whenever the data misfit falls by less than 1 %), or a fixed alpha for
the bounded MAP; ``cg_device`` on an existing :class:`GravMagModule`;
the reference-compatible :class:`ConjugateGradient`; and
:class:`BootStrap`, whose with-replacement row resampling is weighted
least squares with each row weighted by its draw count.

Laid out for the card:

* the state is ``(S, M)`` for ``S`` sets of row weights (the bootstrap's
  replicates; ``S = 1`` for one solve), so one ``(S, M) @ (M, D)``
  product serves every replicate;
* each iteration carries the residual, the data misfit and the model
  term's value and gradient of the point it moves to, so an iteration
  makes three passes over the matrix (``A mw``, ``r A`` and ``A Iw``);
  the JAX body recomputes the misfits of the two points it holds, the
  same values through the same op;
* no host read an iteration: the loop reads the all-done flag once every
  :data:`CHECK_EVERY` iterations and stops when every replicate has stopped
  (its histories are NaN from then on, as the JAX scan would fill them);
* model gradients are analytic: MS the exact derivative of the MS value
  with the prior (the reference's bug, its ``(mw^2 + beta)^2``
  denominator, is not copied, as in the JAX package), the bootstrap's MS
  without prior and with beta squared, Damping ``2 dm``, Smoothness and TV
  the finite-difference adjoints of :mod:`..ops.fd`.

The products stay ``torch.matmul`` in the solver's dtype: float64 where
the JAX package is float64 (``ConjugateGradient``, ``BootStrap``) and
IEEE float32 with TF32 off (PyTorch's default) where it is float32
(``cg_device``'s default). The JAX package computes them as plain XLA
dots, outside its Pallas kernels.

Smoothness and TV on a topography-carved mesh raise ``ValueError``: the
JAX package's ``fd.grid_diffs`` reshapes the packed active-cell vector to
the full grid and fails there too (``TypeError``).

Entry points run on ``cuda:0`` unless a device is given.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import as_tensor, resolve
from .potential import GravMagModule, model_value_and_grad

REGULARIZATIONS = ("MS", "Damping", "Smoothness", "TV")
#: a fixed-alpha ``cg_device`` solve runs as restarted segments of this
#: many iterations; each restart opens with a steepest-descent step and
#: re-seeds the best iterate, as the JAX package's do
SEGMENT = 800
#: the loop reads the all-done flag once every this many iterations
CHECK_EVERY = 16


def _make_cg_core(Aw, dobs, wdiag, wdiag_inv, mshape, active3d,
                  regularization, beta, q, maxk, rhomin, rhomax,
                  stop_mode, dtype, aprior_mw=None, bootstrap_ms=False,
                  as_args=False, fixed_alpha=False, keep_best=False,
                  device=None):
    """CG solver over (optionally weighted) rows.

    Returns ``solve(mw0, row_weights[, arrs][, alpha]) -> (mw_final,
    data_hist, model_hist, regul_hist, n_iters)``, tensors on the
    arrays' device. ``row_weights`` are data-row multiplicities, ``(D,)``
    for one solve or ``(S, D)`` for ``S`` solves from the one ``mw0``
    (the JAX package's ``vmap`` over the weights); the outputs then have
    a leading ``S``. ``as_args=True`` takes the large arrays at call time
    as ``arrs = (Aw, dobs, wdiag, wdiag_inv, aprior_mw)`` tensors;
    otherwise the arrays given here are put on ``device`` (``cuda:0``
    when None). ``fixed_alpha=True`` minimises ``||A mw - d||^2 + alpha
    R(mw)`` with the one ``alpha`` given to ``solve``, from the k = 0
    step on; ``keep_best`` returns the iterate of the least such
    objective. ``stop_mode`` is "normalized" (data misfit / D < 0.001) or
    "absolute" (data misfit < 0.1, the bootstrap's).
    """
    if regularization not in REGULARIZATIONS:
        raise ValueError(
            "Please choose regularization from 'MS','Damping', "
            "'Smoothness', 'TV'.")
    fd_reg = regularization in ("Smoothness", "TV") and not bootstrap_ms
    if fd_reg and active3d is not None:
        raise ValueError(
            f"{regularization} on a topography-carved mesh: the JAX "
            "package cannot run this case either (its fd.grid_diffs "
            "reshapes the packed active cells to the full grid)")
    if stop_mode not in ("normalized", "absolute"):
        raise ValueError(f"unknown stop_mode {stop_mode!r}")
    beta = float(beta)
    q = float(q)
    if as_args:
        const_arrs = None
    else:
        dev = resolve(device)

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        Aw_c = t(Aw)
        const_arrs = (Aw_c, t(dobs), t(wdiag), t(wdiag_inv),
                      t(aprior_mw) if aprior_mw is not None
                      else Aw_c.new_zeros(Aw_c.shape[1]))

    def solve(mw0, c, arrs=None, alpha=None):
        Aw, dobs, wdiag, wdiag_inv, apr = \
            const_arrs if arrs is None else arrs
        dev = Aw.device
        dsize, msize = Aw.shape
        wm_sq = wdiag * wdiag
        c = torch.as_tensor(c, dtype=dtype, device=dev)
        single = c.ndim == 1
        c = c.reshape(-1, dsize)
        S = c.shape[0]
        mw0 = torch.as_tensor(mw0, dtype=dtype, device=dev).expand(S, msize)

        def residual(mw):
            return mw @ Aw.T - dobs

        def data_of(r):
            return (c * r * r).sum(-1)

        def model(mw):
            """The model term's value (S,) and gradient (S, M)."""
            if bootstrap_ms:
                # no prior, beta squared (reference: reginv.py:600-606)
                m2 = mw * mw
                b2 = beta ** 2
                den = m2 + b2
                return ((wm_sq * m2 / den).sum(-1),
                        wm_sq * (2.0 * b2) * mw / (den * den))
            return model_value_and_grad(regularization, mw - apr, wm_sq,
                                        beta, mshape)

        def project(mw):
            return torch.clamp(mw * wdiag_inv, rhomin, rhomax) * wdiag

        def weighted_norm_sq(v):
            av = v @ Aw.T
            return (c * av * av).sum(-1)

        def dot(a, b):
            return (a * b).sum(-1)

        def col(v):
            return v[:, None]

        def keep(done, old, new):
            """``old`` where the replicate is done: its state is frozen."""
            return torch.where(col(done) if old.ndim == 2 else done, old,
                               new)

        r0 = residual(mw0)
        d0 = data_of(r0)
        m0, g0 = model(mw0)
        # ---- k = 0: steepest descent (alpha = 0 under the adaptive
        # schedule; the fixed objective's full gradient with fixed alpha)
        I0 = 2.0 * ((c * r0) @ Aw)
        if fixed_alpha:
            a_f = torch.full((S,), float(alpha), dtype=dtype, device=dev)
            I0 = I0 + col(a_f) * g0
            kstep = dot(I0, I0) / (weighted_norm_sq(I0) + a_f * dot(I0, I0))
        else:
            kstep = dot(I0, I0) / weighted_norm_sq(I0)
        mw1 = project(mw0 - col(kstep) * I0)
        r1 = residual(mw1)
        d1 = data_of(r1)
        m1, g1 = model(mw1)

        mw_prev, mw_cur = mw0, mw1
        I_prev, Iw_prev = I0, I0
        r_cur, d_prev, d_cur, m_cur, g_cur = r1, d0, d1, m1, g1
        alpha_c = torch.zeros(S, dtype=dtype, device=dev)
        done = torch.zeros(S, dtype=torch.bool, device=dev)
        if keep_best:
            # seed the best from both the incoming point and the k = 0
            # step: a restarted solve never returns worse than its start
            a0 = a_f if fixed_alpha else alpha_c
            obj_in = d0 + a0 * m0
            obj_1 = d1 + a0 * m1
            mw_best = torch.where(col(obj_1 < obj_in), mw1, mw0)
            obj_best = torch.minimum(obj_in, obj_1)
        hist = torch.full((max(maxk - 1, 0), S, 3), float("nan"),
                          dtype=dtype, device=dev)

        for k in range(1, maxk):
            if fixed_alpha:
                alpha_c = a_f
            elif k == 1:
                alpha_c = d_cur / m_cur
            else:
                alpha_c = torch.where(d_prev - d_cur < 0.01 * d_prev,
                                      q * alpha_c, alpha_c)
            I = 2.0 * ((c * r_cur) @ Aw) + col(alpha_c) * g_cur
            # Fletcher-Reeves; 0/0 once a replicate has converged, which
            # the freeze below discards
            mu = dot(I, I) / dot(I_prev, I_prev)
            Iw = I + col(mu) * Iw_prev
            kstep = dot(Iw, I) / (weighted_norm_sq(Iw)
                                  + alpha_c * dot(Iw, Iw))
            mw_next = project(mw_cur - col(kstep) * Iw)
            r_next = residual(mw_next)
            d_next = data_of(r_next)
            m_next, g_next = model(mw_next)
            if stop_mode == "normalized":
                stop_now = d_next / dsize < 0.001
            else:  # absolute (the bootstrap's, reference: reginv.py:693)
                stop_now = d_next < 0.1
            hist[k - 1] = torch.where(
                col(done), float("nan"),
                torch.stack([d_next / dsize, m_next / msize, alpha_c], -1))

            mw_prev, mw_cur = (keep(done, mw_prev, mw_cur),
                               keep(done, mw_cur, mw_next))
            I_prev, Iw_prev = keep(done, I_prev, I), keep(done, Iw_prev, Iw)
            d_prev, d_cur = keep(done, d_prev, d_cur), keep(done, d_cur, d_next)
            r_cur, m_cur, g_cur = (keep(done, r_cur, r_next),
                                   keep(done, m_cur, m_next),
                                   keep(done, g_cur, g_next))
            if keep_best:
                # projected Fletcher-Reeves is not monotone (the box
                # breaks conjugacy; f32 can late-diverge): track the best
                # iterate by the fixed objective, gated on done before
                # this iteration's stop test, so the iterate that
                # triggers the stop can still be recorded
                obj_next = d_next + alpha_c * m_next
                better = (obj_next < obj_best) & ~done
                mw_best = torch.where(col(better), mw_next, mw_best)
                obj_best = torch.where(better, obj_next, obj_best)
            done = done | stop_now
            if k % CHECK_EVERY == 0 and bool(done.all()):
                break

        mw_fin = mw_best if keep_best else mw_cur

        def series(first, j):
            return torch.cat([first[None], hist[:, :, j]]).T

        data_hist = series(d0 / dsize, 0)
        model_hist = series(m0 / msize, 1)
        regul_hist = series(torch.zeros(S, dtype=dtype, device=dev), 2)
        n_iters = (~torch.isnan(hist[:, :, 0])).sum(0) + 1
        if single:
            return (mw_fin[0], data_hist[0], model_hist[0], regul_hist[0],
                    n_iters[0])
        return mw_fin, data_hist, model_hist, regul_hist, n_iters

    return solve


def cg_device(module, dobs, boundary, regularization="Damping", beta=0.01,
              q=0.7, maxk=200, initial=None, aprior=None,
              dtype=torch.float32, alpha=None, keep_best=None,
              segment=SEGMENT):
    """CG on an existing :class:`GravMagModule`, its matrix on the
    module's device (:meth:`GravMagModule.device_arrays`; it reads no
    host ``Aw``, so a matrix built on the card serves, and its weights,
    ``initial`` and ``aprior`` may be tensors on the card).

    The reference's workflow is "CG for the map, HMC for the uncertainty
    around it"; this is the map on the module the sampler uses. ``alpha``
    None runs the adaptive schedule; a number runs the bounded MAP at
    that fixed alpha, returning the best-objective iterate unless
    ``keep_best`` says otherwise, in restarted segments of ``segment``
    iterations when ``maxk`` exceeds it (0 or None: one segment). Each
    restart opens with a steepest-descent step from the best iterate so
    far, so the segments change the numbers; the JAX package's are kept.

    Returns a dict: ``mw`` (weighted-domain solution) and ``m`` (density
    model), tensors on the module's device, and host float64
    ``data_hist``, ``model_hist``, ``regul_hist`` (each segment's
    performed iterations) and the int ``n_iters``.
    """
    arrs_mod = module.device_arrays(dtype)
    Aw = arrs_mod["Aw"]
    D, M = Aw.shape
    dev = Aw.device

    def t(a):
        return as_tensor(a, dtype, dev)

    wdiag = t(module.wdiag)
    wdiag_inv = t(module.wdiag_inv)
    apr_m = t(aprior) if aprior is not None else Aw.new_zeros(M)
    mw0 = wdiag * t(initial) if initial is not None else Aw.new_zeros(M)
    if keep_best is None:
        # a fixed alpha minimises one objective, so its best iterate is
        # well defined; the adaptive schedule returns its final one
        keep_best = alpha is not None
    n_segments, maxk_core = 1, maxk
    if alpha is not None and segment and maxk > segment:
        n_segments = -(-maxk // segment)
        maxk_core = segment
    solve = _make_cg_core(
        Aw, None, None, None, module.mshape,
        module._active3d, regularization, beta, q,
        maxk_core, boundary[0], boundary[1], "normalized", dtype,
        as_args=True, fixed_alpha=alpha is not None, keep_best=keep_best)
    arrs = (Aw, t(dobs), wdiag, wdiag_inv, wdiag * apr_m)
    ones = Aw.new_ones(D)
    mw_fin = mw0
    hists = ([], [], [])
    n_total = 0
    for _ in range(n_segments):
        mw_fin, *h, n_it = solve(mw_fin, ones, arrs, alpha)
        n_it = int(n_it)
        for acc, v in zip(hists, h):
            acc.append(v[:n_it].cpu().numpy().astype(np.float64))
        n_total += n_it
    return {
        "mw": mw_fin,
        "m": mw_fin * wdiag_inv,
        "data_hist": np.concatenate(hists[0]),
        "model_hist": np.concatenate(hists[1]),
        "regul_hist": np.concatenate(hists[2]),
        "n_iters": n_total,
    }


def _module(dobs, mrange, mspacing, obsurface, dtype, device, verbose,
            **kwargs):
    """The CG classes' module: the sqrt-column weighting (the reference's
    ``newkernel``) of the f64 host matrix."""
    return GravMagModule(dobs, mrange, mspacing, obsurface, weightfactor=0.5,
                         dtype=dtype, verbose=verbose, device=device,
                         **kwargs)


class _ModuleView:
    """The module's arrays under the JAX classes' attribute names."""

    def _view(self, mod):
        self._mod = mod
        self.mesh = mod.mesh
        self.mshape = mod.mshape
        self.mxs = mod.mesh.get_xs()
        self.mys = mod.mesh.get_ys()
        self.mzs = mod.mesh.get_zs()
        self.A = mod.A
        self.Aw = mod.Aw
        self.wdiag = mod.wdiag
        self.wdiag_inv = mod.wdiag_inv
        self.dsize = self.A.shape[0]
        self.msize = self.A.shape[1]
        self.mask = mod.mask


class ConjugateGradient(_ModuleView):
    """Regularized CG inversion, reference-compatible construction
    (reference: inversion/reginv.py:22-149): mesh, f64 host matrix and
    its sqrt-column weighting via :class:`GravMagModule`. float64 by
    default; the solve runs on ``device`` (``cuda:0`` when None). After
    :meth:`CG`, ``result`` holds its ``mw`` and ``m`` as tensors on the
    device."""

    def __init__(self, dobs, mrange, mspacing, obsurface, mratio=1, njobs=1,
                 coordinate="cartesian", field="gravity", mangle=(90, 0),
                 wavelet=False, mseg=False, mdivisionsection=(),
                 dtype=torch.float64, verbose=True, device=None, **kwargs):
        self._view(_module(dobs, mrange, mspacing, obsurface, dtype, device,
                           verbose, mratio=mratio, coordinate=coordinate,
                           njobs=njobs, field=field, mangle=mangle,
                           wavelet=wavelet, mseg=mseg,
                           mdivisionsection=mdivisionsection, **kwargs))
        self.dtype = dtype
        self.device = self._mod.device
        self.dobs = np.asarray(dobs, dtype=np.float64)
        self.result = None

    def data(self, mw):
        """Plain-residual data misfit (reference: inversion/reginv.py:248)."""
        r = self.Aw @ np.asarray(mw) - self.dobs
        return float(r @ r)

    def CG(self, initialModel, apriorModel, boundary, regularization="MS",
           beta=0.01, q=0.9, maxk=100):
        """Run the inversion (reference: inversion/reginv.py:357-491).

        Returns (model_inv, data_inv, data_misfit, model_misfit,
        regul_factor), host numpy arrays, the histories trimmed to the
        performed iterations.
        """
        if regularization not in REGULARIZATIONS:
            raise ValueError(
                "Please choose regularization from 'MS','Damping', "
                "'Smoothness', 'TV'.")
        mw0 = self.wdiag * np.asarray(initialModel, dtype=np.float64)
        apr = self.wdiag * np.asarray(apriorModel, dtype=np.float64)
        solve = _make_cg_core(
            self.Aw, self.dobs, self.wdiag, self.wdiag_inv, self.mshape,
            self._mod._active3d, regularization, beta, q, maxk, boundary[0],
            boundary[1], "normalized", self.dtype, aprior_mw=apr,
            device=self.device)
        mw_fin, d_h, m_h, r_h, n_it = solve(mw0, np.ones(self.dsize))
        n_it = int(n_it)
        self.result = {"mw": mw_fin, "m": mw_fin * torch.as_tensor(
            self.wdiag_inv, dtype=self.dtype, device=mw_fin.device)}
        model_inv = self.wdiag_inv * mw_fin.cpu().numpy().astype(np.float64)
        data_inv = self.A @ model_inv

        def host(h):
            return h.cpu().numpy().astype(np.float64)[:n_it]

        return model_inv, data_inv, host(d_h), host(m_h), host(r_h)


class BootStrap(_ModuleView):
    """Bootstrap uncertainty by weighted re-inversions, the replicates of a
    batch solved together (reference: inversion/reginv.py:494-748). After
    :meth:`BSCG`, ``result["mw"]`` holds the replicates' weighted-domain
    solutions as a tensor on ``device`` (``cuda:0`` when None)."""

    def __init__(self, mrange, mspacing, obsurface, dobs, boundary,
                 samples=100, beta=0.01, maxk=100, mratio=1, njobs=1,
                 wavelet=False, dtype=torch.float64, verbose=True,
                 device=None, **kwargs):
        self._view(_module(dobs, mrange, mspacing, obsurface, dtype, device,
                           verbose, mratio=mratio, coordinate="cartesian",
                           field="gravity", njobs=njobs, wavelet=wavelet,
                           **kwargs))
        self.dtype = dtype
        self.device = self._mod.device
        self.dobs = np.asarray(dobs, dtype=np.float64)
        self.boundary = boundary
        self.samples = samples
        self.beta = beta
        self.maxk = maxk
        self.result = None

    def resample_weights(self):
        """(samples, D) row-multiplicity matrix reproducing the reference's
        seeded with-replacement draws (reference: inversion/reginv.py:727-738
        uses np.random.seed(sample); np.random.choice)."""
        weights = np.zeros((self.samples, self.dsize))
        for s in range(self.samples):
            rng = np.random.RandomState(s)
            idx = rng.choice(np.arange(self.dsize), size=self.dsize,
                             replace=True)
            weights[s] = np.bincount(idx, minlength=self.dsize)
        return weights

    def BSCG(self, initialModel, batch=None):
        """Run ``samples`` bootstrap re-inversions, ``batch`` replicates at
        a time (all by default).

        Returns (model_inv_all, data_misfit_all, model_misfit_all,
        regul_factor_all), host numpy arrays, as the JAX package: the
        histories NaN-padded after each replicate's stop, the data and
        model histories without their k = 0 entry.
        """
        mw0 = self.wdiag * np.asarray(initialModel, dtype=np.float64)
        solve = _make_cg_core(
            self.Aw, self.dobs, self.wdiag, self.wdiag_inv, self.mshape,
            None, "MS", self.beta, 0.9, self.maxk, self.boundary[0],
            self.boundary[1], "absolute", self.dtype, bootstrap_ms=True,
            device=self.device)
        weights = self.resample_weights()
        batch = batch or self.samples
        mws, d_hists, m_hists, r_hists = [], [], [], []
        for s0 in range(0, self.samples, batch):
            mw_fin, d_h, m_h, r_h, _ = solve(mw0, weights[s0: s0 + batch])
            mws.append(mw_fin)
            d_hists.append(d_h)
            m_hists.append(m_h)
            r_hists.append(r_h)
        mw_all = torch.cat(mws)
        self.result = {"mw": mw_all}

        def host(parts):
            return torch.cat(parts).cpu().numpy().astype(np.float64)

        return (host(mws) * self.wdiag_inv[None, :],
                host(d_hists)[:, 1:], host(m_hists)[:, 1:], host(r_hists))
