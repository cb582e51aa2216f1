"""Operands and float64 references of the f32-matrix GEMMs.

The f32 GEMM kernels (``residual_f32``, ``step_residual_f32`` and
``kick_f32``: six bf16 products of three pieces of each operand) are
checked and timed on the operands made here, at the two shapes of
:data:`SHAPES`: ``chip_smoke.py`` holds each kernel's error against the
float64 product of the same f32 operands beside its plain version's, and
``f32_gemm_tune.py`` sweeps and times the kernels on them.
"""
from __future__ import annotations

import numpy as np
import torch

#: (chains, observations, cells) before lane padding: realdata's
#: trajectory stage (256 chains over 625 x 10,427 tesseroids; padded 640 x
#: 10,496) and the uniformgrid problem in f32 (1024 chains, 600 x 6000;
#: padded 640 x 6016)
SHAPES = {"realdata": (256, 625, 10427), "uniformgrid": (1024, 600, 6000)}
GEMMS = ("residual_f32", "step_residual_f32", "kick_f32")


def synthetic_problem(D, M, seed=0):
    """The fused ops' arguments ``(A, dobs_centered, None, aprior, wm_sq,
    low, high)`` of a problem of D observations over M cells, made from
    ``seed`` with numpy: A's entries N(0, 1) times column scales
    log-uniform over four decades (a stand-in for a segmented tesseroid
    kernel's dynamic range, where deep cells see the data 10^4 times less
    than shallow ones), data from a model in [0, 0.5] with 1 % noise,
    bounds [0, 1] and an a priori model of 0.001."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((D, M)) * 10.0 ** rng.uniform(-4.0, 0.0, M)
    d = A @ rng.uniform(0.0, 0.5, M)
    d = d + 0.01 * np.abs(d).max() * rng.standard_normal(D)
    return (A, d - d.mean(), None, np.full(M, 0.001), np.ones(M),
            np.zeros(M), np.ones(M))


def gemm_operands(op, C, seed=0):
    """Each f32 GEMM's arguments on ``op``'s lane-padded f32 matrix and
    its pieces at C chains, made from ``seed``: x inside the box, dobs 0,
    dmask 1 and fix 0, so the residual is the bare product x A^T and the
    step residual that product less its row mean over the true rows; the
    kick with p 0, s_mod 0 and s_data -1, so it is the bare product r A.
    Returns name -> a function making fresh arguments."""
    pp = op._padded
    A, pieces = pp["A"], pp["A_split"]
    Dp, Mp = A.shape
    dev = A.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    mask = (pp["high"] > 0).float()
    x = (0.3 + 0.05 * torch.randn(C, Mp, generator=gen, device=dev)) * mask
    r = 0.1 * torch.randn(C, Dp, generator=gen, device=dev) * pp["dmask"]
    zeros, ones = torch.zeros(Dp, device=dev), torch.ones(Dp, device=dev)

    def empty(*shape):
        return torch.empty(*shape, device=dev)

    return {
        "residual_f32": lambda: (x, A, zeros, ones, empty(C, Dp), pieces),
        "step_residual_f32": lambda: (x, A, zeros, zeros, pp["dmask"],
                                      op.inv_nobs, empty(C, Dp), empty(C),
                                      pieces),
        "kick_f32": lambda: (r, A, x, torch.zeros(C, Mp, device=dev),
                             pp["aprior"], pp["gm_scale"], -1.0, 0.0,
                             op.beta, True, pieces),
    }


def product_out(name, a):
    """The output of GEMM ``name`` that holds its product, in its
    arguments ``a``: r (residual, step residual) or p (kick)."""
    return a[{"residual_f32": 4, "step_residual_f32": 6, "kick_f32": 3}[name]]


def f64_reference(name, a):
    """That output from the float64 product of the same f32 operands
    (with :func:`gemm_operands`' dobs, dmask, fix, p and scales), on
    arguments no kernel has run on (the kick updates p in place)."""
    if name == "kick_f32":
        r, A, x, p, aprior, gm_scale, s_data, s_mod, beta, ms = a[:10]
        dm = x.double() - aprior.double()
        gm = gm_scale.double() * dm / (dm * dm + beta) ** 2 if ms else dm
        return (p.double() - s_data * (r.double() @ A.double())
                - s_mod * gm)
    x, A = a[0].double(), a[1].double()
    d = x @ A.T
    if name == "residual_f32":
        return (d - a[2].double()) * a[3].double()
    fix, dobs, dmask, inv_nobs = (a[2].double(), a[3].double(),
                                  a[4].double(), a[5])
    d = d + fix
    return ((d - d.sum(1, keepdim=True) * inv_nobs) - dobs) * dmask


def rel_to_f64(name, a, ref):
    """max |output - ref| over max |ref|, the output of ``name`` in its
    arguments ``a`` after a run and ``ref`` its :func:`f64_reference`."""
    err = (product_out(name, a).double() - ref).abs().max().item()
    return err / max(ref.abs().max().item(), 1e-30)


def library_fn(name, a):
    """One ``torch.matmul`` of the same product (TF32 off): the yardstick
    of a GEMM kernel, used nowhere in the port."""
    if name == "kick_f32":
        r, A = a[0], a[1]
        return lambda: torch.matmul(r, A)
    x, At = a[0], a[1].T
    return lambda: torch.matmul(x, At)
