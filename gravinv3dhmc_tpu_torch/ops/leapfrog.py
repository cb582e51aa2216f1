"""Fused HMC leapfrog: the trajectory, the whole iteration and the single
step, on the GPU.

Counterpart of ``gravinv3dhmc_tpu/ops/leapfrog_pallas.py``'s
``make_fused_trajectory`` (``_traj_kernel``), ``make_fused_iteration``
(``_iter_kernel``) and ``make_fused_step`` (``_step_kernel``), with the
same arguments and return order. The work is split into CUDA kernels
(``csrc/leapfrog.cu``, whose header says why and what bounds each):
``refresh``, ``drift``, ``residual``, ``kick``, ``traj_finish`` and
``accept`` for the trajectory and iteration; the step reuses ``drift`` and
``kick`` and adds ``step_residual`` and ``step_misfit``. The three GEMMs
have a kernel for each matrix type: with an f32 matrix the op launches
``residual_f32``, ``kick_f32`` and ``step_residual_f32``
(:data:`F32_GEMMS`), which compute the f32 product on the tensor cores
from three bf16 pieces of each operand (:func:`split_f32`). Every fused
sampler path opens an iteration with one ``refresh`` launch and closes it
with one ``accept`` launch (:meth:`_FusedLeapfrog.open_iteration`,
:meth:`~_FusedLeapfrog.close_iteration`); ``draws`` gives the eager
shared-L sampler the momentum normals and accept uniforms that those two
draw. Each has a plain
PyTorch version in this module and a wrapper (:class:`~._cuda.Kernel`)
that launches the CUDA kernel for a CUDA tensor, counts the launch, and
takes the plain version only for a CPU tensor. There is no fallback: a
CUDA tensor gets the kernel or an error.

Host preparation is the JAX package's. For the trajectory and iteration
the mean-centred matrix ``A_c = A - mean_rows(A)`` is formed in f64 before
the cast, and ``dobs' = dobs_c - (fix - mean fix)``; then the per-step
residual needs no mean removal and ``A_c^T r == A^T r``. The step keeps
the uncentred A, ``fix`` and ``dobs_c`` and removes the row mean of
``d = x A^T + fix`` over the true observation count in its residual.
Rows and columns are padded to multiples of 128 with neutral values (zero
matrix and data rows, dmask 0, fix 0, low = high = 0, im = 1, pscale = 0),
so pads stay exactly zero.

The trajectory length L is a host integer, so the L-step loop issues its
launches with no device-to-host synchronisation.

The builders put the op on ``cuda:0`` unless a device is given
(``device="cpu"`` runs the plain versions).
"""
from __future__ import annotations

import ctypes
from fractions import Fraction
from functools import partial

import numpy as np
import torch
from torch import nn

from .. import _device
from . import _cuda, philox
from ._cuda import (  # noqa: F401  (re-exported)
    KERNELS, Kernel, launch_counts, reset_launch_counts)

LANE = 128
_F32 = torch.float32
_TRAJ_TPU = "gravinv3dhmc_tpu/ops/leapfrog_pallas.py:146"
_ITER_TPU = "gravinv3dhmc_tpu/ops/leapfrog_pallas.py:421"
_STEP_TPU = "gravinv3dhmc_tpu/ops/leapfrog_pallas.py:87"
#: the on-chip PRNG of _iter_kernel (pltpu.prng_seed)
_PRNG_TPU = "gravinv3dhmc_tpu/ops/leapfrog_pallas.py:480"


def _round_up(x, m):
    return (x + m - 1) // m * m


def _f32(v):
    """A scalar rounded to float32, as the TPU kernels hold eps and alpha."""
    return float(np.float32(v.item() if torch.is_tensor(v) else v))


#: the C entries' matrix operand: a bf16 matrix, or the three bf16 pieces
#: of an f32 one (``csrc/leapfrog.cu``'s a_mode)
A_BF16, A_F32_SPLIT = 1, 2


def split_f32(A):
    """An f32 matrix as its three bf16 pieces, ``(3, *A.shape)``: a0 =
    bf16(a), a1 = bf16(a - a0), a2 = bf16(a - a0 - a1), each rounded to
    nearest even. Each difference is exact in f32, so the pieces carry the
    24 bits of a (a0 + a1 + a2 is a to within 2^-24 of |a|); the f32
    GEMM kernels multiply them by the same pieces of x or r, six bf16
    products (the split the kernels apply to x and r in registers)."""
    if A.dtype != _F32:
        raise TypeError(f"split_f32 takes a float32 matrix, got {A.dtype}")
    pieces, rest = [], A
    for _ in range(3):
        piece = rest.to(torch.bfloat16)
        pieces.append(piece)
        rest = rest - piece.to(_F32)
    return torch.stack(pieces)


def _mv(t, A):
    """The matvec operand rounded to A's storage type, widened to f32."""
    return t if A.dtype == _F32 else t.to(A.dtype).to(_F32)


# ---------------------------------------------------------- plain versions

def refresh_plain(g, U, pscale, im, half_eps, salt, iteration, n01, p, pk,
                  H0):
    """p0 = pscale*n01 (Philox normals unless ``n01`` is given),
    H0 = K0 + U, p = p0 - eps/2 g and, unless ``pk`` is None (the per-step
    path's p-only form), pk = p."""
    if n01 is None:
        n01 = philox.momentum_normals(salt, iteration, g.shape[0],
                                      g.shape[1], g.device)
    p0 = pscale * n01
    H0.copy_(0.5 * (im * p0 * p0).sum(1) + U)
    pv = p0 - half_eps * g
    p.copy_(pv)
    if pk is not None:
        pk.copy_(pv)


def draws_plain(n01, u, salt, iteration, c0=0, j0=0):
    """One iteration's Philox draws into ``n01`` (C, width), the momentum
    normals, and ``u`` (C,), the accept uniforms: for chains c0 .. c0 + C
    - 1 and elements 4 j0 .. 4 j0 + width - 1, the block of the whole
    batch's draws that a shard of a (chains, model) mesh holds."""
    C, width = n01.shape
    n01.copy_(philox.momentum_normals(salt, iteration, C, width, n01.device,
                                      c0, j0))
    u.copy_(philox.accept_uniforms(salt, iteration, C, u.device, c0))


def drift_plain(x, p, pk, im, low, high, eps):
    """x += eps*im*p, clip to [low, high], negate p where the clip moved
    x; pk (if given) receives the new p."""
    xn = x + eps * (im * p)
    xc = torch.minimum(torch.maximum(xn, low), high)
    p.copy_(torch.where(xn != xc, -p, p))
    x.copy_(xc)
    if pk is not None:
        pk.copy_(p)


def residual_plain(x, A, dobs, dmask, r, A_split=None):
    """r = (x A^T - dobs) * dmask with x rounded to A's type. ``A_split``
    (an f32 matrix's :func:`split_f32` pieces, which its kernel reads) is
    not used: the plain version multiplies by A."""
    r.copy_((_mv(x, A) @ A.to(_F32).T - dobs) * dmask)


def kick_plain(r, A, x, p, aprior, gm_scale, s_data, s_mod, beta, ms,
               A_split=None):
    """p -= s_data (r A) + s_mod gm(x) with r rounded to A's type
    (``A_split`` as in :func:`residual_plain`)."""
    gdata = _mv(r, A) @ A.to(_F32)
    dm = x - aprior
    if ms:
        inv = 1.0 / (dm * dm + beta)
        gm = gm_scale * dm * (inv * inv)
    else:
        gm = dm
    p.copy_(p - s_data * gdata - s_mod * gm)


def step_residual_plain(x, A, fix, dobs, dmask, inv_nobs, r, ud,
                        A_split=None):
    """d = x A^T + fix with x rounded to A's type; r = ((d - mean d) -
    dobs) * dmask with the mean over the true n_obs (``inv_nobs``);
    ud = sum r^2 (``A_split`` as in :func:`residual_plain`)."""
    d = _mv(x, A) @ A.to(_F32).T + fix
    rv = ((d - d.sum(1, keepdim=True) * inv_nobs) - dobs) * dmask
    r.copy_(rv)
    ud.copy_((rv * rv).sum(1))


def step_misfit_plain(x, aprior, wmsq, ud, U, um, alpha, beta, ms):
    """um of x (MS or Damping) and U = ud + alpha um."""
    dm = x - aprior
    dm2 = dm * dm
    umv = (wmsq * dm2 / (dm2 + beta)).sum(1) if ms else dm2.sum(1)
    um.copy_(umv)
    U.copy_(ud + alpha * umv)


def traj_finish_plain(x, p, pk, r, g, U, ud, um, aprior, wmsq, inv_eps,
                      alpha, beta, ms):
    """g = (pk - p)/eps (``g`` may be ``pk``), p <- (pk + p)/2 and the
    misfit values of the final state."""
    gv = (pk - p) * inv_eps
    ph = 0.5 * (pk + p)
    dm = x - aprior
    dm2 = dm * dm
    umv = (wmsq * dm2 / (dm2 + beta)).sum(1) if ms else dm2.sum(1)
    udv = (r * r).sum(1)
    g.copy_(gv)
    p.copy_(ph)
    ud.copy_(udv)
    um.copy_(umv)
    U.copy_(udv + alpha * umv)


def accept_plain(x, g, U, ud, um, p, H0, x_in, g_in, U_in, ud_in, um_in, im,
                 salt, iteration, u, acc):
    """Metropolis test of H1 = K(p) + U against H0 (a Philox uniform unless
    ``u`` is given); rejected chains take back x_in, g_in, U_in, ud_in,
    um_in. A NaN Hamiltonian rejects."""
    if u is None:
        u = philox.accept_uniforms(salt, iteration, x.shape[0], x.device)
    H1 = 0.5 * (im * p * p).sum(1) + U
    a = (H1 < H0) | (u < torch.exp(-(H1 - H0)))
    x.copy_(torch.where(a[:, None], x, x_in))
    g.copy_(torch.where(a[:, None], g, g_in))
    U.copy_(torch.where(a, U, U_in))
    ud.copy_(torch.where(a, ud, ud_in))
    um.copy_(torch.where(a, um, um_in))
    acc.copy_(a.to(_F32))


# ------------------------------------------------------------ CUDA launches

def _salt_words(salt, iteration):
    return (int(salt[0]) & philox.MASK32, int(salt[1]) & philox.MASK32,
            int(iteration) & philox.MASK32)


def _a_mode(A):
    """The matrix mode of A's type: A_BF16, or A_F32_SPLIT for float32."""
    if A.dtype not in (_F32, torch.bfloat16):
        raise TypeError(f"kernel matrix must be float32 or bfloat16, got "
                        f"{A.dtype}")
    return A_BF16 if A.dtype == torch.bfloat16 else A_F32_SPLIT


def _matrix(mode, A, A_split):
    """The C entries' matrix pointer for a kernel of ``mode``: a bf16 A
    itself, or an f32 A's (3, Dp, Mp) bf16 pieces. A matrix of the other
    type raises: its type picks the kernel."""
    if _a_mode(A) != mode:
        raise TypeError(f"this kernel takes a "
                        f"{'bfloat16' if mode == A_BF16 else 'float32'} "
                        f"matrix, got {A.dtype}")
    if mode == A_BF16:
        return _cuda.ptr(A, torch.bfloat16, A.shape)
    if A_split is None:
        raise ValueError("the f32 GEMM kernels read the matrix's bf16 "
                         "pieces: pass split_f32(A)")
    return _cuda.ptr(A_split, torch.bfloat16, (3, *A.shape))


def _refresh_cuda(g, U, pscale, im, half_eps, salt, iteration, n01, p, pk,
                  H0):
    C, Mp = g.shape
    P = _cuda.ptr
    _cuda.library().call(
        "lf_refresh", P(g, _F32, (C, Mp)), P(U, _F32, (C,)),
        P(pscale, _F32, (Mp,)), P(im, _F32, (Mp,)),
        P(n01, _F32, (C, Mp)), P(p, _F32, (C, Mp)), P(pk, _F32, (C, Mp)),
        P(H0, _F32, (C,)), C, Mp, half_eps, *_salt_words(salt, iteration),
        _cuda.stream(g))


def _draws_cuda(n01, u, salt, iteration, c0=0, j0=0):
    C, width = n01.shape
    P = _cuda.ptr
    _cuda.library().call(
        "lf_draws", P(n01, _F32, (C, width)), P(u, _F32, (C,)), C, width,
        int(c0), int(j0), *_salt_words(salt, iteration), _cuda.stream(n01))


def _drift_cuda(x, p, pk, im, low, high, eps):
    C, Mp = x.shape
    P = _cuda.ptr
    _cuda.library().call(
        "lf_drift", P(x, _F32, (C, Mp)), P(p, _F32, (C, Mp)),
        P(pk, _F32, (C, Mp)), P(im, _F32, (Mp,)), P(low, _F32, (Mp,)),
        P(high, _F32, (Mp,)), C, Mp, eps, _cuda.stream(x))


_OCCUPANCY = {}
_PLANS = {}
MAX_SPLITS = 8


def split_plan(C, Dp, Mp, tile_m, tile_n, k_stage, resident_blocks,
               max_splits=MAX_SPLITS):
    """How a split-K GEMM of (C x Mp) by (Dp x Mp)^T cuts K, given its
    block tile (``tile_m`` chains x ``tile_n`` observations), the K depth
    of one stage and how many blocks the card holds at once.

    The split count s in 1..min(``max_splits``, stages) is the one whose
    tiles * s blocks fill the largest share of their last wave of
    ``resident_blocks`` (the fewest splits on a tie). Slice z covers the
    stages [z n // s, (z + 1) n // s) of the n = Mp / k_stage, as the
    kernels cut it: whole stages, none empty, together all of K. Returns
    the split count, the slices as (k_begin, k_end), the block count and
    the waves they take."""
    if Dp % tile_n or Mp % k_stage:
        raise ValueError(f"Dp = {Dp} must be a multiple of {tile_n} and "
                         f"Mp = {Mp} of {k_stage}")
    resident = max(int(resident_blocks), 1)
    stages = Mp // k_stage
    tiles = (Dp // tile_n) * (-(-C // tile_m))

    def fill(s):
        n = tiles * s
        return Fraction(n, -(-n // resident) * resident)

    splits = max(range(1, min(max_splits, stages) + 1),
                 key=lambda s: (fill(s), -s))
    slices = [(z * stages // splits * k_stage,
               (z + 1) * stages // splits * k_stage) for z in range(splits)]
    return {"tile": [tile_m, tile_n, k_stage], "splits": splits,
            "slices": slices, "blocks": tiles * splits,
            "waves": tiles * splits / resident}


def f32_max_splits(tiles, resident):
    """The split cap of the f32-matrix residual: its six products make a
    slice stage six times the bf16 one's work, so when the output has few
    tiles (realdata's 256 chains: 10) K is cut into as many slices as one
    wave holds, past :data:`MAX_SPLITS`; with many tiles (uniformgrid's
    1024 chains: 40) the bf16 cap stands."""
    return max(MAX_SPLITS, resident // max(tiles, 1))


def residual_plan(C, Dp, Mp, a_mode):
    """How the split residual GEMM (csrc/leapfrog.cu) of the matrix mode
    (``A_BF16`` or ``A_F32_SPLIT``) cuts K for this shape:
    :func:`split_plan` with the kernel's tile and the resident blocks from
    the runtime's occupancy query. Both tensor-core GEMMs take 128 x 128
    tiles (of 64-deep stages, 32-deep for the f32 matrix) and one block
    per SM, so at the uniformgrid
    shape (8 x 5 tiles) on 132 SMs that is 3 slices, 120 blocks; at
    ratiogrid's (8 x 8) 2 slices, 128 blocks; the f32 GEMM at realdata's
    256 x 640 x 10,496 (2 x 5 tiles) 13 slices, 130 blocks
    (:func:`f32_max_splits`). One ``residual`` or ``step_residual`` call
    launches two kernels, the split GEMM and the fixed-order reduce of its
    slices; its launch count covers the pair."""
    key = (C, Dp, Mp, a_mode)
    if key not in _PLANS:
        if a_mode not in _OCCUPANCY:
            out = (ctypes.c_int * 5)()
            _cuda.library().call("lf_residual_occupancy", a_mode,
                                 ctypes.addressof(out))
            _OCCUPANCY[a_mode] = tuple(out)
        per_sm, sms, tile_m, tile_n, k_stage = _OCCUPANCY[a_mode]
        resident = per_sm * sms
        cap = (MAX_SPLITS if a_mode == A_BF16 else f32_max_splits(
            (Dp // tile_n) * -(-C // tile_m), resident))
        _PLANS[key] = {**split_plan(C, Dp, Mp, tile_m, tile_n, k_stage,
                                    resident, cap),
                       "blocks_per_sm": per_sm, "sms": sms}
    return _PLANS[key]


def kick_plan(C, Dp, Mp, a_mode=A_BF16):
    """How the tensor-core kick (csrc/leapfrog.cu) of the matrix mode
    covers this shape: one block per tile of chains x 128 columns of the
    (C x Mp) output, each over all Dp / 64 stages of K (:func:`split_plan`
    with the roles of Dp and Mp swapped and one split), with the tile and
    the resident blocks from the runtime's occupancy query."""
    key = ("kick", C, Dp, Mp, a_mode)
    occ = "kick" if a_mode == A_BF16 else ("kick", a_mode)
    if key not in _PLANS:
        if occ not in _OCCUPANCY:
            out = (ctypes.c_int * 5)()
            _cuda.library().call("lf_kick_occupancy", a_mode,
                                 ctypes.addressof(out))
            _OCCUPANCY[occ] = tuple(out)
        per_sm, sms, tile_m, tile_n, k_stage = _OCCUPANCY[occ]
        _PLANS[key] = {**split_plan(C, Mp, Dp, tile_m, tile_n, k_stage,
                                    per_sm * sms, max_splits=1),
                       "blocks_per_sm": per_sm, "sms": sms}
    return _PLANS[key]


def _residual_cuda(mode, x, A, dobs, dmask, r, A_split=None):
    C, Mp = x.shape
    Dp = A.shape[0]
    P = _cuda.ptr
    a = _matrix(mode, A, A_split)
    splits = residual_plan(C, Dp, Mp, mode)["splits"]
    part = torch.empty((splits, C, Dp), dtype=_F32, device=x.device)
    _cuda.library().call(
        "lf_residual", P(x, _F32, (C, Mp)), a, mode, P(dobs, _F32, (Dp,)),
        P(dmask, _F32, (Dp,)), P(r, _F32, (C, Dp)), P(part, _F32), splits,
        C, Dp, Mp, _cuda.stream(x))


def _step_residual_cuda(mode, x, A, fix, dobs, dmask, inv_nobs, r, ud,
                        A_split=None):
    C, Mp = x.shape
    Dp = A.shape[0]
    P = _cuda.ptr
    a = _matrix(mode, A, A_split)
    splits = residual_plan(C, Dp, Mp, mode)["splits"]
    part = torch.empty((splits, C, Dp), dtype=_F32, device=x.device)
    _cuda.library().call(
        "lf_step_residual", P(x, _F32, (C, Mp)), a, mode,
        P(fix, _F32, (Dp,)), P(dobs, _F32, (Dp,)), P(dmask, _F32, (Dp,)),
        P(r, _F32, (C, Dp)), P(ud, _F32, (C,)), P(part, _F32), splits, C,
        Dp, Mp, inv_nobs, _cuda.stream(x))


def _step_misfit_cuda(x, aprior, wmsq, ud, U, um, alpha, beta, ms):
    C, Mp = x.shape
    P = _cuda.ptr
    v = (C,)
    _cuda.library().call(
        "lf_step_misfit", P(x, _F32, (C, Mp)), P(aprior, _F32, (Mp,)),
        P(wmsq, _F32, (Mp,)), P(ud, _F32, v), P(U, _F32, v), P(um, _F32, v),
        C, Mp, alpha, beta, int(ms), _cuda.stream(x))


def _kick_cuda(mode, r, A, x, p, aprior, gm_scale, s_data, s_mod, beta, ms,
               A_split=None):
    C, Dp = r.shape
    Mp = A.shape[1]
    P = _cuda.ptr
    _cuda.library().call(
        "lf_kick", P(r, _F32, (C, Dp)), _matrix(mode, A, A_split), mode,
        P(x, _F32, (C, Mp)), P(p, _F32, (C, Mp)), P(aprior, _F32, (Mp,)),
        P(gm_scale, _F32, (Mp,)), C, Dp, Mp, s_data, s_mod, beta, int(ms),
        _cuda.stream(r))


def _traj_finish_cuda(x, p, pk, r, g, U, ud, um, aprior, wmsq, inv_eps,
                      alpha, beta, ms):
    C, Mp = x.shape
    Dp = r.shape[1]
    P = _cuda.ptr
    _cuda.library().call(
        "lf_traj_finish", P(x, _F32, (C, Mp)), P(p, _F32, (C, Mp)),
        P(pk, _F32, (C, Mp)), P(r, _F32, (C, Dp)), P(g, _F32, (C, Mp)),
        P(U, _F32, (C,)), P(ud, _F32, (C,)), P(um, _F32, (C,)),
        P(aprior, _F32, (Mp,)), P(wmsq, _F32, (Mp,)), C, Dp, Mp, inv_eps,
        alpha, beta, int(ms), _cuda.stream(x))


def _accept_cuda(x, g, U, ud, um, p, H0, x_in, g_in, U_in, ud_in, um_in, im,
                 salt, iteration, u, acc):
    C, Mp = x.shape
    P = _cuda.ptr
    m, v = (C, Mp), (C,)
    _cuda.library().call(
        "lf_accept", P(x, _F32, m), P(g, _F32, m), P(U, _F32, v),
        P(ud, _F32, v), P(um, _F32, v), P(p, _F32, m), P(H0, _F32, v),
        P(x_in, _F32, m), P(g_in, _F32, m), P(U_in, _F32, v),
        P(ud_in, _F32, v), P(um_in, _F32, v), P(im, _F32, (Mp,)),
        P(u, _F32, v), P(acc, _F32, v), C, Mp,
        *_salt_words(salt, iteration), _cuda.stream(x))


def philox_bits_cuda(salt, iteration, n_chains, width, device):
    """Raw Philox words of the momentum stream drawn by the CUDA kernel,
    as an int64 tensor like :func:`philox.momentum_bits`."""
    out = torch.empty((n_chains, width), dtype=torch.int32, device=device)
    _cuda.library().call(
        "lf_philox_bits", _cuda.ptr(out, torch.int32), n_chains, width,
        *_salt_words(salt, iteration), _cuda.stream(out))
    return out.to(torch.int64) & philox.MASK32


def draw_units_cuda(salt, iteration, j0, j1, c, device):
    """Momentum normals 4 j0 .. 4 j1 - 1 of chain ``c`` and its accept
    uniform, from one-thread kernels running only ``momentum4`` (one
    counter a pass of a loop) and ``accept_uniform``: the code
    :mod:`..sass` counts to bound ``draws`` and ``refresh``. (4 (j1 -
    j0),) and (1,) f32 tensors."""
    n, u = (torch.empty(k, device=device) for k in (4 * j1, 1))
    jn = torch.tensor([j0, j1], dtype=torch.int32, device=device)
    _cuda.library().call(
        "lf_draw_units", _cuda.ptr(n, _F32), _cuda.ptr(u, _F32),
        _cuda.ptr(jn, torch.int32), c, *_salt_words(salt, iteration),
        _cuda.stream(n))
    return n[4 * j0:], u


#: the kernels each op launches with a bf16 matrix: the iteration (the
#: trajectory is its middle four) and the step, which reuses ``drift`` and
#: ``kick``; a sampler that calls the step opens and closes each iteration
#: with ``refresh`` and ``accept``, the eager shared-L sampler draws with
#: ``draws``
ITERATION_KERNELS = ("refresh", "drift", "residual", "kick", "traj_finish",
                     "accept")
STEP_KERNELS = ("drift", "step_residual", "kick", "step_misfit")
#: each GEMM's kernel for an f32 matrix (the same plain version)
F32_GEMMS = {"residual": "residual_f32", "kick": "kick_f32",
             "step_residual": "step_residual_f32"}


def path_kernels(names, matvec_dtype):
    """``names`` (such as :data:`ITERATION_KERNELS`) as an op with a
    ``matvec_dtype`` matrix launches them: the GEMMs of an f32 matrix are
    :data:`F32_GEMMS`'s."""
    if matvec_dtype == _F32:
        return tuple(F32_GEMMS.get(n, n) for n in names)
    return tuple(names)


_cuda.register(*(Kernel(name, plain, launch, replaces, "leapfrog")
                 for name, plain, launch, replaces in (
    ("refresh", refresh_plain, _refresh_cuda, _ITER_TPU),
    ("drift", drift_plain, _drift_cuda, _TRAJ_TPU),
    ("residual", residual_plain, partial(_residual_cuda, A_BF16),
     _TRAJ_TPU),
    ("kick", kick_plain, partial(_kick_cuda, A_BF16), _TRAJ_TPU),
    ("traj_finish", traj_finish_plain, _traj_finish_cuda, _TRAJ_TPU),
    ("accept", accept_plain, _accept_cuda, _ITER_TPU),
    ("step_residual", step_residual_plain,
     partial(_step_residual_cuda, A_BF16), _STEP_TPU),
    ("step_misfit", step_misfit_plain, _step_misfit_cuda, _STEP_TPU),
    ("draws", draws_plain, _draws_cuda, _PRNG_TPU),
    ("residual_f32", residual_plain, partial(_residual_cuda, A_F32_SPLIT),
     _TRAJ_TPU),
    ("kick_f32", kick_plain, partial(_kick_cuda, A_F32_SPLIT), _TRAJ_TPU),
    ("step_residual_f32", step_residual_plain,
     partial(_step_residual_cuda, A_F32_SPLIT), _STEP_TPU))))


# -------------------------------------------------------- the fused ops

def _pad_rows(t, width, value=0.0):
    """(C, n) -> contiguous float32 (C, width), pads set to ``value``."""
    t = t.to(_F32)
    out = torch.full((t.shape[0], width), value, dtype=_F32, device=t.device)
    out[:, :t.shape[1]] = t
    return out


def _fresh(t, width):
    """A new contiguous float32 (C, width) copy of ``t``, zero-padded."""
    if t.shape[1] != width:
        return _pad_rows(t, width)
    out = torch.empty((t.shape[0], width), dtype=_F32, device=t.device)
    out.copy_(t)
    return out


def _pad_vec(v, width, value=0.0):
    v = v.to(_F32).reshape(-1)
    out = torch.full((width,), value, dtype=_F32, device=v.device)
    out[:v.shape[0]] = v
    return out


def params_from_jax(np_params, device=None):
    """The port's params from a JAX ``traj.params`` / ``it.params`` /
    ``step.params`` dict (values as numpy arrays, lane-padded to (Dp,
    Mp)), on ``device`` (``cuda:0`` when None).

    The pads are sliced off: the true row count comes from ``dmask``, the
    true column count from ``mmask`` when present (iteration params) and
    otherwise from the last non-zero column of the matrix (its pad
    columns are exactly zero). The step's transposed copy ``At`` is not
    needed: both GEMMs read the one A.
    """
    device = _device.resolve(device)

    def vec(name, n):
        a = np.array(np_params[name], np.float32).reshape(-1)[:n]
        return torch.as_tensor(a, device=device)

    A = np.asarray(np_params["A"])
    A32 = np.asarray(A, np.float32)
    D = int(np.asarray(np_params["dmask"], np.float32).sum())
    if "mmask" in np_params:
        M = int(np.asarray(np_params["mmask"], np.float32).sum())
    else:
        M = int(np.flatnonzero(np.any(A32 != 0, axis=0)).max()) + 1
    a_dtype = torch.bfloat16 if A.dtype.name == "bfloat16" else _F32
    out = {"A": torch.as_tensor(A32[:D, :M].copy(), device=device).to(a_dtype),
           "dobs": vec("dobs", D)}
    if "fix" in np_params:
        out["fix"] = vec("fix", D)
    for name in ("aprior", "wmsq", "low", "high", "im", "pscale"):
        if name in np_params:
            out[name] = vec(name, M)
    return out


def _kick_scales(eps, alpha, ms):
    """(s_data, s_mod) of the kick epilogue p -= s_data gdata + s_mod gm:
    2 eps for the data term, eps alpha (MS, whose gm carries its factor)
    or 2 eps alpha (Damping, gm = dm), in f32."""
    e = np.float32(eps)
    return (float(np.float32(2.0) * e),
            float(e * np.float32(alpha) * np.float32(1.0 if ms else 2.0)))


class _FusedLeapfrog(nn.Module):
    """Host preparation and the L-step loop shared by the fused ops.

    ``centred`` (trajectory, iteration) mean-centres A and folds ``fix``
    into dobs; otherwise (the step) A stays uncentred with ``fix`` and
    ``dobs_centered`` kept apart, as the JAX builders prepare them."""

    def __init__(self, A, dobs_centered, grav_fix, aprior, wm_sq, low, high,
                 *, regularization, beta, matvec_dtype, Sigma, device,
                 centred=True):
        super().__init__()
        if regularization not in ("MS", "Damping"):
            raise ValueError("fused leapfrog supports MS/Damping only")
        if matvec_dtype not in (_F32, torch.bfloat16):
            raise ValueError("matvec_dtype must be float32 or bfloat16")
        self.regularization = regularization
        self.beta = float(beta)
        self.device = _device.resolve(device)
        #: the registry names of the GEMMs this op's matrix type launches
        self.gemms = (F32_GEMMS if matvec_dtype == _F32
                      else {name: name for name in F32_GEMMS})
        D, M = np.shape(A)
        self.D, self.M = D, M
        self.Dp, self.Mp = _round_up(D, LANE), _round_up(M, LANE)
        #: 1 / n_obs in f32: the step's mean is over the true rows
        self.inv_nobs = float(np.float32(1.0 / D))
        fix = (np.asarray(grav_fix, np.float64) if grav_fix is not None
               else np.zeros(D))

        def vec(v):
            return torch.as_tensor(np.asarray(v, np.float32).reshape(-1),
                                   device=self.device)

        if centred:
            A64 = np.asarray(A, np.float64)
            A_dev = (A64 - A64.mean(axis=0)).astype(np.float32)
            data = {"dobs": vec(np.asarray(dobs_centered, np.float64)
                                - (fix - fix.mean())),
                    "pscale": torch.full((M,), _f32(Sigma), dtype=_F32,
                                         device=self.device)}
        else:
            A_dev = np.asarray(A, np.float32)
            data = {"dobs": vec(dobs_centered), "fix": vec(fix)}
        self.params = {
            "A": torch.as_tensor(A_dev, device=self.device).to(matvec_dtype),
            **data, "aprior": vec(aprior),
            "wmsq": vec(wm_sq), "low": vec(low), "high": vec(high),
            "im": torch.ones(M, dtype=_F32, device=self.device),
        }
        self._padded = self._pad_params(self.params)
        self._pscales = {}
        self._metric = None
        if self.device.type == "cuda":
            # build (or load) the kernels now: set-up, not sampling time
            _cuda.library()

    def _pad_params(self, prm):
        Dp, Mp = self.Dp, self.Mp
        A = prm["A"]
        Ap = torch.zeros((Dp, Mp), dtype=A.dtype, device=A.device)
        Ap[:A.shape[0], :A.shape[1]] = A
        dmask = torch.zeros(Dp, dtype=_F32, device=A.device)
        dmask[:A.shape[0]] = 1.0
        out = {"A": Ap, "dmask": dmask, "dobs": _pad_vec(prm["dobs"], Dp),
               "im": _pad_vec(prm["im"], Mp, 1.0),
               # the pieces an f32 matrix's GEMM kernels read, split once
               "A_split": split_f32(Ap) if Ap.dtype == _F32 else None}
        if "fix" in prm:
            out["fix"] = _pad_vec(prm["fix"], Dp)
        for name in ("aprior", "wmsq", "low", "high", "pscale"):
            if name in prm:
                out[name] = _pad_vec(prm[name], Mp)
        out["gm_scale"] = out["wmsq"] * (2.0 * self.beta)
        return out

    def resolve_params(self, params=None, inv_mass=None, Sigma=None):
        """The lane-padded params the kernels read: the op's own (or
        ``params``), with ``im`` and ``pscale = 1/sqrt(im)`` from a diagonal
        ``inv_mass``, else with ``pscale = Sigma`` when it is given (a
        sampler's identity-metric momentum scale)."""
        pp = (self._padded if params is None or params is self.params
              else self._pad_params(params))
        if inv_mass is not None:
            # one padded (im, pscale) pair per metric: a sampler passes the
            # same tensor every iteration of a chunk
            cached = self._metric
            if cached is not None and cached[0] is inv_mass \
                    and cached[1] is pp:
                return cached[2]
            im = torch.as_tensor(inv_mass, dtype=_F32, device=self.device)
            out = dict(pp, im=_pad_vec(im, self.Mp, 1.0),
                       pscale=_pad_vec(1.0 / torch.sqrt(im), self.Mp))
            self._metric = (inv_mass, pp, out)
            return out
        elif Sigma is not None:
            s = _f32(Sigma)
            if s not in self._pscales:
                self._pscales[s] = _pad_vec(
                    torch.full((self.M,), s, dtype=_F32, device=self.device),
                    self.Mp)
            pp = dict(pp, pscale=self._pscales[s])
        return pp

    def _width(self, x):
        """The state's width: M cells, or Mp when the caller keeps its
        state lane-padded (pads zero) across calls."""
        n = x.shape[1]
        if n not in (self.M, self.Mp):
            raise ValueError(f"expected {self.M} cells (or {self.Mp} "
                             f"lane-padded), got {n}")
        return n

    def _kernels(self, plain):
        return ({n: k.plain for n, k in KERNELS.items()} if plain
                else KERNELS)

    def _trajectory(self, k, pp, x, p, pk, L, eps, alpha, g, U, ud, um):
        """L leapfrog steps on padded (x, p) with the leading half kick
        already in p, then the gradient recovery and trailing half kick
        into (g, p) and the misfit values into (U, ud, um)."""
        ms = self.regularization == "MS"
        e = np.float32(eps)
        s_data, s_mod = _kick_scales(e, alpha, ms)
        r = torch.zeros((x.shape[0], self.Dp), dtype=_F32, device=x.device)
        L = int(L)
        residual, kick = k[self.gemms["residual"]], k[self.gemms["kick"]]
        for step in range(L):
            k["drift"](x, p, pk if step == L - 1 else None, pp["im"],
                       pp["low"], pp["high"], float(e))
            residual(x, pp["A"], pp["dobs"], pp["dmask"], r, pp["A_split"])
            kick(r, pp["A"], x, p, pp["aprior"], pp["gm_scale"], s_data,
                 s_mod, self.beta, ms, pp["A_split"])
        k["traj_finish"](x, p, pk, r, g, U, ud, um, pp["aprior"], pp["wmsq"],
                         float(np.float32(1.0) / e), float(alpha), self.beta,
                         ms)

    def open_iteration(self, pp, g, U, seed, eps, n01=None, pk=None,
                       plain=False):
        """One ``refresh`` launch from the carried lane-padded g and (C,)
        U: ``(p, H0)`` with p = pscale n01 - eps/2 g (the leading half
        kick, Philox normals keyed by ``seed = (salt, iteration)`` unless
        ``n01`` (C, M) is given) and H0 = K0 + U. ``pk``, when given,
        receives a copy of p."""
        salt, iteration = seed
        p = torch.empty_like(g)
        H0 = torch.empty(g.shape[0], dtype=_F32, device=g.device)
        self._kernels(plain)["refresh"](
            g, U, pp["pscale"], pp["im"],
            float(np.float32(0.5) * np.float32(_f32(eps))), salt, iteration,
            None if n01 is None else _pad_rows(n01, self.Mp), p, pk, H0)
        return p, H0

    def close_iteration(self, pp, proposal, p, H0, carried, seed, u=None,
                        plain=False):
        """One ``accept`` launch: the Metropolis test of H1 = K(p) + U1
        against H0 (the Philox uniform keyed by ``seed`` unless ``u`` is
        given). ``proposal = (x1, g1, U1, ud1, um1)`` is updated in place:
        a rejected chain gets ``carried = (x, g, U, ud, um)`` back bit for
        bit (a NaN Hamiltonian rejects). Returns the (C,) 0/1 flags."""
        salt, iteration = seed
        C = p.shape[0]
        acc = torch.empty(C, dtype=_F32, device=p.device)
        x_in, g_in, *scalars = carried
        self._kernels(plain)["accept"](
            *proposal, p, H0, x_in, g_in,
            *(v.to(_F32).reshape(C).contiguous() for v in scalars),
            pp["im"], salt, iteration,
            None if u is None else u.to(_F32).reshape(C).contiguous(), acc)
        return acc

    def iterate(self, x, U, g, ud, um, seed, L, eps, alpha, params=None,
                inv_mass=None, n01=None, u=None, Sigma=None, plain=False):
        """One whole HMC iteration: ``refresh``, the L-step trajectory and
        ``accept`` (:class:`FusedIteration`'s ``forward``). ``Sigma``, when
        given without ``inv_mass``, replaces the op's own momentum scale,
        so a sampler that drives the trajectory op draws with its own."""
        pp = self.resolve_params(params, inv_mass, Sigma)
        C, n = x.shape[0], self._width(x)
        e = _f32(eps)
        # padded state is read in place: the kernels never write x_in, g_in
        x_in = x.contiguous() if n == self.Mp else _pad_rows(x, self.Mp)
        g_in = g.contiguous() if n == self.Mp else _pad_rows(g, self.Mp)
        U_in = U.to(_F32).reshape(C).contiguous()
        xw = x_in.clone()
        pk = torch.empty_like(x_in)
        U1, ud1, um1 = (torch.empty(C, dtype=_F32, device=x.device)
                        for _ in range(3))
        p, H0 = self.open_iteration(pp, g_in, U_in, seed, e, n01, pk, plain)
        self._trajectory(self._kernels(plain), pp, xw, p, pk, L, e,
                         _f32(alpha), pk, U1, ud1, um1)
        acc = self.close_iteration(pp, (xw, pk, U1, ud1, um1), p, H0,
                                   (x_in, g_in, U_in, ud, um), seed, u, plain)
        return xw[:, :n], U1, pk[:, :n], ud1, um1, acc


class FusedTrajectory(_FusedLeapfrog):
    """``traj(x, p_half, L, eps, alpha) -> (x', p', g', U, ud, um)``.

    ``p_half`` already carries the leading half kick; ``p'`` includes the
    trailing half kick and ``g'`` is the gradient at ``x'`` (counterpart
    of ``make_fused_trajectory``'s ``traj``).
    """

    def forward(self, x, p, L, eps, alpha, params=None, inv_mass=None,
                plain=False):
        pp = self.resolve_params(params, inv_mass)
        C, n = x.shape[0], self._width(x)
        xw = _pad_rows(x, self.Mp)
        pw = _pad_rows(p, self.Mp)
        pk = pw.clone()
        U, ud, um = (torch.empty(C, dtype=_F32, device=x.device)
                     for _ in range(3))
        self._trajectory(self._kernels(plain), pp, xw, pw, pk, L, _f32(eps),
                         _f32(alpha), pk, U, ud, um)
        return xw[:, :n], pw[:, :n], pk[:, :n], U, ud, um


class FusedIteration(_FusedLeapfrog):
    """``it(x, U, g, ud, um, seed, L, eps, alpha) -> (x', U', g', ud',
    um', accept)``: one whole HMC iteration (counterpart of
    ``make_fused_iteration``'s ``it``).

    ``seed = (salt, iteration)`` keys the momentum and accept draws
    (see :mod:`.philox`); ``n01`` (C, M) and ``u`` (C,) replace them when
    given. Every output but ``accept`` is the post-select carried state.
    x and g may be (C, M) or lane-padded (C, Mp) float32 with zero pads;
    the outputs have the same width, so a sampler can keep its carry
    padded for a whole chunk.
    """

    def forward(self, x, U, g, ud, um, seed, L, eps, alpha, params=None,
                inv_mass=None, n01=None, u=None, plain=False):
        return self.iterate(x, U, g, ud, um, seed, L, eps, alpha,
                            params=params, inv_mass=inv_mass, n01=n01, u=u,
                            plain=plain)


class FusedStep(_FusedLeapfrog):
    """``step(x, p, eps, alpha, params=None, inv_mass=None) -> (x', p', U,
    ud, um)``: ONE leapfrog step (counterpart of ``make_fused_step``'s
    ``step``): drift with the diagonal inverse mass, clip to [low, high]
    and negate p where clipped, the residual of the drifted state with the
    row mean over the true n_obs removed, then always a full kick
    ``p' = p - eps (2 A^T r + alpha gm)``; U, ud and um are the drifted
    state's.

    x and p are not changed: x' and p' are new tensors, so a sampler can
    keep the previous step's pair for its boundary replay. x and p may be
    (C, M) or lane-padded (C, Mp) with zero pads; the outputs have the
    same width.
    """

    def forward(self, x, p, eps, alpha, params=None, inv_mass=None,
                plain=False):
        pp = self.resolve_params(params, inv_mass)
        k = self._kernels(plain)
        C, n = x.shape[0], self._width(x)
        ms = self.regularization == "MS"
        e, a = _f32(eps), _f32(alpha)
        s_data, s_mod = _kick_scales(e, a, ms)
        xw, pw = _fresh(x, self.Mp), _fresh(p, self.Mp)
        r = torch.empty((C, self.Dp), dtype=_F32, device=x.device)
        U, ud, um = (torch.empty(C, dtype=_F32, device=x.device)
                     for _ in range(3))
        k["drift"](xw, pw, None, pp["im"], pp["low"], pp["high"], e)
        k[self.gemms["step_residual"]](xw, pp["A"], pp["fix"], pp["dobs"],
                                       pp["dmask"], self.inv_nobs, r, ud,
                                       pp["A_split"])
        k[self.gemms["kick"]](r, pp["A"], xw, pw, pp["aprior"],
                              pp["gm_scale"], s_data, s_mod, self.beta, ms,
                              pp["A_split"])
        k["step_misfit"](xw, pp["aprior"], pp["wmsq"], ud, U, um, a,
                         self.beta, ms)
        return xw[:, :n], pw[:, :n], U, ud, um


def make_fused_step(A, dobs_centered, grav_fix, aprior, wm_sq, low, high, *,
                    regularization="MS", beta=0.001,
                    matvec_dtype=torch.bfloat16, device=None):
    """Build the per-step op (arguments as the JAX builder's, minus the TPU
    tiling options) on ``device``, ``cuda:0`` when None, as every builder
    here: ``A`` is the weighted, uncentred kernel (D, M), ``grav_fix`` the
    frozen-cell data or None."""
    return FusedStep(A, dobs_centered, grav_fix, aprior, wm_sq, low, high,
                     regularization=regularization, beta=beta,
                     matvec_dtype=matvec_dtype, Sigma=1.0, device=device,
                     centred=False)


def make_fused_trajectory(A, dobs_centered, grav_fix, aprior, wm_sq, low,
                          high, *, regularization="MS", beta=0.001,
                          matvec_dtype=torch.bfloat16, device=None):
    """Build the trajectory op (arguments as the JAX builder's, minus the
    TPU tiling options)."""
    return FusedTrajectory(A, dobs_centered, grav_fix, aprior, wm_sq, low,
                           high, regularization=regularization, beta=beta,
                           matvec_dtype=matvec_dtype, Sigma=1.0,
                           device=device)


def make_fused_iteration(A, dobs_centered, grav_fix, aprior, wm_sq, low,
                         high, *, regularization="MS", beta=0.001,
                         matvec_dtype=torch.bfloat16, Sigma=1.0,
                         device=None):
    """Build the whole-iteration op; ``Sigma`` scales the identity-metric
    momentum, as in the JAX builder."""
    return FusedIteration(A, dobs_centered, grav_fix, aprior, wm_sq, low,
                          high, regularization=regularization, beta=beta,
                          matvec_dtype=matvec_dtype, Sigma=Sigma,
                          device=device)
