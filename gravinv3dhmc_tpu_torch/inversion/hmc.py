"""Hamiltonian Monte Carlo over a chain batch, in PyTorch.

Counterpart of ``gravinv3dhmc_tpu/inversion/hmc.py`` for the uniformgrid,
ratiogrid and realdata slices: :func:`make_chunk_sampler` with the
shared-L, fused-step, fused-trajectory and fused-iteration paths, the
'accepted', 'chain' and 'none' storage modes and the Welford moments of
the warmup metric, and :class:`HamiltonianMC` whose ``sample()`` runs the
fixed-dt loop or the JAX package's windowed warmup (dual-averaged dt, a
diagonal metric from Welford moments, then a frozen kernel), and whose
``adapt()`` runs that warmup alone and hands over the frozen kernel and
the warmed chains (:class:`Frozen`) for a caller to issue the frozen
chunks itself. The reference semantics carried over are listed in the
JAX module's docstring (Sigma-scaled identity kinetic, 'mandatory'
clamp-and-negate, carried (U, g) between iterations, Metropolis on the
full Hamiltonian).

Randomness. One trajectory length L per iteration, shared by all chains,
is drawn on the host from a CPU ``torch.Generator`` seeded by (seed,
chunk), so a chunk's draws depend only on its index, as in the JAX
package. Momentum normals and accept uniforms come from Philox keyed by
(salt of the seed, global iteration, chain, element): on the card, inside
the ``refresh`` and ``accept`` kernels that open and close every
iteration of the fused paths (iteration, trajectory and per-step), and
from one launch of the ``draws`` kernel an iteration on the eager shared-L
path; on the CPU from those kernels' plain versions, with identical bits
(see ``ops/philox.py``). A *draw source* ``draws(chunk_idx, i) -> (L,
n01, u)`` replaces all three; the parity tests feed the JAX sampler's own
draws through it, and on the fused paths they enter as ``refresh``'s and
``accept``'s inputs.

CUDA graphs. On the card, a chunk of the fused iteration or trajectory
op whose inputs are the previous chunk's (the same dt, metric, params
and sample buffers, no Welford moments, no draw source, no mesh) replays
each iteration from a CUDA graph captured the first time its (L, carry
parity, store) was seen, with the key, the stats row and the store slot
advanced on the card (``graphs.py``); its draws, carry, buffers and stats
are the directly issued chunk's bit for bit. Every other chunk, and the
per-step op, issue their launches one by one.

Configurations the fused ops do not take (the 'logarithmic' or
'reflective' constraint, a Jacobian, a temperature other than 1, a
wavelet-compressed kernel) run, as
in the JAX package, on the eager path: by default one trajectory length
per chain (the JAX package's masked-L scan: steps past a chain's L pass
its state through; the loop stops at the longest L, past which every
step passes through), drawn on the host with the shared lengths' seeding,
and shared L when ``shared_L`` asks for it. Under 'logarithmic' x is the
logistic variable and the stored rows are ``logistic_to_mw(x)``.

Entry points run on ``cuda:0`` unless a device is given (see
``_device.py``); ``device="cpu"`` runs the plain versions.

Files and state are the JAX package's: ``write_files`` writes each
chain's stored rows to ``<save_folder><myrank + c>/model.dat`` and
``misfit.dat`` through the native sink (``runtime/sink.py``), and
``sample(checkpoint_path=...)`` snapshots the carry in the JAX ``.npz``
layout (``checkpoint.py``) and resumes from it bit for bit. One
deliberate difference: a snapshot taken under warmup adaptation also
stores the frozen kernel (step size, flag, inverse mass), which the JAX
package's lacks, so that its resumed run keeps the frozen kernel (see
:meth:`HamiltonianMC.sample`).

Multi-device runs: ``HamiltonianMC.spmd_mesh`` (a (chains, model) mesh of
``torch.distributed`` ranks, :func:`..parallel.sharded.make_mesh`) runs
the eager sampler SPMD, each rank on its block of the chains and cells
(:mod:`..parallel.sharded`), with the JAX package's restrictions (the
'mandatory' constraint, no Jacobian, temperature 1, a materialised
``Aw``, no fused kernels). Its draws are the unsharded run's: L is drawn
for the whole batch and cut, and ``draws`` runs at the block's offsets.
"""
from __future__ import annotations

import functools
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from .. import profiling
from .._device import as_tensor, resolve
from ..checkpoint import load_extra, load_state, save_state
from ..diagnostics import median
from ..ops import philox
from ..ops.leapfrog import (KERNELS, LANE, make_fused_iteration,
                            make_fused_trajectory)
from ..runtime.sink import write_chains
from .nuts import (dual_averaging_init, dual_averaging_update, shrink,
                   welford_init, welford_update, welford_variance)
from .graphs import IterationGraphs
from .potential import CONSTRAINTS, logistic_to_mw, mw_to_logistic


def _chunk_lengths(seed, chunk_idx, chunk_size, Lmin, Lmax, C=None):
    """The chunk's trajectory lengths from a CPU generator keyed by
    (seed, chunk): one an iteration, or ``C`` (one a chain) with ``C``."""
    k0, k1 = philox.salt_from_seed((int(seed) << 32) + int(chunk_idx))
    gen = torch.Generator().manual_seed(((k1 << 32) | k0) & ((1 << 63) - 1))
    shape = (chunk_size,) if C is None else (chunk_size, C)
    return torch.randint(Lmin, Lmax + 1, shape, generator=gen).tolist()


def make_chunk_sampler(potential_fn, *, dt, Lmin, Lmax, Sigma, low, high,
                       constraint, alpha, chunk_size, nsamples, ndraws,
                       wdiag_inv, data_size, dtype=torch.float32,
                       shared_L=False, fused_step=None,
                       fused_trajectory=None, fused_iteration=None,
                       store_mode="accepted",
                       store_thin=1, draws=None, device=None,
                       log_factor=1000.0, mesh=None, global_shape=None):
    """Build ``run_chunk(carry, seed, chunk_idx, params=None, dt=...,
    inv_mass=None, store_base=0) -> (carry, stats)``.

    ``carry = (x, U, g, u_data, u_model, nacc, buf_m, buf_k)`` as in the
    JAX package; the sample buffers are updated in place. A carry that
    goes on with per-chain running moments ``(w_mean (C, M), w_m2 (C, M),
    w_count ())`` of the post-accept position gets them updated every
    iteration on every path (:func:`.nuts.welford_update`, the warmup
    metric's estimator; :meth:`HamiltonianMC.sample` drops them at the
    freeze); lane pads never enter them. ``stats``
    is the (chunk_size, C, 5) block [accept, U, u_data, u_model, L]. ``draws``
    is an optional draw source (see the module docstring). At most one of
    ``fused_step``, ``fused_trajectory`` and ``fused_iteration`` is given;
    each runs with one L shared by all chains, keeps x and g lane-padded
    for the whole chunk, and opens and closes each iteration with one
    ``refresh`` and one ``accept`` launch and takes the 'mandatory'
    constraint only. Without one the eager path runs, with one L shared
    by all chains under ``shared_L`` and otherwise one a chain (a draw
    source then gives L as a (C,) array); it takes the 'mandatory' clamp,
    the 'reflective' folds (four, then a clip) and the 'logarithmic'
    transform (no bound in x; ``log_factor`` k). ``device`` is ``cuda:0``
    when None.

    ``mesh`` (a :class:`..parallel.sharded.Mesh`, with ``global_shape =
    (C, M)`` the whole batch's) runs this rank's block of the batch on the
    eager path (:func:`..parallel.sharded.make_sharded_chunk_sampler`
    builds it): ``potential_fn`` is the sharded potential, ``low``,
    ``high`` and ``wdiag_inv`` are this rank's cells; the kinetic energies
    are summed over the ``model`` group before the Metropolis test, the
    stats rows divide by the global M, one L a chain is drawn for the
    whole batch and cut to the rank's chains, ``draws`` runs at the
    block's offsets, an injected draw source gives global draws cut to the
    block, and after each chunk one ``all_reduce`` checks that the ranks of
    a chain group counted the same accepts.
    """
    if store_mode not in ("accepted", "chain", "none"):
        raise ValueError(f"unknown store_mode {store_mode!r}")
    if constraint not in CONSTRAINTS:
        raise ValueError("Please choose right boundary constraint"
                         "(mandatory, logarithmic)!")
    fused = (fused_step, fused_trajectory, fused_iteration)
    if constraint != "mandatory" and any(f is not None for f in fused):
        raise ValueError("the fused kernels support the 'mandatory' "
                         "boundary constraint only")
    per_chain = not shared_L and all(f is None for f in fused)
    device = resolve(device)
    if mesh is not None:
        if any(f is not None for f in fused):
            raise ValueError("a mesh runs the eager path only: the fused "
                             "kernels would gather the sharded matrix")
        C_glob, M_glob = (int(v) for v in global_shape)
        c0, c1 = mesh.chain_range(C_glob)
        m0, m1 = mesh.col_range(M_glob)
    dt_default = float(dt)

    def rounded(v):
        # a scalar in the sampler's dtype, as the JAX sampler casts its
        # dt, Sigma and alpha (float32 rounds them, float64 keeps them)
        return float(torch.tensor(float(v), dtype=dtype))

    sigma = rounded(Sigma)
    low_t = as_tensor(low, dtype, device)
    high_t = as_tensor(high, dtype, device)
    alpha_c = rounded(alpha)
    wdiag_inv = as_tensor(wdiag_inv, dtype, device)
    total = nsamples + ndraws
    pot_raw = potential_fn.fn

    def bound(x, p):
        """The constraint's treatment of a drifted (x, p)."""
        if constraint == "mandatory":
            hit = (x > high_t) | (x < low_t)
            return (torch.minimum(torch.maximum(x, low_t), high_t),
                    torch.where(hit, -p, p))
        if constraint == "reflective":
            # billiard reflection, a bounded number of folds
            for _ in range(4):
                over = x > high_t
                under = x < low_t
                x = torch.where(over, 2 * high_t - x, x)
                x = torch.where(under, 2 * low_t - x, x)
                p = torch.where(over | under, -p, p)
            return torch.minimum(torch.maximum(x, low_t), high_t), p
        return x, p

    def make_rows(x, U, u_data, u_model):
        model_size = x.shape[-1] if mesh is None else M_glob
        if constraint == "logarithmic":
            x = logistic_to_mw(x, low_t, high_t, log_factor)
        m_rows = x * wdiag_inv  # unweighted model, reference units
        u_norm_d = u_data / data_size
        u_norm_m = u_model / model_size
        k_rows = torch.stack([
            U, u_data, u_model, u_norm_d + alpha_c * u_norm_m, u_norm_d,
            u_norm_m, torch.full_like(U, alpha_c)], dim=-1)
        return m_rows, k_rows

    def chain_stores(rel):
        """Whether chain-mode storage keeps iteration ``rel`` (every
        store_thin-th post-accept state after ``ndraws``)."""
        return (store_mode == "chain"
                and ndraws <= rel < ndraws + nsamples * store_thin
                and (rel - ndraws) % store_thin == 0)

    def store_accepted(xm, U, u_data, u_model, accept, nacc, buf_m, buf_k):
        # reference parity: each chain writes its own accepted-count row;
        # a gather/select/scatter keeps the host out of it
        store = accept & (nacc >= ndraws) & (nacc < total)
        idx = torch.clamp(nacc - ndraws, 0, nsamples - 1).long()
        chain_ix = torch.arange(xm.shape[0], device=xm.device)
        m_rows, k_rows = make_rows(xm, U, u_data, u_model)
        buf_m[chain_ix, idx] = torch.where(store[:, None], m_rows,
                                           buf_m[chain_ix, idx])
        buf_k[chain_ix, idx] = torch.where(store[:, None], k_rows,
                                           buf_k[chain_ix, idx])

    def stats_row(accept, U, u_data, u_model, L):
        L_col = (L.to(U.device, dtype) if torch.is_tensor(L)
                 else torch.full_like(U, float(L)))
        return torch.stack([accept.to(dtype), U, u_data, u_model, L_col],
                           dim=-1)

    def finish(x, U, g, u_data, u_model, accept, L, rel, nacc, buf_m,
               buf_k, wstate):
        """Sample storage, accept counting, the stats row and the Welford
        moments (x may carry lane pads past the model's width)."""
        with profiling.span("hmc.store"):
            xm = x[:, :buf_m.shape[-1]]
            if store_mode == "accepted":
                store_accepted(xm, U, u_data, u_model, accept, nacc, buf_m,
                               buf_k)
            elif chain_stores(rel):
                # a shared slot
                slot = min((rel - ndraws) // store_thin, nsamples - 1)
                m_rows, k_rows = make_rows(xm, U, u_data, u_model)
                buf_m[:, slot] = m_rows
                buf_k[:, slot] = k_rows
            nacc = nacc + accept.to(nacc.dtype)
            stats = stats_row(accept, U, u_data, u_model, L)
            carry = (x, U, g, u_data, u_model, nacc, buf_m, buf_k)
            if wstate is not None:
                # per-chain running moments of the post-accept position
                w = welford_update(dict(zip(("mean", "m2", "count"), wstate)),
                                   xm)
                carry = carry + (w["mean"], w["m2"], w["count"])
            return carry, stats

    # the op that runs whole iterations (refresh, the trajectory kernels
    # and accept); the trajectory op draws its momentum at this sampler's
    # Sigma
    iter_op = fused_iteration or fused_trajectory
    iter_sigma = None if fused_iteration is not None else sigma

    def one_iteration(carry, L, n01, u, salt, git, dt, inv_mass, params,
                      rel):
        x, U, g, u_data, u_model, nacc, buf_m, buf_k = carry[:8]
        wstate = carry[8:] or None
        seed = (salt, git)
        if iter_op is not None:
            x, U, g, u_data, u_model, accf = iter_op.iterate(
                x, U, g, u_data, u_model, seed, L, dt, alpha_c,
                inv_mass=inv_mass, n01=n01, u=u, Sigma=iter_sigma)
            return finish(x, U, g, u_data, u_model, accf > 0.5, L, rel,
                          nacc, buf_m, buf_k, wstate)
        if fused_step is not None:
            # refresh, then L calls of the per-step op on the padded state.
            # The op applies a full kick every step and never returns g:
            # it is recovered from the last two momenta, after replaying
            # the last step's boundary negation on the pair before it (the
            # op's own im, low and high, the same products and comparisons
            # as its drift, so the same mask bit for bit); then accept
            pp = fused_step.resolve_params(inv_mass=inv_mass, Sigma=sigma)
            p, H0 = fused_step.open_iteration(pp, g, U, seed, dt, n01)
            xs, ps = x, p
            x_prev, p_prev = xs, ps
            U_new, ud_new, um_new = U, u_data, u_model
            for _ in range(L):
                x_prev, p_prev = xs, ps
                xs, ps, U_new, ud_new, um_new = fused_step(
                    xs, ps, dt, alpha_c, inv_mass=inv_mass)
            x_pre = x_prev + dt * (p_prev if inv_mass is None
                                   else pp["im"] * p_prev)
            hit = (x_pre > pp["high"]) | (x_pre < pp["low"])
            p_eff = torch.where(hit, -p_prev, p_prev)
            # trailing half kick: p_eff - dt/2 g with g = (p_eff - ps)/dt
            g_new = (p_eff - ps) / dt
            accf = fused_step.close_iteration(
                pp, (xs, g_new, U_new, ud_new, um_new), 0.5 * (p_eff + ps),
                H0, (x, g, U, u_data, u_model), seed, u)
            return finish(xs, U_new, g_new, ud_new, um_new, accf > 0.5, L,
                          rel, nacc, buf_m, buf_k, wstate)
        C, M = x.shape
        if n01 is None or u is None:
            # the Philox normals at the lane-padded width (the words
            # ``refresh`` draws for this state) and uniforms, one launch;
            # a mesh's rank draws its block at its offsets (its first cell
            # is a multiple of 4, each counter's four normals)
            width, offsets = -(-M // LANE) * LANE, ()
            if mesh is not None:
                width, offsets = -(-M // 4) * 4, (c0, m0 // 4)
            n01_d = torch.empty((C, width), dtype=torch.float32,
                                device=x.device)
            u_d = torch.empty(C, dtype=torch.float32, device=x.device)
            KERNELS["draws"](n01_d, u_d, salt, git, *offsets)
            n01 = n01_d[:, :M] if n01 is None else n01
            u = u_d if u is None else u
        n01 = torch.as_tensor(n01, dtype=dtype, device=x.device)
        u = torch.as_tensor(u, dtype=dtype, device=x.device)
        if inv_mass is None:
            # reference kinetic: K = p.p/2 with p ~ N(0, Sigma^2)
            p0 = n01 * sigma
            K0 = 0.5 * (p0 * p0).sum(-1)
        else:
            p0 = n01 / torch.sqrt(inv_mass)
            K0 = 0.5 * (inv_mass * p0 * p0).sum(-1)
        xs, ps, U_new, g_new = x, p0 - (0.5 * dt) * g, U, g
        ud_new, um_new = u_data, u_model
        if torch.is_tensor(L):
            # one L a chain: a step past a chain's L passes its state
            # through; the trailing half kick is on each chain's last step
            L_dev = L.to(x.device)
            for i in range(int(L.max())):
                act = i < L_dev
                xn, pn = bound(xs + dt * (ps if inv_mass is None
                                          else inv_mass * ps), ps)
                Un, gn, (_, udn, umn) = pot_raw(xn, alpha_c, params)
                kick = torch.where(L_dev - 1 == i, 0.5 * dt, dt)
                pn = pn - kick[:, None] * gn
                xs = torch.where(act[:, None], xn, xs)
                ps = torch.where(act[:, None], pn, ps)
                g_new = torch.where(act[:, None], gn, g_new)
                U_new = torch.where(act, Un, U_new)
                ud_new = torch.where(act, udn, ud_new)
                um_new = torch.where(act, umn, um_new)
            p_new = ps
        else:
            for _ in range(L):
                xs, ps = bound(xs + dt * (ps if inv_mass is None
                                          else inv_mass * ps), ps)
                U_new, g_new, (_, ud_new, um_new) = pot_raw(xs, alpha_c,
                                                            params)
                ps = ps - dt * g_new
            # full kicks everywhere; restore the trailing half kick
            p_new = ps + (0.5 * dt) * g_new
        if inv_mass is None:
            K_new = 0.5 * (p_new * p_new).sum(-1)
        else:
            K_new = 0.5 * (inv_mass * p_new * p_new).sum(-1)
        if mesh is not None:
            # the kinetic energies are sums over cells: both partials in
            # one collective, so every rank of a chain group tests the
            # same Hamiltonians
            K0, K_new = mesh.all_reduce(torch.stack([K0, K_new]), "model")
        H0 = K0 + U
        H_new = K_new + U_new
        accept = (H_new < H0) | (u < torch.exp(-(H_new - H0)))
        acc_col = accept[:, None]
        return finish(torch.where(acc_col, xs, x),
                      torch.where(accept, U_new, U),
                      torch.where(acc_col, g_new, g),
                      torch.where(accept, ud_new, u_data),
                      torch.where(accept, um_new, u_model),
                      accept, L, rel, nacc, buf_m, buf_k, wstate)

    # the whole-iteration ops on the card replay captured iterations
    # (graphs.py) on chunks whose inputs match the previous chunk's; with
    # injected draws or a mesh every iteration is issued directly
    graphs = (IterationGraphs(device) if iter_op is not None
              and IterationGraphs.runs_on(device) and draws is None
              and mesh is None else None)

    def graph_inputs(carry, params, dt, inv_mass):
        """What a chunk's graphs are captured against: ``(key, refs)``
        for :meth:`IterationGraphs.engage`; a carry with Welford moments
        gives the key None."""
        if len(carry) != 8:
            return None, ()
        x, nacc, buf_m, buf_k = carry[0], carry[5], carry[6], carry[7]
        key = (dt, None if inv_mass is None else inv_mass._version,
               tuple(x.shape), x.dtype, nacc.dtype, tuple(buf_m.shape),
               tuple(buf_k.shape), buf_m.data_ptr(), buf_k.data_ptr())
        return key, (params, inv_mass, buf_m, buf_k)

    def replay_chunk(carry, salt, chunk_idx, Ls, dt, inv_mass, store_base):
        """The chunk as one graph replay an iteration: the carry copied
        into the first fixed set, the card's counter set, then each
        iteration from one set into the other; the carry and stats come
        back as new tensors."""
        x, U, g, u_data, u_model, nacc, buf_m, buf_k = carry
        C, M = x.shape
        iter_op.warm(C, inv_mass, iter_sigma)
        b = graphs.chunk_buffers(C, iter_op.Mp, nacc.dtype, chunk_size,
                                 dtype)
        first = b.sets[0]
        first[0][:, :M].copy_(x)
        first[1][:, :M].copy_(g)
        for dst, src in zip(first[2:], (U, u_data, u_model)):
            dst.copy_(src)
        b.nacc.copy_(nacc)
        # the chunk's first store slot: the next chain-mode store's
        b.start(salt, chunk_idx * chunk_size,
                max(0, -(-(store_base - ndraws) // store_thin)))

        def body(src, dst, L, stores):
            xs, gs, Us, uds, ums = src
            x1, U1, _, ud1, um1, accf = iter_op.iterate(
                xs, Us, gs, uds, ums, (salt, 0), L, dt, alpha_c,
                inv_mass=inv_mass, Sigma=iter_sigma, out=dst, key=b.key)
            accept = accf > 0.5
            xm = x1[:, :buf_m.shape[-1]]
            if store_mode == "accepted":
                store_accepted(xm, U1, ud1, um1, accept, b.nacc, buf_m,
                               buf_k)
            elif stores:
                m_rows, k_rows = make_rows(xm, U1, ud1, um1)
                buf_m.index_copy_(1, b.slot, m_rows[:, None])
                buf_k.index_copy_(1, b.slot, k_rows[:, None])
            b.nacc.add_(accept.to(b.nacc.dtype))
            b.stats.index_copy_(0, b.row,
                                stats_row(accept, U1, ud1, um1, L)[None])
            b.step(stores)

        for i in range(chunk_size):
            L, parity = int(Ls[i]), i % 2
            stores = chain_stores(store_base + i)
            src, dst = b.sets[parity], b.sets[1 - parity]
            with profiling.span("hmc.iteration") as it:
                if it is not None:
                    profiling.mark(it, device, steps=L)
                graphs.replay((L, parity, stores),
                              functools.partial(body, src, dst, L, stores))
        last = b.sets[chunk_size % 2]
        return ((last[0][:, :M].clone(), last[2].clone(),
                 last[1][:, :M].clone(), last[3].clone(), last[4].clone(),
                 b.nacc.clone(), buf_m, buf_k), b.stats.clone())

    # the last metric given in another type, kind or place than the
    # sampler's, with what it was when converted: (given, its version or a
    # copy of its values, the converted tensor)
    metric_cache = [None, None, None]

    def metric_tensor(inv_mass):
        """The metric as a tensor of the sampler's dtype on its device:
        the same tensor every chunk while the caller passes the same
        unchanged array, so that the chunk's graphs replay."""
        if inv_mass is None or (torch.is_tensor(inv_mass)
                                and inv_mass.dtype == dtype
                                and inv_mass.device == device):
            return inv_mass
        given, seen, converted = metric_cache
        if given is inv_mass and (
                seen == inv_mass._version if torch.is_tensor(inv_mass)
                else np.array_equal(seen, inv_mass)):
            return converted
        converted = torch.as_tensor(inv_mass, dtype=dtype, device=device)
        metric_cache[:] = (inv_mass, inv_mass._version
                           if torch.is_tensor(inv_mass)
                           else np.array(inv_mass, copy=True), converted)
        return converted

    def run_chunk(carry, seed, chunk_idx, params=None, dt=dt_default,
                  inv_mass=None, store_base=0):
        # spans (profiling.py): hmc.chunk around the chunk, hmc.lengths
        # around the host draw of L, hmc.iteration around each iteration
        # (its batch steps, and a marker on the card where it starts)
        with profiling.chunk(chunk_idx):
            params = potential_fn.params if params is None else params
            dt = rounded(dt)
            inv_mass = metric_tensor(inv_mass)
            salt = philox.salt_from_seed(seed)
            if inv_mass is not None and mesh is not None \
                    and inv_mass.shape[-1] == M_glob:
                inv_mass = inv_mass[..., m0:m1]
            with profiling.span("hmc.lengths"):
                Ls = (None if draws is not None else
                      _chunk_lengths(seed, chunk_idx, chunk_size, Lmin, Lmax,
                                     (carry[0].shape[0] if mesh is None
                                      else C_glob) if per_chain else None))
            if mesh is not None and per_chain and Ls is not None:
                # the whole batch's lengths, cut to this rank's chains
                Ls = [row[c0:c1] for row in Ls]
            if graphs is not None and graphs.engage(
                    *graph_inputs(carry, params, dt, inv_mass)):
                return replay_chunk(carry, salt, chunk_idx, Ls, dt,
                                    inv_mass, store_base)
            M = carry[0].shape[1]
            op = iter_op or fused_step
            if op is not None:
                # a fused path's carry stays lane-padded (zero pads) for
                # the whole chunk: no padding or slicing per iteration
                pad = (0, op.Mp - M)
                carry = (F.pad(carry[0], pad), carry[1],
                         F.pad(carry[2], pad), *carry[3:])
            stats = []
            for i in range(chunk_size):
                if draws is not None:
                    L, n01, u = draws(chunk_idx, i)
                    if mesh is not None:
                        # the whole batch's draws, cut to this rank's block
                        n01 = np.asarray(n01)[c0:c1, m0:m1]
                        u = np.asarray(u)[c0:c1]
                        if per_chain:
                            L = np.asarray(L)[c0:c1]
                else:
                    L, n01, u = Ls[i], None, None
                if n01 is not None:
                    # injected draws, made (C, M) tensors once an iteration
                    n01 = torch.as_tensor(np.array(n01), dtype=dtype,
                                          device=device)
                    u = torch.as_tensor(np.array(u), dtype=dtype,
                                        device=device)
                L = (torch.as_tensor(np.asarray(L), dtype=torch.int64)
                     if per_chain else int(L))
                with profiling.span("hmc.iteration") as it:
                    if it is not None:
                        profiling.mark(it, device, steps=int(L.max())
                                       if per_chain else L)
                    carry, st = one_iteration(
                        carry, L, n01, u, salt, chunk_idx * chunk_size + i,
                        dt, inv_mass, params, store_base + i)
                profiling.count("direct_iterations")
                stats.append(st)
            if op is not None:
                carry = (carry[0][:, :M], carry[1], carry[2][:, :M],
                         *carry[3:])
            if mesh is not None:
                _check_lockstep(mesh, carry[5], chunk_idx)
            return carry, torch.stack(stats)

    return run_chunk


def _check_lockstep(mesh, nacc, chunk_idx):
    """``RuntimeError`` unless every rank of this rank's ``model`` group
    holds the same accept counts: one ``all_reduce`` (max) of a checksum
    and its negation. An accept decision that differs between the ranks
    of a chain group desynchronises their collectives; this fails the run
    at the chunk's end instead."""
    w = torch.arange(1, nacc.shape[0] + 1, dtype=torch.float64,
                     device=nacc.device)
    s = (nacc.to(torch.float64) * w).sum()
    both = mesh.all_reduce(torch.stack([s, -s]), "model", op="max")
    hi, lo = both.tolist()
    if hi != -lo:
        raise RuntimeError(
            f"chunk {chunk_idx}: the ranks of chain group "
            f"{mesh.coords[0]} took different accept decisions (accept "
            f"checksums {-lo} .. {hi}); a sum over cells missed its "
            "all_reduce over 'model'")


#: ``store_base`` during warmup: ``rel`` stays below ``ndraws``, so
#: chain-mode storage skips every iteration (as the JAX package's)
STORE_OFF = -(2 ** 30)


def warmup_schedule(adapt_chunks, adapt_step_size, adapt_mass):
    """``(W, w1, metric_switches)`` of the JAX package's windowed warmup
    (``gravinv3dhmc_tpu/inversion/hmc.py``, ``sample``): W warmup chunks;
    dual averaging of dt under the initial kinetic for chunks [1, w1];
    then, with ``adapt_mass``, doubling slow Welford windows, each ending
    at a metric switch (the diagonal metric re-estimated from that window
    alone, dual averaging re-seeded), and a final window of at least 3
    chunks re-tuning dt under the last metric; the kernel freezes at W.
    Without ``adapt_mass`` there is one dual-averaging window of W chunks;
    with no adaptation, W = 0."""
    adapting = adapt_step_size or adapt_mass
    W = int(adapt_chunks) if adapting else 0
    metric_switches = []
    if adapt_mass:
        W = max(W, 8)
        w1 = max(1, W // 10)
        # the final window must give dual averaging enough updates to
        # settle after its last re-init
        w_f = max(3, W // 5)
        slow_total = W - w1 - w_f
        base = max(1, slow_total // 7)  # 1+2+4 doubling fills ~7x
        lens, acc, cur = [], 0, base
        while acc + cur < slow_total and len(lens) < 6:
            lens.append(cur)
            acc += cur
            cur *= 2
        lens.append(slow_total - acc)
        edge = w1
        for ln in lens:
            edge += ln
            metric_switches.append(edge)
    else:
        w1 = W
    return W, w1, metric_switches


class HamiltonianMC:
    """Chain ensemble sampler with the reference's run semantics.

    Attributes mirror the JAX class; ``device`` says where the chains
    live: ``cuda:0`` while it is None, and then without a card
    :meth:`prepare` raises (``"cpu"`` runs the plain versions).
    ``use_fused`` runs the fused leapfrog kernels (the whole iteration if
    ``prefer_iteration_kernel``, else the trajectory), which on a CUDA
    device are the CUDA kernels of ``csrc/leapfrog.cu``, for the
    configurations they take; the others (``constraint`` 'logarithmic' or
    'reflective', ``jacobian``, a ``temperature`` other than 1) run on the
    eager path with one L a chain unless ``shared_L``, as in the JAX
    package.
    ``adapt_step_size`` / ``adapt_mass`` turn on the JAX package's
    windowed warmup over the first ``adapt_chunks`` chunks
    (:func:`warmup_schedule`), aiming at accept rate ``adapt_target``.
    ``fused_per_step_ok`` and ``transfer_samples`` are accepted for the
    JAX class's interface: this sampler never falls back to the per-step
    op (the slices choose their op), and its sample buffers and ESS stay
    on the device whatever ``transfer_samples`` says. ``write_files``
    (False by default, True in :func:`HMCSample`, as the JAX class's
    default) writes the stored rows to ``<save_folder><myrank + c>/``
    after sampling. ``spmd_mesh`` (a :class:`..parallel.sharded.Mesh`)
    runs :meth:`sample` SPMD over its ranks (see there); the chains live
    on the mesh's device (or this rank's, or ``device``).
    """

    def __init__(self, model):
        self.model = model
        self.dt = None
        self.Lrange = [10, 50]
        self.Sigma = 1.0
        self.seed = 0
        self.myrank = 0
        self.constraint = "mandatory"
        self.log_factor = 1000.0
        self.RegulFactor = 1.0
        self.regularization = "Damping"
        self.beta = 0.01
        self.nchains = 1
        self.chunk_size = 64
        self.dtype = torch.float32
        self.device = None
        self.verbose = True
        self.save_folder = "mychain"
        #: write each chain's stored rows to ``<save_folder><myrank + c>/``
        #: after sampling (the JAX class defaults to True; here the sample
        #: buffers stay on the device unless asked for)
        self.write_files = False
        self.adapt_step_size = False
        self.adapt_target = 0.8
        self.adapt_chunks = 10
        self.adapt_mass = False
        self.shared_L = False
        self.use_fused = False
        #: storage type of the kernel matrix in the fused kernels
        #: (None = bfloat16, the JAX default)
        self.fused_matvec_dtype = None
        self.prefer_iteration_kernel = True
        self.fused_per_step_ok = True
        self._fused_mode = "off"
        self.store_mode = "accepted"
        self.store_thin = 1
        self.temperature = 1.0
        self.jacobian = False
        self.spmd_mesh = None
        self.transfer_samples = True
        self.low = None
        self.high = None
        self.initial_model = None
        self.aprior_model = None
        self.dobs = None

    def _build_fused(self, device):
        """The fused op this configuration runs on ``device``:
        ``(trajectory, iteration)`` with one of them set, or neither for a
        configuration the fused kernels do not take (the JAX package's
        rule: a constraint other than 'mandatory', a Jacobian, a
        temperature other than 1, a regularizer other than MS or
        Damping, a module without a host ``Aw``: a
        :class:`~.joint.JointModule` or a matrix built on the card, a
        module whose potential runs on the wavelet-compressed kernel),
        which then runs on the eager path (``_fused_mode`` "off").

        One deliberate difference: the JAX package also sends chain counts
        that are not a multiple of 32 to the eager path, because its
        Pallas kernels tile chains by 32; the CUDA kernels here guard
        every chain tile's edge (the samplers run 200 chains through
        them), so any count takes the fused op."""
        if (self.constraint != "mandatory"
                or self.regularization not in ("MS", "Damping")
                or self.jacobian or float(self.temperature) != 1.0
                or getattr(self.model, "Aw", None) is None
                or (getattr(self.model, "Awcp", None) is not None
                    and self.model.wavelet)):
            self._fused_mode = "off"
            return None, None
        mv = self.fused_matvec_dtype or torch.bfloat16
        gfix = (np.asarray(self.model.grav_fix)
                if getattr(self.model, "fixed", False) else None)
        fargs = (np.asarray(self.model.Aw),
                 np.asarray(self.dobs) - np.mean(self.dobs), gfix,
                 self.aprior_model, self.model.wdiag * self.model.wdiag,
                 self.low, self.high)
        fkw = dict(regularization=self.regularization, beta=self.beta,
                   matvec_dtype=mv, device=device)
        name = str(mv).replace("torch.", "")
        if self.prefer_iteration_kernel:
            self._fused_mode = f"iteration({name})"
            return None, make_fused_iteration(*fargs, Sigma=self.Sigma,
                                              **fkw)
        self._fused_mode = f"trajectory({name})"
        return make_fused_trajectory(*fargs, **fkw), None

    def prepare(self, nsamples, ndraws, draws=None):
        """``(run_chunk, carry)``: the chunk runner that :meth:`sample`
        drives and the carry it starts from (the initial model, (M,) or
        one a chain (C, M), with its potential and gradient, zeroed counts
        and sample buffers, and zeroed Welford moments under
        ``adapt_mass``). Timing or profiling single chunks starts here
        too."""
        if self.spmd_mesh is not None:
            return self._prepare_sharded(nsamples, ndraws, draws)
        C = self.nchains
        M = self.initial_model.shape[-1]
        dtype = self.dtype
        device = resolve(self.device)
        potential_fn = self.model.make_potential(
            self.aprior_model, self.low, self.high,
            constraint=self.constraint, log_factor=self.log_factor,
            regularization=self.regularization, beta=self.beta, dtype=dtype,
            jacobian=self.jacobian, temperature=float(self.temperature),
            device=device)
        fused_traj, fused_iter = (self._build_fused(device) if self.use_fused
                                  else (None, None))
        fused = fused_traj is not None or fused_iter is not None
        run_chunk = make_chunk_sampler(
            potential_fn, dt=self.dt, Lmin=self.Lrange[0],
            Lmax=self.Lrange[1], Sigma=self.Sigma, low=self.low,
            high=self.high, constraint=self.constraint,
            alpha=self.RegulFactor, chunk_size=self.chunk_size,
            nsamples=nsamples, ndraws=ndraws,
            wdiag_inv=self.model.wdiag_inv, data_size=self.dobs.shape[0],
            dtype=dtype, shared_L=self.shared_L or fused,
            fused_trajectory=fused_traj, fused_iteration=fused_iter,
            store_mode=self.store_mode,
            store_thin=self.store_thin, draws=draws, device=device,
            log_factor=self.log_factor)

        if torch.is_tensor(self.initial_model):
            # a start on the card (the device-built module's warm start)
            # stays there, and so does its box
            xp = torch
            x0 = as_tensor(self.initial_model, torch.float64,
                           device).expand(C, M).clone()
            low, high = (as_tensor(v, torch.float64, device)
                         for v in (self.low, self.high))
        else:
            x0 = np.broadcast_to(np.asarray(self.initial_model, np.float64),
                                 (C, M)).copy()
            low, high, xp = self.low, self.high, np
        if self.constraint == "logarithmic":
            # a start on a bound (a clipped warm start) is pulled 1e-6 of
            # the span inside, so the transform stays finite
            span = high - low
            lo, hi = low + 1e-6 * span, high - 1e-6 * span
            x0 = mw_to_logistic(xp.minimum(xp.maximum(x0, lo), hi),
                                low, high, self.log_factor, xp=xp)
        x = torch.as_tensor(x0, dtype=dtype, device=device)
        U, g, (_, u_data, u_model) = potential_fn(x, self.RegulFactor)
        carry = (x, U, g, u_data, u_model,
                 torch.zeros(C, dtype=torch.int32, device=device),
                 torch.zeros((C, nsamples, M), dtype=dtype, device=device),
                 torch.zeros((C, nsamples, 7), dtype=dtype, device=device))
        if self.adapt_mass:
            carry = carry + _zero_moments(C, M, dtype, device)
        return run_chunk, carry

    def _prepare_sharded(self, nsamples, ndraws, draws):
        """:meth:`prepare` under ``spmd_mesh``: the JAX package's routing
        (its restrictions, the sharded potential from ``module.Aw`` and
        this rank's slices, the eager sampler told the mesh) with this
        rank's block of the carry."""
        from ..parallel.sharded import (make_sharded_chunk_sampler,
                                        make_sharded_potential, mesh_device)
        if self.constraint != "mandatory":
            raise ValueError("spmd_mesh supports the 'mandatory' "
                             "boundary constraint only")
        if self.jacobian or float(self.temperature) != 1.0:
            raise ValueError("spmd_mesh does not support "
                             "temperature/jacobian potentials yet")
        mod = self.model
        if getattr(mod, "Aw", None) is None:
            raise ValueError("spmd_mesh needs a materialised kernel "
                             "matrix (module.Aw)")
        mesh = self.spmd_mesh
        device = mesh_device(mesh, self.device)
        C, M = self.nchains, self.initial_model.shape[-1]
        self._fused_mode = "off"
        potential_fn, _ = make_sharded_potential(
            mesh, mod.Aw, self.dobs, self.aprior_model, self.low, self.high,
            grav_fix=(np.asarray(mod.grav_fix)
                      if getattr(mod, "fixed", False) else None),
            regularization=self.regularization, beta=self.beta,
            wm_sq=np.asarray(mod.wdiag) ** 2,
            mshape=getattr(mod, "mshape", None),
            active=getattr(getattr(mod, "mesh", None), "active", None),
            dtype=self.dtype, device=device)
        run_chunk, init_carry = make_sharded_chunk_sampler(
            mesh, potential_fn, low=self.low, high=self.high, M=M,
            nchains=C, nsamples=nsamples, ndraws=ndraws,
            wdiag_inv=self.model.wdiag_inv, data_size=self.dobs.shape[0],
            dt=self.dt, Lmin=self.Lrange[0], Lmax=self.Lrange[1],
            Sigma=self.Sigma, constraint=self.constraint,
            alpha=self.RegulFactor, chunk_size=self.chunk_size,
            dtype=self.dtype, shared_L=self.shared_L,
            welford=self.adapt_mass, store_mode=self.store_mode,
            store_thin=self.store_thin, draws=draws, device=device)
        if torch.is_tensor(self.initial_model):
            x0 = self.initial_model.to(torch.float64).expand(C, M)
        else:
            x0 = np.broadcast_to(np.asarray(self.initial_model, np.float64),
                                 (C, M))
        return run_chunk, init_carry(x0)

    def adapt(self, nsamples, ndraws):
        """Run the windowed warmup exactly as :meth:`sample` does and hand
        over the frozen kernel: a :class:`Frozen` record with the chunk
        runner (:meth:`prepare`'s, for ``nsamples`` and ``ndraws``), the
        frozen dt, the inverse mass (the sampler's dtype, on its device;
        None without ``adapt_mass``) and the warmed chains' carry, their
        accept counts restarted and without Welford moments, so that a
        caller issues the frozen chunks itself (:meth:`Frozen.run`, chunk
        ``n_chunks`` on) as :meth:`sample` goes on after its freeze.
        Under ``spmd_mesh`` the carry and metric are this rank's blocks.
        Needs ``adapt_step_size`` or ``adapt_mass``."""
        if not (self.adapt_step_size or self.adapt_mass):
            raise ValueError("adapt() runs the warmup: set adapt_step_size "
                             "or adapt_mass")
        run_chunk, carry = self.prepare(nsamples, ndraws)
        loop = _ChunkLoop(self, run_chunk, carry,
                          _Layout(self.spmd_mesh, self.nchains,
                                  self.initial_model.shape[-1],
                                  self.adapt_mass),
                          nsamples, ndraws)
        loop.read_counts()
        self._warmup(loop)
        return Frozen(run_chunk, loop.carry, loop.dt, loop.inv_mass,
                      loop.seed, loop.n_chunks, loop.grad_evals)

    def _warmup(self, loop):
        """The windowed warmup on ``loop`` (:func:`warmup_schedule`), from
        its chunk 0 to the freeze at W (or to ``loop.max_chunks``), in an
        ``hmc.adapt`` span; the freeze in an ``hmc.freeze`` span. Counts
        ``adapt_chunks``, ``metric_switches`` and ``adapt_grad_evals``."""
        W, w1, metric_switches = warmup_schedule(
            self.adapt_chunks, self.adapt_step_size, self.adapt_mass)
        lay, C, dtype = loop.lay, self.nchains, self.dtype
        device = loop.carry[0].device
        da = dual_averaging_init(loop.dt, target=self.adapt_target)
        loop.frozen = False
        with profiling.chunk(None, "hmc.adapt", chunks=W):
            while not loop.frozen:
                if loop.max_chunks is not None \
                        and loop.n_chunks >= loop.max_chunks:
                    break
                acc_rate, ge = loop.step()
                profiling.count("adapt_chunks")
                profiling.count("adapt_grad_evals", ge)
                n_chunks = loop.n_chunks
                da = dual_averaging_update(da, acc_rate)
                loop.dt = float(np.exp(da["log_eps"]))
                if self.adapt_mass and n_chunks == w1:
                    # open the first Welford window: discard the initial
                    # transient's moments
                    loop.carry = loop.carry[:8] + lay.zero_moments(dtype,
                                                                   device)
                if self.adapt_mass and n_chunks in metric_switches:
                    # inverse mass = pooled per-chain variance of THIS
                    # window with Stan's shrinkage toward unity
                    cnt = loop.carry[10]
                    m2 = lay.chain_sum(loop.carry[9].sum(0))
                    pooled = dict(m2=m2 / C, count=cnt)
                    var = shrink(welford_variance(pooled, regularize=False),
                                 cnt * C)
                    new_inv_mass = torch.clamp(var, min=1e-12)
                    med_std = float(median(torch.sqrt(
                        lay.full_cells(new_inv_mass))))
                    if loop.inv_mass is None:
                        # first switch: the kinetic changes from the
                        # Sigma-scaled identity to the diagonal metric;
                        # re-seed dt at a matched position-step scale
                        # (dx ~ dt*Sigma before, dt*std after)
                        loop.dt = float(np.clip(
                            loop.dt * float(self.Sigma)
                            / max(med_std, 1e-30), 1e-10, 1e6))
                    loop.inv_mass = new_inv_mass
                    da = dual_averaging_init(loop.dt,
                                             target=self.adapt_target)
                    # fresh Welford window for the next (longer) estimate
                    loop.carry = loop.carry[:8] + lay.zero_moments(dtype,
                                                                   device)
                    profiling.count("metric_switches")
                    if loop.talk:
                        print(f"adapted diagonal mass at chunk {n_chunks} "
                              f"(median std {med_std:.4g}); re-tuning dt "
                              f"from {loop.dt:.5g}", flush=True)
                if n_chunks == W:
                    with profiling.span("hmc.freeze"):
                        loop.dt = float(np.exp(da["log_eps_avg"]))
                        loop.frozen = True
                        # every stored sample comes from the frozen
                        # kernel: restart the accept and throughput
                        # counters; nothing reads the Welford moments any
                        # more
                        loop.carry = _restart_counts(loop.carry)[:8]
                        loop.acc_min, loop.acc_sum, loop.attempted = 0, 0, 0
                        loop.store_iters = 0
                    if loop.talk:
                        print(f"warmup done at chunk {n_chunks}: frozen "
                              f"dt={loop.dt:.5g}; sample storage reset",
                              flush=True)
                loop.after_chunk()

    def sample(self, nsamples, ndraws, max_chunks=None, callback=None,
               checkpoint_path=None, checkpoint_every=20, resume=True,
               draws=None):
        """Run until every chain has stored ``nsamples`` samples after
        ``ndraws`` warm-up ones (counted in accepted states, or in
        iterations under ``store_mode='chain'``), after the warmup
        adaptation when it is on.

        The warmup follows the JAX package's ``sample`` step for step
        (:func:`warmup_schedule`): each chunk's mean accept rate updates
        the dual-averaged dt (:mod:`.nuts`); under ``adapt_mass`` the
        Welford moments restart at w1 and at every metric switch, where
        the inverse mass becomes the chains' pooled variance of that window
        with Stan's shrinkage, and the first switch re-seeds dt at
        ``dt * Sigma / median(std)``; at W dt freezes at the averaged
        iterate and the accept counters and storage restart, so every
        stored sample comes from the frozen kernel; after the freeze, a
        chunk accepting less than a quarter of the target while some chain
        has stored nothing halves dt and restarts them again.

        ``callback(nacc, x)`` is called after every chunk with the
        per-chain accept counts (int64 numpy) and the chains' state tensor
        (one host read a chunk, made only when a callback is given).
        ``checkpoint_path`` snapshots the carry (``checkpoint.py``, the
        JAX package's ``.npz`` layout) every ``checkpoint_every`` chunks
        once the kernel is frozen and at the end, and with ``resume``
        continues from an existing snapshot exactly as the uninterrupted
        run would have gone on (a chunk's draws depend only on the seed
        and the chunk index); a snapshot of another configuration raises
        ``ValueError``. Under adaptation the snapshot also stores the
        frozen kernel (``step_size``, ``frozen``, ``inv_mass``: keys the
        JAX package's ``load_state`` does not read) and a resumed run
        restores it. The JAX package does not store it and re-adapts on
        resume, from a chunk index past its freeze, so that its resumed
        run never freezes and stores nothing; here a snapshot without it
        (the JAX package's) or taken before the freeze is refused with a
        ``ValueError``. Under ``adapt_mass`` the snapshot keeps the JAX
        package's 11 leaves, the Welford moments (no longer read after the
        freeze) written as zeros.

        Returns a dict like the JAX package's; ``samples``, ``misfits``,
        ``inv_mass`` and the chains' final state ``x`` are tensors on
        ``device``, and the ESS is computed
        there (:func:`~gravinv3dhmc_tpu_torch.diagnostics.ess_torch`, its
        median as ``np.median`` takes it). ``step_size`` is the frozen dt.
        With ``write_files`` the buffers are copied to the host once and
        chain c's ``n_stored[c]`` rows written to
        ``<save_folder><myrank + c>/`` (``folders``).
        ``draws`` is an optional draw source (see the module docstring).

        Under ``spmd_mesh`` every rank runs this loop on its block of the
        chains and cells, and every number that steers it is global and
        equal on every rank: each chunk's read (finite flags, accepts, grad
        evals, the accept counts' minimum and sum, global chain 0's
        misfits) is reduced over the ``chains`` group, the metric switch
        pools ``m2`` over all chains and takes the median over all M cells,
        the ESS reads the same 128 global cells; so dual averaging gives
        every rank the same dt. ``write_files`` and ``checkpoint_path``
        write the global layout from rank 0 (an unsharded run's files),
        and a snapshot resumes sharded or not, either way. ``accepted``,
        ``n_stored``, ``accept_ratio``, ``attempted``, ``grad_evals``,
        ``step_size``, ``inv_mass`` and ``ess_median`` are global;
        ``samples``, ``misfits``, ``x`` and ``U`` are this rank's blocks,
        whose chain and cell ranges ``shard`` gives (``{"chains": [c0,
        c1], "cells": [m0, m1]}``): one deliberate difference from the JAX
        package, whose arrays are global. ``callback`` gets this rank's
        counts and block; ``folders`` is rank 0's.
        """
        run_chunk, carry = self.prepare(nsamples, ndraws, draws=draws)
        C = self.nchains
        M = self.initial_model.shape[-1]
        total = nsamples + ndraws
        mesh = self.spmd_mesh
        lay = _Layout(mesh, C, M, self.adapt_mass)
        device = carry[0].device
        adapting = self.adapt_step_size or self.adapt_mass
        W = warmup_schedule(self.adapt_chunks, self.adapt_step_size,
                            self.adapt_mass)[0]
        if max_chunks is None:
            max_chunks = max(200, 100 * total // self.chunk_size + 10) + W

        ckpt_meta = {"nsamples": nsamples, "ndraws": ndraws, "nchains": C,
                     "M": M, "seed": self.seed, "myrank": self.myrank,
                     "store_mode": self.store_mode,
                     "adapt": [bool(self.adapt_step_size),
                               bool(self.adapt_mass),
                               int(self.adapt_chunks)]}
        loop = _ChunkLoop(self, run_chunk, carry, lay, nsamples, ndraws,
                          max_chunks)
        loop.frozen = not adapting
        loop.checkpoint_path = checkpoint_path
        if checkpoint_path and resume and os.path.exists(checkpoint_path):
            loop.carry, loop.n_chunks, _, meta = lay.load(checkpoint_path,
                                                          carry)
            meta = dict(meta)
            loop.store_iters = int(meta.pop("store_iters", 0))
            meta.setdefault("store_mode", "accepted")
            if meta != ckpt_meta:
                raise ValueError(
                    f"checkpoint config mismatch: {meta} != {ckpt_meta}")
            if adapting:
                loop.dt, inv_mass = _frozen_kernel(
                    checkpoint_path, loop.n_chunks, self.adapt_mass,
                    self.dtype, device)
                loop.inv_mass = lay.cells(inv_mass)
                loop.frozen = True
                loop.carry = loop.carry[:8]
            if lay.lead and self.verbose:
                print(f"resumed from {checkpoint_path} at chunk "
                      f"{loop.n_chunks}", flush=True)

        def snapshot():
            leaves = loop.carry
            if self.adapt_mass and len(leaves) == 8:
                leaves = leaves + lay.zero_moments(self.dtype, device)
            extra = {"step_size": np.float64(loop.dt),
                     "frozen": np.bool_(loop.frozen)}
            if loop.inv_mass is not None:
                extra["inv_mass"] = lay.full_cells(
                    loop.inv_mass).cpu().numpy()
            # under a mesh every rank gathers the global leaves and rank 0
            # writes the unsharded layout
            leaves = lay.full_carry(leaves)
            if lay.lead:
                save_state(checkpoint_path, leaves, loop.n_chunks,
                           philox.salt_from_seed(loop.seed),
                           meta=dict(ckpt_meta,
                                     store_iters=loop.store_iters),
                           extra=extra)

        def after_chunk():
            if callback is not None:
                callback(loop.carry[5].cpu().numpy().astype(np.int64),
                         loop.carry[0])
            if (checkpoint_path and loop.frozen
                    and loop.n_chunks % checkpoint_every == 0):
                snapshot()

        loop.after_chunk = after_chunk
        t0 = time.time()
        loop.read_counts()
        if not loop.frozen:
            self._warmup(loop)
        while not (loop.storage_done() and loop.frozen):
            if loop.n_chunks >= max_chunks:
                if lay.lead:
                    print(f"WARNING: stopping after {loop.n_chunks} chunks "
                          f"with min accepted count {loop.acc_min}")
                break
            acc_rate, _ = loop.step()
            if (adapting and loop.acc_min == 0
                    and acc_rate < 0.25 * self.adapt_target):
                # emergency brake: the frozen dt rejects (almost)
                # everything and some chain has stored nothing yet --
                # halve dt and restart the counters so storage stays
                # consistent with one kernel
                loop.dt *= 0.5
                loop.carry = _restart_counts(loop.carry)
                loop.attempted, loop.acc_sum = 0, 0
                loop.store_iters = 0
                if loop.talk:
                    print(f"post-freeze accept {acc_rate:.2%} -- halving "
                          f"dt to {loop.dt:.5g}", flush=True)
            after_chunk()
        if checkpoint_path:
            snapshot()
        elapsed = time.time() - t0

        carry, dt_cur, inv_mass = loop.carry, loop.dt, loop.inv_mass
        store_iters, attempted = loop.store_iters, loop.attempted
        grad_evals = loop.grad_evals
        accepted = lay.full_chains(carry[5]).cpu().numpy().astype(np.int64)
        if self.store_mode == "chain":
            done_iters = max(store_iters - ndraws, 0)
            n_stored = np.full(
                C, min((done_iters + self.store_thin - 1)
                       // self.store_thin, nsamples), dtype=np.int64)
        else:
            n_stored = np.minimum(np.maximum(accepted - ndraws, 0),
                                  nsamples)
        n_common = int(n_stored.min())
        ess_median = ess_per_s = None
        if n_common >= 8:
            from ..diagnostics import ess_torch
            sub = np.random.RandomState(0).choice(M, size=min(M, 128),
                                                  replace=False)
            ess = ess_torch(lay.sampled_cells(carry[6], n_common, sub))
            ess_median = float(median(ess))
            ess_per_s = ess_median / max(elapsed, 1e-9)
        folders = []
        if self.write_files:
            # one copy of each buffer to the host (under a mesh the global
            # buffers, written by rank 0)
            models = lay.full(carry[6], "buf_m")
            misfits = lay.full(carry[7], "buf_k")
            if lay.lead:
                folders = write_chains(
                    self.save_folder, self.myrank,
                    models.cpu().numpy().astype(np.float64),
                    misfits.cpu().numpy().astype(np.float64), n_stored)
        out = {
            "samples": carry[6],
            "misfits": carry[7],
            "x": carry[0],
            "U": carry[1],
            "n_stored": n_stored,
            "folders": folders,
            "accepted": accepted.tolist(),
            "attempted": attempted,
            "accept_ratio": float(accepted.sum()) / max(attempted, 1),
            "elapsed_s": elapsed,
            "grad_evals": grad_evals,
            "grad_evals_per_s": grad_evals / max(elapsed, 1e-9),
            "step_size": dt_cur,
            "adapted_mass": inv_mass is not None,
            "inv_mass": (lay.full_cells(inv_mass) if inv_mass is not None
                         else None),
            "ess_median": ess_median,
            "ess_per_s_median": ess_per_s,
            "fused_mode": self._fused_mode,
        }
        if mesh is not None:
            out["shard"] = {"chains": [lay.c0, lay.c1],
                            "cells": [lay.m0, lay.m1]}
        return out


def _frozen_kernel(path, n_chunks, adapt_mass, dtype, device):
    """``(dt, inv_mass)`` of the frozen kernel an adaptive run's snapshot
    stores; ``ValueError`` for a snapshot without it (the JAX package's)
    or taken before the kernel froze."""
    extra = load_extra(path)
    need = ("step_size", "frozen") + (("inv_mass",) if adapt_mass else ())
    missing = [k for k in need if k not in extra]
    if missing:
        raise ValueError(
            f"{path} has no frozen kernel ({', '.join(missing)} missing): "
            "an adaptive run resumes only from a snapshot that stores its "
            "frozen step size and metric (the JAX package's snapshots do "
            "not, and resuming one would re-adapt past the freeze)")
    if not bool(extra["frozen"]):
        raise ValueError(
            f"{path} was taken at chunk {n_chunks}, during the warmup: "
            "the warmup's adaptation state is not snapshotted; rerun "
            "without resume")
    inv_mass = (torch.as_tensor(extra["inv_mass"], dtype=dtype,
                                device=device) if adapt_mass else None)
    return float(extra["step_size"]), inv_mass


class Frozen:
    """The kernel the windowed warmup froze and the chains it warmed
    (:meth:`HamiltonianMC.adapt`): ``run_chunk`` (the sampler's chunk
    runner), ``carry`` (the warmed chains, accept counts at 0, no Welford
    moments), ``dt`` (the frozen step size), ``inv_mass`` (the diagonal
    inverse mass as a tensor of the sampler's dtype on its device, or
    None), ``seed`` (the run's Philox seed), ``n_chunks`` (the chunks the
    warmup ran: the first frozen chunk's index) and ``grad_evals`` (the
    warmup's gradient evaluations). ``inv_mass`` is the same tensor on
    every call, so frozen chunks replay from CUDA graphs where the chunk
    runner captures them."""

    __slots__ = ("run_chunk", "carry", "dt", "inv_mass", "seed", "n_chunks",
                 "grad_evals")

    def __init__(self, run_chunk, carry, dt, inv_mass, seed, n_chunks,
                 grad_evals):
        self.run_chunk, self.carry = run_chunk, carry
        self.dt, self.inv_mass, self.seed = dt, inv_mass, seed
        self.n_chunks, self.grad_evals = n_chunks, grad_evals

    def run(self, carry, chunk_idx, store_base=0):
        """Frozen chunk ``chunk_idx`` from ``carry``: ``(carry, stats)``,
        as :meth:`HamiltonianMC.sample` issues it after the freeze
        (``store_base`` the iterations stored before it)."""
        return self.run_chunk(carry, self.seed, chunk_idx, dt=self.dt,
                              inv_mass=self.inv_mass, store_base=store_base)


class _ChunkLoop:
    """The state :meth:`HamiltonianMC.sample`'s chunk loop and its warmup
    share: the carry, the chunk count, the kernel (``dt``, ``inv_mass``,
    ``frozen``), the accept, storage and throughput counters. :meth:`step`
    issues one chunk with the bookkeeping every chunk gets;
    ``after_chunk`` (a no-op unless set) follows every chunk."""

    def __init__(self, hmc, run_chunk, carry, lay, nsamples, ndraws,
                 max_chunks=None):
        self.hmc, self.run_chunk, self.carry, self.lay = (hmc, run_chunk,
                                                          carry, lay)
        self.C = hmc.nchains
        self.M = hmc.initial_model.shape[-1]
        self.total = nsamples + ndraws
        self.chain_mode = hmc.store_mode == "chain"
        self.chain_span = ndraws + nsamples * hmc.store_thin
        self.max_chunks = max_chunks
        #: named in the error of a chunk with a non-finite potential
        self.checkpoint_path = None
        self.seed = hmc.seed + hmc.myrank
        self.talk = hmc.verbose and lay.lead
        self.n_chunks = self.store_iters = 0
        self.attempted = self.grad_evals = 0
        self.acc_min = self.acc_sum = 0
        self.dt = float(hmc.dt)
        self.inv_mass = None
        self.frozen = True
        self.after_chunk = lambda: None

    def read_counts(self):
        self.acc_min, self.acc_sum = self.lay.counts(self.carry[5])

    def storage_done(self):
        return (self.store_iters >= self.chain_span) if self.chain_mode \
            else (self.acc_min >= self.total)

    def step(self):
        """Issue chunk ``n_chunks`` (storing only once frozen) and count
        it: ``(acc_rate, grad_evals)``, the chunk's mean accept rate and
        gradient evaluations."""
        hmc, lay, C = self.hmc, self.lay, self.C
        counted = self.frozen  # this chunk runs with storage active
        self.carry, stats = self.run_chunk(
            self.carry, self.seed, self.n_chunks, dt=self.dt,
            inv_mass=self.inv_mass,
            store_base=self.store_iters if self.frozen else STORE_OFF)
        # one host read a chunk: a stacked reduction (under a mesh made
        # global over the chains group first)
        reduced = lay.chunk_read(torch.stack([
            torch.isfinite(stats).all().to(torch.float64),
            stats[..., 4].sum(dtype=torch.float64),
            stats[..., 0].sum(dtype=torch.float64),
            self.carry[5].min().to(torch.float64),
            self.carry[5].sum(dtype=torch.float64),
            stats[-1, 0, 2].to(torch.float64),
            stats[-1, 0, 3].to(torch.float64)])).tolist()
        finite, ge, acc_chunk, amin, asum, ud_l, um_l = reduced
        if not finite:
            bad = torch.nonzero(
                ~torch.isfinite(stats[..., 1]).all(dim=0)).flatten()
            bad = (bad + lay.c0).tolist()
            path = self.checkpoint_path
            raise FloatingPointError(
                f"non-finite potential in chains {bad} at "
                f"chunk {self.n_chunks} (dt={hmc.dt}, Sigma={hmc.Sigma}); "
                "reduce the step size or check the kernel matrix. "
                + (f"Last good state: {path}" if path else
                   "Set checkpoint_path to make such runs resumable."))
        # the chunk's mean accept as the JAX package's f32 mean
        acc_rate = float(np.float32(acc_chunk)
                         / np.float32(stats.shape[0] * C))
        self.acc_min, self.acc_sum = int(amin), int(asum)
        self.n_chunks += 1
        self.attempted += hmc.chunk_size * C
        self.grad_evals += int(ge)
        if counted:
            self.store_iters += hmc.chunk_size
        if self.talk:
            frac = (min(self.store_iters / self.chain_span, 1.0)
                    if self.chain_mode
                    else min(self.acc_min / self.total, 1.0))
            print("chain {}: {:.2%}, misfit(total, data, alpha, model)="
                  "({:.7f},{:.7f},{:.2f},{:.7f}) -- accept ratio {:.2%}"
                  .format(hmc.myrank, frac,
                          ud_l / hmc.dobs.shape[0]
                          + hmc.RegulFactor * um_l / self.M,
                          ud_l / hmc.dobs.shape[0], hmc.RegulFactor,
                          um_l / self.M, self.acc_sum / self.attempted),
                  flush=True)
        return acc_rate, int(ge)


class _Layout:
    """Where :meth:`HamiltonianMC.sample`'s state lives: the whole batch
    (``mesh`` None: every method is the identity or the plain reduction)
    or this rank's block of a (chains, model) mesh, whose methods make the
    global numbers every rank needs, each with the collectives of
    :mod:`..parallel.sharded`."""

    def __init__(self, mesh, C, M, welford):
        self.mesh, self.C, self.M = mesh, C, M
        self.c0, self.c1, self.m0, self.m1 = 0, C, 0, M
        self.lead = True
        if mesh is not None:
            from ..parallel import sharded
            self.sh = sharded
            self.c0, self.c1 = mesh.chain_range(C)
            self.m0, self.m1 = mesh.col_range(M)
            self.lead = mesh.rank == 0
            self.specs = sharded.carry_shardings(mesh, welford=welford)

    def zero_moments(self, dtype, device):
        return _zero_moments(self.c1 - self.c0, self.m1 - self.m0, dtype,
                             device)

    def counts(self, nacc):
        """The global ``(min, sum)`` of the accept counts."""
        if self.mesh is None:
            return int(nacc.min()), int(nacc.sum())
        mn = self.mesh.all_reduce(nacc.min().to(torch.float64).reshape(1),
                                  "chains", op="min")
        sm = self.mesh.all_reduce(nacc.sum(dtype=torch.float64).reshape(1),
                                  "chains")
        return int(mn), int(sm)

    def chunk_read(self, r):
        """A chunk's ``[finite, grad evals, accepts, min count, sum count,
        ud, um]`` over all chains (ud and um of global chain 0): the sums
        in one ``all_reduce`` over ``chains``, the minimum in another."""
        if self.mesh is None:
            return r
        mesh = self.mesh
        first = 1.0 if mesh.coords[0] == 0 else 0.0
        sums = torch.stack([r[0], r[1], r[2], r[4], r[5] * first,
                            r[6] * first])
        mesh.all_reduce(sums, "chains")
        amin = mesh.all_reduce(r[3].reshape(1).clone(), "chains", op="min")
        finite = (sums[0] == mesh.shape["chains"]).to(sums.dtype)
        return torch.stack([finite, sums[1], sums[2], amin[0], sums[3],
                            sums[4], sums[5]])

    def chain_sum(self, t):
        """``t`` (a sum over this rank's chains) summed over all chains."""
        return t if self.mesh is None else self.mesh.all_reduce(t, "chains")

    def cells(self, v):
        """This rank's cells of a global (M,) vector."""
        return v if self.mesh is None else v[self.m0:self.m1]

    def full_cells(self, v):
        """The global (M,) vector of this rank's cells ``v``."""
        if self.mesh is None:
            return v
        return self.sh.gather(self.mesh, v, ("model",), self.M)

    def full_chains(self, v):
        """The global (C,) vector of this rank's chains' ``v``."""
        if self.mesh is None:
            return v
        return self.sh.gather(self.mesh, v, ("chains",))

    def full(self, t, leaf):
        """The global ``buf_m`` (C, N, M) or ``buf_k`` (C, N, 7)."""
        if self.mesh is None:
            return t
        spec = self.sh.BUF_M_SPEC if leaf == "buf_m" else self.sh.BUF_K_SPEC
        return self.sh.gather(self.mesh, t, spec, self.M)

    def full_carry(self, carry):
        """The global carry (the unsharded run's leaves)."""
        if self.mesh is None:
            return carry
        return tuple(self.sh.gather(self.mesh, leaf, spec, self.M)
                     for leaf, spec in zip(carry, self.specs))

    def load(self, path, carry):
        """``load_state`` of a snapshot of the global carry, each leaf cut
        to this rank's block on ``carry``'s devices and types."""
        if self.mesh is None:
            return load_state(path, like_carry=carry)
        leaves, n_chunks, key, meta = load_state(path)
        if len(leaves) != len(carry):
            raise ValueError(
                f"checkpoint has {len(leaves)} leaves, expected "
                f"{len(carry)} — config mismatch?")
        out = tuple(self.sh.shard(self.mesh, leaf, spec).to(
            device=r.device, dtype=r.dtype).contiguous()
            for leaf, spec, r in zip(leaves, self.specs, carry))
        return out, n_chunks, key, meta

    def sampled_cells(self, buf_m, n, sub):
        """``buf_m[:, :n, sub]`` of the global buffer, on every rank: each
        rank writes its chains' rows of the sampled cells it holds into a
        zero-filled (C, n, len(sub)) buffer, one ``all_reduce`` over all
        ranks."""
        if self.mesh is None:
            return buf_m[:, :n, torch.as_tensor(sub, device=buf_m.device)]
        pos = np.flatnonzero((sub >= self.m0) & (sub < self.m1))
        out = buf_m.new_zeros((self.C, n, len(sub)))
        cols = torch.as_tensor(sub[pos] - self.m0, device=buf_m.device)
        out[self.c0:self.c1, :, torch.as_tensor(pos, device=buf_m.device)] \
            = buf_m[:, :n, cols]
        return self.mesh.all_reduce(out, ("chains", "model"))


def _zero_moments(C, M, dtype, device):
    """A fresh Welford window: ``(w_mean, w_m2, w_count)`` at zero."""
    return tuple(welford_init((C, M), dtype, device).values())


def _restart_counts(carry):
    """``carry`` with its per-chain accept counts set to 0."""
    return carry[:5] + (torch.zeros_like(carry[5]),) + carry[6:]


# reference-compatible misspelled alias (inversion/hmc.py:29)
HamitonianMC = HamiltonianMC


def HMCSample(model, nsamples, ndraws, delta, Lrange, initial_model,
              aprior_model, boundaries, constraint, log_factor, dobs,
              adaptiveRegul=None, RegulRate=None, RegulFactor=1.0,
              regularization="Damping", beta=0.01, seed=100, Sigma=1.0,
              nbest=100, myrank=0, save_folder="mychain", plotsamples=False,
              im=(0, 0), nchains=1, chunk_size=64, dtype=torch.float32,
              verbose=True, write_files=True, adapt_step_size=False,
              adapt_target=0.8, adapt_mass=False, adapt_chunks=10,
              shared_L=False, use_fused=False, transfer_samples=True,
              store_mode="accepted", store_thin=1, spmd_mesh=None,
              jacobian=False, temperature=1.0, device=None):
    """Reference-compatible chain factory, as the JAX package's
    ``HMCSample`` (reference: inversion/hmc.py:358-403): configures a
    :class:`HamiltonianMC` (seed ``seed + myrank``, the box, start and a
    priori model moved to the weighted domain) and returns its
    ``sample(nsamples, ndraws)``. ``nchains`` chains write
    ``save_folder{myrank + c}/`` when ``write_files``. ``dtype`` is a torch
    dtype and ``device`` the chains' (``cuda:0`` when None).
    ``adaptiveRegul``, ``RegulRate``, ``nbest``, ``plotsamples`` and ``im``
    are accepted for parity and unused, as there.
    """
    chain = HamiltonianMC(model)
    chain.myrank = myrank
    chain.save_folder = save_folder
    chain.seed = seed + myrank
    chain.constraint = constraint
    chain.log_factor = log_factor
    chain.Lrange = list(Lrange)
    chain.dt = delta
    chain.Sigma = Sigma
    chain.RegulFactor = RegulFactor
    chain.regularization = regularization
    chain.beta = beta
    chain.nchains = nchains
    chain.chunk_size = chunk_size
    chain.dtype = dtype
    chain.device = device
    chain.verbose = verbose
    chain.write_files = write_files
    chain.adapt_step_size = adapt_step_size
    chain.adapt_target = adapt_target
    chain.adapt_mass = adapt_mass
    chain.adapt_chunks = adapt_chunks
    chain.shared_L = shared_L
    chain.use_fused = use_fused
    chain.transfer_samples = transfer_samples
    chain.store_mode = store_mode
    chain.store_thin = store_thin
    chain.spmd_mesh = spmd_mesh
    chain.jacobian = jacobian
    chain.temperature = temperature

    boundaries = np.asarray(boundaries, dtype=np.float64)
    if torch.is_tensor(model.wdiag):
        # weights on the card (a matrix built there): the box, the start
        # (possibly a warm start on the card) and the a priori model are
        # scaled there, in float64 as the JAX package promotes them
        wdiag = model.wdiag.double()

        def as_vec(v):
            return as_tensor(v, torch.float64, wdiag.device)
    else:
        wdiag = np.asarray(model.wdiag)

        def as_vec(v):
            return np.asarray(v, dtype=np.float64)
    # m-domain -> mw-domain (reference: inversion/hmc.py:393-401)
    chain.low = wdiag * as_vec(boundaries[:, 0])
    chain.high = wdiag * as_vec(boundaries[:, 1])
    chain.initial_model = wdiag * as_vec(initial_model)
    chain.aprior_model = wdiag * as_vec(aprior_model)
    chain.dobs = np.asarray(dobs, dtype=np.float64)
    return chain.sample(nsamples, ndraws)
