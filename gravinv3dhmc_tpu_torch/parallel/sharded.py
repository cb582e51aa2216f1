"""Multi-device sharded HMC: chains x model-column partitioning, on
``torch.distributed``.

Counterpart of ``gravinv3dhmc_tpu/parallel/sharded.py``, same public
names. The reference's only parallelism is embarrassingly-parallel MPI
ranks that each rebuild the full kernel matrix (reference: run_main.sh:18).
Here the two scale axes map onto a 2-D (chains, model) mesh of ranks, one
device a rank:

* ``chains`` -- data parallelism: each rank holds a contiguous slice of
  the chain batch (replaces mpiexec ranks);
* ``model`` -- tensor parallelism: each rank holds the columns
  ``Aw[:, m0:m1]`` of the weighted sensitivity matrix, so the predicted
  data ``x @ Aw.T`` is a partial sum combined by one ``all_reduce`` over
  the ``model`` group, and the adjoint ``r @ Aw`` needs no collective (the
  gradient's columns live where the matrix's columns live).

Where GSPMD inserts the JAX package's collectives, this module writes them
out, each as an ``all_reduce`` over one of the mesh's two subgroups (or
all ranks), one of the two collectives both backends take on CUDA
tensors (:mod:`.multihost`): a gather is an ``all_reduce`` of a
zero-filled buffer in which each rank writes its block, the z halo of the
grid regularizers an ``all_reduce`` of a plane buffer, a value one rank
holds (global chain 0's misfits) a sum to which the others add zeros.

The column split (:func:`column_bounds`) is contiguous in the packed cell
index, each boundary rounded up to a multiple of 4 (the ``draws`` kernel
draws four normals a Philox counter, so a shard's first cell must start a
counter's group); the last shard takes the rest. For a full grid whose
nz the ``model`` axis tiles (and whose planes hold a multiple of 4
cells) the boundaries fall on z planes, the layout under which the JAX
package shards the grid.

The fused kernels are not offered here, as in the JAX package: a
whole-matrix kernel would force an all-gather of the column-sharded matrix
onto every rank. The products ``x @ A_local.T`` and ``r @ A_local`` are
``torch.matmul``, as the JAX sharded path's are plain XLA dots; the
kernel on this path is ``draws``, launched on each rank's block at its
offsets.

A mesh made while no process group is up must be of one rank: its
collectives are then the identity.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..inversion import hmc as hmc_mod
from ..inversion.potential import Potential, model_value_and_grad
from ..ops import fd
from . import multihost

AXES = ("chains", "model")

#: the carry leaves' specs (:func:`carry_shardings`): which dims are split
#: over which mesh axis, as the JAX package's PartitionSpecs
X_SPEC = ("chains", "model")
CHAIN_SPEC = ("chains",)
BUF_M_SPEC = ("chains", None, "model")
BUF_K_SPEC = ("chains", None)
REPLICATED = ()


def mesh_shape(n_devices, chains_axis=None):
    """``(chains, model)`` of an ``n_devices`` mesh: ``chains_axis``
    defaults to the largest power of two that divides ``n_devices`` and is
    at most its square root (the JAX rule, favouring model sharding for
    memory relief): 1 -> (1, 1), 2 -> (1, 2), 4 -> (2, 2), 8 -> (2, 4)."""
    n = int(n_devices)
    if chains_axis is None:
        chains_axis = 1
        while (n % (chains_axis * 2) == 0
               and chains_axis * 2 <= int(np.sqrt(n))):
            chains_axis *= 2
    if n % chains_axis:
        raise ValueError(f"chains_axis {chains_axis} does not divide "
                         f"{n} devices")
    return int(chains_axis), n // int(chains_axis)


def column_bounds(M, n_model):
    """The ``n_model + 1`` boundaries of the column split of ``M`` cells:
    shard k holds cells ``[b[k], b[k+1])``; each inner boundary is
    ``ceil(k M / n_model)`` rounded up to a multiple of 4 (at most M)."""
    M, n = int(M), int(n_model)
    inner = [min(M, _round_up(-(-k * M // n), 4)) for k in range(1, n)]
    return [0, *inner, M]


def _round_up(x, m):
    return -(-x // m) * m


class Mesh:
    """A (chains, model) mesh of ranks and this rank's place in it.

    Rank k sits at ``(k // n_model, k % n_model)``, as the JAX package
    lays out devices. ``groups`` holds the two subgroups this rank
    belongs to: ``model`` (the ranks that share its chains) and
    ``chains`` (the ranks that share its columns), None without a process
    group. ``device`` is this rank's device.
    """

    axis_names = AXES

    def __init__(self, chains_axis, model_axis, rank=0, groups=None,
                 device=None):
        self.shape = {"chains": int(chains_axis), "model": int(model_axis)}
        self.size = int(chains_axis) * int(model_axis)
        #: the ranks in mesh order, shaped (chains, model) like the JAX
        #: mesh's ``devices``
        self.devices = np.arange(self.size).reshape(chains_axis, model_axis)
        self.rank = int(rank)
        self.coords = (self.rank // int(model_axis),
                       self.rank % int(model_axis))
        self.groups = groups
        self.device = None if device is None else torch.device(device)

    def __repr__(self):
        return (f"Mesh(chains={self.shape['chains']}, "
                f"model={self.shape['model']}, rank={self.rank})")

    def chain_range(self, C):
        """``(c0, c1)``: this rank's chains of a batch of ``C``, which
        must tile the ``chains`` axis."""
        n = self.shape["chains"]
        if C % n:
            raise ValueError(f"nchains {C} must tile the 'chains' mesh "
                             f"axis ({n})")
        per = C // n
        return self.coords[0] * per, (self.coords[0] + 1) * per

    def col_range(self, M):
        """``(m0, m1)``: this rank's cells of ``M`` (:func:`column_bounds`)."""
        b = column_bounds(M, self.shape["model"])
        k = self.coords[1]
        return b[k], b[k + 1]

    def _group(self, axes):
        axes = tuple(a for a in axes if a is not None)
        if self.groups is None or not axes:
            return None
        if set(axes) == set(AXES):
            return dist.group.WORLD
        return self.groups[axes[0]]

    def all_reduce(self, t, axes, op="sum"):
        """``t`` reduced in place over the ranks that differ only along
        ``axes`` ("model", "chains" or both); ``op`` is "sum", "min" or
        "max". The identity on a mesh without a process group."""
        group = self._group((axes,) if isinstance(axes, str) else axes)
        if group is not None:
            dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                                   "min": dist.ReduceOp.MIN,
                                   "max": dist.ReduceOp.MAX}[op],
                            group=group)
        return t


def make_mesh(n_devices=None, chains_axis=None, devices=None):
    """Build the (chains, model) mesh over the process group's ranks.

    ``n_devices`` must be the group's size (all of its ranks; 1 without a
    process group, the default then). ``chains_axis`` as
    :func:`mesh_shape`. ``devices`` gives each rank's device in rank order
    (default: :func:`.multihost.local_device` of each rank, resolved when
    a sampler first asks). Every rank must call this with the same
    arguments: it makes the subgroups with ``dist.new_group``, which every
    rank joins in the same order.
    """
    world = multihost.world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(
            f"a mesh of {n} devices needs a process group of {n} ranks "
            f"(this one has {world}; see parallel.multihost.initialize)")
    nc, nm = mesh_shape(n, chains_axis)
    rank = multihost.rank()
    device = None if devices is None else devices[rank]
    groups = None
    if dist.is_initialized():
        ranks = np.arange(n).reshape(nc, nm)
        groups = {}
        for i in range(nc):
            g = dist.new_group([int(r) for r in ranks[i, :]])
            if rank // nm == i:
                groups["model"] = g
        for j in range(nm):
            g = dist.new_group([int(r) for r in ranks[:, j]])
            if rank % nm == j:
                groups["chains"] = g
    return Mesh(nc, nm, rank, groups, device)


def mesh_device(mesh, device=None):
    """The device a sharded builder puts this rank's tensors on:
    ``device``, else the mesh's, else :func:`.multihost.local_device`."""
    if device is not None:
        return torch.device(device)
    if mesh.device is not None:
        return mesh.device
    return multihost.local_device()


# --------------------------------------------------------------- layouts

def _slices(mesh, spec, shape):
    """The index of this rank's block of a global array of ``shape``."""
    out = []
    for d, axis in enumerate(spec):
        if axis == "chains":
            out.append(slice(*mesh.chain_range(shape[d])))
        elif axis == "model":
            out.append(slice(*mesh.col_range(shape[d])))
        else:
            out.append(slice(None))
    return tuple(out)


def shard(mesh, global_tensor, spec):
    """This rank's block of ``global_tensor`` under ``spec`` (a tuple of
    "chains", "model" or None per leading dim; ``()`` replicated)."""
    return global_tensor[_slices(mesh, spec, global_tensor.shape)]


def gather(mesh, local_tensor, spec, M=None):
    """The global tensor of which ``local_tensor`` is this rank's block
    under ``spec``, on every rank: an ``all_reduce`` of a zero-filled
    buffer in which each rank writes its block. ``M`` is the global size
    of a "model" dim (the column split is uneven); a "chains" dim is the
    local size times the axis."""
    shape = list(local_tensor.shape)
    for d, axis in enumerate(spec):
        if axis == "chains":
            shape[d] *= mesh.shape["chains"]
        elif axis == "model":
            if M is None:
                raise ValueError("gather of a 'model' dim needs M")
            shape[d] = int(M)
    axes = tuple(a for a in spec if a is not None)
    if not axes or mesh.groups is None:
        return local_tensor
    dtype = local_tensor.dtype
    # integer and boolean blocks travel as float64 (exact below 2^53): the
    # collectives here reduce floating tensors only
    wide = dtype if dtype.is_floating_point else torch.float64
    buf = torch.zeros(shape, dtype=wide, device=local_tensor.device)
    buf[_slices(mesh, spec, shape)] = local_tensor.to(wide)
    mesh.all_reduce(buf, axes)
    return buf.to(dtype)


def carry_shardings(mesh, welford=False):
    """Each carry leaf's spec, positionally matching the chunk sampler's
    carry: chain state ``("chains", "model")``, per-chain scalars
    ``("chains",)``, the sample buffers ``("chains", None, "model")`` /
    ``("chains", None)``, and (``welford``) the running moments like the
    chain state with a replicated count ``()``: the JAX package's
    PartitionSpecs as tuples. ``mesh`` is accepted for the JAX signature;
    the specs do not depend on it."""
    del mesh
    specs = (X_SPEC, CHAIN_SPEC, X_SPEC, CHAIN_SPEC, CHAIN_SPEC, CHAIN_SPEC,
             BUF_M_SPEC, BUF_K_SPEC)
    if welford:
        specs = specs + (X_SPEC, X_SPEC, REPLICATED)
    return specs


# --------------------------------------------------------------- potential

def _halo_value_and_grad(mesh, name, dm, mshape, beta):
    """Smoothness/TV on this rank's z planes of the full grid: the first
    and last plane of every shard go to all ranks of the ``model`` group in
    one ``all_reduce`` of an ``(n_model, 2, C, ny, nx)`` buffer; each rank
    extends its planes by its neighbours' and keeps the differences whose
    lower plane it owns (so each difference is counted once over the
    group) and the gradient on its own planes (from every difference that
    touches them). Returns the partial value (C,) and the local gradient
    (C, Ml)."""
    _, ny, nx = mshape
    C = dm.shape[0]
    nzl = dm.shape[1] // (ny * nx)
    k, n = mesh.coords[1], mesh.shape["model"]
    g = dm.reshape(C, nzl, ny, nx)
    halo = dm.new_zeros((n, 2, C, ny, nx))
    halo[k, 0] = g[:, 0]
    halo[k, 1] = g[:, -1]
    mesh.all_reduce(halo, "model")
    parts = ([halo[k - 1, 1][:, None]] if k > 0 else []) + [g] + (
        [halo[k + 1, 0][:, None]] if k < n - 1 else [])
    ext = torch.cat(parts, dim=1)
    lo = 1 if k > 0 else 0
    nze = ext.shape[1]
    dx, dy, dz = fd.grid_diffs(ext.reshape(C, -1), (nze, ny, nx))
    own = slice(lo, lo + nzl)
    # the x and y differences of the own planes; z differences whose lower
    # plane is an own plane (the last one reaches the plane above)
    odx, ody, odz = dx[:, own], dy[:, own], dz[:, lo:]
    if name == "Smoothness":
        value = ((odx * odx).sum((1, 2, 3)) + (ody * ody).sum((1, 2, 3))
                 + (odz * odz).sum((1, 2, 3)))
        ex, ey, ez = 2.0 * dx, 2.0 * dy, 2.0 * dz
    else:
        rx, ry, rz = (torch.sqrt(d * d + beta) for d in (dx, dy, dz))
        value = (rx[:, own].sum((1, 2, 3)) + ry[:, own].sum((1, 2, 3))
                 + rz[:, lo:].sum((1, 2, 3)))
        ex, ey, ez = dx / rx, dy / ry, dz / rz
    grad = fd._adjoint(ex, ey, ez, (nze, ny, nx)).reshape(C, nze, ny, nx)
    return value, grad[:, own].reshape(C, nzl * ny * nx)


def grid_layout(mesh, M, mshape, active):
    """How a sharded Smoothness/TV evaluates its grid: "halo" when the
    grid is full, the ``model`` axis has more than one rank and every
    shard holds whole z planes (at least one), else "replicated" (the
    packed model gathered over ``model`` and the grid term computed on
    every rank, as the JAX package does for a carved mesh or an nz the
    axis does not tile)."""
    n = mesh.shape["model"]
    plane = int(mshape[1]) * int(mshape[2])
    b = column_bounds(M, n)
    full = active is None or bool(np.asarray(active).all())
    if (n > 1 and full and all(v % plane == 0 for v in b)
            and all(b1 > b0 for b0, b1 in zip(b, b[1:]))):
        return "halo"
    return "replicated"


def make_sharded_potential(mesh, Aw, dobs, aprior_mw, low, high,
                           grav_fix=None, regularization="Damping",
                           beta=0.01, wm_sq=None, mshape=None, active=None,
                           dtype=torch.float32, device=None):
    """Sharded potential-energy closure: ``(Potential, shardings)``.

    Each rank holds ``Aw[:, m0:m1]`` and its slices of ``aprior_mw``,
    ``low``, ``high`` and ``wm_sq`` (the MS sensitivity weighting Wm^2,
    ones when None); ``dobs`` (centred) and ``grav_fix`` are replicated.
    ``fn(x_local, alpha, params)`` takes this rank's block of a chain
    batch (C_local, M_local) (or of one model (M_local,)) and returns the
    global ``U`` (C_local,), the local gradient and ``(dpre, u_data,
    u_model)``, global per chain: the partial ``x_local @ A_local.T`` and
    the per-chain partial model term go through one ``all_reduce`` over
    ``model``. Smoothness/TV need ``mshape = (nz, ny, nx)`` (and ``active``
    for a carved mesh) and evaluate the grid as :func:`grid_layout` says:
    the halo branch adds one ``all_reduce`` of the boundary planes, the
    replicated branch one of the packed model. ``shardings`` maps
    ``low``, ``high`` and ``Aw`` to this rank's blocks.
    """
    if regularization not in ("Damping", "MS", "Smoothness", "TV"):
        raise ValueError(
            "Please choose regularization from 'MS','Damping', "
            "'Smoothness', 'TV'.")
    needs_grid = regularization in ("Smoothness", "TV")
    if needs_grid and mshape is None:
        raise ValueError(
            "sharded Smoothness/TV need mshape=(nz, ny, nx) "
            "(and the active mask for carved meshes)")
    device = mesh_device(mesh, device)
    Aw = np.asarray(Aw) if not torch.is_tensor(Aw) else Aw
    M = int(Aw.shape[1])
    m0, m1 = mesh.col_range(M)

    def vec(v):
        t = torch.as_tensor(v if torch.is_tensor(v) else np.asarray(v),
                            dtype=dtype, device=device)
        return t

    dobs_t = vec(dobs)
    params = {
        "Aw": vec(Aw[:, m0:m1]),
        "dobs_centered": dobs_t - dobs_t.mean(),
        "aprior_mw": vec(aprior_mw)[m0:m1],
        "low": vec(low)[m0:m1],
        "high": vec(high)[m0:m1],
        "wm_sq": (vec(wm_sq)[m0:m1] if wm_sq is not None
                  else torch.ones(m1 - m0, dtype=dtype, device=device)),
        "grav_fix": vec(grav_fix) if grav_fix is not None else None,
    }
    layout = None
    if needs_grid:
        mshape = tuple(int(s) for s in mshape)
        layout = grid_layout(mesh, M, mshape, active)
        if (layout == "replicated" and active is not None
                and not np.asarray(active).all()):
            act = np.asarray(active, bool).ravel()
            params["active_idx"] = torch.as_tensor(np.flatnonzero(act),
                                                   device=device)
            params["active3d"] = torch.as_tensor(act.reshape(mshape),
                                                 device=device)
    beta = float(beta)
    partial_model = layout != "replicated"

    def fn(x, alpha, P):
        x = torch.as_tensor(x, dtype=dtype, device=device)
        single = x.ndim == 1
        if single:
            x = x[None]
        A = P["Aw"]
        part = x @ A.T
        dm = x - P["aprior_mw"]
        if layout is None:
            um, gm = model_value_and_grad(regularization, dm, P["wm_sq"],
                                          beta, None)
        elif layout == "halo":
            um, gm = _halo_value_and_grad(mesh, regularization, dm, mshape,
                                          beta)
        else:
            full = gather(mesh, dm, (None, "model"), M)
            um, gfull = model_value_and_grad(
                regularization, full, None, beta, mshape, P.get("active3d"),
                P.get("active_idx"))
            gm = gfull[:, m0:m1]
        if partial_model:
            # one collective a call: the data partials and the model term
            buf = torch.cat([part, um[:, None].to(part.dtype)], dim=1)
            mesh.all_reduce(buf, "model")
            # contiguous, as the unsharded product is: a row stride of D + 1
            # can change the card's reduction order over the rows
            dpre = buf[:, :-1].contiguous()
            u_model = buf[:, -1].contiguous()
        else:
            dpre = mesh.all_reduce(part, "model")
            u_model = um
        dinv = dpre + P["grav_fix"] if P["grav_fix"] is not None else dpre
        r = (dinv - dinv.mean(-1, keepdim=True)) - P["dobs_centered"]
        u_data = (r * r).sum(-1)
        rc = 2.0 * (r - r.mean(-1, keepdim=True))
        gdata = rc @ A
        U = u_data + alpha * u_model
        g = gdata + alpha * gm
        if single:
            return U[0], g[0], (dpre[0], u_data[0], u_model[0])
        return U, g, (dpre, u_data, u_model)

    pot = Potential(fn, params)
    pot.grid_layout = layout
    shardings = {"low": params["low"], "high": params["high"],
                 "Aw": params["Aw"]}
    return pot, shardings


# ----------------------------------------------------------- the sampler

def welford_metric_switch(carry, min_var=1e-12, mesh=None):
    """Pooled Welford variance -> diagonal inverse mass, moments reset.

    Over a Welford-carrying carry ``(..., w_mean, w_m2, w_count)``: the
    inverse mass is the pooled per-chain variance of the window over all
    chains (``m2`` summed over the ``chains`` group of ``mesh``, divided by
    the global chain count), clipped at ``min_var``; the moments are
    zeroed for the next window. Returns ``(carry, inv_mass)`` with
    ``inv_mass`` this rank's cells (M_local,)."""
    m2 = carry[9].sum(0)
    C = carry[9].shape[0]
    if mesh is not None:
        mesh.all_reduce(m2, "chains")
        C *= mesh.shape["chains"]
    var = (m2 / C) / torch.clamp(carry[10] - 1.0, min=1.0)
    inv_mass = torch.clamp(var, min=min_var)
    carry = carry[:8] + (torch.zeros_like(carry[8]),
                         torch.zeros_like(carry[9]),
                         torch.zeros_like(carry[10]))
    return carry, inv_mass


def make_sharded_chunk_sampler(mesh, potential_fn, *, low, high, M, nchains,
                               nsamples, ndraws, wdiag_inv, data_size,
                               dt=0.01, Lmin=5, Lmax=20, Sigma=0.001,
                               constraint="mandatory", alpha=1.0,
                               chunk_size=8, dtype=torch.float32,
                               shared_L=False, welford=False,
                               store_mode="accepted", store_thin=1,
                               draws=None, device=None):
    """The sharded training step: ``(run_chunk, init_carry)``.

    ``run_chunk`` is :func:`..inversion.hmc.make_chunk_sampler` told the
    mesh (``mesh=``, ``global_shape=(nchains, M)``): this rank's block of
    the chain state ``x[c0:c1, m0:m1]``, the sample buffers' block, the
    kinetic energy summed over ``model`` before the Metropolis test, the
    stats rows normalised by the global M, one L a chain drawn for the
    whole batch (or one shared, ``shared_L``), the ``draws`` kernel at
    the block's offsets, an injected draw source's global draws cut to the
    block, and a per-chunk check that the ranks of one chain group took
    the same accept decisions. ``run_chunk(carry, seed, chunk_idx,
    params=None, dt=..., inv_mass=None, store_base=0)``; ``inv_mass`` is
    global (M,) or this rank's (M_local,). ``low``, ``high`` and
    ``wdiag_inv`` are global (M,); ``init_carry(x0)`` takes the global
    start (nchains, M) and returns this rank's carry (with zeroed Welford
    moments under ``welford``).

    The fused kernels are deliberately not offered here (see the module
    docstring).
    """
    device = mesh_device(mesh, device)
    m0, m1 = mesh.col_range(M)
    c0, c1 = mesh.chain_range(nchains)

    def local(v):
        v = v if torch.is_tensor(v) else np.asarray(v)
        return v[m0:m1]

    run_chunk = hmc_mod.make_chunk_sampler(
        potential_fn, dt=dt, Lmin=Lmin, Lmax=Lmax, Sigma=Sigma,
        low=local(low), high=local(high), constraint=constraint,
        alpha=alpha, chunk_size=chunk_size, nsamples=nsamples,
        ndraws=ndraws, wdiag_inv=local(wdiag_inv), data_size=data_size,
        dtype=dtype, shared_L=shared_L, store_mode=store_mode,
        store_thin=store_thin, draws=draws, device=device, mesh=mesh,
        global_shape=(nchains, M))

    def init_carry(x0):
        x0 = torch.as_tensor(x0 if torch.is_tensor(x0) else np.array(x0))
        x = x0[c0:c1, m0:m1].to(dtype=dtype, device=device).contiguous()
        U, g, (_, u_data, u_model) = potential_fn(x, alpha)
        Cl, Ml = c1 - c0, m1 - m0
        carry = (x, U, g, u_data, u_model,
                 torch.zeros(Cl, dtype=torch.int32, device=device),
                 torch.zeros((Cl, nsamples, Ml), dtype=dtype, device=device),
                 torch.zeros((Cl, nsamples, 7), dtype=dtype, device=device))
        if welford:
            carry = carry + hmc_mod._zero_moments(Cl, Ml, dtype, device)
        return carry

    return run_chunk, init_carry
