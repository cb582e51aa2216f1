"""Process-group initialisation and chain-distribution helpers, on
``torch.distributed``.

Counterpart of ``gravinv3dhmc_tpu/parallel/multihost.py``. The reference
scales across processes with ``mpiexec`` and uses rank identity only for
seeds and output folders (reference: run_main.sh:18). Here every process
is one rank of a ``torch.distributed`` group and holds one block of the
(chains, model) mesh of :mod:`.sharded`; the collectives between them
are all written as ``all_reduce``, one of the two (with ``broadcast``)
that both backends take on CUDA tensors, so one code path serves NCCL
with one card a rank and gloo with ranks that share a card (or run on
the CPU).

The backend is the caller's choice, never switched behind its back:
``"nccl"`` for CUDA devices and ``"gloo"`` for the CPU by default. NCCL
refuses two ranks of one communicator on one card, so :func:`initialize`
raises a ``ValueError`` naming ``backend="gloo"`` before it would hang.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

#: how long a collective or the rendezvous waits for a peer before the run
#: fails (a dead rank ends the run instead of hanging it)
TIMEOUT_S = 300


def _env_int(name, default=None):
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def rank():
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size():
    """The number of ranks (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def backend_name():
    """The process group's backend ("nccl" or "gloo"; None without one)."""
    return dist.get_backend() if dist.is_initialized() else None


def local_device(device=None):
    """The device this rank's tensors live on: ``device`` when given,
    else ``cuda:{LOCAL_RANK % device_count}`` (``RuntimeError`` without a
    card, as every entry point of the port)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no device given and no CUDA device available: pass "
            "device='cpu' (and backend='gloo') to run the ranks on the CPU")
    local = _env_int("LOCAL_RANK", rank())
    return torch.device("cuda", local % torch.cuda.device_count())


def check_backend(backend, device, shared):
    """``ValueError`` for a backend that cannot serve this layout: NCCL
    with a CPU device, or NCCL with ``shared`` ranks on one card (NCCL
    refuses two ranks of one communicator on the same GPU)."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")
    if backend == "nccl" and torch.device(device).type != "cuda":
        raise ValueError(f"the nccl backend needs CUDA devices, got "
                         f"{device}; use backend='gloo'")
    if backend == "nccl" and shared > 1:
        raise ValueError(
            f"{shared} ranks share {device}: NCCL refuses two ranks of one "
            "communicator on one GPU; use backend='gloo' for ranks that "
            "share a card (it stages CUDA tensors through the host)")


def _ranks_on(device):
    """How many ranks hold ``device`` (this rank's card on this host),
    from every rank's (host, card) gathered over a gloo group of CPU
    tensors, before NCCL is trusted (CPU ranks count as one each)."""
    import socket

    dev = torch.device(device)
    if dev.type != "cuda" or world_size() == 1:
        return 1
    mine = (socket.gethostname(), dev.index or 0)
    every = [None] * world_size()
    group = dist.new_group(backend="gloo")
    dist.all_gather_object(every, mine, group=group)
    dist.destroy_process_group(group)
    return sum(tuple(e) == mine for e in every)


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, backend=None, device=None, timeout=None):
    """``torch.distributed.init_process_group`` with the JAX function's
    arguments and return keys.

    With no arguments the group comes from ``torchrun``'s environment
    (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``). ``coordinator_address`` is
    ``host:port`` (``tcp://`` init) or a URL (``tcp://...``,
    ``file://...``), with ``num_processes`` ranks and this one
    ``process_id``. ``backend`` defaults to ``"nccl"`` for a CUDA device
    and ``"gloo"`` for the CPU (see :func:`check_backend`); ``device`` to
    :func:`local_device`. A group that is already up is kept. The
    rendezvous and every collective time out after ``timeout`` seconds
    (:data:`TIMEOUT_S` by default).

    Returns ``{"process_index", "process_count", "local_devices",
    "global_devices", "device", "backend"}``: one device a rank.
    """
    if not dist.is_initialized():
        kwargs = {}
        if coordinator_address is not None:
            addr = str(coordinator_address)
            kwargs["init_method"] = addr if "://" in addr else f"tcp://{addr}"
            kwargs["world_size"] = int(
                num_processes if num_processes is not None
                else _env_int("WORLD_SIZE", 1))
            kwargs["rank"] = int(process_id if process_id is not None
                                 else _env_int("RANK", 0))
        else:
            kwargs["init_method"] = "env://"
            if num_processes is not None:
                kwargs["world_size"] = int(num_processes)
            if process_id is not None:
                kwargs["rank"] = int(process_id)
        if backend is None:
            backend = ("nccl" if local_device(device).type == "cuda"
                       else "gloo")
        dist.init_process_group(
            backend, timeout=datetime.timedelta(
                seconds=TIMEOUT_S if timeout is None else timeout), **kwargs)
    dev = local_device(device)
    check_backend(backend_name(), dev, _ranks_on(dev))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return {
        "process_index": rank(),
        "process_count": world_size(),
        "local_devices": 1,
        "global_devices": world_size(),
        "device": str(dev),
        "backend": backend_name(),
    }


def chains_for_host(total_chains):
    """Slice ``[start, stop)`` of the global chain batch this rank owns
    (per-rank batching for rank-local sample IO)."""
    per = total_chains // world_size()
    start = rank() * per
    return start, start + per


def host_seed(base_seed):
    """Per-rank seed offset, mirroring the reference's ``seed + myrank``
    (reference: inversion/hmc.py:369)."""
    return base_seed + rank()
