"""Where the port's entry points and builders put their tensors.

Every public entry point (``GravMagModule``, ``HamiltonianMC``,
``make_chunk_sampler``, the fused-op builders, ``prism_kernel_matrix``'s
device builder, ``params_from_jax`` and the slices' ``build_problem``)
takes ``device=None`` and resolves it here: no device means the first
CUDA card, where the hand-written kernels run. Without a card that is an
error, never a quiet fall back to the CPU, whose plain PyTorch versions
are for the tests and must be asked for with ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

DEFAULT = "cuda:0"


def resolve(device=None):
    """``device`` as a ``torch.device``; ``None`` gives ``cuda:0``, and
    raises ``RuntimeError`` when PyTorch sees no CUDA device."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"no device given and no CUDA device available: the port runs "
            f"on {DEFAULT} by default; pass device='cpu' to run the plain "
            f"PyTorch versions on the CPU")
    return torch.device(DEFAULT)


def as_tensor(v, dtype, device):
    """``v`` (a tensor, a numpy array or a number) as a tensor of
    ``dtype`` on ``device``; a tensor on the card goes there directly,
    never through numpy."""
    return torch.as_tensor(v if torch.is_tensor(v) else np.asarray(v),
                           dtype=dtype, device=device)


def sync(device):
    """Wait for ``device``'s queued work; nothing on the CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def card():
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
