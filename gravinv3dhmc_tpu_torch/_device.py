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
