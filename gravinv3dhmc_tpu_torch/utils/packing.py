"""Dense <-> carved (topography-masked) model packing: a numpy copy of
``gravinv3dhmc_tpu/utils/packing.py``.

The reference walks python lists to drop masked cells
(reference: utils.py:714-749); here the mask is a boolean "active" vector
and packing is O(M) vectorised indexing. ``mask`` may be given either as
the reference-style list of carved indices or as a boolean active array.
"""
from __future__ import annotations

import numpy as np


def active_from_mask(mask, size):
    """Normalise a mask spec to a boolean active-cell array of length size.

    * list/array of carved indices (reference convention) -> active bool
    * boolean array interpreted as active (True = keep)
    """
    mask = np.asarray(mask)
    if mask.dtype == np.bool_:
        if mask.size != size:
            raise ValueError("boolean mask length != mesh size")
        return mask
    active = np.ones(size, dtype=bool)
    if mask.size:
        active[mask.astype(int)] = False
    return active


def rho2carve(rho, mask):
    """Pack a dense model vector to active (non-carved) cells only.

    Reference: utils.py:714-730.
    """
    rho = np.asarray(rho)
    active = active_from_mask(mask, rho.shape[0])
    return rho[active]


def carve2rho(rhocarve, rho, mask):
    """Scatter a packed model back onto the dense grid.

    Masked cells keep their value from ``rho`` (the reference updates a copy
    of the original dense vector, reference: utils.py:732-749).
    """
    rho = np.asarray(rho).copy()
    active = active_from_mask(mask, rho.shape[0])
    rho[active] = rhocarve
    return rho


def kernel2ubc(kernel, shape):
    """Reorder kernel columns from x-fastest/z-slowest to UBC-GIF
    z-fastest/y-slowest layout (reference: utils.py:694-711).

    ``shape = (nx, ny, nz)`` as in the reference signature.
    """
    kernel = np.asarray(kernel)
    nx, ny, nz = shape
    # column order: for move in range(nx*ny): for iz in range(nz): iz*nx*ny+move
    move = np.arange(nx * ny)
    iz = np.arange(nz)
    order = (iz[None, :] * nx * ny + move[:, None]).ravel()
    return kernel[:, order]


# Reference-compatible alias
kernel2UBC = kernel2ubc
