"""Dense-or-sparse dispatching linear algebra helpers: a numpy/scipy copy
of ``gravinv3dhmc_tpu/utils/linalg.py``.

Reference: utils.py:154-255 (``safe_inverse/safe_solve/safe_dot/
safe_diagonal``) — small wrappers that keep calling code agnostic to
whether an operator is a dense array or a ``scipy.sparse`` matrix. Kept
for API parity; the sampler hot paths use vectors for diagonal operators and
never materialise sparse matrices.
"""
from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


def safe_inverse(matrix):
    """Inverse via the appropriate dense/sparse algorithm."""
    if sp.issparse(matrix):
        return spla.inv(matrix.tocsc())
    return np.linalg.inv(matrix)


def safe_solve(matrix, vector):
    """Solve ``matrix @ x = vector`` (dense or sparse)."""
    if sp.issparse(matrix) or sp.issparse(vector):
        vector = np.asarray(vector.todense()).ravel() \
            if sp.issparse(vector) else np.asarray(vector)
        return spla.spsolve(matrix.tocsr(), vector)
    return np.linalg.solve(matrix, vector)


def safe_dot(a, b):
    """Matrix product honouring sparse operands."""
    if sp.issparse(a) or sp.issparse(b):
        return a @ b
    return np.dot(a, b)


def safe_diagonal(matrix):
    """Main diagonal of a dense or sparse matrix."""
    if sp.issparse(matrix):
        return np.asarray(matrix.diagonal())
    return np.diagonal(matrix).copy()


class SparseList(Sequence):
    """Fixed-length sequence storing only its non-default entries.

    API-parity stand-in for the legacy fatiando container the reference
    keeps around (reference: utils.py:477-546 — unused by any inversion
    path there or here). Implemented as a :class:`collections.abc.Sequence`
    over a sparse entry map, so slicing-free iteration, ``in`` and
    ``index()`` come from the ABC; iteration is stateless (the reference's
    version kept a cursor on the instance, so nested loops over the same
    object interfered).
    """

    __slots__ = ("size", "elements", "_default")

    def __init__(self, size, elements=None, default=0.0):
        if size < 0:
            raise ValueError(f"size must be non-negative, got {size}")
        self.size = int(size)
        self._default = default
        self.elements = {}
        if elements:
            for k, v in dict(elements).items():
                self[k] = v

    def _wrap(self, index):
        wrapped = index + self.size if index < 0 else index
        if not 0 <= wrapped < self.size:
            raise IndexError(f"index {index} out of range")
        return wrapped

    def __getitem__(self, index):
        return self.elements.get(self._wrap(index), self._default)

    def __setitem__(self, index, value):
        self.elements[self._wrap(index)] = value

    def __len__(self):
        return self.size

    def __iter__(self):
        get = self.elements.get
        return (get(i, self._default) for i in range(self.size))

    def __repr__(self):
        return f"SparseList({self.size}, {self.elements})"

    __str__ = __repr__
