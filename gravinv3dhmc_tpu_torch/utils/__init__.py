"""Host numpy utilities copied from ``gravinv3dhmc_tpu/utils``: grids,
units, packing, IO and the dense-or-sparse linear algebra helpers."""
from .grids import contaminate, gaussian, gaussian2d, regular
from .io import GridData, gmdata, grdload, grdwrite
from .linalg import (
    SparseList,
    safe_diagonal,
    safe_dot,
    safe_inverse,
    safe_solve,
)
from .packing import (
    active_from_mask,
    carve2rho,
    kernel2UBC,
    kernel2ubc,
    rho2carve,
)
from .units import (
    ang2vec,
    dircos,
    eotvos2si,
    mgal2si,
    nt2si,
    si2eotvos,
    si2mgal,
    si2nt,
    sph2cart,
    vec2ang,
)

__all__ = [
    "regular", "contaminate", "gaussian", "gaussian2d",
    "GridData", "gmdata", "grdload", "grdwrite",
    "rho2carve", "carve2rho", "active_from_mask", "kernel2ubc", "kernel2UBC",
    "si2mgal", "mgal2si", "si2eotvos", "eotvos2si", "si2nt", "nt2si",
    "sph2cart", "ang2vec", "vec2ang", "dircos",
    "SparseList", "safe_inverse", "safe_solve", "safe_dot", "safe_diagonal",
]
