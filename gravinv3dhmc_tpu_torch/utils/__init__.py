"""Host numpy utilities copied from ``gravinv3dhmc_tpu/utils``."""
from .grids import contaminate, regular
from .units import (
    dircos,
    eotvos2si,
    mgal2si,
    nt2si,
    si2eotvos,
    si2mgal,
    si2nt,
)

__all__ = [
    "regular", "contaminate",
    "si2mgal", "mgal2si", "si2eotvos", "eotvos2si", "si2nt", "nt2si",
    "dircos",
]
