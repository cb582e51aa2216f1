"""Reference-compatible inversion.potential module."""
from ...inversion.potential import (  # noqa: F401
    GravMagModule,
    Potential,
    logistic_to_mw,
    mw_to_logistic,
    sensitivity_weighting,
)
from ...inversion.joint import JointModule  # noqa: F401
