"""inversion compat package (reference: inversion/__init__.py:1)."""
from . import hmc, potential, reginv  # noqa: F401
from ...inversion.potential import GravMagModule  # noqa: F401
from ...inversion.joint import JointModule  # noqa: F401
from ...inversion.hmc import HMCSample, HamiltonianMC, HamitonianMC  # noqa: F401
from ...inversion.reginv import BootStrap, ConjugateGradient  # noqa: F401
