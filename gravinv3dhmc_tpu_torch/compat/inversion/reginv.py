"""Reference-compatible inversion.reginv module."""
from ...inversion.reginv import BootStrap, ConjugateGradient  # noqa: F401
