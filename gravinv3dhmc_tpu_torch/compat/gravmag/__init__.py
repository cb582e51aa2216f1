"""gravmag compat package (reference: gravmag/)."""
from ...ops import prism, tesseroid  # noqa: F401
from . import compressor1D, compressor3D, tesseroidforward  # noqa: F401
# the reference re-exports the compressor entry points at package level,
# 1D shadowing 3D (reference: gravmag/__init__.py)
from .compressor3D import kernelcompressor, modelcompressor  # noqa: F401
from .compressor1D import kernelcompressor, modelcompressor  # noqa: F401,F811
