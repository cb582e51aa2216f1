"""Reference-compatible 3-D wavelet compressor API
(reference: gravmag/compressor3D.py:18-68)."""
from ...ops.wavelet import kernelcompressor_3d as kernelcompressor  # noqa: F401
from ...ops.wavelet import modelcompressor_3d as modelcompressor  # noqa: F401
