"""Reference-compatible 1-D wavelet compressor API
(reference: gravmag/compressor1D.py:18-60)."""
from ...ops.wavelet import kernelcompressor_1d as kernelcompressor  # noqa: F401
from ...ops.wavelet import modelcompressor_1d as modelcompressor  # noqa: F401
