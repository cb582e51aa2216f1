"""Host runtime: the native tesseroid engine (``tessglq``)."""
