"""Host runtime: the native tesseroid engine (``tessglq``) and the sample
sinks (``sink``, ``sink_py``)."""
