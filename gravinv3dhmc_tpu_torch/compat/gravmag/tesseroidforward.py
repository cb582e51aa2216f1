"""Forward-only tesseroid API (reference: gravmag/tesseroidforward.py).

The reference duplicates its whole tesseroid engine to skip the kernel
matrix; here the same engine serves both, so these wrappers return just
the field vector.
"""
from functools import partial as _partial

from ...ops import tesseroid as _t

# Accuracy constants re-exported for scripts that import them from this
# module (reference: gravmag/tesseroidforward.py:71-74).
RATIO_V = _t.RATIO_V
RATIO_G = _t.RATIO_G
RATIO_GG = _t.RATIO_GG
STACK_SIZE = _t.STACK_SIZE


def _forward_only(field):
    def compute(lon, lat, height, model, dens=None, ratio=None, njobs=1,
                pool=None, **kw):
        res, _ = getattr(_t, field)(lon, lat, height, model, dens=dens,
                                    ratio=ratio)
        return res
    compute.__name__ = field
    return compute


potential = _forward_only("potential")
geoid = _forward_only("geoid")
gx = _forward_only("gx")
gy = _forward_only("gy")
gz = _forward_only("gz")
gxx = _forward_only("gxx")
gxy = _forward_only("gxy")
gxz = _forward_only("gxz")
gyy = _forward_only("gyy")
gyz = _forward_only("gyz")
gzz = _forward_only("gzz")
