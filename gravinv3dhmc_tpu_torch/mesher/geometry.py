"""Geometric cell elements (numpy copy of
``gravinv3dhmc_tpu/mesher/geometry.py``): :class:`Prism` for the
cartesian meshes and :class:`Tesseroid` for the spherical ones, the
values ``mesh[i]`` returns.
"""
from __future__ import annotations

import copy as _copy

import numpy as np


class GeometricElement:
    """Base class holding a physical-property dict (reference:
    mesher/geometry.py:18-48)."""

    def __init__(self, props=None):
        self.props = {}
        if props is not None:
            for p in props:
                self.props[p] = props[p]

    def addprop(self, prop, value):
        self.props[prop] = value

    def copy(self):
        return _copy.deepcopy(self)


class Prism(GeometricElement):
    """Right rectangular prism: x->North, y->East, z->Down
    (reference: mesher/geometry.py:51-106)."""

    def __init__(self, x1, x2, y1, y2, z1, z2, props=None):
        super().__init__(props)
        self.x1 = float(x1)
        self.x2 = float(x2)
        self.y1 = float(y1)
        self.y2 = float(y2)
        self.z1 = float(z1)
        self.z2 = float(z2)

    def __str__(self):
        names = [("x1", self.x1), ("x2", self.x2), ("y1", self.y1),
                 ("y2", self.y2), ("z1", self.z1), ("z2", self.z2)]
        names.extend((p, self.props[p]) for p in sorted(self.props))
        return " | ".join(f"{n}:{v:g}" for n, v in names)

    def get_bounds(self):
        return [self.x1, self.x2, self.y1, self.y2, self.z1, self.z2]

    def center(self):
        return np.array([0.5 * (self.x1 + self.x2),
                         0.5 * (self.y1 + self.y2),
                         0.5 * (self.z1 + self.z2)])


class Tesseroid(GeometricElement):
    """Spherical prism: w/e/s/n in decimal degrees, top/bottom in metres
    relative to the mean Earth radius (reference: mesher/geometry.py:109-210).
    """

    def __init__(self, w, e, s, n, top, bottom, props=None):
        super().__init__(props)
        self.w = float(w)
        self.e = float(e)
        self.s = float(s)
        self.n = float(n)
        self.top = float(top)
        self.bottom = float(bottom)

    def __str__(self):
        names = [("w", self.w), ("e", self.e), ("s", self.s),
                 ("n", self.n), ("top", self.top), ("bottom", self.bottom)]
        names.extend((p, self.props[p]) for p in sorted(self.props))
        return " | ".join(f"{n}:{v:g}" for n, v in names)

    def get_bounds(self):
        return [self.w, self.e, self.s, self.n, self.top, self.bottom]

    def half(self, lon=True, lat=True, r=True):
        """Split into up to 8 halves (used by adaptive quadrature)."""
        dlon = 0.5 * (self.e - self.w)
        dlat = 0.5 * (self.n - self.s)
        dh = 0.5 * (self.top - self.bottom)
        wests = [self.w, self.w + dlon]
        souths = [self.s, self.s + dlat]
        bottoms = [self.bottom, self.bottom + dh]
        if not lon:
            dlon *= 2
            wests.pop()
        if not lat:
            dlat *= 2
            souths.pop()
        if not r:
            dh *= 2
            bottoms.pop()
        return [Tesseroid(i, i + dlon, j, j + dlat, k + dh, k, props=self.props)
                for i in wests for j in souths for k in bottoms]

    def split(self, nlon, nlat, nh):
        """Split into nlon*nlat*nh sub-tesseroids."""
        wests = np.linspace(self.w, self.e, nlon + 1)
        souths = np.linspace(self.s, self.n, nlat + 1)
        bottoms = np.linspace(self.bottom, self.top, nh + 1)
        dlon = wests[1] - wests[0]
        dlat = souths[1] - souths[0]
        dh = bottoms[1] - bottoms[0]
        return [Tesseroid(i, i + dlon, j, j + dlat, k + dh, k, props=self.props)
                for i in wests[:-1] for j in souths[:-1] for k in bottoms[:-1]]
