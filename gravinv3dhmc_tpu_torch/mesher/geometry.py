"""Geometric cell elements (numpy copy of
``gravinv3dhmc_tpu/mesher/geometry.py``).

Only :class:`Prism` and its base are carried over; tesseroids wait for the
spherical slice.
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
