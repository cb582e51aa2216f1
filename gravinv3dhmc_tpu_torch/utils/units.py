"""Coordinate and unit-conversion helpers.

Numpy copy of ``gravinv3dhmc_tpu/utils/units.py`` (reference:
utils.py:258-474). All functions accept scalars or arrays.
"""
from __future__ import annotations

import numpy as np

from .. import constants


def si2nt(value):
    """SI -> 'nanoTesla' (the reference's T2NT is actually micro-tesla)."""
    return value * constants.T2NT


def nt2si(value):
    return value / constants.T2NT


def si2eotvos(value):
    return value * constants.SI2EOTVOS


def eotvos2si(value):
    return value / constants.SI2EOTVOS


def si2mgal(value):
    return value * constants.SI2MGAL


def mgal2si(value):
    return value / constants.SI2MGAL


def sph2cart(lon, lat, height):
    """Spherical (deg, deg, m above mean Earth radius) -> geocentric Cartesian.

    Reference: utils.py:258-279.
    """
    d2r = np.pi / 180.0
    radius = constants.MEAN_EARTH_RADIUS + np.asarray(height)
    x = np.cos(d2r * lat) * np.cos(d2r * lon) * radius
    y = np.cos(d2r * lat) * np.sin(d2r * lon) * radius
    z = np.sin(d2r * lat) * radius
    return x, y, z


def dircos(inc, dec):
    """Unit vector from inclination/declination (degrees).

    x->North, y->East, z->Down; inclination positive down, declination from
    North. Reference: utils.py:446-474.
    """
    d2r = np.pi / 180.0
    return [
        np.cos(d2r * inc) * np.cos(d2r * dec),
        np.cos(d2r * inc) * np.sin(d2r * dec),
        np.sin(d2r * inc),
    ]


def ang2vec(intensity, inc, dec):
    """Intensity + angles (degrees) -> 3-component vector(s).

    Reference: utils.py:420-444.
    """
    return np.transpose([intensity * i for i in dircos(inc, dec)])


def vec2ang(vector):
    """3-component vector -> [intensity, inclination, declination] (degrees).

    Reference: utils.py:383-418.
    """
    intensity = np.linalg.norm(vector)
    r2d = 180.0 / np.pi
    x, y, z = vector
    declination = r2d * np.arctan2(y, x)
    inclination = r2d * np.arcsin(z / intensity)
    return [intensity, inclination, declination]
