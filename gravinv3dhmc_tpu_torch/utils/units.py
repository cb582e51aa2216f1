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
