"""Observation-grid generation and synthetic-noise helpers.

Numpy copy of ``gravinv3dhmc_tpu/utils/grids.py`` (reference:
utils.py:114-151 ``regular``, utils.py:549-631 ``contaminate``,
utils.py:634-690 the gaussians).
"""
from __future__ import annotations

import numpy as np


def _check_area(area):
    x1, x2, y1, y2 = area
    assert x1 <= x2, f"Invalid area dimensions {x1}, {x2}. x1 must be < x2."
    assert y1 <= y2, f"Invalid area dimensions {y1}, {y2}. y1 must be < y2."


def regular(area, shape, z=None):
    """Create a flattened regular observation grid.

    x is North-South (varies along rows), y is East-West (varies along
    columns); ``shape=(nx, ny)``; returned arrays are raveled with x-major
    ordering, matching the reference exactly (reference: utils.py:114-151).

    Returns ``[x, y]`` or ``[x, y, z]`` 1-D float64 arrays of length nx*ny.
    """
    nx, ny = shape
    x1, x2, y1, y2 = area
    _check_area(area)
    xs = np.linspace(x1, x2, nx)
    ys = np.linspace(y1, y2, ny)
    # meshgrid uses its first argument for columns; reversing yields x-major
    arrays = list(np.meshgrid(ys, xs)[::-1])
    if z is not None:
        arrays.append(z * np.ones(nx * ny, dtype=np.float64))
    return [i.ravel() for i in arrays]


def contaminate(data, stddev, percent=False, return_stddev=False, seed=None):
    """Add zero-mean pseudorandom Gaussian noise to data.

    The generated noise has its sample mean removed so it introduces no
    systematic shift. Matches the reference's semantics, including the
    list-of-arrays form and the legacy global-seed behaviour
    (reference: utils.py:549-631).
    """
    rng = np.random.RandomState(seed)
    if not isinstance(stddev, list):
        stddev = [stddev]
        data = [data]
    stddev = list(stddev)
    contam = []
    for i in range(len(stddev)):
        if stddev[i] == 0.0:
            contam.append(data[i])
            continue
        if percent:
            stddev[i] = stddev[i] * max(abs(np.asarray(data[i])))
        noise = rng.normal(scale=stddev[i], size=len(data[i]))
        noise -= noise.mean()
        contam.append(np.asarray(data[i]) + noise)
    if len(contam) == 1:
        contam = contam[0]
        stddev = stddev[0]
    if return_stddev:
        return [contam, stddev]
    return contam


def gaussian(x, mean, std):
    """Normalised 1-D Gaussian (reference: utils.py:634-657, including its
    non-standard exponent scaling, preserved for parity)."""
    return (1 / (np.sqrt(2 * np.pi) * std)) * np.exp(-1 * ((x - mean) ** 2 / 2 * std ** 2))


def gaussian2d(x, y, sigma_x, sigma_y, x0=0, y0=0, angle=0.0):
    """Non-normalised rotated 2-D Gaussian (reference: utils.py:660-690)."""
    theta = -1 * angle * np.pi / 180.0
    tmpx = 1.0 / sigma_x ** 2
    tmpy = 1.0 / sigma_y ** 2
    sintheta = np.sin(theta)
    costheta = np.cos(theta)
    a = tmpx * costheta + tmpy * sintheta ** 2
    b = (tmpy - tmpx) * costheta * sintheta
    c = tmpx * sintheta ** 2 + tmpy * costheta ** 2
    xhat = x - x0
    yhat = y - y0
    return np.exp(-(a * xhat ** 2 + 2.0 * b * xhat * yhat + c * yhat ** 2))
