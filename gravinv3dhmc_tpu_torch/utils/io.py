"""Surfer grid IO: a numpy copy of ``gravinv3dhmc_tpu/utils/io.py``
(reference: utils.py:25-99)."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class GridData:
    """Container mirroring the reference's ``gmdata``."""

    data: np.ndarray
    datamin: float
    datamax: float
    ncol: int
    nrow: int
    dx: float
    dy: float
    xmin: float
    xmax: float
    ymin: float
    ymax: float


# Reference-compatible alias
gmdata = GridData


def grdload(filename):
    """Read a Surfer grid file: ASCII ``DSAA`` (reference: utils.py:40-72)
    or binary Surfer-7 ``DSRB`` (the reference's own realdata ``.grd``
    files are DSRB, which its loader could not open)."""
    with open(filename, "rb") as f:
        magic = f.read(4)
    if magic == b"DSRB":
        return _grdload_dsrb(filename)
    with open(filename, "r") as f:
        lines = f.readlines()
    if lines[0].strip() != "DSAA":
        raise ValueError(
            f"{filename} is not a Surfer grd file (missing DSAA/DSRB header)"
        )
    ncol, nrow = (int(v) for v in lines[1].split())
    xmin, xmax = (float(v) for v in lines[2].split())
    ymin, ymax = (float(v) for v in lines[3].split())
    datamin, datamax = (float(v) for v in lines[4].split())
    data = np.loadtxt(filename, skiprows=5)
    dx = (xmax - xmin) / (ncol - 1)
    dy = (ymax - ymin) / (nrow - 1)
    return GridData(data, datamin, datamax, ncol, nrow, dx, dy, xmin, xmax, ymin, ymax)


def _grdload_dsrb(filename):
    """Surfer 7 binary grid: tagged sections; the GRID section holds
    (nrow, ncol, xLL, yLL, xSize, ySize, zMin, zMax, rotation, blank) and
    DATA holds nrow*ncol doubles, rows south-to-north."""
    import struct

    with open(filename, "rb") as f:
        buf = f.read()
    pos = 0
    grid = None
    data = None
    while pos + 8 <= len(buf):
        tag = buf[pos:pos + 4]
        (size,) = struct.unpack_from("<i", buf, pos + 4)
        body = pos + 8
        if tag == b"DSRB":
            pass  # header: version fields only
        elif tag == b"GRID":
            nrow, ncol = struct.unpack_from("<ii", buf, body)
            (xll, yll, dx, dy, zmin, zmax, _rot,
             blank) = struct.unpack_from("<8d", buf, body + 8)
            grid = (nrow, ncol, xll, yll, dx, dy, zmin, zmax, blank)
        elif tag == b"DATA" and grid is not None:
            nrow, ncol = grid[:2]
            data = np.frombuffer(buf, "<f8", count=nrow * ncol,
                                 offset=body).reshape(nrow, ncol).copy()
        pos = body + size
    if grid is None or data is None:
        raise ValueError(f"{filename}: malformed DSRB grid")
    nrow, ncol, xll, yll, dx, dy, zmin, zmax, blank = grid
    data[data >= blank] = np.nan
    return GridData(data, float(zmin), float(zmax), ncol, nrow, dx, dy,
                    xll, xll + dx * (ncol - 1), yll, yll + dy * (nrow - 1))


def grdwrite(x, y, griddata, filename):
    """Write a Surfer ASCII ``DSAA`` grid file."""
    griddata = np.asarray(griddata)
    with open(filename, "w") as f:
        f.write("DSAA\n")
        f.write(f"{griddata.shape[1]} {griddata.shape[0]}\n")
        f.write(f"{np.min(x):.7f} {np.max(x):.7f}\n")
        f.write(f"{np.min(y):.7f} {np.max(y):.7f}\n")
        f.write(f"{np.min(griddata):.7f} {np.max(griddata):.7f}\n")
        np.savetxt(f, griddata)
