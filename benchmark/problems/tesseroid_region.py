"""A regional mesh of spherical tesseroids under a grid of gz stations:
the upstream's South China case (``example/realdata``) as the JAX bench's
stand-in builds it.

The configuration gives the ``region`` (w, e, s, n; degrees), the
``step`` (degrees) of the stations and of the mesh's columns, the
stations' ``height`` (m), the depth segments' breakpoints ``division``
and spacings ``dz`` (m, negative: down), the ``topography`` (a NumPy
``RandomState(random_state)`` that first draws one N(0, after_normals)
value a station, as the stand-in draws its data, then the topography
U(range) a station: the same for every seed) and the data's ``noise``
(mGal). The stations sit at the cells' centres: ``w + step/2``, ``w +
3 step/2``, ... by ``s + step/2``, ..., longitude fastest. The inputs
made here from the seed: the stations, the topography and the data,
N(0, noise) drawn from the seed (a stand-in: the published observations
are not in the repository). The program builds its module from the
geometry, the topography and the data (:func:`build_module`); the
reference builds its own mesh, carve and matrix from the same
(:func:`reference_matrix`).
"""
from __future__ import annotations

import numpy as np

from benchmark.reference import tesseroid


def stations(cfg):
    """``(lon, lat, height)`` float64 arrays of the stations."""
    w, e, s, n = cfg["region"]
    step = cfg["step"]
    lon, lat = np.meshgrid(np.arange(w + step / 2, e, step),
                           np.arange(s + step / 2, n, step))
    lon, lat = lon.ravel(), lat.ravel()
    return lon, lat, np.full(lon.size, float(cfg["height"]))


def topography(cfg, n):
    """The (n,) topography (m) of the configuration."""
    t = cfg["topography"]
    rng = np.random.RandomState(t["random_state"])
    rng.normal(0, t["after_normals"], n)
    return rng.uniform(*t["range"], n)


def make_inputs(cfg, seed, device):
    """The stations, their topography and the seeded data."""
    lon, lat, height = stations(cfg)
    rng = np.random.default_rng([int(seed), 1])
    return {"lon": lon, "lat": lat, "height": height,
            "topo": topography(cfg, lon.size),
            "dobs": rng.normal(0.0, cfg["noise"], lon.size)}


def build_module(cfg, inputs, device):
    """The program's module over the configuration's carved mesh and the
    data: its tesseroid matrix built and weighted by the program, as its
    realdata slice builds it."""
    from gravinv3dhmc_tpu_torch.inversion.potential import GravMagModule

    w, e, s, n = cfg["region"]
    division = cfg["division"]
    step = cfg["step"]
    obs = (inputs["lon"], inputs["lat"], inputs["height"])
    return GravMagModule(
        inputs["dobs"], (w, e, s, n, division[0], division[-1]),
        (list(cfg["dz"]), step, step), obs, fixed=True,
        grav_fix=np.zeros(inputs["lon"].size), mseg=True,
        mdivisionsection=list(division), coordinate="spherical",
        field="gravity", weightfactor=cfg["weightfactor"], verbose=False,
        device=device, mtopo=(inputs["lon"], inputs["lat"],
                              inputs["topo"]))


def reference_matrix(cfg, inputs, device):
    """The reference's weighted matrix and weights over its own carved
    mesh, float64 on ``device``: ``(Aw, w)``."""
    cells = tesseroid.region_cells(cfg["region"], cfg["step"],
                                   cfg["division"], cfg["dz"])
    keep = tesseroid.carve(cells, inputs["lon"], inputs["lat"],
                           inputs["topo"])
    A = tesseroid.gz_matrix(inputs["lon"], inputs["lat"], inputs["height"],
                            cells[keep], device)
    return tesseroid.weighting(A, cfg["weightfactor"])
