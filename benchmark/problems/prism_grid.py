"""A regular prism grid under a regular grid of gz stations.

The configuration gives the stations' ``area`` (x1, x2, y1, y2), their
``grid`` (nx, ny) and height ``z``, the mesh's corner ``origin``,
``spacing`` (dx, dy, dz) and ``shape`` (nz, ny, nx), the ``body``'s cell
ranges (z, y, x; half-open) and density, and the ``noise`` (a share of
the largest |gz|). The inputs made here from the seed: the stations, the
true model, its gz through the plain reference (:mod:`..reference.prism`,
float64, over the body's cells only) and the data: that gz plus normal
noise of standard deviation ``noise * max|gz|`` drawn from the seed, its
sample mean removed. The program gets the geometry and the data; the
reference builds its own matrix from the same.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import prism


def stations(cfg):
    """(D, 3) float64 stations, x varying slowest."""
    x1, x2, y1, y2 = cfg["area"]
    nx, ny = cfg["grid"]
    xs, ys = np.linspace(x1, x2, nx), np.linspace(y1, y2, ny)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    return np.stack([X.ravel(), Y.ravel(), np.full(X.size, cfg["z"])], 1)


def truth(cfg):
    """(M,) float64 densities of the true model, x fastest, z slowest."""
    rho = np.zeros(cfg["shape"])
    (z0, z1), (y0, y1), (x0, x1) = (cfg["body"][k] for k in "zyx")
    rho[z0:z1, y0:y1, x0:x1] = cfg["body"]["density"]
    return rho.ravel()


def cells(cfg):
    return prism.grid_cells(cfg["origin"], cfg["spacing"], cfg["shape"])


def make_inputs(cfg, seed, device):
    """The stations, cells, true model and seeded data."""
    st, cl, rho = stations(cfg), cells(cfg), truth(cfg)
    body = np.flatnonzero(rho)
    pre = (prism.gz_matrix(st, cl[body], device)
           @ torch.as_tensor(rho[body], dtype=torch.float64,
                             device=device)).cpu().numpy()
    rng = np.random.default_rng([int(seed), 1])
    noise = rng.normal(0.0, cfg["noise"] * np.abs(pre).max(), pre.size)
    return {"stations": st, "cells": cl, "truth": rho, "pre": pre,
            "dobs": pre + (noise - noise.mean())}


def build_module(cfg, inputs, device):
    """The program's module over the configuration's mesh and the data:
    its matrix built and weighted by the program."""
    from gravinv3dhmc_tpu_torch.inversion.potential import GravMagModule

    x0, y0, z0 = cfg["origin"]
    dx, dy, dz = cfg["spacing"]
    nz, ny, nx = cfg["shape"]
    bounds = (x0, x0 + nx * dx, y0, y0 + ny * dy, z0, z0 + nz * dz)
    st = inputs["stations"]
    return GravMagModule(inputs["dobs"], bounds, (dz, dy, dx),
                         (st[:, 0], st[:, 1], st[:, 2]), field="gravity",
                         weightfactor=cfg["weightfactor"], verbose=False,
                         device=device)


def reference_matrix(cfg, inputs, device):
    """The reference's weighted matrix and weights, float64 on
    ``device``: ``(Aw, w)``."""
    A = prism.gz_matrix(inputs["stations"], inputs["cells"], device)
    Aw, w, _ = prism.weighting(A, cfg["weightfactor"])
    return Aw, w
