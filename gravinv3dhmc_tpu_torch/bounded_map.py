"""The bounded-MAP alpha ladder at whole-Earth scale, on the card.

Counterpart of ``tools/bounded_map.py``: fixed-alpha projected CG (the
Damping family, the box [0, 0.8], the a priori model 0.001, float32) on the
7,381 x 72,000 tesseroid problem of :mod:`.global_tess`, whose matrix is
built and weighted on the card (2.13 GB in f32, no host copy). At its
defaults it reproduces ``GLOBAL_r05.json``'s ``bounded_map_ladder_maxk400``;
``--maxk 1600 --alphas 5,271.559,2715.59`` its
``bounded_map_converged_recheck_maxk1600`` and ``--maxk 6400 --alphas
0.5,1.6,5,16,50`` its ``bounded_map_deep_maxk6400``.

* The anchor: one solve of ``min(maxk, chunk)`` iterations at alpha 0 from
  ``mw = 0``, then ``alpha_ref = ||A mw* - d||^2 / ||mw* - apr||^2`` at
  its best iterate (:func:`anchor`).
* The ladder: ``[0] + sorted({alpha_ref 10^e for e in -decades..decades}
  | {5.0})`` (:func:`ladder`); ``--alphas`` replaces it and makes
  ``alpha_ref`` null.
* Each alpha is solved in ``ceil(maxk / chunk)`` restarted segments of
  ``min(maxk, chunk)`` iterations (:func:`solve_alpha`): each restarts
  from the iterate of the least objective ``||A mw - d||^2 + alpha ||mw -
  apr||^2`` (the uncentred residual) seen so far; ``n_iters`` sums the
  segments' iterations.
* Each entry (:func:`evaluate`): RMSD of the mean-removed residual, RMSM
  and the correlation against the truth, the fractions of cells within
  1e-6 of each side of the box and ``final_data_misfit_norm = ||A mw -
  d||^2 / D`` (the uncentred residual).

The solver is :func:`~.inversion.reginv._make_cg_core` with the tool's
arguments; its products are ``torch.matmul`` in IEEE f32 (TF32 off), as
the JAX package computes them outside its Pallas kernels.
``hmc_posterior_mean_corr`` (0.589) and ``unbounded_ridge_map_max_corr``
(0.44) are the JAX package's recorded correlations of the whole-Earth HMC
posterior mean and of the unbounded ridge MAP (``GLOBAL_r04.json``), kept
as the tool keeps them: statistics to compare with, not measurements of
this run.

``python -m gravinv3dhmc_tpu_torch.bounded_map [--scale 1.0] [--maxk 400]
[--decades 3] [--chunk 800] [--alphas A,B,...] [--out PATH] [--device
DEV]`` prints the card's name and power limit, then one JSON line with
the tool's keys (``device`` is that card line) and writes it to ``--out``
when given. It runs on ``cuda:0`` and fails without a card unless given
``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import math
import time

import torch

from . import _device
from .global_tess import build
from .inversion.reginv import _make_cg_core

#: the JAX package's recorded correlations (``GLOBAL_r04.json``): the
#: whole-Earth HMC posterior mean's, and the unbounded ridge MAP ladder's
#: best; statistics, kept as the tool keeps them
HMC_POSTERIOR_MEAN_CORR = 0.589
UNBOUNDED_RIDGE_MAP_MAX_CORR = 0.44
#: the flagship's box, a priori model and the alpha it samples at
BOX = (0.0, 0.8)
APRIOR = 0.001
FLAGSHIP_ALPHA = 5.0


def ladder(alpha_ref, decades):
    """The tool's alphas: 0, then ``alpha_ref`` times each power of ten
    from ``-decades`` to ``decades`` and the flagship's 5.0, sorted and
    distinct."""
    return [0.0] + sorted({alpha_ref * 10.0 ** e
                           for e in range(-decades, decades + 1)}
                          | {FLAGSHIP_ALPHA})


def arrays(module, dobs, dtype=torch.float32):
    """The solver's ``(Aw, dobs, wdiag, wdiag_inv, wdiag * apr)`` tensors
    on the module's device (``tools/bounded_map.py:77-81``)."""
    Aw = module.device_arrays(dtype)["Aw"]
    dev = Aw.device
    wdiag = _device.as_tensor(module.wdiag, dtype, dev)
    wdiag_inv = _device.as_tensor(module.wdiag_inv, dtype, dev)
    apr = torch.full((Aw.shape[1],), APRIOR, dtype=dtype, device=dev)
    return (Aw, _device.as_tensor(dobs, dtype, dev), wdiag, wdiag_inv,
            wdiag * apr)


def make_solver(mshape, maxk, chunk, dtype=torch.float32):
    """``(solve, n_segments)``: the tool's fixed-alpha, best-iterate CG of
    ``min(maxk, chunk)`` iterations a segment."""
    solve = _make_cg_core(
        None, None, None, None, mshape, None, "Damping", 0.01, 0.7,
        min(maxk, chunk), BOX[0], BOX[1], "normalized", dtype,
        as_args=True, fixed_alpha=True, keep_best=True)
    return solve, max(1, -(-maxk // chunk))


def objective(arrs, mw, alpha):
    """``||A mw - d||^2 + alpha ||mw - apr||^2`` (the uncentred residual)."""
    Aw, dobs, _, _, apr = arrs
    r = Aw @ mw - dobs
    dm = mw - apr
    return (r * r).sum() + alpha * (dm * dm).sum()


def anchor(solve, arrs):
    """``alpha_ref``: the data term over the model term at the best iterate
    of one alpha-0 solve from ``mw = 0``."""
    Aw, dobs, _, _, apr = arrs
    mw0 = Aw.new_zeros(Aw.shape[1])
    mw_star = solve(mw0, Aw.new_ones(Aw.shape[0]), arrs, 0.0)[0]
    r = Aw @ mw_star - dobs
    dm = mw_star - apr
    return float((r * r).sum() / (dm * dm).sum())


def solve_alpha(solve, arrs, alpha, n_segments):
    """Restarted projected CG at ``alpha`` from ``mw = 0``: ``n_segments``
    solves, each from the best-objective iterate so far. Returns ``(mw,
    n_iters)``."""
    Aw = arrs[0]
    ones = Aw.new_ones(Aw.shape[0])
    mw = mw_best = Aw.new_zeros(Aw.shape[1])
    obj_best = math.inf
    n_total = 0
    for _ in range(n_segments):
        mw, _, _, _, n_it = solve(mw, ones, arrs, alpha)
        n_total += int(n_it)
        obj = float(objective(arrs, mw, alpha))
        if obj < obj_best:
            mw_best, obj_best = mw, obj
        mw = mw_best
    return mw_best, n_total


def evaluate(arrs, mw, truth):
    """An entry's statistics of the weighted-domain model ``mw``."""
    Aw, dobs, _, wdiag_inv, _ = arrs
    m = mw * wdiag_inv
    dp = Aw @ mw
    r = (dp - dp.mean()) - (dobs - dobs.mean())
    ru = dp - dobs
    return {
        "RMSD": float(torch.sqrt((r * r).mean())),
        "RMSM": float(torch.sqrt(((m - truth) ** 2).mean())),
        "corr": float(torch.corrcoef(torch.stack([m, truth]))[0, 1]),
        "frac_at_lower_bound": float((m <= BOX[0] + 1e-6).to(m.dtype)
                                     .mean()),
        "frac_at_upper_bound": float((m >= BOX[1] - 1e-6).to(m.dtype)
                                     .mean()),
        "final_data_misfit_norm": float((ru * ru).sum() / Aw.shape[0]),
    }


def run(scale=1.0, maxk=400, decades=3, chunk=800, alphas=None, device=None,
        problem=None):
    """The tool's ladder; returns its JSON line as a dict. ``problem`` is
    a built ``(wl, dpre, dobs, module)`` (:func:`~.global_tess.build`) to
    use in place of building one on ``device`` (``cuda:0`` when None)."""
    t_all = time.perf_counter()
    if problem is None:
        problem = build(scale, device=_device.resolve(device))
    wl, _, dobs, module = problem
    dtype = torch.float32
    arrs = arrays(module, dobs, dtype)
    dev = arrs[0].device
    truth = _device.as_tensor(wl["rho"], dtype, dev)
    solve, n_segments = make_solver(module.mshape, maxk, chunk, dtype)
    if alphas is None:
        a_ref = anchor(solve, arrs)
        alphas = ladder(a_ref, decades)
    else:
        a_ref = None
    _device.sync(dev)
    t0 = time.perf_counter()
    entries = []
    for a in alphas:
        mw, n_iters = solve_alpha(solve, arrs, a, n_segments)
        entries.append({"alpha": a, **evaluate(arrs, mw, truth),
                        "n_iters": n_iters})
    _device.sync(dev)
    solve_s = time.perf_counter() - t0
    best = max(entries, key=lambda e: e["corr"])
    return {
        "case": "bounded MAP ladder: fixed-alpha projected CG, "
                "Damping family, box [0, 0.8]",
        "device": _device.card() if dev.type == "cuda" else str(dev),
        "problem": [int(dobs.size), int(module.n_active)],
        "maxk": maxk,
        "alpha_ref": a_ref,
        "ladder": entries,
        "best_alpha": best["alpha"],
        "best_corr": best["corr"],
        "best_RMSM": best["RMSM"],
        "hmc_posterior_mean_corr": HMC_POSTERIOR_MEAN_CORR,
        "unbounded_ridge_map_max_corr": UNBOUNDED_RIDGE_MAP_MAX_CORR,
        "solve_s": solve_s,
        "total_s": time.perf_counter() - t_all,
        "bounded_map_beats_hmc_mean": bool(
            best["corr"] > HMC_POSTERIOR_MEAN_CORR),
    }


def parse_args(argv=None):
    """The tool's knobs (``BM_SCALE``, ``BM_MAXK``, ``BM_DECADES``,
    ``BM_CHUNK``, ``BM_ALPHAS``, ``BM_OUT``) at their defaults."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--maxk", type=int, default=400)
    ap.add_argument("--decades", type=int, default=3)
    ap.add_argument("--chunk", type=int, default=800,
                    help="iterations a restarted CG segment")
    ap.add_argument("--alphas", type=lambda s: [float(a)
                                                for a in s.split(",")],
                    default=None, help="comma-separated alphas in place "
                    "of the anchored ladder")
    ap.add_argument("--out", default=None, help="also write the line here")
    ap.add_argument("--device", default=None,
                    help="cuda:0 when not given; cpu runs the plain path")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = _device.resolve(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    if device.type == "cuda":
        print(_device.card(), flush=True)
    res = run(args.scale, args.maxk, args.decades, args.chunk, args.alphas,
              device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
