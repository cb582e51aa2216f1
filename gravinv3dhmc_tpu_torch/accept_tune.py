"""Time the ``accept`` kernel at each block shape it could take.

``python -m gravinv3dhmc_tpu_torch.accept_tune`` (on a machine with a GPU)
builds ``csrc/leapfrog.cu`` once for every (threads a block, chains a
block, 16-byte loads in flight a thread) of :data:`CONFIGS`, with
``ACCEPT_THREADS``, ``ACCEPT_CHAINS`` and ``ACCEPT_UNROLL`` set to them
(one nvcc per variant, started together, into the package's
``_build/variants/``), and for each times ``accept`` at the two slices'
shapes with the share of chains the slices' checks accept (about half at
uniformgrid, where every rejected chain copies x and g back, 99 % at
ratiogrid): CUDA events over 20 launches after warm-up, the configs in
turn, five rounds, on operands made from a seed, with the kernel's
outputs checked bit for bit against its plain version. One JSON object
per (shape, config) line with the five times and their median, the
card's name and power limit first.

``--baseline FILE`` (another ``leapfrog.cu`` with the same C entries,
such as an earlier commit's) builds FILE too and, after the sweep, times
``refresh`` (both forms) and ``accept`` at both shapes from FILE and from
this package's source in turns, baseline first (b, c, c, b three times,
50 launches each): one JSON line per case with both medians.
"""
from __future__ import annotations

import argparse
import json
import statistics

import torch

from .kick_tune import (build_baseline, build_variants, card, time_kernel,
                        use_library)
from .ops import _cuda, philox
from .ops import leapfrog as tlf

#: (threads a block, chains a block, loads in flight a thread); the first
#: is the one ``leapfrog.cu`` ships
CONFIGS = [(256, 1, 4), (256, 1, 2), (256, 1, 8), (128, 1, 4), (512, 1, 4),
           (1024, 1, 4), (256, 2, 4), (256, 4, 4)]
#: timing rounds over all configs
ROUNDS = 5
#: (chains, Mp, model cells, share of chains accepted)
SHAPES = {"uniformgrid": (1024, 6016, 6000, 0.5),
          "ratiogrid": (1024, 17152, 17100, 0.99)}


def operands(C, Mp, M, share, seed=0, device="cuda", iteration=4):
    """``accept``'s arguments at this shape, made from ``seed``: momenta of
    order 1 on the M model columns (zero pads, im 1 there), a random
    inverse mass in [0.1, 1], and H0 set so that each chain's log accept
    ratio lies 0.5 to one side of its Philox uniform u (drawn in the
    kernel, ``u`` None): accepted with probability ``share``, both sides
    far from a tie at f32 rounding. The carried state differs from the
    proposal in every value, so a restore shows."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=device)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    mask = (torch.arange(Mp, device=device) < M).float()
    im = torch.where(mask > 0, 0.1 + 0.9 * rand(Mp), torch.ones_like(mask))
    p = randn(C, Mp) * mask
    x = (0.3 + 0.05 * randn(C, Mp)) * mask
    g = 10.0 * randn(C, Mp) * mask
    U = 200.0 + randn(C)
    salt = philox.salt_from_seed(5)
    u = philox.accept_uniforms(salt, iteration, C, device).double()
    H1 = 0.5 * (im * p * p).double().sum(1) + U.double()
    side = torch.where(rand(C) < share, -0.5, 0.5).double()
    H0 = (H1 + torch.log(u.clamp_min(2.0 ** -24)) - side).float()
    return (x, g, U, 0.9 * U, 0.1 * U, p, H0, x + 1.0, g + 1.0, U + 1.0,
            U + 2.0, U + 3.0, im, salt, iteration, None,
            torch.empty(C, device=device))


def refresh_operands(C, Mp, M, pk, device="cuda"):
    """``refresh``'s arguments at this shape: g of the slices' scale on the
    M model columns, pscale 0.001 there (0 on the pads), im 1, Philox
    normals drawn in the kernel; ``pk`` None gives the p-only form."""
    gen = torch.Generator(device=device).manual_seed(1)
    mask = (torch.arange(Mp, device=device) < M).float()
    g = 10.0 * torch.randn(C, Mp, generator=gen, device=device) * mask
    U = 200.0 + torch.randn(C, generator=gen, device=device)
    return (g, U, 0.001 * mask, torch.ones(Mp, device=device), 0.005,
            philox.salt_from_seed(3), 7, None,
            torch.empty(C, Mp, device=device),
            torch.empty(C, Mp, device=device) if pk else None,
            torch.empty(C, device=device))


def against(baseline, smi):
    """refresh and accept from ``baseline`` against this source, in
    turns; the p-only refresh only from this source (a baseline may lack
    that form)."""
    build_baseline(baseline)
    for shape, (C, Mp, M, share) in SHAPES.items():
        cases = {"refresh (p, pk)": ("refresh",
                                     refresh_operands(C, Mp, M, True)),
                 "refresh (p only)": ("refresh",
                                      refresh_operands(C, Mp, M, False)),
                 "accept": ("accept", operands(C, Mp, M, share))}
        for case, (kname, args) in cases.items():
            libs = (("current",) if case == "refresh (p only)"
                    else ("baseline", "current"))
            times = {lib: [] for lib in libs}
            order = (["baseline", "current", "current", "baseline"] * 3
                     if len(libs) == 2 else ["current"] * 6)
            for lib in order:
                use_library("leapfrog_current" if lib == "current"
                            else "baseline")
                times[lib].append(time_kernel(kname, args, reps=50,
                                              warmup=5))
            use_library("leapfrog_current")
            print(json.dumps({
                "shape": shape, "case": case, "C_Mp": [C, Mp],
                **{f"{lib}_median_ms": statistics.median(t)
                   for lib, t in times.items()},
                "ms": times, "card": smi}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="another leapfrog.cu to time "
                    "refresh and accept against")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("accept_tune: CUDA is not available")
    smi = card()
    print(smi, flush=True)
    _cuda.build_all(["leapfrog"])
    _cuda._LIBRARIES["leapfrog_current"] = _cuda._LIBRARIES["leapfrog"]
    names = {cfg: "leapfrog_accept_t{}_c{}_u{}".format(*cfg)
             for cfg in CONFIGS}
    build_variants({name: {"ACCEPT_THREADS": t, "ACCEPT_CHAINS": c,
                           "ACCEPT_UNROLL": u}
                    for (t, c, u), name in names.items()})
    for shape, (C, Mp, M, share) in SHAPES.items():
        checks = {}
        for cfg, name in names.items():
            use_library(name)
            a_k = operands(C, Mp, M, share)
            a_p = operands(C, Mp, M, share)
            tlf.KERNELS["accept"](*a_k)
            tlf.accept_plain(*a_p)
            torch.cuda.synchronize()
            checks[cfg] = (int(a_k[16].sum().item()),
                           all(torch.equal(a_k[i], a_p[i])
                               for i in (0, 1, 2, 3, 4, 16)))
        # the configs in turn, ROUNDS times, so a drift of the card's
        # clocks touches all of them alike
        bench = operands(C, Mp, M, share)
        times = {cfg: [] for cfg in names}
        for _ in range(ROUNDS):
            for cfg, name in names.items():
                use_library(name)
                times[cfg].append(time_kernel("accept", bench))
        for (threads, chains, unroll), ms in times.items():
            accepted, equal = checks[threads, chains, unroll]
            print(json.dumps({
                "shape": shape, "C_Mp": [C, Mp], "threads": threads,
                "chains": chains, "unroll": unroll, "accepted": accepted,
                "ms_median": statistics.median(ms), "ms": ms,
                "equal_to_plain": equal, "card": smi}), flush=True)
    if args.baseline:
        against(args.baseline, smi)
    use_library("leapfrog_current")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
