"""Time the bf16 tensor-core kick at each ring shape it could take.

``python -m gravinv3dhmc_tpu_torch.kick_tune`` (on a machine with a GPU)
builds ``csrc/leapfrog.cu`` once for every (consumer warpgroups, ring
stages) of :data:`CONFIGS`, with ``KICK_CONSUMERS`` and ``KICK_STAGES``
set to them (one nvcc per variant, started together, into the package's
``_build/variants/``), and for each times the ``kick`` kernel at the two
slices' shapes: CUDA events over 20 launches after warm-up, on operands
made from a seed, with the kernel checked against its plain version. One
warpgroup of 64 chains a block lets two blocks share an SM, so one
block's epilogue (the memory-bound part) can overlap the other's
mainloop; two warpgroups (128 chains) halve the reads of A a chain. The
blocks an SM holds come from the runtime's occupancy query. One JSON
object per (shape, config) line, the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import re
from pathlib import Path

import torch

from ._device import card
from .ops import _cuda
from .ops import leapfrog as tlf
from .timing import device_ms

#: (consumer warpgroups, ring stages)
CONFIGS = [(2, 2), (2, 3), (2, 4), (1, 2), (1, 3), (1, 4)]
#: (chains, Dp, Mp) of the uniformgrid and ratiogrid slices
SHAPES = {"uniformgrid": (1024, 640, 6016), "ratiogrid": (1024, 1024, 17152)}


def variant_source(text, values):
    """``leapfrog.cu``'s text with each ``constexpr int NAME`` of
    ``values`` (name -> int) set to its value."""
    for name, value in values.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise ValueError(f"{name} is not defined once in the source")
    return text


def _add_source(name, path, kind="leapfrog", entries=None):
    """Register ``path``, a source with the C entries of library ``kind``
    (only ``entries`` of them, when given), as library ``name``."""
    _cuda.SOURCES[name] = (_cuda.SOURCES[kind][0], Path(path))
    sig = _cuda._SIGNATURES[kind]
    _cuda._SIGNATURES[name] = ({e: sig[e] for e in entries} if entries
                               else sig)


def build_variants(variants, kind="leapfrog"):
    """Build one library of library ``kind``'s source (``leapfrog.cu`` by
    default) per variant (library name -> the constants it sets), one
    nvcc each, started together."""
    base = _cuda.SOURCES[kind][1].read_text()
    vdir = _cuda.BUILD_DIR / "variants"
    vdir.mkdir(parents=True, exist_ok=True)
    for name, values in variants.items():
        path = vdir / f"{name}.cu"
        path.write_text(variant_source(base, values))
        _add_source(name, path, kind)
    _cuda.build_all(list(variants))


def build_baseline(path, kind="leapfrog", entries=None, name="baseline"):
    """Build another source of library ``kind`` (such as an earlier
    commit's ``leapfrog.cu``; only ``entries`` of its C entries are bound
    when given) as library ``name``; returns it."""
    _add_source(name, path, kind, entries)
    return _cuda.build_all([name])[name]


def use_library(name, kind="leapfrog"):
    """Point the registry's wrappers that launch from library ``kind`` at
    variant ``name``."""
    _cuda._LIBRARIES[kind] = _cuda._LIBRARIES[name]


def operands(C, Dp, Mp, seed=0, device="cuda"):
    """The kick's arguments at this shape, made from ``seed``: r and p
    of the slices' scales, a bf16 matrix, x inside its box, MS."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    return (0.1 * randn(C, Dp), (0.01 * randn(Dp, Mp)).to(torch.bfloat16),
            0.3 + 0.05 * randn(C, Mp), 1e-3 * randn(C, Mp),
            torch.full((Mp,), 0.001, device=device),
            torch.full((Mp,), 2e-6, device=device), 0.02, 0.01, 0.001, True)


def time_kernel(name, args, reps=20, warmup=3):
    """Mean device time of the registry's ``name`` on ``args``
    (:func:`timing.device_ms`)."""
    kern = tlf.KERNELS[name]
    return device_ms(lambda: kern(*args), reps, warmup)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kick_tune: CUDA is not available")
    smi = card()
    print(smi, flush=True)
    names = {(c, s): f"leapfrog_kick_c{c}_s{s}" for c, s in CONFIGS}
    build_variants({name: {"KICK_CONSUMERS": c, "KICK_STAGES": s}
                    for (c, s), name in names.items()})
    for shape, (C, Dp, Mp) in SHAPES.items():
        for config, name in names.items():
            use_library(name)
            tlf._OCCUPANCY.pop("kick", None)
            tlf._PLANS.pop(("kick", C, Dp, Mp, tlf.A_BF16), None)
            plan = tlf.kick_plan(C, Dp, Mp)
            a_k = operands(C, Dp, Mp)
            a_p = operands(C, Dp, Mp)
            tlf.KERNELS["kick"](*a_k)
            tlf.kick_plain(*a_p)
            torch.cuda.synchronize()
            err = ((a_k[3] - a_p[3]).abs().max()
                   / a_p[3].abs().max()).item()
            ms = time_kernel("kick", operands(C, Dp, Mp))
            print(json.dumps({
                "shape": shape, "C_Dp_Mp": [C, Dp, Mp],
                "consumers": config[0], "stages": config[1],
                "blocks_per_sm": plan["blocks_per_sm"],
                "blocks": plan["blocks"], "waves": plan["waves"],
                "ms": ms, "rel_err_vs_plain": err, "card": smi}),
                flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
