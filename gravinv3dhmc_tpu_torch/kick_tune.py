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
import subprocess

import torch

from .ops import _cuda
from .ops import leapfrog as tlf

#: (consumer warpgroups, ring stages)
CONFIGS = [(2, 2), (2, 3), (2, 4), (1, 2), (1, 3), (1, 4)]
#: (chains, Dp, Mp) of the uniformgrid and ratiogrid slices
SHAPES = {"uniformgrid": (1024, 640, 6016), "ratiogrid": (1024, 1024, 17152)}


def variant_source(text, consumers, stages):
    """``leapfrog.cu``'s text with the kick's ring set to ``consumers``
    warpgroups and ``stages`` stages."""
    for name, value in (("KICK_CONSUMERS", consumers),
                        ("KICK_STAGES", stages)):
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise ValueError(f"{name} is not defined once in the source")
    return text


def build_variants(configs):
    """Build one library per config; returns config -> library name."""
    base = _cuda.SOURCES["leapfrog"][1].read_text()
    vdir = _cuda.BUILD_DIR / "variants"
    vdir.mkdir(parents=True, exist_ok=True)
    names = {}
    for consumers, stages in configs:
        name = f"leapfrog_kick_c{consumers}_s{stages}"
        path = vdir / f"{name}.cu"
        path.write_text(variant_source(base, consumers, stages))
        _cuda.SOURCES[name] = ("lf", path)
        _cuda._SIGNATURES[name] = _cuda._SIGNATURES["leapfrog"]
        names[consumers, stages] = name
    _cuda.build_all(list(names.values()))
    return names


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


def time_kick(args, reps=20, warmup=3):
    kick = tlf.KERNELS["kick"]
    for _ in range(warmup):
        kick(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        kick(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kick_tune: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    names = build_variants(CONFIGS)
    for shape, (C, Dp, Mp) in SHAPES.items():
        for config, name in names.items():
            # the registry's wrapper launches from the "leapfrog" library
            _cuda._LIBRARIES["leapfrog"] = _cuda._LIBRARIES[name]
            tlf._OCCUPANCY.pop("kick", None)
            tlf._PLANS.pop(("kick", C, Dp, Mp), None)
            plan = tlf.kick_plan(C, Dp, Mp)
            a_k = operands(C, Dp, Mp)
            a_p = operands(C, Dp, Mp)
            tlf.KERNELS["kick"](*a_k)
            tlf.kick_plain(*a_p)
            torch.cuda.synchronize()
            err = ((a_k[3] - a_p[3]).abs().max()
                   / a_p[3].abs().max()).item()
            ms = time_kick(operands(C, Dp, Mp))
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
