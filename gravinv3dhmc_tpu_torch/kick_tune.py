"""Time the tensor-core kicks at the shapes they could take.

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

``--f32`` takes the f32 kick (``kick_f32``, the persistent
``kick_split_persistent_kernel``) instead, at every shape of
``f32_gemm_check.SHAPES`` and at :data:`RAGGED_CHAINS` chains of the
realdata-fused cell's width, on that module's synthetic matrices with
the whole kick (p, MS, both scales; :func:`f32_operands`). It builds this
source, each of :data:`F32_VARIANTS` and, with ``--baseline FILE``,
another ``leapfrog.cu`` (such as the parent commit's, whose f32 kick ran
a block a tile), and holds every library's p bit for bit equal to the
baseline's (to this source's without one); any difference exits 1. Then
it times them in turns, :data:`ROUNDS` rounds of 20 launches behind a
spin (``timing.device_ms``), and prints each one's median beside the
six-product bound (12 C Dp Mp FLOP at 989 TFLOP/s) and the plan of this
source's persistent blocks.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
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
#: library name -> the constants of ``leapfrog.cu`` it sets, for the f32
#: kick: "cooperative" puts both consumer warpgroups on one 128 x 128 tile,
#: one block an SM (a three-stage ring beside its epilogue tile), against
#: the source's two blocks an SM of one warpgroup and a 64 x 128 tile each
F32_VARIANTS = {"cooperative": {"SPLIT_KICK_CONSUMERS": 2,
                                "SPLIT_KICK_STAGES": 3}}
#: the ragged chain count of ``--f32``
RAGGED_CHAINS = 37
ROUNDS = 5
#: the bf16 tensor cores' peak (H100 SXM, dense), FLOP/s
TENSOR_FLOPS = 989e12


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


def f32_operands(op, C, seed=0):
    """The f32 kick's arguments at C chains on ``op``'s lane-padded f32
    matrix and its pieces, made from ``seed``: r and p of the slices'
    scales, x inside the box, MS at the op's beta."""
    pp = op._padded
    A, pieces = pp["A"], pp["A_split"]
    Dp, Mp = A.shape
    gen = torch.Generator(device=A.device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=A.device)

    return (0.1 * randn(C, Dp) * pp["dmask"], A, 0.3 + 0.05 * randn(C, Mp),
            1e-3 * randn(C, Mp), pp["aprior"], pp["gm_scale"], 0.02, 0.01,
            op.beta, True, pieces)


def f32_cases(device="cuda"):
    """label -> (f32 trajectory op, chains): each shape of
    ``f32_gemm_check.SHAPES`` and :data:`RAGGED_CHAINS` chains at the
    realdata-fused cell's width."""
    from .f32_gemm_check import SHAPES as F32_SHAPES, synthetic_problem

    ops = {}
    for label, (C, D, M) in F32_SHAPES.items():
        ops[label] = (tlf.make_fused_trajectory(
            *synthetic_problem(D, M), regularization="MS", beta=0.001,
            matvec_dtype=torch.float32, device=device), C)
    ops[f"realdata-fused, {RAGGED_CHAINS} chains"] = (
        ops["realdata-fused"][0], RAGGED_CHAINS)
    return ops


def f32_main(baseline, smi, out):
    """``--f32``: every library's kick bit for bit against the reference
    library's, then their times in turns (the module's docstring)."""
    names = {name: f"leapfrog_f32_{name}" for name in F32_VARIANTS}
    _cuda.build_all(["leapfrog"])
    _cuda._LIBRARIES["current"] = _cuda._LIBRARIES["leapfrog"]
    build_variants({lib: F32_VARIANTS[name] for name, lib in names.items()})
    libs = ["current", *names.values()]
    if baseline:
        build_baseline(baseline)
        libs.insert(0, "baseline")
    ref = libs[0]
    equal_all = True
    for label, (op, C) in f32_cases().items():
        outs, times = {}, {lib: [] for lib in libs}
        for lib in libs:
            use_library(lib)
            a = f32_operands(op, C)
            tlf.KERNELS["kick_f32"](*a)
            torch.cuda.synchronize()
            outs[lib] = a[3].view(torch.int32)
        bench = f32_operands(op, C)
        for _ in range(ROUNDS):
            for lib in libs:
                use_library(lib)
                times[lib].append(time_kernel("kick_f32", bench))
        use_library("current")
        tlf._OCCUPANCY.clear()
        tlf._PLANS.clear()
        plan = tlf.kick_plan(C, op.Dp, op.Mp, tlf.A_F32_SPLIT)
        bound_ms = 12 * C * op.Dp * op.Mp / TENSOR_FLOPS * 1e3
        for lib in libs:
            equal = torch.equal(outs[lib], outs[ref])
            equal_all &= equal
            ms = statistics.median(times[lib])
            line = {"shape": label, "C_Dp_Mp": [C, op.Dp, op.Mp],
                    "library": lib, "sets": F32_VARIANTS.get(
                        lib.removeprefix("leapfrog_f32_"), {}),
                    "bit_equal_to": ref, "bit_equal": equal,
                    "ms_median": ms, "ms": times[lib],
                    "bound_ms": bound_ms, "share_of_bound": bound_ms / ms,
                    "card": smi}
            if lib == "current":
                line["plan"] = {k: plan[k] for k in (
                    "tiles", "blocks", "tiles_per_block", "blocks_per_sm")}
            print(json.dumps(line), flush=True)
            if out:
                with open(out, "a") as f:
                    f.write(json.dumps(line) + "\n")
    return 0 if equal_all else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--f32", action="store_true", help="the f32 kick: "
                    "this source and its variants in turns, bit for bit")
    ap.add_argument("--baseline", help="with --f32, another leapfrog.cu "
                    "whose f32 kick every library must equal bit for bit")
    ap.add_argument("--out", help="with --f32, also append every line "
                    "to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kick_tune: CUDA is not available")
    smi = card()
    print(smi, flush=True)
    if args.f32:
        return f32_main(args.baseline, smi, args.out)
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
