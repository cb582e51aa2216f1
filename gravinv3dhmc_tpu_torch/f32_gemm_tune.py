"""Check and time the f32-matrix GEMMs on the tensor cores.

``python -m gravinv3dhmc_tpu_torch.f32_gemm_tune`` (on a machine with a
GPU) takes the f32 GEMM kernels (``residual_f32``, ``step_residual_f32``
and ``kick_f32``: six bf16 products of three pieces of each operand) at
the two shapes of ``f32_gemm_check.SHAPES``, on an f32 matrix made from
a seed (``f32_gemm_check.synthetic_problem``) lane-padded and split as
the fused ops keep it. For this package's ``csrc/leapfrog.cu`` and for
each variant of :data:`VARIANTS` (one nvcc each, started together, into
the package's ``_build/variants/``) it prints each GEMM's error against
a float64 product of the same f32 operands, over the largest |product|,
beside that of the plain version (one IEEE-f32 ``torch.matmul``, TF32
off), and its time: CUDA events over 20 launches queued behind a spin of
the card (``timing.device_ms``), the variants in turn, median of
:data:`ROUNDS` rounds. Then, per GEMM of this source, the host's time to
issue one call beside the time CUDA events give to calls issued as the
card runs them (the host's, where it is the longer) and the time of
calls queued behind the spin. One JSON object per line, the card's name
and power limit first.

``--baseline FILE`` (another ``leapfrog.cu`` whose ``lf_residual``,
``lf_step_residual`` and ``lf_kick`` take an f32 matrix as ``a_mode`` 0,
the SIMT kernels of the commits before these) builds FILE too and then
times, at both shapes, the baseline's SIMT kernel and this source's
kernel in turns (b, c, c, b three times, 50 launches each), beside the
plain version and one ``torch.matmul`` of the product, with each one's
error against float64. ``--slice`` then samples the f32 uniformgrid slice
(600 x 6000, 1024 chains, the fused iteration) with the f32 GEMM
wrappers launching the baseline's kernels and this source's, in turns
(b, c, c, b, seed 0): grad-evals/s and the accept ratio of each run.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import time
from contextlib import contextmanager
from functools import partial

import torch

from .f32_gemm_check import (GEMMS, SHAPES, f64_reference, gemm_operands,
                             library_fn, rel_to_f64, synthetic_problem)
from .kick_tune import build_baseline, build_variants, card, use_library
from .ops import _cuda
from .ops import leapfrog as tlf
from .timing import device_ms

#: library name -> the constants of ``leapfrog.cu`` it sets; the source
#: as it stands is "current"
VARIANTS = {
    "no_pingpong": {"SPLIT_PINGPONG": 0},
    "promote_2": {"SPLIT_PROMOTE": 2},
    "promote_4": {"SPLIT_PROMOTE": 4},
    "promote_8": {"SPLIT_PROMOTE": 8},
    "stages_3": {"SPLIT_RES_STAGES": 3, "SPLIT_KICK_STAGES": 3},
    "bk_64": {"SPLIT_BK": 64, "SPLIT_RES_STAGES": 2, "SPLIT_KICK_STAGES": 2},
    "one_consumer_2_blocks": {"SPLIT_RES_CONSUMERS": 1,
                              "SPLIT_RES_STAGES": 3,
                              "SPLIT_KICK_CONSUMERS": 1,
                              "SPLIT_KICK_STAGES": 3},
}
ROUNDS = 5


#: where :func:`emit` also writes each line in full (``--out``)
_OUT = []


def emit(obj):
    """One JSON line: on stdout without the per-round times (``ms``), in
    full in the ``--out`` file."""
    print(json.dumps({k: v for k, v in obj.items() if k != "ms"}),
          flush=True)
    for path in _OUT:
        with open(path, "a") as f:
            f.write(json.dumps(obj) + "\n")


def build_ops(device="cuda"):
    """The f32 trajectory op of each shape in :data:`SHAPES` (its
    ``_padded`` holds the f32 matrix and its pieces) and the chains."""
    return {shape: (tlf.make_fused_trajectory(
        *synthetic_problem(D, M), regularization="MS", beta=0.001,
        matvec_dtype=torch.float32, device=device), C)
        for shape, (C, D, M) in SHAPES.items()}


def check(name, make):
    """The kernel and the plain version on the same fresh arguments:
    (kernel's error, plain version's error) against float64."""
    a_k, a_p = make(), make()
    ref = f64_reference(name, make())
    tlf.KERNELS[name](*a_k)
    tlf.KERNELS[name].plain(*a_p)
    torch.cuda.synchronize()
    return rel_to_f64(name, a_k, ref), rel_to_f64(name, a_p, ref)


def use(name):
    """Launch from library ``name``, its own plans (its tiles may differ)."""
    use_library(name)
    tlf._OCCUPANCY.clear()
    tlf._PLANS.clear()


class SimtBaseline:
    """The SIMT f32 GEMMs of another ``leapfrog.cu`` (``--baseline``),
    launched with the f32 wrappers' arguments: the f32 matrix itself as
    ``a_mode`` 0 (its pieces unused), the residual cut into the slices
    that source's own occupancy query and :func:`ops.leapfrog.split_plan`
    give."""

    def __init__(self, path):
        self.lib = build_baseline(path)
        out = (ctypes.c_int * 5)()
        self.lib.call("lf_residual_occupancy", 0, ctypes.addressof(out))
        per_sm, sms, tm, tn, ks = tuple(out)
        self.tile = (tm, tn, ks, per_sm * sms)

    def _part(self, x, A):
        C, Mp = x.shape
        Dp = A.shape[0]
        splits = tlf.split_plan(C, Dp, Mp, *self.tile)["splits"]
        return splits, torch.empty((splits, C, Dp), device=x.device)

    def residual(self, x, A, dobs, dmask, r, A_split=None):
        P, f32 = _cuda.ptr, torch.float32
        (C, Mp), Dp = x.shape, A.shape[0]
        splits, part = self._part(x, A)
        self.lib.call("lf_residual", P(x, f32), P(A, f32), 0, P(dobs, f32),
                      P(dmask, f32), P(r, f32), P(part, f32), splits, C, Dp,
                      Mp, _cuda.stream(x))

    def step_residual(self, x, A, fix, dobs, dmask, inv_nobs, r, ud,
                      A_split=None):
        P, f32 = _cuda.ptr, torch.float32
        (C, Mp), Dp = x.shape, A.shape[0]
        splits, part = self._part(x, A)
        self.lib.call("lf_step_residual", P(x, f32), P(A, f32), 0,
                      P(fix, f32), P(dobs, f32), P(dmask, f32), P(r, f32),
                      P(ud, f32), P(part, f32), splits, C, Dp, Mp, inv_nobs,
                      _cuda.stream(x))

    def kick(self, r, A, x, p, aprior, gm_scale, s_data, s_mod, beta, ms,
             A_split=None):
        P, f32 = _cuda.ptr, torch.float32
        (C, Dp), Mp = r.shape, A.shape[1]
        self.lib.call("lf_kick", P(r, f32), P(A, f32), 0, P(x, f32),
                      P(p, f32), P(aprior, f32), P(gm_scale, f32), C, Dp, Mp,
                      s_data, s_mod, beta, int(ms), _cuda.stream(r))

    def launches(self):
        return {"residual_f32": self.residual,
                "step_residual_f32": self.step_residual,
                "kick_f32": self.kick}


@contextmanager
def launching(launches):
    """The registry's wrappers of ``launches`` (name -> launch function)
    launch those functions while entered (they still count launches).
    A variant of this source is swapped in whole (``use_library``); the
    SIMT baseline takes other arguments (the f32 matrix, ``a_mode`` 0),
    so its launch functions replace the wrappers' own."""
    saved = {n: tlf.KERNELS[n]._launch for n in launches}
    for n, fn in launches.items():
        tlf.KERNELS[n]._launch = fn
    try:
        yield
    finally:
        for n, fn in saved.items():
            tlf.KERNELS[n]._launch = fn


def sweep(ops, smi):
    """Errors and times of this source and each variant, in turn."""
    names = ["current", *VARIANTS]
    for shape, (op, C) in ops.items():
        cases = gemm_operands(op, C)
        errs, times = {}, {(lib, g): [] for lib in names for g in GEMMS}
        for lib in names:
            use(lib)
            errs[lib] = {g: check(g, cases[g]) for g in GEMMS}
        bench = {g: cases[g]() for g in GEMMS}
        for _ in range(ROUNDS):
            for lib in names:
                use(lib)
                for g in GEMMS:
                    times[lib, g].append(device_ms(
                        lambda: tlf.KERNELS[g](*bench[g])))
        for lib in names:
            use(lib)
            for g in GEMMS:
                plan = (tlf.kick_plan(C, op.Dp, op.Mp, tlf.A_F32_SPLIT)
                        if g == "kick_f32" else
                        tlf.residual_plan(C, op.Dp, op.Mp, tlf.A_F32_SPLIT))
                emit({
                    "shape": shape, "C_Dp_Mp": [C, op.Dp, op.Mp],
                    "variant": lib, "sets": VARIANTS.get(lib, {}),
                    "gemm": g, "kernel_vs_f64": errs[lib][g][0],
                    "plain_vs_f64": errs[lib][g][1],
                    "ms_median": statistics.median(times[lib, g]),
                    "splits": plan["splits"],
                    "blocks": plan["blocks"], "card": smi})
    use("current")


def unqueued_ms(fn, reps=20):
    """Mean time of one call of ``fn`` from CUDA events around ``reps``
    calls issued while the card runs them (no spin ahead): the host's
    issue time where it is the longer."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_issue(ops, smi, reps=50):
    """Per GEMM, in turns over :data:`ROUNDS` rounds: the host's time to
    issue one call (wall clock over ``reps`` calls, before they finish),
    the events' time of calls issued as the card runs them, and
    :func:`timing.device_ms`'s."""
    for shape, (op, C) in ops.items():
        cases = gemm_operands(op, C)
        bench = {g: cases[g]() for g in GEMMS}
        runs = {g: {"issue_us": [], "unqueued_ms": [], "ms": []}
                for g in GEMMS}
        for _ in range(ROUNDS):
            for g in GEMMS:
                fn = partial(tlf.KERNELS[g], *bench[g])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                runs[g]["issue_us"].append(
                    (time.perf_counter() - t0) / reps * 1e6)
                runs[g]["unqueued_ms"].append(unqueued_ms(fn))
                runs[g]["ms"].append(device_ms(fn))
        for g in GEMMS:
            emit({"shape": shape, "C_Dp_Mp": [C, op.Dp, op.Mp], "gemm": g,
                  **{f"{k}_median": statistics.median(v)
                     for k, v in runs[g].items()},
                  **{f"{k}_range": [min(v), max(v)]
                     for k, v in runs[g].items()}, "card": smi})


def against(baseline, ops, smi):
    """The baseline's SIMT kernels against this source's, in turns, with
    the plain version and the library call beside them."""
    simt = baseline.launches()
    for shape, (op, C) in ops.items():
        cases = gemm_operands(op, C)
        for g in GEMMS:
            with launching({g: simt[g]}):
                err_b = check(g, cases[g])[0]
            err_c, err_p = check(g, cases[g])
            bench = cases[g]()
            times = {"baseline": [], "current": []}
            for lib in ["baseline", "current", "current", "baseline"] * 3:
                with launching({g: simt[g]} if lib == "baseline" else {}):
                    times[lib].append(device_ms(
                        lambda: tlf.KERNELS[g](*bench), reps=50, warmup=5))
            plain_ms = device_ms(lambda: tlf.KERNELS[g].plain(*bench))
            library_ms = device_ms(library_fn(g, bench), reps=50, warmup=5)
            lib_a = cases[g]()
            ref = f64_reference(g, lib_a)
            out = library_fn(g, lib_a)()
            # the library's product alone (the step residual's less its
            # row mean is the plain version's, not the library call's)
            lib_err = (None if g == "step_residual_f32" else
                       ((out.double() - ref).abs().max()
                        / ref.abs().max()).item())
            emit({
                "shape": shape, "C_Dp_Mp": [C, op.Dp, op.Mp], "gemm": g,
                "baseline_median_ms": statistics.median(times["baseline"]),
                "current_median_ms": statistics.median(times["current"]),
                "plain_ms": plain_ms, "library_ms": library_ms,
                "baseline_vs_f64": err_b, "current_vs_f64": err_c,
                "plain_vs_f64": err_p, "library_vs_f64": lib_err,
                "ms": times, "card": smi})


def slices(baseline, smi, seed=0):
    """The f32 uniformgrid slice with the baseline's GEMMs and with this
    source's, in turns."""
    from . import uniformgrid

    dev = torch.device("cuda", 0)
    module, dobs = uniformgrid.build_problem(device=dev)
    cfg = uniformgrid.SLICE
    for lib in ("baseline", "current", "current", "baseline"):
        with launching(baseline.launches() if lib == "baseline" else {}):
            res = uniformgrid.slice_sampler(
                module, dobs, dev, seed=seed, matvec=torch.float32).sample(
                cfg["nsamples"], cfg["ndraws"])
        emit({
            "slice": "uniformgrid f32", "gemms": lib, "seed": seed,
            "grad_evals_per_s": res["grad_evals_per_s"],
            "accept_ratio": res["accept_ratio"],
            "elapsed_s": res["elapsed_s"], "card": smi})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="another leapfrog.cu whose f32 "
                    "GEMMs (a_mode 0) to time against")
    ap.add_argument("--slice", action="store_true", help="with "
                    "--baseline, also sample the f32 uniformgrid slice "
                    "with each")
    ap.add_argument("--out", help="also write every line, with the times "
                    "of each round, to this file")
    args = ap.parse_args(argv)
    if args.out:
        _OUT.append(args.out)
    if not torch.cuda.is_available():
        raise SystemExit("f32_gemm_tune: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card()
    emit({"card": smi})
    lib = _cuda.build_all(["leapfrog"])["leapfrog"]
    _cuda._LIBRARIES["current"] = lib
    # ptxas's registers and spills of the tensor-core kernels
    log = [ln.split(":", 1)[-1].strip() for ln in lib.build_log.splitlines()
           if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
    emit({"ptxas": [
        ln for i, ln in enumerate(log)
        if any(k in " ".join(log[max(i - 2, 0):i + 1])
               for k in ("_split_kernel", "_tc_kernel"))]})
    build_variants(VARIANTS)
    baseline = SimtBaseline(args.baseline) if args.baseline else None
    ops = build_ops()
    sweep(ops, smi)
    host_issue(ops, smi)
    if baseline:
        against(baseline, ops, smi)
        if args.slice:
            slices(baseline, smi)
    use("current")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
