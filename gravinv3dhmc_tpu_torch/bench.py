"""Benchmark (``python -m gravinv3dhmc_tpu_torch.bench``): leapfrog
gradient evaluations per second on one GPU, both stages of the JAX
package's bench (``gravinv3dhmc_tpu/bench.py``) through the port.

Prints ONE JSON line with the JAX bench's keys: ``metric`` ("uniformgrid
leapfrog grad-evals/s/chip"), ``value``, ``unit``, ``vs_baseline`` (the
reference's 440 grad-evals/s) and ``detail``, whose ``realdata`` holds
the second stage's numbers. Progress goes to stderr.

- **uniformgrid**: the 600 x 6000 prism problem
  (:func:`.uniformgrid.build_problem`) through
  :func:`.uniformgrid.slice_sampler` (the fused iteration op with a bf16
  matrix, MS at beta 0.001, dt 0.01, Sigma 0.001, L in [5, 20]), 1024
  chains, chunks of 128 iterations, 64 samples in ``store_mode='chain'``;
  one warm chunk, then 8 timed chunks whose grad-evals and accepts are
  summed on the card and read once at the end; the median ESS on the card
  over a ``RandomState(0)`` subsample of 128 cells.
- **realdata**: :mod:`.realdata`'s problem and stage (576 x 10,676
  tesseroids, 256 chains, windowed warmup, the fused trajectory op on an
  f32 matrix), after the first stage's buffers are freed. Its
  reference-kernel ESS per sample is read from ``tools/refkernel_f64.json``
  (a recorded f64 run of the reference's fixed-dt kernel on the published
  625 x 10,427 problem) or, with ``BENCH_REALDATA_REFKERNEL=1``, measured
  live (:func:`reference_kernel_live`): the reference's kernel at float64,
  64 chains, 128 samples, on the stage's own problem, after the stage's
  sample buffers are dropped.

Environment variables (the JAX bench's names): ``BENCH_NCHAINS``,
``BENCH_CHUNK``, ``BENCH_CHUNKS``, ``BENCH_NSAMPLES``,
``BENCH_MATVEC_DTYPE`` (the fused iteration op's matrix type, bfloat16
by default; in the JAX bench it set the potential's, which the fused
path reads only for the first state's U and g), ``BENCH_REALDATA=0``
(skip the second stage), ``BENCH_REALDATA_NCHAINS``, ``_CHUNK``,
``_NSAMPLES``, ``_ADAPT_CHUNKS``, ``_DT``, ``_LRANGE`` ("Lmin,Lmax"),
``_THIN``, ``_MATVEC_DTYPE``, ``_REFKERNEL`` ("file", the default; "0"
off; "1", the live f64 measurement) and ``BENCH_VERBOSE``.

Left out on purpose: the JAX bench's TPU-link workarounds (subprocess
kernel probes, d2h watchdog threads, the compile cache, ``BENCH_RBG``)
and its fallbacks. A stage that fails fails the run, with a non-zero
exit: there is no retry on another path and no ``{"error": ...}`` in
place of a stage, which would hide which kernels ran. ``detail`` adds to
the JAX keys the launches of each stage's kernels (``launches``) and the
tesseroid builder's backend (``realdata.tess_backend``); the watchdog's
``grad_eval_count_mode`` is gone (every count is read exactly).
"""
from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import _device, realdata, uniformgrid
from .diagnostics import ess_torch, median
from .inversion.hmc import HamiltonianMC
from .ops import leapfrog

METRIC = "uniformgrid leapfrog grad-evals/s/chip"
BASELINE_GRAD_EVALS_PER_S = 440.0  # 2 chains x ~220/s (BASELINE.md)
# realdata T1: 1000 samples in ~161 s sampling x 2 MPI chains
# (reference: example/realdata/logout_T1.txt; BASELINE.md derived table)
BASELINE_REALDATA_SAMPLES_PER_S = 2 * 1000 / 161.0
BASELINE_REALDATA_GRAD_EVALS_PER_S = 300.0  # 2 chains x ~150/s
#: the recorded f64 run of the reference's kernel (a data file of the
#: repository, read by path)
REFKERNEL = (Path(__file__).resolve().parents[1] / "tools"
             / "refkernel_f64.json")
#: the live measurement's sampler: the reference's fixed-dt kernel
#: (example/realdata/main_real.py:43, logout_T1.txt) at float64, as the
#: JAX bench sets it (``ref.<name> = ...``), and its stored samples
REFKERNEL_SETTINGS = dict(dt=0.005, Lrange=[5, 40], Sigma=0.001, seed=100,
                          RegulFactor=0.05, regularization="Damping",
                          nchains=64, chunk_size=32, write_files=False,
                          shared_L=True, use_fused=False, store_mode="chain",
                          transfer_samples=False, dtype=torch.float64)
REFKERNEL_SAMPLES = 128
#: the published realdata problem the recorded run sampled; the live run
#: samples the repository's synthetic stand-in
PUBLISHED_REALDATA_PROBLEM = [625, 10427]

# the JAX bench's problem builders, under its names
build_problem = uniformgrid.build_problem
build_realdata_problem = realdata.build_problem


def _env_int(name, default):
    return int(os.environ.get(name, str(default)))


def _stage_logger():
    t = [time.time()]

    def stage(msg):
        now = time.time()
        print(f"[bench +{now - t[0]:.1f}s] {msg}", file=sys.stderr,
              flush=True)
        t[0] = now

    return stage


def _launches(before):
    """The kernels launched since the counts ``before``, by name. The
    counts are read, never reset, so a caller counting around
    :func:`run` sees both stages."""
    now = leapfrog.launch_counts()
    return {n: now[n] - before[n] for n in now if now[n] > before[n]}


def _device_name(device):
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))


def uniformgrid_stage(device, stage, problem=None):
    """The bench's first stage; returns the result dict without
    ``detail.realdata``. ``problem(device) -> (module, dobs)`` replaces
    :func:`.uniformgrid.build_problem`."""
    nchains = _env_int("BENCH_NCHAINS", 1024)
    chunk_size = _env_int("BENCH_CHUNK", 128)
    n_timed_chunks = _env_int("BENCH_CHUNKS", 8)
    nsamples = _env_int("BENCH_NSAMPLES", 64)
    matvec = getattr(torch, os.environ.get("BENCH_MATVEC_DTYPE", "bfloat16"))
    module, dobs = (problem or uniformgrid.build_problem)(device=device)
    stage("problem built (kernel matrix on host)")
    M = module.n_active
    chain = uniformgrid.slice_sampler(module, dobs, device, matvec=matvec,
                                      nchains=nchains, chunk=chunk_size)
    run_chunk, carry = chain.prepare(nsamples, 0)
    stage("potential + fused setup done")
    seed = chain.seed
    before = leapfrog.launch_counts()
    carry, _ = run_chunk(carry, seed, 0)
    _device.sync(device)
    stage("warmup chunk ran")

    # counters summed on the card, one read after the last chunk; the
    # read is the completion barrier of the timed window
    t0 = time.time()
    ge_acc = torch.zeros((), dtype=torch.float64, device=device)
    ac_acc = torch.zeros((), dtype=torch.float64, device=device)
    stat_count = 0
    for i in range(1, n_timed_chunks + 1):
        carry, stats = run_chunk(carry, seed, i)
        ge_acc = ge_acc + stats[..., 4].sum(dtype=torch.float64)
        ac_acc = ac_acc + stats[..., 0].sum(dtype=torch.float64)
        stat_count += stats.shape[0] * stats.shape[1]
    grad_evals, accept_sum = torch.stack([ge_acc, ac_acc]).tolist()
    elapsed = time.time() - t0
    launches = _launches(before)
    stage(f"timed chunks done ({elapsed:.1f}s)")

    # ESS over a 128-parameter subsample of the sample buffer, on the card
    sub = np.random.RandomState(0).choice(M, size=min(M, 128),
                                          replace=False)
    ess = float(median(ess_torch(
        carry[6][:, :, torch.as_tensor(sub, device=device)])))

    value = grad_evals / elapsed
    accept_ratio = accept_sum / max(stat_count, 1)
    # the nsamples stored samples/chain took ~nsamples/accept_ratio
    # iterations to collect at the measured per-iteration wall time
    ess_per_s = None
    if np.isfinite(accept_ratio) and accept_ratio > 0:
        iter_time = elapsed / (chunk_size * n_timed_chunks)
        ess_per_s = ess / ((nsamples / accept_ratio) * iter_time)
    return {
        "metric": METRIC,
        "value": round(value, 1),
        "unit": "grad-evals/s",
        "vs_baseline": round(value / BASELINE_GRAD_EVALS_PER_S, 2),
        "detail": {
            "device": _device_name(device),
            "nchains": nchains,
            "chunk_size": chunk_size,
            "shared_L": True,
            "store_mode": "chain",
            "fused_pallas_step": chain._fused_mode,
            "problem": [int(dobs.size), int(M)],
            "iters_per_s": round(chunk_size * n_timed_chunks * nchains
                                 / elapsed, 1),
            "accept_ratio": accept_ratio,
            "ess_per_s_median": (round(ess_per_s, 1)
                                 if ess_per_s is not None else None),
            "ess_median_total": ess,
            "launches": launches,
        },
    }


def reference_kernel():
    """The recorded reference kernel's ESS per sample and what it implies
    on the reference's hardware, from ``BENCH_REALDATA_REFKERNEL``: "file"
    (the default) reads ``tools/refkernel_f64.json``; "0" and "1" return
    None ("1" is measured live by :func:`realdata_stage`, after its
    sampler has run)."""
    mode = os.environ.get("BENCH_REALDATA_REFKERNEL", "file")
    if mode in ("0", "1"):
        return None
    if mode != "file":
        raise ValueError(f"BENCH_REALDATA_REFKERNEL must be 'file', '0' or "
                         f"'1', got {mode!r}")
    art = json.loads(REFKERNEL.read_text())
    e_per_sample = art["measured"]["ess_per_sample"]
    return {
        "accept_ratio": art["measured"]["accept_ratio"],
        "ess_per_sample": e_per_sample,
        "ref_hw_ess_per_s": BASELINE_REALDATA_SAMPLES_PER_S * e_per_sample,
        "source": "tools/refkernel_f64.json (recorded f64 measurement)",
    }


def reference_kernel_live(module, chain, device, nsamples=REFKERNEL_SAMPLES,
                          draws=None):
    """The reference's kernel measured on ``module`` (the JAX bench's
    ``BENCH_REALDATA_REFKERNEL=1``): a :class:`HamiltonianMC` at
    :data:`REFKERNEL_SETTINGS` (fixed dt 0.005, L in [5, 40], Sigma 0.001,
    Damping at 0.05, 64 chains, shared L, the eager path, float64) with
    the box, start, a priori model and data of ``chain`` (the stage's
    sampler), ``nsamples`` stored in ``store_mode='chain'``. Returns its
    accept ratio, ESS per sample (the median ESS over 64 x ``nsamples``)
    and what that implies on the reference's hardware, with the problem's
    shape (the stand-in's, not the published one the recorded run
    sampled), the dtypes of the chains' state and potential and the run's
    seconds. ``draws`` is a draw
    source for :meth:`HamiltonianMC.sample` (the tests inject the JAX
    sampler's). A failing run raises."""
    ref = HamiltonianMC(module)
    for name, value in REFKERNEL_SETTINGS.items():
        setattr(ref, name, list(value) if name == "Lrange" else value)
    ref.device = device
    ref.verbose = chain.verbose
    for name in ("low", "high", "initial_model", "aprior_model", "dobs"):
        setattr(ref, name, getattr(chain, name))
    out = ref.sample(nsamples, 0, draws=draws)
    e_per_sample = out["ess_median"] / (ref.nchains * nsamples)
    return {
        "accept_ratio": round(out["accept_ratio"], 4),
        "ess_per_sample": e_per_sample,
        "ref_hw_ess_per_s": BASELINE_REALDATA_SAMPLES_PER_S * e_per_sample,
        "source": "measured live (f64)",
        "problem": [int(np.asarray(chain.dobs).size), int(module.n_active)],
        "published_problem": PUBLISHED_REALDATA_PROBLEM,
        "problem_note": "the repository's synthetic stand-in of the "
                        "published problem, which the recorded run sampled",
        "nchains": ref.nchains,
        "nsamples": nsamples,
        "dtype": {k: str(out[k].dtype).replace("torch.", "")
                  for k in ("x", "U")},
        "fused_mode": out["fused_mode"],
        "elapsed_s": out["elapsed_s"],
    }


def realdata_stage(device, stage, problem=None):
    """The bench's second stage: :mod:`.realdata`'s problem (or
    ``problem(device) -> (module, dobs)``) through its sampler."""
    nchains = _env_int("BENCH_REALDATA_NCHAINS", realdata.SLICE["nchains"])
    chunk_size = _env_int("BENCH_REALDATA_CHUNK", realdata.SLICE["chunk"])
    nsamples = _env_int("BENCH_REALDATA_NSAMPLES",
                        realdata.SLICE["nsamples"])
    adapt_chunks = _env_int("BENCH_REALDATA_ADAPT_CHUNKS",
                            realdata.SLICE["adapt_chunks"])
    dt = float(os.environ.get("BENCH_REALDATA_DT", realdata.SLICE["dt"]))
    Lrange = [int(v) for v in os.environ.get(
        "BENCH_REALDATA_LRANGE", "%d,%d" % realdata.SLICE["Lrange"])
        .split(",")]
    if len(Lrange) != 2 or Lrange[0] < 1 or Lrange[1] < Lrange[0]:
        raise ValueError(
            f"BENCH_REALDATA_LRANGE must be 'Lmin,Lmax', got {Lrange}")
    store_thin = _env_int("BENCH_REALDATA_THIN", 1)
    matvec = getattr(torch, os.environ.get("BENCH_REALDATA_MATVEC_DTYPE",
                                           "float32"))
    ref_est = reference_kernel()
    t_build = time.time()
    module, dobs = (problem or realdata.build_problem)(device=device)
    build_s = time.time() - t_build
    M = module.n_active
    stage(f"realdata problem built ({build_s:.1f}s, {dobs.size}x{M}, "
          f"{module.tess_backend} tesseroid builder)")
    chain = realdata.slice_sampler(
        module, dobs, device, nchains=nchains, chunk=chunk_size,
        adapt_chunks=adapt_chunks, dt=dt, Lrange=Lrange,
        store_thin=store_thin, matvec=matvec)
    chain.verbose = os.environ.get("BENCH_VERBOSE", "0") == "1"
    stage("realdata sampler configured (adaptive warmup on)")
    before = leapfrog.launch_counts()
    out = chain.sample(nsamples, 0)
    _device.sync(device)
    launches = _launches(before)
    stage(f"realdata adaptive run done ({out['elapsed_s']:.1f}s, "
          f"accept {out['accept_ratio']:.2f})")
    if os.environ.get("BENCH_REALDATA_REFKERNEL", "file") == "1":
        # the stage's sample buffers (8.4 GB at the defaults) go before the
        # reference run allocates its own
        out["samples"] = out["misfits"] = None
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref_est = reference_kernel_live(module, chain, device)
        stage(f"reference-kernel ESS measured ({ref_est['elapsed_s']:.1f}s, "
              f"accept {ref_est['accept_ratio']:.4f}, ESS/sample "
              f"{ref_est['ess_per_sample']:.2e})")
    ess_per_s = out["ess_per_s_median"] or float("nan")
    samples_per_s = nchains * nsamples / out["elapsed_s"]
    return {
        "problem": [int(dobs.size), int(M)],
        "kernel_build_s": round(build_s, 2),
        "nchains": nchains,
        "nsamples": nsamples,
        "Lrange": Lrange,
        "store_thin": store_thin,
        "fused_pallas_step": out["fused_mode"],
        "grad_evals_per_s": round(out["grad_evals_per_s"], 1),
        "samples_per_s": round(samples_per_s, 1),
        "accept_ratio": round(out["accept_ratio"], 4),
        "step_size": out["step_size"],
        "adapted_mass": out["adapted_mass"],
        "ess_per_s_median": round(ess_per_s, 2),
        "elapsed_s": round(out["elapsed_s"], 1),
        # ESS/s vs the reference's samples/s (>= its ESS/s): lower bound
        "vs_baseline_ess": round(
            ess_per_s / BASELINE_REALDATA_SAMPLES_PER_S, 1),
        "vs_baseline_grad_evals": round(
            out["grad_evals_per_s"] / BASELINE_REALDATA_GRAD_EVALS_PER_S, 1),
        "reference_kernel": ref_est,
        "vs_reference_kernel_ess": (
            round(ess_per_s / max(ref_est["ref_hw_ess_per_s"], 1e-12), 1)
            if ref_est else None),
        "tess_backend": module.tess_backend,
        "launches": launches,
    }


def run(device=None, uniformgrid_problem=None, realdata_problem=None):
    """Both stages on ``device`` (``cuda:0`` when None): the dict
    :func:`main` prints. ``uniformgrid_problem`` / ``realdata_problem``,
    functions ``(device) -> (module, dobs)``, replace the full-size
    problems (the CPU tests pass small ones)."""
    device = _device.resolve(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    stage = _stage_logger()
    result = uniformgrid_stage(device, stage, uniformgrid_problem)
    if os.environ.get("BENCH_REALDATA", "1") != "0":
        # the first stage's buffers are gone before the second allocates
        # its sample buffer (8.4 GB at the defaults)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        result["detail"]["realdata"] = realdata_stage(device, stage,
                                                      realdata_problem)
    return result


def main():
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
