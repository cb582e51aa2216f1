#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, one line each (the script stops at the first failure, non-zero):

1. build   — nvcc compiles every ``gravinv3dhmc_tpu_torch/csrc/*.cu`` for
             sm_90a, one nvcc per source started together; prints the
             build times, the card, ptxas's registers and spills, and the
             number of HGMMA (wgmma) instructions in the SASS
             (``cuobjdump -sass``) of each tensor-core kernel
             (``residual_partial_tc_kernel``, ``kick_tc_kernel`` and the
             f32-matrix ``residual_partial_split_kernel``,
             ``kick_split_persistent_kernel``); 0 in any fails. From the
             same SASS (``gravinv3dhmc_tpu_torch/sass.py``), the issued
             instructions by pipe of four momentum normals and of one
             accept uniform (``momentum4`` and ``accept_uniform``, each
             alone in a one-thread kernel) and of one node value of the
             gz matrix (a corner term of ``gz_kernel``): the bounds of
             ``draws``, ``refresh``, ``gz`` and ``gz_nodes``; a unit
             without its pipes fails.
2. philox  — the kernel's Philox words equal ``ops/philox.py``'s bit for
             bit; its 1M normals have mean 0 and variance 1 within 5 sigma;
             ``refresh``'s p-only form gives its two-output form's p and
             H0 bit for bit; the ``draws`` kernel gives the plain version's
             uniforms bit for bit, its normals within ``KERNEL_RTOL`` and
             ``refresh``'s normals bit for bit; ``momentum4`` and
             ``accept_uniform`` run alone give ``draws``' values bit for
             bit (so the counted code is the code ``draws`` runs).
3. kernels — each of the six kernels (and ``refresh``'s p-only form)
             against its plain PyTorch version on the same inputs at the
             uniformgrid slice's shapes (1024 chains, 640 x 6016 bf16
             matrix), with both timed, beside the least time the card
             could take (``bound_ms``) and, for the GEMMs, one PyTorch
             matmul of the same product; ``accept`` with about half the
             chains rejected, each rejected chain's carried state back bit
             for bit and each accepted one's proposal kept. Then the
             tensor-core GEMMs (``gemm`` lines) at 1024 chains and at a
             ragged 200. The residual: the split plan (tile, splits,
             blocks, waves), two launches bit for bit equal, the kernel and
             the plain version against a float64 product of the same
             bf16-rounded operands, and a NaN guard slice after the
             partials that a store past the last chain would overwrite.
             The kick: its plan, two launches bit for bit equal, the
             kernel and the plain version against float64 (r rounded to
             bf16 as both round it) with the gradient term and with p = 0,
             s_mod = 0, s_data = -1 (the bare product), NaN guard rows of p
             after the last chain that must keep their bits, and its time
             beside its bound and the matmul's.
4. traj    — the trajectory op (kernels) vs its plain version at 256
             chains, L = 7: f32 and bf16, MS and Damping, with and without
             a diagonal inverse mass.
5. iter    — the iteration op with injected draws vs its plain version:
             same accept flags and state; a forced rejection keeps the
             state bit for bit; the Philox draws give the same decisions.
6. slice   — the uniformgrid problem (600 obs x 6000 prisms from the
             port's own mesh and prism builder), 1024 chains, through
             ``HamiltonianMC.sample(use_fused=True)``: grad-evals/s,
             accept ratio, median ESS and the launch count of every
             kernel (each must be > 0); the same with an f32 matrix
             (``slice_f32``: the f32 GEMM kernels); then a small problem
             sampled on the card and on the CPU with the same seed must
             agree, and the same on the card through the eager shared-L
             path, whose ``draws`` launches are counted around that run
             alone.
6b. f32    — the f32-matrix GEMMs (``residual_f32``,
             ``step_residual_f32``, ``kick_f32``: six bf16 products of
             three pieces of each operand on the tensor cores) at
             realdata's 256 x 640 x 10,496 (a synthetic f32 matrix whose
             column scales span four decades, ``f32_gemm_check.py``), at a
             ragged 200 chains there, at uniformgrid's 1024 x 640 x
             6016 (its own matrix) and at the realdata-fused cell's 1024 x
             640 x 10,752 (a synthetic 576 x 10,676 matrix): two launches
             bit for bit equal; the
             kernel and the plain version (one IEEE-f32 matmul, TF32 off)
             against the float64 product of the same f32 operands, the
             kernel's error over max|product| at most ``F32_ERR_RATIO``
             times the plain version's; NaN guards past the last chain;
             times beside both bounds (six bf16 products on the tensor
             cores, one f32 product outside them) and one matmul. Then the
             f32 trajectory op at realdata's width (256 chains, L = 22)
             against its plain version to ``TRAJ_RTOL["float32"]``, its
             launches counted. After phase 8 the same GEMM checks at
             ratiogrid's 1024 x 1024 x 17,152, where ``slice2_f32``
             launches ``step_residual_f32``.
6c. state  — files and state at the slice's width (600 x 6000, 1024
             chains; :data:`STATE`): a fixed-dt run through the bf16
             iteration op and an adaptive one (dt and a diagonal metric)
             through the bf16 trajectory op, each run uninterrupted, cut
             with a snapshot every chunk (``checkpoint_path``) and resumed
             from it: the resumed run's samples, misfits, state and accept
             counts (and the adaptive run's frozen step size and inverse
             mass) must equal the uninterrupted run's bit for bit, with no
             ``max_chunks`` warning; the ``.npz`` size and each save's and
             load's seconds. Then ``HMCSample`` with ``write_files`` (8
             chains): ``diagnostics.load_chains`` must give back its
             samples within the ``%.8f`` rounding (:data:`FILE_ROUNDING`),
             and the same rows written by the native sink and by
             ``PySampleSink`` must be the same bytes, both timed. These
             runs' launches go into the kernels line; the plain Philox
             must not be called.
7. gz      — the ratiogrid matrix (900 obs x 17,100 ratio prisms): the
             dispatcher (``ops.prism_gz.gz_plan``) picks the node kernel
             ``gz_nodes`` (19,220 distinct nodes); its matrix equals the
             corner kernel ``gz``'s bit for bit; each against its plain
             version and all against the f64 host builder, within 1e-3
             of max|A| elementwise and 5e-3 relative Frobenius; both
             kernels timed in turns beside the one bound they share (the
             node evaluations at the instruction counts of their SASS),
             plain versions and the f64 host build timed. Then the cells
             jittered (no shared faces) through
             ``prism_kernel_matrix(backend="pallas")``: the corner kernel
             is dispatched and launched once (its launches counted around
             that build), checked against its plain version and f64.
8. slice 2 — ``ratiogrid.build_problem`` on the card (its matrix from the
             ``gz_nodes`` kernel; the build's time split into the
             kernel's device time, the copy to the host and the
             weighting), then 1024 chains through the per-step fused
             op (``make_chunk_sampler(fused_step=...)``) for 4 chunks of
             64 iterations after a warm chunk: grad-evals/s, accept ratio,
             median ESS, both matrix build times and the launch count of
             every kernel of the path (``refresh`` and ``accept``, which
             open and close each iteration, included; each must be > 0,
             and ``draws`` must not be launched); the same problem with
             an f32 matrix (``slice2_f32``, through
             ``step_residual_f32`` and ``kick_f32``); then a
             small ratiogrid sampled on the card and on the CPU must
             agree (an f32 matrix, its launches on its own line).
9. step kernels — ``refresh`` in its p-only form, ``accept`` with 99 %
             of the chains accepted, ``step_residual``, ``step_misfit``
             and ``draws`` (and the reused ``drift`` and ``kick``) against
             their plain versions at the slice's shapes (1024 chains, 1024
             x 17,152 bf16), timed; then the ``gemm`` lines of
             ``step_residual`` and ``kick`` as in phase 3.
10. step   — the step op (kernels) vs its plain version at 256 chains, one
             step and each of L = 7 steps on the same input: f32 and
             bf16, MS and Damping, with and without a diagonal inverse
             mass; its x' is the clip of the sampler's replayed drift bit
             for bit.
11. bench  — ``gravinv3dhmc_tpu_torch.bench.run()`` at its defaults with
             ``BENCH_REALDATA_REFKERNEL=1``, the dict it returns on one
             line: the uniformgrid stage (1024
             chains, the bf16 iteration op) and the realdata stage (the
             576 x 10,676 tesseroid matrix from the native host engine,
             256 chains, 12 warmup chunks of dual-averaged dt and a
             diagonal metric, then 768 stored samples through the f32
             trajectory op). It requires ``trajectory(float32)``, an
             adapted metric, a finite frozen step size more than 2x away
             from the start's, a post-freeze accept ratio in [0.3, 1)
             (``REALDATA_ACCEPT`` says why not 0.95), a finite ESS, the
             ``native`` tesseroid backend, and launches of ``refresh``,
             ``drift``, ``residual_f32``, ``kick_f32``, ``traj_finish``
             and ``accept`` around the realdata stage (and of the
             iteration op's kernels around the uniformgrid one). Then, on
             the stage's own tesseroid matrix (``realdata.build_problem``,
             the op the stage runs: 256 chains, 640 x 10,752 padded,
             Damping): ``refresh``, ``drift``, ``traj_finish`` and
             ``accept`` (98 % accepted) against their plain versions
             (``realdata_kernel`` lines); the f32 trajectory op against its
             plain version as in phase 6b, without and with a diagonal
             inverse mass; and the ``f32_gemm`` checks of phase 6b at 256
             and at a ragged 200 chains, which give the kernels line's
             ``residual_f32`` and ``kick_f32`` numbers.
11b. refkernel — the bench's live f64 reference kernel
             (``bench.reference_kernel_live``, after the realdata stage's
             buffers are dropped: the reference's fixed dt 0.005, L in
             [5, 40], Sigma 0.001, Damping at 0.05, 64 chains, 128
             samples, shared L, the eager path, float64, on the stage's
             576 x 10,676 stand-in), its line with its seconds: the state
             and potential float64, accept at least
             :data:`REFKERNEL_ACCEPT`, a finite ESS per sample above 0,
             the problem's shape, and exactly its 128 ``draws`` launches
             in the bench's run (the fused stages launch none).
12. samplers — ``gravinv3dhmc_tpu_torch.samplers.run()``'s ``chees``,
             ``nuts`` and ``hmc`` on the 600 x 6000 uniformgrid problem at
             the tool's defaults (8 chains, 200 draws after 200 warmup;
             the honest fixed-L HMC with 64 chains), one line each with
             its seconds, the card and its launches: the samples, the
             chain state and the adaptation state must be CUDA tensors,
             the ``hmc`` run (the eager path: the fused kernels do not
             take its logistic target) must launch ``draws``, and the
             statistics must land within :data:`SAMPLER_BOUNDS` of the
             JAX package's on this configuration
             (``tools/samplers_tpu.json``); the plain Philox must not be
             called. Then ``draws`` at those runs' shapes (8 and 64 chains
             x 6016) against its plain version, timed
             (``samplers_kernel`` lines; its uniforms bit for bit).
             ChEES and NUTS write their draws' sample files
             (``samplers.run(save_folder=...)``), which ``load_chains``
             must read back as the draws within :data:`FILE_ROUNDING`.
13. cg     — ``gravinv3dhmc_tpu_torch.cg.run()``'s four stages on the
             card, one line each with its seconds, the card and its
             launches: ``cg`` (``examples/run.py cg``: float64 CG on the
             1,200 x 12,000 two-dyke problem), ``bootstrap`` (20 float64
             replicates on the 600 x 6000 problem in one batch),
             ``bootstrap_southchina`` (``examples/run.py
             bootstrap-southchina``: 20 float64 replicates on the 289 x
             1,579 carved mesh with ``wavelet="1D"``) and ``map`` (the
             float32 bounded MAP on the 576 x 10,676 tesseroid problem
             and its temperature T = 2 sigma_hat^2).
             Every returned tensor must be on the card, the histories
             finite, the models inside their box, ``cg``'s data misfit
             below 5 % of its start and its correlation with the truth
             above 0.5 (as ``tests/test_reginv.py`` holds the JAX solver);
             then each stage against the JAX package's golden numbers
             (``gravinv3dhmc_tpu_torch/golden/reginv_jax.json``, from
             ``tests/reginv_golden.py``), to the tolerances of
             :data:`GOLDEN` (see there for why the bootstraps and
             ``map`` are held as they are).
14. samplers_realdata — the calibrated realdata ChEES
             (``samplers.run(("realdata",))``) at full width (64 chains x
             10,676 cells) at the ``map`` stage's T, cut to 16 warmup and
             16 draws (``reduced``): its tensors on the card, one
             ``draws`` launch an iteration, no plain Philox; then ``draws``
             at 64 x 10,752 against its plain version, its uniforms bit
             for bit (``samplers_kernel``).

15. magnetic — the uniformgrid problem's magnetic twin
             (``uniformgrid.build_problem(field="magnetic")``: the block
             magnetized at 2 A/m along inclination 50, declination 20
             degrees, the f64 host ``tf`` matrix, whose columns have both
             signs): ``refresh``, ``drift``, ``residual``, ``kick``,
             ``traj_finish`` and ``accept`` against their plain versions at
             1024 chains on its bf16 op (accept's rejected rows back bit
             for bit, refresh's K0 within ``KERNEL_RTOL``), then
             ``uniformgrid.run_magnetic`` at full width (1024 chains, the
             bf16 iteration op, 3 chunks of 128, box [0, 3]):
             grad-evals/s, accept, every iteration kernel launched.
16. wavelet — the uniformgrid gravity problem with ``wavelet="1D"`` and
             ``"3D"``: one float32 leapfrog step on the card through the
             CSR products, the transform and its adjoint against the same
             step in float64 through the dense potential on ``Awcp W``,
             built from the host DWT of the identity (x, p, U within
             ``WAVELET_STEP_RTOL``), ``predict`` against the dense ``Aw``
             (the thresholding's error, < 1e-2), the eager run cut to
             ``WAVELET_CUT`` (64 chains; ``draws`` once an iteration), and
             the two sparse products timed beside ``torch.matmul`` with
             the dense ``Aw``.
17. magnetic_demo — ``gravinv3dhmc_tpu_torch.magnetic.run()``
             (``tools/magnetic_demo.py``'s constrained and wide
             configurations) with the ChEES cut to ``MAGNETIC_CUT``: the
             bounded MAPs' data misfits move (range > 1e-3 of the first)
             and stay finite, the tesseroids are built by the native
             engine, the ChEES statistics are finite with R-hat below
             ``MAGNETIC_RHAT``, ``draws`` once an iteration; then
             ``draws`` at the ChEES's 16 x 2,000 cells against its plain
             version, its uniforms bit for bit (``samplers_kernel``; the
             wavelet runs' 64 x 6,000 share the samplers' lane width).
18. prism_device — ``prism_kernel_matrix(backend="jax")`` (torch float64
             on the card) against the numpy float64 builder at ``cg``'s
             1,200 x 12,000, within ``PRISM_DEVICE_RTOL`` of max|A| (the
             JAX package's own device builder's gap, golden
             ``prism_device``, reported beside it); both builds timed.

19. joint  — ``inversion/joint.py`` on the uniformgrid flagship's mesh
             with both fields (1,200 x 12,000 block system, the
             magnetization twice the density along inclination 60,
             declination 10, as ``tests/test_joint.py``): the potential in
             f32 against the same module in f64 on the card (Smoothness,
             without and with the cross-gradient, 64 chains, within
             :data:`JOINT_RTOL`); ``HMCSample`` at 64 chains for 128 stored
             iterations with ``use_fused=True``, which the module (no host
             matrix) must decline for the eager path: one ``draws`` launch
             an iteration, accept in (0.2, 1], finite samples on the card;
             the spherical joint module evaluated finite on the card.
             Then ``draws`` at 64 x 12,000 against its plain version.
20. global — the whole-Earth workload at full scale
             (``global_tess.py``, 7,381 x 72,000, the 2.13 GB f32 matrix
             built and weighted on the card): the build's stages (the
             data's forward over the truth's cells, far field, native mask,
             native pair values, weighting) and
             :data:`GLOBAL_PAIRS` native near-field pairs; the device mask
             against the native one (each differing pair within
             :data:`GLOBAL_FLIP_RTOL` of its threshold); 2,000 sampled
             entries against the native engine within
             :data:`GLOBAL_ENTRY_RTOL`; the bounded MAP
             (:data:`GLOBAL_MAP`: the misfit moves, corr > 0.3, beside the
             JAX package's TPU statistics from ``GLOBAL_r05.json``); the
             eager HMC from the MAP (:data:`GLOBAL_HMC`: the windowed
             warmup with the Welford metric, chain storage; finite, accept
             in (0.2, 1], ``draws`` once an iteration) and one post-freeze
             chunk under ``torch.profiler`` (busy, idle share, the top
             device operations, busy ms a step beside the step's bound:
             two reads of the matrix). Then ``draws`` at 32 x 72,000
             against its plain version.
21. run    — ``gravinv3dhmc_tpu_torch.run.main(argv)`` (``python -m
             gravinv3dhmc_tpu_torch.run``, the port of ``examples/run.py``)
             for each of :data:`RUN_CASES`: uniformgrid, segmentgrid and
             ratiogrid (HMC), uniformgrid ChEES, realdata HMC and ChEES
             (its temperature from the bounded MAP), global (scale 0.25)
             map-only and HMC, cg (model04_complex), bootstrap and
             bootstrap-southchina, each at its full geometry with its
             depth cut; each prints one JSON line with the JAX driver's
             keys (:data:`RUN_KEYS`, held to the JAX lines by
             ``tests/test_torch_run.py``), finite statistics inside
             :data:`RUN_BOUNDS`, ``draws`` launched by every sampler run
             and no kernel by the others, and no plain Philox call. Then
             ``draws`` against its plain version at each distinct
             (chains, cells) that the sampler runs gave it.
22. profiling — one warm uniformgrid chunk (1024 chains, the bf16
             iteration op), then one inside ``profiling.device_trace``:
             the Chrome trace must name every iteration kernel
             (:data:`TRACE_KERNELS`) and ``profiling.memory_report()``
             report ``cuda:0`` with a non-zero peak.
23. multichip — the multi-device sampler (``parallel/``). ``draws`` at a
             shard's offsets: a 512 x 3,000 block at (c0, j0) = (512,
             750) equals the same block of one 1024 x 6,016 launch bit for
             bit, its uniforms the plain version's at those offsets bit
             for bit and its normals within ``KERNEL_RTOL``; at the blocks
             the ranks launch (1024 and 512 x 3,000 at element offset
             3,000) against its plain version and timed beside its bound
             and ``torch.randn`` + ``torch.rand`` (``multichip_kernel``
             lines). Then groups
             of ranks started by ``python -m torch.distributed.run
             --standalone`` (``gravinv3dhmc_tpu_torch.multichip_check``),
             all at once, while this process runs their unsharded
             counterparts on the card: ``run.py uniformgrid --multichip``
             at world size 1 over NCCL (the flagship, 1024 chains) equals
             the same command without ``--multichip`` bit for bit (every
             number of the line but the timings, and every chain's accept
             count); over gloo with 2 ranks (1, 2) and 4 ranks (2, 2), all
             on ``cuda:0``, the float64 runs of
             ``multichip_check.RUNS`` at full width (1024 x 6,000; a
             fixed-dt run, the windowed warmup, and at (1, 2) Smoothness
             through the z-halo branch) take the unsharded runs' accept
             counts and end within :data:`MULTICHIP_RTOL` of their state,
             step size and inverse mass; the float32 command line under
             (2, 2) lands within :data:`MULTICHIP_F32` of the unsharded
             line (accept ratio, RMSD, RMSM), with the number of chains
             whose accept count differs printed. Ranks that share one card
             go through gloo, which stages every collective through the
             host: these are checks of numbers, not of speed. The ranks'
             ``draws`` launches (summed over each group) and this
             process's go into the kernels line.
24. studies — right after phase 20, on its scale-1 module and matrix
             (no second build), the whole-Earth studies and the sampler's
             roofline (:data:`STUDIES`), one line each, printed before its
             checks: ``bounded_map.run`` uncut (the anchor, then the ladder
             of ``maxk`` 400 each): every number finite, the ladder's
             alphas the rule's from ``alpha_ref`` (printed beside the JAX
             record's), each ``n_iters`` at most ``maxk``;
             ``global_chees.run`` cut in depth only (16 chains, 32 warmup
             and 32 samples, ``max_steps`` 64, blocks of 16): the (32, 16,
             72,000) buffer on the card, accept in (0, 1], one ``draws``
             launch an iteration and no plain Philox; ``roofline.run``
             uncut (1024 chains x 600 x 6,000, ``reps`` 200): the
             matmul pair at most 1.05 x 989 TFLOP/s on both clocks, every
             trajectory time positive, a positive slope of both t(L) fits,
             and launches of the trajectory op's kernels, ``refresh``,
             ``accept`` and ``draws``. The quality numbers of the JAX
             package's ``GLOBAL_r05.json`` records (corr, RMSM, coverage,
             accept, saturation) are printed beside the card's: statistics
             to compare, not checks. The studies' launches, each counted
             from 0 around its run, go into the kernels line. Then
             ``draws`` at 16 x 72,000 and 1024 x 6,000 against its plain
             version.

Before phase 13 its 576 x 10,676 realdata problem is built with a
kernel cache and again from the cache (``state`` line ``kernel_cache``):
``A``, ``Aw`` and the weights must be bit equal, both build times
printed.

Phase 13 also runs ``cg``'s ``bootstrap_southchina`` stage (the carved
South China mesh, 20 float64 replicates with ``wavelet="1D"``) and holds
it against its golden entry (see :data:`GOLDEN`).

Slice 1's launch counts are read around phase 6 (bf16 and f32), the
shared-L card run's in phase 6's reference, the state runs' in phase
6c, the realdata-width f32
trajectory's in phase 6b and both on the tesseroid matrix in phase 11,
the unstructured gz build's in phase 7, slice 2's (bf16 and f32) in
phase 8, the bench's (both stages) in phase 11, the samplers' (``draws``:
ChEES's and the honest HMC's) in phase 12, the deterministic stages' in
phase 13 (their products are ``torch.matmul``, so none), the realdata
ChEES's in phase 14, the magnetic stage's in phase 15, the wavelet
runs' in phase 16, the magnetic demo's ChEES's in phase 17, the joint
HMC's in phase 19, the whole-Earth HMC's in phase 20, the command line's
subcommands' in phase 21, the profiled chunks' in phase 22 and the
multi-device runs' (their ranks' and their unsharded counterparts') in
phase 23, the studies' in phase 24 (the live
reference run's ``draws`` are in phase 11's): these
runs' counts make the
``launches`` of the kernels line. ``draws``
and ``refresh`` are bounded by the issued
instructions of their Philox and Box-Muller, counted in phase 1; ``draws``'s
library time is ``torch.randn`` and ``torch.rand`` of its shapes. Around the
slices,
the plain Philox draws (``ops.philox.momentum_normals``,
``accept_uniforms``) must not be called. The last three lines are the
card (``nvidia-smi`` name and power limit),
one JSON object with every kernel's numbers, and the result line
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero before
printing any result.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

# tolerances, stated up front (relative to the largest |reference| value
# of each output, so near-zero entries do not dominate):
#   kernels vs plain on identical inputs differ only in summation order
#   (GEMM and row reductions) and in cos/log ulps of the Philox normals
KERNEL_RTOL = 1e-4
#   whole trajectories: f32 keeps f32 rounding; with bf16 storage each
#   step rounds x and r to 8 bits, and an x that differs by one f32 ulp
#   between the two versions can round to a different bf16 value, so the
#   bound is bf16's (2^-8 ~ 4e-3) times a few steps. g = (pk - p)/eps
#   divides the momentum rounding by eps: looser. ("U" stands for every
#   output without its own entry.)
TRAJ_RTOL = {"float32": {"x": 1e-4, "p": 1e-4, "g": 1e-4, "U": 1e-4},
             "bfloat16": {"x": 2e-2, "p": 5e-2, "g": 1e-1, "U": 2e-2}}
#: chains of the step op's check (the trajectory and iteration checks
#: run at 256 too)
STEP_CHAINS = 256
#: the f32-matrix GEMMs against float64: their error over max|product|
#: may be at most this many times that of one IEEE-f32 matmul
F32_ERR_RATIO = 2.0
#: the ragged chain count at which the tensor-core GEMMs are checked
#: beside the slices' (rows past it come from TMA's zero fill and are
#: neither read nor stored)
RAGGED_CHAINS = 200
#: the card's published peaks (NVIDIA H100 SXM data sheet, dense, at its
#: 700 W limit): device memory bytes/s, and operations/s by type: bf16
#: tensor-core FLOP and the f32 FLOP rate outside the tensor cores
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "f32": 67e12}
#: the issued instructions of one unit of work of the SIMT kernels whose
#: work is not f32 FLOP (Philox, logf, sincosf, atanf, IEEE division and
#: square root), by pipe class: ``sass.unit_counts`` of the libraries
#: this run built (``normal4``: four momentum normals, ``uniform``: one
#: accept uniform, ``node``: one node value of the gz matrix), set by the
#: build phase; their least time is ``sass.instruction_seconds``
UNITS = {}


def line(phase, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def rel_err(out, ref):
    """max |out - ref| and that over max |ref|."""
    err = (out.double() - ref.double()).abs().max().item()
    scale = max(ref.double().abs().max().item(), 1e-30)
    return err, err / scale


def time_ms(torch, fn, reps=20, warmup=3, rounds=5):
    """Device time of one call of ``fn``: the median over ``rounds`` of the
    mean over ``reps`` calls (``timing.device_ms``: CUDA events around
    calls queued behind a spin of the card, so that the host's issue time
    is not timed), after ``warmup`` calls."""
    from gravinv3dhmc_tpu_torch.timing import device_ms

    for _ in range(warmup):
        fn()
    return float(np.median([device_ms(fn, reps, warmup=0)
                            for _ in range(rounds)]))


def work(name, a, accepted=None, simt=False):
    """(bytes, {type: operations}) that kernel ``name`` must move and do
    on its arguments ``a``: each input read once and each output written
    once (scratch such as split partials, and an f32 matrix's bf16
    pieces, not counted: the matrix is read as f32), and where the work
    depends on the data (accept's restore of rejected chains, the gz
    matrix's distinct nodes) what this run's data needs. ``simt``: a
    GEMM's product as one f32 product outside the tensor cores. Type
    "sass" holds issued instructions by class (``sass.scaled`` of
    :data:`UNITS`)."""
    from gravinv3dhmc_tpu_torch import sass

    def nb(t):
        return t.numel() * t.element_size() if t is not None else 0

    def gemm(A, flop, f32):
        # on the tensor cores one bf16 product with a bf16 matrix, six
        # with an f32 one (three bf16 pieces of each operand)
        if simt:
            return {"f32": f32 + flop}
        return {"bf16": (1 if A.element_size() == 2 else 6) * flop,
                "f32": f32}

    if name.endswith("_f32"):
        name = name[:-len("_f32")]

    if name == "refresh":
        g, U, pscale, im, _, _, _, n01, p, pk, H0 = a
        C, Mp = g.shape
        nbytes = (nb(g) + nb(U) + nb(pscale) + nb(im) + nb(n01) + nb(p)
                  + nb(pk) + nb(H0))
        if n01 is not None:
            return nbytes, {"f32": 6 * C * Mp}
        # the normals drawn in registers; p0 = s n, K += (w p0) p0, p
        # = p0 - e/2 g: 6 FP32 instructions an element
        return nbytes, {"sass": sass.scaled((UNITS["normal4"], C * Mp // 4),
                                            fma=6 * C * Mp)}
    if name == "draws":
        # 4 normals a counter, one uniform a chain
        n01, u = a[0], a[1]
        return nb(n01) + nb(u), {"sass": sass.scaled(
            (UNITS["normal4"], n01.numel() // 4), (UNITS["uniform"],
                                                   u.numel()))}
    if name == "drift":
        x, p, pk, im, low, high = a[:6]
        return (2 * (nb(x) + nb(p)) + nb(pk) + nb(im) + nb(low) + nb(high),
                {"f32": 7 * x.numel()})
    if name in ("residual", "step_residual"):
        x, A = a[0], a[1]
        C, Dp = x.shape[0], A.shape[0]
        vecs = a[2:5] if name == "step_residual" else a[2:4]
        outs = a[6:8] if name == "step_residual" else a[4:5]
        return (nb(x) + nb(A) + sum(nb(v) for v in vecs)
                + sum(nb(o) for o in outs),
                gemm(A, 2 * C * Dp * x.shape[1], 4 * C * Dp))
    if name == "kick":
        r, A, x, p, aprior, gm_scale = a[:6]
        return (nb(r) + nb(A) + nb(x) + 2 * nb(p) + nb(aprior)
                + nb(gm_scale),
                gemm(A, 2 * r.shape[0] * r.shape[1] * A.shape[1],
                     (11 if a[9] else 5) * p.numel()))
    if name == "traj_finish":
        x, p, pk, r, g, U, ud, um, aprior, wmsq = a[:10]
        return (nb(x) + 2 * nb(p) + nb(pk) + nb(r) + nb(g) + nb(U) + nb(ud)
                + nb(um) + nb(aprior) + nb(wmsq),
                {"f32": 10 * x.numel() + 2 * r.numel()})
    if name == "accept":
        x, g, U, ud, um, p, H0 = a[:7]
        C, Mp = x.shape
        rejected = C - accepted
        return (nb(p) + nb(a[12]) + nb(U) + nb(H0) + nb(a[15]) + nb(a[16])
                + rejected * (16 * Mp + 24),
                {"f32": 3 * p.numel() + (100 + 8) * C})
    if name == "step_misfit":
        x = a[0]
        return (nb(x) + nb(a[1]) + nb(a[2]) + nb(a[3]) + nb(a[4]) + nb(a[5]),
                {"f32": 6 * x.numel()})
    if name in ("gz", "gz_nodes"):
        # one bound for both: F once per distinct node and observation,
        # then 8 FP32 adds and the scale an entry (the corner kernel, which
        # evaluates F 8 times an entry, is held to the same work); bytes:
        # the observations, the cells (bounds or node tables), the matrix
        obs = a[0]
        if name == "gz":
            from gravinv3dhmc_tpu_torch.ops.prism_gz import node_tables

            cells = a[1]
            n_nodes = node_tables(cells.cpu().numpy()).n_nodes
            M, inputs = cells.shape[0], nb(cells)
        else:
            ux, uy, uz, cells, offsets = a[1:6]
            n_nodes = ux.numel() * uy.numel() * uz.numel()
            M = cells.shape[0]
            inputs = sum(nb(t) for t in (ux, uy, uz, cells, offsets))
        D = obs.shape[0]
        return (nb(obs) + inputs + 4 * D * M,
                {"sass": sass.scaled((UNITS["node"], D * n_nodes),
                                     fma=9 * D * M)})
    raise KeyError(name)


def bound(name, a, accepted=None, simt=False):
    """``(bound_ms, bound_by)``: the least time the card could take for
    ``name`` on ``a`` at its published peaks, the larger of bytes over the
    memory rate and operations over their peak rates (issued instructions
    over their issue and pipe rates, ``sass.instruction_seconds``)."""
    from gravinv3dhmc_tpu_torch import sass

    nbytes, ops = work(name, a, accepted, simt)
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = sum(n / PEAK_OPS_S[k] for k, n in ops.items() if k != "sass")
    t_ops = (t_ops + sass.instruction_seconds(ops.get("sass", {}))) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def library_call(torch, name, a):
    """One PyTorch call computing the function of a kernel on the same
    operands, or None: a bf16 GEMM's product (the operand cast to bf16
    beforehand); for ``draws``, ``torch.randn`` and ``torch.rand`` of its
    shapes (the same distribution, not the same values)."""
    if name == "draws":
        n01, u = a[0], a[1]
        return lambda: (torch.randn(n01.shape, device=n01.device),
                        torch.rand(u.shape, device=u.device))
    if name not in ("residual", "step_residual", "kick") or \
            a[1].dtype != torch.bfloat16:
        return None
    # (the f32 GEMMs' call is f32_gemm_check.library_fn)
    if name == "kick":
        rb, A = a[0].to(torch.bfloat16), a[1]
        return lambda: torch.matmul(rb, A)
    xb, At = a[0].to(torch.bfloat16), a[1].T
    return lambda: torch.matmul(xb, At)


def fused_args(module, dobs, high=1.0):
    M = module.n_active
    w = module.wdiag
    return (module.Aw, dobs - dobs.mean(), None, w * np.full(M, 0.001),
            w * w, w * np.zeros(M), w * np.full(M, high))


def phase_philox(torch, tlf, philox, dev):
    salt = philox.salt_from_seed(2024)
    C, width = 256, 4096                       # 1,048,576 draws
    bits_k = tlf.philox_bits_cuda(salt, 9, C, width, dev)
    bits_p = philox.momentum_bits(salt, 9, C, width, dev)
    if not torch.equal(bits_k, bits_p):
        fail("philox: kernel words differ from ops/philox.py")
    # the refresh kernel's normals: pscale = im = 1, g = 0, eps = 0
    zeros = torch.zeros((C, width), device=dev)
    ones = torch.ones(width, device=dev)
    p, pk = torch.empty_like(zeros), torch.empty_like(zeros)
    H0 = torch.empty(C, device=dev)
    tlf.KERNELS["refresh"](zeros, torch.zeros(C, device=dev), ones, ones,
                           0.0, salt, 9, None, p, pk, H0)
    # its p-only form (pk null, the per-step path's) draws the same bits
    p_only, H0_only = torch.empty_like(zeros), torch.empty_like(H0)
    tlf.KERNELS["refresh"](zeros, torch.zeros(C, device=dev), ones, ones,
                           0.0, salt, 9, None, p_only, None, H0_only)
    ref = philox.momentum_normals(salt, 9, C, width, dev)
    err, _ = rel_err(p, ref)
    n = p.double()
    N = n.numel()
    mean, var = n.mean().item(), n.var().item()
    ok = (err < 1e-5 and abs(mean) < 5 / np.sqrt(N)
          and abs(var - 1) < 5 * np.sqrt(2 / N))
    # the draws kernel: its uniforms are the top 24 bits of the accept
    # words, so equal bit for bit; its normals are refresh's (one device
    # function) and the plain version's within cos/log ulps
    draws = tlf.KERNELS["draws"]
    n_k, u_k = torch.empty((C, width), device=dev), torch.empty(C, device=dev)
    n_p, u_p = torch.empty_like(n_k), torch.empty_like(u_k)
    draws(n_k, u_k, salt, 9)
    draws.plain(n_p, u_p, salt, 9)
    sync(torch)
    uniforms_equal = torch.equal(u_k, u_p)
    as_refresh = torch.equal(n_k, p)
    p_only_same = (torch.equal(p_only, p) and torch.equal(pk, p)
                   and torch.equal(H0_only, H0))
    draws_err = rel_err(n_k, n_p)[1]
    # the code whose SASS bounds draws and refresh, run alone: its values
    # are draws' (counters j0 .. j1 - 1 of chain c)
    j0, j1, c = 517, 520, 201
    n4, u1 = tlf.draw_units_cuda(salt, 9, j0, j1, c, dev)
    once_equal = (torch.equal(n4, n_k[c, 4 * j0:4 * j1])
                  and torch.equal(u1, u_k[c:c + 1]))
    line("philox", bits_equal=True, normals=N, max_abs_err=err, mean=mean,
         var=var, draws_uniforms_bit_equal=uniforms_equal,
         draws_normals_rel_err=draws_err, draws_equal_refresh=as_refresh,
         refresh_p_only_same=p_only_same, counted_code_equal=once_equal)
    if not once_equal:
        fail("philox: momentum4 / accept_uniform alone differ from draws")
    if not ok or not p_only_same:
        fail(f"philox normals (refresh's p-only form the same: "
             f"{p_only_same})")
    if not uniforms_equal or not as_refresh or draws_err > KERNEL_RTOL:
        fail(f"philox: draws kernel (uniforms equal {uniforms_equal}, "
             f"normals as refresh's {as_refresh}, rel err {draws_err})")


def kernel_cases(torch, op, C, dev, share=0.5):
    """Inputs for each kernel at the op's shapes (the op's regularization;
    ``accept`` with the share ``share`` of chains accepted); returns name
    -> (args builder, outputs to compare: args -> {name: tensor})."""
    from gravinv3dhmc_tpu_torch.ops import philox

    pp = op._padded
    Mp, Dp = op.Mp, op.Dp
    ms = op.regularization == "MS"
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device=dev)

    mask = (pp["high"] > 0).float()
    x = (0.3 + 0.05 * randn(C, Mp)) * pp["high"]
    p = randn(C, Mp, scale=1e-3) * mask
    g = randn(C, Mp, scale=10.0) * mask
    r = randn(C, Dp, scale=0.1) * pp["dmask"]
    U = 200.0 + randn(C)
    salt = philox.salt_from_seed(5)
    e = 0.01
    # refresh and accept sum a kinetic energy K = 0.5 sum im p^2 per
    # chain. At the slice's Sigma = 0.001 K is ~0.003, below the rounding
    # of K + U, so they are checked with momenta of order 1 (pscale 1, p
    # ~ N(0, 1)) and a random inverse mass in [0.1, 1]: K ~ 1600.
    im = torch.where(mask > 0, 0.1 + 0.9 * torch.rand(
        Mp, generator=gen, device=dev), torch.ones_like(mask))

    def f(*shape):
        return torch.empty(*shape, device=dev)

    return {
        "refresh": (lambda: (g.clone(), U.clone(), mask, im, 0.5 * e, salt,
                             3, None, f(C, Mp), f(C, Mp), f(C)),
                    lambda a: {"p": a[8], "pk": a[9], "K0": kinetic0(a)}),
        **open_close_cases(torch, g, U, mask, im, e, salt, op.M, share,
                           dev),
        "drift": (lambda: (x.clone(), p.clone(), f(C, Mp), pp["im"],
                           pp["low"], pp["high"], e),
                  lambda a: {"x": a[0], "p": a[1], "pk": a[2]}),
        "residual": (lambda: (x.clone(), pp["A"], pp["dobs"], pp["dmask"],
                              f(C, Dp)), lambda a: {"r": a[4]}),
        "kick": (lambda: (r.clone(), pp["A"], x.clone(), p.clone(),
                          pp["aprior"], pp["gm_scale"], 2 * e, e,
                          op.beta, ms), lambda a: {"p": a[3]}),
        "traj_finish": (lambda: (x.clone(), p.clone(), p + g * e, r.clone(),
                                 f(C, Mp), f(C), f(C), f(C), pp["aprior"],
                                 pp["wmsq"], 1.0 / e, 1.0, op.beta, ms),
                        lambda a: {"p": a[1], "g": a[4], "U": a[5],
                                   "ud": a[6], "um": a[7]}),
    }


def kinetic0(a):
    """refresh's K0 = H0 - U, in f64 from the kernel's f32 H0."""
    return a[10].double() - a[1].double()


def open_close_cases(torch, g, U, mask, im, e, salt, M, share, dev):
    """The cases of the kernels that open and close a fused sampler's
    iteration at the state's shape: ``refresh`` in its p-only form (the
    per-step path's, ``pk`` None) and ``accept`` with the share ``share``
    of chains accepted. Accept's H0 puts each chain's log accept ratio 0.5
    to a chosen side of its Philox uniform (``accept_tune.operands``), far
    from a tie at f32 rounding; a kernel that drops, halves or mis-weights
    K1 moves H1 by hundreds and accepts every planned rejection."""
    from gravinv3dhmc_tpu_torch.accept_tune import operands

    C, Mp = g.shape
    return {
        "refresh (p only)": (
            lambda: (g.clone(), U.clone(), mask, im, 0.5 * e, salt, 3, None,
                     torch.empty((C, Mp), device=dev), None,
                     torch.empty(C, device=dev)),
            lambda a: {"p": a[8], "K0": kinetic0(a)}),
        "accept": (lambda: operands(C, Mp, M, share, device=dev),
                   lambda a: {"x": a[0], "g": a[1], "U": a[2], "ud": a[3],
                              "um": a[4], "acc": a[16]}),
    }


def accept_rows_keep_bits(torch, before, after):
    """``accept``'s arguments before and after a launch: every rejected
    chain's x, g, U, ud, um are its carried x_in, g_in, U_in, ud_in, um_in
    bit for bit, and every accepted chain's the proposal's."""
    acc = after[16] > 0.5
    rows = torch.int32
    for out, prop, carried in zip(after[:5], before[:5], before[7:12]):
        want = torch.where(acc.view(-1, *([1] * (out.dim() - 1))), prop,
                           carried)
        if not torch.equal(out.view(rows), want.view(rows)):
            return False
    return True


def phase_kernels(torch, tlf, op, C, dev):
    """Each kernel against its plain version on the same inputs; every
    output within ``KERNEL_RTOL`` of the plain one relative to its largest
    |value| (accept flags identical, with both decisions taken); then the
    residual GEMM's own checks."""
    plan = tlf.residual_plan(C, op.Dp, op.Mp, 1)
    line("residual_plan", shape=[C, op.Dp, op.Mp], **plan)
    res = run_kernel_cases(torch, tlf, kernel_cases(torch, op, C, dev),
                           [C, op.Dp, op.Mp], "kernel")
    check_gemm(torch, tlf, "residual", {
        n: kernel_cases(torch, op, n, dev)["residual"]
        for n in (C, RAGGED_CHAINS)}, "kernel")
    check_kick(torch, tlf, {n: kernel_cases(torch, op, n, dev)["kick"][0]
                            for n in (C, RAGGED_CHAINS)}, "kernel")
    return res


def gemm_reference(torch, name, args):
    """``name``'s outputs from the float64 product of the same
    bf16-rounded operands (x rounded to nearest even, as the kernel and the
    plain version round it)."""
    x, A = args[0], args[1]
    d = x.to(A.dtype).double() @ A.double().T
    if name == "residual":
        dobs, dmask = args[2].double(), args[3].double()
        return {"r": (d - dobs) * dmask}
    fix, dobs, dmask, inv_nobs = (args[2].double(), args[3].double(),
                                  args[4].double(), args[5])
    d = d + fix
    r = ((d - d.sum(1, keepdim=True) * inv_nobs) - dobs) * dmask
    return {"r": r, "ud": (r * r).sum(1)}


def partials_guarded(torch, tlf, x, A, pieces=None):
    """The split GEMM alone, through the library's entry, with a NaN guard
    slice after its partials: True when a store past the last chain row
    (which would land in the guard) did not happen. An f32 A takes its
    bf16 ``pieces``."""
    from gravinv3dhmc_tpu_torch.ops import _cuda

    C, Mp = x.shape
    Dp = A.shape[0]
    f32 = torch.float32
    mode = tlf._a_mode(A)
    splits = tlf.residual_plan(C, Dp, Mp, mode)["splits"]
    part = torch.full((splits + 1, C, Dp), float("nan"), device=x.device)
    r = torch.empty((C, Dp), device=x.device)
    zeros = torch.zeros(Dp, device=x.device)
    ones = torch.ones(Dp, device=x.device)
    P = _cuda.ptr
    _cuda.library().call(
        "lf_residual", P(x, f32), tlf._matrix(mode, A, pieces), mode,
        P(zeros, f32), P(ones, f32), P(r, f32), P(part, f32), splits, C, Dp,
        Mp, _cuda.stream(x))
    sync(torch)
    return bool(torch.isnan(part[splits]).all())


def check_gemm(torch, tlf, name, cases, phase):
    """The tensor-core residual GEMM under ``name`` at each chain count of
    ``cases`` (chains -> (args builder, outputs)): its split plan, two
    launches bit for bit equal, kernel vs plain within ``KERNEL_RTOL``,
    both against the float64 product of the same bf16-rounded operands
    (the kernel within ``KERNEL_RTOL`` of it), and no store past the last
    chain."""
    kern = tlf.KERNELS[name]
    for C, (make, outputs) in cases.items():
        a1, a2, ap = make(), make(), make()
        kern(*a1)
        kern(*a2)
        kern.plain(*ap)
        sync(torch)
        o1, o2, op = outputs(a1), outputs(a2), outputs(ap)
        ref = gemm_reference(torch, name, a1)
        x, A = a1[0], a1[1]
        plan = tlf.residual_plan(C, A.shape[0], A.shape[1], 1)
        stages = [(b - a) // plan["tile"][2] for a, b in plan["slices"]]
        bit_equal = all(torch.equal(o1[k], o2[k]) for k in o1)
        errs = {"kernel_vs_plain": max(rel_err(o1[k], op[k])[1] for k in o1),
                "kernel_vs_f64": max(rel_err(o1[k], ref[k])[1] for k in o1),
                "plain_vs_f64": max(rel_err(op[k], ref[k])[1] for k in o1)}
        guarded = partials_guarded(torch, tlf, x, A)
        line(phase, gemm=name, shape=[C, A.shape[0], A.shape[1]],
             tile=plan["tile"], splits=plan["splits"], blocks=plan["blocks"],
             waves=plan["waves"], stages_per_slice=[min(stages), max(stages)],
             bit_equal=bit_equal, guard_intact=guarded, **errs)
        if not bit_equal or not guarded or max(
                errs["kernel_vs_plain"], errs["kernel_vs_f64"]) > KERNEL_RTOL:
            fail(f"gemm {name} at {C} chains: bit_equal={bit_equal}, "
                 f"guard={guarded}, errors {errs} (limit {KERNEL_RTOL})")


def kick_reference(a):
    """The kick's p from the float64 product of the same bf16-rounded r
    (rounded to nearest even, as the kernel and the plain version round
    it) and a float64 epilogue."""
    r, A, x, p, aprior, gm_scale, s_data, s_mod, beta, ms = a
    gdata = r.to(A.dtype).double() @ A.double()
    dm = x.double() - aprior.double()
    gm = gm_scale.double() * dm / (dm * dm + beta) ** 2 if ms else dm
    return p.double() - s_data * gdata - s_mod * gm


def kick_product(a):
    """The kick's arguments with p = 0, s_mod = 0 and s_data = -1: its
    result is the bare product r A, not hidden under |p|."""
    return a[:3] + (a[3].new_zeros(a[3].shape),) + a[4:6] + (-1.0, 0.0) \
        + a[8:]


def kick_guarded(torch, tlf, a, tile_m):
    """The kick through the library's entry on x and p with rows past the
    last chain up to the tile's edge and one more: x finite there, p NaN.
    Returns whether those rows of p kept their bits (a store there, even
    of a NaN computed from them, leaves the card's canonical NaN bits)
    and the rows < C."""
    from gravinv3dhmc_tpu_torch.ops import _cuda

    r, A, x, p, aprior, gm_scale, s_data, s_mod, beta, ms = a[:10]
    pieces = a[10] if len(a) > 10 else None
    mode = tlf._a_mode(A)
    C, Mp = x.shape
    rows = -(-C // tile_m) * tile_m + 1
    xg = torch.full((rows, Mp), 0.5, device=x.device)
    pg = torch.full((rows, Mp), float("nan"), device=x.device)
    xg[:C], pg[:C] = x, p
    guard = pg[C:].clone()
    f32, P = torch.float32, _cuda.ptr
    _cuda.library().call(
        "lf_kick", P(r, f32), tlf._matrix(mode, A, pieces), mode, P(xg, f32),
        P(pg, f32), P(aprior, f32), P(gm_scale, f32), C, r.shape[1], Mp,
        s_data, s_mod, beta, int(ms), _cuda.stream(x))
    sync(torch)
    return (torch.equal(pg[C:].view(torch.int32), guard.view(torch.int32)),
            pg[:C])


def check_kick(torch, tlf, cases, phase):
    """The tensor-core kick at each chain count of ``cases`` (chains ->
    args builder): its plan, two launches bit for bit equal, kernel vs
    plain and both against float64 (``kick_reference``) for the kick as
    given and for the bare product, all within ``KERNEL_RTOL``; NaN guard
    rows after the last chain kept bit for bit; its time beside its
    bound and one PyTorch matmul of the same product."""
    kern = tlf.KERNELS["kick"]
    for C, make in cases.items():
        r, A = make()[:2]
        Dp, Mp = A.shape
        plan = tlf.kick_plan(C, Dp, Mp)
        errs, outs, bit_equal = {}, {}, True
        for case, build in (("kick", make), ("product",
                                             lambda: kick_product(make()))):
            a1, a2, ap, ar = build(), build(), build(), build()
            kern(*a1)
            kern(*a2)
            kern.plain(*ap)
            sync(torch)
            ref = kick_reference(ar)
            bit_equal &= torch.equal(a1[3], a2[3])
            outs[case] = a1[3]
            errs[case] = {"kernel_vs_plain": rel_err(a1[3], ap[3])[1],
                          "kernel_vs_f64": rel_err(a1[3], ref)[1],
                          "plain_vs_f64": rel_err(ap[3], ref)[1]}
        guarded, rows = kick_guarded(torch, tlf, make(), plan["tile"][0])
        same_rows = torch.equal(rows, outs["kick"])
        bench = make()
        ms = time_ms(torch, lambda: kern(*bench))
        library_ms = time_ms(torch, library_call(torch, "kick", bench))
        bound_ms, bound_by = bound("kick", bench)
        line(phase, gemm="kick", shape=[C, Dp, Mp], tile=plan["tile"],
             blocks=plan["blocks"], waves=plan["waves"],
             blocks_per_sm=plan["blocks_per_sm"], bit_equal=bit_equal,
             guard_intact=guarded, guard_launch_same=same_rows, **errs,
             ms=ms, library_ms=library_ms, bound_ms=bound_ms,
             bound_by=bound_by, share_of_bound=bound_ms / ms)
        worst = max(e for case in errs.values() for k, e in case.items()
                    if k != "plain_vs_f64")
        if not (bit_equal and guarded and same_rows) or worst > KERNEL_RTOL:
            fail(f"gemm kick at {C} chains: bit_equal={bit_equal}, "
                 f"guard={guarded}, same rows={same_rows}, errors {errs} "
                 f"(limit {KERNEL_RTOL})")


def run_kernel_cases(torch, tlf, cases, shape, phase):
    """Run each case through the kernel and its plain version, compare,
    time both; returns name -> errors and times."""
    results = {}
    for name, (make, outputs) in cases.items():
        kname = name.split()[0]   # "refresh (p only)" is refresh's case
        kern = tlf.KERNELS[kname]
        args_k = make()
        args_p = tuple(a.clone() if torch.is_tensor(a) else a
                       for a in args_k)
        kern(*args_k)
        kern.plain(*args_p)
        sync(torch)
        out_k, out_p = outputs(args_k), outputs(args_p)
        worst_abs, errs = 0.0, {}
        for o in out_k:
            if not torch.isfinite(out_k[o]).all():
                fail(f"kernel {name}: non-finite output {o}")
            a, errs[o] = rel_err(out_k[o], out_p[o])
            worst_abs = max(worst_abs, a)
        extra = {}
        if name == "accept":
            C = out_k["acc"].shape[0]
            n_acc = int(out_k["acc"].sum().item())
            extra["accepted"] = n_acc
            extra["rows_keep_bits"] = accept_rows_keep_bits(torch, make(),
                                                            args_k)
            if not torch.equal(out_k["acc"], out_p["acc"]):
                fail("kernel accept: decisions differ from the plain ones")
            if not 0 < n_acc < C:
                fail(f"kernel accept: {n_acc} of {C} accepted, want both "
                     "decisions exercised")
            if not extra["rows_keep_bits"]:
                fail("kernel accept: a rejected chain did not get its "
                     "carried state back bit for bit, or an accepted one "
                     "lost its proposal's bits")
        bench_k, bench_p = make(), make()
        ms = time_ms(torch, lambda: kern(*bench_k))
        plain_ms = time_ms(torch, lambda: kern.plain(*bench_p))
        lib = library_call(torch, kname, bench_k)
        bound_ms, bound_by = bound(kname, bench_k, extra.get("accepted"))
        worst_rel = max(errs.values())
        results[name] = {"max_abs_err": worst_abs, "rel_err": worst_rel,
                         "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": time_ms(torch, lib) if lib else None}
        line(phase, name=name, shape=shape, rel_errs=errs, **extra,
             **results[name])
        if worst_rel > KERNEL_RTOL:
            fail(f"kernel {name}: rel err {worst_rel:.3g} > {KERNEL_RTOL}")
    return results


def phase_traj(torch, tlf, module, dobs, dev):
    C, L = 256, 7
    M = module.n_active
    w = torch.as_tensor(module.wdiag, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = (0.3 + 0.05 * torch.randn(C, M, generator=gen, device=dev)) * w
    p0 = 1e-3 * torch.randn(C, M, generator=gen, device=dev)
    inv_mass = 10.0 ** (-2 * torch.rand(M, generator=gen, device=dev))
    for dtype in ("float32", "bfloat16"):
        for reg in ("MS", "Damping"):
            op = tlf.make_fused_trajectory(
                *fused_args(module, dobs), regularization=reg, beta=0.001,
                matvec_dtype=getattr(torch, dtype), device=dev)
            for im in (None, inv_mass):
                p = p0 if im is None else p0 / torch.sqrt(im)
                out_k = op(x, p, L, 0.01, 1.0, inv_mass=im)
                out_p = op(x, p, L, 0.01, 1.0, inv_mass=im, plain=True)
                errs = {}
                for nm, a, b in zip(("x", "p", "g", "U", "ud", "um"),
                                    out_k, out_p):
                    if not torch.isfinite(a).all():
                        fail(f"traj {dtype} {reg}: non-finite {nm}")
                    errs[nm] = rel_err(a, b)[1]
                lim = TRAJ_RTOL[dtype]
                bad = [nm for nm in errs
                       if errs[nm] > lim.get(nm, lim["U"])]
                line("traj", dtype=dtype, reg=reg, inv_mass=im is not None,
                     C=C, L=L, rel_err=errs)
                if bad:
                    fail(f"traj {dtype} {reg}: {bad} beyond {lim}")


def phase_iter(torch, tlf, philox, module, dobs, dev):
    C, L = 256, 7
    M = module.n_active
    op = tlf.make_fused_iteration(
        *fused_args(module, dobs), regularization="MS", beta=0.001,
        Sigma=0.001, matvec_dtype=torch.bfloat16, device=dev)
    fa = fused_args(module, dobs)
    pot = module.make_potential(fa[3], fa[5], fa[6], regularization="MS",
                                beta=0.001, device=dev)
    w = torch.as_tensor(module.wdiag, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    x = (0.3 + 0.05 * torch.randn(C, M, generator=gen, device=dev)) * w
    U, g, (_, ud, um) = pot(x, 1.0)
    n01 = torch.randn(C, M, generator=gen, device=dev)
    u = torch.rand(C, generator=gen, device=dev)
    seed = (philox.salt_from_seed(3), 11)
    out_k = op(x, U, g, ud, um, seed, L, 0.01, 1.0, n01=n01, u=u)
    out_p = op(x, U, g, ud, um, seed, L, 0.01, 1.0, n01=n01, u=u,
               plain=True)
    if not torch.equal(out_k[5], out_p[5]):
        fail("iter: accept flags differ with injected draws")
    lim = TRAJ_RTOL["bfloat16"]
    errs = {nm: rel_err(a, b)[1] for nm, a, b in
            zip(("x", "U", "g", "ud", "um"), out_k[:5], out_p[:5])}
    bad = [nm for nm, e in errs.items() if e > lim.get(nm, lim["U"])]
    # forced rejection: the carried state comes back bit for bit
    U_low = torch.full_like(U, -1e30)
    rej = op(x, U_low, g, ud, um, seed, L, 0.01, 1.0, n01=n01, u=u)
    kept = (rej[5].sum().item() == 0 and torch.equal(rej[0], x)
            and torch.equal(rej[1], U_low) and torch.equal(rej[2], g)
            and torch.equal(rej[3], ud) and torch.equal(rej[4], um))
    # Philox draws inside the kernels vs the plain Philox: same decisions
    ph_k = op(x, U, g, ud, um, seed, L, 0.01, 1.0)
    ph_p = op(x, U, g, ud, um, seed, L, 0.01, 1.0, plain=True)
    same_philox = torch.equal(ph_k[5], ph_p[5])
    line("iter", C=C, L=L, accept=out_k[5].mean().item(), rel_err=errs,
         rejection_keeps_state=kept, philox_same_accepts=same_philox)
    if bad or not kept or not same_philox:
        fail(f"iter: errors {bad}, kept={kept}, philox={same_philox}")


class PlainPhilox:
    """Counts the calls of the plain Philox draws
    (``ops.philox.momentum_normals`` and ``accept_uniforms``) made while
    it is entered: on the card's main paths the kernels draw."""
    NAMES = ("momentum_normals", "accept_uniforms")

    def __init__(self, philox):
        self.philox = philox
        self.calls = 0

    def __enter__(self):
        self.saved = {n: getattr(self.philox, n) for n in self.NAMES}

        def counted(fn):
            def wrapper(*args, **kwargs):
                self.calls += 1
                return fn(*args, **kwargs)
            return wrapper

        for n, fn in self.saved.items():
            setattr(self.philox, n, counted(fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.philox, n, fn)


def phase_slice(torch, tlf, module, dobs, dev, smi, matvec=None):
    """The uniformgrid slice with a ``matvec`` (bf16 when None) matrix;
    returns the launch counts of its run, set to 0 just before it."""
    from gravinv3dhmc_tpu_torch.uniformgrid import SLICE as cfg
    from gravinv3dhmc_tpu_torch.uniformgrid import slice_sampler

    matvec = matvec or torch.bfloat16
    path = tlf.path_kernels(tlf.ITERATION_KERNELS, matvec)
    chain = slice_sampler(module, dobs, dev, matvec=matvec)
    sync(torch)
    tlf.reset_launch_counts()
    res = chain.sample(cfg["nsamples"], cfg["ndraws"])
    sync(torch)
    counts = tlf.launch_counts()
    samples = res["samples"]
    finite = bool(torch.isfinite(samples).all())
    line("slice" if matvec == torch.bfloat16 else "slice_f32",
         problem=[int(dobs.size), module.n_active],
         nchains=cfg["nchains"], chunk=cfg["chunk"],
         iterations=res["attempted"] // cfg["nchains"],
         fused_mode=res["fused_mode"],
         grad_evals_per_s=res["grad_evals_per_s"],
         elapsed_s=res["elapsed_s"], accept_ratio=res["accept_ratio"],
         ess_median=res["ess_median"],
         launches={n: counts[n] for n in path},
         samples_shape=list(samples.shape), finite=finite, card=smi)
    if not finite or not 0 < res["accept_ratio"] <= 1:
        fail("slice: non-finite samples or accept ratio out of (0, 1]")
    if tuple(samples.shape) != (cfg["nchains"], cfg["nsamples"],
                                module.n_active):
        fail(f"slice: samples shape {tuple(samples.shape)}")
    missing = [n for n in path if counts[n] <= 0]
    if missing:
        fail(f"slice: kernels never launched: {missing}")
    return counts


def f32_gemm_ops(torch, tlf, module, dobs, dev):
    """The f32 ops whose padded matrices the f32 GEMMs are checked on:
    (label -> (op, chains)) at realdata's width (a synthetic 625 x 10,427
    matrix, ``f32_gemm_check.synthetic_problem``), at a ragged 200 chains
    there, at uniformgrid's (its own 600 x 6000 matrix) and at the
    realdata-fused cell's (1024 chains, a synthetic 576 x 10,676)."""
    from gravinv3dhmc_tpu_torch import f32_gemm_check as ft

    C, D, M = ft.SHAPES["realdata"]
    kw = dict(regularization="MS", beta=0.001, matvec_dtype=torch.float32,
              device=dev)
    rd = tlf.make_fused_trajectory(*ft.synthetic_problem(D, M), **kw)
    ug = tlf.make_fused_trajectory(*fused_args(module, dobs), **kw)
    Cf, Df, Mf = ft.SHAPES["realdata-fused"]
    rdf = tlf.make_fused_trajectory(*ft.synthetic_problem(Df, Mf), **kw)
    return {"realdata": (rd, C), "realdata, ragged": (rd, RAGGED_CHAINS),
            "uniformgrid": (ug, ft.SHAPES["uniformgrid"][0]),
            "realdata-fused": (rdf, Cf)}


def phase_f32_gemms(torch, tlf, ops, smi):
    """The f32-matrix GEMMs at each (op, chains) of ``ops``, on the bare
    products of ``f32_gemm_check.gemm_operands``: two launches bit for bit
    equal; the kernel within ``KERNEL_RTOL`` of the plain version and its
    error against the float64 product of the same f32 operands, over
    max|product|, at most ``F32_ERR_RATIO`` times the plain version's
    (one IEEE-f32 matmul, TF32 off); no store past the last chain (a NaN
    guard slice after the residual's partials, NaN guard rows of the
    kick's p); its time beside the plain version's, one matmul's and
    both bounds. Returns name -> the kernels line's numbers at the first
    op of ``ops``."""
    from gravinv3dhmc_tpu_torch import f32_gemm_check as ft

    results = {}
    for label, (op, C) in ops.items():
        cases = ft.gemm_operands(op, C)
        for name in ft.GEMMS:
            kern, make = tlf.KERNELS[name], cases[name]
            a1, a2, ap = make(), make(), make()
            ref = ft.f64_reference(name, make())
            kern(*a1)
            kern(*a2)
            kern.plain(*ap)
            sync(torch)
            o1, o2, o_p = (ft.product_out(name, a) for a in (a1, a2, ap))
            bit_equal = torch.equal(o1, o2)
            abs_err, vs_plain = rel_err(o1, o_p)
            err_k, err_p = (ft.rel_to_f64(name, a1, ref),
                            ft.rel_to_f64(name, ap, ref))
            if name == "kick_f32":
                plan = tlf.kick_plan(C, op.Dp, op.Mp, tlf.A_F32_SPLIT)
                guarded, rows = kick_guarded(torch, tlf, make(),
                                             plan["tile"][0])
                guarded &= torch.equal(rows, o1)
            else:
                plan = tlf.residual_plan(C, op.Dp, op.Mp, tlf.A_F32_SPLIT)
                guarded = partials_guarded(torch, tlf, a1[0], a1[1], a1[-1])
            bench, bench_p = make(), make()
            res = {"max_abs_err": abs_err,
                   "ms": time_ms(torch, lambda: kern(*bench)),
                   "plain_ms": time_ms(torch, lambda: kern.plain(*bench_p)),
                   "library_ms": time_ms(torch, ft.library_fn(name, bench))}
            res["bound_ms"], res["bound_by"] = bound(name, bench)
            simt_ms, simt_by = bound(name, bench, simt=True)
            line("f32_gemm", gemm=name, problem=label,
                 shape=[C, op.Dp, op.Mp], tile=plan["tile"],
                 splits=plan["splits"], blocks=plan["blocks"],
                 waves=plan["waves"], bit_equal=bit_equal,
                 guard_intact=guarded, kernel_vs_plain=vs_plain,
                 kernel_vs_f64=err_k, plain_vs_f64=err_p,
                 f64_err_ratio=err_k / max(err_p, 1e-30), **res,
                 share_of_bound=res["bound_ms"] / res["ms"],
                 bound_simt_ms=simt_ms, bound_simt_by=simt_by, card=smi)
            results.setdefault(name, res)
            if (not bit_equal or not guarded or vs_plain > KERNEL_RTOL
                    or err_k > F32_ERR_RATIO * err_p):
                fail(f"f32 gemm {name} ({label}, {C} chains): bit_equal="
                     f"{bit_equal}, guard={guarded}, vs plain {vs_plain}, "
                     f"vs f64 {err_k} against the plain version's {err_p}")
    return results


def phase_traj_realdata(torch, tlf, op, dev, smi, w=None, inv_mass=None):
    """The f32 trajectory op at realdata's width (``op``: the synthetic
    625 x 10,427 matrix, or the stage's own tesseroid matrix with its
    weights ``w``): 256 chains, L = 22, through the kernels and through
    the plain versions, every output within ``TRAJ_RTOL["float32"]``, with
    the identity metric or a diagonal ``inv_mass`` (momenta scaled by
    1/sqrt(im), as the sampler draws them). x is ``w`` (1 when None) times
    0.25 +- 0.05; the op's bounds are moved out to +-10 times max ``w`` so
    that no cell clips (a one-ulp difference would flip a clip and its
    momentum's sign). Returns the launch counts of the kernel run, set to
    0 just before it."""
    from gravinv3dhmc_tpu_torch import f32_gemm_check as ft

    C, L, eps = ft.SHAPES["realdata"][0], 22, 0.005
    M = op.M
    w = (torch.ones(M, device=dev) if w is None
         else torch.as_tensor(w, dtype=torch.float32, device=dev))
    edge = 10.0 * w.max().item()
    wide = dict(op.params, low=torch.full((M,), -edge, device=dev),
                high=torch.full((M,), edge, device=dev))
    gen = torch.Generator(device=dev).manual_seed(7)
    x = (0.25 + 0.05 * torch.randn(C, M, generator=gen, device=dev)) * w
    p = 1e-3 * torch.randn(C, M, generator=gen, device=dev)
    if inv_mass is not None:
        p = p / torch.sqrt(inv_mass)
    sync(torch)
    tlf.reset_launch_counts()
    out_k = op(x, p, L, eps, 1.0, params=wide, inv_mass=inv_mass)
    sync(torch)
    counts = tlf.launch_counts()
    out_p = op(x, p, L, eps, 1.0, params=wide, inv_mass=inv_mass, plain=True)
    errs = {}
    for nm, a, b in zip(("x", "p", "g", "U", "ud", "um"), out_k, out_p):
        if not torch.isfinite(a).all():
            fail(f"traj_realdata: non-finite {nm}")
        errs[nm] = rel_err(a, b)[1]
    lim = TRAJ_RTOL["float32"]
    bad = [nm for nm in errs if errs[nm] > lim.get(nm, lim["U"])]
    want = {"drift": L, "residual_f32": L, "kick_f32": L, "traj_finish": 1}
    line("traj_realdata", C=C, shape=[C, op.Dp, op.Mp], L=L, eps=eps,
         reg=op.regularization, inv_mass=inv_mass is not None,
         rel_err=errs, launches={n: counts[n] for n in want},
         x_shape=list(out_k[0].shape), card=smi)
    if bad or any(counts[n] != k for n, k in want.items()):
        fail(f"traj_realdata: {bad} beyond {lim}, launches "
             f"{ {n: counts[n] for n in want} } (want {want})")
    return counts


def phase_realdata_kernels(torch, tlf, module, dobs, dev, smi):
    """The realdata stage's kernels on its own tesseroid matrix at its 256
    chains (640 x 10,752 padded, Damping): ``refresh``, ``drift``,
    ``traj_finish`` and ``accept`` (98 % accepted, the stage's rate)
    against their plain versions; the f32 trajectory op without and with
    a diagonal metric (``phase_traj_realdata``); then the f32 GEMMs
    (``phase_f32_gemms``, and at a ragged 200 chains). Returns the GEMMs'
    numbers for the kernels line and the trajectory runs' launch counts."""
    from gravinv3dhmc_tpu_torch import realdata

    op = realdata.trajectory_op(module, dobs, dev)
    C = realdata.SLICE["nchains"]
    cases = kernel_cases(torch, op, C, dev, share=0.98)
    run_kernel_cases(torch, tlf, {
        n: cases[n] for n in ("refresh", "drift", "traj_finish", "accept")},
        [C, op.Dp, op.Mp], "realdata_kernel")
    gen = torch.Generator(device=dev).manual_seed(8)
    inv_mass = 10.0 ** (-2 * torch.rand(op.M, generator=gen, device=dev))
    counts = [phase_traj_realdata(torch, tlf, op, dev, smi, w=module.wdiag,
                                  inv_mass=im) for im in (None, inv_mass)]
    gemms = phase_f32_gemms(torch, tlf, {
        "realdata tesseroids": (op, C),
        "realdata tesseroids, ragged": (op, RAGGED_CHAINS)}, smi)
    return gemms, counts


def rel_fro(out, ref):
    """max |out - ref| / max |ref| and ||out - ref||_F / ||ref||_F."""
    d = out.double() - ref.double()
    r = ref.double()
    return ((d.abs().max() / r.abs().max()).item(),
            (d.norm() / r.norm()).item())


#: an f32 gz matrix against f64 (and the kernel against its plain
#: version): f32 cancels in the corner differences of distant cells
GZ_MAX, GZ_FRO = 1e-3, 5e-3


def jittered(cells, seed=0):
    """``cells`` with every bound moved down by a seeded 0-0.5 m: no two
    cells share a face value any more (an unstructured set, sent to the
    corner kernel), and none reaches above the observations at z = 0."""
    return cells + np.random.RandomState(seed).uniform(0.0, 0.5, cells.shape)


def phase_gz(torch, tlf, dev, smi):
    """The ratiogrid matrix (900 obs x 17,100 ratio prisms) through both gz
    kernels: the dispatcher picks ``gz_nodes`` for the mesh's cells; its
    matrix equals the corner ``gz`` kernel's bit for bit; each kernel
    against its plain version and all four against the f64 host builder
    within ``GZ_MAX`` of max|A| and ``GZ_FRO`` Frobenius; both timed in
    turns (gz, gz_nodes, gz_nodes, gz) beside the one bound they share.
    Then the same cells jittered (no shared faces) through
    ``prism_kernel_matrix(backend="pallas")``: the corner kernel is
    dispatched and launched once, checked against its plain version and
    against f64 on every tenth observation. Returns the kernels line's
    numbers of both kernels and the launch counts of the jittered build,
    set to 0 just before it."""
    from gravinv3dhmc_tpu_torch import constants, ratiogrid
    from gravinv3dhmc_tpu_torch.ops import prism, prism_gz

    mesh, (xo, yo, zo) = ratiogrid.mesh_and_obs()
    cells = mesh.cell_bounds(only_active=True)
    t0 = time.perf_counter()
    A64 = prism.prism_kernel_matrix("gz", xo, yo, zo, mesh)
    host_s = time.perf_counter() - t0
    A64 = torch.as_tensor(A64, device=dev)
    obs = torch.as_tensor(np.stack([xo, yo, zo], 1), dtype=torch.float32,
                          device=dev)
    scale = float(np.float32(constants.G * constants.SI2MGAL))
    cells32 = cells.astype(np.float32)
    plan, tables = prism_gz.gz_plan(cells32)
    args = {"gz": (obs, torch.as_tensor(cells32, device=dev), scale),
            "gz_nodes": (obs, *prism_gz.node_args(tables, dev), scale)}
    outs = {n: tlf.KERNELS[n](*a) for n, a in args.items()}
    plains = {n: tlf.KERNELS[n].plain(*a) for n, a in args.items()}
    sync(torch)
    bit_equal = torch.equal(outs["gz_nodes"], outs["gz"])
    errs = {}
    for n in args:
        errs[f"{n}_vs_plain"] = rel_fro(outs[n], plains[n])
        errs[f"{n}_vs_f64"] = rel_fro(outs[n], A64)
        errs[f"{n}_plain_vs_f64"] = rel_fro(plains[n], A64)
    times = {n: [] for n in args}
    for n in ("gz", "gz_nodes", "gz_nodes", "gz"):
        times[n].append(time_ms(torch, lambda: tlf.KERNELS[n](*args[n]),
                                reps=10, rounds=3))
    result = {}
    for n, a in args.items():
        bound_ms, bound_by = bound(n, a)
        ms = float(np.median(times[n]))
        result[n] = {
            "max_abs_err": (outs[n].double() - plains[n].double()).abs()
            .max().item(), "ms": ms,
            "plain_ms": time_ms(torch, lambda: tlf.KERNELS[n].plain(*a),
                                reps=3, warmup=1, rounds=1),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    finite = all(bool(torch.isfinite(o).all()) for o in outs.values())
    line("gz", shape=list(outs["gz"].shape), plan=plan,
         nodes=[len(tables.ux), len(tables.uy), len(tables.uz)],
         n_nodes=tables.n_nodes, span=tables.span,
         smem_bytes=prism_gz.node_smem_bytes(tables),
         nodes_bit_equal_corner=bit_equal, errors=errs, host_f64_s=host_s,
         finite=finite, turns_ms=times, card=smi,
         **{n: {**r, "share_of_bound": r["bound_ms"] / r["ms"]}
            for n, r in result.items()})
    bad = [k for k, (e_max, e_fro) in errs.items()
           if e_max > GZ_MAX or e_fro > GZ_FRO]
    if (bad or not finite or plan != "gz_nodes" or not bit_equal
            or tuple(outs["gz"].shape) != (900, 17100)):
        fail(f"gz: plan {plan}, bit_equal={bit_equal}, {bad} beyond "
             f"({GZ_MAX}, {GZ_FRO}) or non-finite")

    # an unstructured cell set: the dispatcher's other side
    jit = jittered(cells)
    jplan = prism_gz.gz_plan(jit)[0]
    sync(torch)
    tlf.reset_launch_counts()
    Aj = prism.prism_kernel_matrix("gz", xo, yo, zo, jit, backend="pallas",
                                   device=dev)
    sync(torch)
    counts = tlf.launch_counts()
    Aj = torch.as_tensor(Aj, device=dev)
    Aj_plain = tlf.KERNELS["gz"].plain(
        obs, torch.as_tensor(jit, dtype=torch.float32, device=dev), scale)
    rows = slice(None, None, 10)
    Aj64 = torch.as_tensor(prism.prism_kernel_matrix(
        "gz", xo[rows], yo[rows], zo[rows], jit), device=dev)
    errs_j = {"kernel_vs_plain": rel_fro(Aj, Aj_plain),
              "kernel_vs_f64": rel_fro(Aj[rows], Aj64),
              "plain_vs_f64": rel_fro(Aj_plain[rows], Aj64)}
    launches = {n: counts[n] for n in args}
    line("gz_unstructured", shape=list(Aj.shape), plan=jplan,
         n_nodes=prism_gz.node_tables(jit).n_nodes, launches=launches,
         errors=errs_j, f64_rows=int(Aj64.shape[0]),
         finite=bool(torch.isfinite(Aj).all()))
    bad = [k for k, (e_max, e_fro) in errs_j.items()
           if e_max > GZ_MAX or e_fro > GZ_FRO]
    if (bad or jplan != "gz" or launches != {"gz": 1, "gz_nodes": 0}
            or not torch.isfinite(Aj).all()):
        fail(f"gz_unstructured: plan {jplan}, launches {launches}, {bad} "
             f"beyond ({GZ_MAX}, {GZ_FRO})")
    return result, counts


def phase_slice2(torch, tlf, dev, smi, problem=None, matvec=None):
    """The ratiogrid main path: the matrix built on the card (or
    ``problem``, a ``(module, dobs)`` built before), the per-step sampler
    with a ``matvec`` (bf16 when None) matrix, a warm chunk and 4 timed
    ones. Returns the problem and the launch counts of the run, set to 0
    just before it."""
    from gravinv3dhmc_tpu_torch import ratiogrid

    matvec = matvec or torch.bfloat16
    name = "slice2" if matvec == torch.bfloat16 else "slice2_f32"
    cfg = ratiogrid.SLICE
    sync(torch)
    tlf.reset_launch_counts()
    if problem is None:
        module, dobs, seconds = ratiogrid.build_problem(device=dev)
    else:
        (module, dobs), seconds = problem, {}
    run_chunk, carry, _ = ratiogrid.step_sampler(module, dobs, dev,
                                                 matvec=matvec)
    res, carry = ratiogrid.run_chunks(run_chunk, carry, 0, 4, dev)
    sync(torch)
    counts = tlf.launch_counts()
    path = (("gz_nodes",) if problem is None else ()) + tlf.path_kernels(
        tlf.STEP_KERNELS, matvec) + ("refresh", "accept")
    line(name, problem=[int(dobs.size), module.n_active],
         nchains=cfg["nchains"], chunk=cfg["chunk"], **res, **seconds,
         launches={n: counts[n] for n in path}, card=smi)
    if not res["finite"] or not 0 < res["accept_ratio"] <= 1:
        fail(f"{name}: non-finite state or accept ratio out of (0, 1]")
    if res["samples_shape"] != [cfg["nchains"], cfg["nsamples"],
                                module.n_active] or module.n_active != 17100:
        fail(f"{name}: samples shape {res['samples_shape']}")
    missing = [n for n in path if counts[n] <= 0]
    if missing:
        fail(f"{name}: kernels never launched: {missing}")
    if counts["draws"]:
        fail(f"{name}: draws launched {counts['draws']} times; the per-step "
             "path draws inside refresh and accept")
    return module, dobs, counts


def phase_reference2(torch, tlf, dev):
    """A small ratiogrid (10 x 10 obs over 10 x 10 x 8 prisms) built and
    sampled through the kernels on the card and through the plain versions
    on the CPU, same seed, f32 matrix: the same Philox draws give the same
    decisions (at least 95% of chains agree). The card run's launches
    (its f32 GEMMs: ``step_residual_f32`` and ``kick_f32``), counted from
    0 just before it, go on this phase's line alone: no main path runs
    this small problem."""
    from gravinv3dhmc_tpu_torch import ratiogrid

    runs = {}
    for where in (dev, torch.device("cpu")):
        module, dobs, _ = ratiogrid.build_problem(device=where, n=10)
        run_chunk, carry, _ = ratiogrid.step_sampler(
            module, dobs, where, matvec=torch.float32, nchains=64, chunk=16,
            nsamples=16)
        sync(torch)
        tlf.reset_launch_counts()
        runs[where.type], _ = ratiogrid.run_chunks(run_chunk, carry, 3, 2,
                                                   where)
        sync(torch)
        if where.type == "cuda":
            counts = tlf.launch_counts()
        runs[where.type + "_carry"] = _
    a, b = runs["cuda_carry"], runs["cpu_carry"]
    same = (a[5].cpu() == b[5]).numpy()
    close = torch.isclose(a[6].cpu(), b[6], rtol=5e-3,
                          atol=5e-4).flatten(1).all(1).numpy()
    agree = same & close
    path = tlf.path_kernels(tlf.STEP_KERNELS, torch.float32)
    line("reference2", chains=int(same.size), same_accepts=int(same.sum()),
         agree=int(agree.sum()), accept_ratio=runs["cuda"]["accept_ratio"],
         launches={n: counts[n] for n in path})
    if agree.mean() < 0.95 or not 0 < runs["cuda"]["accept_ratio"] <= 1:
        fail("reference2: card and CPU runs disagree")
    if any(counts[n] <= 0 for n in path):
        fail(f"reference2: kernels never launched: {path}")


def step_kernel_cases(torch, op, C, dev):
    """Inputs for the step's kernels at the op's shapes (a non-zero fix
    and alpha 0.5, so dropping either shows) and for the draws its
    sampler makes."""
    from gravinv3dhmc_tpu_torch.ops import philox

    pp = op._padded
    Mp, Dp = op.Mp, op.Dp
    gen = torch.Generator(device=dev).manual_seed(4)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device=dev)

    def f(*shape):
        return torch.empty(*shape, device=dev)

    mask = (pp["high"] > 0).float()
    x = (0.3 + 0.05 * randn(C, Mp)) * pp["high"]
    p = randn(C, Mp, scale=1e-3) * mask
    r = randn(C, Dp, scale=0.1) * pp["dmask"]
    fix = randn(Dp, scale=0.1) * pp["dmask"]
    ud = 50.0 + randn(C).abs()
    g = randn(C, Mp, scale=10.0) * mask
    U = 200.0 + randn(C)
    im = torch.where(mask > 0, 0.1 + 0.9 * torch.rand(
        Mp, generator=gen, device=dev), torch.ones_like(mask))
    salt = philox.salt_from_seed(6)
    e = 0.01
    return {
        # ratiogrid accepts ~99 % of its proposals
        **open_close_cases(torch, g, U, mask, im, e, salt, op.M, 0.99, dev),
        "drift": (lambda: (x.clone(), p.clone(), None, pp["im"], pp["low"],
                           pp["high"], e),
                  lambda a: {"x": a[0], "p": a[1]}),
        "step_residual": (lambda: (x.clone(), pp["A"], fix,
                                   pp["dobs"], pp["dmask"], op.inv_nobs,
                                   f(C, Dp), f(C)),
                          lambda a: {"r": a[6], "ud": a[7]}),
        "kick": (lambda: (r.clone(), pp["A"], x.clone(), p.clone(),
                          pp["aprior"], pp["gm_scale"], 2 * e, e, op.beta,
                          True), lambda a: {"p": a[3]}),
        "step_misfit": (lambda: (x.clone(), pp["aprior"], pp["wmsq"], ud,
                                 f(C), f(C), 0.5, op.beta, True),
                        lambda a: {"U": a[4], "um": a[5]}),
        "draws": (lambda: (f(C, Mp), f(C), salt, 7),
                  lambda a: {"n01": a[0], "u": a[1]}),
    }


def phase_step_kernels(torch, tlf, module, dobs, dev):
    """The step's kernels against their plain versions at the slice's
    shapes (the reused drift and kick at this shape too)."""
    from gravinv3dhmc_tpu_torch.ratiogrid import SLICE

    C = SLICE["nchains"]
    op = tlf.make_fused_step(*fused_args(module, dobs, high=0.4),
                             regularization="MS", beta=0.001,
                             matvec_dtype=torch.bfloat16, device=dev)
    plan = tlf.residual_plan(C, op.Dp, op.Mp, 1)
    line("residual_plan", shape=[C, op.Dp, op.Mp], **plan)
    res = run_kernel_cases(torch, tlf, step_kernel_cases(torch, op, C, dev),
                           [C, op.Dp, op.Mp], "step_kernel")
    check_gemm(torch, tlf, "step_residual", {
        n: step_kernel_cases(torch, op, n, dev)["step_residual"]
        for n in (C, RAGGED_CHAINS)}, "step_kernel")
    check_kick(torch, tlf, {
        n: step_kernel_cases(torch, op, n, dev)["kick"][0]
        for n in (C, RAGGED_CHAINS)}, "step_kernel")
    return res


def phase_step(torch, tlf, module, dobs, dev):
    """The step op through the kernels against its plain version at 256
    chains. One step from momenta that clip ~15 % of the cells: x' equals
    the clip of the replayed drift x + dt (im p), the sampler's boundary
    replay, bit for bit. Then L = 7 steps along the kernels' own
    trajectory from the trajectory check's start (x inside the box,
    momenta of 1e-3; cells start to clip by the fifth step), each step's
    kernels against the plain version on the same input. Two free-running
    trajectories are no test here: once cells clip, a one-ulp difference
    flips a later clip (in a small CPU run the plain op against itself,
    x moved by one ulp, parts by 0.38 of max|p| at the seventh step)."""
    C, L, dt = STEP_CHAINS, 7, 0.01
    M = module.n_active
    fa = fused_args(module, dobs, high=0.4)
    low = torch.as_tensor(fa[5], dtype=torch.float32, device=dev)
    high = torch.as_tensor(fa[6], dtype=torch.float32, device=dev)
    w = torch.as_tensor(module.wdiag, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    x = (0.2 + 0.1 * torch.randn(C, M, generator=gen, device=dev)) * w
    p0 = 10.0 * torch.randn(C, M, generator=gen, device=dev) * w
    x_mild = (0.2 + 0.02 * torch.randn(C, M, generator=gen, device=dev)) * w
    p_mild = 1e-3 * torch.randn(C, M, generator=gen, device=dev)
    inv_mass = 10.0 ** (-torch.rand(M, generator=gen, device=dev))
    names = ("x", "p", "U", "ud", "um")
    for dtype in ("float32", "bfloat16"):
        for reg in ("MS", "Damping"):
            op = tlf.make_fused_step(
                *fa, regularization=reg, beta=0.001,
                matvec_dtype=getattr(torch, dtype), device=dev)

            def compare(xs, ps, im):
                out_k = op(xs, ps, dt, 1.0, inv_mass=im)
                out_p = op(xs, ps, dt, 1.0, inv_mass=im, plain=True)
                if not all(torch.isfinite(a).all() for a in out_k):
                    fail(f"step {dtype} {reg}: non-finite output")
                return out_k, {nm: rel_err(a, b)[1]
                               for nm, a, b in zip(names, out_k, out_p)}

            for im in (None, inv_mass):
                scale = 1.0 if im is None else 1.0 / torch.sqrt(im)
                p = p0 * scale
                out_k, errs1 = compare(x, p, im)
                x_pre = x + dt * (p if im is None else im * p)
                hits = ((x_pre > high) | (x_pre < low)).float().mean().item()
                replay = torch.equal(
                    out_k[0], torch.minimum(torch.maximum(x_pre, low), high))
                errs7 = dict.fromkeys(names, 0.0)
                xs, ps = x_mild, p_mild * scale
                for _ in range(L):
                    (xs, ps, *_), errs = compare(xs, ps, im)
                    errs7 = {nm: max(errs7[nm], errs[nm]) for nm in names}
                outs = {1: errs1, L: errs7}
                lim = TRAJ_RTOL[dtype]
                bad = [(n, nm) for n, errs in outs.items() for nm in errs
                       if errs[nm] > lim.get(nm, lim["U"])]
                line("step", dtype=dtype, reg=reg, inv_mass=im is not None,
                     C=C, L=L, clipped=hits, replay_exact=replay,
                     rel_err=outs)
                if bad or not replay or not hits > 0:
                    fail(f"step {dtype} {reg}: {bad} beyond {lim}, "
                         f"replay={replay}, clipped={hits}")


def phase_reference(torch, tlf, dev):
    """A small problem sampled through the kernels on the card and through
    the plain versions on the CPU, same seed: the Philox draws are the
    same bits, so the chains take the same decisions (a chain whose
    decision flips on a rounding tie diverges; at least 95% must agree).
    Then the same problem on the card through the eager shared-L path
    (``use_fused=False``), the path that draws with the ``draws`` kernel:
    it must agree with the CPU run as well, and launch ``draws``. Returns
    the launch counts of that run, set to 0 just before it."""
    from gravinv3dhmc_tpu_torch.uniformgrid import build_problem, sampler

    runs = {}
    for where, fused in ((dev, True), (torch.device("cpu"), True),
                         (dev, False)):
        module, dobs = build_problem(8, 12, 4, device=where)
        chain = sampler(module, dobs, where, 64, 16, 0.05, (3, 8), 0.001,
                        0.001, torch.float32, seed=3, initial=0.3)
        chain.use_fused = fused
        sync(torch)
        tlf.reset_launch_counts()
        runs[where.type, fused] = chain.sample(16, 16)
        sync(torch)
        counts = tlf.launch_counts()
    b = runs["cpu", True]
    agree = {}
    for key in (("cuda", True), ("cuda", False)):
        a = runs[key]
        same = np.asarray(a["accepted"]) == np.asarray(b["accepted"])
        close = torch.isclose(a["samples"].cpu(), b["samples"], rtol=5e-3,
                              atol=5e-4).flatten(1).all(1)
        agree[key] = same & close.numpy()
    a = runs["cuda", True]
    line("reference", chains=int(agree["cuda", True].size),
         agree=int(agree["cuda", True].sum()),
         shared_L_agree=int(agree["cuda", False].sum()),
         accept_ratio=a["accept_ratio"],
         shared_L_accept_ratio=runs["cuda", False]["accept_ratio"],
         shared_L_launches={n: c for n, c in counts.items() if c})
    if (min(v.mean() for v in agree.values()) < 0.95
            or not 0 < a["accept_ratio"] < 1):
        fail("reference: card and CPU runs disagree")
    if counts["draws"] <= 0:
        fail("reference: the shared-L card run never launched draws")
    return counts


#: the state phase's runs on the uniformgrid problem at full width (1024
#: chains, shared L, chain-mode storage): 64 iterations before storage
#: and every 8th after for 16 samples, in chunks of 32 (a 1024 x 16 x
#: 6000 f32 sample buffer, 393 MB: the slice's 64 samples would make a
#: 1.57 GB snapshot, and the kernels' work does not depend on it); the
#: fixed-dt run is cut after ``stop`` chunks, the adaptive one (dt and a
#: diagonal metric, its kernel frozen after ``adapt_chunks``) 2 chunks
#: after its freeze; the sample files come from ``files_chains`` chains
#: storing ``files_nsamples`` iterations
STATE = dict(chunk=32, nsamples=16, ndraws=64, store_thin=8, stop=3,
             adapt_chunks=8, files_chains=8, files_nsamples=64)
#: a ``%.8f`` file against the f32 samples cast to f64: half a unit of
#: the eighth decimal, plus f64's spacing at the samples' size
FILE_ROUNDING = (5e-9, 1e-15)


def file_gap(back, samples):
    """How far the rows read back from sample files are from the
    returned samples, and the rounding bound it must stay within."""
    ref = samples.detach().cpu().double().numpy()
    gap = float(np.abs(np.asarray(back) - ref).max()) if ref.size else 0.0
    return gap, FILE_ROUNDING[0] + FILE_ROUNDING[1] * float(np.abs(ref).max())


def phase_state(torch, tlf, module, dobs, dev, smi):
    """Files and state at the uniformgrid slice's width: a fixed-dt run
    (the bf16 iteration op) and an adaptive one (the bf16 trajectory op)
    each run uninterrupted, cut with a snapshot every chunk, and resumed
    from the snapshot: the resumed run must equal the uninterrupted one
    bit for bit (samples, misfits, x, accept counts; the adaptive one's
    frozen step size and metric too) and stop without the ``max_chunks``
    warning; the snapshot's size and its save and load seconds. Then
    ``HMCSample`` with ``write_files`` (``STATE["files_chains"]`` chains):
    ``load_chains`` gives back its samples to the file's rounding, and the
    native sink's write seconds beside ``PySampleSink``'s for the same
    rows, whose bytes must be the same. Returns the launch counts of
    these runs, each set to 0 just before it."""
    import contextlib
    import io
    import os
    import tempfile

    from gravinv3dhmc_tpu_torch import diagnostics
    from gravinv3dhmc_tpu_torch.inversion import hmc
    from gravinv3dhmc_tpu_torch.runtime import sink, sink_py
    from gravinv3dhmc_tpu_torch.uniformgrid import SLICE, slice_sampler

    t_phase = time.perf_counter()
    total = {n: 0 for n in tlf.KERNELS}
    io_s = {"save": [], "load": []}
    saved = hmc.save_state, hmc.load_state

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            io_s[key].append(time.perf_counter() - t0)
            return out
        return wrapper

    def counted(fn):
        sync(torch)
        tlf.reset_launch_counts()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = fn()
        sync(torch)
        for k, v in tlf.launch_counts().items():
            total[k] += v
        return res, out.getvalue()

    def run(path=None, stop=None, every=1, **kw):
        chain = slice_sampler(module, dobs, dev, chunk=STATE["chunk"])
        chain.store_thin = STATE["store_thin"]
        for k, v in kw.items():
            setattr(chain, k, v)
        return counted(lambda: chain.sample(
            STATE["nsamples"], STATE["ndraws"], max_chunks=stop,
            checkpoint_path=path, checkpoint_every=every))

    hmc.save_state = timed(saved[0], "save")
    hmc.load_state = timed(saved[1], "load")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for label, kw, stop in (
                    ("fixed", {}, STATE["stop"]),
                    ("adaptive", dict(adapt_step_size=True, adapt_mass=True,
                                      adapt_chunks=STATE["adapt_chunks"],
                                      prefer_iteration_kernel=False),
                     STATE["adapt_chunks"] + 2)):
                path = os.path.join(tmp, f"{label}.npz")
                t0 = time.perf_counter()
                full, out_full = run(**kw)
                for v in io_s.values():
                    v.clear()
                run(path, stop, **kw)
                with np.load(path) as z:
                    n_chunks = int(z["n_chunks"])
                nbytes = os.path.getsize(path)
                # the resumed run snapshots at its end only
                resumed, out = run(path, every=10 ** 6, **kw)
                checks = {k: bool(torch.equal(resumed[k], full[k]))
                          for k in ("samples", "misfits", "x")}
                checks["accepted"] = resumed["accepted"] == full["accepted"]
                checks["step_size"] = resumed["step_size"] == \
                    full["step_size"]
                checks["cut"] = n_chunks == stop
                checks["no max_chunks warning"] = (
                    "WARNING" not in out + out_full)
                checks["finite"] = bool(torch.isfinite(full["samples"]).all())
                want_mode = ("trajectory(bfloat16)" if kw
                             else "iteration(bfloat16)")
                checks["path"] = full["fused_mode"] == want_mode
                if kw:
                    checks["frozen dt moved"] = (full["step_size"]
                                                 != SLICE["dt"])
                    checks["inv_mass"] = bool(
                        full["inv_mass"] is not None
                        and torch.equal(resumed["inv_mass"],
                                        full["inv_mass"]))
                line("state", run=label, problem=[int(dobs.size),
                                                  module.n_active],
                     nchains=SLICE["nchains"], fused_mode=full["fused_mode"],
                     chunks_cut=n_chunks,
                     samples_shape=list(full["samples"].shape),
                     step_size=full["step_size"],
                     accept_ratio=full["accept_ratio"], npz_bytes=nbytes,
                     save_s=io_s["save"], load_s=io_s["load"],
                     seconds=time.perf_counter() - t0, checks=checks,
                     card=smi)
                bad = [k for k, ok in checks.items() if not ok]
                if bad:
                    fail(f"state {label}: {bad}")
                del full, resumed

            M = module.n_active
            C, N = STATE["files_chains"], STATE["files_nsamples"]
            base = os.path.join(tmp, "chain")
            t0 = time.perf_counter()
            res, _ = counted(lambda: hmc.HMCSample(
                module, N, 0, SLICE["dt"], SLICE["Lrange"],
                np.full(M, 0.001), np.full(M, 0.001),
                np.column_stack([np.zeros(M), np.ones(M)]), "mandatory",
                1000.0, dobs, regularization="MS", beta=SLICE["beta"],
                seed=0, Sigma=SLICE["Sigma"], save_folder=base, nchains=C,
                chunk_size=STATE["chunk"], verbose=False, shared_L=True,
                use_fused=True, store_mode="chain", device=dev))
            sample_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = diagnostics.load_chains(base, C)
            read_s = time.perf_counter() - t0
            gap, bound_gap = file_gap(back, res["samples"])
            rows = res["samples"].cpu().numpy().astype(np.float64)
            ks = res["misfits"].cpu().numpy().astype(np.float64)
            t0 = time.perf_counter()
            native = sink.write_chains(os.path.join(tmp, "native"), 0,
                                       rows, ks)
            native_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            for c in range(C):
                w = sink_py.PySampleSink(os.path.join(tmp, f"py{c}"))
                for i in range(N):
                    w.append(rows[c, i], ks[c, i])
                w.close()
            py_s = time.perf_counter() - t0
            same_bytes = all(
                open(os.path.join(native[c], f), "rb").read()
                == open(os.path.join(tmp, f"py{c}", f), "rb").read()
                for c in range(C) for f in ("model.dat", "misfit.dat"))
            checks = {
                "folders": res["folders"] == [f"{base}{c}" for c in range(C)],
                "shape": back.shape == (C, N, M),
                "rounding": gap <= bound_gap,
                "sinks' bytes equal": same_bytes,
            }
            line("state", run="files", nchains=C, nsamples=N,
                 fused_mode=res["fused_mode"], model_dat_bytes=sum(
                     os.path.getsize(os.path.join(f, "model.dat"))
                     for f in res["folders"]),
                 sample_and_write_s=sample_s, load_chains_s=read_s,
                 max_file_gap=gap, bound=bound_gap,
                 native_sink_s=native_s, py_sink_s=py_s, checks=checks,
                 card=smi)
            bad = [k for k, ok in checks.items() if not ok]
            if bad:
                fail(f"state files: {bad}")
    finally:
        hmc.save_state, hmc.load_state = saved
    line("state", seconds=time.perf_counter() - t_phase,
         launches={k: v for k, v in total.items() if v})
    return total


def phase_kernel_cache(torch, dev, smi):
    """The realdata problem built once with a kernel cache path (the
    native tesseroid build, the matrix saved) and once more from it (an
    ``np.load``): ``A``, ``Aw`` and the weights bit equal, both seconds.
    Returns the built problem."""
    import os
    import tempfile

    from gravinv3dhmc_tpu_torch import realdata

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "realdata_kernel.npy")
        t0 = time.perf_counter()
        built = realdata.build_problem(device=dev, kernel_cache=path)
        build_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        t0 = time.perf_counter()
        loaded = realdata.build_problem(device=dev, kernel_cache=path)
        load_s = time.perf_counter() - t0
    a, b = built[0], loaded[0]
    checks = {k: (getattr(a, k).dtype == getattr(b, k).dtype
                  and getattr(a, k).tobytes() == getattr(b, k).tobytes())
              for k in ("A", "Aw", "wdiag")}
    checks["native build"] = a.tess_backend == "native"
    checks["loaded, not built"] = b.tess_backend is None
    line("state", run="kernel_cache", shape=list(a.A.shape),
         dtype=str(a.A.dtype), npy_bytes=nbytes, build_s=build_s,
         load_s=load_s, kernel_build_s=a.kernel_build_s,
         kernel_load_s=b.kernel_build_s, checks=checks, card=smi)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"state kernel_cache: {bad}")
    return built


#: the realdata stage's post-freeze accept ratio must be at least 0.3
#: (near 0, the dt re-seed at the metric switch or the brake failed) and
#: below 1. It may exceed 0.95: on this synthetic problem the JAX
#: sampler's own warmup freezes at a dt that accepts 0.987 at the stage's
#: 256 chains (``tests/realdata_warmup_parity.py``, on the CPU); the 0.52
#: of the JAX bench's record came from the published data, which the
#: repository lacks
REALDATA_ACCEPT = (0.3, 1.0)
#: dual averaging must have moved dt by more than this factor either way
#: from the stage's start (0.005)
REALDATA_DT_MOVED = 2.0
#: the kernels the realdata stage must launch (the f32 trajectory op)
REALDATA_KERNELS = ("refresh", "drift", "residual_f32", "kick_f32",
                    "traj_finish", "accept")


#: the live f64 reference run's least accept ratio: the reference logs
#: 100 % (example/realdata/logout_T1.txt), the JAX package's recorded f64
#: run 1.0000 (``tools/refkernel_f64.json``)
REFKERNEL_ACCEPT = 0.99


def phase_bench(torch, tlf, dev, smi):
    """The port's bench at its defaults (both stages) with the live f64
    reference kernel (``BENCH_REALDATA_REFKERNEL=1``), the dict on one
    line and the reference run's on a ``refkernel`` line; returns the dict
    and the launch counts of the run, set to 0 just before it."""
    from gravinv3dhmc_tpu_torch import bench, realdata

    sync(torch)
    tlf.reset_launch_counts()
    t0 = time.perf_counter()
    saved = os.environ.get("BENCH_REALDATA_REFKERNEL")
    os.environ["BENCH_REALDATA_REFKERNEL"] = "1"
    try:
        res = bench.run(dev)
    finally:
        if saved is None:
            del os.environ["BENCH_REALDATA_REFKERNEL"]
        else:
            os.environ["BENCH_REALDATA_REFKERNEL"] = saved
    sync(torch)
    counts = tlf.launch_counts()
    print(json.dumps({"phase": "bench", "seconds": time.perf_counter() - t0,
                      "card": smi, **res}), flush=True)
    d = res["detail"]
    r = d["realdata"]
    ref = r["reference_kernel"]
    line("refkernel", card=smi, seconds=ref["elapsed_s"], **ref,
         draws_launches=counts["draws"])
    ug_path = tlf.path_kernels(tlf.ITERATION_KERNELS, torch.bfloat16)
    problems = {"detail": d["problem"], "realdata": r["problem"]}
    lo, hi = REALDATA_ACCEPT
    checks = {
        "value": res["value"] > 0,
        "uniformgrid path": d["fused_pallas_step"] == "iteration(bfloat16)",
        "uniformgrid accept": 0 < d["accept_ratio"] <= 1,
        "uniformgrid launches": all(d["launches"].get(n, 0) > 0
                                    for n in ug_path),
        "problems": problems == {"detail": [600, 6000],
                                 "realdata": [576, 10676]},
        "realdata path": r["fused_pallas_step"] == "trajectory(float32)",
        "adapted_mass": r["adapted_mass"] is True,
        "step_size": bool(np.isfinite(r["step_size"])
                          and r["step_size"] > 0),
        "realdata accept": lo <= r["accept_ratio"] < hi,
        "dt adapted": not (1 / REALDATA_DT_MOVED
                           < r["step_size"] / realdata.SLICE["dt"]
                           < REALDATA_DT_MOVED),
        "ess": bool(np.isfinite(r["ess_per_s_median"])
                    and r["ess_per_s_median"] > 0),
        "tess_backend": r["tess_backend"] == "native",
        "realdata launches": all(r["launches"].get(n, 0) > 0
                                 for n in REALDATA_KERNELS),
        # the fused stages draw in refresh and accept; the eager reference
        # run launches draws once an iteration (shared L, no warmup)
        "draws: the reference run's only": (
            counts["draws"] == ref["nsamples"]),
        "refkernel live": ref["source"] == "measured live (f64)",
        "refkernel float64": ref["dtype"] == {"x": "float64",
                                              "U": "float64"},
        "refkernel eager": ref["fused_mode"] == "off",
        f"refkernel accept >= {REFKERNEL_ACCEPT}":
            ref["accept_ratio"] >= REFKERNEL_ACCEPT,
        "refkernel ess": bool(np.isfinite(ref["ess_per_sample"])
                              and ref["ess_per_sample"] > 0),
        "refkernel problem": (ref["problem"] == [576, 10676]
                              and ref["nchains"] == 64
                              and ref["nsamples"] == 128),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"bench: {bad}")
    return res, counts


#: the samplers phase's bounds around the JAX package's statistics on
#: this configuration (``tools/samplers_tpu.json``, TPU: ChEES accept
#: 0.77, step 3.07e-4, R-hat 1.020; NUTS accept 0.84, mean depth 5.0, no
#: divergence, R-hat 1.009). The step and depth bounds are wide: the TPU
#: may have run its f32 products at its reduced default precision, the
#: card runs them in IEEE f32
SAMPLER_BOUNDS = {
    "chees": dict(mean_accept=(0.6, 0.9), step_size=(3.07e-5, 3.07e-3),
                  rhat_max=(0.0, 1.1), max_steps_saturated=(0.0, 1.0)),
    "nuts": dict(mean_accept=(0.7, 0.95), mean_depth=(3.0, 7.0),
                 rhat_max=(0.0, 1.1)),
}
#: NUTS may diverge in at most this share of its draws
NUTS_DIVERGENCE_SHARE = 0.01


def phase_samplers(torch, tlf, dev, smi):
    """``samplers.run()``'s three samplers on the card, each with its
    launches counted from 0 just before it; returns the counts of the
    whole phase and the problem's cell count."""
    import os
    import tempfile

    from gravinv3dhmc_tpu_torch import samplers, uniformgrid
    from gravinv3dhmc_tpu_torch.diagnostics import load_chains

    problem = uniformgrid.build_problem(device=dev)
    total = {name: 0 for name in tlf.KERNELS}
    tmp = tempfile.TemporaryDirectory()
    base = os.path.join(tmp.name, "s_")
    for name in ("chees", "nuts", "hmc"):
        sync(torch)
        tlf.reset_launch_counts()
        t0 = time.perf_counter()
        line, tensors = samplers.run((name,), dev, problem,
                                     save_folder=base)[name]
        sync(torch)
        counts = tlf.launch_counts()
        seconds = time.perf_counter() - t0
        for k, v in counts.items():
            total[k] += v
        files = {}
        if name != "hmc":
            t0 = time.perf_counter()
            back = load_chains(f"{base}{name}_", len(line.pop("folders")))
            files = dict(zip(("file_gap", "file_bound"),
                             file_gap(back, tensors["model"])),
                         load_chains_s=time.perf_counter() - t0)
        print(json.dumps({"phase": "samplers", "seconds": seconds,
                          "card": smi, **line, **files,
                          "launches": {k: v for k, v in counts.items()
                                       if v}}), flush=True)
        checks = {f"{k} on the card": v.is_cuda for k, v in tensors.items()}
        if files:
            checks["sample files"] = files["file_gap"] <= files["file_bound"]
        checks["finite"] = all(bool(np.isfinite(line[k])) for k in (
            "ess_min", "ess_median", "rhat_max", "mean_accept", "step_size"))
        for key, (lo, hi) in SAMPLER_BOUNDS.get(name, {}).items():
            checks[f"{key} in [{lo}, {hi}]"] = lo <= line[key] <= hi
        if name == "nuts":
            checks["divergences"] = (line["divergences"]
                                     <= NUTS_DIVERGENCE_SHARE
                                     * line["nchains"] * line["nsamples"])
        if name == "hmc":
            checks["draws launched"] = counts["draws"] > 0
            checks["eager path"] = line["fused_mode"] == "off"
            checks["adapted"] = bool(line["adapted_mass"])
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            fail(f"samplers {name}: {bad}")
    tmp.cleanup()
    return total, problem[0].n_active


def phase_samplers_kernel(torch, tlf, dev, M, chains):
    """``draws`` at the shapes a sampler gives it (``chains`` chains, ``M``
    cells at the lane-padded width) against its plain version, its
    uniforms bit for bit; outside the samplers' runs, since the plain
    version draws with the plain Philox."""
    width = -(-M // tlf.LANE) * tlf.LANE
    res = {}
    for C in chains:
        def make(C=C):
            return (torch.empty((C, width), device=dev),
                    torch.empty(C, device=dev), (11, 12), 7)
        res[C] = run_kernel_cases(torch, tlf, {"draws": (
            make, lambda a: {"n01": a[0], "u": a[1]})}, [C, width],
            "samplers_kernel")["draws"]
        n_k, u_k, n_p, u_p = (*make()[:2], *make()[:2])
        tlf.KERNELS["draws"](n_k, u_k, (11, 12), 7)
        tlf.KERNELS["draws"].plain(n_p, u_p, (11, 12), 7)
        sync(torch)
        if not torch.equal(u_k, u_p):
            fail(f"samplers_kernel: draws' uniforms at {C} chains differ "
                 "from the plain version's")
    return res


#: how the deterministic stages are held against the JAX package's golden
#: numbers (``tests/reginv_golden.py``, the JAX package on the CPU):
#: ``cg`` — float64: the same iteration count and alpha-decay iterations,
#:   every history entry and summary within ``rtol``;
#: ``bootstrap`` — float64, but minimum support with beta^2 = 1e-4 makes
#:   projected Fletcher-Reeves amplify rounding ten times in about ten
#:   iterations: the JAX package itself, given the same replicates one or
#:   five at a time (other product shapes), parts from its one-batch run
#:   by more than 1e-6 at iteration 74 of replicate 13 and moves its
#:   summaries by up to 2.1e-4 (``self_parting``, ``self_spread``). So:
#:   the same iteration counts; every replicate's data misfits within
#:   ``rtol`` over the first ``prefix`` iterations and the alpha-decay
#:   iterations among them identical; each summary within ``spread``
#:   times the JAX package's own spread;
#: ``map`` — float32 Damping at a fixed alpha, whose analytic step (twice
#:   the exact line search, the reference's) keeps every iterate on the
#:   start's level set of the objective while the box is not active: the
#:   JAX package's own iterates stay within 1.95e-5 of it in float32
#:   (5.0e-14 in float64, ``objective_spread*``), and its float32 and
#:   float64 runs pick best iterates (by rounding) whose T differ by 19 %
#:   (653.6, 774.9). So: the same iteration count, the first data misfit
#:   (sum of dobs^2) within ``rtol``, the first ``prefix`` data misfits
#:   within ``prefix_rtol`` of the JAX package's (the solver moves as it
#:   does; the card's float32 run parts from it by more than 1e-5 at
#:   iteration 54), the data misfit moving by more than ``moved`` of its
#:   start over the run, every iterate's objective within ``level_set``
#:   (5x the JAX package's float32 spread) of the start's, and T positive
#:   and at most 2 data_hist[0] (the level set's bound on the mean-removed
#:   misfit); T's gap to the JAX package's is reported in the line, not
#:   held.
#: ``bootstrap_southchina`` — float64 ``BootStrap`` with ``wavelet="1D"``
#:   on the carved South China mesh (the solve reads the dense matrix, as
#:   the JAX package's does): its data misfits grow rounding about tenfold
#:   an iteration, and the JAX package's own batch-1 and batch-5 runs part
#:   from its one-batch run by more than 1e-6 at iteration 7 to 11 and
#:   move its summaries by 3.3 % (std max) and 13.6 % (mean max). So: the
#:   mesh, the carved cell count and ``Awcp``'s shape and nonzeros equal
#:   the golden's, the same iteration counts, the first ``prefix`` data
#:   misfits within ``rtol`` with the same alpha decays among them, and
#:   each summary within ``spread`` times the JAX package's own spread.
GOLDEN = {"cg": dict(rtol=1e-6),
          "bootstrap": dict(rtol=1e-6, prefix=50, spread=4.0),
          "bootstrap_southchina": dict(rtol=1e-6, prefix=6, spread=4.0),
          "map": dict(rtol=1e-6, prefix=40, prefix_rtol=1e-5, moved=1e-3,
                      level_set=1e-4)}


def load_golden():
    """The JAX package's golden numbers
    (``gravinv3dhmc_tpu_torch/golden/reginv_jax.json``)."""
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "gravinv3dhmc_tpu_torch", "golden",
                        "reginv_jax.json")
    with open(path) as f:
        return json.load(f)


def rel_gap(a, b):
    """max |a - b| / |b| over the entries (0 where they are equal, NaN
    where both are NaN); inf if the shapes or the NaN entries differ."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape or not np.array_equal(np.isnan(a), np.isnan(b)):
        return float("inf")
    ok = ~np.isnan(b)
    err = np.abs(a[ok] - b[ok])
    gap = np.where(err == 0, 0.0, err / np.where(err == 0, 1.0,
                                                  np.abs(b[ok])))
    return float(gap.max()) if gap.size else 0.0


def golden_checks(name, line, hist, golden):
    """The stage against the JAX package's golden numbers (see
    :data:`GOLDEN`): ``(checks, gaps)``."""
    from gravinv3dhmc_tpu_torch.cg import decay_iters

    g, tol = golden[name], GOLDEN[name]
    gaps, checks = {}, {}
    if name == "cg":
        checks["n_iters"] = line["iterations"] == g["n_iters"]
        checks["decay iterations"] = (decay_iters(hist["regul_hist"])
                                      == g["decay_iters"])
        for k in ("data_hist", "model_hist", "regul_hist"):
            gaps[k] = rel_gap(hist[k], g[k])
        for k in ("final_data_misfit", "RMSD", "RMSM", "corr", "model_max"):
            gaps[k] = rel_gap(line[k], g[k])
        checks.update({f"{k} within {tol['rtol']}": v <= tol["rtol"]
                       for k, v in gaps.items()})
    elif name.startswith("bootstrap"):
        n = tol["prefix"]
        checks["n_iters"] = line["n_iters"] == g["n_iters"]
        d_h = hist["data_hist"]
        gaps["data_hist_prefix"] = rel_gap(d_h[:, :n],
                                           np.asarray(g["data_hist"])[:, :n])
        checks[f"first {n} data misfits within {tol['rtol']}"] = \
            gaps["data_hist_prefix"] <= tol["rtol"]
        checks[f"decay iterations below {n}"] = all(
            [k for k in decay_iters(r) if k < n]
            == [k for k in gr if k < n]
            for r, gr in zip(hist["regul_hist"], g["decay_iters"]))
        gaps["first_parting"] = min(
            (int(np.argmax(r > tol["rtol"])) for r in
             np.abs(d_h / np.asarray(g["data_hist"]) - 1)
             if (r > tol["rtol"]).any()), default=-1) \
            if d_h.shape == np.shape(g["data_hist"]) else None
        for k in g["self_spread"]:
            gaps[k] = rel_gap(line[k], g[k])
            bound = tol["spread"] * g["self_spread"][k]
            checks[f"{k} within {bound:.3g}"] = gaps[k] <= bound
        for k in ("mesh_shape", "carved_cells", "Awcp"):
            if k in g:
                checks[f"{k} as the golden's"] = line[k] == g[k]
    else:
        D, M = line["problem"]
        checks["n_iters"] = line["n_iters"] == g["n_iters"]
        gaps["data_hist_first"] = rel_gap(line["data_hist_first"],
                                          g["data_hist_first"])
        checks[f"data_hist_first within {tol['rtol']}"] = \
            gaps["data_hist_first"] <= tol["rtol"]
        n = tol["prefix"]
        gaps["data_hist_prefix"] = rel_gap(
            hist["data_hist"][:n], np.asarray(g["data_hist"])[:n])
        checks[f"first {n} data misfits within {tol['prefix_rtol']}"] = \
            gaps["data_hist_prefix"] <= tol["prefix_rtol"]
        checks[f"data misfit moved by more than {tol['moved']} of its "
               "start"] = bool(np.ptp(hist["data_hist"])
                               > tol["moved"] * hist["data_hist"][0])
        obj = (D * hist["data_hist"]
               + line["RegulFactor"] * M * hist["model_hist"])
        gaps["objective_spread"] = float(np.max(np.abs(obj / obj[0] - 1)))
        checks[f"level set within {tol['level_set']}"] = \
            gaps["objective_spread"] <= tol["level_set"]
        checks["T in (0, 2 data_hist[0]]"] = \
            0 < line["temperature"] <= 2 * line["data_hist_first"]
        for k in ("temperature", "data_hist_min", "data_hist_last"):
            gaps[k] = rel_gap(line[k], g[k])
        if hist["data_hist"].shape == np.shape(g["data_hist"]):
            # the first iterate whose data misfit parts from the JAX
            # package's by more than 1e-5 (f32)
            parted = (np.abs(hist["data_hist"] / np.asarray(g["data_hist"])
                             - 1) > 1e-5)
            gaps["data_hist_parting"] = (int(np.argmax(parted))
                                         if parted.any() else None)
    return checks, gaps


def phase_cg(torch, tlf, dev, smi, rd_problem):
    """``cg.run()``'s three stages on the card, each with its launches
    counted from 0 just before it, held as :data:`GOLDEN` says; returns
    the stages' lines."""
    from gravinv3dhmc_tpu_torch import cg

    golden = load_golden()
    lines = {}
    for name in cg.STAGES:
        sync(torch)
        tlf.reset_launch_counts()
        t0 = time.perf_counter()
        line_, tensors, hist = cg.run((name,), dev,
                                      map_problem=rd_problem)[name]
        sync(torch)
        seconds = time.perf_counter() - t0
        counts = tlf.launch_counts()
        checks, gaps = golden_checks(name, line_, hist, golden)
        checks.update({f"{k} on the card": v.is_cuda
                       for k, v in tensors.items()})
        d_h = np.asarray(hist["data_hist"])
        if name.startswith("bootstrap"):
            checks["finite histories"] = all(
                np.isfinite(row[:n - 1]).all()
                for row, n in zip(d_h, line_["n_iters"]))
            models = hist["models"]
            lo, hi = ((0.0, 1.0) if name == "bootstrap"
                      else cg.SOUTHCHINA["boundary"])
            checks["models in the box"] = bool(
                (models >= lo - 1e-12).all() and (models <= hi + 1e-12).all())
        else:
            checks["finite histories"] = bool(np.isfinite(d_h).all())
        if name == "cg":
            checks["models in the box"] = (line_["model_min"] >= -1e-12
                                           and line_["model_max"]
                                           <= 1 + 1e-12)
            checks["misfit below 5 % of its start"] = d_h[-1] < 0.05 * d_h[0]
            checks["corr > 0.5"] = line_["corr"] > 0.5
        if name == "map":
            m = tensors["m"]
            checks["models in the box"] = bool(
                (m >= -0.5 - 1e-6).all() and (m <= 0.5 + 1e-6).all())
        print(json.dumps({"phase": "cg", "stage": name, "seconds": seconds,
                          "card": smi, **line_, "golden_gaps": gaps,
                          "launches": {k: v for k, v in counts.items()
                                       if v}}), flush=True)
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            fail(f"cg {name}: {bad}")
        lines[name] = line_
    return lines


#: the realdata ChEES's cut: warmup and draws (the tool runs 256 and 256)
REALDATA_CUT = dict(nwarmup=16, nsamples=16)


def phase_samplers_realdata(torch, tlf, dev, smi, rd_problem, T):
    """The calibrated realdata ChEES at full width and cut depth, at the
    ``map`` stage's T; returns its launch counts, set to 0 just before
    it."""
    from gravinv3dhmc_tpu_torch import samplers

    sync(torch)
    tlf.reset_launch_counts()
    t0 = time.perf_counter()
    line_, tensors = samplers.run(
        ("realdata",), dev, rd_problem=rd_problem,
        rd=dict(REALDATA_CUT, temperature=T))["realdata"]
    sync(torch)
    counts = tlf.launch_counts()
    reduced = {k: [samplers.REALDATA[k], v] for k, v in REALDATA_CUT.items()}
    print(json.dumps({"phase": "samplers_realdata", "seconds":
                      time.perf_counter() - t0, "card": smi, **line_,
                      "reduced": reduced,
                      "launches": {k: v for k, v in counts.items() if v}}),
          flush=True)
    iters = REALDATA_CUT["nwarmup"] + REALDATA_CUT["nsamples"]
    checks = {f"{k} on the card": v.is_cuda for k, v in tensors.items()}
    checks["finite"] = all(bool(np.isfinite(line_[k])) for k in (
        "ess_min", "ess_median", "rhat_max", "mean_accept", "step_size",
        "mean_L"))
    checks["full width"] = (line_["nchains"] == samplers.REALDATA["nchains"]
                            and line_["problem"] == [576, 10676])
    checks["T from the map"] = line_["temperature"] == T
    checks["one draws launch an iteration"] = counts["draws"] == iters
    checks["accept in [0, 1]"] = 0 <= line_["mean_accept"] <= 1
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"samplers_realdata: {bad}")
    return counts


def phase_magnetic(torch, tlf, dev, smi):
    """The magnetic uniformgrid stage: the six iteration kernels against
    their plain versions on the magnetic matrix (columns of both signs),
    then ``uniformgrid.run_magnetic`` at full width (1024 chains, the bf16
    iteration op), its launches counted from 0 just before it; returns
    them."""
    from gravinv3dhmc_tpu_torch import uniformgrid

    t0 = time.perf_counter()
    cfg = uniformgrid.MAGNETIC
    problem = uniformgrid.build_problem(device=dev, field="magnetic",
                                        mangle=cfg["mangle"])
    module, dobs = problem
    line("magnetic_problem", seconds=time.perf_counter() - t0,
         shape=[int(dobs.size), module.n_active],
         A_range=[float(module.A.min()), float(module.A.max())])
    if not (module.A.min() < 0 < module.A.max()):
        fail("magnetic: the matrix's columns should have both signs")
    op = tlf.make_fused_iteration(
        *fused_args(module, dobs, high=cfg["box"][1]), regularization="MS",
        beta=0.001, Sigma=0.001, matvec_dtype=torch.bfloat16, device=dev)
    C = uniformgrid.SLICE["nchains"]
    cases = {k: v for k, v in kernel_cases(torch, op, C, dev).items()
             if k in tlf.ITERATION_KERNELS}
    run_kernel_cases(torch, tlf, cases, [C, op.Dp, op.Mp], "magnetic_kernel")
    del op
    path = tlf.path_kernels(tlf.ITERATION_KERNELS, torch.bfloat16)
    sync(torch)
    tlf.reset_launch_counts()
    stage, res = uniformgrid.run_magnetic(dev, problem)
    sync(torch)
    counts = tlf.launch_counts()
    finite = bool(torch.isfinite(res["samples"]).all())
    line("magnetic", card=smi, **stage, finite=finite,
         launches={n: counts[n] for n in path})
    missing = [n for n in path if counts[n] <= 0]
    if missing or not finite or not 0 < stage["accept_ratio"] <= 1:
        fail(f"magnetic: kernels never launched {missing}, finite "
             f"{finite}, accept {stage['accept_ratio']}")
    if not stage["fused_mode"].startswith("iteration"):
        fail(f"magnetic: ran {stage['fused_mode']}, not the iteration op")
    return counts


#: the wavelet stage's cut: stored iterations (two chunks of 32)
WAVELET_CUT = dict(nsamples=32, ndraws=32)
#: one leapfrog step in float32 on the sparse path against the float64
#: dense reference: x, p and U within this of max|value|
WAVELET_STEP_RTOL = 1e-4


def wavelet_dense(torch, module, dev, chunk=500):
    """``Awcp W`` as a dense (D, M) float64 tensor on ``dev``: the host
    DWT (``dwt1d``/``dwt3d``, the JAX package's bit for bit) of the
    identity's rows, in chunks, times the dense ``Awcp``. It shares no code
    with the card's transform, its adjoint or the CSR products."""
    from gravinv3dhmc_tpu_torch.ops import wavelet

    M = module.n_active
    rows = []
    for i in range(0, M, chunk):
        n = min(chunk, M - i)
        e = np.zeros((n, M))
        e[np.arange(n), i + np.arange(n)] = 1.0
        rows.append(wavelet.dwt1d(e) if module.wavelet == "1D" else
                    wavelet.dwt3d(e.reshape(n, *module.mshape)))
    Wt = torch.as_tensor(np.concatenate(rows), device=dev)  # (M, K): W^T
    return torch.as_tensor(module.Awcp.toarray(), device=dev) @ Wt.T


def leapfrog_step(pot, x, p, dt, dtype):
    """One leapfrog step (half kick, drift, half kick) on ``pot`` in
    ``dtype``; returns x', p' and U(x')."""
    x, p = x.to(dtype), p.to(dtype)
    p = p - 0.5 * dt * pot(x, 1.0)[1]
    x = x + dt * p
    U, g = pot(x, 1.0)[:2]
    return x, p - 0.5 * dt * g, U


def phase_wavelet(torch, tlf, dev, smi):
    """The wavelet stages, 1D and 3D, on the uniformgrid problem: one
    leapfrog step of the card (float32, the CSR products, the transform
    and its adjoint) against the same step in float64 through the
    module's dense potential on :func:`wavelet_dense`'s ``Awcp W``;
    ``predict`` against the dense ``Aw`` (the thresholding's
    error, reported); the eager run cut to :data:`WAVELET_CUT`, its
    launches counted from 0 just before it; the two sparse products
    against ``torch.matmul`` with the dense ``Aw``. Returns the runs'
    summed launch counts."""
    from gravinv3dhmc_tpu_torch import uniformgrid

    total = {name: 0 for name in tlf.KERNELS}
    for mode in ("1D", "3D"):
        t0 = time.perf_counter()
        problem = uniformgrid.build_problem(device=dev, wavelet=mode)
        module, dobs = problem
        build_s = time.perf_counter() - t0
        M = module.n_active
        w = torch.as_tensor(module.wdiag, device=dev)
        gen = torch.Generator(device=dev).manual_seed(3)
        x = (0.3 + 0.05 * torch.randn(64, M, generator=gen, device=dev,
                                      dtype=torch.float64)) * w
        p = 1e-3 * torch.randn(64, M, generator=gen, device=dev,
                               dtype=torch.float64)
        wd = module.wdiag
        pot_args = (wd * 0.001, 0 * wd, wd)
        pot_kw = dict(regularization="MS", beta=0.001)
        card = leapfrog_step(module.make_potential(*pot_args, **pot_kw,
                                                   dtype=torch.float32),
                             x, p, 0.01, torch.float32)
        ref_pot = module.make_potential(*pot_args, **pot_kw,
                                        dtype=torch.float64,
                                        use_wavelet=False)
        ref_pot.params["Aw"] = wavelet_dense(torch, module, dev)
        ref = leapfrog_step(ref_pot, x, p, 0.01, torch.float64)
        del ref_pot
        errs = {k: rel_err(a.double(), b)[1]
                for k, a, b in zip(("x", "p", "U"), card, ref)}
        module64 = module.device_arrays(torch.float64)
        d_sparse = (module.predict(x.float()).double())
        d_dense = x @ module64["Aw"].T
        threshold_err = rel_err(d_sparse, d_dense)[1]
        sync(torch)
        tlf.reset_launch_counts()
        stage, res = uniformgrid.run_wavelet(dev, mode, problem, **{
            k: v for k, v in WAVELET_CUT.items()})
        sync(torch)
        counts = tlf.launch_counts()
        for k, v in counts.items():
            total[k] += v
        products = uniformgrid.time_products(module, dev,
                                             uniformgrid.WAVELET["nchains"],
                                             rounds=3)
        finite = bool(torch.isfinite(res["samples"]).all())
        line("wavelet", card=smi, build_s=build_s, step_rel_err=errs,
             predict_vs_dense_rel_err=threshold_err, products_ms=products,
             finite=finite, reduced={k: [uniformgrid.WAVELET[k], v]
                                     for k, v in WAVELET_CUT.items()},
             launches={k: v for k, v in counts.items() if v}, **stage)
        iters = stage["iterations"]
        checks = {"step within rtol": max(errs.values()) <= WAVELET_STEP_RTOL,
                  "eager path": stage["fused_mode"] == "off",
                  "one draws launch an iteration": counts["draws"] == iters,
                  "finite": finite,
                  "accept in (0, 1]": 0 < stage["accept_ratio"] <= 1,
                  "compressed close to dense": threshold_err < 1e-2}
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            fail(f"wavelet {mode}: {bad}")
    return total


#: the magnetic demo's ChEES cut (the demo runs 192 + 256 in blocks of
#: 32): at phase 14's 16 + 16 the split R-hat over the 2,000 cells of 16
#: chains stays far above 1.2 (1.70 on the H100), at 64 + 64 it falls
#: below
MAGNETIC_CUT = dict(nwarmup=64, nsamples=64, chunk_iters=32)
#: the ChEES's R-hat bound (the cut run's, the largest over every cell)
MAGNETIC_RHAT = 1.2


def phase_magnetic_demo(torch, tlf, dev, smi):
    """``magnetic.run()`` (``tools/magnetic_demo.py``'s two
    configurations) with the ChEES cut to :data:`MAGNETIC_CUT`, its
    launches counted from 0 just before it; returns them and the ChEES's
    cell count."""
    from gravinv3dhmc_tpu_torch import magnetic

    sync(torch)
    tlf.reset_launch_counts()
    t0 = time.perf_counter()
    res, tensors, hists = magnetic.run(dev, chees=MAGNETIC_CUT)
    sync(torch)
    counts = tlf.launch_counts()
    reduced = {k: [magnetic.WIDE["chees"][k], v]
               for k, v in MAGNETIC_CUT.items()}
    print(json.dumps({"phase": "magnetic_demo", "seconds":
                      time.perf_counter() - t0, "card": smi, **res,
                      "reduced": reduced,
                      "launches": {k: v for k, v in counts.items() if v}}),
          flush=True)
    checks = {}
    for name, h in hists.items():
        d_h = np.asarray(h["data_hist"])
        checks[f"{name} MAP moved"] = bool(np.ptp(d_h) > 1e-3 * d_h[0])
        checks[f"{name} MAP finite"] = bool(np.isfinite(d_h).all())
        checks[f"{name} MAP on the card"] = \
            res[name]["bounded_map"]["m_on_card"]
        checks[f"{name} native tesseroids"] = \
            res[name]["tess_backend"] == "native"
    ch = res["wide_nonunique"]["honest_chees"]
    checks["ChEES finite"] = all(bool(np.isfinite(ch[k])) for k in (
        "accept", "posterior_truth_corr", "coverage_2std",
        "mean_posterior_std", "rhat_max", "step_size", "mean_L"))
    checks[f"ChEES R-hat < {MAGNETIC_RHAT}"] = ch["rhat_max"] < MAGNETIC_RHAT
    checks["ChEES tensors on the card"] = all(
        v.is_cuda for v in tensors["wide_nonunique"].values())
    checks["one draws launch an iteration"] = \
        counts["draws"] == ch["nwarmup"] + ch["nsamples"]
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"magnetic_demo: {bad}")
    return counts, res["wide_nonunique"]["problem"][1]


#: the f64 device prism builder against the numpy one, relative to
#: max|A| (the JAX package's own device builder, XLA on the CPU, is
#: 4.24e-12 from its numpy one at this size: the golden ``prism_device``
#: entry, reported beside the card's gap)
PRISM_DEVICE_RTOL = 1e-12


def phase_prism_device(torch, dev, smi):
    """``prism_kernel_matrix(backend="jax")`` (torch float64 on the card)
    against the numpy float64 builder at ``cg``'s 1,200 x 12,000, within
    :data:`PRISM_DEVICE_RTOL` of max|A|; both builds timed."""
    from gravinv3dhmc_tpu_torch import cg
    from gravinv3dhmc_tpu_torch.ops import prism

    wl = cg.twodykes()
    t0 = time.perf_counter()
    A_host = prism.prism_kernel_matrix("gz", *wl["obs"], wl["mesh"])
    host_s = time.perf_counter() - t0
    timings = {}
    sync(torch)
    t0 = time.perf_counter()
    A_dev = prism.prism_kernel_matrix("gz", *wl["obs"], wl["mesh"],
                                      backend="jax", device=dev,
                                      timings=timings)
    dev_s = time.perf_counter() - t0
    err = float(np.abs(A_dev - A_host).max() / np.abs(A_host).max())
    golden = load_golden()["prism_device"]
    line("prism_device", card=smi, shape=list(A_host.shape),
         host_build_s=host_s, device_build_s=dev_s, **timings,
         rel_err=err, jax_self_gap=golden["self_gap"],
         dtype=str(A_dev.dtype))
    if A_dev.dtype != np.float64 or not err <= PRISM_DEVICE_RTOL:
        fail(f"prism_device: rel err {err} > {PRISM_DEVICE_RTOL} or dtype "
             f"{A_dev.dtype}")


#: the joint phase's settings: ``tests/test_joint.py``'s truth (the
#: magnetization twice the density, the field at inclination 60,
#: declination 10) on the uniformgrid flagship's mesh, its HMCSample at
#: 64 chains, 128 stored iterations in chunks of 32
JOINT = dict(mangle=(60.0, 10.0), nchains=64, nsamples=128, chunk_size=32)
#: the joint potential in f32 on the card against the same module in f64
#: on the card (the f64 reference takes the f32 inputs): U and g over
#: their max |value| across the 64 chains
JOINT_RTOL = 1e-4


def joint_problem(dev):
    """The uniformgrid flagship (20 x 30 x 10 prisms of 100 m, 600
    observations at z = -1 m) with both fields: the ``JointModule``, the
    data forwarded by the f64 host builders."""
    from gravinv3dhmc_tpu_torch import mesher, uniformgrid, utils
    from gravinv3dhmc_tpu_torch.inversion.joint import JointModule
    from gravinv3dhmc_tpu_torch.ops import prism

    nx, ny, nz, d = 20, 30, 10, 100.0
    bounds = (0, nx * d, 0, ny * d, 0, nz * d)
    mesh = mesher.PrismMesh(bounds, (d, d, d))
    rho = 0.5 * uniformgrid.density_model(nx, ny, nz).ravel()
    xo, yo, zo = utils.regular(bounds[:4], (nx, ny), z=-1.0)
    mesh.addprop("density", rho)
    dgz, _ = prism.gz(xo, yo, zo, mesh)
    mesh.addprop("magnetization", 2.0 * rho)
    dtf, _ = prism.tf(xo, yo, zo, mesh, *JOINT["mangle"])
    return JointModule(dgz, dtf, bounds, (d, d, d), (xo, yo, zo),
                       mangle=JOINT["mangle"], verbose=False, device=dev)


def phase_joint(torch, tlf, dev, smi):
    """Joint gravity and magnetics (``inversion/joint.py``) on the card:
    the 1,200 x 12,000 block system's potential with Smoothness, without
    and with the cross-gradient, at 64 chains in f32 against f64; then
    ``HMCSample`` (Damping, :data:`JOINT`, ``use_fused=True``, which a
    module without a host matrix must decline for the eager path), its
    launches counted from 0 just before it; then the spherical joint
    module of ``tests/test_tesseroid_magnetic.py`` evaluated on the card.
    Returns the run's launch counts and the cells of a chain."""
    from gravinv3dhmc_tpu_torch.inversion.hmc import HMCSample
    from gravinv3dhmc_tpu_torch.inversion.joint import JointModule

    t0 = time.perf_counter()
    jm = joint_problem(dev)
    build_s = time.perf_counter() - t0
    n = jm.n_active
    w = torch.as_tensor(jm.wdiag, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    x = (w * (0.05 + 0.5 * torch.rand(JOINT["nchains"], n, generator=gen,
                                      device=dev, dtype=torch.float64))
         ).float()
    args = (jm.wdiag * 0.001, jm.wdiag * -0.1, jm.wdiag * 2.5)
    errs = {}
    for cgw in (0.0, 1.0):
        out = [jm.make_potential(*args, regularization="Smoothness",
                                 cross_gradient_weight=cgw,
                                 dtype=dt)(x.to(dt), 1.0)
               for dt in (torch.float32, torch.float64)]
        errs[f"cgw={cgw:g}"] = {k: rel_err(a, b)[1] for k, a, b in zip(
            ("U", "g"), out[0][:2], out[1][:2])}
    bnd = np.stack([np.full(n, -0.1), np.full(n, 2.5)], axis=1)
    dobs = np.concatenate([jm.dobs_gz, jm.dobs_tf])
    sync(torch)
    tlf.reset_launch_counts()
    t0 = time.perf_counter()
    stats = HMCSample(
        jm, JOINT["nsamples"], 0, 0.005, [3, 8], np.full(n, 0.001),
        np.full(n, 0.001), bnd, "mandatory", 1000.0, dobs, RegulFactor=1.0,
        regularization="Damping", seed=1, Sigma=0.001,
        nchains=JOINT["nchains"], chunk_size=JOINT["chunk_size"],
        verbose=False, write_files=False, store_mode="chain",
        use_fused=True, device=dev)
    sync(torch)
    counts = tlf.launch_counts()
    hmc_s = time.perf_counter() - t0
    samples = stats["samples"]
    finite = bool(torch.isfinite(samples).all())
    # the spherical joint problem (both tesseroid kernels, 16 x 36 cells)
    mrange = (-0.1, 0.1, -0.1, 0.1, 0.0, -6000.0)
    lons, lats = np.meshgrid(np.linspace(-0.08, 0.08, 4),
                             np.linspace(-0.08, 0.08, 4))
    lons, lats = lons.ravel(), lats.ravel()
    rng = np.random.RandomState(1)
    sph = JointModule(rng.normal(0, 5, lons.size),
                      rng.normal(0, 10, lons.size), mrange,
                      (-2000.0, 0.05, 0.05),
                      (lons, lats, np.full(lons.size, 400.0)),
                      coordinate="spherical", mangle=(50.0, 10.0),
                      verbose=False, device=dev)
    ws = sph.wdiag
    U_s, g_s, _ = sph.make_potential(0 * ws, -2.0 * ws, 2.0 * ws)(
        torch.as_tensor(0.1 * ws[None, :], device=dev), 1.0)
    sph_finite = bool(torch.isfinite(U_s).all() and torch.isfinite(g_s).all())
    iters = JOINT["nsamples"]
    line("joint", card=smi, problem=[int(dobs.size), n],
         build_s=build_s, f32_vs_f64_rel_err=errs, rtol=JOINT_RTOL,
         hmc_s=hmc_s, grad_evals_per_s=stats["grad_evals_per_s"],
         accept_ratio=stats["accept_ratio"], iterations=iters,
         fused_mode=stats["fused_mode"], finite=finite,
         spherical=[int(sph.dobs_gz.size), sph.n_active, sph_finite],
         launches={k: v for k, v in counts.items() if v})
    checks = {
        "f32 within rtol": all(v <= JOINT_RTOL for e in errs.values()
                               for v in e.values()),
        "eager path": stats["fused_mode"] == "off",
        "one draws launch an iteration": counts["draws"] == iters,
        "samples on the card": samples.is_cuda,
        "finite": finite,
        "accept in (0.2, 1]": 0.2 < stats["accept_ratio"] <= 1.0,
        "spherical finite": sph_finite,
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"joint: {bad}")
    return counts, n


#: the whole-Earth phase (``global_tess.py`` at scale 1: 7,381
#: observations x 72,000 tesseroids, the f32 matrix built on the card):
#: the native f64 mask's pair count, a fact of the geometry
#: (``GLOBAL_r05.json``'s ``nearfield_pairs``)
GLOBAL_PAIRS = 290_884
#: the device (f32) mask's pairs that differ from the native one's must
#: lie within this relative distance of their threshold (the JAX
#: ``subdivision_mask`` docstring's bound)
GLOBAL_FLIP_RTOL = 1e-6
#: 2,000 sampled entries of the weighted matrix (``RandomState(0)``, as
#: ``examples/run.py global`` draws them) against the native engine's f64
#: values with the same weights, over the largest sampled value
#: (``tests/test_tesseroid_ops.py``'s bound)
GLOBAL_ENTRY_RTOL = 1e-5
#: the bounded MAP (``--map-only --cg-alpha 5 --cg-maxk 1600``) and the
#: HMC's cut: full width, 32 chains from the MAP, the warmup at the JAX
#: command's least 20 chunks but of 32 iterations (its default 64), and
#: 64 stored iterations (its default 500)
GLOBAL_MAP = dict(alpha=5.0, maxk=1600)
GLOBAL_HMC = dict(nchains=32, chunk_size=32, adapt_chunks=20, nsamples=64)


def mask_flips(lon, lat, height, cells, ratio, native, device):
    """The pairs in which the device mask and the native one differ, and
    each one's ``|d^2 - threshold| / threshold`` in f64 (the host test's
    terms)."""
    from gravinv3dhmc_tpu_torch.ops import tesseroid

    M = cells.shape[0]
    keys = [o.astype(np.int64) * M + c for o, c in (native, device)]
    flips = np.setxor1d(*keys)
    o, c = flips // M, flips % M
    lont, _, sinlatt, coslatt, rt, thr = tesseroid._mask_cell_terms(cells,
                                                                    ratio)
    lon_r, lat_r = np.radians(lon[o]), np.radians(lat[o])
    r = tesseroid.MEAN_EARTH_RADIUS + height[o]
    cospsi = (np.sin(lat_r) * sinlatt[c]
              + np.cos(lat_r) * coslatt[c] * np.cos(lon_r - lont[c]))
    d2 = r ** 2 + rt[c] ** 2 - 2.0 * r * rt[c] * cospsi
    return flips.size, np.abs(d2 - thr[c]) / thr[c]


def phase_global(torch, tlf, dev, smi):
    """The whole-Earth workload at full scale on the card: the build (the
    synthetic data's forward on the host, the far field, the native mask
    and pair values, the weighting; :data:`GLOBAL_PAIRS`), the device mask
    against the native one, sampled entries against the native engine,
    the bounded MAP (:data:`GLOBAL_MAP`), then the eager HMC from the MAP
    (:data:`GLOBAL_HMC`, its launches counted from 0 just before it) and
    one post-freeze chunk profiled. Returns the HMC's launch counts and
    the cells of a chain."""
    import os

    from gravinv3dhmc_tpu_torch import global_tess as G
    from gravinv3dhmc_tpu_torch.ops import tesseroid
    from gravinv3dhmc_tpu_torch.runtime import tessglq

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wl, dpre, dobs, module = G.build(1.0, device=dev)
    build_s = time.perf_counter() - t0
    lon, lat, h = wl["obs"]
    cells = wl["mesh"].cell_bounds(only_active=True)
    D, M = lon.size, module.n_active
    ratio = tesseroid._RATIOS["gz"]
    t0 = time.perf_counter()
    native = tesseroid.subdivision_mask(lon, lat, h, cells, ratio,
                                        backend="native")
    native_mask_s = time.perf_counter() - t0
    sync(torch)
    t0 = time.perf_counter()
    on_card = tesseroid.subdivision_mask(lon, lat, h, cells, ratio,
                                         backend="device", device=dev)
    device_mask_s = time.perf_counter() - t0
    n_flips, flip_rel = mask_flips(lon, lat, h, cells, ratio, native,
                                   on_card)
    rng = np.random.RandomState(0)
    si, sj = rng.randint(0, D, 2000), rng.randint(0, M, 2000)
    Aw = module.device_arrays()["Aw"]
    got = Aw[torch.as_tensor(si, device=dev),
             torch.as_tensor(sj, device=dev)].double().cpu().numpy()
    want = (tessglq.kernel_pairs("gz", lon, lat, h, si, sj, cells, ratio)
            * tesseroid._SCALES["gz"]
            * module.wdiag_inv.double().cpu().numpy()[sj])
    entry_err = float(np.abs(got - want).max() / np.abs(want).max())
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "GLOBAL_r05.json")) as f:
        jax_map = json.load(f)["bounded_map_converged_recheck_maxk1600"]
    line("global_build", card=smi, problem=[D, M],
         matrix_bytes=Aw.numel() * Aw.element_size(), build_s=build_s,
         forward_s=wl["forward_s"], forward_backend=wl["forward_backend"],
         kernel_build_device_s=module.kernel_build_s,
         weighting_device_s=module.weighting_s, **module.build_seconds,
         nearfield_pairs=module.nearfield_pairs,
         mask_backend=module.mask_backend,
         pairs_backend=module.pairs_backend, native_mask_s=native_mask_s,
         device_mask_s=device_mask_s, device_mask_pairs=int(on_card[0].size),
         mask_flips=n_flips,
         mask_flip_max_rel=float(flip_rel.max()) if n_flips else 0.0,
         entry_rel_err=entry_err,
         peak_device_bytes=torch.cuda.max_memory_allocated())
    checks = {
        f"{GLOBAL_PAIRS} native pairs": (module.nearfield_pairs
                                         == native[0].size == GLOBAL_PAIRS),
        "native mask and pair values": (module.mask_backend
                                        == module.pairs_backend
                                        == "native"),
        "device mask flips at the threshold": (
            not n_flips or flip_rel.max() <= GLOBAL_FLIP_RTOL),
        "sampled entries": entry_err <= GLOBAL_ENTRY_RTOL,
        "matrix on the card": Aw.is_cuda and module.Aw is None,
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"global build: {bad}")

    mp, cg = G.bounded_map(wl, dobs, module, **GLOBAL_MAP)
    d_h = cg["data_hist"]
    line("global_map", card=smi, **mp, data_hist_first=float(d_h[0]),
         data_hist_min=float(d_h.min()),
         jax_tpu_statistics={"posterior_truth_corr": jax_map["best_corr"],
                             "RMSM": jax_map["best_RMSM"],
                             "source": "GLOBAL_r05.json bounded_map_"
                                       "converged_recheck_maxk1600"})
    checks = {"misfit moved": bool(np.ptp(d_h) > 1e-3 * d_h[0]),
              "finite": bool(np.isfinite(d_h).all()
                             and torch.isfinite(cg["m"]).all()),
              "corr > 0.3": mp["posterior_truth_corr"] > 0.3,
              "on the card": cg["m"].is_cuda}
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"global map: {bad}")

    sync(torch)
    tlf.reset_launch_counts()
    out, stats, chain_args = G.sample(wl, dobs, module, warm_start=cg,
                                      **GLOBAL_HMC)
    sync(torch)
    counts = tlf.launch_counts()
    summ, _ = G.profile_post_freeze(module, dobs, stats, chain_args)
    # each potential evaluation reads the f32 matrix twice (A x, r A)
    step_bound_ms = 2 * D * M * 4 / HBM_BYTES_S * 1e3
    busy = summ["device_busy_ms"]
    line("global_hmc", card=smi, **out,
         reduced={"nchains": [2, GLOBAL_HMC["nchains"]],
                  "chunk_size": [64, GLOBAL_HMC["chunk_size"]],
                  "nsamples": [500, GLOBAL_HMC["nsamples"]]},
         profile={k: summ[k] for k in ("iterations", "chains", "batch_steps",
                                       "wall_ms", "device_busy_ms",
                                       "busy_share")},
         idle_share=None if busy is None else 1.0 - summ["busy_share"],
         busy_ms_per_step=None if busy is None
         else busy / summ["batch_steps"],
         step_bound_ms=step_bound_ms, top_device_ops=summ["by_kernel"][:8],
         launches={k: v for k, v in counts.items() if v})
    chunk = GLOBAL_HMC["chunk_size"]
    least = (GLOBAL_HMC["adapt_chunks"]
             + -(-GLOBAL_HMC["nsamples"] // chunk)) * chunk
    keys = ("RMSD", "RMSM", "posterior_truth_corr", "grad_evals_per_s",
            "step_size", "ess_median", "ess_frozen_floor")
    checks = {"finite": all(np.isfinite(out[k]) for k in keys),
              "accept in (0.2, 1]": 0.2 < out["accept_ratio"] <= 1.0,
              "eager path": out["fused_mode"] == "off",
              "adapted": bool(out["adapted_mass"]),
              "one draws launch an iteration": (
                  counts["draws"] >= least and counts["draws"] % chunk == 0),
              "samples on the card": stats["samples"].is_cuda,
              "profiled on the card": busy is not None}
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"global hmc: {bad}")
    return counts, M, (wl, dpre, dobs, module)


#: phase 24's runs: the bounded-MAP ladder and the roofline uncut (the
#: tools' defaults), the whole-Earth ChEES cut in depth only (the tool
#: runs 16 chains, 300 warmup and 512 samples with max_steps 1024)
STUDIES = {"bounded_map": dict(maxk=400, decades=3, chunk=800),
           "global_chees": dict(nchains=16, nwarmup=32, nsamples=32,
                                max_steps=64, chunk=16),
           "roofline": dict(nchains=1024, reps=200)}


def finite_numbers(v):
    """Every float in a JSON-like value is finite."""
    if isinstance(v, dict):
        return all(finite_numbers(x) for x in v.values())
    if isinstance(v, (list, tuple)):
        return all(finite_numbers(x) for x in v)
    return not isinstance(v, float) or bool(np.isfinite(v))


def counted(torch, tlf, fn):
    """``(fn(), launch counts)``: the launches of ``fn``'s run alone."""
    sync(torch)
    tlf.reset_launch_counts()
    out = fn()
    sync(torch)
    return out, tlf.launch_counts()


def phase_studies(torch, tlf, dev, smi, problem):
    """Phase 24: the bounded-MAP ladder and the whole-Earth ChEES on phase
    20's ``problem`` (``(wl, dpre, dobs, module)``), then the roofline on
    the uniformgrid flagship (:data:`STUDIES`). Returns the three runs'
    launch counts and the (cells, chains) of each ``draws`` shape."""
    import os

    from gravinv3dhmc_tpu_torch import bounded_map, global_chees, roofline
    from gravinv3dhmc_tpu_torch import uniformgrid

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "GLOBAL_r05.json")) as f:
        records = json.load(f)
    t_phase = time.perf_counter()
    total = {name: 0 for name in tlf.KERNELS}

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    # the bounded-MAP ladder
    cfg = STUDIES["bounded_map"]
    t0 = time.perf_counter()
    bm, counts = counted(torch, tlf, lambda: bounded_map.run(
        device=dev, problem=problem, **cfg))
    add(counts)
    jax_bm = records["bounded_map_ladder_maxk400"]
    alphas = [e["alpha"] for e in bm["ladder"]]
    line("studies_bounded_map", card=smi, seconds=time.perf_counter() - t0,
         **bm, n_iters=[e["n_iters"] for e in bm["ladder"]],
         jax_tpu_statistics={
             k: jax_bm[k] for k in ("alpha_ref", "best_alpha", "best_corr",
                                    "best_RMSM")} | {
             "n_iters": [e["n_iters"] for e in jax_bm["ladder"]],
             "source": "GLOBAL_r05.json bounded_map_ladder_maxk400"},
         launches={k: v for k, v in counts.items() if v})
    checks = {
        "finite": finite_numbers(bm) and bm["alpha_ref"] is not None,
        "the ladder's rule": alphas == bounded_map.ladder(bm["alpha_ref"],
                                                          cfg["decades"]),
        "n_iters <= maxk": all(0 < e["n_iters"] <= cfg["maxk"]
                               for e in bm["ladder"]),
        "on the card": bm["device"] == smi,
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"studies bounded_map: {bad}")

    # the whole-Earth ChEES, cut in depth
    cfg = STUDIES["global_chees"]
    t0 = time.perf_counter()
    (gc, xs), counts = counted(torch, tlf, lambda: global_chees.run(
        device=dev, problem=problem, **cfg))
    add(counts)
    jax_gc = records["chees_fullscale_chunked"]
    M = problem[3].n_active
    line("studies_global_chees", card=smi,
         seconds=time.perf_counter() - t0, **gc,
         buffer=list(xs.shape), buffer_on_card=xs.is_cuda,
         reduced={k: [v, cfg[k]] for k, v in (
             ("nwarmup", 300), ("nsamples", 512), ("max_steps", 512))},
         jax_tpu_statistics={
             k: jax_gc[k] for k in ("posterior_truth_corr", "RMSM",
                                    "coverage_2std", "accept_mean",
                                    "max_steps_saturated", "step_size",
                                    "mean_L")} | {
             "source": "GLOBAL_r05.json chees_fullscale_chunked"},
         launches={k: v for k, v in counts.items() if v})
    n_iters = gc["nwarmup"] + gc["nsamples"]
    checks = {
        "finite": finite_numbers(gc) and bool(torch.isfinite(xs).all()),
        "buffer (32, 16, 72000) on the card": (
            list(xs.shape) == [cfg["nsamples"], cfg["nchains"], M]
            and xs.is_cuda),
        "accept in (0, 1]": 0.0 < gc["accept_mean"] <= 1.0,
        "one draws launch an iteration": counts["draws"] == n_iters,
        "no other kernel": all(v == 0 for k, v in counts.items()
                               if k != "draws"),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"studies global_chees: {bad}")
    del xs

    # the roofline on the uniformgrid flagship
    cfg = STUDIES["roofline"]
    t0 = time.perf_counter()
    rl, counts = counted(torch, tlf, lambda: roofline.run(
        device=dev, problem=uniformgrid.build_problem(device=dev), **cfg))
    add(counts)
    line("studies_roofline", card=smi, seconds=time.perf_counter() - t0,
         **rl, launches={k: v for k, v in counts.items() if v})
    peak = 1.05 * roofline.PEAK_BF16_TFLOPS
    flops = rl["nchains"] * 4.0 * rl["padded"][0] * rl["padded"][1]
    times = [t for kind in ("device", "wall")
             for t in rl[f"traj_by_L_{kind}_s"].values()]
    checks = {
        "finite": finite_numbers(rl),
        "matmul TFLOP/s <= 1.05 x 989": (
            rl["matmul_tflops_sane"]
            and flops / rl["matmul_pair_wall_s"] / 1e12 <= peak),
        "trajectory times positive": all(t > 0 for t in times),
        "t(L) slopes positive": (rl["traj_per_step_device_s"] > 0
                                 and rl["traj_per_step_wall_s"] > 0),
        "the kernels launched": all(
            counts[k] > 0 for k in ("drift", "residual", "kick",
                                    "traj_finish", "refresh", "accept",
                                    "draws")),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"studies roofline: {bad}")
    line("studies", card=smi, seconds=time.perf_counter() - t_phase)
    return total, ((M, STUDIES["global_chees"]["nchains"]),
                   (rl["problem"][1], rl["nchains"]))


#: the ``run`` phase: each subcommand of ``python -m
#: gravinv3dhmc_tpu_torch.run`` at its full geometry, depth cut (the cut
#: flags' defaults are 500 samples, 100 warmup draws, 200 CG iterations,
#: 20 replicates), with its expected keys (``RUN_KEYS``, which
#: ``tests/test_torch_run.py`` holds to the JAX driver's lines)
RUN_CASES = {
    "uniformgrid": ["uniformgrid", "--nsamples", "200"],
    "segmentgrid": ["segmentgrid", "--nsamples", "200"],
    "ratiogrid": ["ratiogrid", "--nsamples", "100"],
    "uniformgrid-chees": ["uniformgrid", "--sampler", "chees", "--nsamples",
                          "200"],
    "realdata": ["realdata", "--nsamples", "16"],
    "realdata-chees": ["realdata", "--sampler", "chees", "--nchains", "4",
                       "--nsamples", "64", "--nwarmup", "64",
                       "--chunk-size", "32"],
    "global-map": ["global", "--scale", "0.25", "--map-only"],
    "global-hmc": ["global", "--scale", "0.25", "--nchains", "4",
                   "--nsamples", "32", "--chunk-size", "16"],
    "cg": ["cg", "--model", "model04_complex"],
    "bootstrap": ["bootstrap"],
    "bootstrap-southchina": ["bootstrap-southchina"],
}
_SUMMARY_KEYS = frozenset((
    "n_chains", "n_samples", "rhat_max", "ess_min", "ess_mean", "RMSD",
    "sampler", "total_s", "grad_evals_per_s", "accept_ratio", "workload",
    "problem"))
_HMC_KEYS = _SUMMARY_KEYS | {"RMSM", "sampling_s", "ess_per_s_median"}
_GLOBAL_BUILD = frozenset((
    "kernel_build_device_s", "weighting_device_s", "nearfield_pairs",
    "mask_backend", "pairs_backend", "build_seconds", "forward_s",
    "forward_backend"))
RUN_KEYS = {
    "uniformgrid": _HMC_KEYS, "segmentgrid": _HMC_KEYS,
    "ratiogrid": _HMC_KEYS, "uniformgrid-chees": _HMC_KEYS,
    "realdata": _SUMMARY_KEYS,
    "realdata-chees": _SUMMARY_KEYS | {"temperature"},
    "global-map": frozenset((
        "workload", "estimator", "problem", "RMSD", "RMSM",
        "posterior_truth_corr", "noise_sigma", "n_iters", "total_s",
        "solve_s")) | _GLOBAL_BUILD,
    "global-hmc": frozenset((
        "n_common", "RMSD", "mean_model_max", "std_model_max", "RMSM",
        "posterior_truth_corr", "coverage_2std", "amplitude_ratio",
        "ess_median", "ess_frozen_floor", "ess_degenerate", "sampler",
        "total_s", "sampling_s", "grad_evals_per_s", "accept_ratio",
        "step_size", "adapted_mass", "fused_mode", "cg",
        "ess_per_s_median", "workload", "problem", "data_rms_centered",
        "noise_sigma", "target", "variance_explained")) | _GLOBAL_BUILD,
    "cg": frozenset(("iterations", "final_data_misfit", "RMSD", "RMSM",
                     "corr", "workload")),
    "bootstrap": frozenset(("workload", "samples", "mean_model_max",
                            "std_model_max", "RMSM")),
    "bootstrap-southchina": frozenset((
        "workload", "mesh_shape", "carved_cells", "samples",
        "model_std_max", "finite")),
}
#: the ``run`` phase's bounds on each line's numbers (a key: (low, high)),
#: beside the finite statistics. Where a line has a truth, RMSD (raw, as
#: the line gives it) and RMSM must lie on the JAX driver's side of the
#: midpoint between the JAX driver's reading at the same arguments (the
#: JAX command on the CPU, its own draws) and the value of the start every
#: chain leaves (0.001 everywhere), so a chain that never moves fails:
#: uniformgrid JAX RMSD 0.1132, RMSM 0.0676, start 0.7840, 0.1264;
#: segmentgrid JAX 0.1051, 0.0669, start 1.0912, 0.1264; ratiogrid JAX
#: RMSD 1.0002, start 3.6584 (its RMSM, JAX 0.1272 against the start's
#: 0.1212, tells no moving chain from a frozen one and is not bounded);
#: uniformgrid ChEES JAX 8.6313, 0.4553 (at most twice those). Accept: the
#: HMC runs keep the reference's fixed dt 0.01 and Sigma 0.001 in float32
#: (no adaptation); the JAX driver reads 1.0 for uniformgrid, segmentgrid
#: and realdata (as the live f64 reference kernel does), 0.8516 for
#: ratiogrid; ChEES adapts to its 0.75 target (0.4-0.95); the whole-Earth
#: HMC adapts dt (0.2-1, as phase 20). Truth correlation: the bounded MAP
#: above 0.3 (``tests/test_examples_cli.py``), CG above 0.5 (phase 13,
#: ``tests/test_reginv.py``), and so the whole-Earth HMC from its CG start
#: (the JAX driver reads 0.7123, its MAP-only line 0.5752)
RUN_BOUNDS = {
    "uniformgrid": {"accept_ratio": (0.9, 1.0), "RMSD": (0.0, 0.45),
                    "RMSM": (0.0, 0.097)},
    "segmentgrid": {"accept_ratio": (0.9, 1.0), "RMSD": (0.0, 0.6),
                    "RMSM": (0.0, 0.097)},
    "ratiogrid": {"accept_ratio": (0.5, 1.0), "RMSD": (0.0, 2.3)},
    "uniformgrid-chees": {"accept_ratio": (0.4, 0.95),
                          "RMSD": (4.7, 17.3), "RMSM": (0.29, 0.91)},
    "realdata": {"accept_ratio": (0.9, 1.0)},
    "realdata-chees": {"accept_ratio": (0.4, 0.95),
                       "temperature": (1e-9, np.inf)},
    "global-map": {"posterior_truth_corr": (0.3, 1.0)},
    "global-hmc": {"accept_ratio": (0.2, 1.0),
                   "posterior_truth_corr": (0.5, 1.0)},
    "cg": {"corr": (0.5, 1.0)},
    "bootstrap": {"std_model_max": (1e-12, np.inf)},
    "bootstrap-southchina": {"model_std_max": (1e-12, np.inf)},
}
#: the runs that sample (a ``draws`` launch at least once an iteration)
RUN_SAMPLERS = ("uniformgrid", "segmentgrid", "ratiogrid",
                "uniformgrid-chees", "realdata", "realdata-chees",
                "global-hmc")


def phase_run(torch, tlf, dev, smi, plain):
    """``gravinv3dhmc_tpu_torch.run.main(argv)`` for each of
    :data:`RUN_CASES`, its launches counted from 0 just before it, its
    line printed with the seconds, the card and the launches; each line
    must hold :data:`RUN_KEYS`, finite statistics inside
    :data:`RUN_BOUNDS`, a sampler's run launches ``draws`` and no plain
    Philox is called. Returns the launch counts summed over the runs and
    the distinct (cells, chains) of the sampler runs, the shapes their
    ``draws`` launches had."""
    import contextlib
    import io

    from gravinv3dhmc_tpu_torch import run

    total = {name: 0 for name in tlf.KERNELS}
    shapes = set()
    for name, argv in RUN_CASES.items():
        sync(torch)
        tlf.reset_launch_counts()
        calls = plain.calls
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            with plain:
                out = run.main(argv + ["--quiet"])
        sync(torch)
        seconds = time.perf_counter() - t0
        counts = tlf.launch_counts()
        for k, v in counts.items():
            total[k] += v
        printed = printed.getvalue().strip().splitlines()
        line("run", case=name, argv=argv, seconds=seconds, card=smi,
             launches={k: v for k, v in counts.items() if v}, **out)
        stats = {k: v for k, v in out.items()
                 if isinstance(v, float) and k not in ("total_s",)}
        checks = {
            "one JSON line": (len(printed) == 1
                              and json.loads(printed[0]) == out),
            "keys": set(out) == RUN_KEYS[name],
            "finite": all(np.isfinite(v) for v in stats.values()),
            "no plain Philox": plain.calls == calls,
        }
        for key, (lo, hi) in RUN_BOUNDS[name].items():
            checks[f"{key} in [{lo}, {hi}]"] = lo <= out[key] <= hi
        if name in RUN_SAMPLERS:
            checks["draws launched"] = counts["draws"] > 0
            shapes.add((out["problem"][1], run.parse_args(argv).nchains))
        else:
            checks["no kernel"] = not any(counts.values())
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            fail(f"run {name}: {bad}")
    return total, sorted(shapes)


#: the CUDA functions of the bf16 iteration op that a profiled chunk's
#: trace must name (the wrappers' kernels, ``csrc/leapfrog.cu``)
TRACE_KERNELS = {"refresh": "refresh_kernel", "drift": "drift_kernel",
                 "residual": "residual_partial_tc_kernel",
                 "kick": "kick_tc_kernel",
                 "traj_finish": "traj_finish_kernel",
                 "accept": "accept_kernel"}


def phase_profiling(torch, tlf, dev, smi):
    """One warm chunk of the uniformgrid slice (1024 chains, the bf16
    iteration op), then one chunk inside ``profiling.device_trace``: the
    Chrome trace must name :data:`TRACE_KERNELS`, and
    ``profiling.memory_report()`` report ``cuda:0`` with a non-zero peak.
    Returns the launch counts of both chunks, set to 0 just before."""
    import tempfile

    from gravinv3dhmc_tpu_torch import profiling, uniformgrid

    module, dobs = uniformgrid.build_problem(device=dev)
    chain = uniformgrid.slice_sampler(module, dobs, dev)
    run_chunk, carry = chain.prepare(uniformgrid.SLICE["nsamples"], 0)
    sync(torch)
    tlf.reset_launch_counts()
    carry, _ = run_chunk(carry, chain.seed, 0)
    sync(torch)
    tmp = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    with profiling.timers("traced_chunk"):
        with profiling.device_trace(tmp.name) as path:
            carry, stats = run_chunk(carry, chain.seed, 1)
    seconds = time.perf_counter() - t0
    counts = tlf.launch_counts()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    found = {w: sum(sym in k for k in kernels)
             for w, sym in TRACE_KERNELS.items()}
    mem = profiling.memory_report()
    line("profiling", card=smi, seconds=seconds, trace_bytes=os.path.getsize(
        path), kernel_events=len(kernels), trace_kernels=found,
         memory=mem, timers=profiling.timers.summary(),
         launches={k: v for k, v in counts.items() if v})
    tmp.cleanup()
    checks = {
        "trace names the iteration kernels": all(found.values()),
        "cuda:0 reported": "cuda:0" in mem,
        "non-zero peak": mem.get("cuda:0", {}).get("peak_gb", 0) > 0,
        "finite chunk": bool(torch.isfinite(stats).all()),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"profiling: {bad}")
    return counts


#: the multichip phase's command line (``run.py uniformgrid`` at the
#: flagship's full width, depth cut) and its groups: name -> (ranks,
#: ``multichip_check`` arguments); the gloo groups share ``cuda:0``
MULTICHIP_CLI = ["uniformgrid", "--nchains", "1024", "--nsamples", "16",
                 "--chunk-size", "16", "--quiet"]
_GLOO = ["--device", "cuda:0", "--backend", "gloo"]
MULTICHIP_GROUPS = {
    "nccl1": (1, ["cli", "--", *MULTICHIP_CLI, "--multichip"]),
    "gloo2": (2, ["runs", *_GLOO, "--runs", "fixed,adapt,smooth"]),
    "gloo4": (4, ["runs", *_GLOO, "--runs", "fixed,adapt"]),
    "gloo4_cli": (4, ["cli", *_GLOO, "--", *MULTICHIP_CLI, "--multichip",
                      "--device", "cuda:0", "--dist-backend", "gloo"]),
}
#: float64 sharded runs against the unsharded: the state's largest
#: difference over its largest value, and the step size's and inverse
#: mass's relative gaps (partial sums over the model shards round apart
#: by about 1e-16)
MULTICHIP_RTOL = 1e-9
#: the float32 command line under (2, 2) against the unsharded one: the
#: accept ratio's gap and RMSD's and RMSM's relative gaps (the partial
#: sums round apart by about 1e-7, so an accept near log u can flip)
MULTICHIP_F32 = {"accept_ratio": 0.005, "RMSD": 0.01, "RMSM": 0.01}
#: the seconds the groups get, started together
MULTICHIP_TIMEOUT_S = 240
#: the line's numbers that are timings (not held bit for bit)
_TIMINGS = ("total_s", "sampling_s", "grad_evals_per_s", "ess_per_s_median")


def start_group(name, ranks, args, workdir):
    """``torchrun --standalone`` of ``multichip_check`` with ``args``
    (``runs`` writes its states to ``workdir/name`` and reads the
    flagship's matrix from ``workdir/kernel.npy``), in a session of its
    own so that the group can be ended with its ranks. Returns the Popen
    and its output directory."""
    out = os.path.join(workdir, name)
    os.makedirs(out)
    if args[0] == "runs":
        args = [*args, "--out", out, "--kernel-cache",
                os.path.join(workdir, "kernel.npy")]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    stdout = open(os.path.join(out, "stdout.txt"), "w")
    log = open(os.path.join(out, "log.txt"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(ranks), "-m",
         "gravinv3dhmc_tpu_torch.multichip_check", *args],
        stdout=stdout, stderr=log, env=env, start_new_session=True)
    return proc, out


def end_groups(procs):
    """Stop every group still running (its whole session)."""
    import signal

    for proc, _ in procs.values():
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()


def group_lines(name, proc, out):
    """Rank 0's ``multichip_check`` lines of a finished group; a group
    that failed fails the phase with its log's tail."""
    with open(os.path.join(out, "stdout.txt")) as f:
        lines = [json.loads(ln) for ln in f
                 if ln.startswith('{"multichip_check"')]
    if proc.returncode != 0 or not lines:
        with open(os.path.join(out, "log.txt")) as f:
            tail = f.read()[-4000:]
        fail(f"multichip {name}: rc {proc.returncode}, {len(lines)} lines:"
             f"\n{tail}")
    return {ln["multichip_check"]: ln for ln in lines}


def phase_multichip(torch, tlf, philox, dev, smi):
    """Phase 23 (see the module docstring). Returns the ``draws`` launches
    of the groups' ranks and of this process's unsharded runs."""
    import tempfile

    from gravinv3dhmc_tpu_torch import multichip_check as mc

    t_phase = time.perf_counter()
    # draws at a shard's offsets: the block of one full launch
    salt = philox.salt_from_seed(15)
    draws = tlf.KERNELS["draws"]
    full_n = torch.empty((1024, 6016), device=dev)
    full_u = torch.empty(1024, device=dev)
    draws(full_n, full_u, salt, 7)
    n_k, u_k = torch.empty((512, 3000), device=dev), torch.empty(512,
                                                                  device=dev)
    n_p, u_p = torch.empty_like(n_k), torch.empty_like(u_k)
    draws(n_k, u_k, salt, 7, 512, 750)
    draws.plain(n_p, u_p, salt, 7, 512, 750)
    sync(torch)
    block = {"normals_bit_equal": torch.equal(n_k,
                                              full_n[512:, 3000:6000]),
             "uniforms_bit_equal": torch.equal(u_k, full_u[512:]),
             "uniforms_plain_bit_equal": torch.equal(u_k, u_p)}
    block_err = rel_err(n_k, n_p)[1]
    line("multichip", check="draws_offsets", shape=[512, 3000],
         offsets=[512, 750], normals_rel_err=block_err, **block)
    if not all(block.values()) or block_err > KERNEL_RTOL:
        fail(f"multichip: draws at offsets {block}, rel err {block_err}")
    # against the plain version and timed at the blocks the ranks launch:
    # (1, 2)'s second rank and (2, 2)'s last
    for C, c0 in ((1024, 0), (512, 512)):
        def make(C=C, c0=c0):
            return (torch.empty((C, 3000), device=dev),
                    torch.empty(C, device=dev), salt, 7, c0, 750)
        run_kernel_cases(torch, tlf, {"draws": (
            make, lambda a: {"n01": a[0], "u": a[1]})}, [C, 3000],
            "multichip_kernel")

    workdir = tempfile.mkdtemp(prefix="multichip_")
    procs = {}
    try:
        t0 = time.perf_counter()
        # the flagship's matrix built once, for this process and the
        # ranks of the ``runs`` groups (each would build it twice)
        module, dobs = mc.problem(dev, os.path.join(workdir, "kernel.npy"))
        for name, (ranks, args) in MULTICHIP_GROUPS.items():
            procs[name] = start_group(name, ranks, args, workdir)
        # the unsharded counterparts, on the card meanwhile
        counts = {name: 0 for name in tlf.KERNELS}
        ref = {}
        for run in mc.RUNS:
            tlf.reset_launch_counts()
            t1 = time.perf_counter()
            res = mc.sample(module, dobs, run, dev)
            sync(torch)
            ref[run] = (mc.summary(res, time.perf_counter() - t1),
                        res["x"].cpu().numpy())
            counts["draws"] += tlf.KERNELS["draws"].launches
        del module
        # the command line unsharded (float32, run.py's default)
        line_ref, acc_ref, n_ref = mc.run_cli(MULTICHIP_CLI)
        counts["draws"] += n_ref
        ref_seconds = time.perf_counter() - t0
        deadline = t0 + MULTICHIP_TIMEOUT_S
        for name, (proc, out) in procs.items():
            try:
                proc.wait(timeout=max(deadline - time.perf_counter(), 1))
            except subprocess.TimeoutExpired:
                with open(os.path.join(out, "stdout.txt")) as f:
                    done = f.read()[-3000:]
                fail(f"multichip {name}: no end within "
                     f"{MULTICHIP_TIMEOUT_S} s; its lines:\n{done}")
        group_seconds = time.perf_counter() - t0
        got = {name: group_lines(name, *procs[name]) for name in procs}
    finally:
        end_groups(procs)

    # NCCL at world size 1: the unsharded command's line bit for bit
    nccl = got["nccl1"]["cli"]
    same = {k: nccl["line"][k] == v for k, v in line_ref.items()
            if k not in _TIMINGS}
    checks = {"nccl1 line bit for bit": all(same.values()),
              "nccl1 accept counts": nccl["accepted"] == acc_ref}
    line("multichip", check="nccl_world_1", card=smi, argv=MULTICHIP_CLI,
         differing=[k for k, ok in same.items() if not ok],
         draws_launches=nccl["draws_launches"], line_sharded=nccl["line"],
         line_unsharded=line_ref)
    counts["draws"] += nccl["draws_launches"]
    # gloo at 2 and 4 ranks on one card: the float64 runs
    for name in ("gloo2", "gloo4"):
        for run, got_run in got[name].items():
            want, x_ref = ref[run]
            x = np.load(os.path.join(procs[name][1], f"{run}_x.npy"))
            x_err = float(np.abs(x - x_ref).max() / np.abs(x_ref).max())
            differ = int(sum(a != b for a, b in zip(got_run["accepted"],
                                                    want["accepted"])))
            gaps = {k: abs(got_run[k] - want[k]) / abs(want[k])
                    for k in ("step_size", "inv_mass_sum", "inv_mass_min")
                    if want[k] is not None}
            line("multichip", check=f"{name}_{run}", card=smi,
                 mesh=got_run["mesh"], backend=got_run["backend"],
                 chains_differing=differ, x_rel_err=x_err, gaps=gaps,
                 seconds=got_run["seconds"],
                 unsharded_seconds=want["seconds"],
                 draws_launches=got_run["draws_launches"],
                 accept_ratio=sum(got_run["accepted"]) / max(
                     got_run["attempted"], 1))
            checks[f"{name} {run} accepts"] = differ == 0
            checks[f"{name} {run} state"] = x_err < MULTICHIP_RTOL
            checks[f"{name} {run} kernel"] = all(
                g < MULTICHIP_RTOL for g in gaps.values())
            checks[f"{name} {run} draws"] = got_run["draws_launches"] > 0
            counts["draws"] += got_run["draws_launches"]
    # the float32 command line under (2, 2)
    cli = got["gloo4_cli"]["cli"]
    differ = int(sum(a != b for a, b in zip(cli["accepted"], acc_ref)))
    gaps = {"accept_ratio": abs(cli["line"]["accept_ratio"]
                                - line_ref["accept_ratio"]),
            **{k: abs(cli["line"][k] - line_ref[k]) / abs(line_ref[k])
               for k in ("RMSD", "RMSM")}}
    line("multichip", check="gloo4_cli_f32", card=smi,
         chains_differing=differ, gaps=gaps, line_sharded=cli["line"],
         draws_launches=cli["draws_launches"])
    counts["draws"] += cli["draws_launches"]
    for k, bound in MULTICHIP_F32.items():
        checks[f"gloo4 cli {k}"] = gaps[k] <= bound
    checks["gloo4 cli keys"] = set(cli["line"]) == set(line_ref)
    seconds = time.perf_counter() - t_phase
    line("multichip", check="phase", seconds=seconds,
         groups_seconds=group_seconds, unsharded_seconds=ref_seconds,
         card=smi, draws_launches=counts["draws"])
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"multichip: {bad}")
    return counts


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from gravinv3dhmc_tpu_torch import (magnetic, ratiogrid, realdata,
                                        samplers, sass, uniformgrid)
    from gravinv3dhmc_tpu_torch.ops import _cuda, philox
    from gravinv3dhmc_tpu_torch.ops import leapfrog as tlf

    tc_kernels = ("residual_partial_tc_kernel", "kick_tc_kernel",
                  "residual_partial_split_kernel",
                  "kick_split_persistent_kernel")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = card()

    t0 = time.perf_counter()
    libs = _cuda.build_all()
    ptxas = {name: [ln.strip() for ln in lib.build_log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, lib in libs.items()}
    _, fns = sass.functions(libs["leapfrog"])
    hgmma = {k: sum(op == "HGMMA" for _, _, op, _, _ in sass.find(fns, k)[0])
             for k in tc_kernels}
    UNITS.update(sass.unit_counts(libs["leapfrog"], libs["prism_gz"]))
    line("build", seconds=time.perf_counter() - t0,
         nvcc_seconds={n: lib.build_seconds for n, lib in libs.items()},
         card=smi, torch=torch.__version__, cuda=torch.version.cuda,
         ptxas=ptxas, hgmma=hgmma, sass_units=UNITS)
    if not all(hgmma.values()):
        fail(f"build: a tensor-core kernel without HGMMA in its SASS: "
             f"{hgmma}")
    # each unit's pipes: Philox's integer work, Box-Muller's and the
    # corner term's logs, square roots and divisions on MUFU (the uniform's
    # Philox may run on the uniform datapath: its chain is the block's)
    need = {"normal4": ("fma", "imad", "alu", "mufu_conv"),
            "node": ("fma", "alu", "mufu_conv")}
    if not all(UNITS[u].get(k, 0) > 0 for u, ks in need.items() for k in ks):
        fail(f"build: a unit of work without its instructions: {UNITS}")

    phase_philox(torch, tlf, philox, dev)

    t0 = time.perf_counter()
    module, dobs = uniformgrid.build_problem(device=dev)
    line("problem", seconds=time.perf_counter() - t0,
         shape=[int(dobs.size), module.n_active])
    op = tlf.make_fused_iteration(
        *fused_args(module, dobs), regularization="MS", beta=0.001,
        Sigma=0.001, matvec_dtype=torch.bfloat16, device=dev)
    kres = phase_kernels(torch, tlf, op, uniformgrid.SLICE["nchains"], dev)
    phase_traj(torch, tlf, module, dobs, dev)
    phase_iter(torch, tlf, philox, module, dobs, dev)
    with PlainPhilox(philox) as plain:
        counts = phase_slice(torch, tlf, module, dobs, dev, smi)
        counts_f32 = phase_slice(torch, tlf, module, dobs, dev, smi,
                                 matvec=torch.float32)
    counts3 = phase_reference(torch, tlf, dev)
    f32_ops = f32_gemm_ops(torch, tlf, module, dobs, dev)
    kres.update(phase_f32_gemms(torch, tlf, f32_ops, smi))
    counts_rd = phase_traj_realdata(torch, tlf, f32_ops["realdata"][0], dev,
                                    smi)
    with plain:
        counts_state = phase_state(torch, tlf, module, dobs, dev, smi)
    del module, op, f32_ops

    gres, counts_gz = phase_gz(torch, tlf, dev, smi)
    kres.update(gres)
    with plain:
        module2, dobs2, counts2 = phase_slice2(torch, tlf, dev, smi)
        counts2_f32 = phase_slice2(torch, tlf, dev, smi,
                                   problem=(module2, dobs2),
                                   matvec=torch.float32)[2]
    line("plain_philox", calls_in_slices=plain.calls)
    if plain.calls:
        fail(f"the slices called the plain Philox {plain.calls} times")
    phase_reference2(torch, tlf, dev)
    # the f32 per-step path's GEMMs at the shape slice2_f32 gives them
    step_f32 = tlf.make_fused_step(
        *fused_args(module2, dobs2, high=0.4), regularization="MS",
        beta=0.001, matvec_dtype=torch.float32, device=dev)
    kres["step_residual_f32"] = phase_f32_gemms(
        torch, tlf, {"ratiogrid": (step_f32, ratiogrid.SLICE["nchains"])},
        smi)["step_residual_f32"]
    del step_f32
    sres = phase_step_kernels(torch, tlf, module2, dobs2, dev)
    for name in ("step_residual", "step_misfit", "draws"):
        kres[name] = sres[name]
    phase_step(torch, tlf, module2, dobs2, dev)
    del module2, dobs2

    with plain:
        _, counts_bench = phase_bench(torch, tlf, dev, smi)
    if plain.calls:
        fail(f"the bench called the plain Philox {plain.calls} times")
    rd, counts_rd_real = phase_realdata_kernels(
        torch, tlf, *realdata.build_problem(device=dev), dev, smi)
    for name in ("residual_f32", "kick_f32"):
        kres[name] = rd[name]
    with plain:
        counts_samplers, M = phase_samplers(torch, tlf, dev, smi)
    if plain.calls:
        fail(f"the samplers called the plain Philox {plain.calls} times")
    phase_samplers_kernel(torch, tlf, dev, M, (
        samplers.SAMPLERS["nchains"], samplers.HMC["nchains"]))

    rd_problem = phase_kernel_cache(torch, dev, smi)
    T = phase_cg(torch, tlf, dev, smi, rd_problem)["map"]["temperature"]
    with plain:
        counts_rd_chees = phase_samplers_realdata(torch, tlf, dev, smi,
                                                  rd_problem, T)
    if plain.calls:
        fail(f"the realdata ChEES called the plain Philox {plain.calls} "
             "times")
    phase_samplers_kernel(torch, tlf, dev, rd_problem[0].n_active,
                          (samplers.REALDATA["nchains"],))
    del rd_problem

    counts_mag = phase_magnetic(torch, tlf, dev, smi)
    with plain:
        counts_wav = phase_wavelet(torch, tlf, dev, smi)
        counts_mag_demo, M_demo = phase_magnetic_demo(torch, tlf, dev, smi)
    if plain.calls:
        fail(f"the wavelet and magnetic samplers called the plain Philox "
             f"{plain.calls} times")
    # the wavelet runs' 64 x 6,000 pad to the samplers' 64 x 6,016
    phase_samplers_kernel(torch, tlf, dev, M_demo,
                          (magnetic.WIDE["chees"]["nchains"],))
    phase_prism_device(torch, dev, smi)

    with plain:
        counts_joint, M_joint = phase_joint(torch, tlf, dev, smi)
        counts_global, M_global, global_problem = phase_global(
            torch, tlf, dev, smi)
        counts_studies, studies_shapes = phase_studies(
            torch, tlf, dev, smi, global_problem)
    del global_problem
    if plain.calls:
        fail(f"the joint and global samplers and the studies called the "
             f"plain Philox {plain.calls} times")
    phase_samplers_kernel(torch, tlf, dev, M_joint, (JOINT["nchains"],))
    phase_samplers_kernel(torch, tlf, dev, M_global,
                          (GLOBAL_HMC["nchains"],))
    for M_s, C_s in studies_shapes:
        phase_samplers_kernel(torch, tlf, dev, M_s, (C_s,))

    counts_run, run_shapes = phase_run(torch, tlf, dev, smi, plain)
    for M_run, C_run in run_shapes:
        phase_samplers_kernel(torch, tlf, dev, M_run, (C_run,))
    counts_prof = phase_profiling(torch, tlf, dev, smi)
    counts_multi = phase_multichip(torch, tlf, philox, dev, smi)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    # the main paths' runs, each counted from 0: both uniformgrid slices,
    # the shared-L card run, the state phase's runs (uninterrupted, cut
    # and resumed, fixed-dt and adaptive, and HMCSample's with files), the
    # realdata-width trajectories (synthetic,
    # then the stage's matrix without and with a metric), the unstructured
    # gz build, both ratiogrid slices, the bench's two stages, the
    # samplers, the realdata ChEES (the deterministic stages launch none),
    # the magnetic uniformgrid stage, the wavelet stages, the magnetic
    # demo's ChEES, the joint HMC, the whole-Earth HMC, the studies (the
    # ladder, the whole-Earth ChEES and the roofline), the command line's
    # subcommands, the profiled uniformgrid chunks and the multi-device
    # runs with their unsharded counterparts (the bench's count holds the
    # live f64 reference run's draws)
    runs = (counts, counts_f32, counts3, counts_state, counts_rd,
            *counts_rd_real, counts_gz, counts2, counts2_f32, counts_bench,
            counts_samplers, counts_rd_chees, counts_mag, counts_wav,
            counts_mag_demo, counts_joint, counts_global, counts_studies,
            counts_run, counts_prof, counts_multi)
    print(smi)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": k.source,
         "replaces": k.replaces,
         "launches": sum(c[name] for c in runs),
         **{key: kres[name][key] for key in keys}}
        for name, k in tlf.KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
