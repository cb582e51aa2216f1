"""Drives the program's fused HMC sampler after its windowed warmup: the
warmup runs in set-up through ``HamiltonianMC.adapt`` (dual-averaged dt
and a diagonal metric from Welford moments), and the window issues the
frozen chunks of the warmed chains through the chunk runner it hands
over, with the frozen dt and inverse mass, as ``HamiltonianMC.sample``
does after its freeze. Then the plain reference follows the stored draws
under the program's frozen kernel.

Traffic keys: those of the :mod:`hmc` driver (``chains``, ``chunk``,
``dt`` and ``sigma`` (the warmup's start), ``L``, ``matrix_dtype``,
``stride``, ``burn_in_chunks`` (frozen chunks after the warmup, before
the window), ``trace_chunks``, ``check_iters``, ``check_spans``,
``check_chains``, ``limits``, ``control``), and ``adapt_chunks`` and
``adapt_target``, the warmup's chunks and target accept rate. The
program runs the fused trajectory op.

The window, its sink, the traced stretch and the ESS are the
:mod:`hmc` driver's; the chunks keep counting from the warmup's (the
first frozen chunk is chunk ``W``, the warmup's length). In a traced run
the program's spans are on for the warmup (``profiling.enable``): the
record gets ``adapt_s`` (the ``hmc.adapt`` span's host wall) and
``adapt_grad_evals`` (the program's counter), where the program has them.

The check (float64, the reference's own tesseroid matrix, weights and
Philox draws, under the program's frozen dt and inverse mass,
:mod:`benchmark.reference.hmc_metric`): ``start_u_gap`` (at the first
state of the window: chain 0 after the burn-in), ``replay_gap_max`` and
``draw_u_gap_median`` as in :mod:`hmc`; logged beside them,
``metric_gap``: the reference's shrunk pooled variance at the ESS cells
from every draw of the warmup's last metric window (the driver asks the
program's chunk runner to store that chunk and copies the cells on the
card, as it copies the window's) against the program's inverse mass
there, the largest relative gap over the cells that moved in the window
(one no chain moved reads the shrinkage's floor on both sides); and
``dt_gap``: the reference's dual averaging over the warmup chunks' mean
accept rates, from the step size each of its windows started at,
against every step size the program chose after it and the frozen one,
the largest relative gap.
"""
from __future__ import annotations

import functools
import math
import time

import numpy as np
import torch

from benchmark import harness
from benchmark.drivers import common
from benchmark.drivers import hmc as base
from benchmark.reference import hmc as ref_hmc
from benchmark.reference import hmc_metric
from benchmark.reference import philox as ref_philox

window = base.window
stretch = base.stretch


def setup(ctx):
    cfg, tr = ctx.config, dict(ctx.traffic)
    if ctx.control and "program" in tr["control"]:
        tr.update(tr["control"]["program"])
    from gravinv3dhmc_tpu_torch import profiling
    from gravinv3dhmc_tpu_torch.inversion import hmc as program
    if not hasattr(program.HamiltonianMC, "adapt"):
        raise RuntimeError("the program has no entry that hands over its "
                           "warmed chains and frozen kernel "
                           "(HamiltonianMC.adapt); this cell needs it")
    ctx.mark("imports")
    torch.zeros(1, device=ctx.device)
    ctx.mark("cuda_init")
    problem = ctx.problem()
    inputs = problem.make_inputs(cfg, ctx.seed, ctx.device)
    ctx.mark("inputs")
    common.load_extensions(ctx)
    ctx.mark("extension_load")
    t0 = time.perf_counter()
    module = problem.build_module(cfg, inputs, ctx.device)
    ctx.sync()
    ctx.record["build_s"] = time.perf_counter() - t0
    ctx.mark("build")

    s = base.State()
    s.tr, s.problem, s.inputs, s.module = tr, problem, inputs, module
    s.C, s.chunk, s.stride = tr["chains"], tr["chunk"], tr["stride"]
    if s.chunk % s.stride or tr["check_iters"] % s.stride \
            or not 0 < tr["check_iters"] < s.chunk \
            or tr["burn_in_chunks"] < 2:
        raise ValueError("the stride has to divide the chunk and the "
                         "check's iterations, which lie under the chunk, "
                         "and the burn-in needs two chunks")
    s.per = s.chunk // s.stride
    s.span_slots = tr["check_iters"] // s.stride
    s.M = int(module.n_active)
    dev = ctx.device
    s.cells = torch.as_tensor(np.random.RandomState(0).choice(
        s.M, size=min(s.M, base.ESS_CELLS), replace=False), device=dev)
    rng = np.random.default_rng([ctx.seed, 2])
    s.check_chains = torch.as_tensor(np.sort(rng.choice(
        s.C, size=min(tr["check_chains"], s.C), replace=False)), device=dev)
    slots = np.random.default_rng([ctx.seed, 3])
    places = []

    def check_slot(k):
        while len(places) <= k:
            places.append(int(slots.integers(0, s.per - s.span_slots)))
        return places[k]
    s.check_slot = check_slot

    # the warmup's last metric window: its chunks' draws are kept
    W, w1, switches = program.warmup_schedule(tr["adapt_chunks"], True,
                                              True)
    s.switches = switches
    s.metric_chunks = range(switches[-2] if len(switches) > 1 else w1,
                            switches[-1])
    s.warm_draws = torch.empty((len(s.metric_chunks), s.C, s.per,
                                len(s.cells)), dtype=torch.float32,
                               device=dev)
    s.warm_dt, s.warm_acc = [], []

    w = np.asarray(module.wdiag, np.float64)
    lo, hi = cfg["box"]
    chain = _watched(program.HamiltonianMC, s)(module)
    chain.device = dev
    chain.dt, chain.Lrange, chain.Sigma = tr["dt"], list(tr["L"]), \
        tr["sigma"]
    chain.regularization, chain.beta = cfg["regularization"], cfg["beta"]
    chain.RegulFactor = cfg["alpha"]
    chain.nchains, chain.chunk_size = s.C, s.chunk
    chain.seed = ctx.seed
    chain.verbose = False
    chain.use_fused = True
    chain.prefer_iteration_kernel = False
    chain.shared_L = True
    chain.adapt_step_size = chain.adapt_mass = True
    chain.adapt_chunks, chain.adapt_target = (tr["adapt_chunks"],
                                              tr["adapt_target"])
    chain.store_mode, chain.store_thin = "chain", s.stride
    chain.fused_matvec_dtype = getattr(torch, tr["matrix_dtype"])
    chain.low, chain.high = w * lo, w * hi
    chain.initial_model = w * cfg["initial"]
    chain.aprior_model = w * cfg["aprior"]
    chain.dobs = np.asarray(inputs["dobs"], np.float64)
    if ctx.trace:
        profiling.enable(True)
    frozen = chain.adapt(s.per, 0)
    ctx.sync()
    if ctx.trace:
        _record_warmup(ctx.record, profiling)
        profiling.enable(None)
    ctx.mark("adapt")
    s.fused_mode = chain._fused_mode
    s.W, s.dt, s.inv_mass = frozen.n_chunks, frozen.dt, frozen.inv_mass
    s.run_chunk = functools.partial(s.program_run_chunk, dt=frozen.dt,
                                    inv_mass=frozen.inv_mass, store_base=0)
    s.carry = frozen.carry
    del frozen, chain
    # the frozen burn-in does the window's work, copies included, into
    # one chunk's buffers; its chunks after the first give the rate that
    # sizes the window's
    s.B = s.W + tr["burn_in_chunks"]
    s.sink = base.Sink(s, 1, True, dev)
    base._chunks(ctx, s, s.W, 1)
    ctx.sync()
    t0 = time.perf_counter()
    base._chunks(ctx, s, s.W + 1, tr["burn_in_chunks"] - 1)
    ctx.sync()
    per_chunk = (time.perf_counter() - t0) / (tr["burn_in_chunks"] - 1)
    n = math.ceil(base.HEADROOM * ctx.seconds / per_chunk) + 1
    s.sink = None
    s.sink = base.Sink(s, n, False, dev)
    # the window's first state: chain 0 of the warmed, burnt-in carry
    s.u0 = float(s.carry[1][0])
    s.x0_m = (s.carry[0][0].double() * torch.as_tensor(
        module.wdiag_inv, dtype=torch.float64, device=dev)).clone()
    ctx.mark("burn_in")
    harness.log(f"[setup] path {s.fused_mode}, {s.C} chains x {s.M} "
                f"cells, warmup of {s.W} chunks: frozen dt {s.dt:.6g}, "
                f"{per_chunk:.4f} s a burn-in chunk, buffers for {n} "
                f"chunks of {s.per} draws")
    return s


def _watched(cls, s):
    """``cls`` whose chunk runner, as :meth:`prepare` hands it to the
    warmup, also records each warmup chunk's dt and accepts (summed on the
    card) and stores the draws of the last metric window's chunks, whose
    ESS cells it copies on the card into ``s.warm_draws``. The runner
    itself goes to ``s.program_run_chunk`` for the frozen chunks."""

    class Watched(cls):
        def prepare(self, nsamples, ndraws, draws=None):
            run_chunk, carry = super().prepare(nsamples, ndraws, draws)
            s.program_run_chunk = run_chunk

            def watched(carry, seed, k, **kw):
                keep = k in s.metric_chunks
                if keep:
                    kw["store_base"] = 0
                carry, stats = run_chunk(carry, seed, k, **kw)
                s.warm_dt.append(float(kw["dt"]))
                s.warm_acc.append(stats[..., 0].sum(dtype=torch.float64))
                if keep:
                    torch.index_select(carry[6], 2, s.cells,
                                       out=s.warm_draws[k -
                                                        s.metric_chunks[0]])
                return carry, stats
            return watched, carry
    return Watched


def _record_warmup(rec, profiling):
    """The warmup's span and counter, where the program has them."""
    adapt = [sp for sp in profiling.spans()
             if sp.name == "hmc.adapt" and sp.end_ns is not None]
    if adapt:
        rec["adapt_s"] = (adapt[-1].end_ns - adapt[-1].start_ns) * 1e-9
    ge = profiling.counters().get("adapt_grad_evals")
    if ge:
        rec["adapt_grad_evals"] = float(ge)


def _warm_checks(s, w_cells, inv_mass_cells, accepts):
    """``metric_gap`` and ``dt_gap`` (see the module docstring)."""
    tr = s.tr
    draws = s.warm_draws.permute(1, 0, 2, 3).reshape(
        s.C, -1, s.warm_draws.shape[-1]).double() * w_cells
    ref_var = hmc_metric.pooled_variance(draws)
    gap = (inv_mass_cells - ref_var).abs() / ref_var
    # a cell that no chain moved in the window (held at a wall, or every
    # proposal rejected) reads the shrinkage's floor on both sides: its
    # gap is the floor's float32 rounding, so the cells that moved are
    # compared
    moved = (draws != draws[:, :1]).any(dim=1).any(dim=0)
    harness.log(f"[check] metric window: {int(moved.sum())} of "
                f"{moved.numel()} ESS cells moved; gap at the others "
                f"{float(gap[~moved].max()) if (~moved).any() else 0.0:.3g}")
    metric_gap = float(gap[moved].max() if moved.any() else gap.max())
    rates = [a / (s.chunk * s.C) for a in accepts]
    harness.log("[check] warmup chunks' dt and mean accept: " + ", ".join(
        f"{dt:.4g} {r:.3f}" for dt, r in zip(s.warm_dt, rates))
        + f"; frozen dt {s.dt:.6g}, inverse mass "
        f"{float(inv_mass_cells.min()):.4g}-{float(inv_mass_cells.max()):.4g}"
        " at the ESS cells")
    switches = s.switches
    starts = [0] + list(switches)
    gaps = []
    for a, b in zip(starts, starts[1:] + [s.W]):
        if a >= b:
            continue
        seq = hmc_metric.dual_averaging(s.warm_dt[a], rates[a:b],
                                        tr["adapt_target"])
        for k in range(a, b):
            log_eps, log_avg = seq[k - a]
            if k + 1 < b:
                want, got = math.exp(log_eps), s.warm_dt[k + 1]
            elif b == s.W:
                want, got = math.exp(log_avg), s.dt
            elif b != switches[0]:
                # a later switch re-starts at the current step size
                want, got = math.exp(log_eps), s.warm_dt[b]
            else:
                continue  # the first switch re-seeds it from the metric
            gaps.append(abs(got - want) / want)
    return metric_gap, max(gaps)


def check(ctx, s):
    cfg, tr, dev = ctx.config, s.tr, ctx.device
    sink, k = s.window_sink, s.k_window
    rng = np.random.default_rng([ctx.seed, 4])
    picked = np.sort(rng.choice(k, size=min(tr["check_spans"], k),
                                replace=False))
    m_start = sink.m[picked, 0].double()
    m_end = sink.m[picked, 1].double()
    u_end = sink.u[picked].double()
    chains = s.check_chains.cpu().numpy()
    first_it = [(s.B + int(c)) * s.chunk + sink.at[int(c)] * s.stride
                for c in picked]
    inv_mass = s.inv_mass.double().clone()
    accepts = torch.stack(s.warm_acc).tolist()
    # everything of the program is let go before the ESS and the
    # reference run
    s.carry = s.run_chunk = s.program_run_chunk = s.module = None
    s.sink = s.inv_mass = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    base._record_ess(ctx, s)
    s.window_sink = sink = None
    Aw, w = s.problem.reference_matrix(cfg, s.inputs, dev)
    pot = ref_hmc.Potential(
        Aw, torch.as_tensor(s.inputs["dobs"], device=dev),
        cfg["aprior"] * w, w * w, cfg["alpha"], cfg["beta"],
        cfg["regularization"], "float64")
    lo, hi = (v * w for v in cfg["box"])
    U0 = pot(s.x0_m[None].to(dev) * w)[0]
    out = {"start_u_gap": abs(s.u0 - float(U0[0])) / abs(float(U0[0]))}
    R = len(chains)
    m_start = m_start.reshape(-1, s.M)
    m_end = m_end.reshape(-1, s.M)
    cc = np.tile(chains, len(picked))
    it0 = np.repeat(first_it, R)
    x = m_start.to(dev) * w
    U, g, _, _ = pot(x)
    x_begin = x.clone()
    eps = float(np.float32(s.dt))
    width = -(-s.M // 4) * 4
    lcache = {}
    for t in range(1, tr["check_iters"] + 1):
        its = it0 + t
        Ls = []
        for it in its.tolist():
            ci = it // s.chunk
            if ci not in lcache:
                lcache[ci] = ref_philox.lengths(ctx.seed, ci, s.chunk,
                                                *tr["L"])
            Ls.append(int(lcache[ci][it % s.chunk]))
        n01 = ref_philox.normals(ctx.seed, cc, its, width, dev)[:, :s.M]
        u = ref_philox.uniforms(ctx.seed, cc, its, dev)
        x, U, g, _, _ = hmc_metric.iterate(
            pot, x, U, g, n01, u, torch.as_tensor(Ls, device=dev), eps,
            inv_mass, lo, hi)
    x_prog = m_end.to(dev) * w
    dist = (x - x_begin).norm(dim=1).clamp_min(1e-300)
    gap = ((x_prog - x).norm(dim=1) / dist).cpu().numpy()
    per_chain = np.median(gap.reshape(len(picked), R), axis=0)
    out["replay_gap_max"] = float(per_chain.max())
    harness.log(f"[check] per-chain replay gaps: median "
                f"{np.median(per_chain):.6g}, 90th percentile "
                f"{np.percentile(per_chain, 90):.6g}, max "
                f"{per_chain.max():.6g}; {len(picked)} spans of {R} chains")
    U_ref = pot(x_prog)[0]
    ug = ((u_end.reshape(-1).to(dev) - U_ref).abs()
          / U_ref.abs()).cpu().numpy()
    out["draw_u_gap_median"] = float(np.median(ug))
    out["metric_gap"], out["dt_gap"] = _warm_checks(
        s, w[s.cells], inv_mass[s.cells], accepts)
    return common.compared(out, tr["limits"])
