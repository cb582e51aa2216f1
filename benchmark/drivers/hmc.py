"""Drives the program's fused HMC sampler (``HamiltonianMC``'s chunk
runner: one L an iteration shared by all chains, the fused iteration
kernels) through the window, then follows its stored draws with the
plain reference.

Traffic keys: ``chains``, ``chunk`` (iterations a chunk), ``dt``, ``L``
([Lmin, Lmax]), ``sigma``, ``matrix_dtype`` (the fused kernels' matrix
type), ``stride`` (the program stores every stride-th state; it divides
``chunk``), ``burn_in_chunks``, ``trace_chunks``, ``check_iters`` (the
iterations the reference replays a span; a multiple of ``stride`` under
``chunk``), ``check_spans`` and ``check_chains`` (how many spans and
chains the reference follows), ``limits`` and ``control``.

Every chunk, from the first of the burn-in, stores its draws in the
program's buffer (one chunk's slots, written again each chunk), and the
harness copies from it on the card, queued behind the chunk: the ESS
cells' values of every draw, and two draws ``check_iters`` apart of the
check's chains, at a place in the chunk drawn from the seed. The
window's copies go to buffers sized, after the burn-in, for twice the
chunks a second the burn-in ran; a window that outruns them fails the
run. The window issues chunks back to back, with their counters summed
on the card, until the host's clock passes the window's seconds, then
waits for the card: the rates are all the work of all the chunks over
all that time. ``ess`` is the median over :data:`ESS_CELLS` cells of the
multi-chain ESS of every draw the window stored.

The check (all in float64 with the reference's own matrix, weights and
Philox draws); the numbers the traffic's ``limits`` name are compared,
the others are logged:

* ``start_u_gap``: the program's potential at the start against the
  reference's, relative;
* ``replay_gap_max``: for ``check_chains`` chains (drawn from the seed)
  in ``check_spans`` window chunks (drawn from the seed), the reference
  runs the ``check_iters`` iterations from the first copied draw, and a
  span's gap is the distance of the program's second draw from the
  reference's end over the distance the reference's chain moved; a
  chain's gap is the median of its spans' (1 for a chain whose state
  never changed), and the number is the largest over the chains;
* ``draw_u_gap_median``: the potential the program stored with each
  compared second draw against the reference's at that draw, relative;
  median.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark import harness, roofline
from benchmark.reference import ess as ref_ess
from benchmark.reference import hmc as ref_hmc
from benchmark.reference import philox as ref_philox
from benchmark.drivers import common

#: how many cells the ESS is taken over (the port's ``RandomState(0)``
#: sample), and how many of them one pass of the estimator holds
ESS_CELLS = 128
ESS_BLOCK = 4
#: the window's buffers hold this many times the burn-in's chunk rate
HEADROOM = 2.0


class State:
    pass


class Sink:
    """The harness's copies of ``n`` chunks' draws: ``ess`` (n, C, per,
    K) the ESS cells of every stored draw, ``m`` (n, 2, R, M) two draws
    of each check chain, ``u`` (n, R) the potential stored with the
    second. ``put(k, ...)`` copies chunk ``k``'s from the program's
    buffers, on the card; with ``wrap`` a chunk past ``n`` reuses a
    slot, otherwise it raises."""

    def __init__(self, s, n, wrap, device):
        self.n, self.wrap = n, wrap
        C, M, K = s.C, s.M, len(s.cells)
        self.ess = torch.empty((n, C, s.per, K), dtype=torch.float32,
                               device=device)
        R = len(s.check_chains)
        self.m = torch.empty((n, 2, R, M), dtype=torch.float32,
                             device=device)
        self.u = torch.empty((n, R), dtype=torch.float32, device=device)
        self.at = [0] * n

    def put(self, s, k, carry):
        if k >= self.n and not self.wrap:
            raise RuntimeError(
                f"the window ran past the {self.n} chunks its draw buffers "
                "hold (twice the burn-in's rate): a chunk would go "
                "unstored")
        i = k % self.n
        buf_m, buf_k = carry[6], carry[7]
        j = s.check_slot(k)
        jn = j + s.span_slots
        torch.index_select(buf_m, 2, s.cells, out=self.ess[i])
        torch.index_select(buf_m[:, j], 0, s.check_chains, out=self.m[i, 0])
        torch.index_select(buf_m[:, jn], 0, s.check_chains,
                           out=self.m[i, 1])
        torch.index_select(buf_k[:, jn, 0], 0, s.check_chains,
                           out=self.u[i])
        self.at[i] = j


def setup(ctx):
    cfg, tr = ctx.config, dict(ctx.traffic)
    if ctx.control and "program" in tr["control"]:
        tr.update(tr["control"]["program"])
    import gravinv3dhmc_tpu_torch  # noqa: F401
    from gravinv3dhmc_tpu_torch.inversion.hmc import HamiltonianMC
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

    s = State()
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
    s.B = tr["burn_in_chunks"]
    dev = ctx.device
    s.cells = torch.as_tensor(np.random.RandomState(0).choice(
        s.M, size=min(s.M, ESS_CELLS), replace=False), device=dev)
    rng = np.random.default_rng([ctx.seed, 2])
    s.check_chains = torch.as_tensor(np.sort(rng.choice(
        s.C, size=min(tr["check_chains"], s.C), replace=False)), device=dev)
    # the place of each chunk's check span, drawn from the seed on the host
    slots = np.random.default_rng([ctx.seed, 3])
    places = []

    def check_slot(k):
        while len(places) <= k:
            places.append(int(slots.integers(0, s.per - s.span_slots)))
        return places[k]
    s.check_slot = check_slot

    # the box, start and a priori model in the weighted domain
    w = np.asarray(module.wdiag, np.float64)
    lo, hi = cfg["box"]
    chain = HamiltonianMC(module)
    chain.device = dev
    chain.dt, chain.Lrange, chain.Sigma = tr["dt"], list(tr["L"]), \
        tr["sigma"]
    chain.regularization, chain.beta = cfg["regularization"], cfg["beta"]
    chain.RegulFactor = cfg["alpha"]
    chain.nchains, chain.chunk_size = s.C, s.chunk
    chain.seed = ctx.seed
    chain.verbose = False
    chain.use_fused = True
    chain.shared_L = True
    chain.store_mode, chain.store_thin = "chain", s.stride
    chain.fused_matvec_dtype = getattr(torch, tr["matrix_dtype"])
    chain.low, chain.high = w * lo, w * hi
    chain.initial_model = w * cfg["initial"]
    chain.aprior_model = w * cfg["aprior"]
    chain.dobs = np.asarray(inputs["dobs"], np.float64)
    s.run_chunk, s.carry = chain.prepare(s.per, 0)
    s.fused_mode = chain._fused_mode
    s.u0 = float(s.carry[1][0])
    s.x0_m = (s.carry[0][0].double() * torch.as_tensor(
        module.wdiag_inv, dtype=torch.float64, device=dev)).clone()
    if ctx.control and "reference" in tr["control"]:
        _reference_in_place(ctx, s, tr["control"]["reference"])
    ctx.mark("start")
    # the burn-in does the window's work, copies included, into one
    # chunk's buffers; its chunks after the first give the rate that
    # sizes the window's
    s.sink = Sink(s, 1, True, dev)
    _chunks(ctx, s, 0, 1)
    ctx.sync()
    t0 = time.perf_counter()
    _chunks(ctx, s, 1, s.B - 1)
    ctx.sync()
    per_chunk = (time.perf_counter() - t0) / (s.B - 1)
    n = math.ceil(HEADROOM * ctx.seconds / per_chunk) + 1
    s.sink = None  # the scratch goes before the window's buffers come
    s.sink = Sink(s, n, False, dev)
    ctx.mark("burn_in")
    harness.log(f"[setup] path {s.fused_mode}, {s.C} chains x {s.M} "
                f"cells, {per_chunk:.4f} s a burn-in chunk, buffers for "
                f"{n} chunks of {s.per} draws")
    return s


def _reference_in_place(ctx, s, precision):
    """The control: the plain reference in ``precision``, with its own
    matrix and weights, in place of the program's chunk runner and carry
    (same layout, same draws, same storage)."""
    cfg, tr, dev = ctx.config, s.tr, ctx.device
    s.carry = s.run_chunk = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    Aw, w = s.problem.reference_matrix(cfg, s.inputs, dev)
    pot = ref_hmc.Potential(
        Aw, torch.as_tensor(s.inputs["dobs"], device=dev),
        cfg["aprior"] * w, w * w, cfg["alpha"], cfg["beta"],
        cfg["regularization"], precision)
    winv = (1.0 / w).to(pot.dtype)
    lo, hi = (v * w.to(pot.dtype) for v in cfg["box"])
    eps = float(np.float32(tr["dt"]))
    sigma = float(np.float32(tr["sigma"]))
    x0 = (s.x0_m.to(dev) * w).to(pot.dtype).expand(s.C, s.M).contiguous()
    U, g, _, _ = pot(x0)
    buf_m = torch.zeros((s.C, s.per, s.M), dtype=torch.float32, device=dev)
    buf_k = torch.zeros((s.C, s.per, 7), dtype=torch.float32, device=dev)
    chains = torch.arange(s.C, device=dev)
    width = -(-s.M // 4) * 4

    def run_chunk(carry, seed, chunk_idx):
        x, U, g = carry[:3]
        buf_m, buf_k = carry[6:]
        Ls = ref_philox.lengths(seed, chunk_idx, s.chunk, *tr["L"])
        stats = []
        for i in range(s.chunk):
            it = chunk_idx * s.chunk + i
            its = torch.full((s.C,), it, device=dev)
            L = Ls[i].expand(s.C).to(dev)
            n01 = ref_philox.normals(seed, chains, its, width, dev)[:, :s.M]
            u = ref_philox.uniforms(seed, chains, its, dev)
            x, U, g, acc, _ = ref_hmc.iterate(pot, x, U, g, n01, u, L,
                                              eps, sigma, lo, hi)
            if i % s.stride == 0:
                buf_m[:, i // s.stride] = (x * winv).float()
                buf_k[:, i // s.stride, 0] = U.float()
            stats.append(torch.stack([acc.float(), U.float(), U.float(),
                                      U.float(), L.float()], dim=-1))
        return (x, U, g, None, None, None, buf_m, buf_k), torch.stack(stats)

    s.run_chunk = run_chunk
    s.carry = (x0, U, g, None, None, None, buf_m, buf_k)
    s.fused_mode = f"reference({precision})"
    s.u0 = float(U[0])


def _chunks(ctx, s, first, n_or_until):
    """Issue chunks from ``first``, each copied into ``s.sink`` at its
    place among them: ``n_or_until`` chunks (an int), or until the host
    clock passes it (a float deadline). Returns the chunks issued and the
    card's sums (useful grad evals, batch steps, accepts) as tensors."""
    dev = ctx.device
    ge = torch.zeros((), dtype=torch.float64, device=dev)
    bs = torch.zeros((), dtype=torch.float64, device=dev)
    ac = torch.zeros((), dtype=torch.float64, device=dev)
    k = 0
    while True:
        with harness.span("chunk_issue"):
            s.carry, st = s.run_chunk(s.carry, ctx.seed, first + k)
            s.sink.put(s, k, s.carry)
        with harness.span("stats_sum"):
            L = st[..., 4].to(torch.float64)
            ge += L.sum()
            bs += L.max(dim=1).values.sum()
            ac += st[..., 0].sum(dtype=torch.float64)
        k += 1
        if isinstance(n_or_until, int):
            if k >= n_or_until:
                break
        elif time.perf_counter() >= n_or_until:
            break
    return k, ge, bs, ac


def window(ctx, s, seconds):
    ctx.sync()
    t0 = time.perf_counter()
    k, ge, bs, ac = _chunks(ctx, s, s.B, t0 + seconds)
    ctx.sync()
    window_s = time.perf_counter() - t0
    ge, bs, ac = torch.stack([ge, bs, ac]).tolist()
    s.k_window = k
    s.window_sink = s.sink
    iters = k * s.chunk
    rec = ctx.record
    D = len(s.inputs["dobs"])
    nbytes, flops = roofline.hmc_step(s.C, D, s.M, s.tr["matrix_dtype"])
    rec.update(path="hmc", window_s=window_s, work=ge, units=ge / s.C,
               batch_steps=bs, least_s=roofline.least_s(nbytes, flops),
               accepts=ac, proposals=float(s.C * iters),
               attempted=s.C * iters, draws=k * s.per)
    rec["failed"] = int((~torch.isfinite(s.carry[1])).sum())
    harness.log(f"[window] {k} chunks, {iters} iterations, "
                f"{k * s.per} draws stored, {window_s:.4f} s; "
                f"accept {ac / max(s.C * iters, 1):.6f}")


def stretch(ctx, s):
    """The traced stretch: ``trace_chunks`` chunks after the window, with
    the window's work, copied into one chunk's buffers."""
    s.sink = Sink(s, 1, True, ctx.device)
    first = s.B + s.k_window
    _, ge, bs, _ = _chunks(ctx, s, first, s.tr["trace_chunks"])
    ge, bs = torch.stack([ge, bs]).tolist()
    return ge / s.C, bs


def _ess(sink, lo, hi, thin=1):
    """(K,) multi-chain ESS of every ``thin``-th draw of chunks ``lo`` to
    ``hi`` in ``sink``, a block of cells at a time."""
    out = []
    for b in range(0, sink.ess.shape[-1], ESS_BLOCK):
        d = sink.ess[lo:hi, ..., b:b + ESS_BLOCK]
        d = d.permute(1, 0, 2, 3).reshape(d.shape[1], -1, d.shape[-1])
        out.append(ref_ess.ess(d[:, ::thin].double()))
    return ref_ess.median(torch.cat(out))


def _record_ess(ctx, s):
    """The window's ESS, with the ESS per draw a chain logged at thinnings
    of the stored draws and in each half of the window."""
    sink, k, C, per = s.window_sink, s.k_window, s.C, s.per
    ctx.record["ess"] = _ess(sink, 0, k)
    n = k * per
    per_draw = [f"{thin * s.stride}: "
                f"{_ess(sink, 0, k, thin) / (C * -(-n // thin)):.4g}"
                for thin in (1, 2, 4, 8, 16, 32) if n // thin >= 4]
    harness.log(f"[window] ESS per draw a chain, by iterations between "
                f"draws: {', '.join(per_draw)}")
    h = k // 2
    if h * per >= 4:
        e1, e2 = (_ess(sink, a, a + h) / (C * h * per) for a in (0, h))
        harness.log(f"[window] ESS per draw a chain, first half {e1:.6g}, "
                    f"second half {e2:.6g} ({h * per} draws each)")


def check(ctx, s):
    cfg, tr, dev = ctx.config, s.tr, ctx.device
    sink, k = s.window_sink, s.k_window
    rng = np.random.default_rng([ctx.seed, 4])
    picked = np.sort(rng.choice(k, size=min(tr["check_spans"], k),
                                replace=False))
    m_start = sink.m[picked, 0].double()
    m_end = sink.m[picked, 1].double()
    u_end = sink.u[picked].double()
    u0, x0_m = s.u0, s.x0_m
    chains = s.check_chains.cpu().numpy()
    first_it = [(s.B + int(c)) * s.chunk + sink.at[int(c)] * s.stride
                for c in picked]
    # everything of the program is let go before the ESS and the
    # reference run
    s.carry = s.run_chunk = s.module = s.sink = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    _record_ess(ctx, s)
    s.window_sink = sink = None
    Aw, w = s.problem.reference_matrix(cfg, s.inputs, dev)
    pot = ref_hmc.Potential(
        Aw, torch.as_tensor(s.inputs["dobs"], device=dev),
        cfg["aprior"] * w, w * w, cfg["alpha"], cfg["beta"],
        cfg["regularization"], "float64")
    lo, hi = (v * w for v in cfg["box"])
    U0 = pot(x0_m[None].to(dev) * w)[0]
    out = {"start_u_gap": abs(u0 - float(U0[0])) / abs(float(U0[0]))}
    R = len(chains)
    m_start = m_start.reshape(-1, s.M)
    m_end = m_end.reshape(-1, s.M)
    cc = np.tile(chains, len(picked))
    it0 = np.repeat(first_it, R)
    x = m_start.to(dev) * w
    U, g, _, _ = pot(x)
    x_begin = x.clone()
    eps = float(np.float32(tr["dt"]))
    sigma = float(np.float32(tr["sigma"]))
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
        x, U, g, _, _ = ref_hmc.iterate(
            pot, x, U, g, n01, u, torch.as_tensor(Ls, device=dev), eps,
            sigma, lo, hi)
    x_prog = m_end.to(dev) * w
    dist = (x - x_begin).norm(dim=1).clamp_min(1e-300)
    # a span the program never moved reads 1 (as far as the chain would
    # have gone); a chain's gap is the median over its spans
    gap = ((x_prog - x).norm(dim=1) / dist).cpu().numpy()
    gap = gap.reshape(len(picked), R)
    per_chain = np.median(gap, axis=0)
    out["replay_gap_max"] = float(per_chain.max())
    harness.log(f"[check] per-chain replay gaps: median "
                f"{np.median(per_chain):.6g}, 90th percentile "
                f"{np.percentile(per_chain, 90):.6g}, max "
                f"{per_chain.max():.6g}; {len(picked)} spans of {R} chains")
    U_ref = pot(x_prog)[0]
    ug = ((u_end.reshape(-1).to(dev) - U_ref).abs()
          / U_ref.abs()).cpu().numpy()
    out["draw_u_gap_median"] = float(np.median(ug))
    return common.compared(out, tr["limits"])
