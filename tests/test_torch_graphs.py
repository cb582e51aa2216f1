"""The fused sampler's CUDA graphs: a replayed chunk equals the same chunk
issued launch by launch, bit for bit.

``make_chunk_sampler`` replays whole iterations captured as CUDA graphs
(``inversion/graphs.py``) on a chunk whose inputs match the previous
chunk's, and issues every iteration directly otherwise. Two samplers
from one configuration run the same chunks: one as a caller runs it (its
chunks 1 on replay graphs), one given fresh sample buffers every chunk,
which never replays. Carry, accept counts, sample buffers and stats must
be equal bit for bit, and the carry equal to the fused op's ``iterate``
called in a loop with the chunk's trajectory lengths and Philox keys.

On the CPU the graphs are stood in for by running the captured
iteration's Python again at each "replay" (:class:`EagerGraphs`), so the
card-side counter (key, row, slot), the two carry sets and the store of
the replayed path run through the kernels' plain versions. The tests
marked ``chip`` run the real graphs on the card and skip without one;
this file imports no JAX, so that they run there: ``python -m pytest
--noconftest -p no:cacheprovider tests/test_torch_graphs.py``.
"""
from types import SimpleNamespace

import pytest
import torch

from gravinv3dhmc_tpu_torch import profiling, uniformgrid
from gravinv3dhmc_tpu_torch.inversion import graphs as tgraphs
from gravinv3dhmc_tpu_torch.inversion import hmc as thmc
from gravinv3dhmc_tpu_torch.ops import philox

torch.set_num_threads(2)

#: 7 x 9 observations over 7 x 9 x 4 prisms: 252 cells, lane-padded to 256
NX, NY, NZ = 7, 9, 4
CHUNK, LRANGE, SEED, DT = 8, (3, 8), 2 ** 31 + 77, 0.01
#: (store mode, store_thin, nsamples, ndraws): chain mode stores its
#: draws across chunks 0-2 and none in chunk 3
STORES = {"chain1": ("chain", 1, 16, 4), "chain2": ("chain", 2, 10, 4),
          "accepted": ("accepted", 1, 12, 3)}


class EagerGraphs(tgraphs.IterationGraphs):
    """The graphs on any device: a "capture" keeps the iteration's Python
    and each "replay" runs it again, with the same buffers and the
    counter read where the kernels read it."""

    @staticmethod
    def runs_on(device):
        return True

    def _capture(self, body):
        profiling.count("graph_captures")
        return SimpleNamespace(replay=body), []


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _chain(device, chains, matvec, op, store):
    module, dobs = uniformgrid.build_problem(NX, NY, NZ, device=device)
    chain = uniformgrid.sampler(module, dobs, device, chains, CHUNK, DT,
                                LRANGE, 0.001, 0.001, matvec, seed=SEED)
    chain.prefer_iteration_kernel = op == "iteration"
    chain.store_mode, chain.store_thin = STORES[store][:2]
    return chain


def _chunks(chain, store, n, fresh_buffers):
    """``n`` chunks of a new sampler from ``chain``: a copy of the carry
    and the stats after each. ``fresh_buffers`` gives every chunk new
    sample buffers (with the old contents), so it never replays."""
    run, carry = chain.prepare(*STORES[store][2:])
    out = []
    for k in range(n):
        if fresh_buffers:
            carry = carry[:6] + (carry[6].clone(), carry[7].clone())
        carry, stats = run(carry, SEED, k, store_base=k * CHUNK)
        out.append(([t.clone() for t in carry], stats.clone()))
    return out


def _iterate_loop(chain, store, device, n):
    """x, U, g, ud, um and the accept counts after each of ``n`` chunks of
    the fused op's ``iterate`` called directly, one iteration at a time
    (the sampler's lengths and Philox keys, unpadded state)."""
    traj, it = chain._build_fused(device)
    op = it or traj
    sigma = None if it is not None else float(
        torch.tensor(chain.Sigma, dtype=torch.float32))
    run, carry = chain.prepare(*STORES[store][2:])
    x, U, g, ud, um, nacc = carry[:6]
    salt = philox.salt_from_seed(SEED)
    out = []
    for k in range(n):
        Ls = thmc._chunk_lengths(SEED, k, CHUNK, *LRANGE)
        for i, L in enumerate(Ls):
            x, U, g, ud, um, acc = op.iterate(
                x, U, g, ud, um, (salt, k * CHUNK + i), L, DT, 1.0,
                Sigma=sigma)
            nacc = nacc + (acc > 0.5).to(nacc.dtype)
        out.append([t.clone() for t in (x, U, g, ud, um, nacc)])
    return out


def _same_chunks(make_chain, store, device):
    """Chunks 0-3 with replays against the same chunks issued directly
    and against the op's own loop; the counters of the replayed run."""
    chain = make_chain()
    profiling.reset()
    replayed = _chunks(chain, store, 4, fresh_buffers=False)
    counts = profiling.counters()
    direct = _chunks(make_chain(), store, 4, fresh_buffers=True)
    loop = _iterate_loop(make_chain(), store, device, 4)
    for k in range(4):
        (ca, sa), (cb, sb) = replayed[k], direct[k]
        for name, a, b in zip(("x", "U", "g", "ud", "um", "nacc", "buf_m",
                               "buf_k"), ca, cb):
            assert a.shape == b.shape, (k, name)
            assert torch.equal(a, b), (k, name)
        assert torch.equal(sa, sb), (k, "stats")
        for name, a, b in zip(("x", "U", "g", "ud", "um", "nacc"), ca,
                              loop[k]):
            assert torch.equal(a, b), (k, name, "loop")
    assert counts["direct_iterations"] == CHUNK
    assert counts["graph_replays"] == 3 * CHUNK
    assert 1 <= counts["graph_captures"] <= 3 * CHUNK
    # the chain-mode buffers were written across the chunks
    assert replayed[-1][0][7][..., 0].abs().sum() > 0
    return counts


def _new_dt_drops_the_graphs(chain, store):
    """A chunk with another dt drops the graphs and runs directly; the
    chunk after it, with that dt again, captures afresh and replays."""
    run, carry = chain.prepare(*STORES[store][2:])
    profiling.reset()
    seen = [dict.fromkeys(("direct_iterations", "graph_replays",
                           "graph_captures"), 0)]
    for k, dt in enumerate((DT, DT, 0.5 * DT, 0.5 * DT)):
        carry, _ = run(carry, SEED, k, dt=dt, store_base=k * CHUNK)
        seen.append(profiling.counters())

    def per_chunk(name):
        return [b[name] - a[name] for a, b in zip(seen, seen[1:])]

    assert per_chunk("direct_iterations") == [CHUNK, 0, CHUNK, 0]
    assert per_chunk("graph_replays") == [0, CHUNK, 0, CHUNK]
    captures = per_chunk("graph_captures")
    assert captures[0] == captures[2] == 0
    assert captures[1] >= 1 and captures[3] >= 1


def _make(device, chains, matvec, op, store):
    return lambda: _chain(device, chains, matvec, op, store)


@pytest.mark.parametrize("store", sorted(STORES))
@pytest.mark.parametrize("op", ["iteration", "trajectory"])
@pytest.mark.parametrize("matvec", [torch.bfloat16, torch.float32])
def test_replayed_chunks_equal_direct_ones(monkeypatch, matvec, op, store):
    monkeypatch.setattr(thmc, "IterationGraphs", EagerGraphs)
    _same_chunks(_make("cpu", 6, matvec, op, store), store,
                 torch.device("cpu"))


def test_new_dt_drops_the_graphs(monkeypatch):
    monkeypatch.setattr(thmc, "IterationGraphs", EagerGraphs)
    _new_dt_drops_the_graphs(
        _chain("cpu", 6, torch.bfloat16, "iteration", "chain1"), "chain1")


def test_no_graphs_on_the_cpu():
    """On the CPU every iteration is issued directly and counted so."""
    profiling.reset()
    _chunks(_chain("cpu", 4, torch.bfloat16, "iteration", "chain1"),
            "chain1", 3, fresh_buffers=False)
    counts = profiling.counters()
    assert counts["direct_iterations"] == 3 * CHUNK
    assert counts["graph_replays"] == counts["graph_captures"] == 0


def test_key_words_of_the_counter():
    """The counter's int32 view holds k0, k1 and the iteration, as the
    kernels read them, for a salt whose k1 has its top bit set."""
    b = tgraphs.Buffers(2, 8, torch.int32, 4, torch.float32, "cpu")
    salt = philox.salt_from_seed(SEED)
    b.start((salt[0], salt[1] | 1 << 31), 2 ** 32 + 5, 3)
    assert b.key.tolist() == [
        w - (1 << 32) * (w >> 31)
        for w in (salt[0], salt[1] | 1 << 31, 5)]
    b.step(True)
    b.step(False)
    assert b.ctr[1:].tolist() == [2 ** 32 + 7, 2, 4]


@pytest.mark.chip
@pytest.mark.parametrize("store", sorted(STORES))
@pytest.mark.parametrize("op", ["iteration", "trajectory"])
@pytest.mark.parametrize("matvec", [torch.bfloat16, torch.float32])
def test_card_replays_equal_direct_issue(card, matvec, op, store):
    """On the card, 64 chains: chunks 1-3 on CUDA graphs equal the same
    chunks issued launch by launch and the op's own loop, bit for bit."""
    _same_chunks(_make(card, 64, matvec, op, store), store, card)


@pytest.mark.chip
def test_card_new_dt_drops_the_graphs(card):
    _new_dt_drops_the_graphs(
        _chain(card, 64, torch.bfloat16, "iteration", "chain1"), "chain1")


# ------------------------------------------------ the frozen kernel's chunks

#: the realdata stand-in at a 3-degree step (16 stations, 299 tesseroids)
RD_STEP, RD_CHUNK, RD_LRANGE = 3.0, 8, (5, 40)


def _frozen(device):
    """The stand-in's sampler (the f32 trajectory op) after its windowed
    warmup: :meth:`HamiltonianMC.adapt`'s record, with a per-cell metric
    and L in [5, 40]."""
    from gravinv3dhmc_tpu_torch import realdata
    module, dobs = realdata.build_problem(device, step=RD_STEP)
    chain = realdata.slice_sampler(module, dobs, device, nchains=64,
                                   chunk=RD_CHUNK, adapt_chunks=8,
                                   Lrange=RD_LRANGE, seed=SEED)
    frozen = chain.adapt(3 * RD_CHUNK, 0)
    assert chain._fused_mode == "trajectory(float32)"
    assert frozen.inv_mass is not None and frozen.inv_mass.ndim == 1
    return frozen


def _frozen_chunks_replay_as_issued(device):
    """Four frozen chunks from the warmed carry, chunks 1-3 replayed,
    equal the same chunks issued directly (fresh buffers every chunk), bit
    for bit."""
    fz = _frozen(device)
    start = [t.clone() for t in fz.carry]
    out = {}
    for fresh in (False, True):
        carry = tuple(t.clone() for t in start)
        profiling.reset()
        rows = []
        for k in range(4):
            if fresh:
                carry = carry[:6] + (carry[6].clone(), carry[7].clone())
            carry, stats = fz.run(carry, fz.n_chunks + k,
                                  store_base=k * RD_CHUNK)
            rows.append(([t.clone() for t in carry], stats.clone()))
        out[fresh] = rows, profiling.counters()
    (replayed, counts), (direct, direct_counts) = out[False], out[True]
    for k in range(4):
        (ca, sa), (cb, sb) = replayed[k], direct[k]
        for name, a, b in zip(("x", "U", "g", "ud", "um", "nacc", "buf_m",
                               "buf_k"), ca, cb):
            assert torch.equal(a, b), (k, name)
        assert torch.equal(sa, sb), (k, "stats")
    assert counts["direct_iterations"] == RD_CHUNK
    assert counts["graph_replays"] == 3 * RD_CHUNK
    assert direct_counts["graph_replays"] == 0
    assert int(replayed[-1][1][..., 4].max()) > 20  # long trajectories ran


def _numpy_metric_replays(device):
    """The frozen metric passed as the same NumPy array every chunk: the
    chunks after the first replay, and a chunk whose graphs are all
    captured captures nothing more."""
    fz = _frozen(device)
    metric = fz.inv_mass.cpu().numpy()
    carry = fz.carry
    profiling.reset()
    seen = [profiling.counters()]
    for k in (0, 1, 1):
        carry, _ = fz.run_chunk(carry, fz.seed, fz.n_chunks + k, dt=fz.dt,
                                inv_mass=metric, store_base=0)
        seen.append(profiling.counters())

    def per_chunk(name):
        return [b[name] - a[name] for a, b in zip(seen, seen[1:])]

    assert per_chunk("direct_iterations") == [RD_CHUNK, 0, 0]
    assert per_chunk("graph_replays") == [0, RD_CHUNK, RD_CHUNK]
    captures = per_chunk("graph_captures")
    assert captures[1] >= 1 and captures[2] == 0


def test_frozen_chunks_replay_as_issued(monkeypatch):
    monkeypatch.setattr(thmc, "IterationGraphs", EagerGraphs)
    _frozen_chunks_replay_as_issued(torch.device("cpu"))


def test_a_numpy_metric_replays(monkeypatch):
    monkeypatch.setattr(thmc, "IterationGraphs", EagerGraphs)
    _numpy_metric_replays(torch.device("cpu"))


@pytest.mark.chip
def test_card_frozen_chunks_replay_as_issued(card):
    """On the card: the f32 trajectory op's frozen chunks with a per-cell
    metric and L in [5, 40] on CUDA graphs equal the same chunks issued
    launch by launch, bit for bit."""
    _frozen_chunks_replay_as_issued(card)


@pytest.mark.chip
def test_card_numpy_metric_replays(card):
    _numpy_metric_replays(card)
