"""The function the bf16 tensor-core kick is held to, the ``draws`` kernel's
registration, and the samplers that draw through it.

``kick_plain`` with a bf16 matrix is held against a float64 numpy
reference that rounds r to bf16 by hand (round to nearest, ties to even,
on the f32 bits): the card's kernel is held to the plain version, so this
pins down what it must compute. The tolerance, 1e-5 of the largest
|reference| value, is f32 summation over a few hundred terms and the f32
epilogue; rounding r by truncation instead moves the bare product by
~1e-3 of it.

``draws`` gives the eager shared-L sampler the Philox normals (at the
lane-padded width) and uniforms that the ``refresh`` and ``accept``
kernels draw on the fused paths (iteration, trajectory and per-step),
which open and close each iteration with one call of each. Its plain
version must be ``philox.momentum_normals`` and
``philox.accept_uniforms`` bit for bit, and a sampler that draws through
the registry must carry exactly what it carried when it called those two
itself.

``kick_plan`` is ``split_plan`` with the kick's roles: N = Mp, K = Dp, one
split.
"""
import numpy as np
import pytest
import torch

from gravinv3dhmc_tpu_torch import uniformgrid
from gravinv3dhmc_tpu_torch.inversion import hmc as thmc
from gravinv3dhmc_tpu_torch.ops import leapfrog as tlf
from gravinv3dhmc_tpu_torch.ops import philox

torch.set_num_threads(2)

#: error over the largest |reference| value (see the module docstring)
REF_RTOL = 1e-5
SMS = 132
SHAPES = {"uniformgrid": (640, 6016), "ratiogrid": (1024, 17152)}


def _bf16_bits(x32, nearest_even=True):
    """f32 values rounded to bf16 on their bits, widened back to f32:
    round to nearest with ties to even, or truncation."""
    b = x32.view(np.uint32).astype(np.uint64)
    if nearest_even:
        b = b + 0x7FFF + ((b >> 16) & 1)
    return (b & 0xFFFF0000).astype(np.uint32).view(np.float32)


def _kick_inputs(C=37, D=250, Dp=256, Mp=384, seed=11):
    """r with every third column an exact bf16 tie (half an ulp above a
    bf16 value) and zero pad columns, a bf16 matrix with zero pad rows,
    x, p, aprior and an MS gradient scale."""
    rng = np.random.default_rng(seed)
    r = rng.normal(0.0, 1.0, (C, Dp)).astype(np.float32)
    tie = (r.view(np.uint32) & 0xFFFF0000) | 0x8000
    r[:, ::3] = tie.view(np.float32)[:, ::3]
    r[:, D:] = 0.0
    A = _bf16_bits(rng.normal(0.0, 1.0, (Dp, Mp)).astype(np.float32))
    A[D:] = 0.0
    x = rng.uniform(0.0, 0.6, (C, Mp)).astype(np.float32)
    p = rng.normal(0.0, 0.1, (C, Mp)).astype(np.float32)
    aprior = np.full(Mp, 0.001, np.float32)
    gm_scale = rng.uniform(1e-4, 2e-3, Mp).astype(np.float32)
    return r, A, x, p, aprior, gm_scale


def _kick_reference(r, A, x, p, aprior, gm_scale, s_data, s_mod, beta, ms,
                    nearest_even=True):
    rr = _bf16_bits(r, nearest_even).astype(np.float64)
    gdata = rr @ A.astype(np.float64)
    dm = x.astype(np.float64) - aprior
    gm = gm_scale * dm / (dm * dm + beta) ** 2 if ms else dm
    return p - s_data * gdata - s_mod * gm


def _rel(out, ref):
    return np.abs(np.asarray(out, np.float64) - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("case", ["MS", "Damping", "product"])
def test_kick_plain_bf16_against_float64(case):
    """MS and Damping with both terms of the kick; ``product`` is p = 0,
    s_mod = 0 and s_data = -1, the bare GEMM, where truncating r shows."""
    r, A, x, p, aprior, gm_scale = _kick_inputs()
    ms = case == "MS"
    s_data, s_mod, beta = 0.02, 0.01, 0.001
    if case == "product":
        p, s_data, s_mod = np.zeros_like(p), -1.0, 0.0
    pt = torch.from_numpy(p.copy())
    tlf.kick_plain(torch.from_numpy(r), torch.from_numpy(A).to(torch.bfloat16),
                   torch.from_numpy(x), pt, torch.from_numpy(aprior),
                   torch.from_numpy(gm_scale), s_data, s_mod, beta, ms)
    args = (r, A, x, p, aprior, gm_scale, s_data, s_mod, beta, ms)
    ref = _kick_reference(*args)
    assert _rel(pt.numpy(), ref) < REF_RTOL
    if case == "product":
        assert _rel(_kick_reference(*args, nearest_even=False),
                    ref) > 100 * REF_RTOL
    else:
        # the gradient term is not lost under p
        assert _rel(p, ref) > 100 * REF_RTOL


@pytest.mark.parametrize("C, width, iteration", [(3, 128, 0), (5, 256, 9),
                                                 (2, 4, 2 ** 32 - 1)])
def test_draws_plain_is_the_philox_draws(C, width, iteration):
    salt = philox.salt_from_seed(77)
    n01 = torch.full((C, width), float("nan"))
    u = torch.full((C,), float("nan"))
    tlf.KERNELS["draws"](n01, u, salt, iteration)
    assert torch.equal(n01, philox.momentum_normals(salt, iteration, C,
                                                    width))
    assert torch.equal(u, philox.accept_uniforms(salt, iteration, C))
    k = tlf.KERNELS["draws"]
    assert k.plain is tlf.draws_plain and k.launches == 0
    assert k.replaces.startswith("gravinv3dhmc_tpu/ops/leapfrog_pallas.py:")


#: a small uniformgrid (7 x 9 observations over 7 x 9 x 4 prisms): 252
#: cells, so the draws are made at the lane-padded width 256 and sliced
NX, NY, NZ = 7, 9, 4
CHAINS, CHUNK, LMIN, LMAX, SEED = 6, 5, 3, 6, 13


@pytest.fixture(scope="module")
def problem():
    return uniformgrid.build_problem(NX, NY, NZ, device="cpu")


def _sampler(problem, path, draws=None):
    module, dobs = problem
    M = module.n_active
    w = np.asarray(module.wdiag)
    aprior, low, high = w * 0.001, w * 0.0, w * 1.0
    pot = module.make_potential(aprior, low, high, regularization="MS",
                                beta=0.001)
    fargs = (module.Aw, dobs - dobs.mean(), None, aprior, w * w, low, high)
    fkw = dict(regularization="MS", beta=0.001, matvec_dtype=torch.float32,
               device="cpu")
    fused = {}
    if path == "step":
        fused["fused_step"] = tlf.make_fused_step(*fargs, **fkw)
    elif path == "trajectory":
        fused["fused_trajectory"] = tlf.make_fused_trajectory(*fargs, **fkw)
    elif path == "iteration":
        fused["fused_iteration"] = tlf.make_fused_iteration(
            *fargs, Sigma=0.001, **fkw)
    run = thmc.make_chunk_sampler(
        pot, dt=0.05, Lmin=LMIN, Lmax=LMAX, Sigma=0.001, low=low, high=high,
        constraint="mandatory", alpha=1.0, chunk_size=CHUNK, nsamples=4,
        ndraws=0, wdiag_inv=module.wdiag_inv, data_size=dobs.size,
        shared_L=True, store_mode="chain", draws=draws, device="cpu",
        **fused)
    x = torch.as_tensor(np.tile(300.0 * aprior, (CHAINS, 1)),
                        dtype=torch.float32)
    U, g, (_, ud, um) = pot(x, 1.0)
    carry = (x, U, g, ud, um, torch.zeros(CHAINS, dtype=torch.int32),
             torch.zeros((CHAINS, 4, M)), torch.zeros((CHAINS, 4, 7)))
    return run, carry


@pytest.mark.parametrize("path, calls", [
    pytest.param("step", {"refresh": CHUNK, "accept": CHUNK, "draws": 0},
                 id="step-5"),
    pytest.param("trajectory",
                 {"refresh": CHUNK, "accept": CHUNK, "draws": 0},
                 id="trajectory-5"),
    pytest.param("shared_L", {"refresh": 0, "accept": 0, "draws": CHUNK},
                 id="shared_L-5"),
    pytest.param("iteration",
                 {"refresh": CHUNK, "accept": CHUNK, "draws": 0},
                 id="iteration-0")])
def test_samplers_draw_through_the_registry(problem, monkeypatch, path,
                                            calls):
    """Each fused path opens an iteration with one ``refresh`` call and
    closes it with one ``accept`` call, which draw; the eager shared-L
    path makes one ``draws`` call instead. All at the lane-padded width,
    keyed by the global iteration; only the per-step path takes
    ``refresh``'s p-only form (no pk)."""
    seen = {name: [] for name in calls}

    def counting(name):
        plain = tlf.KERNELS[name].plain

        def wrapper(*a):
            # (padded width, pk given) for refresh, else the width
            if name == "refresh":
                seen[name].append((a[0].shape, a[9] is not None, a[6]))
            elif name == "accept":
                seen[name].append((a[0].shape, a[14]))
            else:
                seen[name].append((a[0].shape, a[3]))
            return plain(*a)
        return wrapper

    for name in calls:
        monkeypatch.setattr(tlf.KERNELS[name], "plain", counting(name))
    run, carry = _sampler(problem, path)
    run(carry, SEED, 2)
    assert {name: len(v) for name, v in seen.items()} == calls
    shape = (CHAINS, 256)
    for name, rows in seen.items():
        for i, row in enumerate(rows):
            assert row[0] == shape and row[-1] == 2 * CHUNK + i
        if name == "refresh":
            assert all(row[1] == (path != "step") for row in rows)


def _direct_philox_draws(M):
    """A draw source that calls the plain Philox as the samplers did
    before they drew through ``draws``: normals at the lane-padded width
    sliced to M, uniforms, and the chunk's L from its CPU generator."""
    salt = philox.salt_from_seed(SEED)
    width = -(-M // tlf.LANE) * tlf.LANE

    def draws(chunk_idx, i):
        it = chunk_idx * CHUNK + i
        L = thmc._chunk_lengths(SEED, chunk_idx, CHUNK, LMIN, LMAX)[i]
        return (L, philox.momentum_normals(salt, it, CHAINS, width)[:, :M],
                philox.accept_uniforms(salt, it, CHAINS))

    return draws


@pytest.mark.parametrize("path", ["step", "trajectory", "shared_L"])
def test_drawing_through_the_registry_keeps_the_carry(problem, path):
    """Without injected draws the sampler's carry and stats are bit for
    bit those of the same chunks fed the plain Philox directly."""
    M = problem[0].n_active
    assert M % tlf.LANE
    run_k, carry_k = _sampler(problem, path)
    run_d, carry_d = _sampler(problem, path, _direct_philox_draws(M))
    for chunk in (0, 1):
        carry_k, stats_k = run_k(carry_k, SEED, chunk)
        carry_d, stats_d = run_d(carry_d, SEED, chunk)
        assert torch.equal(stats_k, stats_d)
    for a, b in zip(carry_k, carry_d):
        assert torch.equal(a, b)
    assert 0 < stats_k[..., 0].mean() <= 1


def _occupancy(monkeypatch, tile_m, per_sm):
    """kick_plan with the runtime's occupancy answer given: blocks an SM,
    SMs, the tile (chains, columns) and the K depth of a stage."""
    monkeypatch.setitem(tlf._OCCUPANCY, "kick", (per_sm, SMS, tile_m, 128,
                                                 64))
    monkeypatch.setattr(tlf, "_PLANS", {})


@pytest.mark.parametrize("C", [1024, 200, 37])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("tile_m, per_sm", [(128, 1), (64, 2)])
def test_kick_plan_covers_the_output_in_one_pass(monkeypatch, shape, C,
                                                 tile_m, per_sm):
    """One block per tile of chains x 128 columns, each over all of K."""
    _occupancy(monkeypatch, tile_m, per_sm)
    Dp, Mp = SHAPES[shape]
    plan = tlf.kick_plan(C, Dp, Mp)
    assert plan["splits"] == 1 and plan["slices"] == [(0, Dp)]
    assert plan["tile"] == [tile_m, 128, 64]
    assert plan["blocks"] == (Mp // 128) * -(-C // tile_m)
    assert plan["waves"] == pytest.approx(plan["blocks"] / (SMS * per_sm))
    assert (plan["blocks_per_sm"], plan["sms"]) == (per_sm, SMS)


@pytest.mark.parametrize("Dp, Mp", [(640, 6016 + 64), (640 + 32, 6016)])
def test_kick_plan_rejects_a_shape_off_the_tile(monkeypatch, Dp, Mp):
    """Mp must be whole 128-column tiles and Dp whole 64-deep stages, as
    lf_kick requires."""
    _occupancy(monkeypatch, 128, 1)
    with pytest.raises(ValueError):
        tlf.kick_plan(64, Dp, Mp)
