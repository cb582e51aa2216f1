"""How the fused sampler paths open and close an iteration, and where the
port's entry points run.

The per-step and trajectory branches of ``make_chunk_sampler`` open each
iteration with one ``refresh`` call and close it with one ``accept`` call,
as the fused iteration does. On the CPU these are the kernels' plain
versions, so the semantics the card's kernels are held to are pinned
here: a rejected chain gets its carried state back bit for bit, a NaN
Hamiltonian rejects, and ``refresh``'s p-only form (no ``pk``, the
per-step path's) writes exactly the two-output form's p and H0. Every
comparison is exact (``torch.equal``): selection and copies round
nothing.

Entry points run on ``cuda:0`` unless ``device`` is given; without a CUDA
device they raise, naming ``device="cpu"``, and never fall back to the
CPU. ``torch.cuda.is_available`` is patched to False, so the check is the
same on a machine with a card.
"""
import numpy as np
import pytest
import torch

from gravinv3dhmc_tpu_torch import (_device, mesher, ratiogrid, uniformgrid,
                                   utils)
from gravinv3dhmc_tpu_torch.inversion import hmc as thmc
from gravinv3dhmc_tpu_torch.inversion.potential import GravMagModule
from gravinv3dhmc_tpu_torch.ops import leapfrog as tlf
from gravinv3dhmc_tpu_torch.ops import philox, prism

torch.set_num_threads(2)

#: 7 x 9 observations over 7 x 9 x 4 prisms: 252 cells, lane-padded to 256
NX, NY, NZ = 7, 9, 4
CHAINS, CHUNK, LMIN, LMAX, SEED = 6, 3, 3, 6, 21


@pytest.fixture(scope="module")
def problem():
    return uniformgrid.build_problem(NX, NY, NZ, device="cpu")


def _sampler(problem, path, chunk=CHUNK, draws=None):
    module, dobs = problem
    w = np.asarray(module.wdiag)
    aprior, low, high = w * 0.001, w * 0.0, w * 1.0
    pot = module.make_potential(aprior, low, high, regularization="MS",
                                beta=0.001)
    fargs = (module.Aw, dobs - dobs.mean(), None, aprior, w * w, low, high)
    fkw = dict(regularization="MS", beta=0.001, matvec_dtype=torch.float32,
               device="cpu")
    key = "fused_step" if path == "step" else "fused_trajectory"
    make = (tlf.make_fused_step if path == "step"
            else tlf.make_fused_trajectory)
    run = thmc.make_chunk_sampler(
        pot, dt=0.05, Lmin=LMIN, Lmax=LMAX, Sigma=0.001, low=low, high=high,
        constraint="mandatory", alpha=1.0, chunk_size=chunk, nsamples=2,
        ndraws=0, wdiag_inv=module.wdiag_inv, data_size=dobs.size,
        shared_L=True, store_mode="chain", draws=draws, device="cpu",
        **{key: make(*fargs, **fkw)})
    return run, pot, aprior


def _carry(pot, x, U=None):
    U0, g, (_, ud, um) = pot(x, 1.0)
    M = x.shape[1]
    return (x, U0 if U is None else U, g, ud, um,
            torch.zeros(x.shape[0], dtype=torch.int32),
            torch.zeros((x.shape[0], 2, M)), torch.zeros((x.shape[0], 2, 7)))


def _injected(M):
    """A draw source: fixed L, normals from a seeded numpy generator and
    u = 0 (so only exp(-dH) = 0 or a NaN can reject)."""
    rng = np.random.RandomState(3)
    normals = [rng.randn(CHAINS, M).astype(np.float32)
               for _ in range(CHUNK)]

    def draws(chunk_idx, i):
        return LMIN + i, normals[i], np.zeros(CHAINS, np.float32)

    return draws


@pytest.mark.parametrize("draws", ["philox", "injected"])
@pytest.mark.parametrize("path", ["step", "trajectory"])
def test_forced_rejection_keeps_the_carry(problem, path, draws):
    """A hugely negative carried U makes exp(-dH) underflow to 0 and the
    uniform is not below it: every chain of every iteration rejects, and
    the carry (x, U, g, ud, um and the accept counts) comes back bit for
    bit, through the lane-padded carry and ``accept``'s restore."""
    M = problem[0].n_active
    run, pot, aprior = _sampler(
        problem, path, draws=_injected(M) if draws == "injected" else None)
    x = torch.as_tensor(np.tile(300.0 * aprior, (CHAINS, 1)),
                        dtype=torch.float32)
    carry = _carry(pot, x, U=torch.full((CHAINS,), -1e30))
    before = [t.clone() for t in carry]
    out, stats = run(carry, SEED, 0)
    assert torch.equal(stats[..., 0], torch.zeros(CHUNK, CHAINS))
    assert (stats[..., 4] >= LMIN).all()
    for name, a, b in zip(("x", "U", "g", "ud", "um", "nacc"), out, before):
        assert a.shape == b.shape, name
        assert torch.equal(a, b), name


@pytest.mark.parametrize("path", ["step", "trajectory"])
def test_nan_hamiltonian_rejects(problem, path):
    """A NaN in one chain's carried g makes its momentum, its trajectory
    and so its H1 NaN, which fails both accept tests: that chain keeps its
    carried x and g (NaN included) bit for bit; the others move."""
    run, pot, aprior = _sampler(problem, path, chunk=1)
    x = torch.as_tensor(np.tile(300.0 * aprior, (CHAINS, 1)),
                        dtype=torch.float32)
    carry = list(_carry(pot, x))
    carry[2] = carry[2].clone()
    carry[2][1, 0] = float("nan")
    before = [t.clone() for t in carry]
    out, stats = run(tuple(carry), SEED, 0)
    assert stats[0, 1, 0].item() == 0.0
    assert torch.equal(out[0][1], before[0][1])
    assert torch.isnan(out[2][1, 0])
    assert torch.equal(out[2][1, 1:], before[2][1, 1:])
    assert torch.equal(out[1][1], before[1][1])
    assert stats[0, [0, 2, 3, 4, 5], 0].sum().item() > 0
    assert torch.isfinite(out[0][[0, 2, 3, 4, 5]]).all()


@pytest.mark.parametrize("injected", [False, True])
def test_refresh_p_only_form(injected):
    """``refresh`` with ``pk`` None (nothing to write a copy of p to)
    writes the two-output form's p and H0 bit for bit."""
    C, Mp = 5, 256
    rng = np.random.RandomState(1)
    g = torch.from_numpy(rng.randn(C, Mp).astype(np.float32))
    U = torch.from_numpy(rng.randn(C).astype(np.float32))
    pscale = torch.full((Mp,), 0.01)
    pscale[250:] = 0.0
    im = torch.from_numpy(rng.uniform(0.1, 1.0, Mp).astype(np.float32))
    n01 = (torch.from_numpy(rng.randn(C, Mp).astype(np.float32))
           if injected else None)
    salt = philox.salt_from_seed(4)
    refresh = tlf.KERNELS["refresh"]
    p2, pk2, H2 = torch.empty(C, Mp), torch.empty(C, Mp), torch.empty(C)
    refresh(g, U, pscale, im, 0.025, salt, 7, n01, p2, pk2, H2)
    p1, H1 = torch.empty(C, Mp), torch.empty(C)
    refresh(g, U, pscale, im, 0.025, salt, 7, n01, p1, None, H1)
    assert torch.equal(p1, p2) and torch.equal(pk2, p2)
    assert torch.equal(H1, H2)
    # p = pscale n01 - eps/2 g, as the two-output form computes it
    n = n01 if injected else philox.momentum_normals(salt, 7, C, Mp)
    assert torch.equal(p1, pscale * n - 0.025 * g)


def _entry_points(device):
    """name -> a call of one entry point or builder with ``device`` (None
    leaves the default) at a tiny size."""
    rng = np.random.RandomState(0)
    D, M = 6, 8
    A = rng.randn(D, M)
    fargs = (A, rng.randn(D), None, np.zeros(M), np.ones(M), np.zeros(M),
             np.ones(M))
    kw = {} if device is None else {"device": device}
    obs = utils.regular((0, 400, 0, 400), (2, 2), z=0.0)
    module_cpu = GravMagModule(np.zeros(4), (0, 400, 0, 400, 0, 200),
                               (200, 200, 200), obs, verbose=False,
                               device="cpu")

    def hmc_prepare():
        w = np.asarray(module_cpu.wdiag)
        chain = thmc.HamiltonianMC(module_cpu)
        chain.dt, chain.Lrange, chain.nchains = 0.01, [2, 3], 2
        chain.shared_L = True
        chain.low, chain.high = w * 0.0, w * 1.0
        chain.initial_model = chain.aprior_model = w * 0.001
        chain.dobs = np.zeros(4)
        if device is not None:
            chain.device = device
        return chain.prepare(2, 0)

    def chunk_sampler():
        w = np.asarray(module_cpu.wdiag)
        pot = module_cpu.make_potential(w * 0.001, w * 0.0, w * 1.0)
        return thmc.make_chunk_sampler(
            pot, dt=0.01, Lmin=2, Lmax=3, Sigma=1.0, low=w * 0.0,
            high=w * 1.0, constraint="mandatory", alpha=1.0, chunk_size=1,
            nsamples=1, ndraws=0, wdiag_inv=module_cpu.wdiag_inv,
            data_size=4, shared_L=True, **kw)

    jax_params = {"A": np.pad(A, ((0, 2), (0, 120))),
                  "dobs": np.zeros(8), "dmask": np.r_[np.ones(D), 0, 0]}
    mesh = mesher.PrismMesh((0, 400, 0, 400, 0, 200), (200, 200, 200))
    return {
        "GravMagModule": lambda: GravMagModule(
            np.zeros(4), (0, 400, 0, 400, 0, 200), (200, 200, 200), obs,
            verbose=False, **kw),
        "HamiltonianMC": hmc_prepare,
        "make_chunk_sampler": chunk_sampler,
        "make_fused_step": lambda: tlf.make_fused_step(*fargs, **kw),
        "make_fused_trajectory": lambda: tlf.make_fused_trajectory(*fargs,
                                                                   **kw),
        "make_fused_iteration": lambda: tlf.make_fused_iteration(*fargs,
                                                                 **kw),
        "params_from_jax": lambda: tlf.params_from_jax(jax_params, **kw),
        "prism_kernel_matrix": lambda: prism.prism_kernel_matrix(
            "gz", *obs, mesh, backend="pallas", **kw),
        "uniformgrid.build_problem": lambda: uniformgrid.build_problem(
            2, 2, 2, **kw),
        "ratiogrid.build_problem": lambda: ratiogrid.build_problem(
            n=3, **kw),
    }


ENTRY_POINTS = ["GravMagModule", "HamiltonianMC", "make_chunk_sampler",
                "make_fused_step", "make_fused_trajectory",
                "make_fused_iteration", "params_from_jax",
                "prism_kernel_matrix", "uniformgrid.build_problem",
                "ratiogrid.build_problem"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_default_to_the_card(monkeypatch, name):
    """Without a CUDA device and without ``device``, each entry point
    raises the helper's error (no CPU fallback); with ``device="cpu"`` it
    runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points(None)[name]()
    assert _entry_points("cpu")[name]() is not None


def test_resolve_gives_cuda0(monkeypatch):
    """No device means ``cuda:0`` where a card is seen; a device given is
    kept as it is."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert _device.resolve(None) == torch.device("cuda", 0)
    assert _device.resolve("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _device.resolve(torch.device("cpu")) == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _device.resolve(None)
