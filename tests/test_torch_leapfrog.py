"""The port's fused leapfrog (plain PyTorch versions of the CUDA kernels)
against the JAX package's Pallas kernels, and Philox known answers.

The JAX kernels run as their own tests run them on the CPU: the
trajectory kernel with ``interpret=True`` and f32 matvecs, the iteration
kernel under ``pltpu.force_tpu_interpret_mode()``, whose stubbed PRNG
returns zeros (so the port is fed the matching constant normals and
``u = 0``, as ``tests/test_leapfrog_pallas.py`` does). Both sides get the
same state through ``params_from_jax``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from gravinv3dhmc_tpu.ops import leapfrog_pallas as jlf
from gravinv3dhmc_tpu_torch.ops import leapfrog as tlf
from gravinv3dhmc_tpu_torch.ops import philox

torch.set_num_threads(2)


def _fargs(module, dobs):
    M = module.n_active
    wdiag = module.wdiag
    return (np.asarray(module.Aw), np.asarray(dobs) - np.mean(dobs), None,
            wdiag * np.full(M, 0.001), wdiag * wdiag, wdiag * np.zeros(M),
            wdiag * np.ones(M))


def _np_params(prm):
    return {k: np.asarray(v) for k, v in prm.items()}


def _state(module, dobs, reg, C, seed):
    fargs = _fargs(module, dobs)
    pot = module.make_potential(fargs[3], fargs[5], fargs[6],
                                constraint="mandatory", regularization=reg,
                                beta=0.001, dtype=jnp.float32)
    rng = np.random.RandomState(seed)
    x = (rng.uniform(0.2, 0.8, (C, module.n_active))
         * np.asarray(module.wdiag)[None, :]).astype(np.float32)
    U, g, (_, ud, um) = pot(jnp.asarray(x), 1.0)
    return x, np.array(U), np.array(g), np.array(ud), np.array(um)


def _trajectory_pair(module, dobs, reg, inv_mass, jax_dtype, torch_dtype):
    """The JAX kernel (interpret mode) and the port's plain trajectory on
    the same state and params, L = 5."""
    M = module.n_active
    fargs = _fargs(module, dobs)
    jt = jlf.make_fused_trajectory(*fargs, regularization=reg, beta=0.001,
                                   tile_c=8, matvec_dtype=jax_dtype,
                                   interpret=True)
    tt = tlf.make_fused_trajectory(*fargs, regularization=reg, beta=0.001,
                                   matvec_dtype=torch_dtype, device="cpu")
    C = 8
    rng = np.random.RandomState(3)
    x = (rng.uniform(0.1, 0.6, (C, M))
         * np.asarray(module.wdiag)[None, :]).astype(np.float32)
    p = (rng.randn(C, M) * 1e-3).astype(np.float32)
    im = (10.0 ** rng.uniform(-2, 0, M)).astype(np.float32) if inv_mass \
        else None
    out_j = jt(jnp.asarray(x), jnp.asarray(p), jnp.int32(5),
               jnp.float32(0.01), jnp.float32(1.0), params=jt.params,
               inv_mass=None if im is None else jnp.asarray(im))
    params = tlf.params_from_jax(_np_params(jt.params), device="cpu")
    assert params["A"].dtype == torch_dtype
    out_t = tt(torch.from_numpy(x), torch.from_numpy(p), 5, 0.01, 1.0,
               params=params,
               inv_mass=None if im is None else torch.from_numpy(im))
    return out_j, out_t


@pytest.mark.parametrize("inv_mass", [False, True])
@pytest.mark.parametrize("reg", ["MS", "Damping"])
def test_trajectory_matches_jax_kernel(small_module, reg, inv_mass):
    """Same state, same L: x', p', g', U, ud, um agree to f32 rounding.
    Tolerances: the two sides sum the matvecs in different orders, and g
    is recovered as (pk - p)/eps, which divides that rounding by eps —
    hence the looser g bound (the JAX tests allow the same)."""
    module, dobs, _ = small_module
    out_j, out_t = _trajectory_pair(module, dobs, reg, inv_mass,
                                    jnp.float32, torch.float32)
    names = ["x", "p", "g", "U", "ud", "um"]
    tol = {"x": (2e-4, 1e-6), "p": (2e-3, 2e-6), "g": (2e-3, 2e-3),
           "U": (2e-4, 0), "ud": (2e-4, 0), "um": (2e-4, 1e-5)}
    for name, a, b in zip(names, out_j, out_t):
        rtol, atol = tol[name]
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol,
                                   atol=atol, err_msg=name)


#: bf16 storage (the slice's setting): both sides round x and r to bf16
#: before each product (the JAX kernel's ``x.astype(matvec_dtype)``) and
#: accumulate in f32. An x one f32 ulp apart on the two sides can round to
#: neighbouring bf16 values, so errors are bounded relative to the largest
#: |reference| of each output: p, which carries the bf16 products
#: directly, and g, recovered as (pk - p)/eps, by 2e-3 and 1e-3 (measured
#: 3e-4 and 3e-6 at this size); x by 1e-4 (measured 1.4e-6); U, ud, um by
#: 1e-5 (measured 2.3e-7). A port that left x or r unrounded misses the
#: JAX kernel by 2e-5 to 8e-4 in ud and 1.2e-3 to 3e-3 in g: outside.
BF16_REL_TOL = {"x": 1e-4, "p": 2e-3, "g": 1e-3, "U": 1e-5, "ud": 1e-5,
                "um": 1e-5}


def _assert_rel_to_max(name, got, ref, rel):
    ref = np.asarray(ref, np.float64)
    err = np.abs(np.asarray(got, np.float64) - ref).max()
    assert err <= rel * np.abs(ref).max(), (name, err, np.abs(ref).max())


@pytest.mark.parametrize("inv_mass", [False, True])
@pytest.mark.parametrize("reg", ["MS", "Damping"])
def test_trajectory_bf16_matches_jax_kernel(small_module, reg, inv_mass):
    """The bf16 matrix path against the JAX kernel run with
    ``matvec_dtype=jnp.bfloat16``: same bf16 A_c (carried through
    ``params_from_jax``), same rounding of the matvec operands."""
    module, dobs, _ = small_module
    out_j, out_t = _trajectory_pair(module, dobs, reg, inv_mass,
                                    jnp.bfloat16, torch.bfloat16)
    for name, a, b in zip(["x", "p", "g", "U", "ud", "um"], out_j, out_t):
        _assert_rel_to_max(name, b.numpy(), a, BF16_REL_TOL[name])


def _stub_normals(C, M):
    """The momentum the TPU interpreter's zero PRNG produces
    (tests/test_leapfrog_pallas.py:300-313)."""
    Mp = -(-M // 128) * 128
    n01 = np.zeros((C, M), np.float32)
    if Mp % 256 == 0:
        n16 = np.sqrt(-2.0 * np.log(np.float32(2.0 ** -17)))
        n01[:, :min(Mp // 2, M)] = np.float32(n16)
    else:
        n01[:, :] = np.float32(np.sqrt(-2.0 * np.log(np.float32(2.0 ** -25))))
    return n01


def _iteration_pair(module, dobs, reg, jax_dtype, torch_dtype):
    """One whole iteration in both packages with the same momentum (the
    stubbed TPU PRNG's) and u = 0."""
    M = module.n_active
    fargs = _fargs(module, dobs)
    kw = dict(regularization=reg, beta=0.001, Sigma=0.001)
    jit_ = jlf.make_fused_iteration(*fargs, tile_c=8, matvec_dtype=jax_dtype,
                                    **kw)
    tit = tlf.make_fused_iteration(*fargs, matvec_dtype=torch_dtype,
                                   device="cpu", **kw)
    C = 8
    x, U, g, ud, um = _state(module, dobs, reg, C, 5)
    with pltpu.force_tpu_interpret_mode():
        out_j = jit_(jnp.asarray(x), jnp.asarray(U), jnp.asarray(g),
                     jnp.asarray(ud), jnp.asarray(um), jnp.int32(7),
                     jnp.int32(4), jnp.float32(0.01), jnp.float32(1.0),
                     params=jit_.params)
    t = torch.from_numpy
    params = tlf.params_from_jax(_np_params(jit_.params), device="cpu")
    assert params["A"].dtype == torch_dtype
    out_t = tit(t(x), t(U), t(g), t(ud), t(um), ((1, 2), 7), 4, 0.01, 1.0,
                params=params, n01=t(_stub_normals(C, M)), u=torch.zeros(C))
    return ([np.asarray(a) for a in out_j], [a.numpy() for a in out_t])


@pytest.mark.parametrize("reg", ["MS", "Damping"])
def test_iteration_matches_jax_kernel(small_module, reg):
    """One whole iteration with the same momentum and u = 0: same accept
    flags, state within the trajectory tolerances."""
    module, dobs, _ = small_module
    (xj, Uj, gj, udj, umj, accj), (xt, Ut, gt, udt, umt, acct) = \
        _iteration_pair(module, dobs, reg, jnp.float32, torch.float32)
    np.testing.assert_array_equal(acct, accj)
    assert accj.sum() > 0
    np.testing.assert_allclose(xt, xj, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(gt, gj, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(Ut, Uj, rtol=2e-4)
    np.testing.assert_allclose(udt, udj, rtol=2e-4)
    np.testing.assert_allclose(umt, umj, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("reg", ["MS", "Damping"])
def test_iteration_bf16_matches_jax_kernel(small_module, reg):
    """The whole iteration on the bf16 matrix path: identical accept
    flags, state within ``BF16_REL_TOL`` of the JAX kernel's."""
    module, dobs, _ = small_module
    out_j, out_t = _iteration_pair(module, dobs, reg, jnp.bfloat16,
                                   torch.bfloat16)
    np.testing.assert_array_equal(out_t[5], out_j[5])
    assert out_j[5].sum() > 0
    for name, a, b in zip(["x", "U", "g", "ud", "um"], out_j, out_t):
        _assert_rel_to_max(name, b, a, BF16_REL_TOL[name])


def test_iteration_takes_lane_padded_state():
    """A sampler may keep x and g lane-padded (zero pads) across calls:
    the padded call gives the unpadded call's outputs bit for bit, and
    its pads stay exactly zero. 200 cells pad to 256 lanes; a carried U of
    +-1e6 makes even chains accept and odd ones reject."""
    rng = np.random.RandomState(6)
    D, M, C = 60, 200, 8
    tit = tlf.make_fused_iteration(
        rng.randn(D, M) * 0.1, rng.randn(D), None, np.full(M, 0.5),
        np.ones(M), np.zeros(M), np.ones(M), regularization="MS",
        matvec_dtype=torch.bfloat16, Sigma=0.01, device="cpu")
    Mp = tit.Mp
    assert Mp == 256
    x = torch.from_numpy(rng.uniform(0.2, 0.8, (C, M)).astype(np.float32))
    g = torch.from_numpy(rng.randn(C, M).astype(np.float32))
    U = torch.tensor([1e6, -1e6] * (C // 2))
    ud, um = torch.ones(C), torch.full((C,), 2.0)
    pad = torch.nn.functional.pad
    out = tit(x, U, g, ud, um, ((3, 4), 5), 6, 0.01, 1.0)
    out_p = tit(pad(x, (0, Mp - M)), U, pad(g, (0, Mp - M)), ud, um,
                ((3, 4), 5), 6, 0.01, 1.0)
    assert out[5].tolist() == [1.0, 0.0] * (C // 2)
    assert out_p[0].shape == (C, Mp) and out_p[2].shape == (C, Mp)
    for i in (0, 2):
        assert torch.equal(out_p[i][:, :M], out[i])
        assert torch.equal(out_p[i][:, M:], torch.zeros(C, Mp - M))
    for i in (1, 3, 4, 5):
        assert torch.equal(out_p[i], out[i])
    with pytest.raises(ValueError):
        tit(x[:, :M - 1], U, g[:, :M - 1], ud, um, ((3, 4), 5), 6, 0.01,
            1.0)


def test_iteration_rejection_keeps_state(small_module):
    """A hugely negative carried U makes exp(-dH) underflow to 0 and
    u = 0 is not below it: every chain rejects and keeps its carried
    state bit for bit, in both packages."""
    module, dobs, _ = small_module
    M = module.n_active
    fargs = _fargs(module, dobs)
    kw = dict(regularization="Damping", beta=0.001, Sigma=0.001)
    jit_ = jlf.make_fused_iteration(*fargs, tile_c=8,
                                    matvec_dtype=jnp.float32, **kw)
    tit = tlf.make_fused_iteration(*fargs, matvec_dtype=torch.float32,
                                   device="cpu", **kw)
    C = 8
    x0 = np.tile(0.5 * np.asarray(module.wdiag, np.float32), (C, 1))
    g0 = np.random.RandomState(0).randn(C, M).astype(np.float32)
    U0 = np.full(C, -1e30, np.float32)
    ud0 = np.full(C, 1.0, np.float32)
    um0 = np.full(C, 2.0, np.float32)
    with pltpu.force_tpu_interpret_mode():
        out_j = jit_(jnp.asarray(x0), jnp.asarray(U0), jnp.asarray(g0),
                     jnp.asarray(ud0), jnp.asarray(um0), jnp.int32(3),
                     jnp.int32(3), jnp.float32(0.01), jnp.float32(1.0),
                     params=jit_.params)
    t = torch.from_numpy
    out_t = tit(t(x0), t(U0), t(g0), t(ud0), t(um0), ((1, 2), 3), 3, 0.01,
                1.0, n01=t(_stub_normals(C, M)), u=torch.zeros(C))
    for a, b, ref in zip(out_j, out_t, (x0, U0, g0, ud0, um0)):
        np.testing.assert_array_equal(np.asarray(a), ref)
        np.testing.assert_array_equal(b.numpy(), ref)
    np.testing.assert_array_equal(out_t[5].numpy(), 0.0)


def test_iteration_nan_hamiltonian_rejects(small_module):
    """A NaN in the proposal makes H1 NaN, which fails both accept tests."""
    module, dobs, _ = small_module
    tit = tlf.make_fused_iteration(*_fargs(module, dobs),
                                   regularization="MS",
                                   matvec_dtype=torch.float32, Sigma=0.001,
                                   device="cpu")
    C, M = 4, module.n_active
    x, U, g, ud, um = (torch.from_numpy(a)
                       for a in _state(module, dobs, "MS", C, 1))
    g_nan = g.clone()
    g_nan[1, 0] = float("nan")
    out = tit(x, U, g_nan, ud, um, ((3, 4), 0), 3, 0.01, 1.0)
    assert out[5][1].item() == 0.0
    assert torch.equal(out[0][1], x[1])
    assert torch.isnan(out[2][1, 0])
    assert out[0].shape == (C, M)


@pytest.mark.parametrize("counter,key,expected", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, expected):
    """Philox4x32-10 known-answer vectors (Random123's kat_vectors)."""
    words = philox.philox4x32(
        *(torch.tensor([c], dtype=torch.int64) for c in counter), key)
    assert tuple(int(w) for w in words) == expected


def test_philox_normals_and_uniforms_are_standard():
    """1M Box-Muller normals: mean and variance within 5 sigma of their
    Monte Carlo error; uniforms in [0, 1) with mean 1/2."""
    salt = philox.salt_from_seed(11)
    n = philox.momentum_normals(salt, 3, 256, 4096).double()
    N = n.numel()
    assert abs(n.mean().item()) < 5 / np.sqrt(N)
    assert abs(n.var().item() - 1.0) < 5 * np.sqrt(2.0 / N)
    u = philox.accept_uniforms(salt, 3, 100000).double()
    assert 0.0 <= u.min().item() and u.max().item() < 1.0
    assert abs(u.mean().item() - 0.5) < 5 * np.sqrt(1 / 12 / u.numel())
    # a different iteration or stream gives different words
    assert not torch.equal(philox.momentum_bits(salt, 3, 2, 8),
                           philox.momentum_bits(salt, 4, 2, 8))


def test_bf16_storage_rounds_matvec_operands(small_module):
    """With bf16 storage the plain version rounds x (and r) to bf16 and
    accumulates in f32: it equals the f32 op fed the bf16-rounded matrix
    on the first step's residual, and stays close to the f32 trajectory."""
    module, dobs, _ = small_module
    fargs = _fargs(module, dobs)
    tb = tlf.make_fused_trajectory(*fargs, matvec_dtype=torch.bfloat16,
                                   device="cpu")
    tf = tlf.make_fused_trajectory(*fargs, matvec_dtype=torch.float32,
                                   device="cpu")
    assert tb.params["A"].dtype == torch.bfloat16
    C, M = 4, module.n_active
    rng = np.random.RandomState(2)
    x = torch.from_numpy((rng.uniform(0.1, 0.6, (C, M))
                          * module.wdiag[None, :]).astype(np.float32))
    p = torch.from_numpy((rng.randn(C, M) * 1e-3).astype(np.float32))
    xb, pb, gb, Ub, _, _ = tb(x, p, 3, 0.01, 1.0)
    xf, pf, gf, Uf, _, _ = tf(x, p, 3, 0.01, 1.0)
    # bf16 keeps ~3 significant digits of each product operand
    np.testing.assert_allclose(xb.numpy(), xf.numpy(), rtol=2e-2, atol=1e-6)
    np.testing.assert_allclose(Ub.numpy(), Uf.numpy(), rtol=5e-2)
