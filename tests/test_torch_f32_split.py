"""The arithmetic of the f32-matrix GEMMs, which run on the tensor cores
from bf16 pieces (``csrc/leapfrog.cu``: ``residual_partial_split_kernel``,
``kick_split_kernel``), checked on the CPU with no card.

``split_f32`` cuts an f32 matrix into three bf16 pieces a0 + a1 + a2,
each rounded to nearest even (the rounding the kernels apply to x and r
in registers with ``__floats2bfloat162_rn``); they sum back to a within
2^-24 of |a|. The kernels compute the six products x_i a_j with
i + j <= 2; a float64 emulation of that sum lies no further from the
float64 product than twice one IEEE-f32 ``torch.matmul`` (TF32 off), and
the three-product bf16 scheme that drops x2 a0, x1 a1 and x0 a2 does not,
so six products are needed. The split plan of the f32 residual
at realdata's and uniformgrid's shapes cuts K into whole, non-empty
slices; an op with an f32 matrix holds its pieces (the same from
``params_from_jax``) and launches the f32 GEMM wrappers, a bf16 one the
bf16 wrappers; ``uniformgrid --matvec float32`` selects the f32 matrix.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gravinv3dhmc_tpu.ops import leapfrog_pallas as jlf
from gravinv3dhmc_tpu_torch import f32_gemm_check, uniformgrid
from gravinv3dhmc_tpu_torch.ops import leapfrog as tlf

torch.set_num_threads(2)

SMS = 132
#: the f32 kernels' block tile (chains, observations) and K depth a stage
F32_TILE = (128, 128, 32)
#: (chains, Dp, Mp) of realdata's trajectory stage and uniformgrid in f32
SHAPES = {"realdata": (256, 640, 10496), "uniformgrid": (1024, 640, 6016)}


def _bf16_bits(x32):
    """f32 values rounded to bf16 on their bits (nearest, ties to even),
    widened back to f32."""
    b = x32.view(np.uint32).astype(np.uint64)
    b = b + 0x7FFF + ((b >> 16) & 1)
    return (b & 0xFFFF0000).astype(np.uint32).view(np.float32)


@pytest.fixture(scope="module")
def uniformgrid_matrix():
    """The uniformgrid problem's weighted 600 x 6000 matrix, in f32."""
    module, _ = uniformgrid.build_problem(device="cpu")
    return np.asarray(module.Aw, np.float32)


def _values(kind, uniformgrid_matrix):
    rng = np.random.default_rng(5)
    if kind == "eight_decades":
        mag = 10.0 ** rng.uniform(-4.0, 4.0, (64, 512))
        return (np.sign(rng.standard_normal((64, 512))) * mag).astype(
            np.float32)
    if kind == "zeros":
        a = rng.standard_normal((32, 256)).astype(np.float32)
        a[:, ::2] = 0.0
        a[:4] = 0.0
        return a
    return uniformgrid_matrix


@pytest.mark.parametrize("kind", ["eight_decades", "zeros", "uniformgrid"])
def test_split_pieces_sum_back_to_the_matrix(kind, uniformgrid_matrix):
    a = _values(kind, uniformgrid_matrix)
    pieces = tlf.split_f32(torch.from_numpy(a))
    assert pieces.dtype == torch.bfloat16 and pieces.shape == (3, *a.shape)
    p = pieces.to(torch.float32).numpy()
    total = p.astype(np.float64).sum(0)
    a64 = a.astype(np.float64)
    assert np.all(np.abs(total - a64) <= 2.0 ** -24 * np.abs(a64))
    # each piece is the one before it rounded to nearest even, as the
    # kernels round x and r, and about 2^-8 of it or less
    rest = a
    for q in range(3):
        assert np.array_equal(p[q].view(np.uint32),
                              _bf16_bits(rest).view(np.uint32))
        rest = rest - p[q]
    assert np.all(np.abs(p[1]) <= 2.0 ** -8 * np.abs(a))
    assert np.all(np.abs(p[2]) <= 2.0 ** -16 * np.abs(a))
    if kind == "zeros":
        assert np.all(p[:, a == 0.0] == 0.0)


def _six_products(left, right, products):
    """sum over (i, j) of left_i @ right_j in float64, the pieces of
    both operands from ``split_f32``."""
    lp = tlf.split_f32(left).double()
    rp = tlf.split_f32(right).double()
    return sum(lp[i] @ rp[j] for i, j in products)


SIX = [(2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)]
THREE = [(1, 0), (0, 1), (0, 0)]


@pytest.mark.parametrize("gemm", ["residual", "kick"])
def test_six_products_are_as_close_as_an_f32_matmul(gemm,
                                                    uniformgrid_matrix):
    """At a small uniformgrid size: 37 chains against the first 96
    observations and 768 cells of the matrix (x A^T for the residual, r A
    for the kick)."""
    rng = np.random.default_rng(11)
    A = torch.from_numpy(uniformgrid_matrix[:96, :768].copy())
    if gemm == "residual":
        left = torch.from_numpy(rng.uniform(0.0, 0.6, (37, 768)).astype(
            np.float32))
        right = A.T.contiguous()
    else:
        left = torch.from_numpy(rng.normal(0.0, 1.0, (37, 96)).astype(
            np.float32))
        right = A
    ref = left.double() @ right.double()
    scale = ref.abs().max().item()

    def rel(out):
        return (out.double() - ref).abs().max().item() / scale

    f32 = rel(torch.matmul(left, right))
    assert rel(_six_products(left, right, SIX)) <= 2.0 * f32
    assert rel(_six_products(left, right, THREE)) > 2.0 * f32


def _residual_plan(monkeypatch, C, Dp, Mp):
    """residual_plan with the runtime's occupancy answer for the f32
    kernel given: one block an SM, 132 SMs, its tile."""
    monkeypatch.setitem(tlf._OCCUPANCY, tlf.A_F32_SPLIT, (1, SMS, *F32_TILE))
    monkeypatch.setattr(tlf, "_PLANS", {})
    return tlf.residual_plan(C, Dp, Mp, tlf.A_F32_SPLIT)


@pytest.mark.parametrize("C", [256, 200, 1024])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_f32_split_plan_covers_K_in_whole_slices(monkeypatch, shape, C):
    _, Dp, Mp = SHAPES[shape]
    plan = _residual_plan(monkeypatch, C, Dp, Mp)
    slices, ks = plan["slices"], F32_TILE[2]
    assert plan["tile"] == list(F32_TILE) and len(slices) == plan["splits"]
    assert slices[0][0] == 0 and slices[-1][1] == Mp
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    assert all(b % ks == 0 and e % ks == 0 and e > b for b, e in slices)
    stages = [(e - b) // ks for b, e in slices]
    assert max(stages) - min(stages) <= 1
    tiles = (Dp // F32_TILE[1]) * -(-C // F32_TILE[0])
    assert plan["blocks"] == tiles * plan["splits"]
    # the cap: as many slices as one wave holds, at least MAX_SPLITS
    cap = max(tlf.MAX_SPLITS, SMS // tiles)
    assert plan["splits"] <= cap and plan["splits"] == tlf.split_plan(
        C, Dp, Mp, *F32_TILE, SMS, cap)["splits"]


@pytest.mark.parametrize("shape, C, splits, blocks", [
    ("realdata", 256, 13, 130),     # 2 x 5 tiles: 13 slices fill a wave
    ("uniformgrid", 1024, 3, 120),  # 8 x 5 tiles: the bf16 GEMM's plan
])
def test_f32_split_plan_at_the_slices(monkeypatch, shape, C, splits,
                                      blocks):
    plan = _residual_plan(monkeypatch, C, *SHAPES[shape][1:])
    assert (plan["splits"], plan["blocks"]) == (splits, blocks)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_f32_kick_plan_covers_the_output_in_one_pass(monkeypatch, shape):
    C, Dp, Mp = SHAPES[shape]
    monkeypatch.setitem(tlf._OCCUPANCY, ("kick", tlf.A_F32_SPLIT),
                        (1, SMS, *F32_TILE))
    monkeypatch.setattr(tlf, "_PLANS", {})
    plan = tlf.kick_plan(C, Dp, Mp, tlf.A_F32_SPLIT)
    assert plan["splits"] == 1 and plan["slices"] == [(0, Dp)]
    assert plan["blocks"] == (Mp // 128) * -(-C // 128)


@pytest.mark.parametrize("argv, dtype", [([], torch.bfloat16),
                                         (["--matvec", "float32"],
                                          torch.float32),
                                         (["--matvec", "bfloat16"],
                                          torch.bfloat16)])
def test_uniformgrid_matvec_option(argv, dtype):
    assert uniformgrid.parse_args(argv).matvec is dtype


def test_the_matrix_type_picks_the_kernel():
    """The launch wrappers refuse a matrix of the other type, and an f32
    matrix without its pieces, before anything reaches a card."""
    A32 = torch.zeros(128, 128)
    with pytest.raises(TypeError):
        tlf._matrix(tlf.A_BF16, A32, None)
    with pytest.raises(TypeError):
        tlf._matrix(tlf.A_F32_SPLIT, A32.to(torch.bfloat16), None)
    with pytest.raises(ValueError):
        tlf._matrix(tlf.A_F32_SPLIT, A32, None)


def _fargs(module, dobs):
    M = module.n_active
    w = np.asarray(module.wdiag)
    return (np.asarray(module.Aw), np.asarray(dobs) - np.mean(dobs), None,
            w * np.full(M, 0.001), w * w, w * np.zeros(M), w * np.ones(M))


def test_params_from_jax_give_the_same_pieces(small_module):
    """The JAX f32 trajectory op's params, through ``params_from_jax``,
    give the port's op the pieces it split from its own matrix, bit for
    bit."""
    module, dobs, _ = small_module
    fargs = _fargs(module, dobs)
    jt = jlf.make_fused_trajectory(*fargs, regularization="MS", beta=0.001,
                                   tile_c=8, matvec_dtype=jnp.float32,
                                   interpret=True)
    tt = tlf.make_fused_trajectory(*fargs, regularization="MS", beta=0.001,
                                   matvec_dtype=torch.float32, device="cpu")
    params = tlf.params_from_jax({k: np.asarray(v)
                                  for k, v in jt.params.items()},
                                 device="cpu")
    own = tt._padded["A_split"]
    theirs = tt.resolve_params(params)["A_split"]
    assert own.shape == (3, tt.Dp, tt.Mp)
    assert torch.equal(own.view(torch.int16), theirs.view(torch.int16))
    assert torch.equal(own, tlf.split_f32(tt._padded["A"]))


@pytest.mark.parametrize("gemm", f32_gemm_check.GEMMS)
def test_gemm_check_operands_and_float64_reference(gemm):
    """The card's f32 GEMM check (``f32_gemm_check``) on a small synthetic
    problem (40 observations, 300 cells, 9 chains): the wrapper, which
    runs its plain version on the CPU, lands within f32 rounding of the
    float64 reference in the output ``product_out`` names, and the
    library call computes the same product."""
    op = tlf.make_fused_trajectory(
        *f32_gemm_check.synthetic_problem(40, 300), regularization="MS",
        beta=0.001, matvec_dtype=torch.float32, device="cpu")
    make = f32_gemm_check.gemm_operands(op, 9)[gemm]
    a = make()
    ref = f32_gemm_check.f64_reference(gemm, make())
    out = f32_gemm_check.product_out(gemm, a)
    before = out.clone()
    tlf.KERNELS[gemm](*a)
    assert not torch.equal(out, before)
    assert 0.0 < f32_gemm_check.rel_to_f64(gemm, a, ref) < 1e-5
    if gemm != "step_residual_f32":
        # the residual's reference is the bare x A^T (dobs 0, dmask 1),
        # the kick's p - s_data (r A) with p = 0 and s_data = -1
        lib = f32_gemm_check.library_fn(gemm, make())().double()
        assert (lib - ref).abs().max() / ref.abs().max() < 1e-5


@pytest.mark.parametrize("matvec", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("path", ["trajectory", "iteration", "step"])
def test_ops_launch_the_gemms_of_their_matrix_type(small_module, monkeypatch,
                                                   path, matvec):
    """Each op calls the GEMM wrappers of its matrix type and no other
    (on the CPU the wrappers run their plain versions)."""
    module, dobs, _ = small_module
    fargs = _fargs(module, dobs)
    kw = dict(regularization="MS", beta=0.001, matvec_dtype=matvec,
              device="cpu")
    calls = dict.fromkeys(("residual", "kick", "step_residual",
                           *tlf.F32_GEMMS.values()), 0)

    def counting(name):
        plain = tlf.KERNELS[name].plain

        def wrapper(*a):
            calls[name] += 1
            return plain(*a)
        return wrapper

    for name in calls:
        monkeypatch.setattr(tlf.KERNELS[name], "plain", counting(name))
    C, M, L = 3, module.n_active, 4
    x = torch.full((C, M), 0.3) * torch.from_numpy(
        np.asarray(module.wdiag, np.float32))
    p = torch.zeros(C, M)
    if path == "step":
        tlf.make_fused_step(*fargs, **kw)(x, p, 0.01, 1.0)
        used, steps = tlf.STEP_KERNELS, 1
    elif path == "trajectory":
        tlf.make_fused_trajectory(*fargs, **kw)(x, p, L, 0.01, 1.0)
        used, steps = tlf.ITERATION_KERNELS, L
    else:
        z = torch.zeros(C)
        tlf.make_fused_iteration(*fargs, Sigma=0.001, **kw)(
            x, z, torch.zeros(C, M), z, z, ((1, 2), 0), L, 0.01, 1.0)
        used, steps = tlf.ITERATION_KERNELS, L
    want = {n: steps for n in tlf.path_kernels(used, matvec) if n in calls}
    assert {n: c for n, c in calls.items() if c} == want
