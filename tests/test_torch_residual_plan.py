"""The split-K plan of the residual GEMM and the function its bf16
tensor-core kernel is held to.

``ops.leapfrog.split_plan`` is the arithmetic of ``residual_plan`` without
the card: given the kernel's block tile, its K depth per stage and the
blocks the card holds at once, it picks the split count whose blocks fill
the largest share of their last wave (the fewest splits on a tie) and
cuts K into slices of whole stages, as ``csrc/leapfrog.cu`` cuts them.
The shapes are the two slices' (uniformgrid 1024 x 640 x 6016, ratiogrid
1024 x 1024 x 17,152) at 1024, 256 and a ragged 200 chains, with the
tensor-core tile (128 x 128, 64 deep) and the f32 SIMT tile (64 x 64, 16
deep), on 132 SMs holding one or two blocks each.

``residual_plain`` and ``step_residual_plain`` with a bf16 matrix are
held against a float64 numpy reference that rounds x to bf16 by hand
(round to nearest, ties to even, on the f32 bits): the card's kernel is
held to the plain versions, so this pins down what it must compute. The
tolerance, 1e-5 of the largest |reference| value, is f32 summation over
a few hundred terms; rounding x by truncation instead moves the result by
~1e-3 of it.
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

from gravinv3dhmc_tpu_torch.ops import leapfrog as tlf

torch.set_num_threads(2)

SMS = 132
SHAPES = {"uniformgrid": (640, 6016), "ratiogrid": (1024, 17152)}
TILES = {"tensor_core": (128, 128, 64), "simt_f32": (64, 64, 16)}
#: error over the largest |reference| value (see the module docstring)
REF_RTOL = 1e-5


def _fill(tiles, splits, resident):
    n = tiles * splits
    return Fraction(n, -(-n // resident) * resident)


@pytest.mark.parametrize("per_sm", [1, 2])
@pytest.mark.parametrize("C", [1024, 256, 200])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("tile", sorted(TILES))
def test_split_plan_slices_and_fill(tile, shape, C, per_sm):
    Dp, Mp = SHAPES[shape]
    tm, tn, ks = TILES[tile]
    resident = SMS * per_sm
    plan = tlf.split_plan(C, Dp, Mp, tm, tn, ks, resident)
    slices = plan["slices"]
    assert plan["tile"] == [tm, tn, ks]
    assert len(slices) == plan["splits"]
    # together the slices cover K exactly, in order, without overlap
    assert slices[0][0] == 0 and slices[-1][1] == Mp
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    # each covers whole stages, none is empty, sizes within one stage
    assert all(b % ks == 0 and e % ks == 0 for b, e in slices)
    stages = [(e - b) // ks for b, e in slices]
    assert min(stages) >= 1 and max(stages) - min(stages) <= 1
    # the fill rule: the fullest last wave, the fewest splits on a tie
    tiles = (Dp // tn) * -(-C // tm)
    allowed = range(1, min(tlf.MAX_SPLITS, Mp // ks) + 1)
    best = max(_fill(tiles, s, resident) for s in allowed)
    assert plan["splits"] == min(s for s in allowed
                                 if _fill(tiles, s, resident) == best)
    assert plan["blocks"] == tiles * plan["splits"]
    assert plan["waves"] == pytest.approx(plan["blocks"] / resident)


@pytest.mark.parametrize("shape, splits, blocks", [
    ("uniformgrid", 3, 120),   # 8 x 5 tiles: 3 and 6 splits tie at 120/132
    ("ratiogrid", 2, 128),     # 8 x 8 tiles: 2, 4, 6 and 8 tie at 128/132
])
def test_split_plan_tensor_core_at_the_slices(shape, splits, blocks):
    """The plans ``residual_plan`` documents, one block per SM."""
    plan = tlf.split_plan(1024, *SHAPES[shape], *TILES["tensor_core"], SMS)
    assert (plan["splits"], plan["blocks"]) == (splits, blocks)


@pytest.mark.parametrize("Mp, max_splits", [(128, 8), (64 * 5, 8),
                                            (64 * 9, 6)])
def test_split_plan_never_more_splits_than_stages(Mp, max_splits):
    """A short K (few stages, a tiny problem with many SMs to fill) caps
    the split count at the stage count, so no slice is empty."""
    plan = tlf.split_plan(37, 128, Mp, 128, 128, 64, SMS, max_splits)
    assert plan["splits"] <= min(Mp // 64, max_splits)
    assert all(e > b for b, e in plan["slices"])


def test_split_plan_rejects_a_shape_off_the_tile():
    with pytest.raises(ValueError):
        tlf.split_plan(64, 640 + 64, 6016, 128, 128, 64, SMS)
    with pytest.raises(ValueError):
        tlf.split_plan(64, 640, 6016 + 32, 128, 128, 64, SMS)


def _bf16_bits(x32, nearest_even=True):
    """f32 values rounded to bf16 on their bits, widened back to f32:
    round to nearest with ties to even, or truncation."""
    b = x32.view(np.uint32).astype(np.uint64)
    if nearest_even:
        b = b + 0x7FFF + ((b >> 16) & 1)
    return (b & 0xFFFF0000).astype(np.uint32).view(np.float32)


def _gemm_inputs(C=37, D=250, Dp=256, Mp=384, seed=7):
    """x with every third column an exact bf16 tie (half an ulp above a
    bf16 value), a bf16 matrix with zero pad rows, dobs, a non-zero fix
    and a dmask of the D true rows."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, (C, Mp)).astype(np.float32)
    tie = (x.view(np.uint32) & 0xFFFF0000) | 0x8000
    x[:, ::3] = tie.view(np.float32)[:, ::3]
    A = _bf16_bits(rng.normal(0.0, 1.0, (Dp, Mp)).astype(np.float32))
    A[D:] = 0.0
    dmask = np.zeros(Dp, np.float32)
    dmask[:D] = 1.0
    dobs = rng.normal(0.0, 5.0, Dp).astype(np.float32) * dmask
    fix = rng.normal(0.0, 1.0, Dp).astype(np.float32) * dmask
    return x, A, dobs, fix, dmask, D


def _rel(out, ref):
    return np.abs(np.asarray(out, np.float64) - ref).max() / np.abs(ref).max()


def test_torch_bf16_cast_is_round_to_nearest_even():
    """torch's f32 -> bf16 cast (the plain versions' rounding of x) is the
    rounding the kernel applies (``__floats2bfloat162_rn``), ties
    included."""
    x = _gemm_inputs()[0]
    cast = torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()
    assert np.array_equal(cast.view(np.uint32),
                          _bf16_bits(x).view(np.uint32))
    assert not np.array_equal(cast, _bf16_bits(x, nearest_even=False))


def test_residual_plain_bf16_against_float64():
    x, A, dobs, _, dmask, _ = _gemm_inputs()
    r = torch.empty(x.shape[0], A.shape[0])
    tlf.residual_plain(torch.from_numpy(x),
                       torch.from_numpy(A).to(torch.bfloat16),
                       torch.from_numpy(dobs), torch.from_numpy(dmask), r)

    def ref(nearest_even):
        xr = _bf16_bits(x, nearest_even).astype(np.float64)
        return (xr @ A.astype(np.float64).T - dobs) * dmask

    assert _rel(r.numpy(), ref(True)) < REF_RTOL
    assert _rel(ref(False), ref(True)) > 100 * REF_RTOL


def test_step_residual_plain_bf16_against_float64():
    x, A, dobs, fix, dmask, D = _gemm_inputs()
    C, Dp = x.shape[0], A.shape[0]
    inv_nobs = float(np.float32(1.0 / D))
    r, ud = torch.empty(C, Dp), torch.empty(C)
    tlf.step_residual_plain(torch.from_numpy(x),
                            torch.from_numpy(A).to(torch.bfloat16),
                            torch.from_numpy(fix), torch.from_numpy(dobs),
                            torch.from_numpy(dmask), inv_nobs, r, ud)

    def ref(nearest_even):
        xr = _bf16_bits(x, nearest_even).astype(np.float64)
        d = xr @ A.astype(np.float64).T + fix
        rv = ((d - d.sum(1, keepdims=True) / D) - dobs) * dmask
        return rv, (rv * rv).sum(1)

    r64, ud64 = ref(True)
    assert _rel(r.numpy(), r64) < REF_RTOL
    assert _rel(ud.numpy(), ud64) < REF_RTOL
    assert np.all(r.numpy()[:, D:] == 0.0)
    assert _rel(ref(False)[0], r64) > 100 * REF_RTOL
