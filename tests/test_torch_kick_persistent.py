"""The persistent f32 kick on the card: bit for bit the kick of a block a
tile.

``kick_split_persistent_kernel`` walks many output tiles a block and runs
each tile's epilogue under the next tile's mainloop; its K loop, its six
products in their order and its promotion every stage are those of the
kick that ran one block a tile, so p must equal that kick's bit for bit.
That kick is another ``leapfrog.cu`` (the commit's before the persistent
kick), named by the environment variable ``KICK_BASELINE``; the tests
build it (``kick_tune.build_baseline``) and run both on the same operands
(``kick_tune.f32_operands``: the whole kick, MS, p and both scales) at
each shape of ``f32_gemm_check.SHAPES`` and at 37 chains of the
realdata-fused cell's width (``kick_tune.f32_cases``). Marked ``chip``:
they skip without a card or without ``KICK_BASELINE``. This file imports
no JAX, so that it runs there: ``KICK_BASELINE=old_leapfrog.cu python -m
pytest --noconftest -p no:cacheprovider tests/test_torch_kick_persistent.py``.
"""
import os

import pytest
import torch

from gravinv3dhmc_tpu_torch import f32_gemm_check, kick_tune
from gravinv3dhmc_tpu_torch.ops import _cuda
from gravinv3dhmc_tpu_torch.ops import leapfrog as tlf

LABELS = [*f32_gemm_check.SHAPES,
          f"realdata-fused, {kick_tune.RAGGED_CHAINS} chains"]


@pytest.fixture(scope="module")
def cases():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    baseline = os.environ.get("KICK_BASELINE")
    if not baseline:
        pytest.skip("KICK_BASELINE names no block-a-tile leapfrog.cu")
    _cuda.build_all(["leapfrog"])
    _cuda._LIBRARIES["current"] = _cuda._LIBRARIES["leapfrog"]
    kick_tune.build_baseline(baseline)
    yield kick_tune.f32_cases()
    kick_tune.use_library("current")


@pytest.mark.chip
@pytest.mark.parametrize("label", LABELS)
def test_f32_kick_equals_the_block_a_tile_kick(cases, label):
    op, C = cases[label]
    out = {}
    for lib in ("baseline", "current"):
        kick_tune.use_library(lib)
        a = kick_tune.f32_operands(op, C)
        tlf.KERNELS["kick_f32"](*a)
        torch.cuda.synchronize()
        out[lib] = a[3]
    kick_tune.use_library("current")
    assert torch.isfinite(out["current"]).all()
    assert torch.equal(out["current"].view(torch.int32),
                       out["baseline"].view(torch.int32))
