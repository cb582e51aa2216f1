"""The uniformgrid slice helpers: the bench's problem and a profiled chunk
(on the CPU here: the fused ops take their plain versions and no device
time exists)."""
import numpy as np
import torch

from gravinv3dhmc_tpu_torch import uniformgrid
from gravinv3dhmc_tpu_torch.ops import leapfrog as tlf

torch.set_num_threads(2)


def test_density_model_is_the_bench_block():
    """At 20 x 30 x 10 the block is bench.py's rho[2:5, 10:18, 7:11]."""
    ref = np.zeros((10, 30, 20))
    ref[2:5, 10:18, 7:11] = 1.0
    np.testing.assert_array_equal(uniformgrid.density_model(20, 30, 10), ref)


def test_profile_chunk_on_cpu():
    """A profiled chunk of a tiny problem: the step count is the chunk's
    sum of L, no kernel launch is counted for CPU tensors and the device
    figures are absent, not zero."""
    module, dobs = uniformgrid.build_problem(8, 12, 4, device="cpu")
    assert dobs.shape == (96,) and module.n_active == 384
    chain = uniformgrid.sampler(module, dobs, "cpu", 8, 4, 0.01, (3, 6),
                                0.001, 0.001, torch.float32, seed=2)
    summary, _ = uniformgrid.profile_chunk(chain)
    assert summary["iterations"] == 4 and summary["chains"] == 8
    assert 4 * 3 <= summary["steps"] <= 4 * 6
    assert summary["wall_ms"] > 0
    assert summary["device_busy_ms"] is None
    assert summary["busy_share"] is None
    assert summary["device_ms_by_owner"] is None
    assert summary["launches"] == {name: 0 for name in tlf.KERNELS}
    # the profiler turned the program's spans on for the profiled chunk:
    # host self time by span, no device idle without a card
    host = {name: (ms, n) for name, ms, n in summary["host_ms_by_span"]}
    assert host["hmc.chunk"][1] == 1 and host["hmc.iteration"][1] == 4
    assert host["kernel.kick_f32"][1] == summary["steps"]
    assert sum(ms for ms, _ in host.values()) <= summary["wall_ms"]
    assert summary["idle_ms_by_span"] is None


def test_padded_fused_carry_matches_unfused_path():
    """At 180 cells (padded to 256 lanes) the fused-iteration sampler,
    which keeps its carry lane-padded through each chunk, takes the same
    accept decisions as the unfused shared-L path over two chunks (the
    same Philox draws), with samples within f32 summation-order error."""
    module, dobs = uniformgrid.build_problem(6, 10, 3, device="cpu")
    assert module.n_active == 180
    runs = []
    for fused in (True, False):
        chain = uniformgrid.sampler(module, dobs, "cpu", 16, 8, 0.05, (3, 8),
                                    0.001, 0.001, torch.float32, seed=3,
                                    initial=0.3)
        chain.use_fused = fused
        runs.append(chain.sample(8, 8))
    fused, plain = runs
    assert fused["fused_mode"] == "iteration(float32)"
    assert fused["samples"].shape == (16, 8, 180)
    assert 0 < fused["accept_ratio"] < 1
    assert fused["accepted"] == plain["accepted"]
    np.testing.assert_allclose(fused["samples"].numpy(),
                               plain["samples"].numpy(), rtol=5e-3,
                               atol=5e-4)
