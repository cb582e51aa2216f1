"""The ratiogrid slice: the reference's workload rebuilt by the port, and
a reduced ratiogrid built with the ``"pallas"`` backend (the gz kernel's
plain version on the CPU) and sampled through the per-step branch."""
import os
import sys

import numpy as np
import torch

from gravinv3dhmc_tpu_torch import ratiogrid
from gravinv3dhmc_tpu_torch.ops import prism

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "examples"))

import workloads as W  # noqa: E402

torch.set_num_threads(2)


def test_mesh_density_and_observations_are_the_workloads():
    """At full size: the mesh is 19 x 30 x 30 ratio-1.05 prisms with the
    workload's cell bounds, dyke complex and 900 observation points."""
    wl = W.ratiogrid()
    from gravinv3dhmc_tpu_torch import mesher, utils

    mesh = mesher.PrismMesh((0, 6000, 0, 6000, 0, 6000),
                            (200.0, 200.0, 200.0), ratiogrid.RATIO)
    assert mesh.shape == wl["mesh"].shape == (19, 30, 30)
    np.testing.assert_array_equal(mesh.cell_bounds(),
                                  wl["mesh"].cell_bounds())
    np.testing.assert_array_equal(
        ratiogrid.density_model(mesh.shape).ravel(), wl["rho"])
    for a, b in zip(utils.regular((0, 6000, 0, 6000), (30, 30), z=0.0),
                    wl["obs"]):
        np.testing.assert_array_equal(a, b)
    assert wl["rhomax"] == ratiogrid.RHO


def _numpy_draws(C, M, seed):
    """A draw source with L, normals and uniforms from numpy."""
    cache = {}

    def draws(chunk_idx, i):
        if (chunk_idx, i) not in cache:
            rng = np.random.RandomState([seed, chunk_idx, i])
            cache[chunk_idx, i] = (int(rng.randint(2, 6)),
                                   rng.randn(C, M).astype(np.float32),
                                   rng.uniform(size=C).astype(np.float32))
        return cache[chunk_idx, i]

    return draws


def test_reduced_ratiogrid_samples_through_the_per_step_branch():
    """12 x 12 observations over 12 x 12 x 9 prisms: the f32 matrix is
    within the f32 bound of the f64 one; one chunk through the per-step
    op stores finite samples of the expected shape, its stats carry the
    draw source's L, and the accepted counts are the sums of the flags."""
    module, dobs, seconds = ratiogrid.build_problem(device="cpu", n=12)
    M = module.n_active
    assert module.mshape == (9, 12, 12) and dobs.shape == (144,)
    assert module.A.dtype == np.float32
    # the build's parts: no device time of the gz kernel on the CPU
    assert set(seconds) == {"host_f64_s", "kernel_build_s", "to_host_s",
                            "weighting_s"}
    assert seconds["to_host_s"] <= seconds["kernel_build_s"]
    A64 = prism.prism_kernel_matrix("gz", module.lonobs, module.latobs,
                                    module.heightobs, module.mesh)
    assert np.abs(module.A - A64).max() <= 1e-3 * np.abs(A64).max()
    assert (np.linalg.norm(module.A - A64)
            <= 5e-3 * np.linalg.norm(A64))

    C, chunk, nsamples = 8, 6, 4
    draws = _numpy_draws(C, M, 5)
    run_chunk, carry, cfg = ratiogrid.step_sampler(
        module, dobs, "cpu", draws=draws, nchains=C, chunk=chunk,
        nsamples=nsamples)
    assert cfg["Lrange"] == (5, 20) and cfg["dt"] == 0.01
    carry, stats = run_chunk(carry, 0, 0)
    assert stats.shape == (chunk, C, 5)
    L = [draws(0, i)[0] for i in range(chunk)]
    np.testing.assert_array_equal(stats[..., 4].numpy(),
                                  np.repeat(np.array(L)[:, None], C, 1))
    np.testing.assert_array_equal(carry[5].numpy(),
                                  stats[..., 0].sum(0).numpy())
    assert 0 < stats[..., 0].mean() <= 1
    assert carry[6].shape == (C, nsamples, M)
    assert torch.isfinite(carry[0]).all() and torch.isfinite(carry[6]).all()
    # chain mode stores the last nsamples iterations' states, in reference
    # units: inside [0, 0.4] g/cm^3
    assert (carry[6] >= 0).all() and (carry[6] <= ratiogrid.RHO + 1e-6).all()


def test_run_chunks_counts_the_draws():
    """The timed loop: grad-evals are the chains times the drawn L of the
    timed chunks (the warm chunk 0 not counted), and the result is finite."""
    module, dobs, _ = ratiogrid.build_problem(device="cpu", n=10)
    C, chunk = 4, 3
    draws = _numpy_draws(C, module.n_active, 9)
    run_chunk, carry, _ = ratiogrid.step_sampler(
        module, dobs, "cpu", draws=draws, nchains=C, chunk=chunk,
        nsamples=chunk)
    res, _ = ratiogrid.run_chunks(run_chunk, carry, 0, 2, "cpu")
    L = sum(draws(c, i)[0] for c in (1, 2) for i in range(chunk))
    assert res["grad_evals"] == C * L
    assert res["iterations"] == 2 * chunk
    assert res["finite"] and 0 < res["accept_ratio"] <= 1
    assert res["samples_shape"] == [C, chunk, module.n_active]
    assert np.isfinite(res["ess_median"])
