"""The least-time counts from the configurations' shapes."""
import pytest

from benchmark import roofline


def test_uniformgrid_bf16_step():
    nbytes, flops = roofline.hmc_step(1024, 600, 6000, "bfloat16")
    assert nbytes == 600 * 6000 * 2 + 4 * 1024 * 6000 * 4 == 105_504_000
    assert flops == 4 * 1024 * 600 * 6000
    assert roofline.least_s(nbytes, flops) == pytest.approx(
        105_504_000 / 3.35e12)            # 31.5 us: bound by bytes


def test_uniformgrid_f32_step_counts_the_bf16_peak():
    nbytes, flops = roofline.hmc_step(1024, 600, 6000, "float32")
    assert nbytes == 600 * 6000 * 4 + 4 * 1024 * 6000 * 4
    assert roofline.least_s(nbytes, flops) == pytest.approx(
        112_704_000 / 3.35e12)


def test_few_chains_on_a_large_matrix_are_bound_by_its_bytes():
    nbytes, flops = roofline.hmc_step(32, 7381, 72000, "float32")
    assert roofline.least_s(nbytes, flops) == pytest.approx(
        (7381 * 72000 * 4 + 4 * 32 * 72000 * 4) / 3.35e12)  # 0.646 ms


def test_flops_bound_when_the_bytes_are_few():
    assert roofline.least_s(1, 989e12) == pytest.approx(1.0)
