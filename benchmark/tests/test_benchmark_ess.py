"""The copied ESS estimator against series worked out by hand."""
import pytest
import torch

from benchmark.reference.ess import ess, median


def test_alternating_series_by_hand():
    # one chain 0, 1, 0, 1: acov = 1/4, -3/16, 1/8, -1/16; var+ = 1/3;
    # rho_1 = -5/16, rho_2 = 5/8; the one pair 5/16 >= 0, so
    # tau = 1 + 2 * 5/16 = 13/8 and ESS = 4 / (13/8)
    x = torch.tensor([[0.0, 1.0, 0.0, 1.0]], dtype=torch.float64)[..., None]
    assert float(ess(x)[0]) == pytest.approx(4 / 1.625, rel=1e-12)


def test_constant_chains_count_every_draw():
    x = torch.ones((3, 10, 2), dtype=torch.float64)
    assert ess(x).tolist() == [30.0, 30.0]


def test_chains_without_variance_count_every_draw():
    # within-chain variance 0: the estimator counts C N, apart or not
    x = torch.zeros((2, 8, 1), dtype=torch.float64)
    x[1] = 1.0
    assert ess(x).tolist() == [16.0]


def test_two_chains_pool_their_correlograms():
    # 0, 1, 0, 1 and 1, 0, 1, 0 have the same correlogram as one of them
    x = torch.tensor([[0.0, 1.0, 0.0, 1.0], [1.0, 0.0, 1.0, 0.0]],
                     dtype=torch.float64)[..., None]
    assert float(ess(x)[0]) == pytest.approx(8 / 1.625, rel=1e-12)


def test_median_takes_the_mean_of_the_middle_two():
    assert median(torch.tensor([4.0, 1.0, 3.0, 2.0])) == 2.5
    assert median(torch.tensor([5.0, 1.0, 3.0])) == 3.0
