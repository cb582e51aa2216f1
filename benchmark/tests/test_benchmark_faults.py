"""The check fails a run whose timed path is broken underneath.

Each test drives a whole run on the CPU at the cell's tiny size, with the
program's chunk runner wrapped by a planted fault, and sees ``correct``
come out false. The faults a cell can have: a step that returns its
state unchanged, half of the batch left out, and an answer altered where
it is produced. (The cells run on one card: there is no exchange between
chips to leave out.)
"""
import pytest
import torch

from conftest import TINY, run_tiny


def _hmc_fault(kind):
    """Wraps the program's chunk runner: ``unchanged`` keeps every chain's
    state (and stores it), ``half_batch`` keeps the second half of the
    chains', ``altered`` scales every stored answer by 1.01."""
    def plant(s):
        real = s.run_chunk
        winv = torch.as_tensor(s.module.wdiag_inv)

        def run_chunk(carry, seed, chunk_idx):
            x0, U0, g0 = (t.clone() for t in carry[:3])
            new, stats = real(carry, seed, chunk_idx)
            x, U, g = new[:3]
            C = x.shape[0]
            keep = torch.zeros(C, dtype=torch.bool)
            keep[C // 2 if kind == "half_batch" else 0:] = kind in (
                "unchanged", "half_batch")
            k = keep[:, None]
            x, U, g = (torch.where(k, x0, x), torch.where(keep, U0, U),
                       torch.where(k, g0, g))
            buf = new[6]
            buf[keep] = (x0[keep] * winv.to(x0.dtype))[:, None]
            if kind == "altered":
                buf *= 1.01
            return (x, U, g) + tuple(new[3:]), stats

        s.run_chunk = run_chunk
    return plant


@pytest.mark.parametrize("kind", ("unchanged", "half_batch", "altered"))
@pytest.mark.parametrize("workload", sorted(TINY))
def test_hmc_fault_is_not_correct(workload, kind):
    line = run_tiny(workload, seed=21, fault=_hmc_fault(kind))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("workload", sorted(TINY))
def test_sound_run_is_correct(workload):
    line = run_tiny(workload, seed=21)
    assert line["correct"], line["checks"]
