"""The benchmark's own tests: CPU at tiny sizes, and a few that need the
card (marked ``chip``; they skip without one)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "chip: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    """Skips the test unless PyTorch sees a CUDA card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


#: a 8 x 6 grid of stations over 3 x 6 x 8 prisms (the uniformgrid
#: configuration's layout at a size the CPU runs in a second)
TINY_GRID = {"area": [0.0, 700.0, 0.0, 500.0], "grid": [8, 6],
             "shape": [3, 6, 8],
             "body": {"z": [1, 2], "y": [2, 4], "x": [3, 5],
                      "density": 1.0}}
TINY_FUSED = {"chains": 16, "chunk": 8, "stride": 1, "check_iters": 4,
              "burn_in_chunks": 2, "trace_chunks": 1, "check_chains": 8,
              "check_spans": 4}
#: (workload, configuration override, traffic override) of every cell
TINY = {"uniformgrid-fused": (TINY_GRID, TINY_FUSED),
        "uniformgrid-f32": (TINY_GRID, TINY_FUSED)}


def run_tiny(workload, seed=11, seconds=0.5, trace=0, control=False,
             root=ROOT, traffic=None, fault=None):
    """One run of ``workload`` on the CPU at its tiny size."""
    from benchmark import harness
    cfg, tr = TINY[workload]
    return harness.run_cell(root, workload, seed, seconds, trace,
                            device="cpu", control=control,
                            config_override=cfg,
                            traffic_override=dict(tr, **(traffic or {})),
                            fault=fault)
