"""Each cell on the card: a short window, its line well formed and
correct, and nothing of JAX loaded. Needs a CUDA card (``-m chip``)."""
import json
import subprocess
import sys

import pytest

from conftest import ROOT

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(card, workload, trace):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", "2147483999", "--seconds", "5", "--trace", str(trace)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
    if trace:
        assert line["device"]["busy_s"] > 0
        assert "breakdown" in line
    else:
        assert "setup_s" in line["metrics"]


def test_without_a_card_the_run_prints_nothing(tmp_path):
    """Alone in a directory with only the benchmark's files (no program),
    or without a card, a run exits non-zero and prints no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "uniformgrid-fused", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
