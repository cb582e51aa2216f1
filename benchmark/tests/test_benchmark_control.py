"""Each cell's control (``--control``) comes out not correct under the
cell's own limits, and the program comes out correct.

On the CPU at the tiny sizes: the float8 reference (uniformgrid-fused)
and the program's bf16 path (uniformgrid-f32). On the card (``-m chip``),
every cell at its own size on three seeds.
"""
import json
import subprocess
import sys

import pytest

from conftest import ROOT, TINY, run_tiny


@pytest.mark.parametrize("workload", sorted(TINY))
def test_control_fails_and_program_passes_at_tiny_size(workload):
    assert run_tiny(workload, seed=31)["correct"]
    line = run_tiny(workload, seed=31, control=True)
    assert not line["correct"], line["checks"]


@pytest.mark.chip
@pytest.mark.parametrize("seed", [2147483801, 2147483802, 2147483803])
@pytest.mark.parametrize(
    "workload", [w["name"] for w in
                 json.loads((ROOT / "BENCHMARK.json").read_text())[
                     "workloads"]])
def test_control_fails_on_the_card(card, workload, seed):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(seed), "--seconds", "10", "--trace", "0",
         "--control"], capture_output=True, text=True, timeout=600,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert not line["correct"], line["checks"]
