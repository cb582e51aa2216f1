"""The harness finds every part by name, and a new part is a new file."""
import json
import shutil

import pytest

from benchmark import harness
from conftest import ROOT, TINY_FUSED, TINY_GRID


def test_every_cell_resolves_its_parts():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell in bench["workloads"]:
        _, config, traffic, e2e, per_layer = harness.find_cell(
            ROOT, cell["name"])
        assert harness.load_code(ROOT, "problems", config["problem"])
        assert harness.load_code(ROOT, "drivers", traffic["driver"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and per_layer
        for m in e2e + per_layer:
            assert callable(harness.load_code(ROOT, "metrics",
                                              m["name"]).read)


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.find_cell(ROOT, "no-such-cell")


def test_new_configuration_traffic_and_metric_as_files(tmp_path):
    """A throwaway configuration, traffic mix and metric, each a new file
    in another checkout, run by the harness with no file edited."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for kind in ("configs", "traffic", "metrics"):
        (tmp_path / "benchmark" / kind).mkdir(parents=True)
    cfg = json.loads((ROOT / "benchmark/configs/uniformgrid.json")
                     .read_text())
    cfg.update(TINY_GRID)
    (tmp_path / "benchmark/configs/tinygrid.json").write_text(
        json.dumps(cfg))
    tr = json.loads((ROOT / "benchmark/traffic/fused-bf16.json")
                    .read_text())
    tr.update(TINY_FUSED, chains=8)
    (tmp_path / "benchmark/traffic/fused-tiny.json").write_text(
        json.dumps(tr))
    (tmp_path / "benchmark/metrics/iterations_per_s.py").write_text(
        "def read(rec):\n"
        "    if not rec.get('proposals'):\n"
        "        return None\n"
        "    return rec['proposals'] / 8 / rec['window_s']\n")
    bench["configs"].append({"name": "tinygrid", "source": "a test",
                             "file": "benchmark/configs/tinygrid.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tinygrid-fused",
                               "config": "tinygrid",
                               "traffic": "fused-tiny", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "iterations_per_s",
                                "unit": "iters/s", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["tinygrid-fused"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in (ROOT / "benchmark").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts
              and ".cache" not in p.parts}
    line = harness.run_cell(tmp_path, "tinygrid-fused", 3, 0.3, 0,
                            device="cpu")
    assert line["correct"]
    assert set(line["metrics"]) == {"setup_s", "iterations_per_s"}
    assert line["metrics"]["iterations_per_s"]["value"] > 0
    after = {p: p.read_bytes() for p in before}
    assert before == after
    shutil.rmtree(tmp_path)
