"""No run loads JAX or the JAX package, and the reference imports nothing
of the program."""
import ast
import json
import subprocess
import sys

from benchmark import harness
from conftest import ROOT

PORT = "gravinv3dhmc_tpu_torch"


def test_top_level_names_are_compared_whole():
    assert harness.forbidden_modules([PORT, PORT + ".ops", "numpy",
                                      "jaxtyping", "flaxen"]) == []
    assert harness.forbidden_modules(["gravinv3dhmc_tpu.ops", "jax._src",
                                      "jaxlib", "flax.linen"]) == [
        "flax", "gravinv3dhmc_tpu", "jax", "jaxlib"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((ROOT / "benchmark" / "reference").glob("*.py"))
    assert files
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "gravinv3dhmc_tpu",
                               PORT), (path.name, name)
            if top == "benchmark":
                assert name.startswith("benchmark.reference"), (path.name,
                                                                name)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT / 'benchmark' / 'tests')!r})\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from conftest import run_tiny\n"
        "from benchmark import harness\n"
        "run_tiny('uniformgrid-fused', seconds=0.2)\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
