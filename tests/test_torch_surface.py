"""The port's public surface against the JAX package's.

* ``gravinv3dhmc_tpu_torch.compat`` re-exports what
  ``tests/test_api_surface.py::test_compat_package_exports`` asks of the
  JAX package's ``compat``.
* Every module of ``gravinv3dhmc_tpu`` has a counterpart at the same path
  under ``gravinv3dhmc_tpu_torch``, and each public function, class and
  class method defined there (read from the source with ``ast``) exists
  in it, except the entries of :data:`EXCLUDED`, each with its reason or
  its counterpart. No module is left for not being ported yet.
"""
import ast
import importlib
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "gravinv3dhmc_tpu")

#: module (path under the package) or "module:name" -> reason/counterpart
EXCLUDED = {
    "ops/leapfrog_pallas.py": "Pallas TPU kernels; their counterparts are "
                              "ops/leapfrog.py and csrc/leapfrog.cu",
    "ops/prism_pallas.py": "Pallas TPU kernel; its counterpart is "
                           "ops/prism_gz.py and csrc/prism_gz.cu",
    "diagnostics.py:ess_jax": "diagnostics.ess_torch",
    "inversion/chees.py:run_chees_chunked": "inversion/chees.run_chees "
                                            "(chunk_iters=)",
    "runtime/transfer.py": "TPU-link workaround (ROADMAP.md: not ported)",
    "runtime/compile_cache.py": "TPU-link workaround (ROADMAP.md: not "
                                "ported)",
    "bench.py:run_with_fallback": "TPU-link workaround (ROADMAP.md: not "
                                  "ported; a failing stage fails the run)",
}


def _modules():
    out = []
    for dirpath, _, files in os.walk(JAX_ROOT):
        for f in sorted(files):
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(dirpath, f),
                                           JAX_ROOT).replace(os.sep, "/"))
    return sorted(out)


def _public(path):
    """Public functions, classes and ``Class.method`` names defined at the
    top of ``path``."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    names = []
    for node in tree.body:
        if (isinstance(node, (ast.FunctionDef, ast.ClassDef))
                and not node.name.startswith("_")):
            names.append(node.name)
            if isinstance(node, ast.ClassDef):
                names += [f"{node.name}.{m.name}" for m in node.body
                          if isinstance(m, ast.FunctionDef)
                          and not m.name.startswith("_")]
    return names


def _port_module(rel):
    parts = rel[:-3].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(["gravinv3dhmc_tpu_torch"] + parts)


def test_compat_package_exports():
    from gravinv3dhmc_tpu_torch import compat
    for name in ("HamitonianMC", "HMCSample", "GravMagModule",
                 "JointModule"):
        assert hasattr(compat.inversion, name)
    for name in ("kernelcompressor", "modelcompressor", "prism",
                 "tesseroid", "tesseroidforward"):
        assert hasattr(compat.gravmag, name)
    for name in ("Prism", "Tesseroid", "PrismRelief", "PrismMesh",
                 "TesseroidMesh", "PrismMeshSegment",
                 "TesseroidMeshSegment"):
        assert hasattr(compat.mesher, name)
    from gravinv3dhmc_tpu_torch.compat.mesher import PrismMesh
    from gravinv3dhmc_tpu_torch.compat.utils import regular
    assert PrismMesh is compat.mesher.PrismMesh
    assert regular is compat.utils.regular
    assert hasattr(compat.vis, "mpl") and hasattr(compat.vis, "myv")
    # 1D shadows 3D at package level, as in the reference
    from gravinv3dhmc_tpu_torch.ops import wavelet
    assert compat.gravmag.kernelcompressor is wavelet.kernelcompressor_1d
    assert compat.gravmag.compressor3D.kernelcompressor is \
        wavelet.kernelcompressor_3d
    # everything resolves to the port
    assert compat.inversion.GravMagModule.__module__.startswith(
        "gravinv3dhmc_tpu_torch.")


def test_tesseroidforward_is_forward_only():
    import numpy as np

    from gravinv3dhmc_tpu_torch import mesher
    from gravinv3dhmc_tpu_torch.compat.gravmag import tesseroidforward
    from gravinv3dhmc_tpu_torch.ops import tesseroid

    mesh = mesher.TesseroidMesh((0, 10, 0, 10, 0, -20000), (-10000, 5, 5))
    mesh.addprop("density", np.arange(mesh.size, dtype=float))
    lon, lat = np.array([2.0, 7.0]), np.array([3.0, 8.0])
    h = np.full(2, 1000.0)
    res = tesseroidforward.gz(lon, lat, h, mesh)
    np.testing.assert_array_equal(res, tesseroid.gz(lon, lat, h, mesh)[0])
    assert tesseroidforward.gz.__name__ == "gz"
    assert tesseroidforward.RATIO_G == tesseroid.RATIO_G


@pytest.mark.parametrize("rel", _modules())
def test_every_public_name_has_a_counterpart(rel):
    if rel in EXCLUDED:
        assert rel.startswith(("ops/", "runtime/"))
        return
    port = importlib.import_module(_port_module(rel))
    missing = []
    for name in _public(os.path.join(JAX_ROOT, rel)):
        if f"{rel}:{name}" in EXCLUDED:
            continue
        obj = port
        for part in name.split("."):
            obj = getattr(obj, part, None)
        if obj is None:
            missing.append(name)
    assert not missing, f"{rel}: {missing}"


def test_exclusions_are_needed():
    """Every excluded name is defined by the JAX module and absent from the
    port's counterpart, and every excluded module has no counterpart, so
    the table cannot hide a name the port has since gained."""
    for key in EXCLUDED:
        rel, _, name = key.partition(":")
        assert os.path.isfile(os.path.join(JAX_ROOT, rel)), key
        if name:
            assert name in _public(os.path.join(JAX_ROOT, rel)), key
            port = importlib.import_module(_port_module(rel))
            assert not hasattr(port, name), key
        else:
            with pytest.raises(ModuleNotFoundError):
                importlib.import_module(_port_module(rel))
    not_yet = [k for k, why in EXCLUDED.items() if why.startswith("not yet")]
    assert not not_yet
