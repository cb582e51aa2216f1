"""The port's f32 prism-gz builder (the plain PyTorch version of the CUDA
``gz`` kernel) against the JAX package's Pallas ``_gz_tile_kernel`` run
in interpret mode and against the f64 host builder.

Observation points lie on a grid right above cell corners and edges, so
the guarded branches (log(0), atan2 with x == 0 or y == 0) are taken.

Tolerances (f32 cancels in the corner differences of distant cells, so
an f32 matrix is held against f64 relative to max|A| and in Frobenius
norm, never column by column): against f64, 1e-3 of max|A| elementwise
and 5e-3 relative Frobenius; the port against the JAX kernel, which
evaluates the same corner formula in f32 with a polynomial atan and
log(a + r) summed as written (the port takes it as (b^2 + c^2)/(r - a)
for a < 0, where it cancels), 2.5e-4 of max|A| and 2.5e-4 relative
Frobenius. At these sizes each f32 build misses f64 by 4-7e-5 (both
measures), and the two f32 builds differ from each other by as much,
since each rounds the cancelling corner sums its own way.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gravinv3dhmc_tpu import mesher as jmesher
from gravinv3dhmc_tpu.inversion.potential import GravMagModule as JModule
from gravinv3dhmc_tpu.ops import prism as jprism
from gravinv3dhmc_tpu.ops.prism_pallas import gz_kernel_matrix_pallas
from gravinv3dhmc_tpu_torch import constants, mesher, utils
from gravinv3dhmc_tpu_torch.inversion.potential import GravMagModule
from gravinv3dhmc_tpu_torch.ops import _cuda, prism, prism_gz

torch.set_num_threads(2)

BOUNDS = (0, 800, 0, 1200, 0, 400)
F64_MAX, F64_FRO = 1e-3, 5e-3
JAX_MAX, JAX_FRO = 2.5e-4, 2.5e-4


def _errors(got, ref):
    """(max |got - ref| / max |ref|, ||got - ref||_F / ||ref||_F)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return (np.abs(got - ref).max() / np.abs(ref).max(),
            np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _problem(spacing, ratio, z):
    mesh = mesher.PrismMesh(BOUNDS, spacing, ratio)
    xo, yo, zo = utils.regular((0, 800, 0, 1200), (9, 13), z=z)
    return mesh, xo, yo, zo


@pytest.mark.parametrize("spacing,ratio,z", [
    ((100, 100, 100), 1, 0.0), ((50, 100, 200), 1.3, 0.0),
    ((100, 100, 100), 1, -20.0)])
def test_plain_gz_matches_jax_pallas_and_f64(spacing, ratio, z):
    mesh, xo, yo, zo = _problem(spacing, ratio, z)
    cells = mesh.cell_bounds(only_active=True)
    obs = np.stack([xo, yo, zo], axis=1)
    scale = constants.G * constants.SI2MGAL
    A64 = prism.prism_kernel_matrix("gz", xo, yo, zo, mesh)
    At = prism.prism_kernel_matrix("gz", xo, yo, zo, mesh, backend="pallas",
                                   device="cpu")
    assert At.dtype == np.float32 and At.shape == A64.shape
    # as the JAX package's own pallas branch runs it (ops/prism.py:247-255)
    with jax.enable_x64(False):
        Aj = np.asarray(gz_kernel_matrix_pallas(
            jnp.asarray(obs, jnp.float32), jnp.asarray(cells, jnp.float32),
            np.float32(scale), interpret=True))
    # the port's plain version is the whole path on the CPU
    direct = prism_gz.gz_plain(torch.as_tensor(obs, dtype=torch.float32),
                               torch.as_tensor(cells, dtype=torch.float32),
                               float(np.float32(scale)))
    np.testing.assert_array_equal(direct.numpy(), At)
    for got, ref, lim in ((At, A64, (F64_MAX, F64_FRO)),
                          (Aj, A64, (F64_MAX, F64_FRO)),
                          (At, Aj, (JAX_MAX, JAX_FRO))):
        e_max, e_fro = _errors(got, ref)
        assert e_max <= lim[0] and e_fro <= lim[1], (e_max, e_fro)


def test_guarded_branches_are_taken():
    """At z = 0 on the grid of cell corners both guards fire: dz == 0 on
    the top corners (atan2 with x == 0), dx == 0 or dy == 0 (y == 0) and
    r == 0 right at a corner (log(0))."""
    mesh, xo, yo, zo = _problem((100, 100, 100), 1, 0.0)
    cells = mesh.cell_bounds(only_active=True)
    hits = {"dx0": 0, "dz0": 0, "r0": 0}
    for x, y, z in zip(xo, yo, zo):
        dx = cells[:, :2] - x
        dy = cells[:, 2:4] - y
        dz = cells[:, 4:6] - z
        hits["dx0"] += int((dx == 0).sum())
        hits["dz0"] += int((dz == 0).sum())
        hits["r0"] += int(((dx == 0).any(1) & (dy == 0).any(1)
                           & (dz == 0).any(1)).sum())
    assert all(v > 0 for v in hits.values()), hits
    A = prism.prism_kernel_matrix("gz", xo, yo, zo, mesh, backend="pallas",
                                  device="cpu")
    assert np.isfinite(A).all()


def test_module_pallas_backend_matches_jax():
    """``GravMagModule(kernel_backend="pallas")`` in both packages: the
    f32 matrix is weighted in numpy, so ``wdiag`` and ``Aw`` come out f32
    in both and agree within the bound, as does the port's against its
    f64 build."""
    spacing = (50, 100, 200)
    obs = utils.regular((0, 800, 0, 1200), (9, 13), z=0.0)
    dobs = np.random.RandomState(0).randn(obs[0].size)
    jm = JModule(dobs, BOUNDS, spacing, obs, mratio=1.3,
                 kernel_backend="pallas", verbose=False)
    tm = GravMagModule(dobs, BOUNDS, spacing, obs, mratio=1.3,
                       kernel_backend="pallas", verbose=False, device="cpu")
    t64 = GravMagModule(dobs, BOUNDS, spacing, obs, mratio=1.3,
                        verbose=False, device="cpu")
    assert tm.Aw.dtype == np.float32 and tm.wdiag.dtype == np.float32
    assert np.asarray(jm.Aw).dtype == np.float32
    assert tm.kernel_build_s >= 0
    for name in ("A", "Aw", "wdiag"):
        got, ref = getattr(tm, name), np.asarray(getattr(jm, name))
        e_max, e_fro = _errors(got, ref)
        assert e_max <= JAX_MAX and e_fro <= JAX_FRO, (name, e_max, e_fro)
        e_max, e_fro = _errors(got, getattr(t64, name))
        assert e_max <= F64_MAX and e_fro <= F64_FRO, (name, e_max, e_fro)


def test_gz_kernel_is_registered_and_cpu_takes_plain():
    _cuda.reset_launch_counts()
    k = _cuda.KERNELS["gz"]
    assert k.replaces.startswith("gravinv3dhmc_tpu/ops/prism_pallas.py")
    assert k.source == "gravinv3dhmc_tpu_torch/csrc/prism_gz.cu"
    mesh = jmesher.PrismMesh(BOUNDS, (100, 100, 100))
    out = prism_gz.gz_kernel_matrix([[0.0, 0.0, -1.0]],
                                    mesh.cell_bounds(), 2.0, "cpu")
    assert out.shape == (1, mesh.size) and out.device.type == "cpu"
    assert k.launches == 0
    with pytest.raises(ValueError):
        k(torch.empty(3, 3, device="meta"), torch.empty(2, 6, device="meta"),
          1.0)
    # scale 2.0 in place of G * SI2MGAL
    ref = (2.0 / (constants.G * constants.SI2MGAL)) * jprism.\
        prism_kernel_matrix("gz", [0.0], [0.0], [-1.0], mesh)[0]
    np.testing.assert_allclose(out.numpy()[0], ref, rtol=0,
                               atol=F64_MAX * np.abs(ref).max())
