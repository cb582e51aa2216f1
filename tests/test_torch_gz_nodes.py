"""The node form of the port's f32 prism-gz builder: ``node_tables``,
the dispatcher ``gz_plan`` and ``gz_nodes_plain`` (the plain version of the
CUDA ``gz_nodes`` kernel) against the corner form's plain version, the JAX
package's Pallas ``_gz_tile_kernel`` run in interpret mode and the f64
host builder.

Tolerances: against f64 and against the JAX kernel as
``test_torch_prism_gz.py`` states them. The node form against the corner
form: the same f32 corner terms summed in the same order, so equal but for
the ulps by which the CPU's vectorised and scalar logarithm and arctangent
may differ on tensors of other shapes; 1e-6 of max|A|. (On the card the
two kernels are held bit for bit by ``chip_smoke.py``.)
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gravinv3dhmc_tpu.ops.prism_pallas import gz_kernel_matrix_pallas
from gravinv3dhmc_tpu_torch import constants, mesher, ratiogrid, utils
from gravinv3dhmc_tpu_torch.ops import _cuda, prism, prism_gz

torch.set_num_threads(2)

BOUNDS = (0, 800, 0, 1200, 0, 400)
F64_MAX, F64_FRO = 1e-3, 5e-3
JAX_MAX, JAX_FRO = 2.5e-4, 2.5e-4
NODES_MAX = 1e-6
SCALE = float(np.float32(constants.G * constants.SI2MGAL))


def _errors(got, ref):
    """(max |got - ref| / max |ref|, ||got - ref||_F / ||ref||_F)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return (np.abs(got - ref).max() / np.abs(ref).max(),
            np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _obs(z=0.0):
    xo, yo, zo = utils.regular((0, 800, 0, 1200), (9, 13), z=z)
    return xo, yo, zo, np.stack([xo, yo, zo], axis=1)


def _both_forms(obs, cells32):
    """(node form, corner form) of the plain f32 matrix of ``cells32``."""
    o = torch.as_tensor(obs, dtype=torch.float32)
    tables = prism_gz.node_tables(cells32)
    nodes = prism_gz.gz_nodes_plain(o, *prism_gz.node_args(tables, "cpu"),
                                    SCALE)
    corner = prism_gz.gz_plain(o, torch.as_tensor(cells32), SCALE)
    return nodes.numpy(), corner.numpy()


def test_ratiogrid_node_tables():
    """ratiogrid's 17,100 cells have 31 x 31 x 20 = 19,220 distinct f32
    nodes: the layer faces differ in f64 (ztop and zbot are computed apart)
    and coincide after the cast, so each is one node. The cells keep mesh
    order, grouped by layer, and span one plane."""
    mesh, _ = ratiogrid.mesh_and_obs()
    assert not np.array_equal(mesh.ztop[1:], mesh.zbot[:-1])
    np.testing.assert_array_equal(mesh.ztop[1:].astype(np.float32),
                                  mesh.zbot[:-1].astype(np.float32))
    cells = mesh.cell_bounds(only_active=True)
    name, t = prism_gz.gz_plan(cells)
    assert name == "gz_nodes"
    assert (len(t.ux), len(t.uy), len(t.uz)) == (31, 31, 20)
    assert t.n_nodes == 19220 and t.span == 1
    assert prism_gz.node_smem_bytes(t) == 4 * (
        3 * 31 * 31 + 31 + 31 + 20 + 21)
    np.testing.assert_array_equal(t.cells[:, 3], np.arange(17100))
    np.testing.assert_array_equal(t.offsets, np.r_[0, np.arange(20) * 900])
    # each cell's words name its own bounds, the upper one first
    w = t.cells.view(np.uint32)
    c32 = cells.astype(np.float32)
    for a, u in enumerate((t.ux, t.uy, t.uz)):
        np.testing.assert_array_equal(u[w[:, a] & 0xFFFF], c32[:, 2 * a + 1])
        np.testing.assert_array_equal(u[w[:, a] >> 16], c32[:, 2 * a])


@pytest.mark.parametrize("spacing,ratio,z", [
    ((100, 100, 100), 1, 0.0), ((50, 100, 200), 1.3, 0.0),
    ((100, 100, 100), 1, -20.0)])
def test_nodes_plain_matches_corner_jax_pallas_and_f64(spacing, ratio, z):
    """On the meshes of ``test_plain_gz_matches_jax_pallas_and_f64``: the
    prism builder's device path takes the node form, which matches the
    corner form, the JAX kernel (interpret mode) and the f64 builder."""
    mesh = mesher.PrismMesh(BOUNDS, spacing, ratio)
    xo, yo, zo, obs = _obs(z)
    cells = mesh.cell_bounds(only_active=True)
    assert prism_gz.gz_plan(cells)[0] == "gz_nodes"
    nodes, corner = _both_forms(obs, cells.astype(np.float32))
    At = prism.prism_kernel_matrix("gz", xo, yo, zo, mesh, backend="pallas",
                                   device="cpu")
    np.testing.assert_array_equal(At, nodes)
    A64 = prism.prism_kernel_matrix("gz", xo, yo, zo, mesh)
    with jax.enable_x64(False):
        Aj = np.asarray(gz_kernel_matrix_pallas(
            jnp.asarray(obs, jnp.float32), jnp.asarray(cells, jnp.float32),
            np.float32(constants.G * constants.SI2MGAL), interpret=True))
    assert _errors(nodes, corner)[0] <= NODES_MAX
    for ref, lim in ((A64, (F64_MAX, F64_FRO)), (Aj, (JAX_MAX, JAX_FRO))):
        e_max, e_fro = _errors(nodes, ref)
        assert e_max <= lim[0] and e_fro <= lim[1], (e_max, e_fro)


@pytest.mark.parametrize("axis", [0, 2])
def test_one_ulp_apart_faces_stay_apart(axis):
    """A face moved by one f32 ulp (x: the upper x bound of one column; z:
    the top of one layer) becomes a node of its own, the cells beside it
    keep theirs, and the matrix is still right."""
    mesh = mesher.PrismMesh(BOUNDS, (100, 100, 100))
    cells = mesh.cell_bounds(only_active=True).astype(np.float32)
    base = prism_gz.node_tables(cells)
    col = 2 * axis + (1 if axis == 0 else 0)
    pick = cells[:, col] == (400 if axis == 0 else 200)
    cells[pick, col] = np.nextafter(cells[pick, col], np.float32(np.inf))
    t = prism_gz.node_tables(cells)
    grown = [len(t.ux) - len(base.ux), len(t.uy) - len(base.uy),
             len(t.uz) - len(base.uz)]
    assert grown == [1 if a == axis else 0 for a in range(3)]
    assert t.span == 1 and prism_gz.gz_plan(cells)[0] == "gz_nodes"
    xo, yo, zo, obs = _obs()
    nodes, corner = _both_forms(obs, cells)
    A64 = prism.prism_kernel_matrix("gz", xo, yo, zo, cells.astype(float))
    assert _errors(nodes, corner)[0] <= NODES_MAX
    e_max, e_fro = _errors(nodes, A64)
    assert e_max <= F64_MAX and e_fro <= F64_FRO, (e_max, e_fro)


def test_a_cell_across_two_planes_widens_the_ring():
    """Two columns of different layering: one cell spans two planes of
    the other column's faces, so the ring holds three planes; the cells
    stay grouped by their upper z node."""
    cells = np.array([[0, 100, 0, 100, 0, 100], [0, 100, 0, 100, 100, 200],
                      [100, 200, 0, 100, 0, 200]], np.float32)
    t = prism_gz.node_tables(cells)
    assert t.span == 2 and list(t.uz) == [0, 100, 200]
    np.testing.assert_array_equal(t.offsets, [0, 0, 1, 3])
    np.testing.assert_array_equal(t.cells[:, 3], [0, 1, 2])
    xo, yo, zo, obs = _obs()
    nodes, corner = _both_forms(obs, cells)
    assert _errors(nodes, corner)[0] <= NODES_MAX


def test_carved_mesh_takes_the_node_form():
    """A mesh carved by topography (holes in the upper layers): the active
    cells still share their nodes, and the node form is right."""
    mesh = mesher.PrismMesh(BOUNDS, (100, 100, 100))
    gx, gy = np.meshgrid(np.linspace(0, 800, 9), np.linspace(0, 1200, 13))
    mesh.carvetopo(gx.ravel(), gy.ravel(), -(gx.ravel() / 800.0) * 250.0)
    assert 0 < mesh.n_active < mesh.size
    cells = mesh.cell_bounds(only_active=True)
    name, t = prism_gz.gz_plan(cells)
    assert name == "gz_nodes" and len(t.cells) == mesh.n_active
    xo, yo, zo, obs = _obs()
    nodes, corner = _both_forms(obs, cells.astype(np.float32))
    A64 = prism.prism_kernel_matrix("gz", xo, yo, zo, mesh)
    assert _errors(nodes, corner)[0] <= NODES_MAX
    e_max, e_fro = _errors(nodes, A64)
    assert e_max <= F64_MAX and e_fro <= F64_FRO, (e_max, e_fro)


@pytest.mark.parametrize("case", ["jittered", "ring too large",
                                  "z bounds reversed"])
def test_other_cell_sets_take_the_corner_form(case):
    """The corner kernel where the node form does not pay or fit: cells
    that share no face (every bound jittered), a plane ring beyond a
    block's shared memory (200 x 200 columns), a cell whose z bounds are
    reversed. The device builder's CPU path then gives the corner form's
    matrix."""
    if case == "jittered":
        mesh = mesher.PrismMesh(BOUNDS, (100, 100, 100))
        cells = mesh.cell_bounds(only_active=True)
        cells = cells + np.random.RandomState(0).uniform(0, 0.5, cells.shape)
    elif case == "ring too large":
        cells = mesher.PrismMesh((0, 2000, 0, 2000, 0, 20),
                                 (10, 10, 10)).cell_bounds()
    else:
        cells = mesher.PrismMesh(BOUNDS, (100, 100, 100)).cell_bounds()
        cells[5, 4:] = cells[5, 5], cells[5, 4]
    name, t = prism_gz.gz_plan(cells)
    assert name == "gz"
    if case == "ring too large":
        assert t.n_nodes <= 4 * len(cells)
        assert prism_gz.node_smem_bytes(t) > prism_gz.NODE_SMEM
    _, _, _, obs = _obs(-20.0)
    got = prism_gz.gz_kernel_matrix(obs[:5], cells, SCALE, "cpu")
    ref = prism_gz.gz_plain(torch.as_tensor(obs[:5], dtype=torch.float32),
                            torch.as_tensor(cells, dtype=torch.float32),
                            SCALE)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_gz_nodes_is_registered_and_cpu_takes_plain():
    _cuda.reset_launch_counts()
    k = _cuda.KERNELS["gz_nodes"]
    assert k.replaces == _cuda.KERNELS["gz"].replaces
    assert k.replaces.startswith("gravinv3dhmc_tpu/ops/prism_pallas.py")
    assert k.source == "gravinv3dhmc_tpu_torch/csrc/prism_gz.cu"
    mesh = mesher.PrismMesh(BOUNDS, (100, 100, 100))
    out = prism_gz.gz_kernel_matrix([[0.0, 0.0, -1.0]], mesh.cell_bounds(),
                                    2.0, "cpu")
    assert out.shape == (1, mesh.size) and out.device.type == "cpu"
    assert _cuda.launch_counts()["gz_nodes"] == 0
    assert _cuda.launch_counts()["gz"] == 0
    t = prism_gz.node_tables(mesh.cell_bounds())
    with pytest.raises(ValueError):
        k(torch.empty(3, 3, device="meta"),
          *prism_gz.node_args(t, "meta"), 2.0)
