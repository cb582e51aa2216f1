"""The port's multi-device HMC (``gravinv3dhmc_tpu_torch/parallel``) on the
CPU over gloo, against the JAX package's sharded functions and the
unsharded port.

The ranks are real processes (``tests/test_torch_parallel_worker.py``):
one group each for the meshes (1, 2), (2, 2) and (1, 4), all started
together once for this module, joined by a ``file://`` rendezvous, each
rank on its block. Rank 0 writes the gathered global results, which the
tests here read:

* the sharded potential in float64 on the JAX tests' 8 x 8 x 4 problem
  (``tests/test_parallel.py``): Damping, MS with Wm^2 (its u_model too),
  Smoothness and TV on the full grid (the z-halo branch: one plane a
  shard at (1, 4)), on the carved mesh and on an nz = 3 grid the 'model'
  axis does not tile (the replicated branch), against the JAX sharded
  potential on the conftest's virtual devices at the same mesh shape
  (``u`` rtol 1e-10, ``g`` rtol 1e-8 atol 1e-12, the JAX tests' bounds);
* the sharded chunk sampler fed the JAX sampler's own draws (shared L,
  Welford moments, the chain store thinned by 2, a runtime dt and inverse
  mass; ``test_sharded_chunk_feature_parity_with_single_device``'s run)
  against the JAX sharded one: identical accept counts, the state, the
  store and the moments within 1e-9 relative, and the pooled metric switch;
* ``HamiltonianMC.sample`` under the mesh with its own Philox draws (one L
  a chain) and with the windowed warmup (``adapt_mass``) against the
  unsharded port: identical accept counts, the same step size and inverse
  mass (1e-12 relative), samples within 1e-9;
* snapshots: a sharded run's snapshot resumes unsharded, an unsharded
  run's resumes sharded, both to the uninterrupted run, and the JAX
  ``load_state`` reads the sharded one;
* ``run.py --multichip`` over the group: rank 0's line has the JAX
  ``examples/run.py --multichip`` line's keys; the other ranks print
  nothing;
* the lockstep check raises on every rank of a chain group whose accept
  counts differ; ``chains_for_host`` / ``host_seed`` by rank.

In-process: the mesh shapes against ``jax`` ``make_mesh``, ``draws`` at a
shard's offsets against the block of a full draw bit for bit, the NCCL
check, a one-rank mesh (no process group) bit for bit equal to the
unsharded sample, and ``--multichip`` at world size 1 equal to the run
without it.
"""
import importlib.util
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import random

from gravinv3dhmc_tpu import checkpoint as jcheckpoint
from gravinv3dhmc_tpu import mesher as jmesher
from gravinv3dhmc_tpu import utils as jutils
from gravinv3dhmc_tpu.inversion.potential import GravMagModule as JModule
from gravinv3dhmc_tpu.ops import prism as jprism
from gravinv3dhmc_tpu.parallel import make_mesh as jmake_mesh
from gravinv3dhmc_tpu.parallel import make_sharded_chunk_sampler as jchunk
from gravinv3dhmc_tpu.parallel import make_sharded_potential as jpotential
from gravinv3dhmc_tpu.parallel import welford_metric_switch as jswitch
from gravinv3dhmc_tpu_torch import run as trun
from gravinv3dhmc_tpu_torch import workloads as TW
from gravinv3dhmc_tpu_torch.inversion import hmc as thmc
from gravinv3dhmc_tpu_torch.ops import leapfrog as tlf
from gravinv3dhmc_tpu_torch.ops import philox
from gravinv3dhmc_tpu_torch.parallel import multihost, sharded

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
_spec = importlib.util.spec_from_file_location(
    "torch_parallel_worker", os.path.join(HERE,
                                          "test_torch_parallel_worker.py"))
worker = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(worker)

#: tag -> (chains, model)
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
#: the group's own timeout and, longer, each worker's (the ranks take
#: about 30 s here alone; the driver's run shares the cores)
GROUP_TIMEOUT_S, WORKER_TIMEOUT_S = 120, 300
#: float64 tolerances: the JAX tests' for the potential, the JAX parity
#: test's for a chunk, and for the adapted kernel's numbers
U_RTOL, G_RTOL, G_ATOL, STATE_RTOL, KERNEL_RTOL = 1e-10, 1e-8, 1e-12, 1e-9, \
    1e-12


def _jax_problem(nz=4, carved=False):
    bounds, spacing, obs, mtopo = worker.problem_geometry(nz, carved)
    mesh = jmesher.PrismMesh(bounds, spacing)
    rho3 = np.zeros(mesh.shape)
    rho3[1:3, 3:6, 3:6] = 1.0
    mesh.addprop("density", rho3.ravel())
    xo, yo, zo = jutils.regular((0, 800, 0, 800), (8, 8), z=0.0)
    dobs, _ = jprism.gz(xo, yo, zo, mesh)
    kw = {} if mtopo is None else {"mtopo": mtopo}
    module = JModule(dobs, bounds, spacing, (xo, yo, zo), verbose=False,
                     **kw)
    return module, np.asarray(dobs)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(
        np.abs(np.asarray(b)).max(), 1e-30)


def _jax_chunk_draws(M):
    """The JAX sampler's own draws of the chunk run: chunks 0 and 1 of
    base key ``PRNGKey(7)`` (``fold_in`` -> ``split`` -> ``split(key, 3)``,
    float64)."""
    c = worker.CHUNK
    L = np.zeros((2, c["chunk_size"]), np.int64)
    n01 = np.zeros((2, c["chunk_size"], c["nchains"], M))
    u = np.zeros((2, c["chunk_size"], c["nchains"]))
    base = random.PRNGKey(7)
    for ci in range(2):
        for i, k in enumerate(random.split(random.fold_in(base, ci),
                                           c["chunk_size"])):
            kL, kp, ku = random.split(k, 3)
            L[ci, i] = int(random.randint(kL, (), c["Lmin"], c["Lmax"] + 1))
            n01[ci, i] = np.asarray(random.normal(kp, (c["nchains"], M),
                                                  jnp.float64))
            u[ci, i] = np.asarray(random.uniform(ku, (c["nchains"],),
                                                 jnp.float64))
    return L, n01, u


def _port_run(module, dobs, **kw):
    chain = worker.configure(thmc.HamiltonianMC(module), module, dobs,
                             dtype=torch.float64)
    for k, v in kw.items():
        setattr(chain, k, v)
    return chain


@pytest.fixture(scope="module")
def problems():
    return {"full": _jax_problem(), "carved": _jax_problem(carved=True),
            "nz3": _jax_problem(nz=3)}


@pytest.fixture(scope="module")
def launched(problems, tmp_path_factory):
    """The inputs and the unsharded snapshot written, then every rank of
    every mesh started at once: ``(dir, {tag: [Popen]})``."""
    d = str(tmp_path_factory.mktemp("parallel"))
    inputs = {}
    for name, (module, dobs) in problems.items():
        M = module.n_active
        w = np.asarray(module.wdiag)
        active = module.mesh.active
        inputs.update({
            f"{name}_Aw": np.asarray(module.Aw), f"{name}_dobs": dobs,
            f"{name}_wdiag": w, f"{name}_wdiag_inv": module.wdiag_inv,
            f"{name}_mshape": np.asarray(module.mshape),
            f"{name}_active": (np.ones(int(np.prod(module.mshape)), bool)
                               if active is None else np.asarray(active)),
            f"{name}_apr": w * 0.001, f"{name}_low": w * 0.0,
            f"{name}_high": w * 1.0,
            f"{name}_xb": np.random.RandomState(2).uniform(
                0.2, 0.8, (4, M)) * w[None, :]})
    L, n01, u = _jax_chunk_draws(problems["full"][0].n_active)
    inputs.update(draw_L=L, draw_n01=n01, draw_u=u)
    np.savez(os.path.join(d, "inputs.npz"), **inputs)
    # an unsharded run's snapshot after CUT_CHUNKS chunks
    module = worker.port_module(problems["full"][1])
    _port_run(module, problems["full"][1]).sample(
        worker.NSAMPLES, 0, max_chunks=worker.CUT_CHUNKS,
        checkpoint_path=os.path.join(d, "snap_unsharded.npz"))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    procs = {}
    for tag, (nc, nm) in MESHES.items():
        sub = os.path.join(d, tag)
        os.makedirs(sub)
        import shutil
        shutil.copy(os.path.join(d, "inputs.npz"), sub)
        shutil.copy(os.path.join(d, "snap_unsharded.npz"), sub)
        spec = {"world": nc * nm, "chains_axis": nc, "dir": sub, "tag": tag,
                "init": "file://" + os.path.join(sub, "rendezvous"),
                "timeout": GROUP_TIMEOUT_S}
        path = os.path.join(sub, "spec.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        procs[tag] = []
        for r in range(nc * nm):
            with open(os.path.join(sub, f"rank{r}.log"), "w") as log:
                procs[tag].append(subprocess.Popen(
                    [sys.executable,
                     os.path.join(HERE, "test_torch_parallel_worker.py"),
                     path, str(r)], stdout=log, stderr=subprocess.STDOUT,
                    env=env))
    return d, procs


@pytest.fixture(scope="module")
def jax_refs(launched, problems):
    """The JAX sharded functions at each mesh shape, computed while the
    ranks run: ``{tag: {"pot": {...}, "chunk": carry, "switch": inv_mass}}``
    and the JAX ``--multichip`` line."""
    refs = {}
    for tag, (nc, nm) in MESHES.items():
        jm = jmake_mesh(nc * nm, chains_axis=nc)
        out = {"pot": {}}
        for name, reg, beta in worker.POTENTIALS:
            module, dobs = problems[name]
            w = np.asarray(module.wdiag)
            M = module.n_active
            pot, _ = jpotential(
                jm, module.Aw, dobs, w * 0.001, w * 0.0, w * 1.0,
                regularization=reg, beta=beta, wm_sq=w * w,
                mshape=module.mshape, active=module.mesh.active,
                dtype=jnp.float64)
            xb = np.random.RandomState(2).uniform(0.2, 0.8, (4, M)) * w
            U, g, (_, _, um) = pot(xb, 0.5)
            out["pot"][f"pot_{name}_{reg}"] = tuple(
                np.asarray(a) for a in (U, g, um))
        module, dobs = problems["full"]
        w = np.asarray(module.wdiag)
        M = module.n_active
        c = worker.CHUNK
        pot, _ = jpotential(jm, module.Aw, dobs, w * 0.001, w * 0.0, w,
                            regularization="Damping", dtype=jnp.float64)
        run_chunk, init_carry = jchunk(
            jm, pot, low=w * 0.0, high=w, M=M, nchains=c["nchains"],
            nsamples=c["nsamples"], ndraws=c["ndraws"],
            wdiag_inv=module.wdiag_inv, data_size=dobs.size, dt=c["dt"],
            Lmin=c["Lmin"], Lmax=c["Lmax"], Sigma=c["Sigma"],
            chunk_size=c["chunk_size"], dtype=jnp.float64,
            shared_L=c["shared_L"], welford=c["welford"],
            store_mode=c["store_mode"], store_thin=c["store_thin"])
        carry = init_carry(np.tile((w * 0.001)[None], (c["nchains"], 1)))
        key = random.PRNGKey(7)
        carry, _ = run_chunk(carry, key, 0, pot.params,
                             store_base=-(2 ** 30))
        carry, _ = run_chunk(carry, key, 1, pot.params, dt=0.005,
                             inv_mass=np.full(M, 0.5), store_base=0)
        out["chunk"] = [np.asarray(leaf) for leaf in carry]
        out["switch"] = np.asarray(jswitch(carry)[1])
        refs[tag] = out
    return refs


@pytest.fixture(scope="module")
def outputs(launched, jax_refs):
    """Each mesh's gathered results: ``{tag: (arrays, meta)}``."""
    d, procs = launched
    failed = []
    for tag, ps in procs.items():
        for r, p in enumerate(ps):
            try:
                p.wait(timeout=WORKER_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                for q in (q for qs in procs.values() for q in qs):
                    q.kill()
                pytest.fail(f"mesh {tag} rank {r} timed out")
            if p.returncode != 0:
                with open(os.path.join(d, tag, f"rank{r}.log")) as f:
                    failed.append(f"{tag} rank {r} rc={p.returncode}:\n"
                                  f"{f.read()[-3000:]}")
    if failed:
        pytest.fail("\n".join(failed))
    out = {}
    for tag in MESHES:
        sub = os.path.join(d, tag)
        with open(os.path.join(sub, f"out_{tag}.json")) as f:
            meta = json.load(f)
        out[tag] = (dict(np.load(os.path.join(sub, f"out_{tag}.npz"))),
                    meta, sub)
    return out


@pytest.fixture(scope="module")
def unsharded(problems):
    """The unsharded port's sample() runs of the worker's configurations."""
    module = worker.port_module(problems["full"][1])
    dobs = problems["full"][1]
    return module, {
        tag: _port_run(module, dobs, **kw).sample(worker.NSAMPLES, 0)
        for tag, kw in (("fixed", {}), ("adapt", worker.ADAPT))}


# --------------------------------------------------------------------------
# the ranks' results
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tag", sorted(MESHES))
def test_mesh_and_group(outputs, tag):
    arrays, meta, _ = outputs[tag]
    nc, nm = MESHES[tag]
    assert meta["shape"] == {"chains": nc, "model": nm}
    assert meta["info"]["process_count"] == nc * nm
    assert meta["info"]["backend"] == "gloo"
    ranks = meta["ranks"]
    assert [r["coords"] for r in ranks] == [[k // nm, k % nm]
                                            for k in range(nc * nm)]
    per = 8 // (nc * nm)
    assert [r["chains_for_host"] for r in ranks] == [
        [k * per, (k + 1) * per] for k in range(nc * nm)]
    assert [r["host_seed"] for r in ranks] == [100 + k
                                               for k in range(nc * nm)]


@pytest.mark.parametrize("case", [f"pot_{n}_{r}"
                                  for n, r, _ in worker.POTENTIALS])
@pytest.mark.parametrize("tag", sorted(MESHES))
def test_sharded_potential_matches_jax(outputs, jax_refs, tag, case):
    arrays, meta, _ = outputs[tag]
    U, g, um = jax_refs[tag]["pot"][case]
    np.testing.assert_allclose(arrays[case + "_U"], U, rtol=U_RTOL)
    np.testing.assert_allclose(arrays[case + "_um"], um, rtol=U_RTOL)
    np.testing.assert_allclose(arrays[case + "_g"], g, rtol=G_RTOL,
                               atol=G_ATOL)
    layout = meta["layouts"][case]
    if case.startswith("pot_full_") and case.endswith(("Smoothness", "TV")):
        assert layout == "halo"
    elif case.endswith(("Smoothness", "TV")):
        assert layout == "replicated"
    else:
        assert layout is None


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_sharded_chunk_matches_jax_with_its_draws(outputs, jax_refs, tag):
    arrays, _, _ = outputs[tag]
    ref = jax_refs[tag]["chunk"]
    assert np.array_equal(arrays["chunk_nacc"], ref[5])
    for i, name in ((0, "x"), (6, "store"), (8, "w_mean"), (9, "w_m2")):
        assert _rel(arrays["chunk_" + name], ref[i]) < STATE_RTOL, name
    assert np.abs(arrays["chunk_store"][:, 0]).max() > 0
    assert float(arrays["chunk_w_count"]) == float(ref[10]) == 12.0
    assert _rel(arrays["chunk_switch_inv_mass"],
                jax_refs[tag]["switch"]) < STATE_RTOL


@pytest.mark.parametrize("run", ["fixed", "adapt"])
@pytest.mark.parametrize("tag", sorted(MESHES))
def test_sample_matches_unsharded(outputs, unsharded, tag, run):
    """One L a chain from the whole batch's draw, Philox draws at the
    block's offsets: the unsharded run's accepts; under the warmup the same
    step size and inverse mass, so every rank adapted alike."""
    arrays, meta, _ = outputs[tag]
    ref = unsharded[1][run]
    got = meta[run]
    assert got["accepted"] == ref["accepted"]
    assert got["attempted"] == ref["attempted"]
    assert got["grad_evals"] == ref["grad_evals"]
    assert got["n_stored"] == ref["n_stored"].tolist()
    assert got["step_size"] == pytest.approx(ref["step_size"],
                                             rel=KERNEL_RTOL)
    assert _rel(arrays[f"{run}_samples"], ref["samples"]) < STATE_RTOL
    assert _rel(arrays[f"{run}_x"], ref["x"]) < STATE_RTOL
    if run == "adapt":
        assert _rel(arrays["adapt_inv_mass"], ref["inv_mass"]) < KERNEL_RTOL
        assert got["step_size"] != worker.ADAPT["dt"]
    nc, nm = MESHES[tag]
    c0 = meta["coords"][0] * 4 // nc
    assert got["shard"]["chains"] == [c0, c0 + 4 // nc]
    assert got["ess_median"] == pytest.approx(ref["ess_median"], rel=1e-9)


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_snapshots_cross_the_mesh(outputs, unsharded, tag):
    """A sharded run's snapshot resumes unsharded, an unsharded run's
    resumes sharded; both end where the uninterrupted run does. The JAX
    ``load_state`` reads the sharded snapshot's global leaves."""
    arrays, meta, sub = outputs[tag]
    module, refs = unsharded
    ref = refs["fixed"]
    assert meta["resumed"]["accepted"] == ref["accepted"]
    assert _rel(arrays["resumed_samples"], ref["samples"]) < STATE_RTOL
    snap = os.path.join(sub, "snap_sharded.npz")
    res = _port_run(module, np.asarray(module.dobs)).sample(
        worker.NSAMPLES, 0, checkpoint_path=snap)
    assert res["accepted"] == ref["accepted"]
    assert _rel(res["samples"], ref["samples"]) < STATE_RTOL
    leaves, n_chunks, _, _ = jcheckpoint.load_state(snap)
    assert n_chunks >= worker.CUT_CHUNKS and len(leaves) == 8
    M = module.n_active
    assert leaves[0].shape == (4, M)
    assert leaves[6].shape == (4, worker.NSAMPLES, M)


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_rank_0_writes_the_unsharded_files(outputs, unsharded, tag,
                                           tmp_path):
    """``write_files`` under the mesh: rank 0 writes every chain's
    folder (the global layout), the other ranks none; the files read
    back as an unsharded run's within the sink's ``%.8f`` rounding."""
    from gravinv3dhmc_tpu_torch.diagnostics import load_chains

    _, meta, sub = outputs[tag]
    module = unsharded[0]
    chain = _port_run(module, np.asarray(module.dobs), write_files=True,
                      save_folder=str(tmp_path / "chain"))
    want = chain.sample(worker.NSAMPLES, 0)["folders"]
    folders = [r["folders"] for r in meta["ranks"]]
    assert len(folders[0]) == len(want) == 4
    assert all(f == [] for f in folders[1:])
    got = load_chains(os.path.join(sub, "files", "chain"), 4)
    np.testing.assert_allclose(got, load_chains(str(tmp_path / "chain"), 4),
                               rtol=0, atol=2e-8)


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_ranks_draw_and_stay_in_lockstep(outputs, tag):
    _, meta, _ = outputs[tag]
    for r in meta["ranks"]:
        assert r["lockstep_raised"]
        assert r["draws_launches"] == 0   # the CPU runs the plain version
    assert [r["cli_is_none"] for r in meta["ranks"]] == [
        False] + [True] * (len(meta["ranks"]) - 1)


def test_multichip_line_has_the_jax_keys(outputs, monkeypatch):
    """rank 0's ``--multichip`` line over the (1, 2) group against the JAX
    driver's ``--multichip 2`` line on the virtual devices, both on the
    uniformgrid cube cut to 8 x 10 x 4."""
    from io import StringIO

    sys.path.insert(0, os.path.join(REPO, "examples"))
    import run as jrun
    import workloads as JW

    def small():
        wl = TW.singlecube(8, 10, 4)
        mesh = jmesher.PrismMesh(wl["mrange"], wl["mspacing"])
        mesh.addprop("density", wl["rho"])
        return dict(wl, mesh=mesh)

    monkeypatch.setattr(JW, "uniformgrid", small)
    monkeypatch.setattr(sys, "argv", ["run.py", *worker.CLI,
                                      "--multichip", "2"])
    buf = StringIO()
    monkeypatch.setattr(sys, "stdout", buf)
    try:
        jrun.main()
    finally:
        monkeypatch.setattr(sys, "stdout", sys.__stdout__)
    want = json.loads(buf.getvalue().strip().splitlines()[-1])
    got = outputs["1x2"][1]["cli"]
    assert set(got) == set(want)
    assert got["problem"] == want["problem"]
    assert got["n_chains"] == want["n_chains"] == 4
    assert np.isfinite(got["RMSD"]) and 0 < got["accept_ratio"] <= 1


# --------------------------------------------------------------------------
# in-process
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_shapes(n):
    assert sharded.mesh_shape(n) == jmake_mesh(n).devices.shape
    assert sharded.mesh_shape(4, chains_axis=1) == (1, 4)


def test_one_rank_mesh_without_a_group():
    mesh = sharded.make_mesh()
    assert mesh.shape == {"chains": 1, "model": 1} and mesh.groups is None
    assert mesh.axis_names == ("chains", "model")
    with pytest.raises(ValueError, match="process group"):
        sharded.make_mesh(2)


@pytest.mark.parametrize("M,n", [(6000, 2), (6000, 4), (256, 4), (192, 2),
                                 (17100, 4), (10, 4)])
def test_column_split(M, n):
    b = sharded.column_bounds(M, n)
    assert b[0] == 0 and b[-1] == M and b == sorted(b)
    assert all(v % 4 == 0 for v in b[:-1])
    if M % (4 * n) == 0:
        assert len({b1 - b0 for b0, b1 in zip(b, b[1:])}) == 1


@pytest.mark.parametrize("c0,j0", [(0, 0), (3, 0), (0, 5), (2, 7)])
def test_draws_at_offsets_are_the_block_of_a_full_draw(c0, j0):
    salt = philox.salt_from_seed(21)
    C, width = 8, 64
    full_n, full_u = torch.empty(C + c0, 4 * j0 + width), torch.empty(
        C + c0)
    tlf.KERNELS["draws"](full_n, full_u, salt, 9)
    n, u = torch.empty(C, width), torch.empty(C)
    tlf.KERNELS["draws"](n, u, salt, 9, c0, j0)
    assert torch.equal(n, full_n[c0:, 4 * j0:])
    assert torch.equal(u, full_u[c0:])
    assert torch.equal(u, philox.accept_uniforms(salt, 9, C, c0=c0))


def test_nccl_refuses_ranks_that_share_a_card():
    with pytest.raises(ValueError, match="gloo"):
        multihost.check_backend("nccl", "cuda:0", 2)
    with pytest.raises(ValueError, match="gloo"):
        multihost.check_backend("nccl", "cpu", 1)
    multihost.check_backend("nccl", "cuda:0", 1)
    multihost.check_backend("gloo", "cuda:0", 4)
    multihost.check_backend("gloo", "cpu", 4)


def test_chains_for_host_and_seed(monkeypatch):
    starts = []
    for pid in range(4):
        monkeypatch.setattr(multihost, "rank", lambda p=pid: p)
        monkeypatch.setattr(multihost, "world_size", lambda: 4)
        lo, hi = multihost.chains_for_host(32)
        assert hi - lo == 8
        starts.append(lo)
        assert multihost.host_seed(100) == 100 + pid
    assert starts == [0, 8, 16, 24]


@pytest.mark.parametrize("adapt", [False, True])
def test_one_rank_spmd_mesh_equals_the_unsharded_sample(problems, adapt):
    """``spmd_mesh`` at (1, 1): the sharded routing with identity
    collectives takes the unsharded run's every step, bit for bit."""
    module = worker.port_module(problems["full"][1])
    dobs = problems["full"][1]
    kw = dict(worker.ADAPT) if adapt else {}
    a = _port_run(module, dobs, dtype=torch.float32, **kw).sample(16, 0)
    b = _port_run(module, dobs, dtype=torch.float32,
                  spmd_mesh=sharded.make_mesh(), **kw).sample(16, 0)
    for k in ("samples", "misfits", "x", "U"):
        assert torch.equal(a[k], b[k]), k
    for k in ("accepted", "attempted", "grad_evals", "step_size",
              "ess_median", "n_stored"):
        assert np.array_equal(a[k], b[k]), k
    if adapt:
        assert torch.equal(a["inv_mass"], b["inv_mass"])
    assert b["shard"] == {"chains": [0, 4], "cells": [0, module.n_active]}
    assert b["fused_mode"] == "off"


def test_sharded_entry_points_need_a_card_or_a_device(problems,
                                                     monkeypatch):
    """Without a device and without a card, a sharded entry point raises,
    as every entry point of the port does: no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = worker.port_module(problems["full"][1])
    w = np.asarray(module.wdiag)
    mesh = sharded.make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sharded.make_sharded_potential(mesh, module.Aw, module.dobs, w, w,
                                       w)
    chain = _port_run(module, np.asarray(module.dobs), spmd_mesh=mesh)
    chain.device = None
    with pytest.raises(RuntimeError, match="device='cpu'"):
        chain.sample(4, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multihost.initialize("file:///nonexistent", 1, 0)


def test_sharded_restrictions(problems):
    module = worker.port_module(problems["full"][1])
    dobs = problems["full"][1]
    for kw, msg in (({"constraint": "logarithmic"}, "mandatory"),
                    ({"temperature": 2.0}, "temperature"),
                    ({"jacobian": True}, "temperature")):
        chain = _port_run(module, dobs, spmd_mesh=sharded.make_mesh(), **kw)
        with pytest.raises(ValueError, match=msg):
            chain.sample(4, 0)
    wl = worker.small_uniformgrid()
    with pytest.raises(ValueError, match="fixed-L HMC"):
        TW.run_hmc(wl, TW.forward_with_noise(wl)[1], sampler="chees",
                   spmd_mesh=sharded.make_mesh(), verbose=False,
                   device="cpu")
    with pytest.raises(ValueError, match="regularization"):
        sharded.make_sharded_potential(sharded.make_mesh(), module.Aw, dobs,
                                       dobs, dobs, dobs,
                                       regularization="L1")
    with pytest.raises(ValueError, match="mshape"):
        sharded.make_sharded_potential(sharded.make_mesh(), module.Aw, dobs,
                                       dobs, dobs, dobs,
                                       regularization="TV")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_multichip_world_size_one_equals_the_plain_run(monkeypatch):
    """``--multichip`` on a one-rank group (torchrun's environment, gloo
    on the CPU) prints the line the run without it prints: the same ops,
    and an all_reduce over one rank is a copy. The group is destroyed at
    the end."""
    import torch.distributed as dist

    monkeypatch.setattr(TW, "uniformgrid", worker.small_uniformgrid)
    for k, v in (("MASTER_ADDR", "127.0.0.1"),
                 ("MASTER_PORT", str(_free_port())), ("RANK", "0"),
                 ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)
    plain = trun.run(worker.CLI + ["--device", "cpu"])
    multi = trun.run(worker.CLI + ["--device", "cpu", "--multichip"])
    assert not dist.is_initialized()
    timing = {"total_s", "sampling_s", "grad_evals_per_s",
              "ess_per_s_median"}
    assert set(plain) == set(multi)
    for k in set(plain) - timing:
        assert multi[k] == plain[k], k
    with pytest.raises(SystemExit, match="2"):
        trun.run(worker.CLI + ["--device", "cpu", "--multichip", "2"])
    assert not dist.is_initialized()
    with pytest.raises(SystemExit, match="Cartesian"):
        trun.run(["global", "--device", "cpu", "--multichip"])
