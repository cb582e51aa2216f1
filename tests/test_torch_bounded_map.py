"""The bounded-MAP ladder (``gravinv3dhmc_tpu_torch/bounded_map.py``)
against ``tools/bounded_map.py`` at scale 0.25 (496 observations x 4,500
tesseroids, the matrix from the port's device builder, run on the CPU).

The tool's solver and statistics are closures inside its ``main``, so the
JAX side here is what they call: the JAX package's ``_make_cg_core`` with
the tool's arguments (``fixed_alpha=True, keep_best=True``) and the tool's
formulas (``tools/bounded_map.py:86-98, 108-112, 136-144``) written in
``jnp`` below, on the same arrays as the port's (the port's matrix,
weights and data as numpy). Projected Fletcher-Reeves amplifies rounding
as it goes (``tests/test_torch_reginv.py``), so the solves are held over
their first :data:`MAXK` iterations. The JAX side runs in float64: on
XLA:CPU its float32 solve parts from its own float64 one by 4.5e-4 at the
fourth iteration (its ``r A`` product alone is 1.1e-6 off), while the
port's float32 solve stays within 2.2e-5 of it. So the port's float32
line (the module's own run) is held to the JAX float64 solve within
:data:`RTOL`, and the port's functions in float64 to it within
:data:`RTOL64`. The line's keys are read from the tool's source.
"""
import ast
import json
import math
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from gravinv3dhmc_tpu.inversion.reginv import _make_cg_core as j_cg_core
from gravinv3dhmc_tpu_torch import bounded_map as B
from gravinv3dhmc_tpu_torch import global_tess as G

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = 0.25
#: iterations a solve, and the tolerance of each value against the JAX
#: package's over them
MAXK, RTOL, RTOL64 = 20, 1e-4, 1e-9
#: the port's ladder at this scale: 0, seven powers of ten and 5.0
N_LADDER = 9


@pytest.fixture(scope="module")
def problem():
    return G.build(SCALE, device="cpu")


@pytest.fixture(scope="module")
def arrs(problem):
    return B.arrays(problem[3], problem[2])


@pytest.fixture(scope="module")
def line(problem):
    return B.run(maxk=MAXK, problem=problem)


@pytest.fixture(scope="module")
def jax_side(problem, arrs):
    """The tool's solver and ``finish`` in JAX (float64) on the port's
    arrays."""
    Aw_np = arrs[0].numpy()
    solve = j_cg_core(Aw_np, None, None, None, problem[3].mshape, None,
                      "Damping", 0.01, 0.7, MAXK, 0.0, 0.8, "normalized",
                      jnp.float64, as_args=True, fixed_alpha=True,
                      keep_best=True)
    arrs_j = jax_arrays(arrs)
    truth = jnp.asarray(problem[0]["rho"], jnp.float64)
    D, M = Aw_np.shape
    mw0 = jnp.zeros(M, jnp.float64)
    ones = jnp.ones(D, jnp.float64)

    @jax.jit
    def solve_from_zero(alpha, arrs):
        return solve(mw0, ones, arrs, alpha)

    @jax.jit
    def anchor(arrs):
        mw_star = solve_from_zero(jnp.asarray(0.0, jnp.float64), arrs)[0]
        Aw_, dobs_, _, _, apr_ = arrs
        r = Aw_ @ mw_star - dobs_
        dm = mw_star - apr_
        return jnp.sum(r * r) / jnp.sum(dm * dm)

    @jax.jit
    def finish(mw, arrs):
        Aw_, dobs_, _, wdiag_inv, _ = arrs
        m = mw * wdiag_inv
        dp = Aw_ @ mw
        r = (dp - jnp.mean(dp)) - (dobs_ - jnp.mean(dobs_))
        rmsd = jnp.sqrt(jnp.mean(r ** 2))
        rmsm = jnp.sqrt(jnp.mean((m - truth) ** 2))
        corr = jnp.corrcoef(jnp.stack([m, truth]))[0, 1]
        at_lo = jnp.mean((m <= 0.0 + 1e-6).astype(jnp.float64))
        at_hi = jnp.mean((m >= 0.8 - 1e-6).astype(jnp.float64))
        ru = Aw_ @ mw - dobs_
        return rmsd, rmsm, corr, at_lo, at_hi, jnp.sum(ru * ru) / D

    def entry(alpha):
        mw, _, _, _, n_it = solve_from_zero(jnp.asarray(alpha, jnp.float64),
                                            arrs_j)
        out = [float(v) for v in finish(mw, arrs_j)]
        return dict(zip(("RMSD", "RMSM", "corr", "frac_at_lower_bound",
                         "frac_at_upper_bound", "final_data_misfit_norm"),
                        out), n_iters=int(n_it))

    return {"anchor": lambda: float(anchor(arrs_j)), "entry": entry}


def jax_arrays(arrs):
    """The port's float32 arrays as JAX float64 arrays (the same values)."""
    return tuple(jnp.asarray(a.numpy(), jnp.float64) for a in arrs)


def close(got, want, rtol=RTOL):
    return abs(got - want) <= rtol * max(abs(want), 1e-30)


def test_alpha_ref_matches_jax_anchor(problem, arrs, line, jax_side):
    want = jax_side["anchor"]()
    assert close(line["alpha_ref"], want), (line["alpha_ref"], want)
    arrs64 = tuple(a.double() for a in arrs)
    solve64 = B.make_solver(problem[3].mshape, MAXK, 800, torch.float64)[0]
    assert close(B.anchor(solve64, arrs64), want, RTOL64)


@pytest.mark.parametrize("alpha_ref, decades, want", [
    # the JAX package's recorded ladder at scale 1 (GLOBAL_r05.json
    # bounded_map_ladder_maxk400), rebuilt from its alpha_ref exactly
    (271.55865478515625, 3, "record"),
    # an anchor at the flagship's 5.0: the set keeps one 5.0
    (5.0, 1, [0.0, 0.5, 5.0, 50.0]),
])
def test_ladder_rule(alpha_ref, decades, want):
    if want == "record":
        with open(os.path.join(REPO, "GLOBAL_r05.json")) as f:
            rec = json.load(f)["bounded_map_ladder_maxk400"]
        assert rec["alpha_ref"] == alpha_ref
        want = [e["alpha"] for e in rec["ladder"]]
        assert len(want) == N_LADDER
    assert B.ladder(alpha_ref, decades) == want


def test_line_follows_its_ladder(line):
    assert [e["alpha"] for e in line["ladder"]] == B.ladder(
        line["alpha_ref"], 3)
    assert len(line["ladder"]) == N_LADDER
    best = max(line["ladder"], key=lambda e: e["corr"])
    assert (line["best_alpha"], line["best_corr"], line["best_RMSM"]) == (
        best["alpha"], best["corr"], best["RMSM"])
    assert line["bounded_map_beats_hmc_mean"] == (best["corr"] > 0.589)
    assert line["problem"] == [496, 4500] and line["device"] == "cpu"


@pytest.mark.parametrize("i", range(N_LADDER))
def test_ladder_entry_matches_jax(line, jax_side, i):
    got = line["ladder"][i]
    want = jax_side["entry"](got["alpha"])
    assert got["n_iters"] == want["n_iters"] == MAXK
    for key in ("final_data_misfit_norm", "corr", "RMSD", "RMSM"):
        assert close(got[key], want[key]), (key, got[key], want[key])
    for key in ("frac_at_lower_bound", "frac_at_upper_bound"):
        assert abs(got[key] - want[key]) <= 2.0 / 4500, key


def test_segment_restart_keeps_the_better_iterate(arrs):
    """A planted second segment that ends worse than the first: the third
    starts from the first's iterate, which is returned."""
    M = arrs[0].shape[1]
    good = torch.full((M,), 1e-3) * arrs[2]
    worse = good + 0.5 * arrs[2]
    alpha = 5.0
    assert float(B.objective(arrs, worse, alpha)) > float(
        B.objective(arrs, good, alpha))
    ends = iter([good, worse, worse])
    starts = []

    def planted(mw, c, arrs_, a):
        starts.append(mw.clone())
        assert a == alpha and arrs_ is arrs
        return next(ends), None, None, None, torch.tensor(7)

    mw, n_iters = B.solve_alpha(planted, arrs, alpha, 3)
    assert n_iters == 21
    assert torch.equal(mw, good)
    assert torch.equal(starts[0], torch.zeros(M))
    assert torch.equal(starts[1], good) and torch.equal(starts[2], good)


def test_restarted_segments_against_the_tools_loop(problem, arrs, jax_side):
    """``maxk`` 2 x ``chunk``: two segments, the second from the first's
    best iterate, against the tool's loop around the JAX solver."""
    solve, n_seg = B.make_solver(problem[3].mshape, 2 * MAXK, MAXK)
    assert n_seg == 2
    mw, n_iters = B.solve_alpha(solve, arrs, 5.0, n_seg)
    assert n_iters == 2 * MAXK
    # the tool's loop: best by objective, restart from the best
    Aw_np = arrs[0].numpy()
    j_solve = jax.jit(j_cg_core(
        Aw_np, None, None, None, problem[3].mshape, None, "Damping", 0.01,
        0.7, MAXK, 0.0, 0.8, "normalized", jnp.float64, as_args=True,
        fixed_alpha=True, keep_best=True))
    arrs_j = jax_arrays(arrs)
    ones = jnp.ones(Aw_np.shape[0], jnp.float64)
    alpha = jnp.asarray(5.0, jnp.float64)
    mw_j = mw_best = jnp.zeros(Aw_np.shape[1], jnp.float64)
    obj_best = math.inf
    for _ in range(2):
        mw_j = j_solve(mw_j, ones, arrs_j, alpha)[0]
        r = arrs_j[0] @ mw_j - arrs_j[1]
        dm = mw_j - arrs_j[4]
        obj = float(jnp.sum(r * r) + alpha * jnp.sum(dm * dm))
        if obj < obj_best:
            mw_best, obj_best = mw_j, obj
        mw_j = mw_best
    assert close(float(B.objective(arrs, mw, 5.0)), obj_best)


def test_given_alphas(problem):
    out = B.run(maxk=3, alphas=[5.0, 0.5], problem=problem)
    assert out["alpha_ref"] is None
    assert [e["alpha"] for e in out["ladder"]] == [5.0, 0.5]
    assert all(e["n_iters"] == 3 for e in out["ladder"])


def _tool_keys():
    """The tool's ``res`` keys and a ladder entry's, from its source."""
    with open(os.path.join(REPO, "tools", "bounded_map.py")) as f:
        tree = ast.parse(f.read())
    res, entry = set(), set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Assign):
            t = n.targets[0]
            if isinstance(t, ast.Name) and t.id == "res" \
                    and isinstance(n.value, ast.Dict):
                res |= {k.value for k in n.value.keys}
            elif isinstance(t, ast.Subscript) \
                    and isinstance(t.value, ast.Name) and t.value.id == "res":
                res.add(t.slice.value)
        elif isinstance(n, ast.Call) and getattr(n.func, "attr", "") \
                == "append" and n.args and isinstance(n.args[0], ast.Dict):
            entry |= {k.value for k in n.args[0].keys}
    return res, entry


def test_line_keys_are_the_tools(line):
    res, entry = _tool_keys()
    assert "bounded_map_beats_hmc_mean" in res and "alpha_ref" in res
    assert set(line) == res
    assert all(set(e) == entry for e in line["ladder"])


def test_main_prints_and_writes_the_line(problem, tmp_path, capsys,
                                         monkeypatch):
    monkeypatch.setattr(B, "build", lambda scale, device: problem)
    out = tmp_path / "bm.json"
    assert B.main(["--scale", "0.25", "--maxk", "2", "--alphas", "5",
                   "--device", "cpu", "--out", str(out)]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(out.read_text())
    assert printed["maxk"] == 2 and printed["ladder"][0]["n_iters"] == 2
