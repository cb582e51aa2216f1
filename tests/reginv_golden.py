"""Golden numbers of the JAX package's deterministic inversion, for the
port's check on the GPU (not a test: it takes a few minutes on the CPU).

    JAX_PLATFORMS=cpu python tests/reginv_golden.py [cg] [bootstrap] [map]

The three stages of ``gravinv3dhmc_tpu_torch.cg`` at their full sizes,
run by the JAX package on the CPU with the JAX commands' own inputs:

* ``cg``: ``examples/run.py cg`` at its defaults (``workloads.cg_model``
  "model03_twodykes", ``forward_with_noise`` seed 1, ``run_cg``: float64
  ``ConjugateGradient``, MS, beta 0.001, q 0.7, maxk 200, box [0, 1]);
* ``bootstrap``: ``examples/run.py bootstrap`` at its defaults
  (``workloads.uniformgrid``, the same noise, 20 replicates, maxk 200,
  beta 0.01, float64, one batch);
* ``map``: the bounded MAP of ``tools/samplers_tpu.py realdata`` with
  ``SAMPLERS_RD_TEMP=auto`` (``bench.build_realdata_problem``,
  ``cg_device`` with Damping, alpha 0.05, maxk 400, float32, box
  [-0.5, 0.5]; T = 2 sigma_hat^2 from the mean-removed residual of
  ``predict``).

Writes ``gravinv3dhmc_tpu_torch/golden/reginv_jax.json`` (``--out``),
merging into the stages already there, and prints one line a stage with
its CPU seconds. The alpha-decay iterations are those k >= 2 at which the
regularization factor fell. ``bootstrap``'s ``self_spread`` is how far
the JAX package's own summaries move when the same replicates are solved
one and five at a time (other product shapes, other rounding), and
``self_parting`` each replicate's first iteration (of the histories
without their k = 0 entry) at which those runs' data misfits part by more
than 1e-6 (-1: never). ``map``'s ``objective_spread`` is the largest
relative distance of an iterate's objective from the start's, and
``temperature_f64`` and ``objective_spread_f64`` the same solve's in
float64.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(REPO, "examples"))
import conftest  # noqa: E402,F401  (jax on the CPU, x64 as in the package)

import jax.numpy as jnp  # noqa: E402

import workloads as W  # noqa: E402
from gravinv3dhmc_tpu import bench as jbench  # noqa: E402
from gravinv3dhmc_tpu.inversion.reginv import BootStrap, cg_device  # noqa: E402
from gravinv3dhmc_tpu_torch.cg import decay_iters  # noqa: E402

OUT = os.path.join(REPO, "gravinv3dhmc_tpu_torch", "golden",
                   "reginv_jax.json")


def floats(a):
    return [float(v) for v in np.asarray(a, np.float64)]


def stage_cg():
    wl = W.cg_model("model03_twodykes")
    _, dobs = W.forward_with_noise(wl, seed=1)
    inv, model_inv, _, out = W.run_cg(wl, dobs, regularization="MS",
                                      beta=0.001, q=0.7, maxk=200,
                                      verbose=False)
    M = inv.msize
    # the same solve again, for the histories run_cg does not return
    _, _, d_h, m_h, r_h = inv.CG(np.zeros(M), np.zeros(M), (0.0, 1.0),
                                 regularization="MS", beta=0.001, q=0.7,
                                 maxk=200)
    return dict(out, n_iters=int(len(d_h)), data_hist=floats(d_h),
                model_hist=floats(m_h), regul_hist=floats(r_h),
                decay_iters=decay_iters(r_h),
                model_max=float(np.max(model_inv)),
                model_min=float(np.min(model_inv)))


def stage_bootstrap():
    wl = W.uniformgrid()
    _, dobs = W.forward_with_noise(wl, seed=1)
    bs = BootStrap(wl["mrange"], wl["mspacing"], wl["obs"], dobs,
                   (wl["rhomin"], wl["rhomax"]), samples=20, beta=0.01,
                   maxk=200, verbose=False)
    def summary(batch):
        models, d_h, m_h, r_h = bs.BSCG(np.zeros(bs.msize), batch=batch)
        mean = models.mean(axis=0)
        return (dict(mean_model_max=float(mean.max()),
                     std_model_max=float(models.std(axis=0).max()),
                     RMSM=float(np.sqrt(np.mean((mean - wl["rho"]) ** 2)))),
                models, d_h, m_h, r_h)

    out, models, d_h, m_h, r_h = summary(None)
    # the JAX package against itself: the same replicates solved one and
    # five at a time (other vmapped product shapes, other rounding)
    spread = {k: 0.0 for k in out}
    part = []
    for batch in (1, 5):
        other, _, d_b = summary(batch)[:3]
        for k in out:
            spread[k] = max(spread[k], abs(other[k] / out[k] - 1))
        rel = np.abs(d_b / d_h - 1)
        part.append([int(np.argmax(r > 1e-6)) if (r > 1e-6).any() else -1
                     for r in rel])
    n_iters = [int(np.sum(~np.isnan(row))) + 1 for row in d_h]
    return dict(samples=20, **out, self_spread=spread,
                self_parting=[min((p for p in ps if p >= 0), default=-1)
                              for ps in zip(*part)],
                n_iters=n_iters,
                data_last=[float(row[n - 2]) for row, n in zip(d_h, n_iters)],
                model_last=[float(row[n - 2])
                            for row, n in zip(m_h, n_iters)],
                decay_iters=[decay_iters(row) for row in r_h],
                model_max=[float(v) for v in models.max(axis=1)],
                data_hist=[floats(row) for row in d_h])


def stage_map():
    module, dobs = jbench.build_realdata_problem()
    cg = cg_device(module, dobs, (-0.5, 0.5), regularization="Damping",
                   maxk=400, dtype=jnp.float32, alpha=0.05)
    dp = module.predict(cg["mw"])
    dzc = jnp.asarray(dobs, jnp.float32)
    rr = (dp - jnp.mean(dp)) - (dzc - jnp.mean(dzc))
    sigma_hat2 = float(jnp.mean(rr * rr))
    d_h = cg["data_hist"]
    D, M = module.Aw.shape
    obj = D * d_h + 0.05 * M * cg["model_hist"]
    # the same solve in float64: another best iterate, another T
    cg64 = cg_device(module, dobs, (-0.5, 0.5), regularization="Damping",
                     maxk=400, dtype=jnp.float64, alpha=0.05)
    dp64 = module.predict(cg64["mw"])
    r64 = (dp64 - jnp.mean(dp64)) - (jnp.asarray(dobs) - np.mean(dobs))
    obj64 = D * cg64["data_hist"] + 0.05 * M * cg64["model_hist"]
    return dict(problem=[int(dobs.size), int(module.n_active)],
                n_iters=int(cg["n_iters"]),
                RMSD=float(np.sqrt(sigma_hat2)), sigma_hat2=sigma_hat2,
                temperature=2.0 * sigma_hat2,
                data_hist_min=float(np.min(d_h)),
                data_hist_last=float(d_h[-1]),
                data_hist_first=float(d_h[0]),
                objective_spread=float(np.max(np.abs(obj / obj[0] - 1))),
                temperature_f64=2.0 * float(jnp.mean(r64 * r64)),
                objective_spread_f64=float(np.max(np.abs(obj64 / obj64[0]
                                                         - 1))),
                data_hist=floats(d_h), model_hist=floats(cg["model_hist"]))


STAGES = {"cg": stage_cg, "bootstrap": stage_bootstrap, "map": stage_map}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("stages", nargs="*", metavar="{cg,bootstrap,map}")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    if not set(args.stages) <= set(STAGES):
        ap.error(f"choose stages from {list(STAGES)}")
    golden = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            golden = json.load(f)
    for name in args.stages or list(STAGES):
        t0 = time.perf_counter()
        golden[name] = STAGES[name]()
        golden[name]["cpu_seconds"] = time.perf_counter() - t0
        print(json.dumps({"stage": name,
                          "cpu_seconds": golden[name]["cpu_seconds"]}),
              flush=True)
    golden["source"] = ("tests/reginv_golden.py: the JAX package on the "
                        "CPU (float64 stages in float64, map in float32)")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(golden, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
