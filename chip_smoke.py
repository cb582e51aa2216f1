#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, one line each (the script stops at the first failure, non-zero):

1. build   — nvcc compiles ``gravinv3dhmc_tpu_torch/csrc/leapfrog.cu`` for
             sm_90a; prints the build time and the card.
2. philox  — the kernel's Philox words equal ``ops/philox.py``'s bit for
             bit; its 1M normals have mean 0 and variance 1 within 5 sigma.
3. kernels — each of the six kernels against its plain PyTorch version on
             the same inputs at the uniformgrid slice's shapes (1024
             chains, 640 x 6016 bf16 matrix), with both timed.
4. traj    — the trajectory op (kernels) vs its plain version at 256
             chains, L = 7: f32 and bf16, MS and Damping, with and without
             a diagonal inverse mass.
5. iter    — the iteration op with injected draws vs its plain version:
             same accept flags and state; a forced rejection keeps the
             state bit for bit; the Philox draws give the same decisions.
6. slice   — the uniformgrid problem (600 obs x 6000 prisms from the
             port's own mesh and prism builder), 1024 chains, through
             ``HamiltonianMC.sample(use_fused=True)``: grad-evals/s,
             accept ratio, median ESS and the launch count of every
             kernel (each must be > 0); then a small problem sampled on
             the card and on the CPU with the same seed must agree.

The last three lines are the card (``nvidia-smi`` name and power limit),
one JSON object with every kernel's numbers, and the result line
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero before
printing any result.
"""
import json
import subprocess
import sys
import time

import numpy as np

# tolerances, stated up front (relative to the largest |reference| value
# of each output, so near-zero entries do not dominate):
#   kernels vs plain on identical inputs differ only in summation order
#   (GEMM and row reductions) and in cos/log ulps of the Philox normals
KERNEL_RTOL = 1e-4
#   whole trajectories: f32 keeps f32 rounding; with bf16 storage each
#   step rounds x and r to 8 bits, and an x that differs by one f32 ulp
#   between the two versions can round to a different bf16 value, so the
#   bound is bf16's (2^-8 ~ 4e-3) times a few steps. g = (pk - p)/eps
#   divides the momentum rounding by eps: looser. ("U" stands for every
#   output without its own entry.)
TRAJ_RTOL = {"float32": {"x": 1e-4, "p": 1e-4, "g": 1e-4, "U": 1e-4},
             "bfloat16": {"x": 2e-2, "p": 5e-2, "g": 1e-1, "U": 2e-2}}


def line(phase, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def rel_err(out, ref):
    """max |out - ref| and that over max |ref|."""
    err = (out.double() - ref.double()).abs().max().item()
    scale = max(ref.double().abs().max().item(), 1e-30)
    return err, err / scale


def time_ms(torch, fn, reps=20, warmup=3):
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def fused_args(module, dobs):
    M = module.n_active
    w = module.wdiag
    return (module.Aw, dobs - dobs.mean(), None, w * np.full(M, 0.001),
            w * w, w * np.zeros(M), w * np.ones(M))


def phase_philox(torch, tlf, philox, dev):
    salt = philox.salt_from_seed(2024)
    C, width = 256, 4096                       # 1,048,576 draws
    bits_k = tlf.philox_bits_cuda(salt, 9, C, width, dev)
    bits_p = philox.momentum_bits(salt, 9, C, width, dev)
    if not torch.equal(bits_k, bits_p):
        fail("philox: kernel words differ from ops/philox.py")
    # the refresh kernel's normals: pscale = im = 1, g = 0, eps = 0
    zeros = torch.zeros((C, width), device=dev)
    ones = torch.ones(width, device=dev)
    p, pk = torch.empty_like(zeros), torch.empty_like(zeros)
    H0 = torch.empty(C, device=dev)
    tlf.KERNELS["refresh"](zeros, torch.zeros(C, device=dev), ones, ones,
                           0.0, salt, 9, None, p, pk, H0)
    ref = philox.momentum_normals(salt, 9, C, width, dev)
    err, _ = rel_err(p, ref)
    n = p.double()
    N = n.numel()
    mean, var = n.mean().item(), n.var().item()
    ok = (err < 1e-5 and abs(mean) < 5 / np.sqrt(N)
          and abs(var - 1) < 5 * np.sqrt(2 / N))
    line("philox", bits_equal=True, normals=N, max_abs_err=err, mean=mean,
         var=var)
    if not ok:
        fail("philox normals")


def kernel_cases(torch, op, C, dev):
    """Inputs for each kernel at the op's shapes; returns name -> (args
    builder, outputs to compare: args -> {name: tensor})."""
    from gravinv3dhmc_tpu_torch.ops import philox

    pp = op._padded
    Mp, Dp = op.Mp, op.Dp
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device=dev)

    mask = (pp["high"] > 0).float()
    x = (0.3 + 0.05 * randn(C, Mp)) * pp["high"]
    p = randn(C, Mp, scale=1e-3) * mask
    g = randn(C, Mp, scale=10.0) * mask
    r = randn(C, Dp, scale=0.1) * pp["dmask"]
    U = 200.0 + randn(C)
    salt = philox.salt_from_seed(5)
    e = 0.01
    # refresh and accept sum a kinetic energy K = 0.5 sum im p^2 per
    # chain. At the slice's Sigma = 0.001 K is ~0.003, below the rounding
    # of K + U, so they are checked with momenta of order 1 (pscale 1, p
    # ~ N(0, 1)) and a random inverse mass in [0.1, 1]: K ~ 1600.
    im = torch.where(mask > 0, 0.1 + 0.9 * torch.rand(
        Mp, generator=gen, device=dev), torch.ones_like(mask))
    p1 = randn(C, Mp) * mask
    acc_iteration = 4

    def f(*shape):
        return torch.empty(*shape, device=dev)

    def acc_args():
        # H0 puts each chain's log accept ratio 0.5 to a chosen side of
        # its Philox uniform u: accept where u < e^0.5 u, reject where
        # u >= e^-0.5 u (u clamped away from 0 to keep the log finite).
        # Both sides are far from a tie at f32 rounding, and a kernel that
        # drops, halves or mis-weights K1 moves H1 by hundreds, accepting
        # every planned rejection.
        u = philox.accept_uniforms(salt, acc_iteration, C, dev).double()
        H1 = 0.5 * (im * p1 * p1).double().sum(1) + U.double()
        side = torch.where(torch.rand(C, generator=gen, device=dev) < 0.5,
                           0.5, -0.5).double()
        H0 = (H1 + torch.log(u.clamp_min(2.0 ** -24)) - side).float()
        return (x.clone(), g.clone(), U.clone(), U.clone() * 0.9,
                U.clone() * 0.1, p1.clone(), H0, x + 1.0, g + 1.0,
                U + 1.0, U + 2.0, U + 3.0, im, salt, acc_iteration, None,
                f(C))

    def kinetic0(a):
        # K0 = H0 - U, in f64 from the kernel's f32 H0
        return a[10].double() - a[1].double()

    return {
        "refresh": (lambda: (g.clone(), U.clone(), mask, im, 0.5 * e, salt,
                             3, None, f(C, Mp), f(C, Mp), f(C)),
                    lambda a: {"p": a[8], "pk": a[9], "K0": kinetic0(a)}),
        "drift": (lambda: (x.clone(), p.clone(), f(C, Mp), pp["im"],
                           pp["low"], pp["high"], e),
                  lambda a: {"x": a[0], "p": a[1], "pk": a[2]}),
        "residual": (lambda: (x.clone(), pp["A"], pp["dobs"], pp["dmask"],
                              f(C, Dp)), lambda a: {"r": a[4]}),
        "kick": (lambda: (r.clone(), pp["A"], x.clone(), p.clone(),
                          pp["aprior"], pp["gm_scale"], 2 * e, e,
                          op.beta, True), lambda a: {"p": a[3]}),
        "traj_finish": (lambda: (x.clone(), p.clone(), p + g * e, r.clone(),
                                 f(C, Mp), f(C), f(C), f(C), pp["aprior"],
                                 pp["wmsq"], 1.0 / e, 1.0, op.beta, True),
                        lambda a: {"p": a[1], "g": a[4], "U": a[5],
                                   "ud": a[6], "um": a[7]}),
        "accept": (acc_args,
                   lambda a: {"x": a[0], "g": a[1], "U": a[2], "ud": a[3],
                              "um": a[4], "acc": a[16]}),
    }


def phase_kernels(torch, tlf, op, C, dev):
    """Each kernel against its plain version on the same inputs; every
    output within ``KERNEL_RTOL`` of the plain one relative to its largest
    |value| (accept flags identical, with both decisions taken)."""
    results = {}
    for name, (make, outputs) in kernel_cases(torch, op, C, dev).items():
        kern = tlf.KERNELS[name]
        args_k = make()
        args_p = tuple(a.clone() if torch.is_tensor(a) else a
                       for a in args_k)
        kern(*args_k)
        kern.plain(*args_p)
        sync(torch)
        out_k, out_p = outputs(args_k), outputs(args_p)
        worst_abs, errs = 0.0, {}
        for o in out_k:
            if not torch.isfinite(out_k[o]).all():
                fail(f"kernel {name}: non-finite output {o}")
            a, errs[o] = rel_err(out_k[o], out_p[o])
            worst_abs = max(worst_abs, a)
        extra = {}
        if name == "accept":
            n_acc = int(out_k["acc"].sum().item())
            extra["accepted"] = n_acc
            if not torch.equal(out_k["acc"], out_p["acc"]):
                fail("kernel accept: decisions differ from the plain ones")
            if not 0 < n_acc < C:
                fail(f"kernel accept: {n_acc} of {C} accepted, want both "
                     "decisions exercised")
        bench_k, bench_p = make(), make()
        ms = time_ms(torch, lambda: kern(*bench_k))
        plain_ms = time_ms(torch, lambda: kern.plain(*bench_p))
        worst_rel = max(errs.values())
        results[name] = {"max_abs_err": worst_abs, "rel_err": worst_rel,
                         "ms": ms, "plain_ms": plain_ms}
        line("kernel", name=name, shape=[C, op.Dp, op.Mp], rel_errs=errs,
             **extra, **results[name])
        if worst_rel > KERNEL_RTOL:
            fail(f"kernel {name}: rel err {worst_rel:.3g} > {KERNEL_RTOL}")
    return results


def phase_traj(torch, tlf, module, dobs, dev):
    C, L = 256, 7
    M = module.n_active
    w = torch.as_tensor(module.wdiag, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = (0.3 + 0.05 * torch.randn(C, M, generator=gen, device=dev)) * w
    p0 = 1e-3 * torch.randn(C, M, generator=gen, device=dev)
    inv_mass = 10.0 ** (-2 * torch.rand(M, generator=gen, device=dev))
    for dtype in ("float32", "bfloat16"):
        for reg in ("MS", "Damping"):
            op = tlf.make_fused_trajectory(
                *fused_args(module, dobs), regularization=reg, beta=0.001,
                matvec_dtype=getattr(torch, dtype), device=dev)
            for im in (None, inv_mass):
                p = p0 if im is None else p0 / torch.sqrt(im)
                out_k = op(x, p, L, 0.01, 1.0, inv_mass=im)
                out_p = op(x, p, L, 0.01, 1.0, inv_mass=im, plain=True)
                errs = {}
                for nm, a, b in zip(("x", "p", "g", "U", "ud", "um"),
                                    out_k, out_p):
                    if not torch.isfinite(a).all():
                        fail(f"traj {dtype} {reg}: non-finite {nm}")
                    errs[nm] = rel_err(a, b)[1]
                lim = TRAJ_RTOL[dtype]
                bad = [nm for nm in errs
                       if errs[nm] > lim.get(nm, lim["U"])]
                line("traj", dtype=dtype, reg=reg, inv_mass=im is not None,
                     C=C, L=L, rel_err=errs)
                if bad:
                    fail(f"traj {dtype} {reg}: {bad} beyond {lim}")


def phase_iter(torch, tlf, philox, module, dobs, dev):
    C, L = 256, 7
    M = module.n_active
    op = tlf.make_fused_iteration(
        *fused_args(module, dobs), regularization="MS", beta=0.001,
        Sigma=0.001, matvec_dtype=torch.bfloat16, device=dev)
    fa = fused_args(module, dobs)
    pot = module.make_potential(fa[3], fa[5], fa[6], regularization="MS",
                                beta=0.001, device=dev)
    w = torch.as_tensor(module.wdiag, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    x = (0.3 + 0.05 * torch.randn(C, M, generator=gen, device=dev)) * w
    U, g, (_, ud, um) = pot(x, 1.0)
    n01 = torch.randn(C, M, generator=gen, device=dev)
    u = torch.rand(C, generator=gen, device=dev)
    seed = (philox.salt_from_seed(3), 11)
    out_k = op(x, U, g, ud, um, seed, L, 0.01, 1.0, n01=n01, u=u)
    out_p = op(x, U, g, ud, um, seed, L, 0.01, 1.0, n01=n01, u=u,
               plain=True)
    if not torch.equal(out_k[5], out_p[5]):
        fail("iter: accept flags differ with injected draws")
    lim = TRAJ_RTOL["bfloat16"]
    errs = {nm: rel_err(a, b)[1] for nm, a, b in
            zip(("x", "U", "g", "ud", "um"), out_k[:5], out_p[:5])}
    bad = [nm for nm, e in errs.items() if e > lim.get(nm, lim["U"])]
    # forced rejection: the carried state comes back bit for bit
    U_low = torch.full_like(U, -1e30)
    rej = op(x, U_low, g, ud, um, seed, L, 0.01, 1.0, n01=n01, u=u)
    kept = (rej[5].sum().item() == 0 and torch.equal(rej[0], x)
            and torch.equal(rej[1], U_low) and torch.equal(rej[2], g)
            and torch.equal(rej[3], ud) and torch.equal(rej[4], um))
    # Philox draws inside the kernels vs the plain Philox: same decisions
    ph_k = op(x, U, g, ud, um, seed, L, 0.01, 1.0)
    ph_p = op(x, U, g, ud, um, seed, L, 0.01, 1.0, plain=True)
    same_philox = torch.equal(ph_k[5], ph_p[5])
    line("iter", C=C, L=L, accept=out_k[5].mean().item(), rel_err=errs,
         rejection_keeps_state=kept, philox_same_accepts=same_philox)
    if bad or not kept or not same_philox:
        fail(f"iter: errors {bad}, kept={kept}, philox={same_philox}")


def phase_slice(torch, tlf, module, dobs, dev, smi):
    from gravinv3dhmc_tpu_torch.uniformgrid import SLICE as cfg
    from gravinv3dhmc_tpu_torch.uniformgrid import slice_sampler

    chain = slice_sampler(module, dobs, dev)
    sync(torch)
    tlf.reset_launch_counts()
    res = chain.sample(cfg["nsamples"], cfg["ndraws"])
    sync(torch)
    counts = tlf.launch_counts()
    samples = res["samples"]
    finite = bool(torch.isfinite(samples).all())
    line("slice", problem=[int(dobs.size), module.n_active],
         nchains=cfg["nchains"], chunk=cfg["chunk"],
         iterations=res["attempted"] // cfg["nchains"],
         fused_mode=res["fused_mode"],
         grad_evals_per_s=res["grad_evals_per_s"],
         elapsed_s=res["elapsed_s"], accept_ratio=res["accept_ratio"],
         ess_median=res["ess_median"], launches=counts,
         samples_shape=list(samples.shape), finite=finite, card=smi)
    if not finite or not 0 < res["accept_ratio"] <= 1:
        fail("slice: non-finite samples or accept ratio out of (0, 1]")
    if tuple(samples.shape) != (cfg["nchains"], cfg["nsamples"],
                                module.n_active):
        fail(f"slice: samples shape {tuple(samples.shape)}")
    missing = [n for n, c in counts.items() if c <= 0]
    if missing:
        fail(f"slice: kernels never launched: {missing}")
    return counts


def phase_reference(torch, dev):
    """A small problem sampled through the kernels on the card and through
    the plain versions on the CPU, same seed: the Philox draws are the
    same bits, so the chains take the same decisions (a chain whose
    decision flips on a rounding tie diverges; at least 95% must agree)."""
    from gravinv3dhmc_tpu_torch.uniformgrid import build_problem, sampler

    runs = {}
    for where in (dev, torch.device("cpu")):
        module, dobs = build_problem(8, 12, 4, device=where)
        chain = sampler(module, dobs, where, 64, 16, 0.05, (3, 8), 0.001,
                        0.001, torch.float32, seed=3, initial=0.3)
        runs[where.type] = chain.sample(16, 16)
    a, b = runs["cuda"], runs["cpu"]
    same = np.asarray(a["accepted"]) == np.asarray(b["accepted"])
    sa, sb = a["samples"].cpu(), b["samples"]
    close = torch.isclose(sa, sb, rtol=5e-3, atol=5e-4).flatten(1).all(1)
    agree = same & close.numpy()
    line("reference", chains=int(same.size), same_accepts=int(same.sum()),
         agree=int(agree.sum()), accept_ratio=a["accept_ratio"])
    if agree.mean() < 0.95 or not 0 < a["accept_ratio"] < 1:
        fail("reference: card and CPU runs disagree")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from gravinv3dhmc_tpu_torch import uniformgrid
    from gravinv3dhmc_tpu_torch.ops import _cuda, philox
    from gravinv3dhmc_tpu_torch.ops import leapfrog as tlf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = card()

    t0 = time.perf_counter()
    lib = _cuda.library()
    ptxas = [ln.strip() for ln in lib.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    line("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=lib.build_seconds, card=smi,
         torch=torch.__version__, cuda=torch.version.cuda, ptxas=ptxas)

    phase_philox(torch, tlf, philox, dev)

    t0 = time.perf_counter()
    module, dobs = uniformgrid.build_problem(device=dev)
    line("problem", seconds=time.perf_counter() - t0,
         shape=[int(dobs.size), module.n_active])
    op = tlf.make_fused_iteration(
        *fused_args(module, dobs), regularization="MS", beta=0.001,
        Sigma=0.001, matvec_dtype=torch.bfloat16, device=dev)
    kres = phase_kernels(torch, tlf, op, uniformgrid.SLICE["nchains"], dev)
    phase_traj(torch, tlf, module, dobs, dev)
    phase_iter(torch, tlf, philox, module, dobs, dev)
    counts = phase_slice(torch, tlf, module, dobs, dev, smi)
    phase_reference(torch, dev)

    print(smi)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "gravinv3dhmc_tpu_torch/csrc/leapfrog.cu",
         "replaces": tlf.KERNELS[name].replaces,
         "launches": counts[name], "max_abs_err": kres[name]["max_abs_err"],
         "ms": kres[name]["ms"], "plain_ms": kres[name]["plain_ms"]}
        for name in tlf.KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
