"""The uniformgrid slice: the JAX bench's flagship problem and sampler
settings (``gravinv3dhmc_tpu/bench.py`` ``build_problem`` and its
uniformgrid stage), rebuilt from this package's own layers, and a profile
of it.

``python -m gravinv3dhmc_tpu_torch.uniformgrid`` (on a machine with a
GPU) samples the 600 x 6000 problem with 1024 chains a few times with
different seeds, printing grad-evals/s per run, then runs one chunk under
``torch.profiler``: device busy time (the union of kernel intervals)
against the host's wall time, and device time by kernel. One JSON object
per line; ``--out FILE`` also writes the profiler's table there.
``--matvec float32`` runs the fused iteration on an f32 matrix (the JAX
bench's ``BENCH_MATVEC_DTYPE=float32``) instead of the default bf16.

Two more stages at the flagship's full width (20 x 30 x 10 prisms, 600
observations), ``--stage``:

* ``magnetic`` (:func:`run_magnetic`): the same body as a magnetization
  of 2 A/m induced along a field of inclination 50 and declination 20
  degrees, its total field with 2 % noise, box [0, 3] A/m; the module's
  ``field="magnetic"`` matrix (columns of both signs) sampled by the
  bench's sampler, 1024 chains through the bf16 iteration op.
* ``wavelet`` (:func:`run_wavelet`): the gravity problem with
  ``wavelet="1D"`` and ``"3D"``: the thresholded ``Awcp`` (600 x 6000 and
  600 x 6210), MS under 'mandatory', 64 chains on the eager path (the
  fused kernels do not take a wavelet kernel, as in the JAX package),
  shared L, then the two sparse products (``Awcp W m`` and ``Awcp^T r``)
  timed on the card beside one ``torch.matmul`` with the dense ``Aw`` at
  the same shape, and one chunk profiled (device busy against wall).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from . import _device, mesher, profiling, utils
from .inversion.hmc import HamiltonianMC
from .inversion.potential import GravMagModule
from .ops import prism

#: the bench's uniformgrid sampler settings at full width
SLICE = dict(nchains=1024, chunk=128, nsamples=64, ndraws=256, dt=0.01,
             Lrange=(5, 20), Sigma=0.001, beta=0.001)
#: the magnetic stage's field, body and box (A/m)
MAGNETIC = dict(mangle=(50.0, 20.0), magnetization=2.0, box=(0.0, 3.0))
#: the wavelet stage's eager sampler: chains, chunk and stored iterations
WAVELET = dict(nchains=64, chunk=32, nsamples=64, ndraws=32)


def density_model(nx, ny, nz):
    """The bench's unit-density block, (nz, ny, nx); at 20 x 30 x 10 it is
    ``rho[2:5, 10:18, 7:11]`` exactly as ``bench.py`` sets it."""
    rho = np.zeros((nz, ny, nx))
    rho[nz // 5:nz // 2, ny // 3:(3 * ny) // 5,
        (7 * nx) // 20:(11 * nx) // 20] = 1.0
    return rho


def build_problem(nx=20, ny=30, nz=10, spacing=100.0, device=None,
                  field="gravity", mangle=(90, 0), wavelet=False):
    """``(module, dobs)``: nx * ny observations at z = 0 over nx * ny * nz
    prisms of ``spacing`` metres, the module on ``device`` (``cuda:0``
    when None). The default is the bench's 600 x 6000 problem: gz of the
    unit-density block from the f64 prism builder with 2 % of max noise
    (seed 1). ``field="magnetic"``: the block magnetized at
    ``MAGNETIC["magnetization"]`` A/m along the field of ``mangle`` and
    its total field with 2 % of max|d| noise (the JAX workloads'
    ``forward_with_noise``). ``wavelet`` ("1D", "3D") is the module's.
    The noise's standard deviation is ``module.noise_sigma``."""
    d = spacing
    bounds = (0, nx * d, 0, ny * d, 0, nz * d)
    mesh = mesher.PrismMesh(bounds, (d, d, d))
    body = density_model(nx, ny, nz).ravel()
    xo, yo, zo = utils.regular((0, nx * d, 0, ny * d), (nx, ny), z=0.0)
    if field == "magnetic":
        mesh.addprop("magnetization", MAGNETIC["magnetization"] * body)
        pre, _ = prism.tf(xo, yo, zo, mesh, *mangle)
        sigma = 0.02 * float(np.abs(pre).max())
    else:
        mesh.addprop("density", body)
        pre, _ = prism.gz(xo, yo, zo, mesh)
        sigma = 0.02 * float(pre.max())
    dobs = utils.contaminate(pre, sigma, seed=1)
    module = GravMagModule(dobs, bounds, (d, d, d), (xo, yo, zo),
                           field=field, mangle=mangle, wavelet=wavelet,
                           verbose=False, device=device)
    module.noise_sigma = sigma
    return module, dobs


def sampler(module, dobs, device, nchains, chunk, dt, Lrange, Sigma, beta,
            matvec, seed=0, initial=0.001, high=1.0):
    """A fixed-dt ``HamiltonianMC`` on the fused kernels with the bench's
    run semantics: shared L, MS regularization, ``store_mode='chain'``,
    bounds [0, ``high``] and a priori 0.001 in reference units."""
    M = module.n_active
    w = module.wdiag
    chain = HamiltonianMC(module)
    chain.device = device
    chain.dt, chain.Lrange, chain.Sigma = dt, list(Lrange), Sigma
    chain.regularization, chain.beta = "MS", beta
    chain.RegulFactor = 1.0
    chain.nchains, chain.chunk_size = nchains, chunk
    chain.seed = seed
    chain.verbose = False
    chain.use_fused = True
    chain.shared_L = True
    chain.store_mode = "chain"
    chain.fused_matvec_dtype = matvec
    chain.low, chain.high = w * np.zeros(M), w * np.full(M, high)
    chain.initial_model = w * np.full(M, initial)
    chain.aprior_model = w * np.full(M, 0.001)
    chain.dobs = dobs
    return chain


def slice_sampler(module, dobs, device, seed=0, matvec=torch.bfloat16,
                  high=1.0, **overrides):
    """:func:`sampler` at the :data:`SLICE` settings, a bf16 matrix unless
    ``matvec`` says otherwise."""
    cfg = dict(SLICE, **overrides)
    return sampler(module, dobs, device, cfg["nchains"], cfg["chunk"],
                   cfg["dt"], cfg["Lrange"], cfg["Sigma"], cfg["beta"],
                   matvec, seed=seed, high=high)


def _result_line(res, module, dobs, chain):
    return dict(problem=[int(dobs.size), module.n_active],
                nchains=chain.nchains, chunk=chain.chunk_size,
                iterations=res["attempted"] // chain.nchains,
                fused_mode=res["fused_mode"],
                grad_evals_per_s=res["grad_evals_per_s"],
                grad_evals=res["grad_evals"], elapsed_s=res["elapsed_s"],
                accept_ratio=res["accept_ratio"],
                ess_median=res["ess_median"])


def run_magnetic(device, problem=None, seed=0):
    """The magnetic stage: ``(line, result)`` of one :data:`SLICE` run on
    the magnetic problem (1024 chains, the bf16 iteration op, box
    ``MAGNETIC["box"]``); ``problem`` is a ``build_problem(field=
    "magnetic", ...)`` pair to reuse."""
    module, dobs = problem or build_problem(
        device=device, field="magnetic", mangle=MAGNETIC["mangle"])
    chain = slice_sampler(module, dobs, device, seed=seed,
                          high=MAGNETIC["box"][1])
    res = chain.sample(SLICE["nsamples"], SLICE["ndraws"])
    line = dict(stage="magnetic", mangle=list(MAGNETIC["mangle"]),
                box=list(MAGNETIC["box"]),
                A_range=[float(module.A.min()), float(module.A.max())],
                **_result_line(res, module, dobs, chain))
    return line, res


def wavelet_sampler(module, dobs, device, seed=0):
    """:func:`sampler` at :data:`SLICE`'s dt, L and Sigma with
    :data:`WAVELET`'s chains and chunk: the fused path is asked for and
    gives way to the eager one (``_fused_mode`` "off")."""
    return sampler(module, dobs, device, WAVELET["nchains"],
                   WAVELET["chunk"], SLICE["dt"], SLICE["Lrange"],
                   SLICE["Sigma"], SLICE["beta"], torch.bfloat16, seed=seed)


def sparse_products(module, device, C):
    """The wavelet path's two products at ``C`` chains, each with its
    dense counterpart: ``{name: (fn, dense_fn)}``. ``forward``: ``Awcp``
    (D x K CSR) times the coefficients (K x C), beside ``Aw`` (D x M)
    times the models (M x C); ``adjoint``: ``Awcp^T`` (its own CSR, K x D)
    times the residuals (D x C), beside ``Aw^T`` times them."""
    arrs = module.device_arrays()
    Aw = arrs["Aw"]
    D, M = Aw.shape
    K = arrs["Awcp"].shape[1]
    gen = torch.Generator(device=device).manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=device,
                           dtype=Aw.dtype)

    mcp, x, r = rand(K, C), rand(M, C), rand(D, C)
    return {"forward": (lambda: arrs["Awcp"] @ mcp, lambda: Aw @ x),
            "adjoint": (lambda: arrs["AwcpT"] @ r, lambda: Aw.T @ r)}


def run_wavelet(device, mode, problem=None, seed=0, nsamples=None,
                ndraws=None):
    """The wavelet stage in ``mode`` ("1D", "3D"): ``(line, result)`` of
    one :data:`WAVELET` run (eager, 64 chains; ``nsamples`` and ``ndraws``
    cut it); the line has the steps' wall ms (``ms_per_step``) and
    ``Awcp``'s shape and nonzeros."""
    module, dobs = problem or build_problem(device=device, wavelet=mode)
    chain = wavelet_sampler(module, dobs, device, seed=seed)
    res = chain.sample(nsamples or WAVELET["nsamples"],
                       ndraws or WAVELET["ndraws"])
    steps = res["grad_evals"] / chain.nchains
    awcp = module.Awcp
    line = dict(stage="wavelet", mode=mode,
                Awcp=[list(awcp.shape), int(awcp.nnz)],
                density=awcp.nnz / (awcp.shape[0] * awcp.shape[1]),
                ms_per_step=res["elapsed_s"] * 1e3 / steps,
                wavelet_build_s=module.build_seconds["wavelet_s"],
                **_result_line(res, module, dobs, chain))
    return line, res


def profile_chunk(chain, chunk_idx=1):
    """One chunk of ``chain`` under ``torch.profiler`` after a warm chunk
    (:func:`.profiling.profile_run`): host wall time, device busy time,
    device time by kernel, host time and device idle by program span."""
    run_chunk, carry = chain.prepare(nsamples=chain.chunk_size, ndraws=0)
    return profiling.profile_run(run_chunk, carry, chain.seed,
                       _device.resolve(chain.device), chunk_idx)


def time_products(module, device, C, rounds=5):
    """Device ms (median of ``rounds`` of ``timing.device_ms``) of the
    wavelet path's two sparse products and their dense counterparts at
    ``C`` chains (:func:`sparse_products`)."""
    from .timing import device_ms

    out = {}
    for name, (fn, dense) in sparse_products(module, device, C).items():
        out[name] = {k: float(np.median([device_ms(f) for _ in
                                         range(rounds)]))
                     for k, f in (("sparse_ms", fn), ("dense_ms", dense))}
    return out


def parse_args(argv=None):
    """The command line, with ``--matvec`` as a torch dtype."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage", choices=("gravity", "magnetic", "wavelet"),
                    default="gravity",
                    help="the problem: the bench's gravity one (default), "
                         "its magnetic twin, or gravity on the wavelet "
                         "kernel (1D and 3D)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="full slice runs, seeds 0..repeats-1")
    ap.add_argument("--profile-chunk", type=int, default=32,
                    help="iterations in the profiled chunk")
    ap.add_argument("--matvec", choices=("bfloat16", "float32"),
                    default="bfloat16",
                    help="storage type of the kernel matrix")
    ap.add_argument("--out", help="write the profiler's table here")
    args = ap.parse_args(argv)
    args.matvec = getattr(torch, args.matvec)
    return args


def _profile(chain, out, tag):
    """One chunk of at most 32 iterations profiled: the summary on one
    line (the 12 longest kernels, names cut to 100 characters), the
    profiler's table appended to ``out``."""
    chain.chunk_size = min(chain.chunk_size, 32)
    summary, prof = profile_chunk(chain)
    summary["by_kernel"] = [[k[:100], ms, n] for k, ms, n in
                            summary["by_kernel"][:12]]
    print(json.dumps({"profile": summary, "stage": tag}), flush=True)
    if out:
        with open(out, "a") as f:
            f.write(f"== {tag}\n" + prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=25) + "\n")


def main(argv=None):
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("uniformgrid profile: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = _device.card()
    print(card, flush=True)
    if args.out:
        open(args.out, "w").close()
    if args.stage == "magnetic":
        problem = build_problem(device=dev, field="magnetic",
                                mangle=MAGNETIC["mangle"])
        for seed in range(args.repeats):
            line, _ = run_magnetic(dev, problem, seed=seed)
            print(json.dumps({"card": card, "seed": seed, **line}),
                  flush=True)
        _profile(slice_sampler(*problem, dev, high=MAGNETIC["box"][1]),
                 args.out, "magnetic")
        return 0
    if args.stage == "wavelet":
        for mode in ("1D", "3D"):
            problem = build_problem(device=dev, wavelet=mode)
            for seed in range(args.repeats):
                line, _ = run_wavelet(dev, mode, problem, seed=seed)
                print(json.dumps({"card": card, "seed": seed, **line}),
                      flush=True)
            print(json.dumps({"card": card, "mode": mode,
                              "products": time_products(
                                  problem[0], dev, WAVELET["nchains"])}),
                  flush=True)
            _profile(wavelet_sampler(*problem, dev), args.out,
                     f"wavelet {mode}")
        return 0
    module, dobs = build_problem(device=dev)
    rates = []
    for seed in range(args.repeats):
        res = slice_sampler(module, dobs, dev, seed=seed,
                            matvec=args.matvec).sample(SLICE["nsamples"],
                                                       SLICE["ndraws"])
        rates.append(res["grad_evals_per_s"])
        print(json.dumps({"seed": seed, "matvec": str(args.matvec),
                          "grad_evals_per_s":
                          res["grad_evals_per_s"],
                          "accept_ratio": res["accept_ratio"],
                          "elapsed_s": res["elapsed_s"],
                          "grad_evals": res["grad_evals"]}), flush=True)
    chain = slice_sampler(module, dobs, dev, matvec=args.matvec,
                          chunk=args.profile_chunk)
    summary, prof = profile_chunk(chain)
    print(json.dumps({"profile": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=25))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
