"""Time the gz kernels and ``draws`` against another commit's sources, in
turns, and count the instructions of their SASS.

``python -m gravinv3dhmc_tpu_torch.gz_tune --baseline-gz OLD_prism_gz.cu
--baseline-leapfrog OLD_leapfrog.cu [--sass DIR]`` (on a machine with a
GPU) builds this package's ``csrc/prism_gz.cu`` and ``csrc/leapfrog.cu``,
the two baseline sources (such as an earlier commit's, with the same C
entries; the baseline ``prism_gz.cu`` needs only ``gz_matrix``, the
baseline ``leapfrog.cu`` only ``lf_draws`` and ``lf_refresh``) and one
``prism_gz.cu`` for every block shape of the node
kernel in :data:`CONFIGS`, one nvcc each, into the
package's ``_build/variants/``, and one ``leapfrog.cu`` for every
``draws`` block of :data:`DRAWS_CONFIGS` (``kick_tune``'s builders).
Then, one JSON object a line, the card's name and power limit first:

- ``gz``: the ratiogrid matrix (900 x 17,100) from the baseline's corner
  kernel, this source's corner kernel and its node kernel, checked bit
  for bit against each other, then timed in turns, baseline first (b, c,
  c, b, :data:`ROUNDS` times; c times the node kernel and the corner
  kernel back to back);
- ``gz_nodes_config``: each node-kernel block of :data:`CONFIGS`, bit
  for bit against the corner kernel, the configs in turn;
- ``draws_config``: each ``draws`` block of :data:`DRAWS_CONFIGS`, bit
  for bit against this source's, the configs in turn;
- ``draws``: at 1024 x 17,152 the baseline's and this source's ``draws``
  bit for bit (normals and uniforms), ``refresh``'s normals from both
  bit for bit, then both ``draws`` and both p-only ``refresh`` timed in
  turns, beside ``torch.randn(C, Mp)`` + ``torch.rand(C)``, the one
  PyTorch call of the same distribution (not the same values; the port
  never calls it);
- ``sass``: for each kernel function of :data:`SASS_FUNCTIONS` in each
  library, the instructions one thread issues by class
  (:data:`sass.ARITHMETIC` by pipe, the rest by opcode) along its fast
  path (:func:`sass.path`: the slow paths of sincosf, division and square
  root skipped); ``sass_units``: :func:`sass.unit_counts` of this
  package's libraries, the counts ``chip_smoke.py`` bounds ``draws``,
  ``refresh`` and gz with; ``--sass DIR`` also writes each library's full
  ``cuobjdump -sass`` there.
"""
from __future__ import annotations

import argparse
import json
import statistics
from pathlib import Path

import numpy as np
import torch

from . import sass
from .kick_tune import build_baseline, build_variants, card, use_library
from .ops import _cuda, philox, prism_gz
from .ops import leapfrog as tlf
from .timing import device_ms

#: (threads a block, index words a thread loaded ahead) of the node
#: kernel; the first is the one ``prism_gz.cu`` ships
CONFIGS = [(256, 1), (256, 2), (256, 4), (512, 1), (128, 1)]
#: (threads a block, float4 groups a thread) of ``draws``; the first is
#: the one ``leapfrog.cu`` ships
DRAWS_CONFIGS = [(256, 4), (256, 2), (256, 1), (128, 4), (512, 2), (256, 8)]
#: timing rounds (b, c, c, b each)
ROUNDS = 3
#: (chains, Mp) of the draws at ratiogrid's width
DRAWS_SHAPE = (1024, 17152)
#: the functions whose SASS is counted
SASS_FUNCTIONS = ("draws_kernel", "refresh_kernel", "gz_kernel",
                  "gz_nodes_kernel")

def gz_operands(device):
    """The ratiogrid matrix's operands on ``device``: obs (900, 3) and
    cells (17,100, 6) as float32 tensors, the scale, and the node
    kernel's table arguments."""
    from . import constants, ratiogrid

    mesh, (xo, yo, zo) = ratiogrid.mesh_and_obs()
    cells = mesh.cell_bounds(only_active=True).astype(np.float32)
    name, tables = prism_gz.gz_plan(cells)
    if name != "gz_nodes":
        raise RuntimeError(f"ratiogrid's cells dispatch to {name}")
    obs = torch.as_tensor(np.stack([xo, yo, zo], 1), dtype=torch.float32,
                          device=device)
    return (obs, torch.as_tensor(cells, device=device),
            float(np.float32(constants.G * constants.SI2MGAL)),
            prism_gz.node_args(tables, device))


def time_gz(smi, dev):
    obs, cells, scale, tables = gz_operands(dev)
    corner, nodes = tlf.KERNELS["gz"], tlf.KERNELS["gz_nodes"]
    outs = {}
    for lib in ("baseline", "current"):
        use_library("gz_baseline" if lib == "baseline" else
                    "prism_gz_current", "prism_gz")
        outs[lib] = corner(obs, cells, scale)
    outs["nodes"] = nodes(obs, *tables, scale)
    torch.cuda.synchronize()
    equal = {"nodes_vs_corner": torch.equal(outs["nodes"], outs["current"]),
             "corner_vs_baseline": torch.equal(outs["current"],
                                               outs["baseline"])}
    times = {"baseline": [], "current_corner": [], "current_nodes": []}
    for lib in ["baseline", "current", "current", "baseline"] * ROUNDS:
        if lib == "baseline":
            use_library("gz_baseline", "prism_gz")
            times["baseline"].append(device_ms(
                lambda: corner(obs, cells, scale), reps=10, warmup=2))
            continue
        use_library("prism_gz_current", "prism_gz")
        times["current_nodes"].append(device_ms(
            lambda: nodes(obs, *tables, scale), reps=10, warmup=2))
        times["current_corner"].append(device_ms(
            lambda: corner(obs, cells, scale), reps=10, warmup=2))
    use_library("prism_gz_current", "prism_gz")
    print(json.dumps({
        "gz": [int(obs.shape[0]), int(cells.shape[0])], "bit_equal": equal,
        **{f"{k}_median_ms": statistics.median(v) for k, v in times.items()},
        "ms": times, "card": smi}), flush=True)
    return outs["current"]


def ptxas_lines(lib, function):
    """ptxas's registers and spill lines for ``function`` from the
    library's build log."""
    out, on = [], False
    for ln in lib.build_log.splitlines():
        if "Compiling entry function" in ln or "Function properties" in ln:
            on = function in ln
        elif on and ("registers" in ln or "spill" in ln):
            out.append(ln.split("info    :")[-1].strip())
    return out


def sweep_nodes(names, reference, smi, dev):
    obs, _, scale, tables = gz_operands(dev)
    nodes = tlf.KERNELS["gz_nodes"]
    equal, times = {}, {cfg: [] for cfg in names}
    for cfg, name in names.items():
        use_library(name, "prism_gz")
        equal[cfg] = torch.equal(nodes(obs, *tables, scale), reference)
    for _ in range(ROUNDS):
        for cfg, name in names.items():
            use_library(name, "prism_gz")
            times[cfg].append(device_ms(lambda: nodes(obs, *tables, scale),
                                        reps=10, warmup=2))
    use_library("prism_gz_current", "prism_gz")
    for cfg, ms in times.items():
        print(json.dumps({
            "gz_nodes_config": dict(zip(("threads", "prefetch"), cfg)),
            "ptxas": ptxas_lines(_cuda._LIBRARIES[names[cfg]],
                                 "gz_nodes_kernel"),
            "bit_equal_to_corner": equal[cfg],
            "ms_median": statistics.median(ms), "ms": ms, "card": smi}),
            flush=True)


def sweep_draws(names, smi, dev):
    """Each ``draws`` block of :data:`DRAWS_CONFIGS`: bit for bit against
    this source's draws, then the configs in turn."""
    C, Mp = DRAWS_SHAPE
    draws = tlf.KERNELS["draws"]
    salt = philox.salt_from_seed(6)

    def run():
        n01, u = torch.empty((C, Mp), device=dev), torch.empty(C, device=dev)
        draws(n01, u, salt, 7)
        return n01, u

    use_library("leapfrog_current")
    ref = run()
    equal, times = {}, {cfg: [] for cfg in names}
    for cfg, name in names.items():
        use_library(name)
        out = run()
        equal[cfg] = all(torch.equal(a, b) for a, b in zip(out, ref))
    bench = (torch.empty((C, Mp), device=dev), torch.empty(C, device=dev),
             salt, 7)
    for _ in range(ROUNDS):
        for cfg, name in names.items():
            use_library(name)
            times[cfg].append(device_ms(lambda: draws(*bench), reps=50,
                                        warmup=5))
    use_library("leapfrog_current")
    for cfg, ms in times.items():
        print(json.dumps({
            "draws_config": dict(zip(("threads", "unroll"), cfg)),
            "bit_equal_to_current": equal[cfg],
            "ms_median": statistics.median(ms), "ms": ms, "card": smi}),
            flush=True)


def time_draws(smi, dev):
    from .accept_tune import refresh_operands

    C, Mp = DRAWS_SHAPE
    salt = philox.salt_from_seed(6)
    draws, refresh = tlf.KERNELS["draws"], tlf.KERNELS["refresh"]
    zeros = torch.zeros((C, Mp), device=dev)
    ones = torch.ones(Mp, device=dev)
    outs = {}
    for lib in ("baseline", "current"):
        use_library("lf_baseline" if lib == "baseline" else
                    "leapfrog_current")
        n01, u = torch.empty((C, Mp), device=dev), torch.empty(C, device=dev)
        draws(n01, u, salt, 7)
        p, H0 = torch.empty_like(zeros), torch.empty(C, device=dev)
        refresh(zeros, torch.zeros(C, device=dev), ones, ones, 0.0, salt, 7,
                None, p, None, H0)
        outs[lib] = (n01, u, p)
    torch.cuda.synchronize()
    b, c = outs["baseline"], outs["current"]
    equal = {"normals": torch.equal(b[0], c[0]),
             "uniforms": torch.equal(b[1], c[1]),
             "refresh_normals": torch.equal(b[2], c[2]),
             "draws_vs_refresh": torch.equal(c[0], c[2])}
    bench = (torch.empty((C, Mp), device=dev), torch.empty(C, device=dev),
             salt, 7)
    r_args = refresh_operands(C, Mp, 17100, False, device=dev)
    times = {k: [] for k in ("draws_baseline", "draws_current",
                             "refresh_baseline", "refresh_current")}
    for lib in ["baseline", "current", "current", "baseline"] * ROUNDS:
        use_library("lf_baseline" if lib == "baseline" else
                    "leapfrog_current")
        times[f"draws_{lib}"].append(device_ms(lambda: draws(*bench),
                                               reps=50, warmup=5))
        times[f"refresh_{lib}"].append(device_ms(lambda: refresh(*r_args),
                                                 reps=50, warmup=5))
    use_library("leapfrog_current")
    gen = torch.Generator(device=dev).manual_seed(0)
    library = [device_ms(lambda: (torch.randn(C, Mp, generator=gen,
                                              device=dev),
                                  torch.rand(C, generator=gen, device=dev)),
                         reps=50, warmup=5) for _ in range(ROUNDS)]
    print(json.dumps({
        "draws": [C, Mp], "bit_equal": equal,
        **{f"{k}_median_ms": statistics.median(v) for k, v in times.items()},
        "library_median_ms": statistics.median(library), "ms": times,
        "library_ms": library, "card": smi}), flush=True)


def count_sass(libs, out_dir):
    """One ``sass`` line per counted function of each library (the
    issued instructions by class on its fast path, :func:`sass.path` with
    ``skip_slow``), then the ``sass_units`` line of this package's
    libraries."""
    for lib_name, lib in libs.items():
        text, fns = sass.functions(lib)
        if out_dir:
            Path(out_dir).mkdir(parents=True, exist_ok=True)
            (Path(out_dir) / f"{lib_name}.sass").write_text(text)
        for short in SASS_FUNCTIONS:
            try:
                steps = sass.path(*sass.find(fns, short), True)
            except KeyError:
                continue
            print(json.dumps({"sass": short, "library": lib_name,
                              "fast_path": sass.counts(steps)}), flush=True)
    print(json.dumps({"sass_units": sass.unit_counts(libs["leapfrog"],
                                                     libs["prism_gz"])}),
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline-gz", required=True,
                    help="another prism_gz.cu (its gz_matrix is timed)")
    ap.add_argument("--baseline-leapfrog", required=True,
                    help="another leapfrog.cu (its draws and refresh)")
    ap.add_argument("--sass", help="write each library's SASS here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gz_tune: CUDA is not available")
    smi = card()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    libs = _cuda.build_all(["prism_gz", "leapfrog"])
    build_baseline(args.baseline_gz, "prism_gz", ["gz_matrix"],
                   "gz_baseline")
    build_baseline(args.baseline_leapfrog, "leapfrog",
                   ["lf_draws", "lf_refresh"], "lf_baseline")
    names = {cfg: "prism_gz_t{}_p{}".format(*cfg) for cfg in CONFIGS}
    build_variants({name: dict(zip(("GZN_THREADS", "GZN_PREFETCH"), cfg))
                    for cfg, name in names.items()}, "prism_gz")
    dnames = {cfg: "leapfrog_draws_t{}_u{}".format(*cfg)
              for cfg in DRAWS_CONFIGS}
    build_variants({name: dict(zip(("DRAWS_THREADS", "DRAWS_UNROLL"), cfg))
                    for cfg, name in dnames.items()})
    _cuda._LIBRARIES["prism_gz_current"] = libs["prism_gz"]
    _cuda._LIBRARIES["leapfrog_current"] = libs["leapfrog"]
    count_sass({n: _cuda._LIBRARIES[n] for n in
                ("prism_gz", "leapfrog", "gz_baseline", "lf_baseline")},
               args.sass)
    reference = time_gz(smi, dev)
    sweep_nodes(names, reference, smi, dev)
    time_draws(smi, dev)
    sweep_draws(dnames, smi, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
