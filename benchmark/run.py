"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder
and ``gravinv3dhmc_tpu_torch``. Set-up phases go to standard error as
they end, each timed to a ``torch.cuda.synchronize()``; the checked
numbers, each beside its limit, are the last lines there. The last line
of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` the
trace's ``breakdown``, and ``checks`` last.

The run exits non-zero and prints no result when no CUDA card is seen,
when the program or a part of the cell is missing, or when a module of
JAX or of the JAX package is loaded once the window has closed.

``--control`` puts the cell's control (its ``control`` in the traffic
file: the plain reference in a lower precision, or the program on a
lower-precision path of its own) in the program's place. The benchmark's
own runs never pass it; the control's runs show that the check fails it.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache in the checkout, at fixed paths
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = str(ROOT / "benchmark" / ".cache" / _sub)
os.environ["USE_FLAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="run the cell's control in the program's place")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from benchmark import harness

    if not (ROOT / "BENCHMARK.json").is_file():
        harness.log("no BENCHMARK.json in the checkout")
        return 2
    cell = harness.find_cell(ROOT, args.workload)[0]
    import torch

    if not torch.cuda.is_available():
        harness.log("no CUDA device: the benchmark runs on the card only")
        return 3
    if torch.cuda.device_count() < int(cell["chips"]):
        harness.log(f"{args.workload} needs {cell['chips']} cards, "
                    f"{torch.cuda.device_count()} seen")
        return 3
    harness.log(f"[card] {harness.card_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                            args.trace, control=args.control,
                            t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"loaded in this process: {', '.join(bad)}; the "
                    "benchmark may load neither JAX nor the JAX package")
        return 4
    for name, c in line["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILED"
        harness.log(f"[check] {name} = {c['value']!r} (limit "
                    f"{c['limit']!r}) {ok}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
