"""What the drivers share: the extensions' load and the compared numbers."""
from __future__ import annotations


def load_extensions(ctx):
    """Load (on a checkout's first run: build) the program's CUDA kernel
    library, on the card."""
    if ctx.device.type == "cuda":
        from gravinv3dhmc_tpu_torch.ops import _cuda
        _cuda.library("leapfrog")


def compared(numbers, limits):
    """The numbers that ``limits`` names, each with its limit, in the
    result line's form; the others go to standard error."""
    from benchmark import harness
    for name, v in numbers.items():
        if name not in limits:
            harness.log(f"[check] {name} = {v!r} (not compared)")
    return {name: {"value": v, "limit": limits[name]}
            for name, v in numbers.items() if name in limits}
