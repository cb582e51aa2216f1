"""Device time of a kernel call on the card, with the host out of it.

The host takes 20-50 us to issue one GEMM call of this package (Python,
two tensor-map encodings, two launches; ``f32_gemm_tune``'s host-issue
lines on an H100 machine), about as long as a realdata-width f32
residual runs on the card. CUDA events around calls issued while the card
runs them then time the host whenever it is the slower, and a kernel's
time moves with the load on the host's cores. :func:`device_ms` queues the
calls behind a spin of the card (``torch.cuda._sleep``), so the card runs
them back to back, and checks that it had not reached the start event by
the time the last call was issued.
"""
from __future__ import annotations

import torch

#: the card's spin ahead of the timed calls, in clock cycles a call: 0.1
#: ms at 2 GHz, twice the host's longest issue time of one call
SPIN_CYCLES_PER_CALL = 200_000


def device_ms(fn, reps=20, warmup=3, cycles_per_call=SPIN_CYCLES_PER_CALL):
    """Mean device time of one call of ``fn``: CUDA events around ``reps``
    calls queued behind a spin of ``cycles_per_call`` clock cycles a call
    (more for a ``fn`` of many launches), after ``warmup`` calls. If the
    card reached the start event before the last call was issued, the run
    is repeated behind a spin twice as long, up to 16 times the first (a
    ``fn`` that waits for the card itself is then timed as it runs)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    first = reps * int(cycles_per_call)
    cycles = first
    while True:
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        ahead = not start.query()
        end.synchronize()
        if ahead or cycles >= 16 * first:
            return start.elapsed_time(end) / reps
        cycles *= 2
