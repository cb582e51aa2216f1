"""The program's own spans, as the ``program_span`` metrics read them.

``gravinv3dhmc_tpu_torch.profiling.spans()`` holds what the program
recorded while a ``torch.profiler`` session was active: in a traced run,
the harness's stretch (the program starts its buffer afresh when a
profiler session turns its tracing on, and the window runs unprofiled).
Each span has a name, ``start_ns`` and ``end_ns`` on ``time.time_ns()``
(the profiler's clock), its parent's index, its chunk and its attributes:
``hmc.chunk`` (one chunk), ``hmc.iteration`` (one iteration: ``steps``,
its batch steps, and on the card ``mark_ns``, the host's time when it
issued the iteration's start, and ``device_ns``, the card's time there)
and ``kernel.<name>`` (one hand-written kernel's issue). A program
without ``profiling.spans`` gives nothing to read.
"""
from __future__ import annotations

import statistics


def load(rec):
    """The spans of the traced stretch, or None: not the hmc path, no
    ``profiling.spans`` in the program, or no iteration recorded."""
    if rec.get("path") != "hmc":
        return None
    try:
        from gravinv3dhmc_tpu_torch import profiling
    except ImportError:
        return None
    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    spans = spans()
    if not any(s.name == "hmc.iteration" and s.end_ns is not None
               for s in spans):
        return None
    return spans


def _ns(s):
    return s.end_ns - s.start_ns


def batch_steps(spans):
    """The potential evaluations of the chain batch: the iterations'
    ``steps``."""
    return sum(s.attrs["steps"] for s in spans
               if s.name == "hmc.iteration" and s.end_ns is not None)


def kernel_ns(spans):
    """Host time inside ``kernel.*`` spans of the chunks (a kernel span
    inside another counted once)."""
    return sum(_ns(s) for s in spans
               if s.name.startswith("kernel.") and s.end_ns is not None
               and s.chunk is not None
               and not (s.parent >= 0
                        and spans[s.parent].name.startswith("kernel.")))


def chunk_ns(spans):
    """Host time inside the ``hmc.chunk`` spans."""
    return sum(_ns(s) for s in spans
               if s.name == "hmc.chunk" and s.end_ns is not None)


def leads_ms(spans):
    """Each iteration's lead: the card's time at its start marker less the
    host's when it issued it, in ms."""
    return [(s.attrs["device_ns"] - s.attrs["mark_ns"]) * 1e-6
            for s in spans if s.name == "hmc.iteration"
            and s.attrs and "device_ns" in s.attrs]


def median(values):
    return statistics.median(values) if values else None
