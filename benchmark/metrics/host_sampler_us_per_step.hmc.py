"""host_sampler_us_per_step.hmc (sampler layer, us): the host's wall time
inside the program's ``hmc.chunk`` spans not covered by a ``kernel.*``
span (the sampler's Python, its torch operations and allocations, the
store, the host draw of L) in the traced stretch, over its batch steps.
Wall time, as ``host_kernel_us_per_step.hmc``."""
from benchmark import program_spans


def read(rec):
    spans = program_spans.load(rec)
    steps = None if spans is None else program_spans.batch_steps(spans)
    if not steps:
        return None
    host_ns = program_spans.chunk_ns(spans) - program_spans.kernel_ns(spans)
    return host_ns * 1e-3 / steps
