"""host_kernel_us_per_step.hmc (kernels layer, host issue, us): the host's
wall time inside the program's ``kernel.*`` spans (each hand-written
kernel's issue: pointer checks, ctypes, the C entry's tensor maps and
launch) in the traced stretch, over its batch steps (the ``hmc.iteration``
spans' steps). Wall time: with the launch queue full it holds the wait for
a slot, which ``issue_lead_ms.hmc`` tells apart."""
from benchmark import program_spans


def read(rec):
    spans = program_spans.load(rec)
    steps = None if spans is None else program_spans.batch_steps(spans)
    if not steps:
        return None
    return program_spans.kernel_ns(spans) * 1e-3 / steps
