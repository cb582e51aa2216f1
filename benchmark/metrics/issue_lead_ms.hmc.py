"""issue_lead_ms.hmc (sampler layer: the host-to-card queue, ms): the
median, over the traced stretch's iterations, of the time the card
reached an iteration's start marker less the time the host issued it
(the program's ``hmc.iteration`` spans). Near zero, the card waited for
the host there; several ms, the host ran that far ahead. None without a
card (no marker) or without the program's spans."""
from benchmark import program_spans


def read(rec):
    spans = program_spans.load(rec)
    if spans is None:
        return None
    return program_spans.median(program_spans.leads_ms(spans))
