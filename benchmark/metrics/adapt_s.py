"""adapt_s (adapt layer, s): the host wall time of the program's windowed
warmup, its ``hmc.adapt`` span, which the driver turns the program's
spans on for in a traced run. None where the program has no such span."""


def read(rec):
    return rec.get("adapt_s")
