"""setup_s (s): the set-up's seconds, from the start of the process to
the end of the burn-in, each phase ended by a synchronise."""


def read(rec):
    return rec.get("setup_s")
