"""accept_ratio (sampler layer): the window's accepts, summed on the
card, over its proposals (chains times iterations)."""


def read(rec):
    if rec.get("path") != "hmc" or not rec.get("proposals"):
        return None
    return rec["accepts"] / rec["proposals"]
