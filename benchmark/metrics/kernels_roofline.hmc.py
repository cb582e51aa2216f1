"""kernels_roofline.hmc (kernels layer, %): a unit's least time
(:mod:`benchmark.roofline`) times the traced stretch's units, over the
device's busy time there (the union of its operations' intervals)."""


def read(rec):
    if rec.get("path") != "hmc" or not rec.get("prof_busy_s"):
        return None
    return 100.0 * rec["least_s"] * rec["prof_units"] / rec["prof_busy_s"]
