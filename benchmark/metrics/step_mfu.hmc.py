"""step_mfu.hmc (whole step, %): a unit's least time times the window's
units, over the window's wall seconds: the whole step's share of the
chip's peak, read in the traced run's unprofiled window."""


def read(rec):
    if rec.get("path") != "hmc" or not rec.get("units"):
        return None
    return 100.0 * rec["least_s"] * rec["units"] / rec["window_s"]
