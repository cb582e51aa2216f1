"""device_idle_pct.hmc (device layer, %): one less the device's busy time a
unit in the traced stretch over the wall time a unit in the unprofiled
window of the same process."""


def read(rec):
    if rec.get("path") != "hmc" or not rec.get("prof_busy_s"):
        return None
    busy = rec["prof_busy_s"] / rec["prof_units"]
    wall = rec["window_s"] / rec["units"]
    return 100.0 * (1.0 - busy / wall)
