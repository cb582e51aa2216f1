"""grad_evals_per_s: every useful leapfrog gradient evaluation of every
chain in the window (a chain's steps past its own L are not counted), over
the window's seconds to the card's last result."""


def read(rec):
    if rec.get("path") != "hmc":
        return None
    return rec["work"] / rec["window_s"]
