"""ess_per_s.traced (sampler layer): the median, over a fixed sample of
128 cells, of the multi-chain ESS of every draw the window stored, over
the window's seconds; read in the traced run, whose window is unprofiled
(the traced stretch follows it)."""


def read(rec):
    if rec.get("path") != "hmc" or rec.get("ess") is None:
        return None
    return rec["ess"] / rec["window_s"]
