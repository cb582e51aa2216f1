"""launches_per_step.hmc (sampler layer): the device operations in the
traced stretch over its batch leapfrog steps."""


def read(rec):
    if rec.get("path") != "hmc" or not rec.get("prof_batch_steps"):
        return None
    if not rec.get("prof_busy_s"):
        return None
    return rec["prof_launches"] / rec["prof_batch_steps"]
