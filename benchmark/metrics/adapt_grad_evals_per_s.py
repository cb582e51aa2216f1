"""adapt_grad_evals_per_s (adapt layer, grad-evals/s): the warmup's
gradient evaluations of every chain (the program's ``adapt_grad_evals``
counter) over its ``hmc.adapt`` span's seconds. The warmup issues its
chunks directly: a carry with Welford moments never replays. None where
the program has no such span or counter."""


def read(rec):
    if not rec.get("adapt_s") or not rec.get("adapt_grad_evals"):
        return None
    return rec["adapt_grad_evals"] / rec["adapt_s"]
