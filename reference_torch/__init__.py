"""Plain references of the port's computations, in PyTorch and NumPy.

Nothing here imports JAX, the JAX package or anything of the port
(``gravinv3dhmc_tpu_torch``). Each module works out again, from its
published method, what the port derives, in float64; the port's tests
hold the port against them, and the benchmark keeps byte-for-byte copies
(``benchmark/reference/``) so that its yardstick stays fixed.

- :mod:`.tesseroid`: tesseroid gz by Gauss-Legendre quadrature with the
  distance-to-size subdivision, the South China stand-in's segmented,
  carved mesh and the depth weighting.
- :mod:`.hmc_metric`: one HMC iteration under a diagonal inverse mass,
  Stan's shrunk pooled variance and Nesterov dual averaging (the windowed
  warmup's two estimators).
"""
