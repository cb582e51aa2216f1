"""The plain reference of the benchmark: PyTorch and NumPy only.

Nothing here imports JAX, the JAX package or anything of the port
(``tests/test_benchmark_imports.py`` holds it to that). It works out
again, from the inputs the harness made, what the program derives: the
matrices, the weighting, the potential and its gradient, the random
draws, the leapfrog trajectories and the accept tests.
"""
