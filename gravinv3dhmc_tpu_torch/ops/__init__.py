"""Forward operators, random numbers and the fused leapfrog kernels.

Importing the package registers every CUDA kernel wrapper in
``_cuda.KERNELS``, so ``launch_counts()`` always covers all of them.
"""
from . import leapfrog, prism_gz  # noqa: F401
