"""Forward operators, random numbers and the fused leapfrog kernels."""
