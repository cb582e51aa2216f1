"""The chip's published peaks and the least time of a unit of work.

Peaks of one NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data sheet, dense
rates at the 700 W power limit: 3.35 TB/s of HBM bandwidth and 989
TFLOP/s of bf16 tensor-core throughput. The least time of a unit is the
larger of its bytes over the bandwidth and its operations over the bf16
peak, whatever precision the matrix is stored in, so that no
implementation of an f32 path can read over 100 %. Bytes and operations
follow from the configuration's shapes alone: each input read once and
each output written once.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4, "float64": 8}


def least_s(nbytes, flops):
    """The larger of ``nbytes`` at the bandwidth and ``flops`` at the
    bf16 peak, in seconds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S)


def hmc_step(chains, data, cells, matrix_dtype):
    """``(bytes, flops)`` of one leapfrog gradient evaluation of every
    chain: the (data x cells) matrix read once in ``matrix_dtype``, the
    chains' positions and momenta (float32) read once and written once,
    and the two products (forward and adjoint), 4 C D M operations."""
    nbytes = (data * cells * ITEMSIZE[matrix_dtype]
              + 4 * chains * cells * 4)
    return nbytes, 4 * chains * data * cells

