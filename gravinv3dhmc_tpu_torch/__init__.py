"""gravinv3dhmc_tpu_torch — the PyTorch/CUDA port of gravinv3dhmc_tpu.

A second package beside the JAX one, mirroring its layout (``mesher/``,
``utils/``, ``ops/``, ``inversion/``, ``diagnostics.py``). It imports
torch, numpy and scipy and never jax or ``gravinv3dhmc_tpu``: the host
numpy layers it needs are copied in, and the Pallas TPU kernels on its
path are CUDA C++ kernels written for Hopper (``csrc/``), built with nvcc
at first use. The JAX package stays the reference the tests hold this one
against.

Three slices are ported. uniformgrid (``uniformgrid.py``): prism mesh,
f64 prism gz matrix, sensitivity weighting, the MS/Damping potential
under the 'mandatory' clamp, and fixed-dt shared-L HMC through the fused
iteration kernels. ratiogrid (``ratiogrid.py``): the geometric-ratio
mesh, the f32 gz matrix built on the GPU by its own kernel, and the
chunk sampler's per-step branch through the fused step kernels. realdata
(``realdata.py``): segmented, topography-carved tesseroids with frozen
cells, the f64 tesseroid matrix from a native host engine, and the
windowed warmup (dual-averaged dt, a diagonal metric) through the fused
trajectory kernels on an f32 matrix. ``bench.py`` runs the JAX bench's
two stages, uniformgrid and realdata, and prints its one JSON line.
``samplers.py`` runs the adaptive samplers (ChEES, NUTS) on the honest
posterior, and ``cg.py`` the deterministic inversion (projected CG,
bootstrap, the bounded MAP that calibrates the realdata temperature,
``inversion/reginv.py``). Files and state keep the JAX package's layouts:
sample files through a native sink (``runtime/sink.py``), checkpoints
that resume a run exactly (``checkpoint.py``) and the kernel disk cache.
``inversion/joint.py`` inverts gravity and magnetics jointly, and
``global_tess.py`` runs the whole-Earth workload on a tesseroid matrix
built on the card (``ops/tesseroid.tesseroid_kernel_device``). The user's
front door is ``python -m gravinv3dhmc_tpu_torch.run <workload>``, the
port of ``examples/run.py`` over ``workloads.py``; ``compat/``, ``vis/``
and ``profiling.py`` complete the JAX package's surface.
"""

__version__ = "0.1.0"

from . import constants  # noqa: F401
