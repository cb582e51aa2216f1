"""The port stands alone: importing it pulls in neither jax nor the JAX
package, and every CUDA kernel wrapper, given CPU tensors, runs its plain
version without counting a launch."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gravinv3dhmc_tpu_torch.ops import leapfrog as tlf

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import gravinv3dhmc_tpu_torch\n"
            "import gravinv3dhmc_tpu_torch.inversion.hmc\n"
            "import gravinv3dhmc_tpu_torch.diagnostics\n"
            "import gravinv3dhmc_tpu_torch.ops.leapfrog\n"
            "import gravinv3dhmc_tpu_torch.uniformgrid\n"
            "import gravinv3dhmc_tpu_torch.ratiogrid\n"
            "import gravinv3dhmc_tpu_torch.ops.prism_gz\n"
            "import gravinv3dhmc_tpu_torch.f32_gemm_tune\n"
            "import gravinv3dhmc_tpu_torch.accept_tune\n"
            "import gravinv3dhmc_tpu_torch.gz_tune\n"
            "import gravinv3dhmc_tpu_torch.sass\n"
            "import gravinv3dhmc_tpu_torch.realdata\n"
            "import gravinv3dhmc_tpu_torch.bench\n"
            "import gravinv3dhmc_tpu_torch.inversion.nuts\n"
            "import gravinv3dhmc_tpu_torch.inversion.chees\n"
            "import gravinv3dhmc_tpu_torch.samplers\n"
            "import gravinv3dhmc_tpu_torch.ops.tesseroid\n"
            "import gravinv3dhmc_tpu_torch.runtime.tessglq\n"
            "import gravinv3dhmc_tpu_torch.ops.fd\n"
            "import gravinv3dhmc_tpu_torch.inversion.reginv\n"
            "import gravinv3dhmc_tpu_torch.cg\n"
            "import gravinv3dhmc_tpu_torch.ops.wavelet\n"
            "import gravinv3dhmc_tpu_torch.ops.prism\n"
            "import gravinv3dhmc_tpu_torch.magnetic\n"
            "import gravinv3dhmc_tpu_torch.checkpoint\n"
            "import gravinv3dhmc_tpu_torch.config\n"
            "import gravinv3dhmc_tpu_torch.utils\n"
            "import gravinv3dhmc_tpu_torch.utils.io\n"
            "import gravinv3dhmc_tpu_torch.utils.linalg\n"
            "import gravinv3dhmc_tpu_torch.utils.packing\n"
            "import gravinv3dhmc_tpu_torch.runtime.sink\n"
            "import gravinv3dhmc_tpu_torch.runtime.sink_py\n"
            "import gravinv3dhmc_tpu_torch.inversion.joint\n"
            "import gravinv3dhmc_tpu_torch.global_tess\n"
            "import gravinv3dhmc_tpu_torch.workloads\n"
            "import gravinv3dhmc_tpu_torch.run\n"
            "import gravinv3dhmc_tpu_torch.profiling\n"
            "import gravinv3dhmc_tpu_torch.vis\n"
            "import gravinv3dhmc_tpu_torch.vis.geodata\n"
            "import gravinv3dhmc_tpu_torch.compat\n"
            "import gravinv3dhmc_tpu_torch.compat.gravmag.tesseroidforward\n"
            "from gravinv3dhmc_tpu_torch.compat.mesher import PrismMesh\n"
            "from gravinv3dhmc_tpu_torch.mesher import PrismRelief\n"
            "from gravinv3dhmc_tpu_torch.inversion.hmc import HMCSample\n"
            "from gravinv3dhmc_tpu_torch.diagnostics import load_chains\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m.startswith('gravinv3dhmc_tpu.') "
            "or m == 'gravinv3dhmc_tpu']\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_vis_and_compat_import_without_matplotlib():
    """The card's machine has no matplotlib: ``vis`` and ``compat`` import
    without it (and without contourpy), as the JAX package's do; it is
    needed only when a plot is drawn."""
    code = ("import sys\n"
            "for m in ('matplotlib', 'contourpy', 'mpl_toolkits'):\n"
            "    sys.modules[m] = None\n"
            "import gravinv3dhmc_tpu_torch.vis\n"
            "import gravinv3dhmc_tpu_torch.compat\n"
            "from gravinv3dhmc_tpu_torch.compat.vis import mpl, myv\n"
            "try:\n"
            "    mpl.contour([0], [0], [0], (1, 1), 1)\n"
            "except ImportError:\n"
            "    sys.exit(0)\n"
            "sys.exit(1)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cpu_tensors_take_the_plain_versions():
    tlf.reset_launch_counts()
    C, M, D = 4, 128, 128
    rng = np.random.RandomState(0)
    A = rng.randn(D, M) * 0.1
    it = tlf.make_fused_iteration(A, rng.randn(D), None, np.zeros(M),
                                  np.ones(M), np.full(M, -5.0),
                                  np.full(M, 5.0), Sigma=0.1,
                                  matvec_dtype=torch.bfloat16, device="cpu")
    x = torch.zeros(C, M)
    out = it(x, torch.zeros(C), torch.zeros(C, M), torch.zeros(C),
             torch.zeros(C), ((5, 6), 0), 3, 0.01, 1.0)
    assert all(torch.isfinite(t).all() for t in out)
    assert tlf.launch_counts() == {name: 0 for name in tlf.KERNELS}
    # every kernel of the port has a plain version and names its TPU
    # kernel and its CUDA source
    assert set(tlf.KERNELS) == {"refresh", "drift", "residual", "kick",
                                "traj_finish", "accept", "step_residual",
                                "step_misfit", "gz", "gz_nodes", "draws",
                                "residual_f32",
                                "kick_f32", "step_residual_f32"}
    for k in tlf.KERNELS.values():
        assert callable(k.plain)
        assert k.replaces.startswith("gravinv3dhmc_tpu/ops/")
        assert os.path.isfile(os.path.join(REPO, k.source))
        assert os.path.isfile(os.path.join(REPO, k.replaces.split(":")[0]))


def test_meta_tensors_are_refused():
    with pytest.raises(ValueError):
        tlf.KERNELS["drift"](*(torch.empty(4, 128, device="meta")
                               for _ in range(3)),
                             *(torch.empty(128, device="meta")
                               for _ in range(3)), 0.01)
