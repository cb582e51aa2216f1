"""Reference-compatible import surface.

Lets code written against ChuWeiEr/GravInv3DHMC's flat module layout run on
this framework with only the import root changed:

    # reference                      # here
    import utils, mesher             from gravinv3dhmc_tpu_torch.compat import utils, mesher
    from gravmag import prism        from gravinv3dhmc_tpu_torch.compat.gravmag import prism
    from inversion import hmc        from gravinv3dhmc_tpu_torch.compat.inversion import hmc

The port's counterpart of ``gravinv3dhmc_tpu/compat``: every name
resolves to the PyTorch implementation (entry points on ``cuda:0`` unless
given a device); numerical semantics and file formats match the reference
(see module docstrings for the documented divergences).
"""
import sys as _sys

from .. import constants, mesher, utils  # noqa: F401
from . import gravmag, inversion, vis  # noqa: F401

# register the borrowed top-level modules as real submodules so that
# `from gravinv3dhmc_tpu_torch.compat.mesher import PrismMesh` works like the
# reference's `from mesher import PrismMesh`
for _name, _mod in (("constants", constants), ("mesher", mesher),
                    ("utils", utils)):
    _sys.modules.setdefault(__name__ + "." + _name, _mod)
