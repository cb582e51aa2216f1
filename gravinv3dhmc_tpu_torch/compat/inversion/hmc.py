"""Reference-compatible inversion.hmc module."""
from ...inversion.hmc import (  # noqa: F401
    HamiltonianMC,
    HamitonianMC,
    HMCSample,
    make_chunk_sampler,
)
from ...inversion.nuts import NUTSSample  # noqa: F401
