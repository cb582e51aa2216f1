"""Inversion engines: HMC/NUTS/ChEES sampling, CG, bootstrap."""
from .hmc import HamiltonianMC, make_chunk_sampler
from .potential import (
    GravMagModule,
    Potential,
    logistic_to_mw,
    mw_to_logistic,
    sensitivity_weighting,
)

__all__ = ["GravMagModule", "Potential", "sensitivity_weighting",
           "logistic_to_mw", "mw_to_logistic",
           "HamiltonianMC", "make_chunk_sampler"]
