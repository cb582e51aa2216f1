"""Potential and HMC sampler of the uniformgrid and ratiogrid slices."""
from .hmc import HamiltonianMC, make_chunk_sampler
from .potential import GravMagModule, Potential, sensitivity_weighting

__all__ = ["GravMagModule", "Potential", "sensitivity_weighting",
           "HamiltonianMC", "make_chunk_sampler"]
