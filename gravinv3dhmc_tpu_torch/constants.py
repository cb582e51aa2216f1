"""Physical constants and unit-conversion factors (copy of
``gravinv3dhmc_tpu/constants.py``, which the port cannot import).

All constants are in SI unless noted. Values are kept numerically identical
to the reference implementation (reference: constants.py:19-50) so that
forward-modelled fields and sensitivity kernels match bit-for-bit in f64.

Note the two gravitational constants: ``GS`` is the plain SI value used by
some spherical fields, while ``G`` is the value used by the prism (and most
tesseroid) drivers, which pairs with densities given in g/cm^3 and
distances in metres to yield fields that scale directly to mGal via
``SI2MGAL`` (reference: constants.py:32-34).
"""

THERMAL_DIFFUSIVITY = 0.000001
THERMAL_DIFFUSIVITY_YEAR = 31.5576

#: 1/s^2 = 1e9 Eotvos
SI2EOTVOS = 1000000000.0
#: 1 m/s^2 = 1e5 mGal
SI2MGAL = 100000.0

#: Gravitational constant used by spherical-SI fields (m^3 kg^-1 s^-2)
Gs = 0.00000000006673
GS = Gs
#: Gravitational constant paired with g/cm^3 densities (cm^3 g^-1 s^-2)
G = 0.00000006673

#: Proportionality constant of the magnetic method, henry/m (SI)
CM = 10.0 ** (-7)

#: Conversion factor from tesla: the reference redefines T2NT to produce
#: micro-tesla (1e6) rather than nano-tesla (reference: constants.py:40-42).
T2NT = 10.0 ** 6
T2MuT = 10.0 ** 6

#: Mean Earth radius in metres (reference: constants.py:44)
MEAN_EARTH_RADIUS = 6378137.0
MEAN_MOON_RADIUS = 1738000.0

#: Permeability of free space in N A^-2
PERM_FREE_SPACE = 4 * 3.141592653589793 * (10.0 ** -7)

#: Gravitational acceleration, m/s^2
g0 = 9.80
