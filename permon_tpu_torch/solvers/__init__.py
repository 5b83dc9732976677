"""The solvers: CG / PCPG, MPRGP, SMALXE, the TAO analog and the driver."""

from .mprgp import MPRGPOptions, MPRGPResult, mprgp
from .driver import solve
