"""Convergence testing — reasons, tolerances and the default test
(the port of :mod:`permon_tpu.core.convergence`; reference:
src/qps/interface/qps.c:675-714, PETSc KSPConvergedReason codes)."""

from __future__ import annotations

import dataclasses
import enum
import math


class ConvergedReason(enum.IntEnum):
    ITERATING = 0
    CONVERGED_RTOL = 2
    CONVERGED_ATOL = 3
    CONVERGED_ITS = 4
    CONVERGED_HAPPY_BREAKDOWN = 7
    DIVERGED_NULL = -2
    DIVERGED_ITS = -3
    DIVERGED_DTOL = -4
    DIVERGED_BREAKDOWN = -5
    DIVERGED_NANORINF = -9


@dataclasses.dataclass(frozen=True)
class Tolerances:
    rtol: float = 1e-5
    atol: float = 1e-50
    divtol: float = 1e4
    max_it: int = 10000


def converged_default(it: int, rnorm: float, *, ttol: float, atol: float,
                      divtol: float, norm_rhs_div: float, max_it: int) -> int:
    """The reason code for one host check of a solver loop.

    Test order mirrors the reference (qps.c:693-713) and the JAX package
    (core/convergence.py:51-76): max-iterations first, then NaN/Inf, then
    ttol = max(rtol*||b||, atol) (ATOL when rnorm < atol), then divergence
    on rnorm >= divtol * ||b_div||."""
    if it > max_it:
        return int(ConvergedReason.DIVERGED_ITS)
    if math.isnan(rnorm) or math.isinf(rnorm):
        return int(ConvergedReason.DIVERGED_NANORINF)
    if rnorm <= ttol:
        if rnorm < atol:
            return int(ConvergedReason.CONVERGED_ATOL)
        return int(ConvergedReason.CONVERGED_RTOL)
    if rnorm >= divtol * norm_rhs_div:
        return int(ConvergedReason.DIVERGED_DTOL)
    return int(ConvergedReason.ITERATING)
