"""Precision policy — the port of :mod:`permon_tpu.core.precision`.

The policy keeps the expensive part — operator STORAGE and matvecs — in
f32, and the cheap-but-sensitive part — dot products and recurrence
scalars — in f64:

- ``cast_floats(tree, dtype)`` re-stores every float tensor of an operator
  (a dataclass, walked recursively) in the given dtype, index tensors
  untouched;
- :class:`MixedPrecision` wraps a low-precision operator behind an f64
  interface; :class:`CastTo` gives an operator a fixed output dtype;
- ``with_precision(op, policy)`` applies ``'f64'``, ``'mixed'``,
  ``'f32'`` or ``'bf16_mixed'`` to an OPERATOR; ``qp_with_precision(qp,
  policy)`` (also ``QP.with_precision``) to a whole QP: under ``'mixed'``
  operator, rhs, bounds and iterates are f32 and every solver dot/norm is
  promoted to f64 (``dots_dtype="float64"``) through the fixed tree;
  ``'bf16_mixed'`` is the same with the Hessian stored in bf16 behind
  ``CastTo("float32")``.  Every operator that ``QP.create`` produces
  (``Dense``, ``Dia``, ``Ell``, ``SEll``) computes a bf16-stored product in
  the dtype of x (the values widened exactly), as the JAX operators do;
- ``reducers`` and ``dot_bundler`` are what the solvers read.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from . import detred
from .linop import LinearOperator

POLICIES = ("f64", "mixed", "f32", "bf16_mixed")


def cast_floats(tree, dtype):
    """Re-store every float tensor reachable from ``tree`` (a tensor, a
    dataclass, a tuple or list of those) in ``dtype``; ints/bools and
    everything else are kept."""
    from .extension import GatherTable

    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.dtype.is_floating_point else tree
    if isinstance(tree, GatherTable):  # keeps the padded plane stride of its idx
        return tree.cast(dtype)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: cast_floats(getattr(tree, f.name), dtype)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(cast_floats(v, dtype) for v in tree)
    return tree


def _storage_dtype(obj):
    """The dtype of the first float tensor found in ``obj`` (float64 if none)."""
    if isinstance(obj, torch.Tensor):
        return obj.dtype if obj.dtype.is_floating_point else None
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        children = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    elif isinstance(obj, (tuple, list)):
        children = list(obj)
    else:
        return None
    for child in children:
        found = _storage_dtype(child)
        if found is not None:
            return found
    return None


@dataclasses.dataclass
class MixedPrecision(LinearOperator):
    """f64 interface over a low-precision operator: x -> up(A_lo(down(x))).
    The wrapped matvec runs at storage precision; callers see f64 so Krylov
    dots and recurrences keep full accuracy."""

    inner: Any

    @property
    def shape(self):
        return self.inner.shape

    def _down(self, x):
        return x.to(_storage_dtype(self.inner) or torch.float64)

    def mv(self, x):
        return self.inner.mv(self._down(x)).to(torch.float64)

    def rmv(self, x):
        return self.inner.rmv(self._down(x)).to(torch.float64)

    def diagonal(self):
        return self.inner.diagonal().to(torch.float64)


@dataclasses.dataclass
class CastTo(LinearOperator):
    """Fixed-output-dtype wrapper: y = A(x) cast to ``dtype``."""

    inner: Any
    dtype: str = "float32"

    @property
    def shape(self):
        return self.inner.shape

    def mv(self, x):
        return self.inner.mv(x).to(_dtype(self.dtype))

    def rmv(self, x):
        return self.inner.rmv(x).to(_dtype(self.dtype))

    def diagonal(self):
        return self.inner.diagonal().to(_dtype(self.dtype))


def _check_policy(policy: str):
    if policy not in POLICIES:
        raise ValueError(f"unknown precision policy {policy!r}; one of {POLICIES}")


def with_precision(op, policy: str):
    """Apply a precision policy to an OPERATOR (f64-interface wrappers):
    under 'bf16_mixed' the wrapped product runs on bf16 storage AND a bf16
    x (``MixedPrecision._down``), as in the JAX package.  For whole-QP
    policies — f32 state with f64 reductions — use
    :func:`qp_with_precision` / ``QP.with_precision``."""
    _check_policy(policy)
    if policy == "f64":
        return op
    lo = cast_floats(op, torch.bfloat16 if policy == "bf16_mixed" else torch.float32)
    return lo if policy == "f32" else MixedPrecision(inner=lo)


def qp_with_precision(qp, policy: str):
    """Whole-QP precision policy:

    - 'f32'   — everything f32: operator storage, rhs, bounds, iterates, dots;
    - 'mixed' — f32 storage AND f32 iterates/axpys, but every dot product /
      norm a solver takes is PROMOTED to f64 (``dots_dtype``), so the
      recurrence scalars and convergence tests keep f64-grade accuracy;
    - 'bf16_mixed' — like 'mixed' with the Hessian stored in bf16 behind
      ``CastTo("float32")``: its products take an f32 x and give f32.

    The projector (coarse problem) is NOT cast: its internal math stays f64
    and its applications cast back to the iterate dtype."""
    _check_policy(policy)
    if policy == "f64":
        return qp
    f32 = torch.float32
    out = qp.replace(**{name: cast_floats(getattr(qp, name), f32)
                        for name in ("b", "x0", "box", "BE", "cE", "BI", "cI")})
    if policy == "bf16_mixed":
        A = CastTo(inner=cast_floats(qp.A, torch.bfloat16), dtype="float32")
    else:
        A = cast_floats(qp.A, f32)
    out = out.replace(A=A)
    if policy in ("mixed", "bf16_mixed"):
        out = out.replace(dots_dtype="float64")
    return out


def _dtype(dots_dtype) -> torch.dtype:
    if isinstance(dots_dtype, torch.dtype):
        return dots_dtype
    return getattr(torch, str(dots_dtype))


def reducers(dots_dtype):
    """(vdot, norm) honoring an optional promotion dtype for reductions;
    promoted reductions always run as the fixed binary tree."""
    if dots_dtype is None:
        return detred.vdot, detred.norm
    dd = _dtype(dots_dtype)

    def vdot(x, y):
        return detred.det_dot(x.to(dd), y.to(dd))

    def norm(x):
        return detred.det_norm(x.to(dd))

    return vdot, norm


def dot_bundler(dots_dtype):
    """``vdots(pairs) -> tuple of dots`` for fusing same-point reductions:
    one batched fixed tree under promotion or deterministic mode (bitwise
    equal per pair to separate dots), separate dots otherwise."""
    if dots_dtype is None:
        def vdots(pairs):
            if detred.enabled():
                return detred.det_dots(pairs)
            return tuple(torch.vdot(x.reshape(-1), y.reshape(-1)) for x, y in pairs)

        return vdots
    dd = _dtype(dots_dtype)

    def vdots(pairs):
        return detred.det_dots([(x.to(dd), y.to(dd)) for x, y in pairs])

    return vdots
