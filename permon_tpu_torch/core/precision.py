"""Reduction helpers of the precision policy — the port of ``reducers`` and
``dot_bundler`` from :mod:`permon_tpu.core.precision` (:173-221).

Only the ``'f64'`` policy is ported (``dots_dtype=None``); the promoted
``'mixed'`` reductions are kept because :func:`~permon_tpu_torch.solvers.cg.cg`
reads them, and a promotion dtype runs as the fixed tree exactly as in the
JAX package."""

from __future__ import annotations

import torch

from . import detred


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
