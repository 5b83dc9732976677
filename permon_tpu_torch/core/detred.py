"""Deterministic reductions — the fixed binary tree of
:mod:`permon_tpu.core.detred`, in torch.

Every reduction the solvers own can run as a FIXED BINARY TREE of
elementwise adds: the summation order is pinned by construction, so the
result does not depend on thread counts or on the reduction kernels a
backend picks.  The tree is the same as the JAX package's, so on the CPU
an f64 result is bitwise equal to JAX's for equal inputs.

The mode is a flag read when a solver runs (:func:`deterministic_mode`
scopes it to one solve, as ``FetiOptions(deterministic=True)`` does).
"""

from __future__ import annotations

import torch

_DETERMINISTIC = False


def set_deterministic(on: bool = True) -> None:
    """Toggle deterministic reductions globally.  Prefer the per-solve
    switches (``FetiOptions(deterministic=True)``, ``make_solver(...,
    deterministic=True)``), which scope the flag to one solve through
    :func:`deterministic_mode`."""
    global _DETERMINISTIC
    _DETERMINISTIC = bool(on)


class deterministic_mode:
    """Context manager scoping the deterministic-reduction flag to a block;
    ``deterministic_mode(None)`` inherits the current mode."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        global _DETERMINISTIC
        self._old = _DETERMINISTIC
        if self.on is not None:
            _DETERMINISTIC = bool(self.on)
        return self

    def __exit__(self, *exc):
        global _DETERMINISTIC
        _DETERMINISTIC = self._old
        return False


def enabled() -> bool:
    return _DETERMINISTIC


def det_sum(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Sum along ``axis`` as a fixed binary tree of elementwise adds: pair
    element i with element i + n//2, carry an odd tail element along."""
    x = torch.movedim(x, axis, -1)
    n = x.shape[-1]
    while n > 1:
        half = n // 2
        lo = x[..., :half] + x[..., half: 2 * half]
        x = torch.cat([lo, x[..., 2 * half:]], dim=-1) if n % 2 else lo
        n = x.shape[-1]
    return x[..., 0]


def det_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """<x, y> with a pinned summation order."""
    return det_sum((torch.conj(x) * y).reshape(-1))


def det_dots(pairs):
    """Tuple of <x_i, y_i> as ONE batched fixed tree; each row's order is
    identical to :func:`det_dot` of that pair alone (bitwise equal)."""
    prods = torch.stack([(torch.conj(x) * y).reshape(-1) for x, y in pairs])
    out = det_sum(prods, axis=-1)
    return tuple(out[i] for i in range(len(pairs)))


def det_norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(det_dot(x, x).real)


def vdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``torch.vdot`` normally; the fixed-tree dot in deterministic mode."""
    return det_dot(x, y) if _DETERMINISTIC else torch.vdot(x.reshape(-1), y.reshape(-1))


def norm(x: torch.Tensor) -> torch.Tensor:
    return det_norm(x) if _DETERMINISTIC else torch.linalg.vector_norm(x)


def det_gram(G: torch.Tensor) -> torch.Tensor:
    """G G' (k, n) -> (k, k) with a pinned reduction order over n: chunks
    are added left to right, each chunk's sum is the fixed tree."""
    k, n = G.shape
    chunk = max(min(n, (1 << 22) // max(k * k, 1)), 1)
    out = torch.zeros((k, k), dtype=G.dtype, device=G.device)
    for c0 in range(0, n, chunk):
        Gc = G[:, c0: c0 + chunk]
        out = out + det_sum(Gc[:, None, :] * Gc[None, :, :], axis=-1)
    return out


def gram(G: torch.Tensor) -> torch.Tensor:
    return det_gram(G) if _DETERMINISTIC else G @ G.T
