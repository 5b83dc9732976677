"""Host COO / scipy views of the port's sparse row operators — the
``to_coo`` / ``to_scipy`` part of :mod:`permon_tpu.qp.sparse_rows`, which
the sparse coarse build (G = R'B', GG') needs."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..core.extension import SubdomainExtension
from ..core.linop import Ell, VStack


def to_coo(op) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[int, int]]]:
    """Host (rows, cols, vals, shape) of a sparse row operator
    (SubdomainExtension, Ell, VStack of those); None for a Dense operator
    (no sparse row structure)."""
    if isinstance(op, SubdomainExtension):
        rows = op.rows.reshape(-1)
        sub = np.repeat(np.arange(op.ns), op.rows.shape[1])
        cols = sub * op.nl + op.cols.reshape(-1).astype(np.int64)
        vals = op.vals.reshape(-1)
        keep = rows < op.m_dual  # drop padding slots
        return rows[keep], cols[keep], vals[keep], (op.m_dual, op.ns * op.nl)
    if isinstance(op, Ell):
        m, n = op.shape
        vals = op.vals.cpu().numpy()
        cols = op.cols.cpu().numpy()
        rows = np.broadcast_to(np.arange(m)[:, None], cols.shape)
        keep = vals != 0
        return rows[keep], cols[keep], vals[keep], (m, n)
    if isinstance(op, VStack):
        parts = [to_coo(b) for b in op.ops]
        if any(p is None for p in parts):
            return None
        n = parts[0][3][1]
        if any(p[3][1] != n for p in parts):
            raise ValueError("VStack blocks differ in their column count")
        offs = np.cumsum([0] + [p[3][0] for p in parts])
        return (np.concatenate([p[0] + o for p, o in zip(parts, offs)]),
                np.concatenate([p[1] for p in parts]),
                np.concatenate([p[2] for p in parts]), (int(offs[-1]), n))
    return None  # Dense and matrix-free operators have no sparse rows


def to_scipy(op):
    """scipy CSR of a sparse row operator, or None."""
    coo = to_coo(op)
    if coo is None:
        return None
    import scipy.sparse as sp

    rows, cols, vals, shape = coo
    return sp.csr_matrix(sp.coo_matrix((vals, (rows, cols)), shape=shape))
