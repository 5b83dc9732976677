"""Sparse row operations on constraint operators, without an (m, n)
dense array — the port of :mod:`permon_tpu.qp.sparse_rows` (reference:
src/qp/interface/qptransform.c:1437-1902, permonmatfetiutils.c):

- :func:`to_coo` / :func:`to_scipy`: host views of the port's sparse row
  operators (SubdomainExtension, Ell, VStack of those), which the sparse
  coarse build (G = R'B', GG') needs;
- :func:`row_nnz` / :func:`row_sqnorm`: per-row reductions on the host;
- :func:`scale_rows` / :func:`permute_rows` / :func:`restrict_rows`:
  same-type row transforms (an extension stays an extension, its gather
  tables rebuilt on their device; an Ell its transpose table).

Dense operators have no sparse rows: ``to_coo`` gives None and the row
transforms act on the array.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.extension import SubdomainExtension
from ..core.linop import Dense, Ell, VStack


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


def row_nnz(op) -> Optional[np.ndarray]:
    """Nonzeros of each row, or None for an operator without sparse rows."""
    coo = to_coo(op)
    if coo is None:
        return None
    rows, _, vals, (m, _) = coo
    return np.bincount(rows[vals != 0], minlength=m)


def row_sqnorm(op) -> Optional[np.ndarray]:
    """Squared 2-norm of each row, or None for an operator without sparse rows."""
    coo = to_coo(op)
    if coo is None:
        return None
    rows, _, vals, (m, _) = coo
    return np.bincount(rows, weights=vals * vals, minlength=m)


def _retabled(old: SubdomainExtension, new: SubdomainExtension) -> SubdomainExtension:
    """``new`` with gather tables on the device of ``old``'s, if it had any:
    the tables bake the values and rows in, so they are built anew."""
    if old.gB is None:
        return new
    return new.replace(gB=None, gBt=None).with_gather_apply(old.gB.idx.device).with_kernel(
        old.gB.kernel)


def _ell(op: Ell, cols: torch.Tensor, vals: torch.Tensor, m: int) -> Ell:
    return Ell.from_arrays(cols.cpu().numpy(), vals.cpu().numpy(), (m, op.shape[1]),
                           device=op.vals.device)


def _host_vec(d, dtype=None) -> np.ndarray:
    if isinstance(d, torch.Tensor):
        d = d.cpu().numpy()
    return np.asarray(d, dtype=dtype)


def scale_rows(op, d):
    """diag(d) @ op, keeping the operator type (MatDiagonalScale on the
    sparse storage, as QPTScale does on AIJ)."""
    if isinstance(op, SubdomainExtension):
        d_pad = np.concatenate([_host_vec(d, op.vals.dtype), np.zeros(1, op.vals.dtype)])
        return _retabled(op, op.replace(vals=op.vals * d_pad[op.rows]))
    if isinstance(op, Ell):
        dt = torch.as_tensor(_host_vec(d), dtype=op.vals.dtype, device=op.vals.device)
        return _ell(op, op.cols, op.vals * dt[:, None], op.shape[0])
    if isinstance(op, Dense):
        return Dense.create(torch.as_tensor(_host_vec(d), dtype=op.a.dtype,
                                            device=op.a.device)[:, None] * op.a)
    raise TypeError(f"scale_rows: unsupported operator {type(op).__name__}")


def permute_rows(op, perm):
    """Row permutation: row i of the result is row perm[i] of op."""
    perm = _host_vec(perm)
    if isinstance(op, SubdomainExtension):
        m = op.m_dual
        lookup = np.full(m + 1, m, dtype=np.int32)
        lookup[perm] = np.arange(len(perm), dtype=np.int32)
        return _retabled(op, op.replace(rows=lookup[op.rows]))
    if isinstance(op, Ell):
        p = torch.as_tensor(perm, dtype=torch.int64, device=op.vals.device)
        return _ell(op, op.cols[p], op.vals[p], op.shape[0])
    if isinstance(op, Dense):
        return Dense.create(op.a[torch.as_tensor(perm, dtype=torch.int64, device=op.a.device)])
    raise TypeError(f"permute_rows: unsupported operator {type(op).__name__}")


def restrict_rows(op, keep):
    """Only the listed (sorted) rows, renumbered 0..len(keep)-1 (the row
    restriction of MatRemoveGluingOfDirichletDofs, permonmatfetiutils.c:1-167)."""
    keep = _host_vec(keep)
    if isinstance(op, SubdomainExtension):
        m_new = len(keep)
        lookup = np.full(op.m_dual + 1, m_new, dtype=np.int32)
        lookup[keep] = np.arange(m_new, dtype=np.int32)
        new_rows = lookup[op.rows]
        # dropped entries point at the padding row: zero their values
        new_vals = np.where(new_rows < m_new, op.vals, 0.0)
        return _retabled(op, op.replace(rows=new_rows, vals=new_vals, m_dual=m_new))
    if isinstance(op, Ell):
        k = torch.as_tensor(keep, dtype=torch.int64, device=op.vals.device)
        return _ell(op, op.cols[k], op.vals[k], len(keep))
    if isinstance(op, Dense):
        return Dense.create(op.a[torch.as_tensor(keep, dtype=torch.int64, device=op.a.device)])
    raise TypeError(f"restrict_rows: unsupported operator {type(op).__name__}")
