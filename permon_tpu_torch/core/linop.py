"""Composable linear operators — the port of :mod:`permon_tpu.core.linop`.

An operator is a plain dataclass with

- ``mv(x)``  : y = A @ x
- ``rmv(x)`` : y = A.T @ x

holding its tensors on one device.  Implicit composition (never
materialized) follows the reference's MatProd idiom (reference:
src/mat/impls/composite/matprod.c).  Only the operators the large-path
TFETI slice uses are ported; see ROADMAP.md for the rest.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from .. import Struct, resolve_device


class LinearOperator(Struct):
    """Shared operator sugar; concrete operators are dataclasses."""

    shape: Tuple[int, int]

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def rmv(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def __matmul__(self, x):
        if isinstance(x, LinearOperator):
            return Product((self, x))
        return self.mv(x)

    @property
    def T(self) -> "LinearOperator":
        return Transpose(self)

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]


@dataclasses.dataclass
class Dense(LinearOperator):
    a: torch.Tensor
    shape: Tuple[int, int]

    @classmethod
    def create(cls, a: torch.Tensor) -> "Dense":
        return cls(a=a, shape=(int(a.shape[0]), int(a.shape[1])))

    def mv(self, x):
        return self.a @ x

    def rmv(self, x):
        return self.a.T @ x


@dataclasses.dataclass
class DenseTree(Dense):
    """Dense wide (k, m) operator whose matvecs reduce as the FIXED BINARY
    TREE of :func:`~permon_tpu_torch.core.detred.det_sum` instead of a
    GEMV — deterministic by construction, bitwise equal to the JAX
    package's DenseTree on the CPU.  Chunked along the non-reduced axis
    (each output element's tree is untouched) to cap the (k, m) product
    temporary at CHUNK_ELEMS elements."""

    CHUNK_ELEMS = 1 << 24

    def mv(self, x):
        from .detred import det_sum

        k, m = self.a.shape
        xa = x[None, :].to(self.a.dtype)
        if k > 1 and k * m > self.CHUNK_ELEMS:
            rows = max(self.CHUNK_ELEMS // max(m, 1), 1)
            outs = [det_sum(self.a[i0:i0 + rows] * xa, dim=-1)
                    for i0 in range(0, k, rows)]
            return torch.cat(outs).to(x.dtype)
        return det_sum(self.a * xa, dim=-1).to(x.dtype)

    def rmv(self, y):
        from .detred import det_sum

        k, m = self.a.shape
        ya = y[:, None].to(self.a.dtype)
        if m > 1 and k * m > self.CHUNK_ELEMS:
            cols = max(self.CHUNK_ELEMS // max(k, 1), 1)
            outs = [det_sum(self.a[:, j0:j0 + cols] * ya, dim=0)
                    for j0 in range(0, m, cols)]
            return torch.cat(outs).to(y.dtype)
        return det_sum(self.a * ya, dim=0).to(y.dtype)


@dataclasses.dataclass
class Identity(LinearOperator):
    shape: Tuple[int, int]

    @classmethod
    def create(cls, n: int) -> "Identity":
        return cls(shape=(n, n))

    def mv(self, x):
        return x

    rmv = mv


@dataclasses.dataclass
class Ell(LinearOperator):
    """Row-wise padded sparse operator (ELLPACK), used for the nullspace
    basis R.  ``cols[i, k]`` / ``vals[i, k]`` hold the k-th nonzero of row
    i; padded slots have ``vals == 0`` and ``cols == 0``.

    ``rmv`` runs through a host-built COLUMN-major gather table
    (``t_slots`` indexes the flattened (m*k) slot array, pad = m*k) and a
    row sum: no scatter-add, so the result is deterministic on CUDA too."""

    cols: torch.Tensor  # (m, k) int64
    vals: torch.Tensor  # (m, k)
    shape: Tuple[int, int]
    t_slots: torch.Tensor = None  # (n, kt) int64 slot ids per column

    @classmethod
    def from_scipy(cls, a, device=None) -> "Ell":
        """Host CSR -> ELL (vectorized; the same layout as the JAX
        package's native converter)."""
        dev = resolve_device(device)
        a = a.tocsr()
        m, n = a.shape
        row_nnz = np.diff(a.indptr)
        k = max(int(row_nnz.max()) if m else 0, 1)
        cols = np.zeros((m, k), dtype=np.int64)
        vals = np.zeros((m, k), dtype=a.dtype)
        rows = np.repeat(np.arange(m), row_nnz)
        slot = np.arange(a.nnz) - a.indptr[rows]
        cols[rows, slot] = a.indices
        vals[rows, slot] = a.data
        return cls.from_arrays(cols, vals, (m, n), device=dev)

    @classmethod
    def from_arrays(cls, cols, vals, shape, device=None) -> "Ell":
        """Build from host ELL arrays (the JAX package's layout)."""
        dev = resolve_device(device)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        m, n = int(shape[0]), int(shape[1])
        kk = cols.shape[1]
        flat_c = cols.reshape(-1)
        live = np.flatnonzero(vals.reshape(-1) != 0)
        order = live[np.argsort(flat_c[live], kind="stable")]
        counts = np.bincount(flat_c[order], minlength=n)
        kt = max(int(counts.max()) if len(counts) else 0, 1)
        pos = np.arange(len(order)) - np.concatenate([[0], np.cumsum(counts)[:-1]])[
            flat_c[order]]
        t_slots = np.full((n, kt), m * kk, dtype=np.int64)
        t_slots[flat_c[order], pos] = order
        return cls(
            cols=torch.as_tensor(cols, device=dev),
            vals=torch.as_tensor(vals, device=dev),
            shape=(m, n),
            t_slots=torch.as_tensor(t_slots, device=dev),
        )

    def mv(self, x):
        return torch.sum(self.vals * x[self.cols], dim=1)

    def rmv(self, x):
        contrib = (self.vals * x[:, None]).reshape(-1)
        cp = torch.cat([contrib, contrib.new_zeros(1)])
        return torch.sum(cp[self.t_slots], dim=1)

    def todense(self):
        out = torch.zeros(self.shape, dtype=self.vals.dtype, device=self.vals.device)
        live = self.vals != 0
        rows = torch.arange(self.m, device=self.vals.device)[:, None].expand_as(self.cols)
        # real (row, col) pairs are unique, so a plain assignment suffices
        out[rows[live], self.cols[live]] = self.vals[live]
        return out


@dataclasses.dataclass
class Transpose(LinearOperator):
    inner: Any

    @property
    def shape(self):
        m, n = self.inner.shape
        return (n, m)

    def mv(self, x):
        return self.inner.rmv(x)

    def rmv(self, x):
        return self.inner.mv(x)

    @property
    def T(self):
        return self.inner


@dataclasses.dataclass
class Product(LinearOperator):
    """y = ops[0] @ ops[1] @ ... @ x — lazy multiplicative composite; the
    FETI dual operator F = B K+ B' is this 3-factor product (reference:
    matprod.c:43, qptransform.c:1102)."""

    ops: Tuple[Any, ...]

    @property
    def shape(self):
        return (self.ops[0].shape[0], self.ops[-1].shape[1])

    def mv(self, x):
        for op in reversed(self.ops):
            x = op.mv(x)
        return x

    def rmv(self, x):
        for op in self.ops:
            x = op.rmv(x)
        return x
