"""Composable linear operators — the port of :mod:`permon_tpu.core.linop`.

An operator is a plain dataclass with

- ``mv(x)``  : y = A @ x
- ``rmv(x)`` : y = A.T @ x

holding its tensors on one device.  Implicit composition (never
materialized) follows the reference's MatProd idiom (reference:
src/mat/impls/composite/matprod.c).  Ported: every operator of the JAX
module, ``Timer`` included.
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

    def diagonal(self) -> torch.Tensor:
        raise NotImplementedError(f"{type(self).__name__} has no diagonal()")

    def todense(self) -> torch.Tensor:
        """Materialize as dense by applying to the identity, column by
        column (float64, on the device of the operator's first tensor)."""
        dev = next((v.device for v in vars(self).values()
                    if isinstance(v, torch.Tensor)), None)
        eye = torch.eye(self.n, dtype=torch.float64, device=dev)
        return torch.stack([self.mv(eye[:, j]) for j in range(self.n)], dim=1)


@dataclasses.dataclass
class Dense(LinearOperator):
    a: torch.Tensor
    shape: Tuple[int, int]

    @classmethod
    def create(cls, a: torch.Tensor) -> "Dense":
        return cls(a=a, shape=(int(a.shape[0]), int(a.shape[1])))

    def _promoted(self, x):
        """(a, x) in the product's dtype: torch's matmul takes one dtype
        where jnp promotes (a bf16 array times an f32 x is f32)."""
        dt = torch.promote_types(self.a.dtype, x.dtype)
        return self.a.to(dt), x.to(dt)

    def mv(self, x):
        a, x = self._promoted(x)
        return a @ x

    def rmv(self, x):
        a, x = self._promoted(x)
        return a.T @ x

    def diagonal(self):
        return torch.diagonal(self.a)

    def todense(self):
        return self.a


@dataclasses.dataclass
class DenseTree(Dense):
    """Dense wide (k, m) operator whose matvecs reduce as the FIXED BINARY
    TREE of :func:`~permon_tpu_torch.core.detred.det_sum` instead of a
    GEMV — deterministic by construction, bitwise equal to the JAX
    package's DenseTree on the CPU.  On the CPU chunked along the
    non-reduced axis (each output element's tree is untouched) to cap the
    (k, m) product temporary at CHUNK_ELEMS elements; on the card the
    kernel forms no product temporary, so one call takes all of it."""

    CHUNK_ELEMS = 1 << 24

    def mv(self, x):
        from .detred import det_sum

        k, m = self.a.shape
        xa = x[None, :].to(self.a.dtype)
        if k > 1 and k * m > self.CHUNK_ELEMS and not self.a.is_cuda:
            rows = max(self.CHUNK_ELEMS // max(m, 1), 1)
            outs = [det_sum(self.a[i0:i0 + rows], -1, xa) for i0 in range(0, k, rows)]
            return torch.cat(outs).to(x.dtype)
        return det_sum(self.a, -1, xa).to(x.dtype)

    def rmv(self, y):
        from .detred import det_sum

        k, m = self.a.shape
        ya = y[:, None].to(self.a.dtype)
        if m > 1 and k * m > self.CHUNK_ELEMS and not self.a.is_cuda:
            cols = max(self.CHUNK_ELEMS // max(k, 1), 1)
            outs = [det_sum(self.a[:, j0:j0 + cols], 0, ya) for j0 in range(0, m, cols)]
            return torch.cat(outs).to(y.dtype)
        return det_sum(self.a, 0, ya).to(y.dtype)


@dataclasses.dataclass
class Diagonal(LinearOperator):
    d: torch.Tensor
    shape: Tuple[int, int]

    @classmethod
    def create(cls, d: torch.Tensor) -> "Diagonal":
        return cls(d=d, shape=(int(d.shape[0]), int(d.shape[0])))

    def mv(self, x):
        return self.d * x

    rmv = mv

    def diagonal(self):
        return self.d

    def todense(self):
        return torch.diag(self.d)


@dataclasses.dataclass
class Identity(LinearOperator):
    shape: Tuple[int, int]

    @classmethod
    def create(cls, n: int) -> "Identity":
        return cls(shape=(n, n))

    def mv(self, x):
        return x

    rmv = mv

    def diagonal(self):
        """Ones (float64, on the CPU: the operator holds no tensor)."""
        return torch.ones(self.n, dtype=torch.float64)

    def todense(self):
        return torch.eye(self.n, dtype=torch.float64)


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
    def from_coo(cls, rows, cols, vals, shape, device=None) -> "Ell":
        """Build from host COO triplets (duplicates summed, as scipy does)."""
        import scipy.sparse as sp

        return cls.from_scipy(sp.coo_matrix((vals, (rows, cols)), shape=shape), device=device)

    @classmethod
    def from_arrays(cls, cols, vals, shape, device=None) -> "Ell":
        """Build from host ELL arrays (the JAX package's layout)."""
        dev = resolve_device(device)
        # writable: torch.as_tensor shares a numpy array's memory, and a
        # read-only one (a JAX array's host view) draws its warning
        cols = np.require(cols, np.int64, "W")
        vals = np.require(vals, requirements="W")
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

    @property
    def nnz(self) -> int:
        """Stored slots, padding included (the JAX package's count)."""
        return int(self.vals.numel())

    def mv(self, x):
        return torch.sum(self.vals * x[self.cols], dim=1)

    def rmv(self, x):
        contrib = (self.vals * x[:, None]).reshape(-1)
        cp = torch.cat([contrib, contrib.new_zeros(1)])
        return torch.sum(cp[self.t_slots], dim=1)

    def diagonal(self):
        row_ids = torch.arange(self.m, device=self.cols.device)[:, None]
        return torch.sum(torch.where(self.cols == row_ids, self.vals,
                                     torch.zeros_like(self.vals)), dim=1)

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

    def todense(self):
        return self.inner.todense().T


@dataclasses.dataclass
class Scaled(LinearOperator):
    inner: Any
    scale: Any  # python float or 0-dim tensor

    @property
    def shape(self):
        return self.inner.shape

    def mv(self, x):
        return self.scale * self.inner.mv(x)

    def rmv(self, x):
        return self.scale * self.inner.rmv(x)

    def diagonal(self):
        return self.scale * self.inner.diagonal()


@dataclasses.dataclass
class Sum(LinearOperator):
    """y = sum_i ops[i] @ x — additive composite (reference: MATCOMPOSITE
    additive)."""

    ops: Tuple[Any, ...]

    @property
    def shape(self):
        return self.ops[0].shape

    def mv(self, x):
        y = self.ops[0].mv(x)
        for op in self.ops[1:]:
            y = y + op.mv(x)
        return y

    def rmv(self, x):
        y = self.ops[0].rmv(x)
        for op in self.ops[1:]:
            y = y + op.rmv(x)
        return y

    def diagonal(self):
        d = self.ops[0].diagonal()
        for op in self.ops[1:]:
            d = d + op.diagonal()
        return d


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


@dataclasses.dataclass
class VStack(LinearOperator):
    """Vertically stacked operator [B0; B1; ...] — the analog of the 2x1
    MATNESTPERMON the reference builds when merging BE and BI into one
    constraint matrix B (reference: QPSetUpInnerObjects, qp.c:492-598).
    ``rmv`` adds the blocks' contributions in the order of ``ops``."""

    ops: Tuple[Any, ...]

    @property
    def shape(self):
        return (sum(op.shape[0] for op in self.ops), self.ops[0].shape[1])

    @property
    def row_offsets(self):
        offs, o = [], 0
        for op in self.ops:
            offs.append((o, o + op.shape[0]))
            o += op.shape[0]
        return offs

    def mv(self, x):
        return torch.cat([op.mv(x) for op in self.ops])

    def rmv(self, y):
        out = None
        for op, (lo, hi) in zip(self.ops, self.row_offsets):
            contrib = op.rmv(y[lo:hi])
            out = contrib if out is None else out + contrib
        return out

    def todense(self):
        return torch.cat([op.todense() for op in self.ops], dim=0)


@dataclasses.dataclass
class Penalized(LinearOperator):
    """y = A @ x + rho * B^T (B x) — the augmented-Lagrangian Hessian.
    ``rho`` is a 0-dim tensor or a float; SMALXE swaps it between outer
    iterations with ``.replace`` (reference: MatPenalizedUpdatePenalty,
    src/qp/utils/matpenalized.c:4-120)."""

    a: Any
    b: Any  # the constraint operator B (m_dual x n)
    rho: Any

    @property
    def shape(self):
        return self.a.shape

    def mv(self, x):
        return self.a.mv(x) + self.rho * self.b.rmv(self.b.mv(x))

    rmv = mv  # symmetric by construction (A symmetric in QP context)

    def mv_parts(self, x):
        """(A x + rho B'B x, B x), so callers can reuse B x (reference:
        smalxe.c:246-285)."""
        bx = self.b.mv(x)
        return self.a.mv(x) + self.rho * self.b.rmv(bx), bx


@dataclasses.dataclass
class OneRow(LinearOperator):
    """1 x n operator from a vector: mv = [v'x], rmv = y[0]*v — the MATONEROW
    analog used for single scalar constraints (reference:
    src/mat/impls/onerow/onerow.c:5-50)."""

    v: torch.Tensor

    @property
    def shape(self):
        return (1, int(self.v.shape[0]))

    def mv(self, x):
        return torch.vdot(self.v, x)[None]

    def rmv(self, y):
        return y[0] * self.v

    def todense(self):
        return self.v[None, :]


@dataclasses.dataclass
class Timer(LinearOperator):
    """Instrumentation wrapper — the MATTIMER analog (reference:
    src/mat/impls/timer/mattimer.c).  Each apply runs inside a span of
    :mod:`permon_tpu_torch.sys.tracing` named ``<name>.mv`` /
    ``<name>.rmv`` (nested under the caller's spans, and a
    ``record_function`` range while a profiler records) and bumps the host
    counter ``op_counts``.  The JAX package's counters count traces (one
    per compilation); the port runs eagerly, so they count applications."""

    inner: Any
    name: str = "op"

    @property
    def shape(self):
        return self.inner.shape

    def _run(self, op: str, x):
        from ..sys.tracing import count_op, trace

        count_op(self.name, op)
        with trace(f"{self.name}.{op}"):
            return getattr(self.inner, op)(x)

    def mv(self, x):
        return self._run("mv", x)

    def rmv(self, x):
        return self._run("rmv", x)

    def diagonal(self):
        return self.inner.diagonal()

    def todense(self):
        return self.inner.todense()


def operator_device(op) -> torch.device:
    """The device an operator's tensors live on: that of the first tensor
    found in its fields, looking into nested operators, tuples of them and
    gather tables.  An operator that holds no tensor runs wherever its
    input lives; for it this is the CPU."""
    seen = [op]
    while seen:
        cur = seen.pop(0)
        if isinstance(cur, torch.Tensor):
            return cur.device
        if isinstance(cur, (tuple, list)):
            seen.extend(cur)
        elif dataclasses.is_dataclass(cur):
            seen.extend(getattr(cur, f.name) for f in dataclasses.fields(cur))
    return torch.device("cpu")


def aslinearoperator(a, device=None) -> LinearOperator:
    """An operator from an operator (returned as it is), a numpy array or
    torch tensor (-> :class:`Dense` on ``device``) or a scipy sparse matrix
    (-> :func:`~permon_tpu_torch.core.matutils.make_operator`)."""
    import scipy.sparse as sp

    if isinstance(a, LinearOperator):
        return a
    if isinstance(a, (np.ndarray, torch.Tensor)):
        return Dense.create(torch.as_tensor(a, device=resolve_device(device)))
    if sp.issparse(a):
        from .matutils import make_operator

        return make_operator(a, device=device)
    raise TypeError(f"cannot interpret {type(a)} as LinearOperator")
